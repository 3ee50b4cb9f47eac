"""The port's serving engine and scheduler (``gym_tpu_torch.serve``) on the
CPU (counterpart of ``tests/test_serve.py``'s engine and scheduler cases),
held to ``gym_tpu``'s on the same numpy-seeded weights.

- a single request through the engine gives ``generate_fast``'s tokens, the
  port's and ``gym_tpu``'s, also for a bucket-padded prompt;
- concurrent requests (decode chunks of 1 and 8) each give their solo
  stream; EOS stops a request mid-stream;
- teacher forcing: the engine's logits equal the JAX dense forward's at
  every position (rtol 1e-4);
- prompts bucket to at most ⌈log2(block_size)⌉ + 1 prefill shapes;
- backpressure, typed rejection of requests that cannot be served,
  shutdown and the threaded run loop behave as in ``gym_tpu.serve``;
- a mixed workload (shared prefixes, top-k and top-p, EOS) through
  ``Scheduler`` gives ``gym_tpu``'s engine's token streams and
  ``EngineStats`` counters exactly: unpaged, paged with prefix sharing and
  copy-on-write, speculative at γ = 4, and with a request parked and
  resumed.
"""

import threading

import numpy as np
import pytest

from gym_tpu.models import nanogpt as J
from gym_tpu.serve import engine as JE
from gym_tpu.serve import scheduler as JS
from gym_tpu_torch.convert import serving_params_from_jax
from gym_tpu_torch.models import nanogpt as T
from gym_tpu_torch.serve import (InferenceEngine, QueueFullError,
                                 RequestStatus, SamplingParams, Scheduler,
                                 max_prefill_buckets, prompt_bucket)
from gym_tpu_torch.serve import engine as TE
from gym_tpu_torch.serve import scheduler as TS
from test_torch_decode import full_forward, numpy_params, port_config

V = 48
COUNTERS = ("tokens_generated", "decode_steps", "prefills", "prefill_tokens",
            "prefix_hit_blocks", "kv_blocks_in_use", "kv_blocks_cached",
            "spec_drafted", "spec_accepted", "preemptions", "resumes",
            "quarantined", "prefill_buckets")


@pytest.fixture(scope="module")
def setup():
    cfg = J.GPTConfig(block_size=64, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    params = numpy_params(cfg, 1)
    return cfg, params, serving_params_from_jax(params, "cpu"), \
        port_config(cfg)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, V, n).astype(np.int32)


def _drain(sched, handles, limit=5000):
    for _ in range(limit):
        if all(h.status in (RequestStatus.DONE, RequestStatus.FAILED)
               for h in handles):
            return
        sched.step()
    raise AssertionError("scheduler did not drain")


def _solo(tp, tcfg, prompt, sp):
    kw = dict(temperature=sp.temperature, top_k=sp.top_k, top_p=sp.top_p,
              seed=sp.seed)
    out = T.generate_fast(tp, tcfg, prompt[None], sp.max_new_tokens, **kw)
    return out[0, len(prompt):].tolist()


def _engine(tp, tcfg, **kw):
    return InferenceEngine(tp, tcfg, device="cpu", **kw)


@pytest.mark.parametrize("plen", [8, 11], ids=["aligned", "padded"])
def test_engine_matches_generate_fast(setup, plen):
    """One request, sampling on: the engine's stream equals the port's and
    ``gym_tpu``'s ``generate_fast`` (11 tokens prefill as bucket 16)."""
    cfg, params, tp, tcfg = setup
    prompt = _prompt(plen, plen)
    sp = SamplingParams(max_new_tokens=10, temperature=0.8, top_k=5,
                        seed=plen)
    sched = Scheduler(_engine(tp, tcfg, num_slots=3), max_queue=4)
    h = sched.submit(prompt, sp)
    _drain(sched, [h])
    ref = J.generate_fast(params, cfg, prompt[None], 10, temperature=0.8,
                          top_k=5, seed=plen)[0, plen:].tolist()
    assert h.result(timeout=1) == ref == _solo(tp, tcfg, prompt, sp)


@pytest.mark.parametrize("chunk", [1, 8])
def test_concurrent_requests_isolated(setup, chunk):
    """Requests of different lengths and sampling share the slot batch
    (and a decode chunk); each stream equals its solo run."""
    cfg, params, tp, tcfg = setup
    eng = _engine(tp, tcfg, num_slots=3, decode_chunk=chunk)
    sched = Scheduler(eng, max_queue=16)
    reqs = [(_prompt(3 + 4 * i, 30 + i), SamplingParams(
        max_new_tokens=5 + 3 * i, temperature=0.7 + 0.1 * i,
        top_k=None if i % 2 else 6, top_p=0.9 if i % 2 else None, seed=i))
        for i in range(5)]
    hs = [sched.submit(p, sp) for p, sp in reqs]
    _drain(sched, hs)
    for h, (p, sp) in zip(hs, reqs):
        assert h.result(timeout=1) == _solo(tp, tcfg, p, sp)


def test_eos_token_stops_midstream(setup):
    cfg, params, tp, tcfg = setup
    prompt = _prompt(6, 3)
    ref = _solo(tp, tcfg, prompt, SamplingParams(max_new_tokens=12,
                                                 top_k=3, seed=4))
    eos = ref[4]
    stop = ref.index(eos)
    sched = Scheduler(_engine(tp, tcfg, num_slots=2, decode_chunk=4))
    h = sched.submit(prompt, SamplingParams(max_new_tokens=12, top_k=3,
                                            seed=4, eos_token=eos))
    _drain(sched, [h])
    assert h.result(timeout=1) == ref[:stop + 1]


@pytest.mark.parametrize("chunk", [1, 4])
def test_teacher_forcing_logits_match_dense_forward(setup, chunk):
    """Feed the true token each step: the engine's logits are the JAX dense
    forward's at each position (a chunked engine steps once per forced
    token)."""
    cfg, params, tp, tcfg = setup
    seq = _prompt(16, 7)[None]
    full = full_forward(cfg, params, seq)
    eng = _engine(tp, tcfg, num_slots=3, decode_chunk=chunk)
    slot, _ = eng.admit(seq[0, :6], SamplingParams(max_new_tokens=16))
    for j in range(6, 16):
        eng.step(override_tokens={slot: int(seq[0, j])})
        np.testing.assert_allclose(eng.last_logits[slot], full[0, j],
                                   rtol=1e-4, atol=1e-5)


def test_prompt_bucketing_bounds_prefill_shapes(setup):
    cfg, params, tp, tcfg = setup
    eng = _engine(tp, tcfg, num_slots=2)
    sched = Scheduler(eng, max_queue=64)
    hs = [sched.submit(_prompt(n, 200 + n), SamplingParams(
        max_new_tokens=2, seed=n)) for n in range(1, 33)]
    _drain(sched, hs)
    assert all(len(h.result(timeout=1)) == 2 for h in hs)
    bound = max_prefill_buckets(cfg.block_size)
    assert bound == 7
    assert len(eng.stats.prefill_buckets) <= bound
    assert eng.stats.prefill_compiles <= bound
    assert eng.stats.prefills == 32


def test_prompt_bucket_function():
    assert [prompt_bucket(n, 64) for n in (1, 2, 3, 5, 8, 9, 33, 64)] \
        == [1, 2, 4, 8, 8, 16, 64, 64]
    assert prompt_bucket(1000, 64) == 64
    with pytest.raises(ValueError):
        prompt_bucket(0, 64)
    assert max_prefill_buckets(1024) == 11


def test_submit_backpressure(setup):
    cfg, params, tp, tcfg = setup
    sched = Scheduler(_engine(tp, tcfg, num_slots=1), max_queue=2)
    for i in range(2):
        sched.submit(_prompt(4, i), SamplingParams(max_new_tokens=4))
    with pytest.raises(QueueFullError):
        sched.submit(_prompt(4, 9), SamplingParams(max_new_tokens=4),
                     block=False)
    with pytest.raises(QueueFullError):
        sched.submit(_prompt(4, 9), SamplingParams(max_new_tokens=4),
                     timeout=0.05)
    for _ in range(200):
        sched.step()
        if sched.queue_depth() == 0 and sched.active_requests() == 0:
            break
    sched.submit(_prompt(4, 9), SamplingParams(max_new_tokens=4),
                 block=False)


def test_oversized_request_rejected_typed(setup):
    cfg, params, tp, tcfg = setup
    sched = Scheduler(_engine(tp, tcfg, num_slots=2), max_queue=4)
    with pytest.raises(ValueError, match="exceeds the KV cache"):
        sched.submit(_prompt(40, 0), SamplingParams(max_new_tokens=40))
    with pytest.raises(ValueError, match="exceeds the KV cache"):
        T.generate_fast(tp, tcfg, _prompt(40, 0)[None], 40)
    with pytest.raises(ValueError, match="token ids"):
        sched.submit(np.asarray([1, 2, V]), SamplingParams(max_new_tokens=2))
    with pytest.raises(ValueError, match="temperature"):
        sched.submit(_prompt(4, 0), SamplingParams(max_new_tokens=2,
                                                   temperature=0.0))


def test_shutdown_answers_running_fails_queued(setup):
    cfg, params, tp, tcfg = setup
    sched = Scheduler(_engine(tp, tcfg, num_slots=1), max_queue=8)
    running = sched.submit(_prompt(4, 0), SamplingParams(max_new_tokens=6))
    queued = sched.submit(_prompt(4, 1), SamplingParams(max_new_tokens=6))
    sched.step()
    assert running.status is RequestStatus.RUNNING
    sched.shutdown(finish_running=True)
    assert running.status is RequestStatus.DONE
    assert len(running.result(timeout=1)) == 6
    assert queued.status is RequestStatus.FAILED
    with pytest.raises(RuntimeError, match="shutting down"):
        queued.result(timeout=1)
    with pytest.raises(RuntimeError, match="shutting down"):
        sched.submit(_prompt(4, 2), SamplingParams(max_new_tokens=2))


def test_scheduler_threaded_run_loop(setup):
    cfg, params, tp, tcfg = setup
    sched = Scheduler(_engine(tp, tcfg, num_slots=2), max_queue=8)
    stop = threading.Event()
    t = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    t.start()
    try:
        hs = [sched.submit(_prompt(5, i), SamplingParams(
            max_new_tokens=5, seed=i)) for i in range(4)]
        for h in hs:
            assert len(h.result(timeout=60)) == 5
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()


# -- the whole mixed workload against gym_tpu's engine ----------------------

MIXES = {
    "unpaged": dict(num_slots=4, decode_chunk=4),
    "paged": dict(num_slots=4, decode_chunk=4, paged=True, page_size=8),
    "spec": dict(num_slots=4, decode_chunk=2, paged=True, page_size=8,
                 spec_tokens=4),
    "park_resume": dict(num_slots=4, decode_chunk=4, paged=True,
                        page_size=8),
}


def _workload():
    """12 requests: every third shares a 16-token prefix (two pages of 8),
    one a fully block-aligned repeat (the copy-on-write path); top-k and
    top-p; one with an EOS token."""
    rng = np.random.default_rng(11)
    shared = _prompt(16, 99)
    out = []
    for i in range(12):
        if i % 3 == 0:
            p = np.concatenate([shared, _prompt(int(rng.integers(1, 9)), i)])
        elif i == 7:
            p = shared.copy()
        else:
            p = _prompt(int(rng.integers(3, 24)), 50 + i)
        kw = dict(temperature=0.9, top_k=5) if i % 2 else dict(top_p=0.9)
        out.append((p, dict(max_new_tokens=int(rng.integers(4, 14)), seed=i,
                            eos_token=3 if i == 5 else None, **kw)))
    return out


def _serve(mod_engine, mod_sched, params, cfg, mix, **device):
    work = _workload()
    kw = dict(MIXES[mix])
    eng = mod_engine.InferenceEngine(params, cfg, **kw, **device)
    sched = mod_sched.Scheduler(eng, max_queue=64, prefix_window=4,
                                preempt=mix == "park_resume")
    if mix == "park_resume":
        # batch-class requests fill the slots; interactive ones arrive a
        # chunk later and park them
        hs = [sched.submit(p, mod_engine.SamplingParams(**k),
                           slo_class="batch") for p, k in work[:6]]
        sched.step()
        hs += [sched.submit(p, mod_engine.SamplingParams(**k),
                            slo_class="interactive") for p, k in work[6:]]
    else:
        hs = [sched.submit(p, mod_engine.SamplingParams(**k))
              for p, k in work]
    for _ in range(5000):
        if all(h.status in (mod_sched.RequestStatus.DONE,
                            mod_sched.RequestStatus.FAILED) for h in hs):
            break
        sched.step()
    return [h.result(timeout=1) for h in hs], eng.stats


@pytest.mark.parametrize("mix", list(MIXES))
def test_mixed_workload_matches_gym_tpu_engine(setup, mix):
    cfg, params, tp, tcfg = setup
    ref, ref_stats = _serve(JE, JS, params, cfg, mix)
    got, stats = _serve(TE, TS, tp, tcfg, mix, device="cpu")
    assert got == ref
    for name in COUNTERS:
        assert getattr(stats, name) == getattr(ref_stats, name), name
    if mix != "unpaged":
        assert stats.prefix_hit_blocks > 0
    if mix == "spec":
        assert stats.spec_drafted > 0
    if mix == "park_resume":
        assert stats.preemptions > 0 and stats.resumes > 0
    # every stream is also the port's generate_fast
    for (p, kw), toks in zip(_workload(), got):
        sp = SamplingParams(**kw)
        solo = _solo(tp, tcfg, p, sp)
        if sp.eos_token is not None and sp.eos_token in solo:
            solo = solo[:solo.index(sp.eos_token) + 1]
        assert toks == solo
