"""The port's paged, prefix-shared KV cache and speculative decoding on the
CPU (counterpart of ``tests/test_serve_paged.py``'s f32 cases), held to
``gym_tpu``'s ``generate_fast`` on the same numpy-seeded weights.

- token exactness: the paged engine's streams equal ``generate_fast``'s,
  for a bucket-padded prompt, through shared prefix blocks (admitted
  without prefilling them again), through the copy-on-write path, and for
  requests churning through a shared pool that drains back to zero;
- speculative decoding equals non-speculative decoding, greedy and
  sampled, and stops at an EOS inside an accepted run;
- the allocator's refcounts, LRU eviction and double-free detection; a
  pool too small for every slot queues requests; the NaN quarantine
  catches a slot poisoned mid-chunk; a failed admission releases every
  block; the scheduler's starvation guards and prefix-aware ordering;
- park/resume: a parked slot resumes byte-identical to an uncontended run.
"""

import numpy as np
import pytest
import torch

from gym_tpu.models import nanogpt as J
from gym_tpu_torch.convert import serving_params_from_jax
from gym_tpu_torch.models import nanogpt as T
from gym_tpu_torch.serve import (BlockAllocator, InferenceEngine,
                                 NoFreeBlocksError, RequestStatus,
                                 SamplingParams, Scheduler,
                                 max_prefill_buckets)
from gym_tpu_torch.utils.resilience import faults
from test_torch_decode import numpy_params, port_config

V = 48


@pytest.fixture(scope="module")
def setup():
    cfg = J.GPTConfig(block_size=64, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    params = numpy_params(cfg, 2)
    return cfg, params, serving_params_from_jax(params, "cpu"), \
        port_config(cfg)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, V, n).astype(np.int32)


def _engine(setup, **kw):
    _, _, tp, tcfg = setup
    kw.setdefault("paged", True)
    kw.setdefault("page_size", 8)
    return InferenceEngine(tp, tcfg, device="cpu", **kw)


def _fast(setup, prompt, mnew, **kw):
    _, _, tp, tcfg = setup
    return T.generate_fast(tp, tcfg, prompt[None], mnew,
                           **kw)[0, len(prompt):].tolist()


def _run_one(eng, prompt, sp):
    slot, ev = eng.admit(prompt, sp)
    toks = [ev.token]
    while not ev.finished:
        evs = [e for e in eng.step() if e.slot == slot]
        toks.extend(e.token for e in evs)
        ev = evs[-1]
    return toks


def _drain(sched, handles, limit=5000):
    for _ in range(limit):
        if all(h.status in (RequestStatus.DONE, RequestStatus.FAILED)
               for h in handles):
            return
        sched.step()
    raise AssertionError("scheduler did not drain")


@pytest.mark.parametrize("plen,mnew,kw", [
    (8, 10, dict(temperature=0.8, top_k=5, seed=3)),
    (11, 7, dict(top_p=0.9, seed=5)),
    (16, 5, dict(top_k=1, seed=2)),
], ids=["aligned", "padded", "greedy"])
def test_paged_matches_generate_fast(setup, plen, mnew, kw):
    cfg, params, _, _ = setup
    prompt = _prompt(plen, plen)
    ref = J.generate_fast(params, cfg, prompt[None], mnew,
                          **kw)[0, plen:].tolist()
    got = _run_one(_engine(setup, num_slots=2), prompt,
                   SamplingParams(max_new_tokens=mnew, **kw))
    assert got == ref == _fast(setup, prompt, mnew, **kw)


def test_prefix_sharing_admits_without_reprefill_and_stays_exact(setup):
    shared = _prompt(24, 70)
    pa = np.concatenate([shared, _prompt(4, 71)])
    pb = np.concatenate([shared, _prompt(4, 72)])
    eng = _engine(setup, num_slots=2)
    kw = dict(temperature=0.8, top_k=5)
    ra = _run_one(eng, pa, SamplingParams(max_new_tokens=6, seed=1, **kw))
    assert eng.stats.prefix_hit_blocks == 0
    before = eng.stats.prefill_tokens
    rb = _run_one(eng, pb, SamplingParams(max_new_tokens=6, seed=2, **kw))
    assert eng.stats.prefix_hit_blocks == 3
    assert eng.stats.prefill_tokens - before == 4    # the suffix's bucket
    assert ra == _fast(setup, pa, 6, seed=1, **kw)
    assert rb == _fast(setup, pb, 6, seed=2, **kw)


def test_full_block_aligned_hit_takes_cow_path(setup):
    p16 = _prompt(16, 80)
    eng = _engine(setup, num_slots=2)
    r1 = _run_one(eng, p16, SamplingParams(max_new_tokens=5, top_k=4,
                                           seed=3))
    before = eng.stats.prefill_tokens
    r2 = _run_one(eng, p16, SamplingParams(max_new_tokens=5, top_k=4,
                                           seed=4))
    assert eng.stats.prefill_tokens - before == 1    # one token forwarded
    assert eng.stats.prefix_hit_blocks == 2
    r3 = _run_one(eng, p16, SamplingParams(max_new_tokens=5, top_k=4,
                                           seed=3))
    assert r1 == _fast(setup, p16, 5, top_k=4, seed=3) == r3
    assert r2 == _fast(setup, p16, 5, top_k=4, seed=4)


def test_paged_concurrent_churn_isolated_and_blocks_freed(setup):
    eng = _engine(setup, num_slots=2, decode_chunk=4)
    sched = Scheduler(eng, max_queue=8)
    kw = dict(temperature=0.9, top_k=7, top_p=0.95)
    handles, wants = [], []
    for i, (plen, mnew) in enumerate([(5, 7), (9, 12), (3, 4), (17, 9),
                                      (8, 15)]):
        prompt = _prompt(plen, 100 + i)
        wants.append(_fast(setup, prompt, mnew, seed=i, **kw))
        handles.append(sched.submit(prompt, SamplingParams(
            max_new_tokens=mnew, seed=i, **kw)))
    _drain(sched, handles)
    for h, want in zip(handles, wants):
        assert h.result(timeout=1) == want
    assert eng.stats.kv_blocks_in_use == 0


def test_speculative_greedy_exact_vs_nonspeculative(setup):
    prompt = _prompt(9, 13)
    ref = _fast(setup, prompt, 14, top_k=1, seed=6)
    sp = SamplingParams(max_new_tokens=14, top_k=1, seed=6)
    plain = _engine(setup, num_slots=2, decode_chunk=2)
    spec = _engine(setup, num_slots=2, decode_chunk=2, spec_tokens=4)
    assert _run_one(plain, prompt, sp) == ref
    assert _run_one(spec, prompt, sp) == ref
    assert spec.stats.spec_drafted > 0 and spec.stats.spec_accepted > 0


@pytest.mark.parametrize("kw", [dict(temperature=0.9, top_k=7, seed=5),
                                dict(temperature=1.1, top_p=0.9, seed=8)],
                         ids=["top_k", "top_p"])
def test_speculative_sampling_exact_vs_nonspeculative(setup, kw):
    prompt = _prompt(10, 21)
    spec = _engine(setup, num_slots=2, decode_chunk=3, spec_tokens=3)
    got = _run_one(spec, prompt, SamplingParams(max_new_tokens=12, **kw))
    assert got == _fast(setup, prompt, 12, **kw)


def test_speculative_eos_mid_chunk(setup):
    prompt = _prompt(9, 3)
    ref = _fast(setup, prompt, 12, temperature=0.9, top_k=7, seed=1)
    eos = ref[4]
    stop = ref.index(eos)
    eng = _engine(setup, num_slots=2, decode_chunk=4, spec_tokens=3)
    got = _run_one(eng, prompt, SamplingParams(
        max_new_tokens=12, temperature=0.9, top_k=7, seed=1, eos_token=eos))
    assert got == ref[:stop + 1]


def test_speculative_requires_paged(setup):
    with pytest.raises(ValueError, match="paged"):
        _engine(setup, num_slots=2, spec_tokens=2, paged=False)


def test_paged_prefill_shapes_bounded(setup):
    eng = _engine(setup, num_slots=2)
    sched = Scheduler(eng, max_queue=64)
    hs = [sched.submit(_prompt(n, 200 + n), SamplingParams(
        max_new_tokens=2, seed=n)) for n in range(1, 33)]
    _drain(sched, hs)
    assert all(len(h.result(timeout=1)) == 2 for h in hs)
    assert eng.stats.prefill_compiles <= max_prefill_buckets(64)


def test_allocator_refcount_and_free_list():
    al = BlockAllocator(num_pages=5, page_size=4)
    a, b = al.alloc(), al.alloc()
    assert a != b and 0 not in (a, b)
    assert al.in_use() == 2 and al.available() == 2
    al.incref(a)
    al.decref(a)
    assert al.in_use() == 2
    al.decref(a)
    assert al.in_use() == 1 and al.available() == 3
    with pytest.raises(ValueError, match="double-freed"):
        al.decref(a)
    al.decref(b)
    assert al.available() == 4


def test_allocator_prefix_cache_lru_eviction():
    al = BlockAllocator(num_pages=4, page_size=2)
    p1 = al.alloc()
    c1 = al.register(0, b"aa", p1)
    p2 = al.alloc()
    c2 = al.register(c1, b"bb", p2)
    al.decref(p1)
    al.decref(p2)
    assert al.cached() == 2 and al.available() == 3
    assert al.lookup(0, b"aa")[0] == p1
    assert al.lookup(c1, b"bb")[0] == p2
    p3, p4 = al.alloc(), al.alloc()
    assert {p3, p4} & {p1, p2}
    assert al.cached() == 1
    p5 = al.alloc()
    assert al.cached() == 0
    with pytest.raises(NoFreeBlocksError):
        al.alloc()
    assert al.probe(0, b"aa") is None
    for p in (p3, p4, p5):
        al.decref(p)
    assert c2 != c1


def test_pool_exhaustion_queues_instead_of_failing(setup):
    eng = _engine(setup, num_slots=2, kv_pages=10)
    sched = Scheduler(eng, max_queue=8)
    handles, wants = [], []
    for i in range(4):
        prompt = _prompt(24, 300 + i)
        wants.append(_fast(setup, prompt, 16, temperature=0.9, top_k=7,
                           seed=i))
        handles.append(sched.submit(prompt, SamplingParams(
            max_new_tokens=16, temperature=0.9, top_k=7, seed=i)))
    _drain(sched, handles)
    for h, want in zip(handles, wants):
        assert h.result(timeout=1) == want
    assert eng.stats.kv_blocks_in_use == 0 and eng.stats.active_slots == 0


def test_undersized_pool_rejected_at_construction(setup):
    with pytest.raises(ValueError, match="kv_pages"):
        _engine(setup, num_slots=1, kv_pages=9)
    eng = _engine(setup, num_slots=4, kv_pages=10)
    eng.validate(_prompt(32, 0), SamplingParams(max_new_tokens=32))


def test_paged_nan_quarantine_catches_slot_finishing_mid_chunk(setup):
    """Poison one slot's own pages; it finishes at step 2 of a 4-step
    chunk: its tokens come back poisoned, its neighbour's clean."""
    eng = _engine(setup, num_slots=2, decode_chunk=4)
    slot, _ = eng.admit(_prompt(8, 1), SamplingParams(max_new_tokens=3))
    other, _ = eng.admit(_prompt(6, 2), SamplingParams(max_new_tokens=8))
    pg = int(eng._bt[slot, 0])
    for c in eng._cache.values():
        c[pg] = float("nan")
    evs = eng.step()
    mine = [e for e in evs if e.slot == slot]
    assert mine and all(e.poisoned for e in mine)
    assert eng.stats.quarantined == 1
    assert all(not e.poisoned for e in evs if e.slot == other)
    assert eng.stats.kv_blocks_in_use > 0


def test_failed_admission_releases_every_block(setup):
    eng = _engine(setup, num_slots=2)
    _run_one(eng, _prompt(16, 60), SamplingParams(max_new_tokens=2))
    assert eng.stats.kv_blocks_in_use == 0
    cached = eng.stats.kv_blocks_cached
    faults.reset()
    faults.configure("serve.prefill:oserror")
    try:
        with pytest.raises(OSError):
            eng.admit(np.concatenate([_prompt(16, 60), _prompt(4, 61)]),
                      SamplingParams(max_new_tokens=4))
    finally:
        faults.reset()
    assert eng.stats.kv_blocks_in_use == 0
    assert eng.stats.kv_blocks_cached == cached
    got = _run_one(eng, _prompt(24, 62), SamplingParams(
        max_new_tokens=4, top_k=3, seed=7))
    assert len(got) == 4


def test_starvation_guard_admits_blocked_head(setup):
    eng = _engine(setup, num_slots=2, kv_pages=10)
    sched = Scheduler(eng, max_queue=32, prefix_window=4,
                      starvation_rounds=2)
    big = sched.submit(_prompt(40, 1), SamplingParams(max_new_tokens=24,
                                                      seed=1))
    smalls = [sched.submit(_prompt(8, 10 + i), SamplingParams(
        max_new_tokens=6 + 2 * i, seed=i)) for i in range(6)]
    for _ in range(3000):
        sched.step()
        if big.status is not RequestStatus.QUEUED:
            break
    assert big.status is not RequestStatus.QUEUED
    _drain(sched, [big] + smalls)
    assert len(big.result(timeout=1)) == 24
    for i, h in enumerate(smalls):
        assert len(h.result(timeout=1)) == 6 + 2 * i
    assert eng.stats.kv_blocks_in_use == 0


def test_starvation_guard_covers_prefix_priority(setup):
    shared = _prompt(16, 97)
    eng = _engine(setup, num_slots=1)
    sched = Scheduler(eng, max_queue=64, prefix_window=4,
                      starvation_rounds=3)
    warm = sched.submit(np.concatenate([shared, _prompt(2, 98)]),
                        SamplingParams(max_new_tokens=2, seed=0))
    _drain(sched, [warm])
    cold = sched.submit(_prompt(18, 99), SamplingParams(max_new_tokens=2,
                                                        seed=1))
    hot_seed, hots = 200, []
    for _ in range(400):
        while sum(h.status is RequestStatus.QUEUED for h in hots) < 3:
            hots.append(sched.submit(
                np.concatenate([shared, _prompt(2, hot_seed)]),
                SamplingParams(max_new_tokens=2, seed=hot_seed)))
            hot_seed += 1
        sched.step()
        if cold.status is not RequestStatus.QUEUED:
            break
    assert cold.status is not RequestStatus.QUEUED
    _drain(sched, [cold] + hots)
    assert len(cold.result(timeout=1)) == 2


def test_scheduler_prefix_aware_admit_ordering(setup):
    shared = _prompt(16, 90)
    eng = _engine(setup, num_slots=1)
    sched = Scheduler(eng, max_queue=8, prefix_window=4)
    h0 = sched.submit(np.concatenate([shared, _prompt(2, 91)]),
                      SamplingParams(max_new_tokens=2, seed=0))
    _drain(sched, [h0])
    cold = sched.submit(_prompt(18, 92), SamplingParams(max_new_tokens=2,
                                                        seed=1))
    hot = sched.submit(np.concatenate([shared, _prompt(2, 93)]),
                       SamplingParams(max_new_tokens=2, seed=2))
    sched.step()
    assert hot.status in (RequestStatus.RUNNING, RequestStatus.DONE)
    assert cold.status is RequestStatus.QUEUED
    _drain(sched, [cold, hot])
    schedu = Scheduler(_engine(setup, num_slots=1, paged=False),
                       max_queue=8, prefix_window=4)
    first = schedu.submit(_prompt(6, 94), SamplingParams(max_new_tokens=2,
                                                         seed=3))
    second = schedu.submit(_prompt(6, 95), SamplingParams(max_new_tokens=2,
                                                          seed=4))
    schedu.step()
    assert first.status in (RequestStatus.RUNNING, RequestStatus.DONE)
    assert second.status is RequestStatus.QUEUED
    _drain(schedu, [first, second])


def test_park_resume_exact(setup):
    """A slot parked mid-decode (its pages pinned in the snapshot) while
    another request runs in its place resumes byte-identical to an
    uncontended run."""
    prompt = _prompt(13, 40)
    sp = SamplingParams(max_new_tokens=20, temperature=0.9, top_p=0.9,
                        seed=9)
    ref = _fast(setup, prompt, 20, temperature=0.9, top_p=0.9, seed=9)
    eng = _engine(setup, num_slots=1, decode_chunk=3)
    slot, ev = eng.admit(prompt, sp)
    toks = [ev.token]
    toks += [e.token for e in eng.step()]
    parked = eng.park(slot)
    assert eng.stats.preemptions == 1 and not eng._active.any()
    other = _run_one(eng, _prompt(7, 41), SamplingParams(max_new_tokens=5,
                                                         seed=2))
    assert other == _fast(setup, _prompt(7, 41), 5, seed=2)
    slot = eng.resume(parked)
    while True:
        evs = eng.step()
        toks += [e.token for e in evs]
        if evs[-1].finished:
            break
    assert toks == ref and eng.stats.resumes == 1
    assert eng.stats.kv_blocks_in_use == 0
    with pytest.raises(ValueError, match="consumed"):
        eng.resume(parked)


def test_unpaged_engine_reports_zero_paged_stats(setup):
    eng = _engine(setup, num_slots=2, paged=False)
    _run_one(eng, _prompt(6, 1), SamplingParams(max_new_tokens=3))
    assert eng.stats.kv_blocks_in_use == 0
    assert eng.stats.prefix_hit_blocks == 0
    assert eng.stats.spec_accept_rate() is None
    assert eng.stats.prefill_tokens == 8
    with pytest.raises(ValueError, match="paged"):
        eng.park(0)


def test_later_slices_raise_naming_them(setup):
    _, _, tp, tcfg = setup
    import dataclasses
    with pytest.raises(NotImplementedError, match="later slice"):
        InferenceEngine(tp, dataclasses.replace(tcfg, kv_dtype="int8"),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        _engine(setup, num_slots=1).warmup_defs()
    assert torch.equal(_engine(setup, num_slots=1).params["wte.embedding"],
                       tp["wte.embedding"])
