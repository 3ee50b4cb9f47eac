"""The port's quantized serving (int8/int4 weights, int8 KV) on the CPU,
twinned against ``gym_tpu``'s engine (``tests/test_serve_paged.py``'s
quantized cases) on the same numpy-seeded weights: the JAX engine gets the
JAX package's quantized tree, the port's the f32 tree carried across
(``convert.serving_params_from_jax``), quantized at its construction.

Every port stream equals the JAX engine's token for token and the port's
own quantized ``generate_fast``:

- prefix sharing and copy-on-write triple exactness, ``kv_dtype`` f32 and
  int8; churn through one pool under int8 weights and int8 KV, paged and
  unpaged (int4 weights and embedding); speculative decoding; a NaN
  planted in the scale pool quarantines its slot only;
- the int8 pool holds at least 4× the f32 pool's resident prefix blocks
  at no more payload bytes (``kv_pool_bytes``,
  ``kv_blocks_capacity_effective``), with the JAX engine's counts;
- the divergence from f32 is measured, never asserted zero; bad dtypes
  are refused; ``serve.csv`` carries the dtype columns;
- program names carry the dtypes, so an f32 engine and an int8 one share
  no program;
- both packages' servers over HTTP on the quantized weights: streams
  equal, ``/stats`` echoes the dtypes; ``--quant-embed`` alone exits 2.
"""

import dataclasses
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.models import nanogpt as J
from gym_tpu.serve import engine as JE
from gym_tpu.serve import scheduler as JS
from gym_tpu.serve.load import quantize_params as j_quantize
from gym_tpu_torch.convert import serving_params_from_jax
from gym_tpu_torch.models import nanogpt as T
from gym_tpu_torch.serve import engine as TE
from gym_tpu_torch.serve import scheduler as TS
from gym_tpu_torch.serve import (InferenceEngine, RequestStatus,
                                 SamplingParams, Scheduler, ServeMetrics,
                                 read_headline)
from test_torch_decode import numpy_params, port_config

V = 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    cfg = J.GPTConfig(block_size=64, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    params = numpy_params(cfg, 2)
    return cfg, params, serving_params_from_jax(params, "cpu")


def _quant(setup, weights_dtype="f32", kv_dtype="int8", quant_embed=False):
    """(JAX config, JAX quantized tree, port config, port f32 tree)."""
    cfg, params, tp = setup
    qcfg = dataclasses.replace(cfg, weights_dtype=weights_dtype,
                               kv_dtype=kv_dtype, quant_embed=quant_embed)
    return qcfg, j_quantize(params, qcfg), port_config(qcfg), tp


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, V, n).astype(np.int32)


def _run_one(eng, prompt, sp):
    slot, ev = eng.admit(prompt, sp)
    toks = [ev.token]
    while not ev.finished:
        evs = [e for e in eng.step() if e.slot == slot]
        toks.extend(e.token for e in evs)
        ev = evs[-1]
    return toks


def _drain(mod_sched, sched, handles, limit=5000):
    for _ in range(limit):
        if all(h.status in (mod_sched.RequestStatus.DONE,
                            mod_sched.RequestStatus.FAILED)
               for h in handles):
            return
        sched.step()
    raise AssertionError("scheduler did not drain")


def _engines(q, **kw):
    """The JAX engine and the port's over the same quantized weights."""
    jcfg, jparams, tcfg, tp = q
    return (JE.InferenceEngine(jparams, jcfg, **kw),
            InferenceEngine(tp, tcfg, device="cpu", **kw))


def _fast(q, prompt, mnew, **kw):
    """The port's quantized ``generate_fast`` (its f32 tree quantized)."""
    _, _, tcfg, tp = q
    from gym_tpu_torch.serve.load import quantize_params
    return T.generate_fast(quantize_params(tp, tcfg), tcfg, prompt[None],
                           mnew, **kw)[0, len(prompt):].tolist()


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_prefix_sharing_exact_under_kv_dtype(setup, kv_dtype):
    q = _quant(setup, kv_dtype=kv_dtype)
    shared = _prompt(24, 170)
    pa = np.concatenate([shared, _prompt(4, 171)])
    pb = np.concatenate([shared, _prompt(4, 172)])
    kw = dict(temperature=0.8, top_k=5)
    streams = []
    for eng in _engines(q, num_slots=2, paged=True, page_size=8):
        ra = _run_one(eng, pa, SamplingParams(max_new_tokens=6, seed=1,
                                              **kw))
        before = eng.stats.prefill_tokens
        rb = _run_one(eng, pb, SamplingParams(max_new_tokens=6, seed=2,
                                              **kw))
        assert eng.stats.prefix_hit_blocks == 3
        assert eng.stats.prefill_tokens - before == 4
        streams.append((ra, rb))
    assert streams[1] == streams[0]
    assert streams[1] == (_fast(q, pa, 6, seed=1, **kw),
                          _fast(q, pb, 6, seed=2, **kw))


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_cow_triple_exact_under_kv_dtype(setup, kv_dtype):
    q = _quant(setup, kv_dtype=kv_dtype)
    p16 = _prompt(16, 180)
    streams = []
    for eng in _engines(q, num_slots=2, paged=True, page_size=8):
        r1 = _run_one(eng, p16, SamplingParams(max_new_tokens=5, top_k=4,
                                               seed=3))
        before = eng.stats.prefill_tokens
        r2 = _run_one(eng, p16, SamplingParams(max_new_tokens=5, top_k=4,
                                               seed=4))
        assert eng.stats.prefill_tokens - before == 1
        r3 = _run_one(eng, p16, SamplingParams(max_new_tokens=5, top_k=4,
                                               seed=3))
        streams.append((r1, r2, r3))
    assert streams[1] == streams[0]
    r1, r2, r3 = streams[1]
    assert r1 == r3 == _fast(q, p16, 5, top_k=4, seed=3)
    assert r2 == _fast(q, p16, 5, top_k=4, seed=4)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_churn_isolated_under_int8_weights_and_kv(setup, paged):
    """Mixed concurrent requests through one quantized engine: paged with
    int8 weights, unpaged with int4 weights and embedding; every stream
    equals the JAX engine's and its solo ``generate_fast``, and a paged
    pool drains to zero."""
    q = (_quant(setup, weights_dtype="int8") if paged else
         _quant(setup, weights_dtype="int4", quant_embed=True))
    kw = dict(temperature=0.9, top_k=7, top_p=0.95)
    work = [(_prompt(plen, 190 + i), mnew)
            for i, (plen, mnew) in enumerate([(5, 7), (9, 12), (17, 9),
                                              (8, 15)])]
    results = []
    engine_kw = dict(num_slots=2, decode_chunk=4, paged=paged)
    if paged:
        engine_kw["page_size"] = 8
    for mod_sched, eng in zip((JS, TS), _engines(q, **engine_kw)):
        sched = mod_sched.Scheduler(eng, max_queue=8)
        handles = [sched.submit(p, _sp(eng, mnew, i, **kw))
                   for i, (p, mnew) in enumerate(work)]
        _drain(mod_sched, sched, handles)
        results.append([h.result(timeout=1) for h in handles])
        assert eng.stats.kv_blocks_in_use == 0
    assert results[1] == results[0]
    for i, ((p, mnew), got) in enumerate(zip(work, results[1])):
        assert got == _fast(q, p, mnew, seed=i, **kw)


def _sp(eng, mnew, seed, **kw):
    """The engine's own package's SamplingParams."""
    mod = JE if isinstance(eng, JE.InferenceEngine) else TE
    return mod.SamplingParams(max_new_tokens=mnew, seed=seed, **kw)


def test_quantized_spec_decode_exact(setup):
    q = _quant(setup, weights_dtype="int8")
    prompt = _prompt(10, 121)
    kw = dict(temperature=0.9, top_k=7, seed=5)
    got = []
    for eng in _engines(q, num_slots=2, paged=True, page_size=8,
                        decode_chunk=3, spec_tokens=3):
        got.append(_run_one(eng, prompt, _sp(eng, 12, **kw)))
        assert eng.stats.spec_drafted > 0
    assert got[1] == got[0] == _fast(q, prompt, 12, **kw)


def test_quarantine_under_int8_kv(setup):
    """A NaN in a slot's page of the f32 SCALE pools (int8 cannot hold
    one) reaches that slot's logits through B7 int8's dequant: the slot is
    quarantined, its neighbour stays clean, in both engines."""
    q = _quant(setup)
    jeng, teng = _engines(q, num_slots=2, paged=True, page_size=8,
                          decode_chunk=4)
    outs = []
    for eng in (jeng, teng):
        slot, _ = eng.admit(_prompt(8, 1), _sp(eng, 3, 0))
        other, _ = eng.admit(_prompt(6, 2), _sp(eng, 8, 0))
        pg = int(eng._bt[slot, 0])
        if eng is jeng:
            eng._cache = jax.tree.map(
                lambda x: x.at[pg].set(jnp.nan)
                if x.dtype == jnp.float32 else x, eng._cache)
        else:
            for name, c in eng._cache.items():
                if c.dtype == torch.float32:
                    c[pg] = float("nan")
        evs = eng.step()
        mine = [e for e in evs if e.slot == slot]
        assert mine and all(e.poisoned for e in mine)
        assert eng.stats.quarantined == 1
        assert all(not e.poisoned for e in evs if e.slot == other)
        outs.append([(e.slot, e.token, e.poisoned) for e in evs
                     if e.slot == other])
    assert outs[1] == outs[0]


def test_int8_kv_capacity_4x_structural(setup):
    """At the same KV payload bytes (4 int8 pages a f32 page) the int8
    pool holds >= 4x the resident prefix blocks, deterministically; the
    port's counters and byte counts are the JAX engine's."""
    cfg, params, tp = setup
    q = _quant(setup)
    f32_pages = 2 + cfg.block_size // 8        # the least legal pool: 10
    int8_pages = 1 + (f32_pages - 1) * 4       # equal payload bytes: 37

    def arm(eng):
        for i in range(48):
            _run_one(eng, _prompt(8, 700 + i), _sp(eng, 2, i))
        return eng

    f32 = [arm(e) for e in (
        JE.InferenceEngine(params, cfg, num_slots=2, paged=True,
                           page_size=8, kv_pages=f32_pages),
        InferenceEngine(tp, port_config(cfg), num_slots=2, paged=True,
                        page_size=8, kv_pages=f32_pages, device="cpu"))]
    int8 = [arm(e) for e in _engines(q, num_slots=2, paged=True,
                                     page_size=8, kv_pages=int8_pages)]
    for jeng, teng in (f32, int8):
        assert teng.kv_pool_bytes() == jeng.kv_pool_bytes()
        assert teng.stats.kv_blocks_cached == jeng.stats.kv_blocks_cached
        assert (teng.kv_blocks_capacity_effective
                == jeng.kv_blocks_capacity_effective)
        assert teng.kv_elem_bytes == jeng.kv_elem_bytes
    f32_eng, int8_eng = f32[1], int8[1]
    f32_bytes, int8_bytes = f32_eng.kv_pool_bytes(), int8_eng.kv_pool_bytes()
    assert int8_bytes["payload"] <= f32_bytes["payload"]
    assert f32_bytes["scales"] == 0 and int8_bytes["scales"] > 0
    assert (int8_eng.stats.kv_blocks_cached
            >= 4 * f32_eng.stats.kv_blocks_cached)
    assert (int8_eng.kv_blocks_capacity_effective == 4 * (int8_pages - 1)
            > f32_eng.kv_blocks_capacity_effective)
    assert InferenceEngine(tp, port_config(cfg), num_slots=1,
                           device="cpu").kv_blocks_capacity_effective == 0


def test_f32_vs_int8_divergence_measured_separately(setup):
    """f32 and int8 streams may diverge: each equals its own reference
    and the divergence is a measurement, never asserted zero."""
    cfg, params, tp = setup
    q = _quant(setup, weights_dtype="int8")
    prompt = _prompt(12, 131)
    kw = dict(temperature=0.9, top_k=7, seed=9)
    ref_f32 = T.generate_fast(tp, port_config(cfg), prompt[None], 16,
                              **kw)[0, 12:].tolist()
    got = [_run_one(eng, prompt, _sp(eng, 16, **kw))
           for eng in _engines(q, num_slots=2, paged=True, page_size=8)]
    assert got[1] == got[0] == _fast(q, prompt, 16, **kw)
    div = sum(a != b for a, b in zip(got[1], ref_f32)) / len(got[1])
    assert 0.0 <= div <= 1.0


def test_engine_rejects_bad_quant_dtypes(setup):
    cfg, params, tp = setup
    tcfg = port_config(cfg)
    with pytest.raises(ValueError, match="weights_dtype"):
        InferenceEngine(tp, dataclasses.replace(tcfg, weights_dtype="fp8"),
                        num_slots=1, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(tp, dataclasses.replace(tcfg, kv_dtype="int4"),
                        num_slots=1, device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        T.GPT(dataclasses.replace(tcfg, kv_dtype="fp8"))


def test_program_names_carry_the_dtypes(setup):
    """An int8 engine's programs are named for its dtypes and share no
    registry key with an f32 engine's; its caches hold int8 K/V with f32
    scales, its weights int8 kernels."""
    cfg, params, tp = setup
    _, _, tcfg, _ = _quant(setup, weights_dtype="int8", quant_embed=True)
    f32 = InferenceEngine(tp, port_config(cfg), num_slots=1, paged=True,
                          page_size=8, device="cpu")
    q = InferenceEngine(tp, tcfg, num_slots=1, paged=True, page_size=8,
                        device="cpu")
    names = [d.name for d in q.warmup_defs()]
    assert names == ([f"serve.paged_decode[slots=1,chunk=1,w=int8+emb,"
                      f"kv=int8]", "serve.cow[page=8,w=int8+emb,kv=int8]"]
                     + [f"serve.paged_prefill[bucket={b},w=int8+emb,kv=int8]"
                        for b in (1, 2, 4, 8, 16, 32, 64)])
    fkeys = {d.key()[1] for d in f32.warmup_defs()}
    assert fkeys.isdisjoint(d.key()[1] for d in q.warmup_defs())
    assert q.params["h_0.attn.c_attn.qkernel"].dtype == torch.int8
    assert q.params["wte.qembedding"].dtype == torch.int8
    assert "wte.embedding" not in q.params
    assert q._cache["h_1.attn.v"].dtype == torch.int8
    assert q._cache["h_1.attn.v_scale"].shape == q._cache["h_1.attn.v"]\
        .shape[:3]
    assert q.weights_bytes < f32.weights_bytes / 2
    assert q.stats.weights_dtype == "int8" and q.stats.kv_dtype == "int8"
    unpaged = InferenceEngine(tp, tcfg, num_slots=2, device="cpu")
    assert [d.name for d in unpaged.warmup_defs()][:2] == [
        "serve.decode[slots=2,chunk=1,w=int8+emb,kv=int8]",
        "serve.admit[slots=2,w=int8+emb,kv=int8]"]


def test_metrics_quant_columns(setup, tmp_path):
    _, _, tcfg, tp = _quant(setup, weights_dtype="int8")
    eng = InferenceEngine(tp, tcfg, num_slots=2, paged=True, page_size=8,
                          device="cpu")
    metrics = ServeMetrics(str(tmp_path), engine_log_every=1)
    sched = Scheduler(eng, max_queue=8, metrics=metrics)
    h = sched.submit(_prompt(6, 41), SamplingParams(max_new_tokens=3))
    while h.status in (RequestStatus.QUEUED, RequestStatus.RUNNING):
        sched.step()
        metrics.engine_tick(eng.stats, queue_depth=sched.queue_depth())
    metrics.sync()
    head = metrics.headline()
    assert head["weights_dtype"] == "int8" and head["kv_dtype"] == "int8"
    csv_path = os.path.join(str(tmp_path), "serve.csv")
    with open(csv_path) as f:
        header = f.readline().strip().split(",")
    assert "weights_dtype" in header and "kv_dtype" in header
    post = read_headline(csv_path)
    assert post["weights_dtype"] == "int8" and post["kv_dtype"] == "int8"
    metrics.close()


# -- both servers over HTTP ---------------------------------------------------


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    r = urllib.request.urlopen(req, timeout=120)
    return r.status, json.loads(r.read())


def _stats(port):
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=30).read())


def test_http_quantized_streams_equal_the_jax_server(tmp_path):
    """``--quant int8 --kv-quant int8`` as both servers' ``main`` loads it
    (the run's weights quantized at load), over HTTP: equal streams, and
    ``/stats`` echoes the dtypes and the int8 pool's capacity."""
    from gym_tpu.serve.__main__ import create_server as jcreate
    from gym_tpu_torch.serve.__main__ import create_server as tcreate
    from gym_tpu_torch.serve.load import quantize_params
    cfg = J.GPTConfig(block_size=32, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    jcfg = dataclasses.replace(cfg, weights_dtype="int8", kv_dtype="int8")
    params = numpy_params(cfg, 11)
    tcfg = port_config(jcfg)
    handles = {
        "jax": jcreate(j_quantize(params, jcfg), jcfg, port=0, num_slots=2,
                       metrics_dir=str(tmp_path / "j"), warmup=False,
                       dispatch_timeout=60.0),
        "torch": tcreate(quantize_params(serving_params_from_jax(
            params, "cpu"), tcfg), tcfg, port=0, num_slots=2,
            metrics_dir=str(tmp_path / "t"), device="cpu",
            dispatch_timeout=60.0)}
    threads = []
    for h in handles.values():
        threads.append(threading.Thread(target=h.httpd.serve_forever,
                                        daemon=True))
        threads[-1].start()
    reqs = [{"prompt": [1, 2, 3], "max_new_tokens": 8, "top_k": 1},
            {"prompt": [5, 7, 9, 11], "max_new_tokens": 8,
             "temperature": 0.8, "top_k": 5, "seed": 4},
            {"prompt": [2, 3], "max_new_tokens": 6, "top_p": 0.9,
             "seed": 7}]
    try:
        assert handles["torch"].warmup.wait(timeout=60)
        outs = {name: [_post(h.port, r) for r in reqs]
                for name, h in handles.items()}
        assert all(code == 200 for code, _ in outs["torch"])
        assert [b["tokens"] for _, b in outs["torch"]] == \
            [b["tokens"] for _, b in outs["jax"]]
        js, ts = _stats(handles["jax"].port), _stats(handles["torch"].port)
        for key in ("weights_dtype", "kv_dtype",
                    "kv_blocks_capacity_effective", "kv_pages"):
            assert ts[key] == js[key], key
        assert ts["weights_dtype"] == ts["kv_dtype"] == "int8"
        assert ts["kv_blocks_capacity_effective"] == 4 * (ts["kv_pages"] - 1)
        assert ts["warmup"]["done"] and ts["warmup"]["warmed"] == 8
    finally:
        for h in handles.values():
            h.close()
        for t in threads:
            t.join(timeout=10)


def test_main_quant_flags(tmp_path, capsys):
    """The three flags are served, not refused: ``--quant-embed`` without
    ``--quant`` is a usage error (exit 2); with ``--quant`` they reach the
    loader (a missing run dir exits 1, "cannot load")."""
    from gym_tpu_torch.serve.__main__ import _build_parser, main
    args = _build_parser().parse_args(["--ckpt", str(tmp_path), "--quant",
                                       "int4", "--quant-embed",
                                       "--kv-quant", "int8"])
    assert (args.quant, args.quant_embed, args.kv_quant) == (
        "int4", True, "int8")
    with pytest.raises(SystemExit) as e:
        main(["--ckpt", str(tmp_path), "--quant-embed", "--device", "cpu"])
    assert e.value.code == 2
    assert "--quant-embed requires --quant" in capsys.readouterr().err
    assert main(["--ckpt", str(tmp_path / "missing"), "--device", "cpu",
                 "--quant", "int4", "--quant-embed", "--kv-quant",
                 "int8"]) == 1
    assert "cannot load" in capsys.readouterr().err
