"""The port's device-program registry (``gym_tpu_torch/programs/``),
twinned with ``tests/test_programs.py``, on the CPU.

- keys: deterministic, and config, shape and dtype each change them;
- single flight: N threads asking for one key build it once; an owner's
  lock is held around every build of its programs;
- pinning: LRU eviction takes only unpinned entries, a dead owner's pins
  go with it, ``discard`` drops a torn-down owner's programs;
- warmup: builds a family, single-flights with a racing request, skips a
  program whose engine closed, and survives a failing builder;
- the counters: ``programs_compiled`` is the kernel library's ``nvcc``
  builds (none here), ``graphs_captured`` the graphs (none on the CPU);
  ``enable_disk_tier`` refuses by name;
- the engine's family: the JAX engine's ``warmup_defs`` names, built once
  each, after which no request builds anything, and the staged programs'
  streams equal the eager engine's and ``generate_fast``'s (the programs'
  graph twins are held to these on the card, ``test_torch_kernels_gpu``).
"""

import threading
import time

import numpy as np
import pytest
import torch

from gym_tpu.serve.engine import InferenceEngine as JEngine
from gym_tpu_torch.models import nanogpt as T
from gym_tpu_torch.programs import (ProgramDef, ProgramOwnerClosedError,
                                    ProgramRegistry, StagedProgram,
                                    WarmupThread, enable_disk_tier,
                                    program_key, warm_engine_programs,
                                    xla_compile_counter)
from gym_tpu_torch.serve import (InferenceEngine, RequestStatus,
                                 SamplingParams, Scheduler)
from test_torch_decode import J, numpy_params, port_config

V = 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """2L/2H/32d, block 32: the JAX config and the port's, the JAX
    engine's program family names, and the port's weights."""
    from gym_tpu_torch.convert import serving_params_from_jax
    cfg = J.GPTConfig(block_size=32, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    params = numpy_params(cfg, 4)
    jnames = {}
    for kw in (dict(decode_chunk=2), dict(decode_chunk=2, paged=True,
                                          page_size=8, spec_tokens=2)):
        eng = JEngine(params, cfg, num_slots=2, **kw)
        jnames[kw.get("paged", False)] = [
            d.name for d in eng.warmup_defs()]
    return port_config(cfg), serving_params_from_jax(params, "cpu"), jnames


def _fake_def(name, calls, lock=None):
    def builder():
        calls.append(name)
        time.sleep(0.005)        # widen the race window for the threads
        return lambda *a: (name, len(calls))

    return ProgramDef(name=name, config={"n": name}, args=(),
                      builder=builder, lock=lock)


class _Owner:
    """weakref-able stand-in for the engine that pins its programs."""


def test_program_key_deterministic_and_shape_sensitive():
    args = ((("x", ((4, 8), np.float32)),),)
    canon_a, ha = program_key("p", {"k": 1}, args)
    assert (canon_a, ha) == program_key("p", {"k": 1}, args)
    assert program_key("p", {"k": 2}, args)[1] != ha
    assert program_key("p", {"k": 1},
                       ((("x", ((4, 9), np.float32)),),))[1] != ha
    assert program_key("p", {"k": 1},
                       ((("x", ((4, 8), np.int32)),),))[1] != ha
    t = torch.zeros(4, 8)
    assert program_key("p", {}, (t,)) == program_key(
        "p", {}, (((4, 8), torch.float32),))


def test_n_threads_one_key_exactly_one_build():
    reg = ProgramRegistry()
    calls = []
    lock = threading.RLock()
    pdef = _fake_def("t.sf", calls, lock=lock)
    n = 8
    barrier = threading.Barrier(n)
    results = []

    def worker():
        barrier.wait()
        results.append(reg.acquire(pdef).ensure()())

    threads = [threading.Thread(target=worker) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert calls == ["t.sf"]
    assert len(set(results)) == 1
    c = reg.counters()
    assert c["builds"] == 1 and c["hits"] == n - 1
    # a build holds its owner's lock: while another thread holds it, the
    # build waits (a capture never overlaps its engine's dispatch)
    other = _fake_def("t.locked", calls, lock=lock)
    done = threading.Event()
    with lock:
        t = threading.Thread(
            target=lambda: (reg.acquire(other, eager=True), done.set()))
        t.start()
        time.sleep(0.05)
        assert not done.is_set() and "t.locked" not in calls
    t.join(timeout=30)
    assert done.is_set() and calls[-1] == "t.locked"


def test_eviction_never_evicts_pinned_in_use():
    reg = ProgramRegistry(capacity=2)
    calls = []
    owner = _Owner()
    ha = reg.acquire(_fake_def("t.a", calls), eager=True, pin_owner=owner)
    reg.acquire(_fake_def("t.b", calls), eager=True)
    reg.acquire(_fake_def("t.c", calls), eager=True)
    names = set(reg.keys().values())
    assert "t.a" in names and "t.b" not in names
    assert reg.counters()["evictions"] == 1
    assert ha()[0] == "t.a"
    o2, o3 = _Owner(), _Owner()
    reg.acquire(_fake_def("t.c", calls), pin_owner=o2)
    reg.acquire(_fake_def("t.d", calls), eager=True, pin_owner=o3)
    assert len(reg) == 3 and reg.counters()["evictions"] == 1
    del o3
    import gc
    gc.collect()
    reg.acquire(_fake_def("t.e", calls), eager=True)
    assert "t.d" not in set(reg.keys().values())
    # a torn-down owner's entries go whatever their pins; the built
    # programs come back for the owner to free
    key_a = next(k for k, v in reg.keys().items() if v == "t.a")
    built = reg.discard([key_a, "no-such-key"])
    assert len(built) == 1 and "t.a" not in set(reg.keys().values())
    with pytest.raises(KeyError, match="evicted"):
        reg.acquire(_fake_def("t.x", calls))._registry._ensure_built(
            "no-such-key")


def test_warmup_single_flights_with_requests_and_survives_failures():
    reg = ProgramRegistry()
    calls = []
    defs = [_fake_def(f"t.w[{i}]", calls) for i in range(6)]
    t = WarmupThread(defs, registry=reg)
    t.start()
    reg.acquire(defs[3]).ensure()           # a request racing the warmup
    assert t.wait(timeout=30)
    assert t.stats()["warmed"] == 6 and t.stats()["done"]
    assert sorted(calls) == sorted(f"t.w[{i}]" for i in range(6))
    assert reg.counters()["builds"] == 6
    # a closed owner's program is skipped; a failing builder aborts the
    # warmup, logged, without raising
    closed = ProgramDef(name="t.closed", config={}, args=(),
                        builder=lambda: (_ for _ in ()).throw(
                            ProgramOwnerClosedError("engine closed")))
    bad = ProgramDef(name="t.bad", config={"b": 1}, args=(),
                     builder=lambda: (_ for _ in ()).throw(
                         RuntimeError("builder exploded")))
    logs = []
    t = WarmupThread([closed, _fake_def("t.ok", calls), bad],
                     registry=reg, log=logs.append)
    t.start()
    assert t.wait(timeout=30)
    assert t.stats()["warmed"] == 1 and t.skipped == 1
    assert any("aborted" in line for line in logs)


def test_counters_and_no_disk_tier():
    c = ProgramRegistry().counters()
    assert set(c) == {"hits", "builds", "xla_compiles", "disk_hits",
                      "compile_seconds", "evictions", "programs",
                      "graphs_captured"}
    assert xla_compile_counter() == 0       # no nvcc on the CPU
    with pytest.raises(NotImplementedError, match="enable_disk_tier"):
        enable_disk_tier("/nonexistent")


def test_staged_program_stages_and_packs():
    """Inputs are staged by name into one buffer, outputs come back in
    the function's order whatever their item sizes."""
    def fn(a, b):
        return (a > 0, (a.float() * b[0]).to(torch.float32), a + 1)

    prog = StagedProgram("t.staged", fn, {"a": ((3,), np.int32),
                                          "b": ((1,), np.float32)},
                         "cpu", capture=True, warm={"b": 2.0})
    assert not prog.captured
    out = prog(a=np.array([1, -2, 3]), b=0.5)
    assert out[0].dtype == np.bool_ and out[0].tolist() == [True, False,
                                                            True]
    assert out[1].tolist() == [0.5, -1.0, 1.5]
    assert out[2].dtype == np.int32 and out[2].tolist() == [2, -1, 4]
    with pytest.raises(ValueError, match="inputs"):
        prog(a=np.zeros(3))
    prog.close()
    with pytest.raises(RuntimeError, match="closed"):
        prog(a=np.zeros(3), b=1.0)


def _serve(eng, workload):
    sched = Scheduler(eng, max_queue=len(workload))
    handles = [sched.submit(p, SamplingParams(**kw)) for p, kw in workload]
    for _ in range(5000):
        if all(h.status in (RequestStatus.DONE, RequestStatus.FAILED)
               for h in handles):
            break
        sched.step()
    return [h.result(timeout=5) for h in handles]


@pytest.mark.parametrize("paged", [False, True])
def test_warmed_engine_serves_with_zero_builds(tiny, paged):
    """The family of the JAX engine, warmed once each in the background;
    afterwards no request (every bucket, sampled and greedy) builds
    anything, and the streams equal ``generate_fast``'s."""
    cfg, tp, jnames = tiny
    kw = (dict(paged=True, page_size=8, spec_tokens=2) if paged else {})
    reg = ProgramRegistry()
    eng = InferenceEngine(tp, cfg, num_slots=2, decode_chunk=2,
                          device="cpu", registry=reg, **kw)
    assert [d.name for d in eng.warmup_defs()] == jnames[paged]
    warm = warm_engine_programs(eng, registry=reg)
    assert warm.wait(timeout=120)
    st = warm.stats()
    assert st["warmed"] == st["total"] == len(jnames[paged])
    builds0 = reg.counters()["builds"]
    rng = np.random.default_rng(0)
    work = [(rng.integers(0, V, n).astype(np.int32),
             dict(max_new_tokens=3, temperature=0.9, top_k=8, seed=n))
            for n in (1, 2, 5, 9, 17, 29)]
    work.append((work[4][0], dict(max_new_tokens=3, top_k=1)))
    got = _serve(eng, work)
    assert reg.counters()["builds"] == builds0
    assert eng.stats.prefill_compiles == 0
    for (p, kw_), toks in zip(work, got):
        want = T.generate_fast(tp, cfg, p[None], kw_["max_new_tokens"],
                               **{k: v for k, v in kw_.items()
                                  if k != "max_new_tokens"})
        assert toks == want[0, len(p):].tolist()
    # teardown frees the engine's programs and refuses new builds
    n = len(reg)
    eng.close()
    assert len(reg) == n - len(jnames[paged]) and eng.closed
    with pytest.raises(ProgramOwnerClosedError):
        eng._program("prefill", 4)
    # an engine dropped without close frees its programs as well: the
    # registry reaches it only weakly
    other = InferenceEngine(tp, cfg, num_slots=2, device="cpu",
                            registry=reg, **kw)
    warm_engine_programs(other, registry=reg, start=False).run()
    assert len(reg) > n - len(jnames[paged])
    del other
    import gc
    gc.collect()
    assert len(reg) == n - len(jnames[paged])
