"""The port's supervisor and in-process fleet (``gym_tpu_torch/serve/
supervisor.py``, ``router.py``), twinned with ``tests/test_serve_chaos.py``'s
supervisor cases and ``tests/test_serve_fleet.py``, on the CPU, every
stream held to the port's ``generate_fast`` (itself held to ``gym_tpu``'s
in ``test_torch_decode.py``).

- supervisor: an engine exception and a wedged dispatch fail the request
  in flight typed and rebuild the engine (which serves exact streams, the
  old engine closed); past ``max_restarts`` the engine is declared dead; a
  request wedged inside admission fails typed; a clean stop is no failure;
- dispatch: least-loaded with the lowest-id tie-break, and prefix-affine;
- failover: a replica killed mid-decode fails over with the exact stream
  under the remaining deadline; a whole dead fleet degrades typed; the
  death window is a health signal; an exhausted deadline is not retried;
- hot swap: under traffic no request fails, the new engines are warmed
  before they serve (no request builds a program) and serve the new
  weights, the old engines are closed; a drain timeout is transient and
  typed, a dead replica skipped, a second rollout refused;
- shutdown: in-flight answered, queued failed typed, a wedged replica's
  stacks dumped; ``/stats`` and ``POST /reload`` over HTTP, its bad
  bodies typed 400; the checkpoint watcher.
"""

import concurrent.futures
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gym_tpu_torch.convert import serving_params_from_jax
from gym_tpu_torch.models import nanogpt as T
from gym_tpu_torch.programs import default_registry
from gym_tpu_torch.serve import (CheckpointWatcher, EngineFailedError,
                                 FleetReloadError, InferenceEngine,
                                 NoHealthyReplicaError, RequestStatus,
                                 SamplingParams, Scheduler,
                                 SchedulerClosedError, ServeMetrics,
                                 Supervisor, build_fleet,
                                 latest_checkpoint_step)
from gym_tpu_torch.serve.scheduler import DeadlineExceededError
from gym_tpu_torch.utils.resilience import faults
from test_torch_decode import J, numpy_params, port_config

V = 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def setup():
    cfg = J.GPTConfig(block_size=64, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    return (port_config(cfg),
            serving_params_from_jax(numpy_params(cfg, 0), "cpu"),
            serving_params_from_jax(numpy_params(cfg, 7), "cpu"))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, V, n).astype(np.int32)


def _ref(params, cfg, prompt, n, **kw):
    return T.generate_fast(params, cfg, prompt[None], n,
                           **kw)[0, len(prompt):].tolist()


def _quiet(*a, **k):
    pass


# -- supervisor -------------------------------------------------------------


def _supervised(params, cfg, **sup_kw):
    def factory():
        return InferenceEngine(params, cfg, num_slots=2, device="cpu")
    sched = Scheduler(factory(), max_queue=16)
    return sched, Supervisor(sched, factory, log=_quiet, **sup_kw)


def test_supervisor_recovers_engine_exception(setup):
    cfg, params, _ = setup
    sched, sup = _supervised(params, cfg, dispatch_timeout_s=30.0,
                             max_restarts=3)
    first = sched.engine
    faults.install("serve.decode", "oserror", first=2, last=2)
    sup.start()
    try:
        h = sched.submit(_prompt(5, 0), SamplingParams(max_new_tokens=8,
                                                       seed=3))
        with pytest.raises(EngineFailedError, match="InjectedFault"):
            h.result(timeout=60)
        deadline = time.perf_counter() + 30.0
        while sched.engine is first:         # the rebuild follows the
            assert time.perf_counter() < deadline   # typed failure
            time.sleep(0.01)
        assert sup.restarts == 1
        deadline = time.perf_counter() + 30.0
        while not first.closed:              # the old engine torn down
            assert time.perf_counter() < deadline
            time.sleep(0.01)
        p = _prompt(5, 1)
        h2 = sched.submit(p, SamplingParams(max_new_tokens=6,
                                            temperature=0.8, top_k=5,
                                            seed=4))
        assert h2.result(timeout=60) == _ref(params, cfg, p, 6,
                                             temperature=0.8, top_k=5,
                                             seed=4)
        assert sup.failed is None
    finally:
        sup.stop(join_timeout_s=10)


def test_supervisor_recovers_wedged_dispatch(setup):
    """The watchdog reaps a hung dispatch; the rebuilt engine serves
    exact tokens, also after the abandoned thread wakes."""
    cfg, params, _ = setup
    sched, sup = _supervised(params, cfg, dispatch_timeout_s=0.4,
                             max_restarts=3)
    faults.install("serve.decode", "hang", arg=1.5, first=2, last=2)
    sup.start()
    try:
        t0 = time.perf_counter()
        h = sched.submit(_prompt(5, 0), SamplingParams(max_new_tokens=8,
                                                       seed=3))
        with pytest.raises(EngineFailedError, match="wedged"):
            h.result(timeout=60)
        assert time.perf_counter() - t0 < 10.0
        assert sup.restarts == 1
        p = _prompt(6, 1)
        ref = _ref(params, cfg, p, 6, temperature=0.8, top_k=5, seed=4)
        for _ in range(2):
            h2 = sched.submit(p, SamplingParams(
                max_new_tokens=6, temperature=0.8, top_k=5, seed=4))
            assert h2.result(timeout=60) == ref
            time.sleep(max(0.0, 1.6 - (time.perf_counter() - t0)))
    finally:
        sup.stop(join_timeout_s=10)


def test_supervisor_max_restarts_declares_dead(setup):
    cfg, params, _ = setup
    sched, sup = _supervised(params, cfg, dispatch_timeout_s=30.0,
                             max_restarts=1)
    faults.install("serve.decode", "oserror")
    sup.start()
    try:
        for seed in (0, 1):
            h = sched.submit(_prompt(5, seed),
                             SamplingParams(max_new_tokens=8))
            with pytest.raises(EngineFailedError):
                h.result(timeout=60)
        deadline = time.perf_counter() + 30.0
        while sup.failed is None and time.perf_counter() < deadline:
            time.sleep(0.05)
        assert sup.failed is not None and sup.restarts == 2
        with pytest.raises(SchedulerClosedError):
            sched.submit(_prompt(5, 1), SamplingParams(max_new_tokens=2))
    finally:
        sup.stop(join_timeout_s=10)


def test_failover_fails_request_wedged_in_admission(setup):
    cfg, params, _ = setup
    sched, sup = _supervised(params, cfg, dispatch_timeout_s=0.4,
                             max_restarts=3)
    faults.install("serve.prefill", "hang", arg=1.5, first=1, last=1)
    sup.start()
    try:
        t0 = time.perf_counter()
        h = sched.submit(_prompt(5, 0), SamplingParams(max_new_tokens=6,
                                                       seed=3))
        with pytest.raises(EngineFailedError, match="wedged"):
            h.result(timeout=60)
        assert time.perf_counter() - t0 < 10.0
        h2 = sched.submit(_prompt(5, 1), SamplingParams(max_new_tokens=4,
                                                        seed=4))
        assert len(h2.result(timeout=60)) == 4
        time.sleep(max(0.0, 1.6 - (time.perf_counter() - t0)))
        assert h.status is RequestStatus.FAILED
    finally:
        sup.stop(join_timeout_s=10)


def test_supervisor_clean_stop_is_not_a_failure(setup):
    cfg, params, _ = setup
    sched, sup = _supervised(params, cfg, dispatch_timeout_s=30.0)
    sup.start()
    h = sched.submit(_prompt(5, 0), SamplingParams(max_new_tokens=5,
                                                   seed=2))
    assert len(h.result(timeout=60)) == 5
    assert sup.stop(join_timeout_s=10)
    assert sup.restarts == 0 and sup.failed is None


# -- the fleet --------------------------------------------------------------


def _fleet(params, cfg, tmp_path=None, *, replicas=2, num_slots=2,
           start=True, **kw):
    m = ServeMetrics(str(tmp_path)) if tmp_path is not None else None
    kw.setdefault("dispatch_timeout_s", 30.0)
    r = build_fleet(params, cfg, replicas=replicas, num_slots=num_slots,
                    metrics=m, log=_quiet, device="cpu", **kw)
    if start:
        r.start()
    return r, m


def _close(router, metrics):
    router.close(drain_deadline_s=30.0)
    if metrics is not None:
        metrics.close()


def _boom(*a, **k):
    raise RuntimeError("test: injected hard engine death")


def test_dispatch_least_loaded_prefix_affine(setup):
    cfg, params, _ = setup
    router, _m = _fleet(params, cfg, start=False)
    picks = [router.submit(_prompt(5, i), SamplingParams(max_new_tokens=8),
                           block=False).replica_id for i in range(2)]
    assert picks == [0, 1]               # idle tie → 0, then the sibling
    _close(router, None)
    router, _m = _fleet(params, cfg, paged=True, page_size=16, kv_pages=64)
    try:
        shared = _prompt(34, 3)           # 2 full pages of shared prefix
        park = router.submit(_prompt(5, 4),
                             SamplingParams(max_new_tokens=24, seed=0))
        warm = router.submit(shared, SamplingParams(max_new_tokens=4,
                                                    seed=1))
        assert (park.replica_id, warm.replica_id) == (0, 1)
        warm.result(timeout=60)
        park.result(timeout=60)
        hit = router.submit(shared, SamplingParams(max_new_tokens=4,
                                                   seed=2))
        assert hit.replica_id == 1        # the resident prefix wins
        hit.result(timeout=60)
    finally:
        _close(router, None)


def test_replica_kill_mid_decode_fails_over_exact_stream(setup, tmp_path):
    cfg, params, _ = setup
    router, m = _fleet(params, cfg, tmp_path, max_restarts=0)
    try:
        p = _prompt(6, 10)
        ref = _ref(params, cfg, p, 24, temperature=0.9, top_k=7, seed=5)
        faults.install("serve.decode", "delay", arg=0.02)
        fr = router.submit(p, SamplingParams(max_new_tokens=24,
                                             temperature=0.9, top_k=7,
                                             seed=5), deadline_s=60.0)
        victim = fr.replica_id
        deadline = time.perf_counter() + 30.0
        while len(fr.tokens) < 4:         # mid-decode, provably partial
            assert time.perf_counter() < deadline, "no decode progress"
            time.sleep(0.005)
        router.replicas[victim].scheduler.engine.step = _boom
        assert fr.result(timeout=60) == ref
        assert fr.failovers == 1 and fr.replica_id != victim
        assert fr._inner.deadline_s < 60.0
        st = router.status()
        assert st["failovers"] == 1 and st["healthy_replicas"] == 1
        assert st["replicas"][victim]["dead"] is True
        nxt = router.submit(_prompt(4, 20), SamplingParams(max_new_tokens=2))
        assert nxt.replica_id != victim and len(nxt.result(timeout=60)) == 2
    finally:
        _close(router, m)


def test_whole_fleet_dead_and_death_window_degrade_typed(setup):
    cfg, params, _ = setup
    router, _m = _fleet(params, cfg, max_restarts=0)
    try:
        fr = router.submit(_prompt(5, 0),
                           SamplingParams(max_new_tokens=16, seed=0))
        for rep in router.replicas:
            rep.scheduler.engine.step = _boom
        with pytest.raises((EngineFailedError, SchedulerClosedError,
                            NoHealthyReplicaError)):
            fr.result(timeout=60)
        deadline = time.perf_counter() + 30.0
        while (any(not r.dead for r in router.replicas)
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        with pytest.raises(NoHealthyReplicaError):
            router.submit(_prompt(4, 1), SamplingParams(max_new_tokens=2))
    finally:
        _close(router, None)
    router, _m = _fleet(params, cfg, start=False)
    for rep in router.replicas:
        rep.scheduler.shutdown(finish_running=False, deadline_s=0.0)
    with pytest.raises(NoHealthyReplicaError,
                       match="shutting down or being declared dead") as ei:
        router.submit(_prompt(4, 0), SamplingParams(max_new_tokens=2),
                      block=False)
    assert ei.value.retry_after_s > 0
    _close(router, None)


def test_failover_deadline_exhausted_or_forwarded(setup):
    cfg, params, _ = setup
    router, _m = _fleet(params, cfg, start=False)
    fr = router.submit(_prompt(5, 0), SamplingParams(max_new_tokens=4),
                       deadline_s=5.0, block=False)
    fr.submit_t -= 10.0                   # elapsed > deadline_s
    router.replicas[fr.replica_id].scheduler.shutdown(
        finish_running=False, deadline_s=0.0)
    with pytest.raises(DeadlineExceededError,
                       match="during replica failover"):
        fr.result(timeout=5)
    assert fr.failovers == 0
    _close(router, None)
    router, _m = _fleet(params, cfg, start=False)
    fr = router.submit(_prompt(5, 0), SamplingParams(max_new_tokens=4),
                       deadline_s=30.0, block=False)
    first = fr.replica_id
    fr.submit_t -= 3.0
    router.replicas[first].scheduler.shutdown(finish_running=False,
                                              deadline_s=0.0)
    with pytest.raises(TimeoutError):
        fr.result(timeout=0.05)
    assert fr.failovers == 1 and fr.replica_id != first
    assert fr._inner.deadline_s == pytest.approx(27.0, abs=1.0)
    _close(router, None)


def test_rolling_hot_swap_under_traffic(setup, tmp_path):
    """No request fails; each new engine is warmed before it serves (no
    request builds a program afterwards), serves the new weights, and
    its predecessor is closed."""
    cfg, params_a, params_b = setup
    router, m = _fleet(params_a, cfg, tmp_path, weights_tag="v1",
                       max_restarts=2, paged=True, page_size=16)
    try:
        probe = _prompt(6, 30)
        ref_b = _ref(params_b, cfg, probe, 8, temperature=0.9, top_k=7,
                     seed=9)
        old = [rep.scheduler.engine for rep in router.replicas]

        def client(i):
            fr = router.submit(_prompt(4 + i % 5, 40 + i),
                               SamplingParams(max_new_tokens=10, seed=i),
                               timeout=60.0)
            return len(fr.result(timeout=120)) == 10

        reload_result = {}

        def do_reload():
            time.sleep(0.05)
            reload_result.update(router.reload(params_b, weights_tag="v2",
                                               drain_timeout_s=60.0))

        swapper = threading.Thread(target=do_reload)
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(client, i) for i in range(12)]
            swapper.start()
            results = [f.result() for f in futs]
        swapper.join(timeout=60)
        assert not swapper.is_alive() and all(results)
        assert sorted(reload_result["swapped"]) == [0, 1]
        assert all(e.closed for e in old)
        builds0 = default_registry().counters()["builds"]
        fr = router.submit(probe, SamplingParams(
            max_new_tokens=8, temperature=0.9, top_k=7, seed=9))
        assert fr.result(timeout=60) == ref_b
        assert default_registry().counters()["builds"] == builds0
        st = router.status()
        assert st["weight_reloads"] == 1 and st["weights_tag"] == "v2"
        assert all(r["weights_tag"] == "v2" for r in st["replicas"])
        assert m.headline()["engine_reloads"] == 2
    finally:
        _close(router, m)


def test_reload_drain_timeout_dead_replica_and_serialization(setup):
    cfg, params_a, params_b = setup
    router, _m = _fleet(params_a, cfg, num_slots=1)
    try:
        faults.install("serve.decode", "delay", arg=0.05)
        fr = router.submit(_prompt(5, 0),
                           SamplingParams(max_new_tokens=40, seed=0))
        deadline = time.perf_counter() + 30.0
        while router.replicas[fr.replica_id].scheduler.inflight() == 0:
            assert time.perf_counter() < deadline, "never admitted"
            time.sleep(0.005)
        with pytest.raises(FleetReloadError, match="did not drain") as ei:
            router.reload(params_b, weights_tag="v2", drain_timeout_s=0.01)
        assert ei.value.retry_after_s is not None
        faults.reset()
        assert len(fr.result(timeout=60)) == 40
    finally:
        _close(router, None)
    router, _m = _fleet(params_a, cfg, start=False, weights_tag="v1")
    router.replicas[0].supervisor.failed = RuntimeError("test: dead")
    res = router.reload(params_b, weights_tag="v2")
    assert res["swapped"] == [1] and res["skipped"] == [0]
    assert router.params_box["params"] is params_b
    assert router.replicas[1].scheduler.engine.weights_tag == "v2"
    router._reloading = True
    with pytest.raises(FleetReloadError, match="already in progress"):
        router.reload(params_b, weights_tag="v3")
    router._reloading = False
    _close(router, None)


def _post(port, path, payload, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        raw if raw is not None else json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    try:
        r = urllib.request.urlopen(req, timeout=120)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_fleet_shutdown_inflight_answered_queued_typed(setup, tmp_path):
    cfg, params, _ = setup
    from gym_tpu_torch.serve.__main__ import create_server
    handle = create_server(params, cfg, port=0, num_slots=1, replicas=2,
                           metrics_dir=str(tmp_path), device="cpu",
                           dispatch_timeout=30.0, request_timeout=120.0)
    t = threading.Thread(target=handle.httpd.serve_forever, daemon=True)
    t.start()
    try:
        faults.install("serve.decode", "delay", arg=0.05)
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(_post, handle.port, "/generate",
                              {"prompt": [1, 2, 3 + i],
                               "max_new_tokens": 12, "seed": i})
                    for i in range(4)]
            deadline = time.perf_counter() + 30.0
            while (sum(r.scheduler.active_requests()
                       for r in handle.router.replicas) < 2):
                assert time.perf_counter() < deadline, "slots never filled"
                time.sleep(0.01)
            for rep in handle.router.replicas:
                rep.scheduler.pause_admission()
            handle.close(drain_deadline_s=60.0)
            results = [f.result() for f in futs]
        oks = [b for c, b in results if c == 200]
        fails = [(c, b) for c, b in results if c != 200]
        assert len(oks) == 2 and len(fails) == 2, results
        assert all(len(b["tokens"]) == 12 for b in oks)
        assert {b["replica"] for b in oks} == {0, 1}
        assert all(c == 503 and "shutting down" in b["error"]
                   for c, b in fails)
        assert all(rep.scheduler.engine.closed
                   for rep in handle.router.replicas)
    finally:
        faults.reset()
        t.join(timeout=10)


def test_fleet_close_dumps_stacks_for_wedged_replica(setup, capsys):
    cfg, params, _ = setup
    router, _m = _fleet(params, cfg, start=False)
    router.replicas[0].supervisor.stop = lambda **k: False
    q = router.submit(_prompt(4, 0), SamplingParams(max_new_tokens=4),
                      block=False)
    assert q.replica_id == 0
    assert router.close(drain_deadline_s=0.5) is False
    assert "replica 0 driver wedged" in capsys.readouterr().err
    assert q.status is RequestStatus.FAILED
    with pytest.raises(SchedulerClosedError):
        q.result(timeout=1)


def test_http_fleet_stats_reload_and_bad_bodies(setup, tmp_path):
    cfg, params_a, params_b = setup
    from gym_tpu_torch.serve.__main__ import create_server
    handle = create_server(
        params_a, cfg, port=0, num_slots=2, replicas=2, device="cpu",
        metrics_dir=str(tmp_path), dispatch_timeout=30.0,
        reload_source=lambda body: (params_b, body.get("tag", "step-9")))
    t = threading.Thread(target=handle.httpd.serve_forever, daemon=True)
    t.start()
    try:
        prompt = np.asarray([1, 2, 3], np.int32)
        ref_b = _ref(params_b, cfg, prompt, 6, top_k=4, seed=0)
        gen = {"prompt": [1, 2, 3], "max_new_tokens": 6, "top_k": 4,
               "seed": 0}
        code, body = _post(handle.port, "/generate", gen)
        assert code == 200 and body["replica"] in (0, 1)
        assert body["tokens"] != ref_b and body["failovers"] == 0
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{handle.port}/stats", timeout=30).read())
        assert stats["healthy_replicas"] == 2
        assert [r["id"] for r in stats["replicas"]] == [0, 1]
        for raw in (b"[1, 2]", json.dumps({"drain_timeout_s": "fast"})
                    .encode()):
            code, body = _post(handle.port, "/reload", None, raw=raw)
            assert code == 400 and "malformed reload body" in body["error"]
        code, body = _post(handle.port, "/reload", {"tag": "step-9"})
        assert code == 200 and sorted(body["swapped"]) == [0, 1]
        code, body = _post(handle.port, "/generate", gen)
        assert code == 200 and body["tokens"] == ref_b
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{handle.port}/stats", timeout=30).read())
        assert stats["weight_reloads"] == 1 and stats["step"] == 9
        assert stats["warmup"]["done"]
        # every replica's family: decode + cow + seven buckets 1..64
        assert stats["warmup"]["warmed"] == 2 * 9
    finally:
        handle.close()
        t.join(timeout=10)
    handle = create_server(params_a, cfg, port=0, num_slots=1,
                           device="cpu", metrics_dir=str(tmp_path / "b"),
                           dispatch_timeout=30.0, warmup=False)
    t = threading.Thread(target=handle.httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, body = _post(handle.port, "/reload", {})
        assert code == 400 and "no reload source" in body["error"]
    finally:
        handle.close()
        t.join(timeout=10)


def test_checkpoint_watcher_drives_router_reload(setup, tmp_path):
    cfg, params_a, params_b = setup
    run = tmp_path / "run"
    run.mkdir()
    for name in ("1", "150.corrupt-1", "200.tmp-write"):
        (run / name).mkdir()
    assert latest_checkpoint_step(str(run)) == 1
    router, _m = _fleet(params_a, cfg, start=False, weights_tag="step-1")
    fired = []

    def on_new_step(step):
        fired.append(step)
        router.reload(params_b, weights_tag=f"step-{step}")

    w = CheckpointWatcher(str(run), on_new_step, poll_s=3600.0,
                          initial_step=1)
    assert w.poll_once() is None
    (run / "2").mkdir()
    assert w.poll_once() == 2 and w.poll_once() is None
    st = router.status()
    assert st["weights_tag"] == "step-2" and st["weight_reloads"] == 1
    _close(router, None)

    def explode(step):
        fired.append(step)
        raise RuntimeError("test: reload blew up")

    w2 = CheckpointWatcher(str(run), explode, poll_s=3600.0,
                           initial_step=1)
    assert w2.poll_once() == 2            # the callback's error swallowed
    (run / "3").mkdir()
    assert w2.poll_once() == 3 and fired == [2, 2, 3]
