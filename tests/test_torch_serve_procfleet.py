"""The port's out-of-process fleet on the CPU (twin of
``tests/test_serve_procfleet.py``): real worker subprocesses
(``python -m gym_tpu_torch.serve.worker``) behind the socket-speaking
``ProcessRouter``, held to ``gym_tpu``'s ``generate_fast`` on the same
numpy-made weights carried across by ``convert.serving_params_from_jax``.

- a streamed request through a worker process concatenates token for token
  to the JAX package's ``generate_fast``, in more than one chunk;
- the health frames carry distinct worker pids (none ours), the load
  observables and ``programs_compiled`` 0 (no ``nvcc`` on the CPU);
- ``python -m gym_tpu_torch.serve``'s ``--out-of-process --autoscale``
  branch (``create_server``) serves the same stream over HTTP, and its
  autoscaler respawns a ``kill -9``'d worker (``/stats``);
- a rolling reload goes through both workers and both then serve the new
  weights exactly;
- without a card a fleet on the card (the default) raises;
- ``kill -9`` of the worker serving a stream once 4 or more tokens reached
  the client: the concatenated stream equals the uncontended one inside
  the deadline, ``scale_up`` respawns, and no zombie is left.

One module-scoped 2-worker fleet; the kill test runs LAST (the suite runs
with ``-p no:randomly``). Workers run one intra-op thread, and the
fleet's decode steps take at least 10 ms (an injected ``serve.decode``
delay) so that the kill always lands mid-stream.
"""

import json
import os
import signal
import tempfile
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gym_tpu.models import nanogpt as J
from gym_tpu_torch.convert import serving_params_from_jax
from gym_tpu_torch.serve.engine import SamplingParams
from gym_tpu_torch.serve.metrics import ServeMetrics
from gym_tpu_torch.serve.router import build_process_fleet
from test_torch_decode import numpy_params, port_config

V = 48
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fleet():
    jcfg = J.GPTConfig(block_size=64, vocab_size=V, n_layer=2, n_head=2,
                       n_embd=32, dropout=0.0, bias=True)
    jparams = numpy_params(jcfg, 0)
    tcfg = port_config(jcfg)
    metrics = ServeMetrics(tempfile.mkdtemp(prefix="gym_torch_pfm_"))
    router = build_process_fleet(
        serving_params_from_jax(jparams, "cpu"), tcfg,
        tempfile.mkdtemp(prefix="gym_torch_pf_"), replicas=2, num_slots=2,
        metrics=metrics, no_warmup=True, max_restarts=0, device="cpu",
        # 10 ms a decode step: a loaded host cannot finish the kill test's
        # stream before the kill lands
        env={**ONE_THREAD, "GYM_TPU_FAULTS": "serve.decode:delay=0.01"},
        log=lambda *a, **k: None)
    router.start()
    router.wait_ready(timeout_s=120)
    yield jcfg, jparams, tcfg, router, metrics
    assert router.close(drain_deadline_s=60) is True
    metrics.close()
    # no zombies: every spawned worker is gone and reaped
    for rep in router.replicas:
        assert rep.proc.poll() is not None, \
            f"worker {rep.id} (pid {rep.pid}) still running"


def _ref(jparams, jcfg, prompt, n, **kw):
    return J.generate_fast(jparams, jcfg, np.asarray(prompt)[None], n,
                           **kw)[0, len(prompt):].tolist()


def test_proc_stream_equals_jax_generate_fast(fleet):
    jcfg, jparams, _tcfg, router, _m = fleet
    prompt = [1, 2, 3, 4, 5, 6]
    ref = _ref(jparams, jcfg, prompt, 16, temperature=0.9, top_k=7, seed=3)
    pr = router.submit(prompt, SamplingParams(
        max_new_tokens=16, temperature=0.9, top_k=7, seed=3),
        coalesce_s=0.0)
    got, chunks = [], 0
    for chunk in pr.stream(timeout=120):
        got.extend(chunk)
        chunks += 1
    assert got == ref
    assert chunks > 1
    assert pr.tokens == ref
    assert pr.ttft_s is not None and pr.ttft_s > 0
    assert pr.done_t is not None
    # the result-only surface (tokens on the done frame) too
    pr2 = router.submit(prompt, SamplingParams(
        max_new_tokens=16, temperature=0.9, top_k=7, seed=3), stream=False)
    assert pr2.result(timeout=120) == ref


def test_health_reports_pids_and_load_observables(fleet):
    _jcfg, _jparams, _tcfg, router, _m = fleet
    deadline = time.monotonic() + 30
    st = router.status()
    while time.monotonic() < deadline:
        st = router.status()
        live = [r for r in st["replicas"] if not r["retired"]]
        if all(r.get("pid") and "backlog_tokens" in r for r in live):
            break
        time.sleep(0.2)
    live = [r for r in st["replicas"] if not r["retired"]]
    assert st["fleet"] == "process" and st["healthy_replicas"] >= 2
    pids = {r["pid"] for r in live}
    assert len(pids) == len(live)            # distinct real processes
    assert os.getpid() not in pids           # none of them is us
    for r in live:
        assert r["programs_compiled"] == 0   # no nvcc on the CPU
        assert "tokens_per_s_ewma" in r and r["num_slots"] == 2
    snap = router.autoscale_snapshot()
    assert snap["healthy"] >= 2
    assert "backlog_tokens" in snap and "tokens_per_s" in snap


def _sse(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        return [json.loads(line[6:]) for line in r
                if line.strip().startswith(b"data: ")]


def _stats(port):
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}/stats", timeout=30).read())


def test_server_out_of_process_autoscale_serves_and_respawns(
        fleet, tmp_path, monkeypatch):
    """``create_server(out_of_process=True, autoscale=True)`` — what
    ``python -m gym_tpu_torch.serve --device cpu --out-of-process
    --replicas 2 --autoscale`` runs: a streamed request equal to the JAX
    package's tokens, ``/stats`` with the process fleet and the
    autoscaler, and a ``kill -9``'d worker respawned by the autoscaler's
    floor rule."""
    from gym_tpu_torch.serve.__main__ import create_server
    jcfg, jparams, tcfg, _router, _m = fleet
    for k, v in ONE_THREAD.items():
        monkeypatch.setenv(k, v)          # the workers' environment
    handle = create_server(
        serving_params_from_jax(jparams, "cpu"), tcfg, port=0,
        num_slots=2, replicas=2, metrics_dir=str(tmp_path / "m"),
        warmup=False, device="cpu", out_of_process=True, autoscale=True,
        autoscale_interval_s=0.2, fleet_dir=tempfile.mkdtemp(
            prefix="gym_torch_fs_"))
    threading.Thread(target=handle.httpd.serve_forever,
                     daemon=True).start()
    try:
        prompt = [3, 1, 4, 1, 5]
        ref = _ref(jparams, jcfg, prompt, 12, temperature=0.8, top_k=5,
                   seed=9)
        events = _sse(handle.port, {"prompt": prompt, "max_new_tokens": 12,
                                    "temperature": 0.8, "top_k": 5,
                                    "seed": 9, "stream": True})
        assert events[-1]["done"] is True
        assert [t for e in events[:-1] for t in e["tokens"]] == ref
        st = _stats(handle.port)
        assert st["fleet"] == "process" and st["status"] == "ok"
        assert st["autoscaler"]["min_replicas"] == 2
        live = [r for r in st["replicas"] if not r["retired"]]
        assert len({r["pid"] for r in live}) == 2
        assert all(r["programs_compiled"] == 0 for r in live)
        os.kill(live[0]["pid"], signal.SIGKILL)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = _stats(handle.port)
            if (st["autoscaler"]["spawns"] >= 1
                    and st["healthy_replicas"] == 2):
                break
            time.sleep(0.2)
        assert st["autoscaler"]["spawns"] >= 1, st["autoscaler"]
        assert st["healthy_replicas"] == 2 and st["replicas_spawned"] == 3
        assert st["status"] == "ok"
        events = _sse(handle.port, {"prompt": prompt, "max_new_tokens": 12,
                                    "temperature": 0.8, "top_k": 5,
                                    "seed": 9, "stream": True})
        assert [t for e in events[:-1] for t in e["tokens"]] == ref
    finally:
        handle.close(drain_deadline_s=30.0)
    assert all(rep.proc.poll() is not None for rep in handle.router.replicas)


def test_fleet_on_the_card_without_one_raises(fleet, tmp_path):
    """The default device is the card: with none, the fleet refuses before
    it spawns anything, never a quiet CPU fleet."""
    jcfg, jparams, tcfg, _router, _m = fleet
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        build_process_fleet(serving_params_from_jax(jparams, "cpu"), tcfg,
                            str(tmp_path), replicas=1)
    assert not list(tmp_path.glob("*.sock"))


def test_proc_reload_rolls_through_workers(fleet):
    """A rolling hot swap across the process boundary: both workers
    drain, rebuild from the new snapshot, and then serve the new weights
    exactly."""
    jcfg, _jparams, tcfg, router, _m = fleet
    jparams_b = numpy_params(jcfg, 7)
    prompt = [1, 2, 3, 4]
    ref_b = _ref(jparams_b, jcfg, prompt, 8, temperature=0.9, top_k=7,
                 seed=2)
    res = router.reload(serving_params_from_jax(jparams_b, "cpu"),
                        weights_tag="v2", drain_timeout_s=120.0)
    assert sorted(res["swapped"]) == sorted(
        r.id for r in router.replicas if r.healthy)
    outs = []
    for _ in range(4):
        pr = router.submit(prompt, SamplingParams(
            max_new_tokens=8, temperature=0.9, top_k=7, seed=2))
        outs.append((pr.replica_id, pr.result(timeout=120)))
    assert {rid for rid, _ in outs} == {
        r.id for r in router.replicas if r.healthy}
    for _rid, toks in outs:
        assert toks == ref_b
    st = router.status()
    assert st["weight_reloads"] == 1 and st["weights_tag"] == "v2"


def test_kill9_mid_stream_splices_exact_and_respawns(fleet):
    """SIGKILL the worker serving a stream once 4 or more tokens reached
    the client: the router re-dispatches with the delivered prefix, the
    sibling re-derives, verifies and suppresses it, and the concatenated
    stream equals the JAX package's uncontended one inside the deadline;
    the dead process leaves dispatch and no zombie, and ``scale_up`` (the
    autoscaler's move) restores the fleet."""
    jcfg, _jparams, _tcfg, router, metrics = fleet
    jparams_b = numpy_params(jcfg, 7)    # the reload above swapped to it
    prompt = [1, 2, 3, 4, 5, 6]
    # 56 tokens, one frame a decode step: the worker dies with most of
    # the stream ungenerated
    sp = SamplingParams(max_new_tokens=56, temperature=0.9, top_k=7,
                        seed=5)
    ref = _ref(jparams_b, jcfg, prompt, 56, temperature=0.9, top_k=7,
               seed=5)
    pr = router.submit(prompt, sp, deadline_s=120.0, coalesce_s=0.0)
    victim_pid, victim_rid = pr.pid, pr.replica_id
    got, killed_at = [], None
    t0 = time.perf_counter()
    for chunk in pr.stream(timeout=120):
        got.extend(chunk)
        if killed_at is None and len(got) >= 4:
            os.kill(victim_pid, signal.SIGKILL)
            killed_at = len(got)
    wall = time.perf_counter() - t0
    assert killed_at is not None and killed_at < len(ref)
    assert got == ref                       # the splice, token for token
    assert wall < 120.0                     # inside the deadline
    assert pr.failovers == 1 and pr.replica_id != victim_rid
    st = router.status()
    assert st["failovers"] >= 1
    victim = next(r for r in st["replicas"] if r["id"] == victim_rid)
    assert victim["dead"] is True and victim["healthy"] is False
    vrep = next(r for r in router.replicas if r.id == victim_rid)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and vrep.proc.poll() is None:
        time.sleep(0.2)
    assert vrep.proc.poll() == -signal.SIGKILL   # reaped: no zombie
    router.scale_up()
    router.wait_ready(n=2, timeout_s=120)
    st = router.status()
    assert st["healthy_replicas"] == 2
    assert st["replicas_spawned"] == 3      # 2 initial + 1 respawn
    assert metrics.headline()["replicas_spawned"] == 3
    pr = router.submit(prompt, sp)
    assert pr.result(timeout=120) == ref
