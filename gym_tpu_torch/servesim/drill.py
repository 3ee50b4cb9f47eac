"""The closed train→deploy loop: continuous deployment under live traffic,
as one gated drill (counterpart of ``gym_tpu/servesim/drill.py``).

Composes the trainer, the serving fleet and the trace replayer into the
scenario they exist for:

- a LIVE TRAINER (a real subprocess, ``python -m
  gym_tpu_torch.servesim.drill --train-worker``; ``--kill-trainer``
  SIGKILLs it mid-run and resumes it with ``resume="auto"``) streams
  checkpoints into a run dir;
- a serving FLEET (in-process or ``--out-of-process`` worker subprocesses)
  watches that run dir (``CheckpointWatcher``, the ``--reload-watch``
  machinery) and rolls every new checkpoint through its replicas with the
  zero-downtime hot swap;
- WHILE a synthetic trace replays open-loop against the HTTP endpoint
  (streamed SSE requests, non-coordinated omission);
- gated on the three invariants continuous deployment stands on:

  1. **zero dropped requests** — every replayed request completes;
  2. **zero recompiles** — the kernel library's ``nvcc`` builds
     (``programs_compiled``: process-wide for the in-process fleet, the
     workers' health frames for the process fleet) do not move across any
     hot swap (the CUDA graphs of a swapped engine are captured again by
     design: a graph holds its engine's addresses);
  3. **post-swap streams exact** — after the final swap, a streamed
     request through the full HTTP path is byte-identical to
     ``generate_fast`` under the final checkpoint's params.

Everything runs on the card unless ``--device cpu``, the trainer
subprocess and the fleet's workers too. The model is the JAX drill's
(2L/2H/32d, block 32, vocab 48), and so are the trace, the invariants and
the JSON result. ``scripts/ci_torch_deploy.sh`` runs it on the CPU:

    python -m gym_tpu_torch.servesim.drill --out /tmp/drill \\
        --out-of-process --replicas 2 --kill-trainer --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

# the drill's fixed tiny workload: one config shared by the trainer
# segments, the fleet, and the exactness oracle
_BLOCK, _VOCAB = 32, 48
_SEG_A_STEPS = 4          # checkpoints at 2, 4 before serving starts
_CKPT_INTERVAL = 2
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _model_cfg():
    from ..models.nanogpt import GPTConfig
    return GPTConfig(block_size=_BLOCK, vocab_size=_VOCAB, n_layer=2,
                     n_head=2, n_embd=32, dropout=0.0, bias=True)


def train_segment(out: str, max_steps: int,
                  device: Optional[str] = None) -> None:
    """One trainer segment: deterministic synthetic corpus, tiny GPT,
    ``resume="auto"`` — a killed segment rerun with the same command picks
    up from its last checkpoint (the contract ``--kill-trainer``
    exercises)."""
    import numpy as np

    from .. import Trainer
    from ..data import ArrayDataset
    from ..models.nanogpt import GPT
    from ..strategy.optim import OptimSpec
    from ..strategy.simple_reduce import SimpleReduceStrategy

    rng = np.random.default_rng(0)
    toks = rng.integers(0, _VOCAB, (64, _BLOCK + 1))
    ds = ArrayDataset(toks[:, :-1].astype(np.int64),
                      toks[:, 1:].astype(np.int64))
    Trainer(GPT(_model_cfg()), ds).fit(
        strategy=SimpleReduceStrategy(
            optim_spec=OptimSpec("adamw", lr=1e-3)),
        num_nodes=1, max_steps=max_steps, batch_size=4, val_size=0,
        val_interval=0, show_progress=False, seed=1, device=device,
        checkpoint_interval=_CKPT_INTERVAL,
        save_dir=os.path.join(out, "ckpts"), run_name="drill",
        log_dir=os.path.join(out, "logs"), resume="auto")


def _spawn_trainer(out: str, steps: int,
                   device: Optional[str]) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = (_PKG_ROOT + os.pathsep
                         + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
    cmd = [sys.executable, "-m", "gym_tpu_torch.servesim.drill",
           "--train-worker", out, "--train-steps", str(steps)]
    if device:
        cmd += ["--device", str(device)]
    with open(os.path.join(out, "trainer.log"), "ab") as log:
        return subprocess.Popen(cmd, stdout=log, stderr=log, env=env)


def _wait_warm(handle, timeout_s: float = 300.0) -> None:
    """Block until every replica's program warmup finished — the
    zero-recompile gate below is only meaningful once the full program
    family is resident."""
    deadline = time.monotonic() + timeout_s
    router = handle.router
    while time.monotonic() < deadline:
        if getattr(router, "kind", "thread") == "process":
            live = [r for r in router.status()["replicas"]
                    if not r["retired"] and r["healthy"]]
            warm = [r.get("warmup") for r in live]
            if live and all(w is None or w.get("done") for w in warm):
                return
        else:
            w = handle.warmup
            if w is None or w.stats().get("done"):
                return
        time.sleep(1.0)
    raise TimeoutError("fleet warmup never finished")


def _compiled_counts(handle) -> Dict[str, Any]:
    """The zero-recompile observable: the process's ``nvcc`` build counter
    for the in-process fleet, per-worker counters (health frames) for the
    process fleet."""
    router = handle.router
    if getattr(router, "kind", "thread") == "process":
        return {str(r["id"]): r.get("programs_compiled")
                for r in router.status()["replicas"]
                if not r["retired"]}
    from .. import programs as programs_mod
    return {"process": programs_mod.xla_compile_counter()}


def run_drill(out: str, *, replicas: int = 2,
              out_of_process: bool = False, kill_trainer: bool = False,
              final_steps: int = 10, trace_duration_s: float = 25.0,
              trace_rps: float = 1.2, time_scale: float = 1.0,
              startup_timeout_s: float = 420.0,
              device: Optional[str] = None) -> Dict[str, Any]:
    """The drill on ``device`` (the card unless ``"cpu"``); returns the
    JSON result (``ok``, ``failures``, the replay's SLO report, the compile
    counters before and after, ``post_swap_stream_exact``)."""
    import numpy as np

    from ..models.nanogpt import generate_fast
    from ..serve.__main__ import create_server
    from ..serve.load import (CheckpointWatcher, latest_checkpoint_step,
                              load_for_serving)
    from ..train_node import default_device
    from .replay import HttpClient, replay, slo_report
    from .traces import diurnal_trace

    dev = str(default_device(device))
    os.makedirs(out, exist_ok=True)
    run_dir = os.path.join(out, "ckpts", "drill")
    t_start = time.perf_counter()

    # -- phase 1: train the initial checkpoint (segment A) ---------------
    print(f"drill: training segment A ({_SEG_A_STEPS} steps) on {dev}",
          flush=True)
    train_segment(out, _SEG_A_STEPS, device=dev)

    # -- phase 2: stand up the fleet over it -----------------------------
    params, cfg, info = load_for_serving(run_dir, device=dev)
    served_step = {"step": info["step"]}

    def reload_source(body):
        new_params, new_cfg, new_info = load_for_serving(
            run_dir, step=body.get("step"), device=dev)
        if new_cfg != cfg:
            raise ValueError("drill checkpoint changed architecture")
        return new_params, f"step-{new_info['step']}"

    handle = create_server(
        params, cfg, host="127.0.0.1", port=0, num_slots=2,
        replicas=replicas, metrics_dir=os.path.join(out, "serve"),
        info=info, reload_source=reload_source,
        out_of_process=out_of_process,
        fleet_dir=os.path.join(out, "fleet"),
        worker_startup_timeout_s=startup_timeout_s, device=dev)
    del params
    httpd_thread = threading.Thread(target=handle.httpd.serve_forever,
                                    daemon=True, name="drill-httpd")
    httpd_thread.start()
    url = f"http://127.0.0.1:{handle.port}"
    print(f"drill: fleet serving step {info['step']} at {url} "
          f"({'process' if out_of_process else 'thread'} x {replicas} on "
          f"{dev})", flush=True)
    result: Dict[str, Any] = {"drill": "train_deploy_loop",
                              "fleet": ("process" if out_of_process
                                        else "thread"),
                              "replicas": replicas, "device": dev,
                              "initial_step": info["step"],
                              "kill_trainer": bool(kill_trainer)}
    try:
        _wait_warm(handle)
        compiles_before = _compiled_counts(handle)
        reloads: List[int] = []

        # the --reload-watch machinery, wired exactly as main() does
        def on_new_step(step: int) -> None:
            new_params, tag = reload_source({"step": step})
            res = handle.router.reload(new_params, weights_tag=tag,
                                       drain_timeout_s=120.0)
            served_step["step"] = step
            handle.info["step"] = step
            reloads.append(step)
            print(f"drill: hot-swapped {tag} into replicas "
                  f"{res['swapped']} in {res['wall_s']}s", flush=True)

        watcher = CheckpointWatcher(run_dir, on_new_step, poll_s=1.0,
                                    initial_step=info["step"]).start()

        # -- phase 3: live trainer + open-loop replay, concurrently ------
        trainer = _spawn_trainer(out, final_steps, dev)
        killed = False
        if kill_trainer:

            def killer():
                nonlocal killed, trainer
                # SIGKILL as soon as segment B commits its first new
                # checkpoint — or after a short grace if it has not yet
                # (a kill during startup/restore is an equally valid kill;
                # resume="auto" recovers from step 4 either way). Waiting
                # for the LAST checkpoint would race completion and make
                # the gate vacuous.
                deadline = time.monotonic() + 8.0
                while time.monotonic() < deadline:
                    s = latest_checkpoint_step(run_dir)
                    if s is not None and s > _SEG_A_STEPS:
                        break
                    if trainer.poll() is not None:
                        break       # finished already — rc check below
                    time.sleep(0.1)
                trainer.kill()      # SIGKILL mid-training
                rc = trainer.wait()
                # a kill that landed AFTER a clean exit is a no-op, not a
                # drill — only a -SIGKILL returncode counts
                killed = rc == -9
                print(f"drill: trainer SIGKILL rc={rc} after step "
                      f"{latest_checkpoint_step(run_dir)}; resuming",
                      flush=True)
                trainer = _spawn_trainer(out, final_steps, dev)

            kill_thread = threading.Thread(target=killer, daemon=True)
            kill_thread.start()

        # prompt + max_new must fit the drill model's block_size=32 window
        # — an over-window request is a 400, not a drop, but the
        # zero-dropped gate should never depend on that distinction
        trace = diurnal_trace(
            duration_s=trace_duration_s, base_rps=trace_rps,
            amplitude=0.6, seed=11, prompt_lens=(4, 14),
            max_news=(6, 12), prefix_groups=2)
        client = HttpClient(url, _VOCAB, stream=True, timeout_s=180.0)
        t0 = time.perf_counter()
        outcomes = replay(trace, client, time_scale=time_scale)
        replay_wall = time.perf_counter() - t0
        report = slo_report(outcomes, wall_s=replay_wall)
        result["replay"] = report
        print(f"drill: replay done — {report['done']}/"
              f"{report['requests']} completed", flush=True)

        # -- phase 4: wait for the final checkpoint to be serving --------
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if (trainer.poll() is not None
                    and served_step["step"] >= final_steps):
                break
            time.sleep(1.0)
        if kill_trainer:
            kill_thread.join(timeout=60)
        trainer.wait(timeout=60)
        watcher.stop()
        result["trainer_killed_and_resumed"] = killed
        result["final_step_served"] = served_step["step"]
        result["reload_steps"] = reloads
        compiles_after = _compiled_counts(handle)
        result["compiles_before"] = compiles_before
        result["compiles_after"] = compiles_after

        # -- phase 5: post-swap exactness over the full HTTP path --------
        final_params, _cfg2, final_info = load_for_serving(run_dir,
                                                           device=dev)
        probe = np.arange(1, 9, dtype=np.int32)
        ref = generate_fast(final_params, cfg, probe[None], 16,
                            temperature=0.9, top_k=7,
                            seed=1234)[0, len(probe):].tolist()
        del final_params
        import urllib.request
        body = json.dumps({
            "prompt": [int(t) for t in probe], "max_new_tokens": 16,
            "temperature": 0.9, "top_k": 7, "seed": 1234,
            "stream": True}).encode()
        got: List[int] = []
        with urllib.request.urlopen(urllib.request.Request(
                url + "/generate", body,
                {"Content-Type": "application/json"}),
                timeout=180) as r:
            for line in r:
                if line.strip().startswith(b"data: "):
                    evt = json.loads(line[6:])
                    got.extend(evt.get("tokens", []) or [])
        result["post_swap_stream_exact"] = got == ref

        # -- the gates ---------------------------------------------------
        failures = []
        if report["done"] != report["requests"]:
            failures.append(
                f"dropped {report['requests'] - report['done']} of "
                f"{report['requests']} requests")
        if served_step["step"] < final_steps:
            failures.append(
                f"final checkpoint step {final_steps} never served "
                f"(at {served_step['step']})")
        if not reloads:
            failures.append("no hot-swap ever fired")
        if compiles_after != compiles_before:
            failures.append(
                f"recompiles across hot-swaps: {compiles_before} -> "
                f"{compiles_after}")
        if not result["post_swap_stream_exact"]:
            failures.append(
                f"post-swap stream diverged from generate_fast under "
                f"step-{final_info['step']} params")
        if kill_trainer and not killed:
            failures.append("kill-trainer arm never killed the trainer")
        result["failures"] = failures
        result["ok"] = not failures
        result["wall_s"] = round(time.perf_counter() - t_start, 1)
        return result
    finally:
        handle.close(drain_deadline_s=60.0)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gym_tpu_torch.servesim.drill",
        description="Closed train->deploy loop: live trainer streaming "
                    "checkpoints into a reload-watching fleet while a "
                    "trace replays — zero dropped, zero recompiles, "
                    "post-swap streams exact")
    p.add_argument("--out", default=None)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--out-of-process", action="store_true")
    p.add_argument("--kill-trainer", action="store_true",
                   help="SIGKILL the trainer mid-run and resume it")
    p.add_argument("--final-steps", type=int, default=10)
    p.add_argument("--trace-duration", type=float, default=25.0)
    p.add_argument("--trace-rps", type=float, default=1.2)
    p.add_argument("--time-scale", type=float, default=1.0)
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' runs the trainer, the "
                        "fleet and the oracle on the CPU")
    # internal: the trainer-segment subprocess entry
    p.add_argument("--train-worker", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--train-steps", type=int, default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.train_worker:
        train_segment(args.train_worker, args.train_steps,
                      device=args.device)
        return 0

    if not args.out:
        p.error("--out is required")
    try:
        from ..train_node import default_device
        default_device(args.device)
    except RuntimeError as e:
        print(f"gym_tpu_torch.servesim.drill: {e}", file=sys.stderr)
        return 1
    result = run_drill(
        args.out, replicas=args.replicas,
        out_of_process=args.out_of_process,
        kill_trainer=args.kill_trainer, final_steps=args.final_steps,
        trace_duration_s=args.trace_duration,
        trace_rps=args.trace_rps, time_scale=args.time_scale,
        device=args.device)
    print(json.dumps({"deploy_drill": result}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
