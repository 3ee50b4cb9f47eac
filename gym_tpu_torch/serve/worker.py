"""``python -m gym_tpu_torch.serve.worker`` — one fleet replica as a process
(counterpart of ``gym_tpu/serve/worker.py``).

The out-of-process fleet runs each replica as a subprocess: its own
interpreter (no shared GIL), its own CUDA context and its own failure
domain. A crash or ``kill -9`` takes down ONE replica, and the router
splices the affected streams onto a sibling. This module is the worker
side: it builds the engine+scheduler+supervisor stack ``create_server``
builds in-process, then serves the ``serve/wire.py`` frame protocol over a
local AF_UNIX socket instead of HTTP:

- ``submit`` → ``accepted`` → ``chunk``\\* → ``done`` | ``error`` — tokens
  stream back at decode-chunk granularity (``Request.wait_progress``), so
  the router's first byte waits on the FIRST token, not the last. A
  ``prefix`` on the submit (a failover splice) is re-derived by the
  deterministic engine, VERIFIED token by token and not sent again: the
  router's concatenated client stream is byte-identical to an uncontended
  run. On the card that holds across processes and batch mixes because
  the decode kernels (R1, B6, B7, L1, T1's bits rows) keep a row's bits
  whatever the rows beside it.
- ``cancel`` → the request is cancelled at the next decode-chunk boundary
  (``Scheduler.cancel``) and its slot freed.
- ``health`` → ``health_ok`` with the dispatch observables the router
  prices (backlog tokens, the tokens/s EWMA, ``pid``) and
  ``programs_compiled``: the kernel library's ``nvcc`` builds in this
  process, 0 against a warm ``--program-cache-dir``.
- ``reload`` → the worker half of a rolling hot swap: pause admission,
  drain in-flight, build the new engine from the new params snapshot (its
  CUDA graphs captured before it serves), swap, close the old, resume.
- ``stop`` / SIGTERM → graceful drain (answer in-flight, fail queued
  typed), flush ``serve.csv``, exit 0.

Params arrive either as a checkpoint run dir (``--ckpt``, the standalone
path) or as the numpy snapshot + config JSON the parent router writes
(``--params-file``/``--config-json``, the fleet path: one restore and, under
``--quant``, one quantization in the parent, N cheap loads), both through
``serve/load.py``. The worker runs on the card unless ``--device cpu``;
without a card it exits 1. Each worker captures its own CUDA graphs.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import threading
import time
import traceback
from typing import Any, Dict

import numpy as np

from . import wire


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gym_tpu_torch.serve.worker",
        description="One fleet replica: engine+scheduler+supervisor "
                    "serving the wire protocol over a local socket.")
    p.add_argument("--socket", required=True, metavar="PATH",
                   help="AF_UNIX socket path to listen on (created; an "
                        "existing file is replaced)")
    src = p.add_argument_group("model source (one of)")
    src.add_argument("--ckpt", default=None, metavar="RUN_DIR",
                     help="checkpoint run dir (standalone worker)")
    src.add_argument("--step", type=int, default=None)
    src.add_argument("--config", default=None, metavar="CONFIG_JSON",
                     help="explicit config.json for --ckpt run dirs")
    src.add_argument("--params-file", default=None, metavar="PKL",
                     help="numpy params snapshot written by the router "
                          "(fleet spawn path)")
    src.add_argument("--config-json", default=None, metavar="JSON",
                     help="GPTConfig fields as JSON (with --params-file)")
    p.add_argument("--replica-id", type=int, default=0)
    p.add_argument("--num_slots", type=int, default=4)
    p.add_argument("--decode_chunk", type=int, default=1)
    p.add_argument("--page_size", type=int, default=16)
    p.add_argument("--kv_pages", type=int, default=None)
    p.add_argument("--spec_tokens", type=int, default=0)
    p.add_argument("--max_queue", type=int, default=64)
    p.add_argument("--quotas-json", default=None, metavar="JSON",
                   help="per-SLO-class token-rate quotas as JSON, e.g. "
                        "'{\"batch\": {\"share\": 0.5}}'; absent = no "
                        "quota enforcement")
    p.add_argument("--preempt", action="store_true",
                   help="allow parking low-priority decodes at chunk "
                        "boundaries when strictly more urgent work is "
                        "queued and no slot is free")
    p.add_argument("--dispatch-timeout", type=float,
                   default=float(os.environ.get(
                       "GYM_TPU_SERVE_WATCHDOG_S", 120.0)))
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--drain-deadline", type=float, default=300.0)
    p.add_argument("--metrics-dir", default=None,
                   help="this worker's serve.csv dir (default: a "
                        "private temp dir)")
    p.add_argument("--program-cache-dir", default=None,
                   help="the kernel library's build directory (spawned "
                        "replicas start at programs_compiled=0 against a "
                        "warm one)")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--weights-tag", default=None)
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' serves on the CPU "
                        "(tests)")
    return p


#: Submit-frame fields this worker version understands. Anything else is
#: IGNORED WITH A NOTE, never rejected: a mixed-version fleet (newer router,
#: older worker) degrades to serving the fields it knows.
_SUBMIT_FIELDS = frozenset({
    "type", "id", "prompt", "sampling", "prefix", "deadline_s",
    "stream", "submit_timeout", "coalesce_s", "tenant", "slo_class",
})


class WorkerReloadError(RuntimeError):
    """A worker-side rolling reload could not complete (drain timeout,
    concurrent reload) — reported typed over the wire; the router maps it
    into its ``FleetReloadError`` surface."""


class WorkerServer:
    """Frame dispatch over accepted connections. One reader thread per
    connection; per-request streamer threads; all writes on a connection
    serialized by its lock (frames interleave, never tear)."""

    def __init__(self, scheduler, supervisor, metrics, params_box,
                 engine_factory, replica_id: int, *, device,
                 warmup=None):
        self.scheduler = scheduler
        self.supervisor = supervisor
        self.metrics = metrics
        self.params_box = params_box
        self.engine_factory = engine_factory
        self.replica_id = int(replica_id)
        self.device = device
        self.warmup = warmup
        self.stop_event = threading.Event()
        self._reload_lock = threading.Lock()

    # -- observability -----------------------------------------------------

    def health_frame(self) -> Dict[str, Any]:
        from .. import programs as programs_mod
        sched = self.scheduler
        stats = sched.engine.stats    # advisory cross-thread read
        return {
            "type": "health_ok",
            "pid": os.getpid(),
            "replica_id": self.replica_id,
            "dead": self.supervisor.failed is not None,
            "backlog_tokens": sched.backlog_tokens(),
            "backlog_by_class": sched.backlog_tokens_by_class(),
            "preempt": bool(getattr(sched, "preempt", False)),
            "tenants": sched.tenant_snapshot(),
            "queue_depth": sched.queue_depth(),
            "active_requests": sched.active_requests(),
            "active_slots": int(stats.active_slots),
            "num_slots": int(stats.num_slots),
            "tokens_generated": int(stats.tokens_generated),
            "decode_steps": int(stats.decode_steps),
            "prefills": int(stats.prefills),
            "tokens_per_s_ewma": self.metrics.tokens_per_s_ewma(),
            # the kernel library's nvcc builds in this process (0 against
            # a warm build directory), the registry's program builds and
            # the CUDA graphs this worker captured
            "programs_compiled": programs_mod.xla_compile_counter(),
            "programs_built":
                programs_mod.default_registry().counters()["builds"],
            "graphs_captured": programs_mod.graphs_captured_counter(),
            "engine_generation": self.supervisor.generation,
            "engine_restarts": self.supervisor.restarts,
            "weights_tag": self.params_box.get("tag"),
            "warmup": (self.warmup.stats()
                       if self.warmup is not None else None),
        }

    # -- per-connection serving --------------------------------------------

    def serve_connection(self, conn: socket.socket) -> None:
        wlock = threading.Lock()
        live: Dict[Any, Any] = {}      # request id -> scheduler Request
        # cancels that arrived BEFORE their submit registered (the submit
        # can block in Scheduler.submit for seconds under a full queue):
        # applied the moment the request exists instead of dropped
        cancelled: set = set()

        def send(frame: Dict[str, Any]) -> bool:
            try:
                with wlock:
                    wire.send_frame(conn, frame)
                return True
            except (OSError, wire.WireError):
                return False           # router gone; streamers cancel

        send({"type": "hello", "pid": os.getpid(),
              "replica_id": self.replica_id,
              **{k: v for k, v in self.health_frame().items()
                 if k != "type"}})
        reg_lock = threading.Lock()   # live/cancelled registration:
        #                               closes the cancel-vs-submit race
        graceful = False
        try:
            while not self.stop_event.is_set():
                try:
                    frame = wire.recv_frame(conn)
                except OSError:
                    return         # connection torn down under us
                except wire.WireError as e:
                    sys.stderr.write(
                        f"gym_tpu_torch.serve.worker: protocol error from "
                        f"router — {type(e).__name__}: {e}; closing "
                        f"connection\n")
                    return
                if frame is None:
                    return             # router closed cleanly
                ftype = frame["type"]
                if ftype == "submit":
                    threading.Thread(
                        target=self._stream_request,
                        args=(frame, send, live, cancelled, reg_lock),
                        name=f"worker-stream-{frame.get('id')}",
                        daemon=True).start()
                elif ftype == "cancel":
                    with reg_lock:
                        req = live.get(frame.get("id"))
                        if req is None:
                            cancelled.add(frame.get("id"))
                    if req is not None:
                        self.scheduler.cancel(req)
                elif ftype == "health":
                    send(self.health_frame())
                elif ftype == "stats":
                    send({"type": "stats_ok", "id": frame.get("id"),
                          "headline": self.metrics.headline(),
                          **{k: v for k, v in self.health_frame().items()
                             if k != "type"}})
                elif ftype == "reload":
                    threading.Thread(
                        target=self._reload, args=(frame, send),
                        name="worker-reload", daemon=True).start()
                elif ftype == "stop":
                    send({"type": "stop_ok", "id": frame.get("id")})
                    graceful = True
                    self.stop_event.set()
                    return
                # unknown-but-valid types: ignore (forward compat)
        finally:
            # router connection GONE (not a graceful stop): its clients are
            # unreachable — cancel every stream it owned at the next chunk
            # boundary. A stop frame instead leaves them running for the
            # main drain (answer in-flight).
            if not graceful:
                for req in list(live.values()):
                    self.scheduler.cancel(req,
                                          reason="router disconnected")

    def _stream_request(self, frame: Dict[str, Any], send, live,
                        cancelled, reg_lock) -> None:
        from .scheduler import RequestFailedError, RequestStatus
        rid = frame.get("id")
        unknown = sorted(set(frame) - _SUBMIT_FIELDS)
        if unknown:
            sys.stderr.write(
                f"gym_tpu_torch.serve.worker: submit {rid} carries unknown "
                f"fields {unknown} — ignoring them (newer router?), "
                f"serving the fields this worker understands\n")
        try:
            prompt = np.asarray(frame["prompt"], np.int32).reshape(-1)
            sp = wire.sampling_from_dict(frame.get("sampling") or {})
            prefix = [int(t) for t in (frame.get("prefix") or [])]
            deadline_s = frame.get("deadline_s")
            req = self.scheduler.submit(
                prompt, sp, block=True,
                timeout=float(frame.get("submit_timeout", 30.0)),
                deadline_s=(None if deadline_s is None
                            else float(deadline_s)),
                tenant=frame.get("tenant"),
                slo_class=frame.get("slo_class"))
        except Exception as e:  # noqa: BLE001 — typed over the wire; the
            # router maps it back to the same class
            with reg_lock:
                cancelled.discard(rid)
            send(wire.exception_to_frame(rid, e))
            return
        with reg_lock:
            live[rid] = req
            was_cancelled = rid in cancelled
            cancelled.discard(rid)
        if was_cancelled:
            self.scheduler.cancel(req, reason="cancelled before admit")
        if not send({"type": "accepted", "id": rid}):
            self.scheduler.cancel(req, reason="router disconnected")
            live.pop(rid, None)
            return
        streaming = bool(frame.get("stream", True))
        # after the FIRST chunk, coalesce later tokens for a few ms a frame
        # (fewer frames and wakeups at the full decode rate)
        coalesce = float(frame.get("coalesce_s", 0.02))
        try:
            seen = 0
            sent_any = False
            while True:
                if not streaming:
                    # result-only: wait on the TERMINAL event itself, no
                    # per-token wakeups
                    if req._event.wait(timeout=1.0):
                        break
                    continue
                snapshot, terminal = req.wait_progress(seen, timeout=1.0)
                if (not terminal and sent_any and coalesce > 0
                        and len(snapshot) > seen):
                    time.sleep(coalesce)
                    snapshot, terminal = req.wait_progress(seen, 0.0)
                if len(snapshot) > seen:
                    # failover splice: verify the replayed prefix (a
                    # mismatch means the fleet is NOT serving one model;
                    # fail typed, never ship a corrupted stream), ship only
                    # what follows
                    for i in range(seen, min(len(snapshot), len(prefix))):
                        if snapshot[i] != prefix[i]:
                            self.scheduler.cancel(
                                req, reason="splice mismatch")
                            send(wire.exception_to_frame(
                                rid, _splice_mismatch(i, prefix[i],
                                                      snapshot[i])))
                            return
                    start = max(seen, len(prefix))
                    if len(snapshot) > start:
                        if not send({"type": "chunk", "id": rid,
                                     "tokens": snapshot[start:]}):
                            self.scheduler.cancel(
                                req, reason="router disconnected")
                            return
                        sent_any = True
                    seen = len(snapshot)
                if terminal:
                    break
            if req.status is RequestStatus.DONE:
                done = {"type": "done", "id": rid,
                        "tokens_total": len(req.tokens),
                        "new_tokens": len(req.tokens) - len(prefix),
                        "ttft_s": req.ttft_s,
                        "avg_token_latency_s": req.avg_token_latency_s}
                if not streaming:
                    # the prefix is verified result-only too
                    toks = list(req.tokens)
                    if toks[:len(prefix)] != prefix:
                        bad = next(
                            (i for i, want in enumerate(prefix)
                             if i >= len(toks) or toks[i] != want), 0)
                        send(wire.exception_to_frame(
                            rid, _splice_mismatch(
                                bad, prefix[bad],
                                toks[bad] if bad < len(toks) else -1)))
                        return
                    done["tokens"] = toks[len(prefix):]
                send(done)
            else:
                send(wire.exception_to_frame(
                    rid, req.exception
                    or RequestFailedError(req.error or "failed")))
        finally:
            live.pop(rid, None)

    def _reload(self, frame: Dict[str, Any], send) -> None:
        """Worker half of the rolling hot swap: drain, build the new engine
        (its graphs captured), swap, close the old one, resume — the
        sequence ``Router.reload`` runs against an in-process replica,
        driven over the wire."""
        from .load import load_params_snapshot
        rid = frame.get("id")
        t0 = time.perf_counter()
        if not self._reload_lock.acquire(blocking=False):
            send(wire.exception_to_frame(rid, WorkerReloadError(
                "a reload is already in progress on this worker")))
            return
        try:
            params = load_params_snapshot(frame["params_file"],
                                          device=self.device)
            self.params_box["params"] = params
            if frame.get("tag") is not None:
                self.params_box["tag"] = frame["tag"]
            self.scheduler.pause_admission()
            try:
                deadline = (time.perf_counter()
                            + float(frame.get("drain_timeout_s", 300.0)))
                while (self.scheduler.inflight()
                       and self.supervisor.failed is None):
                    if time.perf_counter() > deadline:
                        raise WorkerReloadError(
                            "worker did not drain within the reload "
                            "drain_timeout_s bound")
                    time.sleep(0.002)
                engine = self.engine_factory()
                old = self.scheduler.engine
                self.scheduler.replace_engine(engine)
                old.close()
                self.metrics.engine_reloaded()
            finally:
                self.scheduler.resume_admission()
            send({"type": "reload_ok", "id": rid,
                  "tag": self.params_box.get("tag"),
                  "wall_s": round(time.perf_counter() - t0, 3)})
        except Exception as e:  # noqa: BLE001 — reload failures are the
            # router's problem, typed; the worker keeps serving
            sys.stderr.write(
                f"gym_tpu_torch.serve.worker: reload failed:\n"
                f"{traceback.format_exc()}")
            send(wire.exception_to_frame(rid, e))
        finally:
            self._reload_lock.release()


def _splice_mismatch(i: int, want: int, got: int) -> BaseException:
    from .scheduler import EngineFailedError
    return EngineFailedError(
        f"failover splice verification failed: replayed token {i} is "
        f"{got}, client already received {want} — replicas are not "
        f"serving identical models")


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    import torch
    if args.device == "cpu":
        device = "cpu"
    elif not torch.cuda.is_available():
        print("gym_tpu_torch.serve.worker: no CUDA card "
              "(torch.cuda.is_available() is False); pass --device cpu to "
              "serve on the CPU", file=sys.stderr)
        return 1
    else:
        device = args.device or "cuda"

    # Per-replica fault arming (SDC drills): GYM_TPU_FAULTS is process-
    # global, so a spawner env would arm EVERY replica — corrupting the
    # failover target along with the victim. A replica-suffixed spec arms
    # just this worker.
    per_replica = os.environ.get(
        f"GYM_TPU_FAULTS_REPLICA_{args.replica_id}")
    if per_replica:
        from ..utils.resilience import faults
        faults.configure(per_replica)
        sys.stderr.write(
            f"gym_tpu_torch.serve.worker: replica {args.replica_id} armed "
            f"with faults: {per_replica}\n")

    from .. import programs as programs_mod
    cache_dir = (args.program_cache_dir
                 or os.environ.get("GYM_TPU_PROGRAM_CACHE_DIR"))
    if cache_dir:
        resolved = programs_mod.use_program_cache_dir(cache_dir)
        sys.stderr.write(
            f"gym_tpu_torch.serve.worker: kernel library build directory "
            f"{resolved}\n")

    from .engine import InferenceEngine
    from .load import config_from_json, load_for_serving, load_params_snapshot
    from .metrics import ServeMetrics
    from .scheduler import Scheduler
    from .supervisor import Supervisor

    if args.params_file:
        if not args.config_json:
            print("gym_tpu_torch.serve.worker: --params-file needs "
                  "--config-json", file=sys.stderr)
            return 1
        params = load_params_snapshot(args.params_file, device=device)
        cfg = config_from_json(args.config_json)
    elif args.ckpt:
        params, cfg, info = load_for_serving(
            args.ckpt, step=args.step, config_path=args.config,
            device=device)
        if args.weights_tag is None and info.get("step") is not None:
            args.weights_tag = f"step-{info['step']}"
    else:
        print("gym_tpu_torch.serve.worker: need --ckpt or "
              "--params-file/--config-json", file=sys.stderr)
        return 1

    page_size = args.page_size
    if page_size and cfg.block_size % page_size:
        page_size = 0
    paged = page_size > 0

    metrics_dir = args.metrics_dir
    if metrics_dir is None:
        import tempfile
        metrics_dir = tempfile.mkdtemp(
            prefix=f"gym_tpu_torch_worker{args.replica_id}_")
    metrics = ServeMetrics(metrics_dir)

    box: Dict[str, Any] = {"params": params, "tag": args.weights_tag}

    def make_engine():
        return InferenceEngine(
            box["params"], cfg, num_slots=args.num_slots,
            decode_chunk=args.decode_chunk, paged=paged,
            page_size=page_size or 16, kv_pages=args.kv_pages,
            spec_tokens=args.spec_tokens if paged else 0,
            weights_tag=box.get("tag"), device=device)

    def factory():
        # a rebuilt or reloaded engine captures its family before it serves
        engine = make_engine()
        if not args.no_warmup:
            programs_mod.warm_engine_programs(engine, start=False).run()
        return engine

    quotas = None
    if args.quotas_json:
        from .scheduler import ClassQuota
        quotas = {cls: ClassQuota(**spec)
                  for cls, spec in json.loads(args.quotas_json).items()}
    sched = Scheduler(make_engine(), max_queue=args.max_queue,
                      metrics=metrics, quotas=quotas,
                      preempt=args.preempt)
    sup = Supervisor(sched, factory,
                     dispatch_timeout_s=args.dispatch_timeout,
                     max_restarts=args.max_restarts, metrics=metrics,
                     log=lambda *a, **k: print(
                         *a, file=sys.stderr,
                         **{k_: v for k_, v in k.items()
                            if k_ != "flush"}, flush=True))
    sup.start()
    warm = None
    if not args.no_warmup:
        warm = programs_mod.warm_engine_programs(
            sched.engine, log=sys.stderr.write)

    server = WorkerServer(sched, sup, metrics, box, factory,
                          args.replica_id, device=device, warmup=warm)

    sock_path = args.socket
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(sock_path)
    listener.listen(4)
    listener.settimeout(0.25)

    def _on_term(signum, frame):
        server.stop_event.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_term)

    sys.stderr.write(
        f"gym_tpu_torch.serve.worker: ready — replica {args.replica_id} "
        f"pid {os.getpid()} on {sock_path} ({args.num_slots} slots, "
        f"{'paged' if paged else 'unpaged'} kv, {device})\n")
    sys.stderr.flush()

    conns: list = []
    ppid0 = os.getppid()
    try:
        while not server.stop_event.is_set():
            if os.getppid() != ppid0:
                # the router process died: a worker must NEVER outlive its
                # parent — drain and exit instead of leaking
                sys.stderr.write(
                    f"gym_tpu_torch.serve.worker: parent {ppid0} is gone — "
                    f"shutting down\n")
                break
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=server.serve_connection,
                                 args=(conn,), name="worker-conn",
                                 daemon=True)
            t.start()
            conns.append((conn, t))
    finally:
        listener.close()
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        # graceful drain, the serve __main__ SIGTERM sequence: answer
        # in-flight, fail queued typed, flush the CSV, exit 0
        if warm is not None:
            warm.stop()
            warm.join(timeout=120.0)
        if sup.stop(join_timeout_s=args.drain_deadline):
            sched.shutdown(finish_running=True,
                           deadline_s=args.drain_deadline)
        else:
            from ..utils.resilience import dump_thread_stacks
            sys.stderr.write(dump_thread_stacks(
                f"gym_tpu_torch.serve.worker: driver wedged past the "
                f"{args.drain_deadline:.0f}s drain deadline:"))
            sched.shutdown(finish_running=False, deadline_s=0.0)
        for conn, _t in conns:
            try:
                conn.close()
            except OSError:
                pass
        metrics.sync()
        head = metrics.headline()
        sys.stderr.write(
            f"gym_tpu_torch.serve.worker: replica {args.replica_id} shut "
            f"down cleanly — {head['requests_done']} done, "
            f"{head['requests_failed']} failed, "
            f"tokens_per_s={head['tokens_per_s']}\n")
        metrics.close()
        sched.engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
