"""``python -m gym_tpu_torch.serve --ckpt <run_dir>`` — stdlib-HTTP serving
on the card (counterpart of ``python -m gym_tpu.serve``, its in-process
replicas).

No framework: ``http.server.ThreadingHTTPServer`` + the router over N
in-process replicas (``serve/router.py``), each an engine, a ``Scheduler``
and a ``Supervisor`` whose driver thread runs the engine loop inside a
watchdog; handler threads submit and block on the request future. The
endpoints, status codes and JSON keys are the JAX server's:

- ``POST /generate`` — JSON body with either ``prompt`` (a list of token
  ids) or ``text`` (char-level corpora only: encoded via ``CHAR_VOCAB``),
  plus optional ``max_new_tokens`` / ``temperature`` / ``top_k`` /
  ``top_p`` / ``eos_token`` / ``seed`` / ``deadline_s`` / ``stream``.
  ``deadline_s`` (also the ``X-Deadline-S`` header; the body field wins)
  bounds the request end to end: admission control rejects it up front
  (429 + ``Retry-After``) when the live tokens/s EWMA says the backlog
  cannot meet it; a queued request past deadline is shed before prefill
  and a running one cancelled at the next chunk boundary (504, typed).
- ``GET /stats`` (alias ``/healthz``) — engine + metrics headline JSON:
  supervisor state, the fleet view (per-replica health, ``failovers``,
  ``weight_reloads``), ``prefix_hit_blocks``, ``paged``, the background
  ``warmup`` progress, ``programs_compiled`` (the kernel library's
  ``nvcc`` builds in this process: 0 against a warm build directory) and
  ``graphs_captured`` (the CUDA graphs this process captured; a restart
  captures its engines' families again).
- ``POST /reload`` — zero-downtime weight hot-swap: re-reads the
  checkpoint run dir (optionally ``{"ckpt": ..., "step": ...}``) and
  rolls the new params through the replicas one at a time. ``--reload-
  watch S`` does the same whenever the trainer commits a newer
  checkpoint (``serve/load.py``'s ``CheckpointWatcher``).

====================== ======================================
400                     malformed JSON / bad params / prompt
                        too long (typed ``ValueError`` body)
429 + ``Retry-After``   queue full, admission-control reject
503 + ``Retry-After``   shutting down, engine failed/rebuilt,
                        slot quarantined (NaN), injected IO
504                     deadline exceeded (shed or cancelled)
====================== ======================================

On the card each engine's decode chunks and prefill buckets are CUDA
graphs (``programs/``), captured by a background warmup at startup
(``--no-warmup``: at first use); ``--program-cache-dir`` names the
directory the kernel library is built and cached in, the one artifact a
restart reuses. ``--device`` defaults to the card; the CPU serves only
when ``--device cpu`` asks for it (tests), and without a card the server
exits non-zero instead of serving on the CPU.

Quantized serving: ``--quant {int8,int4}`` quantizes the restored weights
at load (per-tile int8/int4 values and f32 scales, B6 on the card),
``--quant-embed`` the tied embedding and lm head too (only with
``--quant``), ``--kv-quant int8`` keeps the KV pool in int8 with f32 scales
(B7's int8 form). A reload quantizes the new step's weights the same way;
``/stats`` echoes ``weights_dtype`` and ``kv_dtype``.

SIGTERM/SIGINT drain: stop accepting, fail queued requests (typed),
answer in-flight ones (bounded by ``--drain-deadline``), close the
listener, flush ``serve.csv``, print "shut down cleanly" and the
``tokens_per_s`` headline, exit 0.

Flags of later items keep their names and exit 2 naming the item:
``--out-of-process``, ``--autoscale``, ``--autoscale-interval``,
``--min-replicas``, ``--max-replicas`` and ``--worker-startup-timeout``
(the process fleet, ROADMAP item 15).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np

#: flags of later items: (attribute, flag, the item that ports it)
LATER_FLAGS = (
    ("out_of_process", "--out-of-process", "ROADMAP item 15"),
    ("autoscale", "--autoscale", "ROADMAP item 15"),
    ("autoscale_interval", "--autoscale-interval", "ROADMAP item 15"),
    ("min_replicas", "--min-replicas", "ROADMAP item 15"),
    ("max_replicas", "--max-replicas", "ROADMAP item 15"),
    ("worker_startup_timeout", "--worker-startup-timeout",
     "ROADMAP item 15"),
)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gym_tpu_torch.serve",
        description="Serve a gym_tpu_torch checkpoint over HTTP "
                    "(continuous-batching KV-cache decode on the card).")
    p.add_argument("--ckpt", required=True, metavar="RUN_DIR",
                   help="checkpoint run dir: fit(save_dir=...)/<run_name>")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: newest valid)")
    p.add_argument("--config", default=None, metavar="CONFIG_JSON",
                   help="explicit config.json (default: the run dir's)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--num_slots", type=int, default=4,
                   help="concurrent decode slots (the batch width)")
    p.add_argument("--replicas", type=int, default=1,
                   help="in-process engine replicas behind the "
                        "health-aware router (failover and a rolling "
                        "hot swap need >= 2)")
    p.add_argument("--failover-retries", type=int, default=None,
                   help="per-request failover re-dispatch budget "
                        "(default: min(2, replicas-1))")
    p.add_argument("--reload-watch", type=float, default=0.0,
                   help="poll the checkpoint run dir every S seconds "
                        "and hot-swap newer checkpoints into the fleet "
                        "(0 = off; POST /reload always works)")
    p.add_argument("--decode_chunk", type=int, default=1,
                   help="decode steps fused per dispatch (chunk boundary "
                        "= deadline-cancellation granularity)")
    p.add_argument("--page_size", type=int, default=16,
                   help="paged KV cache page size in tokens (must divide "
                        "block_size; 0 = the unpaged per-slot cache)")
    p.add_argument("--kv_pages", type=int, default=None,
                   help="physical pages in the paged KV pool (default: "
                        "null page + num_slots full windows)")
    p.add_argument("--spec_tokens", type=int, default=0,
                   help="speculative decoding draft length (0 = off; "
                        "paged only); streams stay equal to "
                        "non-speculative decoding")
    p.add_argument("--quant", choices=("int8", "int4"), default=None,
                   help="quantize the restored weights at load: per-tile "
                        "int8/int4 values and f32 scales (the QuantizeCodec "
                        "tiling), consumed by B6 on the card; the embedding "
                        "and lm head stay f32 unless --quant-embed "
                        "(default: f32)")
    p.add_argument("--quant-embed", action="store_true",
                   help="with --quant: quantize the tied embedding and lm "
                        "head too")
    p.add_argument("--kv-quant", choices=("int8",), default=None,
                   help="keep the KV cache in int8 with one f32 scale per "
                        "(position, head): the same kv_pages hold 4x the "
                        "payload in a quarter of the bytes (default: f32)")
    p.add_argument("--max_queue", type=int, default=64,
                   help="FCFS queue bound (backpressure: submits beyond "
                        "it wait, then 429)")
    p.add_argument("--quotas", default=None, metavar="JSON",
                   help="per-SLO-class token-rate quotas as JSON, e.g. "
                        "'{\"batch\": {\"share\": 0.5}}'")
    p.add_argument("--preempt", action="store_true",
                   help="preemptible decode: park a low-priority running "
                        "request for a more urgent one")
    p.add_argument("--request_timeout", type=float, default=600.0,
                   help="per-request wall-clock bound inside a handler")
    p.add_argument("--default-deadline", type=float, default=None,
                   help="deadline_s applied to requests that set none")
    p.add_argument("--dispatch-timeout", type=float,
                   default=float(os.environ.get(
                       "GYM_TPU_SERVE_WATCHDOG_S", 120.0)),
                   help="supervisor watchdog: a dispatch wedged past this "
                        "triggers engine failover (env "
                        "GYM_TPU_SERVE_WATCHDOG_S)")
    p.add_argument("--max-restarts", type=int, default=5,
                   help="engine rebuilds before the supervisor declares "
                        "the engine unrecoverable")
    p.add_argument("--drain-deadline", type=float, default=300.0,
                   help="SIGTERM: max seconds to finish in-flight "
                        "requests before failing them")
    p.add_argument("--metrics_dir", default=None,
                   help="serve.csv location (default: <RUN_DIR>/serve)")
    p.add_argument("--program-cache-dir", default=None,
                   help="directory the kernel library is built and cached "
                        "in (or GYM_TPU_PROGRAM_CACHE_DIR; default "
                        "build/gym_tpu_torch/ in the checkout): a restart "
                        "against it runs no nvcc — /stats "
                        "programs_compiled stays 0")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the background capture of every engine's "
                        "program family at startup (requests then "
                        "capture on first use)")
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' serves on the CPU "
                        "(tests)")
    later = p.add_argument_group(
        "later items", "kept by name; each exits 2 naming the item that "
                       "ports it")
    later.add_argument("--out-of-process", action="store_true")
    later.add_argument("--autoscale", action="store_true")
    later.add_argument("--autoscale-interval", type=float, default=None)
    later.add_argument("--min-replicas", type=int, default=None)
    later.add_argument("--max-replicas", type=int, default=None)
    later.add_argument("--worker-startup-timeout", type=float, default=None)
    return p


@dataclasses.dataclass
class ServerHandle:
    """Everything a caller (main() or an in-process test) needs to drive
    and tear down one serving stack. ``scheduler``/``supervisor``/
    ``engine_factory`` are replica 0's; ``router`` is the fleet."""

    httpd: ThreadingHTTPServer
    scheduler: Any
    supervisor: Any
    metrics: Any
    engine_factory: Any
    info: Dict[str, Any]
    router: Any = None
    warmup: Any = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def stop_warmup(self) -> None:
        """Stop AND join the background warmup before teardown: it may be
        inside a capture, which must end before the engines close.
        Shared by close() and main()'s SIGTERM drain."""
        if self.warmup is not None:
            self.warmup.stop()
            self.warmup.join(timeout=120.0)

    def close(self, drain_deadline_s: float = 30.0) -> None:
        """Test-path teardown: stop every replica's driver, drain it
        (wedged replicas get their stacks dumped and their requests
        failed typed), close the engines and the sockets."""
        self.stop_warmup()
        self.router.close(drain_deadline_s=drain_deadline_s)
        self.httpd.shutdown()
        self.httpd.server_close()
        self.metrics.close()


def create_server(params, cfg, *, host: str = "127.0.0.1", port: int = 0,
                  num_slots: int = 4, decode_chunk: int = 1,
                  max_queue: int = 64, request_timeout: float = 600.0,
                  default_deadline: Optional[float] = None,
                  dispatch_timeout: float = 120.0, max_restarts: int = 5,
                  metrics_dir: Optional[str] = None,
                  info: Optional[Dict[str, Any]] = None,
                  stop_event: Optional[threading.Event] = None,
                  page_size: int = 16, kv_pages: Optional[int] = None,
                  spec_tokens: int = 0, replicas: int = 1,
                  failover_retries: Optional[int] = None,
                  reload_source: Optional[Any] = None,
                  warmup: bool = True,
                  quotas: Optional[Dict[str, Any]] = None,
                  preempt: bool = False, device="cuda") -> ServerHandle:
    """Build the serving stack — replica fleet (engines, schedulers,
    supervisors, router), metrics, HTTP server — WITHOUT entering
    ``serve_forever``. ``main`` and the in-process tests share this path.
    ``port=0`` binds an ephemeral port (``handle.port``).
    ``reload_source(body) -> (params, weights_tag)`` supplies ``POST
    /reload``'s checkpoint re-read (absent: /reload answers 400).

    ``warmup=True`` starts a background thread that builds every
    replica's complete program family (all power-of-two prefill buckets
    and the decode, spec, copy-on-write or admit programs): on the card
    their CUDA graphs, captured under each engine's dispatch lock, so a
    cold request pays no capture; later engines (a supervisor rebuild, a
    hot swap) capture theirs before they serve. ``device`` is every
    engine's."""
    from .. import programs as programs_mod
    from ..data.build_dataset import CHAR_VOCAB
    from ..utils.checkpoint import CheckpointNotFoundError
    from ..utils.resilience import fault_point
    from .engine import SamplingParams
    from .metrics import ServeMetrics
    from .router import FleetReloadError, NoHealthyReplicaError, build_fleet
    from .scheduler import (AdmissionRejectedError, DeadlineExceededError,
                            EngineFailedError, QueueFullError,
                            RequestCancelledError, SchedulerClosedError,
                            SlotQuarantinedError)

    info = dict(info or {"step": None, "num_nodes": None})
    stop = stop_event or threading.Event()
    if metrics_dir is None:
        # per-instance dir: a fixed shared default would interleave two
        # servers' rows in one append-mode serve.csv
        import tempfile
        metrics_dir = tempfile.mkdtemp(prefix="gym_tpu_torch_serve_")

    if page_size and cfg.block_size % page_size:
        sys.stderr.write(
            f"gym_tpu_torch.serve: page_size {page_size} does not divide "
            f"block_size {cfg.block_size} — serving unpaged"
            + (", speculative decoding disabled (it requires the paged "
               "cache)" if spec_tokens else "") + "\n")
        page_size = 0
    paged = page_size > 0
    if spec_tokens and not paged:
        sys.stderr.write(
            "gym_tpu_torch.serve: --spec_tokens requires the paged cache "
            "(--page_size > 0) — speculative decoding disabled\n")

    metrics = ServeMetrics(metrics_dir)
    weights_tag = (f"step-{info['step']}"
                   if info.get("step") is not None else None)
    router = build_fleet(
        params, cfg, replicas=replicas, num_slots=num_slots,
        decode_chunk=decode_chunk, paged=paged,
        page_size=page_size or 16, kv_pages=kv_pages,
        spec_tokens=spec_tokens if paged else 0, max_queue=max_queue,
        metrics=metrics, dispatch_timeout_s=dispatch_timeout,
        max_restarts=max_restarts, max_failovers=failover_retries,
        weights_tag=weights_tag, quotas=quotas, preempt=preempt,
        device=device, warm_rebuilds=warmup)
    rep0 = router.replicas[0]
    sched, sup = rep0.scheduler, rep0.supervisor
    warm_thread = None
    if warmup:
        # a graph belongs to one engine: warm every replica's family; a
        # request arriving mid-warmup waits for at most one capture and
        # single-flights into the same entry
        warm_thread = programs_mod.warm_engine_programs(
            [rep.scheduler.engine for rep in router.replicas],
            log=sys.stderr.write)
    char_level = cfg.vocab_size <= len(CHAR_VOCAB) + 1

    def agg_tenant_snapshots(snaps):
        """Fold per-replica ``tenant_snapshot``s into one /stats
        ``tenants`` block: counters sum; per-class quota fill reports
        the MOST CONSTRAINED replica."""
        agg: Dict[str, Any] = {"preemptions": 0, "resumes": 0,
                               "parked": 0, "quota_rejections": {},
                               "quota_fill": {}, "backlog_by_class": {}}
        for s in snaps:
            if not s:
                continue
            agg["preemptions"] += int(s.get("preemptions", 0) or 0)
            agg["resumes"] += int(s.get("resumes", 0) or 0)
            agg["parked"] += int(s.get("parked", 0) or 0)
            for k, v in (s.get("quota_rejections") or {}).items():
                agg["quota_rejections"][k] = (
                    agg["quota_rejections"].get(k, 0) + int(v or 0))
            for k, v in (s.get("backlog_by_class") or {}).items():
                agg["backlog_by_class"][k] = (
                    agg["backlog_by_class"].get(k, 0) + int(v or 0))
            for k, v in (s.get("quota_fill") or {}).items():
                if v is None:
                    agg["quota_fill"].setdefault(k, None)
                else:
                    prev = agg["quota_fill"].get(k)
                    agg["quota_fill"][k] = (float(v) if prev is None
                                            else min(prev, float(v)))
        return agg

    def encode_text(text: str):
        table = {c: i for i, c in enumerate(CHAR_VOCAB)}
        toks = [table[c] for c in text if c in table]
        if not toks:
            raise ValueError("text encodes to an empty prompt under the "
                             "char vocab")
        return np.asarray(toks, np.int32)

    def decode_text(tokens):
        return "".join(CHAR_VOCAB[t] for t in tokens
                       if 0 <= t < len(CHAR_VOCAB))

    class Handler(BaseHTTPRequestHandler):
        # quiet structured access log — one line per request on stderr
        def log_message(self, fmt, *a):
            sys.stderr.write("gym_tpu_torch.serve: " + fmt % a + "\n")

        def _reply(self, code: int, payload: dict,
                   retry_after_s: Optional[float] = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after_s is not None:
                self.send_header("Retry-After",
                                 str(max(1, math.ceil(retry_after_s))))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path not in ("/stats", "/healthz"):
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            fleet = router.status()
            engines = [rep.scheduler.engine for rep in router.replicas]
            stats = [e.stats for e in engines]
            eng0 = engines[0]
            buckets = sorted({b for s in stats for b in s.prefill_buckets})
            drafted = sum(s.spec_drafted for s in stats)
            accepted = sum(s.spec_accepted for s in stats)
            head = metrics.headline()
            rep_counters = head.pop("replicas", {})
            # ONE per-replica section: live engine samples + the
            # metrics collector's per-replica counters folded into the
            # router's health entries
            for entry, s in zip(fleet["replicas"], stats):
                entry.update(active_slots=s.active_slots,
                             tokens_generated=s.tokens_generated,
                             quarantined=s.quarantined)
                entry.update(rep_counters.get(str(entry["id"]), {}))
            dead = sum(1 for rep in router.replicas if rep.dead)
            self._reply(200, {
                **head,                 # first: the LIVE engine stats
                #                         below win over its tick samples
                "status": ("draining" if stop.is_set() else
                           "degraded" if dead else "ok"),
                "step": info["step"],
                "num_slots": sum(s.num_slots for s in stats),
                "active_slots": sum(s.active_slots for s in stats),
                "queue_depth": sum(rep.scheduler.queue_depth()
                                   for rep in router.replicas),
                "tokens_generated": sum(s.tokens_generated
                                        for s in stats),
                "decode_steps": sum(s.decode_steps for s in stats),
                "prefills": sum(s.prefills for s in stats),
                "prefill_buckets": buckets,
                "prefill_tokens": sum(s.prefill_tokens for s in stats),
                "paged": bool(getattr(eng0, "paged", False)),
                "page_size": int(getattr(eng0, "page_size", 0)),
                "kv_pages": int(getattr(eng0, "kv_pages", 0)),
                "spec_tokens": int(getattr(eng0, "spec_tokens", 0)),
                # quantized serving's config echo and byte footprints
                "weights_dtype": getattr(eng0, "weights_dtype", "f32"),
                "kv_dtype": getattr(eng0, "kv_dtype", "f32"),
                "kv_blocks_capacity_effective": sum(
                    int(getattr(e, "kv_blocks_capacity_effective", 0))
                    for e in engines),
                "weights_bytes": int(getattr(eng0, "weights_bytes", 0)),
                "kv_blocks_in_use": sum(s.kv_blocks_in_use
                                        for s in stats),
                "kv_blocks_cached": sum(s.kv_blocks_cached
                                        for s in stats),
                "prefix_hit_blocks": sum(s.prefix_hit_blocks
                                         for s in stats),
                "spec_accept_rate": (accepted / drafted
                                     if drafted else None),
                # the program registry: the kernel library's nvcc builds
                # this process ran — THE restart-drill observable (0
                # against a warm build directory) — the CUDA graphs
                # captured (a restart captures again) and the background
                # warmup's progress
                "programs_compiled": programs_mod.xla_compile_counter(),
                "graphs_captured": programs_mod.graphs_captured_counter(),
                "warmup": (warm_thread.stats()
                           if warm_thread is not None else None),
                # multi-tenant serving: live quota fill,
                # preemption/park counters and per-class backlog
                "tenants": agg_tenant_snapshots(
                    [rep.scheduler.tenant_snapshot()
                     for rep in router.replicas if not rep.dead]),
                # pre-fleet surface: replica 0's supervisor state (the
                # keys every existing dashboard/drill greps)
                **sup.status(),
                # the fleet view: per-replica health/load/weights,
                # failovers, reloads — wins over the aggregates above
                # where keys collide (replicas, failovers, …)
                **fleet,
            })

        def do_POST(self):
            if self.path == "/reload":
                self._do_reload()
                return
            if self.path != "/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                fault_point("serve.http")
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) or b"{}"
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError as e:
                    raise ValueError(f"malformed JSON body: {e}")
                if not isinstance(body, dict):
                    raise ValueError(
                        f"JSON body must be an object, got "
                        f"{type(body).__name__}")
                if "prompt" in body:
                    prompt = np.asarray(body["prompt"], np.int32)
                elif "text" in body and char_level:
                    prompt = encode_text(body["text"])
                elif "text" in body:
                    raise ValueError(
                        "text prompts need a char-level vocab; this model "
                        f"has vocab_size={cfg.vocab_size} — send token "
                        "ids as 'prompt'")
                else:
                    raise ValueError("body needs 'prompt' (token ids) "
                                     "or 'text'")
                sp = SamplingParams(
                    max_new_tokens=int(body.get("max_new_tokens", 64)),
                    temperature=float(body.get("temperature", 1.0)),
                    top_k=(None if body.get("top_k") is None
                           else int(body["top_k"])),
                    top_p=(None if body.get("top_p") is None
                           else float(body["top_p"])),
                    eos_token=(None if body.get("eos_token") is None
                               else int(body["eos_token"])),
                    seed=int(body.get("seed", 0)))
                # body field wins over the X-Deadline-S header; both win
                # over the server-wide default
                deadline = body.get("deadline_s",
                                    self.headers.get("X-Deadline-S"))
                deadline = (default_deadline if deadline is None
                            else float(deadline))
                stream = bool(body.get("stream", False))
                # multi-tenant tags: body field wins over the header;
                # both optional — absent = the default tenant/class
                # (single-tenant behavior)
                tenant = body.get("tenant",
                                  self.headers.get("X-Tenant"))
                slo_class = body.get("slo_class",
                                     self.headers.get("X-SLO-Class"))
                if tenant is not None:
                    tenant = str(tenant)
                if slo_class is not None:
                    slo_class = str(slo_class)
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": str(e)})
                return
            except OSError as e:      # serve.http injected IO fault
                self._reply(503, {"error": f"{type(e).__name__}: {e}"},
                            retry_after_s=1.0)
                return
            try:
                req = router.submit(prompt, sp, timeout=30.0,
                                    deadline_s=deadline, tenant=tenant,
                                    slo_class=slo_class)
            except AdmissionRejectedError as e:
                self._reply(429, {"error": str(e)},
                            retry_after_s=e.retry_after_s)
                return
            except QueueFullError as e:
                self._reply(429, {"error": str(e)}, retry_after_s=2.0)
                return
            except NoHealthyReplicaError as e:
                self._reply(503, {"error": str(e)},
                            retry_after_s=e.retry_after_s)
                return
            except SchedulerClosedError as e:
                self._reply(503, {"error": str(e)}, retry_after_s=10.0)
                return
            except ValueError as e:
                # a prompt the KV cache can't fit, bad sampling params
                self._reply(400, {"error": str(e)})
                return
            except OSError as e:      # serve.admit injected IO fault
                self._reply(503, {"error": f"{type(e).__name__}: {e}"},
                            retry_after_s=1.0)
                return
            # the handler's own wait honors the request deadline: even if
            # the driver is wedged (the watchdog will reap it), the
            # client gets its typed answer within deadline + grace
            wait_s = request_timeout
            if deadline is not None:
                wait_s = min(wait_s, deadline + 5.0)
            if stream:
                self._stream_reply(req, prompt, wait_s)
                return
            try:
                tokens = req.result(timeout=wait_s)
            except DeadlineExceededError as e:
                self._reply(504, {"error": str(e),
                                  "tokens_before_deadline":
                                  len(req.tokens)})
                return
            except TimeoutError as e:
                self._reply(504, {"error": str(e)})
                return
            except (EngineFailedError, SlotQuarantinedError,
                    SchedulerClosedError) as e:
                self._reply(503, {"error": f"{type(e).__name__}: {e}"},
                            retry_after_s=2.0)
                return
            except AdmissionRejectedError as e:
                # a failover retry shed at the SIBLING's admission (the
                # remaining deadline is infeasible there): same 429 +
                # Retry-After contract as a front-door shed
                self._reply(429, {"error": str(e)},
                            retry_after_s=e.retry_after_s)
                return
            except QueueFullError as e:
                self._reply(429, {"error": str(e)}, retry_after_s=2.0)
                return
            except NoHealthyReplicaError as e:
                self._reply(503, {"error": str(e)},
                            retry_after_s=e.retry_after_s)
                return
            except OSError as e:
                # a request failed by an IO fault (e.g. serve.prefill
                # oserror) stores that exception; it must surface as a
                # typed 503, not escape the handler as a traceback
                self._reply(503, {"error": f"{type(e).__name__}: {e}"},
                            retry_after_s=1.0)
                return
            except RuntimeError as e:
                self._reply(503, {"error": str(e)})
                return
            out = {"tokens": tokens,
                   "prompt_tokens": int(prompt.size),
                   "ttft_s": round(req.ttft_s, 5),
                   "latency_s": round(req.done_t - req.submit_t, 5),
                   "replica": req.replica_id,
                   "failovers": req.failovers}
            if char_level:
                out["text"] = decode_text(tokens)
            self._reply(200, out)

        def _sse(self, obj: dict) -> None:
            self.wfile.write(b"data: " + json.dumps(obj).encode()
                             + b"\n\n")
            self.wfile.flush()

        def _stream_reply(self, req, prompt, wait_s: float) -> None:
            """``"stream": true`` — chunked SSE: one ``data:`` event per
            decode chunk, then a final summary event. TTFB collapses
            from completion time to FIRST-token time; a mid-stream
            replica death is spliced by the router (the concatenated
            events are byte-identical to an uncontended run); a client
            that disconnects (EPIPE on the chunked write) has its
            request cancelled at the next decode-chunk boundary and
            recorded ``status=disconnected`` — never a traceback."""
            metrics.stream_started()
            tokens = []
            try:
                try:
                    # header writes can ALREADY raise EPIPE (client
                    # gone before the first byte) — they must sit
                    # inside the disconnect guard or the generation
                    # runs for nobody and the handler tracebacks
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    for chunk in req.stream(timeout=wait_s):
                        tokens.extend(chunk)
                        self._sse({"tokens": chunk,
                                   "replica": req.replica_id})
                    out = {"done": True,
                           "tokens_total": len(tokens),
                           "prompt_tokens": int(prompt.size),
                           "ttft_s": (round(req.ttft_s, 5)
                                      if req.ttft_s is not None
                                      else None),
                           "latency_s": (round(req.done_t - req.submit_t,
                                               5)
                                         if req.done_t is not None
                                         else None),
                           "replica": req.replica_id,
                           "failovers": req.failovers}
                    if char_level:
                        out["text"] = decode_text(tokens)
                    self._sse(out)
                except (BrokenPipeError, ConnectionResetError):
                    # the client went away mid-stream: cancel at the
                    # next chunk boundary, free the slot; metrics land
                    # as status=disconnected via RequestCancelledError
                    req.cancel(reason="client disconnected mid-stream")
                    self.close_connection = True
                except (DeadlineExceededError, TimeoutError,
                        AdmissionRejectedError, QueueFullError,
                        EngineFailedError, SlotQuarantinedError,
                        SchedulerClosedError, NoHealthyReplicaError,
                        RequestCancelledError, OSError,
                        RuntimeError) as e:
                    # headers are gone — the typed failure travels as a
                    # terminal SSE event instead of a status code
                    try:
                        self._sse({"error": str(e),
                                   "error_type": type(e).__name__,
                                   "tokens_total": len(tokens)})
                    except (BrokenPipeError, ConnectionResetError):
                        req.cancel(reason="client disconnected")
                        self.close_connection = True
            finally:
                metrics.stream_ended()

        def _do_reload(self):
            """Zero-downtime weight hot-swap over HTTP: re-read the
            checkpoint (body: optional ``ckpt``/``step``), roll it
            through the fleet. 400 bad body/source, 409 when a reload
            is already rolling, 503 when a replica failed to drain."""
            if reload_source is None:
                self._reply(400, {
                    "error": "no reload source configured — start the "
                             "server via `python -m gym_tpu_torch.serve "
                             "--ckpt ...` to enable /reload"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) or b"{}"
                body = json.loads(raw)
                if not isinstance(body, dict):
                    raise ValueError(
                        f"JSON body must be an object, got "
                        f"{type(body).__name__}")
                drain_s = float(body.get("drain_timeout_s", 300.0))
            except (json.JSONDecodeError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"malformed reload body: {e}"})
                return
            try:
                new_params, tag = reload_source(body)
            except (CheckpointNotFoundError, FileNotFoundError,
                    ValueError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except OSError as e:
                self._reply(503, {"error": f"{type(e).__name__}: {e}"},
                            retry_after_s=5.0)
                return
            try:
                result = router.reload(
                    new_params, weights_tag=tag, drain_timeout_s=drain_s)
            except FleetReloadError as e:
                if e.retry_after_s is not None:
                    # a replica failed to drain in time — transient
                    self._reply(503, {"error": str(e)},
                                retry_after_s=e.retry_after_s)
                else:       # another rollout already in flight
                    self._reply(409, {"error": str(e)})
                return
            except SchedulerClosedError as e:
                self._reply(503, {"error": str(e)}, retry_after_s=10.0)
                return
            if tag and tag.startswith("step-"):
                # /stats "step" tracks the weights actually serving
                try:
                    info["step"] = int(tag[5:])
                except ValueError:
                    pass
            self._reply(200, result)

    httpd = ThreadingHTTPServer((host, port), Handler)
    # answered-before-closed: server_close waits for handler threads, so
    # every accepted request gets its JSON reply before the process exits
    httpd.daemon_threads = False
    httpd.block_on_close = True
    router.start()
    return ServerHandle(httpd=httpd, scheduler=sched, supervisor=sup,
                        metrics=metrics, engine_factory=rep0.engine_factory,
                        info=info, router=router, warmup=warm_thread)


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.quant_embed and not args.quant:
        # refused, not ignored: quant_embed means nothing on f32 weights
        parser.error("--quant-embed requires --quant {int8,int4}")
    for attr, flag, item in LATER_FLAGS:
        if getattr(args, attr) not in (None, False):
            print(f"gym_tpu_torch.serve: {flag} is ported with {item} of "
                  f"gym_tpu_torch (ROADMAP.md)", file=sys.stderr)
            return 2
    import torch
    if args.device == "cpu":
        device = "cpu"
    elif not torch.cuda.is_available():
        print("gym_tpu_torch.serve: no CUDA card (torch.cuda.is_available() "
              "is False); pass --device cpu to serve on the CPU",
              file=sys.stderr)
        return 1
    else:
        device = args.device or "cuda"

    from .. import programs as programs_mod
    from ..utils.checkpoint import CheckpointNotFoundError
    from .load import CheckpointWatcher, load_for_serving

    cache_dir = (args.program_cache_dir
                 or os.environ.get("GYM_TPU_PROGRAM_CACHE_DIR"))
    if cache_dir:
        # before the first kernel launch (load_for_serving's crc32c runs
        # in the library on the card)
        resolved = programs_mod.use_program_cache_dir(cache_dir)
        print(f"gym_tpu_torch.serve: kernel library build directory "
              f"{resolved}", file=sys.stderr, flush=True)
    quant_kw = dict(weights_dtype=args.quant, kv_dtype=args.kv_quant,
                    quant_embed=args.quant_embed)
    try:
        params, cfg, info = load_for_serving(
            args.ckpt, step=args.step, config_path=args.config,
            device=device, **quant_kw)
    except (CheckpointNotFoundError, FileNotFoundError, ValueError) as e:
        print(f"gym_tpu_torch.serve: cannot load {args.ckpt}: {e}",
              file=sys.stderr)
        return 1
    quant_note = ""
    if args.quant or args.kv_quant:
        quant_note = (f", quantized (weights {cfg.weights_dtype}"
                      + (", embed" if cfg.quant_embed else "")
                      + f", kv {cfg.kv_dtype})")
    print(f"gym_tpu_torch.serve: restored step {info['step']} "
          f"({info['num_nodes']}-node average) from {args.ckpt} on "
          f"{device}{quant_note}", flush=True)

    def reload_source(body):
        """POST /reload + the checkpoint watcher: re-read the run dir
        (newest valid step unless pinned) and hand back the node-averaged
        params with a ``step-N`` weights tag, quantized as at startup (a
        hot swap never changes the serving dtypes). The architecture must
        match: the engines' programs are config-keyed."""
        ckpt = body.get("ckpt") or args.ckpt
        new_params, new_cfg, new_info = load_for_serving(
            ckpt, step=body.get("step"), config_path=args.config,
            device=device, **quant_kw)
        if new_cfg != cfg:
            raise ValueError(
                f"checkpoint {ckpt} carries a different model config — "
                f"a hot-swap cannot change architecture; restart the "
                f"server")
        return new_params, f"step-{new_info['step']}"

    quotas = None
    if args.quotas:
        from .scheduler import ClassQuota
        try:
            quotas = {cls: ClassQuota(**spec)
                      for cls, spec in json.loads(args.quotas).items()}
        except (json.JSONDecodeError, TypeError, ValueError) as e:
            print(f"gym_tpu_torch.serve: bad --quotas JSON: {e}",
                  file=sys.stderr)
            return 1

    stop = threading.Event()
    handle = create_server(
        params, cfg, host=args.host, port=args.port,
        num_slots=args.num_slots, decode_chunk=args.decode_chunk,
        max_queue=args.max_queue, request_timeout=args.request_timeout,
        default_deadline=args.default_deadline,
        dispatch_timeout=args.dispatch_timeout,
        max_restarts=args.max_restarts,
        metrics_dir=args.metrics_dir or os.path.join(args.ckpt, "serve"),
        info=info, stop_event=stop, page_size=args.page_size,
        kv_pages=args.kv_pages, spec_tokens=args.spec_tokens,
        replicas=args.replicas, failover_retries=args.failover_retries,
        reload_source=reload_source, warmup=not args.no_warmup,
        quotas=quotas, preempt=args.preempt, device=device)
    httpd, metrics, router = handle.httpd, handle.metrics, handle.router

    watcher = None
    if args.reload_watch > 0:

        def on_new_step(step):
            new_params, tag = reload_source({"step": step})
            res = router.reload(new_params, weights_tag=tag)
            # /stats "step" tracks the live weights — mutate the
            # handler's copy (create_server dict()s the info it is given)
            handle.info["step"] = step
            print(f"gym_tpu_torch.serve: checkpoint watcher — hot-swapped "
                  f"{tag} into replicas {res['swapped']} "
                  f"in {res['wall_s']}s", flush=True)

        watcher = CheckpointWatcher(
            args.ckpt, on_new_step, poll_s=args.reload_watch,
            initial_step=info["step"]).start()

    def graceful(signum):
        name = signal.Signals(signum).name
        print(f"gym_tpu_torch.serve: {name} — draining "
              f"(answer in-flight, fail queued)", flush=True)
        stop.set()
        if watcher is not None:
            watcher.stop()
        handle.stop_warmup()
        # per-replica drain: answer in-flight, fail queued typed; a
        # WEDGED replica gets its thread stacks dumped and its requests
        # failed typed without its engine ever being stepped from this
        # thread (single-driver contract) — Router.close does both
        if not router.close(drain_deadline_s=args.drain_deadline):
            print("gym_tpu_torch.serve: one or more replica drivers wedged "
                  "through the drain (stacks dumped above)",
                  file=sys.stderr, flush=True)
        httpd.shutdown()

    def _on_signal(signum, frame):
        # serve_forever blocks the main thread; drain from a helper so the
        # handler returns immediately (a second signal takes default
        # action — grace, not imprisonment)
        threading.Thread(target=graceful, args=(signum,),
                         daemon=True).start()
        signal.signal(signum, signal.SIG_DFL)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _on_signal)

    eng = handle.scheduler.engine
    kv = (f"paged kv: page {eng.page_size} x {eng.kv_pages} pages"
          + (f", spec {eng.spec_tokens}" if eng.spec_tokens else "")
          if eng.paged else "unpaged kv")
    if eng.weights_dtype != "f32" or eng.kv_dtype != "f32":
        kv += f", quant w={eng.weights_dtype} kv={eng.kv_dtype}"
    graphs = "cuda graphs" if eng.capture else "eager"
    print(f"gym_tpu_torch.serve: listening on http://{args.host}:"
          f"{handle.port} ({args.replicas} replica(s) x {args.num_slots} "
          f"slots, queue {args.max_queue}, {kv}, {graphs} on {device}, "
          f"watchdog {args.dispatch_timeout:.0f}s)", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if watcher is not None:
            watcher.stop()
        metrics.sync()
        head = metrics.headline()
        fleet = router.status()
        print(f"gym_tpu_torch.serve: shut down cleanly — "
              f"{head['requests_done']} done, "
              f"{head['requests_failed']} failed "
              f"({head['requests_shed']} shed, "
              f"{head['requests_quarantined']} quarantined), "
              f"{head['engine_restarts']} engine restart(s), "
              f"{fleet['failovers']} failover(s), "
              f"{fleet['weight_reloads']} weight reload(s), "
              f"tokens_per_s={head['tokens_per_s']}", flush=True)
        metrics.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
