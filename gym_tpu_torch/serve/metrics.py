"""Serving observability: ``serve.csv`` + aggregate headline (a copy of
``gym_tpu/serve/metrics.py`` but for its comments and
``_program_counters``, which reads the port's registry; pinned to it by
``tests/test_torch_serve_http.py``: the ``serve.csv`` columns are the
same, so ``read_headline`` reads either package's CSV).

CSVLogger-style (``utils/logger.py``): one append-only CSV under the
serve log dir, fsync on ``sync()``, atomic enough for a tail -f. Two row
kinds share the header:

- ``request`` — one row per completed/failed request: TTFT, new-token
  count, mean per-token latency, and the queue/slot state at completion.
  The ``status`` column types the outcome: ``done``, ``failed``,
  ``shed`` (deadline elapsed — queued shed or running cancelled),
  ``quarantined`` (NaN/Inf logits in the slot), ``rejected`` (admission
  control turned it away before it was ever enqueued).
- ``engine``  — a periodic engine sample (every ``engine_log_every``
  ticks of the driver loop): cumulative tokens, rolling tokens/s, queue
  depth, active-slot occupancy, plus the paged-KV/speculative
  observables ``kv_blocks_in_use`` / ``prefix_hit_blocks`` /
  ``spec_accept_rate`` (blank-or-zero on unpaged engines and absent in
  pre-paging CSVs). ``status=restart`` marks a supervisor engine
  rebuild; ``status=reload`` a rolling weight hot-swap.

Fleet serving (``serve/router.py``) shares ONE collector across N
replicas: each replica's scheduler and supervisor write through a
``replica_view(replica_id)`` facade, which stamps the new
``replica_id`` column (blank on single-engine CSVs; ``read_headline``
tolerates its absence, like the paging schema bump) and maintains a
PER-REPLICA tokens/s EWMA — the fleet's interleaved engine ticks would
otherwise difference two different engines' token counters and produce
garbage rates. Per-replica admission control reads its own replica's
EWMA; ``headline()`` reports the fleet aggregate plus a ``replicas``
section.

Fleet counters are per-ATTEMPT, not per-client-request: a transparently
failed-over request shows up as one ``failed`` attempt on the dead
replica plus one ``done`` attempt on the sibling (the client saw a
single 200). Alert on the router's ``retries_exhausted`` — the count of
engine-death failures that actually REACHED a client — and reconcile
``requests_failed`` against ``failovers``, both in ``/stats``.

Beyond the counters, the collector maintains a tokens/s EWMA over driver
ticks — the live service-rate estimate ``Scheduler.submit`` uses for
admission control — and p50/p95/p99 percentiles of TTFT and per-token
latency (tail latency is the serving observable; a mean hides a wedged
tail completely).

``headline()`` aggregates the run into the one-line JSON surface
``bench.py --serve-only`` / ``--chaos-only`` and the HTTP ``/stats``
endpoint report; ``read_headline(path)`` recomputes the same aggregate
from a ``serve.csv`` on disk (post-hoc analysis, tests on synthetic
files).
"""

from __future__ import annotations

import csv
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

HEADER = [
    "ts_s", "kind", "request_id", "status", "queue_depth", "active_slots",
    "prompt_tokens", "new_tokens", "ttft_s", "avg_token_latency_s",
    "cum_tokens", "tokens_per_s",
    # paged-KV / speculative observables (engine rows; blank on request
    # rows and absent in pre-paging CSVs — read_headline tolerates both)
    "kv_blocks_in_use", "prefix_hit_blocks", "spec_accept_rate",
    # fleet serving: which replica produced the row (blank on
    # single-engine collectors and absent in pre-fleet CSVs)
    "replica_id",
    # device-program registry counters (engine rows; absent in
    # pre-registry CSVs — read_headline tolerates both): cumulative
    # in-memory builds, builds that ran XLA (disk-tier hits excluded),
    # and wall seconds inside builds. A restart/reload row whose
    # programs_compiled matches the previous engine row is the
    # zero-recompile seam, on disk.
    "programs_built", "programs_compiled", "program_compile_s",
    # quantized serving (engine rows): the dtype the params
    # and KV pools are stored in — the config echo that makes a
    # serve.csv self-describing about WHAT was serving when its rates
    # were sampled. Absent in pre-quantization CSVs; read_headline
    # tolerates both (like the paging and fleet schema bumps).
    "weights_dtype", "kv_dtype",
    # out-of-process fleet: which OS process produced the
    # row's work — the server pid for in-process replicas, the worker
    # subprocess pid for process replicas. Absent in pre-fleet-process
    # CSVs; read_headline tolerates both (pinned, per repo convention).
    "pid",
    # serving simulator: request rows carry the wall-clock
    # offset (vs the collector's t0) at which the request was SUBMITTED
    # — durations alone cannot reconstruct an arrival process, and the
    # trace replayer (servesim/traces.py: replay_from_serve_csv) needs
    # exact arrivals. Absent in pre-servesim CSVs; read_headline
    # tolerates both.
    "t_submit",
    # autoscaler audit trail: ``kind=autoscale`` rows record
    # every controller tick — the snapshot it priced (healthy/starting
    # counts, backlog tokens; the rate rides the tokens_per_s column),
    # the decision (status: up/down/hold) and the REASON string — so
    # sim-vs-live validation and postmortems read decisions off disk
    # instead of reverse-engineering them from replica counts. Absent
    # in pre-servesim CSVs; read_headline tolerates both.
    "as_healthy", "as_starting", "as_backlog_tokens", "as_reason",
    # multi-tenant serving: who a request row belongs to and
    # which SLO class priced it. Request rows also gain two new status
    # values — ``preempted`` (a running low-priority request parked at a
    # chunk boundary to free its slot; an EVENT row, the request is
    # still live) and ``resumed`` (the parked request got a slot back).
    # Absent in pre-tenant CSVs; read_headline tolerates both (pinned,
    # per repo convention).
    "tenant", "slo_class",
]

#: EWMA smoothing for the live tokens/s estimate (per driver tick with
#: token progress). 0.2 ≈ a ~5-tick memory: reactive enough to track a
#: fault-induced slowdown, smooth enough not to flap admission control.
EWMA_ALPHA = 0.2

#: A fully idle engine (no active slots, empty queue, no token flow) for
#: this long resets the EWMA to None — cold again, admission turns
#: optimistic. Without this, a transient-slowdown rate measured before an
#: idle period would keep rejecting deadline'd requests forever: rejected
#: requests generate no tokens, so a stale-low EWMA could never refresh.
EWMA_IDLE_RESET_S = 10.0

#: Tail-latency sample window. Serving runs are unbounded; percentiles
#: over the last N requests keep memory flat and the numbers current.
PERCENTILE_WINDOW = 10_000

_PCTS = (50, 95, 99)


def _percentiles(samples, prefix: str) -> Dict[str, Optional[float]]:
    out: Dict[str, Optional[float]] = {}
    arr = np.asarray([s for s in samples if s is not None], np.float64)
    for p in _PCTS:
        out[f"{prefix}_p{p}_s"] = (
            round(float(np.percentile(arr, p)), 5) if arr.size else None)
    return out


#: request-failure exception class → serve.csv status value. Typed by
#: NAME so metrics stays import-decoupled from the scheduler.
_STATUS_BY_EXC = {
    "DeadlineExceededError": "shed",
    "SlotQuarantinedError": "quarantined",
    # client went away mid-stream (EPIPE on the chunked write): the
    # request was cancelled at the next decode-chunk boundary — a
    # client decision, recorded distinctly and NOT counted as a server
    # failure
    "RequestCancelledError": "disconnected",
}


def _program_counters() -> Optional[Dict[str, Any]]:
    """Live device-program-registry counters (``builds``, CUDA graphs
    captured, ``xla_compiles`` = the kernel library's ``nvcc`` builds in
    this process, plus its build-directory events), or None if the
    registry is unimportable — metrics must keep writing rows even if the
    programs package is broken."""
    try:
        from ..programs import default_registry, disk_event_counters
        return {**default_registry().counters(), **disk_event_counters()}
    except Exception:  # noqa: BLE001 — observability must not crash
        return None


class _RateState:
    """One engine's tokens/s EWMA state — per replica in a fleet (the
    interleaved ticks of two engines must never be differenced against
    each other) plus the legacy single-engine slot. Caller holds the
    collector's lock."""

    __slots__ = ("ewma", "last_tok", "last_t", "idle_since")

    def __init__(self):
        self.ewma: Optional[float] = None
        self.last_tok = 0
        self.last_t: Optional[float] = None
        self.idle_since: Optional[float] = None

    def update(self, tok: int, now: float, active_slots: int,
               queue_depth: int, idle_reset_s: float) -> None:
        if self.last_t is not None:
            d_tok = tok - self.last_tok
            d_t = now - self.last_t
            # d_tok < 0 = the engine was rebuilt/hot-swapped (counter
            # reset): re-anchor, keep the old EWMA — the rate estimate
            # survives a supervisor failover or a weight reload
            if d_tok > 0 and d_t > 0:
                inst = d_tok / d_t
                self.ewma = (inst if self.ewma is None else
                             EWMA_ALPHA * inst
                             + (1.0 - EWMA_ALPHA) * self.ewma)
                self.idle_since = None
            elif int(active_slots) == 0 and queue_depth == 0:
                # fully idle: after a while the old rate says nothing
                # about the next request — go cold (optimistic admit)
                # rather than reject on a stale-low estimate. A
                # BUSY-but-stalled engine keeps its honest low rate.
                if self.idle_since is None:
                    self.idle_since = now
                elif (now - self.idle_since >= idle_reset_s
                      and self.ewma is not None):
                    self.ewma = None
            else:
                self.idle_since = None
        self.last_tok, self.last_t = tok, now


class _ReplicaAgg:
    """Per-replica slice of the fleet counters (the ``replicas`` section
    of ``headline()``). Caller holds the collector's lock."""

    __slots__ = ("rate", "done", "failed", "shed", "quarantined",
                 "rejected", "disconnected", "restarts", "reloads",
                 "tokens_out", "kv_blocks_in_use", "prefix_hit_blocks",
                 "spec_accept_rate", "pid")

    def __init__(self):
        self.rate = _RateState()
        self.done = self.failed = self.shed = 0
        self.quarantined = self.rejected = 0
        self.disconnected = 0
        self.restarts = self.reloads = 0
        self.tokens_out = 0
        self.kv_blocks_in_use = 0
        self.prefix_hit_blocks = 0
        self.spec_accept_rate: Optional[float] = None
        self.pid: Optional[int] = None

    def headline(self) -> Dict[str, Any]:
        return {
            "requests_done": self.done,
            "requests_failed": self.failed,
            "requests_shed": self.shed,
            "requests_quarantined": self.quarantined,
            "requests_rejected": self.rejected,
            "requests_disconnected": self.disconnected,
            "engine_restarts": self.restarts,
            "engine_reloads": self.reloads,
            "tokens_out": self.tokens_out,
            "tokens_per_s_ewma": (round(self.rate.ewma, 2)
                                  if self.rate.ewma is not None else None),
            "kv_blocks_in_use": self.kv_blocks_in_use,
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "pid": self.pid,
        }


class _ClassAgg:
    """Per-SLO-class slice of the request counters + TTFT tail (the
    ``classes`` section of ``headline()``). Caller holds the
    collector's lock."""

    __slots__ = ("done", "shed", "rejected", "preempted", "resumed",
                 "ttfts")

    def __init__(self):
        self.done = self.shed = self.rejected = 0
        self.preempted = self.resumed = 0
        self.ttfts: deque = deque(maxlen=PERCENTILE_WINDOW)

    def headline(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "requests_done": self.done,
            "requests_shed": self.shed,
            "requests_rejected": self.rejected,
            "preemptions": self.preempted,
            "resumes": self.resumed,
        }
        out.update(_percentiles(self.ttfts, "ttft"))
        return out


class ReplicaMetrics:
    """Replica-scoped facade over a shared ``ServeMetrics``: the exact
    collector interface a ``Scheduler``/``Supervisor`` consumes, with
    the replica id stamped on every write and the EWMA read scoped to
    this replica (admission control must price a replica's OWN backlog
    against its OWN service rate)."""

    def __init__(self, base: "ServeMetrics", replica_id: int,
                 pid: Optional[int] = None):
        self.base = base
        self.replica_id = int(replica_id)
        # in-process replicas all live in the server process; the
        # process fleet stamps each worker's own pid
        self.pid = os.getpid() if pid is None else int(pid)

    def request_done(self, req, queue_depth: int,
                     active_slots: int) -> None:
        self.base.request_done(req, queue_depth, active_slots,
                               replica_id=self.replica_id, pid=self.pid)

    def request_rejected(self, queue_depth: int, active_slots: int,
                         tenant: Optional[str] = None,
                         slo_class: Optional[str] = None) -> None:
        self.base.request_rejected(queue_depth, active_slots,
                                   replica_id=self.replica_id,
                                   pid=self.pid, tenant=tenant,
                                   slo_class=slo_class)

    def request_preempted(self, req, queue_depth: int,
                          active_slots: int) -> None:
        self.base.request_preempted(req, queue_depth, active_slots,
                                    replica_id=self.replica_id,
                                    pid=self.pid)

    def request_resumed(self, req, queue_depth: int,
                        active_slots: int) -> None:
        self.base.request_resumed(req, queue_depth, active_slots,
                                  replica_id=self.replica_id,
                                  pid=self.pid)

    def engine_tick(self, stats, queue_depth: int) -> None:
        self.base.engine_tick(stats, queue_depth,
                              replica_id=self.replica_id, pid=self.pid)

    def engine_restarted(self) -> None:
        self.base.engine_restarted(replica_id=self.replica_id,
                                   pid=self.pid)

    def engine_reloaded(self) -> None:
        self.base.engine_reloaded(replica_id=self.replica_id,
                                  pid=self.pid)

    def tokens_per_s_ewma(self) -> Optional[float]:
        return self.base.tokens_per_s_ewma(replica_id=self.replica_id)

    def headline(self) -> Dict[str, Any]:
        return self.base.headline()

    def sync(self) -> None:
        self.base.sync()


class ServeMetrics:
    def __init__(self, out_dir: str, engine_log_every: int = 50,
                 ewma_idle_reset_s: float = EWMA_IDLE_RESET_S):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "serve.csv")
        # append, not "w": a server restart over the same run dir must
        # not destroy the previous run's request history — the header is
        # written only when the file is new/empty
        new_file = (not os.path.exists(self.path)
                    or os.path.getsize(self.path) == 0)
        self._f = open(self.path, "a", newline="")
        self._w = csv.writer(self._f)
        if new_file:
            self._w.writerow(HEADER)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._every = max(1, int(engine_log_every))
        self._ticks = 0
        self.requests_done = 0
        self.requests_failed = 0
        self.requests_shed = 0
        self.requests_quarantined = 0
        self.requests_rejected = 0
        self.requests_disconnected = 0
        # multi-tenant serving: preempt/resume are EVENTS on
        # live requests, not completions — their own counters, never
        # inflating requests_done/failed
        self.requests_preempted = 0
        self.requests_resumed = 0
        self._classes: Dict[str, _ClassAgg] = {}
        self.engine_restarts = 0
        self.engine_reloads = 0
        # out-of-process fleet counters: process-replica
        # lifecycle (autoscaler spawns/retires + kill-respawns) and the
        # live count of token streams currently being written to
        # clients (the HTTP layer gates it around each SSE response)
        self.replicas_spawned = 0
        self.replicas_retired = 0
        self.streams_active = 0
        # autoscaler audit trail: controller-tick counters
        # next to the per-tick CSV rows
        self.autoscale_ticks = 0
        self.autoscale_ups = 0
        self.autoscale_downs = 0
        self.tokens_out = 0
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self._lat_sum = 0.0
        self._lat_n = 0
        self._ttfts: deque = deque(maxlen=PERCENTILE_WINDOW)
        self._lats: deque = deque(maxlen=PERCENTILE_WINDOW)
        self._rate = _RateState()       # legacy single-engine EWMA slot
        self._replicas: Dict[int, _ReplicaAgg] = {}
        self._ewma_idle_reset_s = float(ewma_idle_reset_s)
        # last engine sample of the paged/speculative observables (an
        # unpaged engine reports 0 blocks and a None accept rate)
        self._kv_blocks_in_use = 0
        self._prefix_hit_blocks = 0
        self._spec_accept_rate: Optional[float] = None
        # last engine sample of the quantized-serving config echo (None
        # until the first tick; fleet replicas share one config, so a
        # collector-level last-wins sample is exact)
        self._weights_dtype: Optional[str] = None
        self._kv_dtype: Optional[str] = None

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def replica_view(self, replica_id: int,
                     pid: Optional[int] = None) -> ReplicaMetrics:
        """Replica-scoped facade for one fleet member's scheduler and
        supervisor (see ``ReplicaMetrics``)."""
        with self._lock:
            agg = self._replicas.setdefault(int(replica_id),
                                            _ReplicaAgg())
            agg.pid = os.getpid() if pid is None else int(pid)
        return ReplicaMetrics(self, replica_id, pid=pid)

    # -- process-fleet lifecycle ------------------------------------------

    def replica_spawned(self, replica_id: Optional[int] = None,
                        pid: Optional[int] = None) -> None:
        """A replica worker process was spawned (fleet startup,
        autoscaler scale-up, or a respawn after a kill)."""
        with self._lock:
            self.replicas_spawned += 1
            rep = self._rep(replica_id)
            if rep is not None and pid is not None:
                rep.pid = int(pid)

    def replica_retired(self, replica_id: Optional[int] = None,
                        pid: Optional[int] = None) -> None:
        """A replica worker process was drained and stopped
        (autoscaler scale-down)."""
        with self._lock:
            self.replicas_retired += 1

    def stream_started(self) -> None:
        with self._lock:
            self.streams_active += 1

    def stream_ended(self) -> None:
        with self._lock:
            self.streams_active = max(0, self.streams_active - 1)

    def _rep(self, replica_id: Optional[int]) -> Optional[_ReplicaAgg]:
        if replica_id is None:
            return None
        return self._replicas.setdefault(int(replica_id), _ReplicaAgg())

    def _cls(self, slo_class: Optional[str]) -> Optional[_ClassAgg]:
        if not slo_class:
            return None
        return self._classes.setdefault(str(slo_class), _ClassAgg())

    @staticmethod
    def _tenant_cells(req) -> List[Any]:
        """The two tenant columns for a request-row write — blank on
        pre-tenant Request objects (duck-typed: metrics stays
        import-decoupled from the scheduler)."""
        return [str(getattr(req, "tenant", "") or ""),
                str(getattr(req, "slo_class", "") or "")]

    @staticmethod
    def _rid_cell(replica_id: Optional[int]):
        return "" if replica_id is None else int(replica_id)

    @staticmethod
    def _pid_cell(pid: Optional[int]):
        return "" if pid is None else int(pid)

    @staticmethod
    def _program_cells() -> List[Any]:
        """The device-program registry's cumulative build/compile
        counters, as engine-row CSV cells (the serve.csv face of
        ``programs.compile_counter()``)."""
        c = _program_counters()
        if c is None:
            return ["", "", ""]
        return [c["builds"], c["xla_compiles"],
                f"{c['compile_seconds']:.3f}"]

    def request_done(self, req, queue_depth: int, active_slots: int,
                     replica_id: Optional[int] = None,
                     pid: Optional[int] = None) -> None:
        with self._lock:
            if self._f.closed:        # straggler after close(): drop it
                return
            failed = req.error is not None
            status = "done"
            if failed:
                status = _STATUS_BY_EXC.get(
                    type(req.exception).__name__, "failed")
            # a disconnect is the CLIENT's decision: its own counter,
            # never inflating requests_failed (the server did nothing
            # wrong — ci alerts stay meaningful under churny clients)
            disconnected = status == "disconnected"
            self.requests_failed += int(failed and not disconnected)
            self.requests_done += int(not failed)
            self.requests_shed += int(status == "shed")
            self.requests_quarantined += int(status == "quarantined")
            self.requests_disconnected += int(disconnected)
            self.tokens_out += len(req.tokens)
            rep = self._rep(replica_id)
            if rep is not None:
                rep.failed += int(failed and not disconnected)
                rep.done += int(not failed)
                rep.shed += int(status == "shed")
                rep.quarantined += int(status == "quarantined")
                rep.disconnected += int(disconnected)
                rep.tokens_out += len(req.tokens)
            ttft = req.ttft_s
            lat = req.avg_token_latency_s
            if ttft is not None:
                self._ttft_sum += ttft
                self._ttft_n += 1
                self._ttfts.append(ttft)
            if lat is not None:
                self._lat_sum += lat
                self._lat_n += 1
                self._lats.append(lat)
            tenant_cells = self._tenant_cells(req)
            agg = self._cls(tenant_cells[1])
            if agg is not None:
                agg.done += int(not failed)
                agg.shed += int(status == "shed")
                if ttft is not None:
                    agg.ttfts.append(ttft)
            # submit offset in the collector's clock: the arrival
            # process, reconstructible from disk
            t_sub = getattr(req, "submit_t", None)
            t_sub_cell = ("" if not t_sub
                          else f"{t_sub - self._t0:.4f}")
            self._w.writerow([
                f"{self._now():.4f}", "request", req.id, status,
                queue_depth, active_slots,
                int(req.prompt.size), len(req.tokens),
                "" if ttft is None else f"{ttft:.5f}",
                "" if lat is None else f"{lat:.5f}",
                self.tokens_out, f"{self.tokens_per_s():.2f}",
                "", "", "", self._rid_cell(replica_id), "", "", "",
                "", "", self._pid_cell(pid),
                t_sub_cell, "", "", "", "", *tenant_cells,
            ])
            self._f.flush()

    def request_rejected(self, queue_depth: int, active_slots: int,
                         replica_id: Optional[int] = None,
                         pid: Optional[int] = None,
                         tenant: Optional[str] = None,
                         slo_class: Optional[str] = None) -> None:
        """Admission control shed a request before it was enqueued (no
        Request object ever existed — the whole point). ``tenant`` /
        ``slo_class`` type WHO was turned away (quota rejects are the
        per-class observable; blank on pre-tenant callers)."""
        with self._lock:
            if self._f.closed:
                return
            self.requests_rejected += 1
            rep = self._rep(replica_id)
            if rep is not None:
                rep.rejected += 1
            agg = self._cls(slo_class)
            if agg is not None:
                agg.rejected += 1
            now = self._now()
            self._w.writerow([
                f"{now:.4f}", "request", "", "rejected",
                queue_depth, active_slots, "", "", "", "",
                self.tokens_out, f"{self.tokens_per_s():.2f}",
                "", "", "", self._rid_cell(replica_id), "", "", "",
                "", "", self._pid_cell(pid),
                # an admission reject happens AT submit: arrival == now
                f"{now:.4f}", "", "", "", "",
                str(tenant or ""), str(slo_class or ""),
            ])
            self._f.flush()

    def _request_event(self, req, status: str, queue_depth: int,
                       active_slots: int, replica_id: Optional[int],
                       pid: Optional[int]) -> None:
        """A lifecycle EVENT row on a still-live request
        (``preempted`` / ``resumed``). new_tokens stays blank — the
        request's tokens are counted once, on its completion row."""
        tenant_cells = self._tenant_cells(req)
        self._w.writerow([
            f"{self._now():.4f}", "request", req.id, status,
            queue_depth, active_slots, int(req.prompt.size), "",
            "", "", self.tokens_out, f"{self.tokens_per_s():.2f}",
            "", "", "", self._rid_cell(replica_id), "", "", "",
            "", "", self._pid_cell(pid), "", "", "", "", "",
            *tenant_cells,
        ])
        self._f.flush()

    def request_preempted(self, req, queue_depth: int,
                          active_slots: int,
                          replica_id: Optional[int] = None,
                          pid: Optional[int] = None) -> None:
        """A running low-priority request was parked at a chunk boundary
        to free its slot for more urgent work. The request is
        still live: its stream pauses and later resumes byte-identical,
        so this is an event counter, never a failure."""
        with self._lock:
            if self._f.closed:
                return
            self.requests_preempted += 1
            agg = self._cls(getattr(req, "slo_class", None))
            if agg is not None:
                agg.preempted += 1
            self._request_event(req, "preempted", queue_depth,
                                active_slots, replica_id, pid)

    def request_resumed(self, req, queue_depth: int, active_slots: int,
                        replica_id: Optional[int] = None,
                        pid: Optional[int] = None) -> None:
        """A parked (preempted) request got a slot back and its stream
        continues from the parked cursor."""
        with self._lock:
            if self._f.closed:
                return
            self.requests_resumed += 1
            agg = self._cls(getattr(req, "slo_class", None))
            if agg is not None:
                agg.resumed += 1
            self._request_event(req, "resumed", queue_depth,
                                active_slots, replica_id, pid)

    def engine_restarted(self, replica_id: Optional[int] = None,
                         pid: Optional[int] = None) -> None:
        """A supervisor failover rebuilt the engine."""
        with self._lock:
            if self._f.closed:
                return
            self.engine_restarts += 1
            rep = self._rep(replica_id)
            if rep is not None:
                rep.restarts += 1
            self._w.writerow([
                f"{self._now():.4f}", "engine", "", "restart", "", "",
                "", "", "", "", self.tokens_out,
                f"{self.tokens_per_s():.2f}", "", "", "",
                self._rid_cell(replica_id), *self._program_cells(),
                self._weights_dtype or "", self._kv_dtype or "",
                self._pid_cell(pid), "", "", "", "", "", "", "",
            ])
            self._f.flush()

    def engine_reloaded(self, replica_id: Optional[int] = None,
                        pid: Optional[int] = None) -> None:
        """A rolling weight hot-swap replaced this engine's params (the
        router drained the replica first — no restart, no failures)."""
        with self._lock:
            if self._f.closed:
                return
            self.engine_reloads += 1
            rep = self._rep(replica_id)
            if rep is not None:
                rep.reloads += 1
            self._w.writerow([
                f"{self._now():.4f}", "engine", "", "reload", "", "",
                "", "", "", "", self.tokens_out,
                f"{self.tokens_per_s():.2f}", "", "", "",
                self._rid_cell(replica_id), *self._program_cells(),
                self._weights_dtype or "", self._kv_dtype or "",
                self._pid_cell(pid), "", "", "", "", "", "", "",
            ])
            self._f.flush()

    def autoscale_tick(self, healthy: int, starting: int,
                       backlog_tokens: float,
                       tokens_per_s: Optional[float], decision: int,
                       reason: str) -> None:
        """Autoscaler audit trail: one ``kind=autoscale`` row
        per controller tick — the exact snapshot the decision priced
        plus the decision and its reason. ``status`` types the decision
        (``up``/``down``/``hold``); the snapshot's aggregate rate rides
        the ``tokens_per_s`` column. Sim-vs-live validation replays
        these against the cost model's modeled ticks; postmortems stop
        reverse-engineering decisions from replica counts."""
        with self._lock:
            if self._f.closed:
                return
            self.autoscale_ticks += 1
            self.autoscale_ups += int(decision > 0)
            self.autoscale_downs += int(decision < 0)
            status = ("up" if decision > 0
                      else "down" if decision < 0 else "hold")
            self._w.writerow([
                f"{self._now():.4f}", "autoscale", "", status, "", "",
                "", "", "", "", self.tokens_out,
                ("" if tokens_per_s is None
                 else f"{tokens_per_s:.2f}"),
                "", "", "", "", "", "", "", "", "", "",
                "", int(healthy), int(starting),
                f"{float(backlog_tokens):.1f}", str(reason), "", "",
            ])
            self._f.flush()

    def engine_tick(self, stats, queue_depth: int,
                    replica_id: Optional[int] = None,
                    pid: Optional[int] = None) -> None:
        """Per-driver-round sample. ALWAYS updates the tokens/s EWMA
        (admission control reads it live); writes a CSV row only every
        ``engine_log_every``-th call so an idle server doesn't grow the
        CSV unboundedly."""
        with self._lock:
            if self._f.closed:
                # a straggler driver thread may tick after close() — the
                # sample is worthless, the crash would not be
                return
            now = self._now()
            tok = int(stats.tokens_generated)
            rep = self._rep(replica_id)
            rate = self._rate if rep is None else rep.rate
            rate.update(tok, now, int(stats.active_slots), queue_depth,
                        self._ewma_idle_reset_s)
            kv = int(getattr(stats, "kv_blocks_in_use", 0))
            ph = int(getattr(stats, "prefix_hit_blocks", 0))
            rate_fn = getattr(stats, "spec_accept_rate", None)
            sr = rate_fn() if callable(rate_fn) else None
            wd = getattr(stats, "weights_dtype", None)
            kd = getattr(stats, "kv_dtype", None)
            if wd:
                self._weights_dtype = str(wd)
            if kd:
                self._kv_dtype = str(kd)
            if rep is None:
                self._kv_blocks_in_use = kv
                self._prefix_hit_blocks = ph
                self._spec_accept_rate = sr
            else:
                rep.kv_blocks_in_use = kv
                rep.prefix_hit_blocks = ph
                rep.spec_accept_rate = sr
            self._ticks += 1
            if self._ticks % self._every:
                return
            self._w.writerow([
                f"{now:.4f}", "engine", "", "", queue_depth,
                stats.active_slots, "", "", "", "",
                stats.tokens_generated, f"{self.tokens_per_s():.2f}",
                kv, ph, ("" if sr is None else f"{sr:.4f}"),
                self._rid_cell(replica_id), *self._program_cells(),
                self._weights_dtype or "", self._kv_dtype or "",
                self._pid_cell(pid), "", "", "", "", "", "", "",
            ])

    def tokens_per_s(self) -> float:
        dt = self._now()
        return self.tokens_out / dt if dt > 0 else 0.0

    def tokens_per_s_ewma(self, replica_id: Optional[int] = None
                          ) -> Optional[float]:
        """Live service-rate estimate (None until the first productive
        tick) — the admission-control input. ``replica_id`` scopes the
        read to one fleet member; without it, a fleet collector reports
        the AGGREGATE rate (sum of live per-replica EWMAs) and a
        single-engine collector its own."""
        with self._lock:
            if replica_id is not None:
                rep = self._replicas.get(int(replica_id))
                return rep.rate.ewma if rep is not None else None
            if self._replicas:
                live = [r.rate.ewma for r in self._replicas.values()
                        if r.rate.ewma is not None]
                return sum(live) if live else None
            return self._rate.ewma

    def headline(self) -> Dict[str, Any]:
        with self._lock:
            if self._replicas:
                # fleet aggregates: per-replica samples summed; rates
                # summed over live EWMAs; spec rate averaged over
                # replicas that have one
                ewmas = [r.rate.ewma for r in self._replicas.values()
                         if r.rate.ewma is not None]
                ewma = sum(ewmas) if ewmas else None
                kv = sum(r.kv_blocks_in_use
                         for r in self._replicas.values())
                ph = sum(r.prefix_hit_blocks
                         for r in self._replicas.values())
                srs = [r.spec_accept_rate
                       for r in self._replicas.values()
                       if r.spec_accept_rate is not None]
                sr = sum(srs) / len(srs) if srs else None
            else:
                ewma = self._rate.ewma
                kv = self._kv_blocks_in_use
                ph = self._prefix_hit_blocks
                sr = self._spec_accept_rate
            head = {
                "requests_done": self.requests_done,
                "requests_failed": self.requests_failed,
                "requests_shed": self.requests_shed,
                "requests_quarantined": self.requests_quarantined,
                "requests_rejected": self.requests_rejected,
                "requests_disconnected": self.requests_disconnected,
                "requests_preempted": self.requests_preempted,
                "requests_resumed": self.requests_resumed,
                "engine_restarts": self.engine_restarts,
                "engine_reloads": self.engine_reloads,
                "replicas_spawned": self.replicas_spawned,
                "replicas_retired": self.replicas_retired,
                "streams_active": self.streams_active,
                "tokens_out": self.tokens_out,
                "wall_s": round(self._now(), 3),
                "tokens_per_s": round(self.tokens_per_s(), 2),
                "tokens_per_s_ewma": (round(ewma, 2)
                                      if ewma is not None else None),
                "mean_ttft_s": (round(self._ttft_sum / self._ttft_n, 5)
                                if self._ttft_n else None),
                "mean_token_latency_s": (
                    round(self._lat_sum / self._lat_n, 5)
                    if self._lat_n else None),
                "kv_blocks_in_use": kv,
                "prefix_hit_blocks": ph,
                "spec_accept_rate": (
                    round(sr, 4) if sr is not None else None),
                "weights_dtype": self._weights_dtype,
                "kv_dtype": self._kv_dtype,
            }
            if self.autoscale_ticks:
                head["autoscale"] = {
                    "ticks": self.autoscale_ticks,
                    "ups": self.autoscale_ups,
                    "downs": self.autoscale_downs,
                }
            progs = _program_counters()
            if progs is not None:
                # the device-program registry's live counters (hits /
                # builds / xla_compiles / disk_hits / compile_seconds +
                # persistent-cache event totals) — /stats spreads the
                # headline, so this is the wire observable the restart
                # drill and the zero-recompile seams read
                head["programs"] = progs
            if self._replicas:
                head["replicas"] = {
                    str(rid): rep.headline()
                    for rid, rep in sorted(self._replicas.items())}
            if self._classes:
                # per-SLO-class tails + shed/preempt counters: the
                # isolation observable — a noisy neighbor
                # shows up as ITS class's rejects/preempts while the
                # victim class's ttft_p99_s stays put
                head["classes"] = {
                    cls: agg.headline()
                    for cls, agg in sorted(self._classes.items())}
            head.update(_percentiles(self._ttfts, "ttft"))
            head.update(_percentiles(self._lats, "token_lat"))
            return head

    def sync(self) -> None:
        # fsync OUTSIDE the lock (lint GT102, the concurrency
        # audit's one genuine finding): this lock serializes the HTTP
        # handlers' admission-control reads (tokens_per_s_ewma) and the
        # driver's request_done — holding it across a disk-durability
        # call let one NFS stall wedge the whole serving plane. flush
        # stays inside (the csv writer's buffer is lock-protected);
        # fsync of an fd is safe concurrent with further writes, it may
        # only persist MORE than this call's rows.
        with self._lock:
            if self._f.closed:
                return    # straggler sync after close: drop, like the
                #           row writers' closed-file guards
            self._f.flush()
            # dup the fd under the lock: a concurrent close() cannot
            # invalidate (or let the OS reuse) OUR descriptor mid-fsync
            fd = os.dup(self._f.fileno())
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def close(self) -> None:
        with self._lock:
            self._f.flush()
            self._f.close()


def read_headline(path: str) -> Dict[str, Any]:
    """Recompute the aggregate headline from a ``serve.csv`` on disk —
    the same counters and percentiles ``ServeMetrics.headline`` reports
    live, derived post-hoc from the request rows (so a finished run, a
    synthetic fixture, or another process's CSV all aggregate the same
    way). Engine rows contribute ``engine_restarts`` and
    ``engine_reloads``. Fleet CSVs (rows carrying the ``replica_id``
    column) additionally aggregate a per-replica ``replicas`` section;
    pre-fleet CSVs (no such column, like pre-paging CSVs lack the KV
    columns) produce the same fleet-free headline they always did."""
    counts = {"done": 0, "failed": 0, "shed": 0, "quarantined": 0,
              "rejected": 0, "disconnected": 0,
              # tenant event rows (absent in pre-tenant CSVs)
              "preempted": 0, "resumed": 0}
    per_cls: Dict[str, Dict[str, Any]] = {}

    def cls_of(row):
        slo = row.get("slo_class")
        if not slo:
            return None
        return per_cls.setdefault(str(slo), {
            "requests_done": 0, "requests_shed": 0,
            "requests_rejected": 0, "preemptions": 0, "resumes": 0,
            "_ttfts": []})
    restarts = reloads = 0
    tokens_out = 0
    last_ts = 0.0
    ttfts: List[float] = []
    lats: List[float] = []
    kv_blocks, prefix_hits, spec_rate = 0, 0, None
    weights_dtype: Optional[str] = None
    kv_dtype: Optional[str] = None
    programs: Optional[Dict[str, Any]] = None
    per_rep: Dict[str, Dict[str, int]] = {}
    as_ticks = as_ups = as_downs = 0

    def rep_of(row):
        rid = row.get("replica_id")
        if rid is None or rid == "":
            return None
        return per_rep.setdefault(str(int(rid)), {
            "requests_done": 0, "requests_failed": 0,
            "engine_restarts": 0, "engine_reloads": 0, "tokens_out": 0})

    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            last_ts = max(last_ts, float(row["ts_s"] or 0.0))
            if row["kind"] == "engine":
                restarts += int(row["status"] == "restart")
                reloads += int(row["status"] == "reload")
                rep = rep_of(row)
                if rep is not None:
                    rep["engine_restarts"] += int(
                        row["status"] == "restart")
                    rep["engine_reloads"] += int(
                        row["status"] == "reload")
                # paged/spec observables: last engine sample wins (the
                # columns are absent in pre-paging CSVs)
                if row.get("kv_blocks_in_use"):
                    kv_blocks = int(row["kv_blocks_in_use"])
                if row.get("prefix_hit_blocks"):
                    prefix_hits = int(row["prefix_hit_blocks"])
                if row.get("spec_accept_rate"):
                    spec_rate = float(row["spec_accept_rate"])
                # quantized-serving config echo: last engine sample wins
                # (columns absent in pre-quantization CSVs)
                if row.get("weights_dtype"):
                    weights_dtype = row["weights_dtype"]
                if row.get("kv_dtype"):
                    kv_dtype = row["kv_dtype"]
                # registry counters: last engine sample wins (columns
                # absent in pre-registry CSVs)
                if row.get("programs_built"):
                    programs = {
                        "builds": int(row["programs_built"]),
                        "xla_compiles": int(row["programs_compiled"]),
                        "compile_seconds": float(
                            row["program_compile_s"] or 0.0),
                    }
                continue
            if row["kind"] == "autoscale":
                # autoscaler audit rows (absent in
                # pre-servesim CSVs — this branch simply never fires)
                as_ticks += 1
                as_ups += int(row["status"] == "up")
                as_downs += int(row["status"] == "down")
                continue
            if row["kind"] != "request":
                continue
            status = row["status"]
            if status in counts:
                counts[status] += 1
            tokens_out += int(row["new_tokens"] or 0)
            rep = rep_of(row)
            if rep is not None:
                rep["requests_done"] += int(status == "done")
                rep["requests_failed"] += int(
                    status in ("failed", "shed", "quarantined"))
                rep["tokens_out"] += int(row["new_tokens"] or 0)
            cls = cls_of(row)
            if cls is not None:
                cls["requests_done"] += int(status == "done")
                cls["requests_shed"] += int(status == "shed")
                cls["requests_rejected"] += int(status == "rejected")
                cls["preemptions"] += int(status == "preempted")
                cls["resumes"] += int(status == "resumed")
                if status not in ("preempted", "resumed") \
                        and row["ttft_s"]:
                    cls["_ttfts"].append(float(row["ttft_s"]))
            if status in ("preempted", "resumed"):
                continue       # event rows: no latency samples
            if row["ttft_s"]:
                ttfts.append(float(row["ttft_s"]))
            if row["avg_token_latency_s"]:
                lats.append(float(row["avg_token_latency_s"]))
    failed = (counts["failed"] + counts["shed"] + counts["quarantined"])
    head: Dict[str, Any] = {
        "requests_done": counts["done"],
        "requests_failed": failed,
        "requests_shed": counts["shed"],
        "requests_quarantined": counts["quarantined"],
        "requests_rejected": counts["rejected"],
        "requests_disconnected": counts["disconnected"],
        "requests_preempted": counts["preempted"],
        "requests_resumed": counts["resumed"],
        "engine_restarts": restarts,
        "engine_reloads": reloads,
        "tokens_out": tokens_out,
        "wall_s": round(last_ts, 3),
        "tokens_per_s": round(tokens_out / last_ts, 2) if last_ts else 0.0,
        "mean_ttft_s": (round(sum(ttfts) / len(ttfts), 5)
                        if ttfts else None),
        "mean_token_latency_s": (round(sum(lats) / len(lats), 5)
                                 if lats else None),
        "kv_blocks_in_use": kv_blocks,
        "prefix_hit_blocks": prefix_hits,
        "spec_accept_rate": spec_rate,
        "weights_dtype": weights_dtype,
        "kv_dtype": kv_dtype,
    }
    if programs is not None:
        head["programs"] = programs
    if as_ticks:
        head["autoscale"] = {"ticks": as_ticks, "ups": as_ups,
                             "downs": as_downs}
    if per_rep:
        head["replicas"] = dict(sorted(per_rep.items()))
    if per_cls:
        classes: Dict[str, Any] = {}
        for slo, agg in sorted(per_cls.items()):
            samples = agg.pop("_ttfts")
            agg.update(_percentiles(samples, "ttft"))
            classes[slo] = agg
        head["classes"] = classes
    head.update(_percentiles(ttfts, "ttft"))
    head.update(_percentiles(lats, "token_lat"))
    return head
