"""FCFS request scheduler over the slot engine.

The engine (``engine.py``) knows slots; this layer knows REQUESTS:

- ``submit``: thread-safe, backpressure-bounded — when the FCFS queue is
  full it blocks up to ``timeout`` for a drain (or raises
  ``QueueFullError`` immediately with ``block=False``). Requests that
  can never fit the KV cache are rejected at submit time with the same
  typed ``ValueError`` ``generate_fast`` raises. Requests that carry a
  ``deadline_s`` the engine provably cannot meet — estimated from the
  live tokens/s EWMA and the current backlog — are rejected typed
  (``AdmissionRejectedError``, with a ``retry_after_s`` hint) instead of
  being enqueued to time out: admission control / load shedding.
- ``step``: one scheduling round, run by the single driver thread:
  shed queued requests past their deadline (before prefill), admit
  queued requests into free slots (prefill; PREFIX-AWARE within a
  bounded lookahead window — a request whose prompt prefix is resident
  in the paged engine's prefix cache is admitted ahead of its FCFS turn
  so shared-prefix bursts hit the cache before eviction churn loses
  them), advance every active slot one token (the shared decode step),
  and complete/evict finished requests BETWEEN steps — continuous
  batching. Running requests past
  their deadline are cancelled at the chunk boundary and their slot
  freed; a slot the engine quarantined (NaN/Inf logits) fails only its
  own request.
- ``Request``: the poll/wait surface — status, accumulated tokens, and a
  ``result(timeout)`` future; per-request TTFT/latency stamps feed
  ``metrics.ServeMetrics``. Failures carry their TYPED exception
  (``Request.exception``), which ``result`` re-raises — callers branch
  on class, not on string matching.

Engine failover (``supervisor.Supervisor``) uses two hooks:
``fail_inflight`` (fail every running request typed, bump the scheduler
EPOCH) and ``replace_engine``. The epoch makes failover safe against a
WEDGED driver thread: a stale ``step`` that finally wakes from a hung
dispatch finds the epoch advanced and discards its admissions and
events instead of corrupting the rebuilt engine's slot bookkeeping.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from ..utils.resilience import fault_point
from .engine import InferenceEngine, NoFreeBlocksError, SamplingParams


class QueueFullError(RuntimeError):
    """Backpressure signal: the FCFS queue is at capacity and the caller
    declined (or timed out) waiting for it to drain."""


class SchedulerClosedError(RuntimeError):
    """Typed "scheduler is shutting down": raised by ``submit`` after
    ``shutdown()`` and stored on requests failed by the drain. Subclasses
    ``RuntimeError`` so pre-existing callers that caught the bare
    ``RuntimeError`` keep working."""


class DeadlineExceededError(RuntimeError):
    """The request's ``deadline_s`` elapsed: shed from the queue before
    prefill, or cancelled at a decode-chunk boundary while running."""


class AdmissionRejectedError(RuntimeError):
    """Load shedding at ``submit``: the live tokens/s EWMA says this
    request cannot finish inside its ``deadline_s``, so it is rejected
    up front instead of queued to die. ``retry_after_s`` estimates when
    the current backlog will have drained."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class QuotaExceededError(AdmissionRejectedError):
    """Per-class token-rate quota exhausted at ``submit``: the request's
    ``slo_class`` refill bucket cannot cover its committed tokens right
    now. Subclasses ``AdmissionRejectedError`` so every existing
    429 + ``Retry-After`` surface — the HTTP handler, the router's
    cheapest-reject ladder, the wire frames — applies unchanged."""


class EngineFailedError(RuntimeError):
    """The engine crashed or wedged under this request: its in-flight
    generation cannot be recovered (the KV cache died with the engine).
    The supervisor rebuilds the engine; RETRYING the request is safe."""


class SlotQuarantinedError(RuntimeError):
    """The engine detected non-finite (NaN/Inf) logits in this request's
    slot and quarantined it — only this request fails; neighbor slots
    are row-isolated by the model's per-row cache math."""


class RequestFailedError(RuntimeError):
    """Fallback for a request failed with only a string reason (no typed
    exception was stored) — ``Request.result`` re-raises the stored
    TYPED exception whenever one exists."""


class RequestCancelledError(RuntimeError):
    """The request was cancelled by its caller — in practice: the HTTP
    client disconnected mid-stream. The generation stops at the next
    decode-chunk boundary and the slot is freed; ``serve.csv`` records
    ``status=disconnected`` (not a failure, not a traceback)."""


#: Known SLO classes in priority order (most urgent first). Requests
#: that name an unknown class are rejected at submit with a typed
#: ValueError (HTTP 400) — a typo'd class silently mapping to a default
#: priority would be an isolation hole.
SLO_CLASSES = ("interactive", "standard", "batch")
DEFAULT_SLO_CLASS = "standard"
DEFAULT_TENANT = "default"
#: Admission priority (lower = more urgent). Preemption only ever runs
#: in favor of a STRICTLY more urgent class, so same-class traffic can
#: never thrash slots back and forth.
CLASS_PRIORITY = {"interactive": 0, "standard": 1, "batch": 2}
#: Weighted-fair-queuing weights: a tenant's virtual finish time
#: advances at cost/weight, so at equal sustained demand an interactive
#: tenant receives 8x a batch tenant's token share.
CLASS_WEIGHT = {"interactive": 8.0, "standard": 4.0, "batch": 1.0}


@dataclasses.dataclass(frozen=True)
class ClassQuota:
    """Refill-bucket token quota for one SLO class. Exactly one of
    ``tokens_per_s`` (absolute refill rate) or ``share`` (fraction of
    the live ``tokens_per_s_ewma`` — the bucket refills at a slice of
    whatever the engine is actually delivering) must be set.
    ``burst_s`` sizes the bucket: a class may burst up to ``burst_s``
    seconds of its refill rate before the rate limit bites."""

    tokens_per_s: Optional[float] = None
    share: Optional[float] = None
    burst_s: float = 2.0

    def __post_init__(self):
        if (self.tokens_per_s is None) == (self.share is None):
            raise ValueError(
                "ClassQuota: set exactly one of tokens_per_s / share")
        if self.tokens_per_s is not None and not self.tokens_per_s > 0:
            raise ValueError(
                f"tokens_per_s must be > 0, got {self.tokens_per_s}")
        if self.share is not None and not 0 < self.share <= 1:
            raise ValueError(
                f"share must be in (0, 1], got {self.share}")
        if not self.burst_s > 0:
            raise ValueError(f"burst_s must be > 0, got {self.burst_s}")


class _TokenBucket:
    """Lazy-refill token bucket with an injectable clock (tests pin
    refill determinism by stepping a fake clock; production uses
    ``time.monotonic``). Called under the scheduler lock — no locking
    of its own."""

    def __init__(self, quota: ClassQuota, clock=time.monotonic):
        self.quota = quota
        self._clock = clock
        self._level: Optional[float] = None   # None = start full
        self._last = 0.0

    def _rate(self, ewma: Optional[float]) -> Optional[float]:
        """Resolve the refill rate in tokens/s; None = unenforceable
        right now (share-based quota on a cold engine with no EWMA —
        optimistic, the same stance the deadline admission takes)."""
        if self.quota.tokens_per_s is not None:
            return float(self.quota.tokens_per_s)
        if ewma is None or ewma <= 0:
            return None
        return float(self.quota.share) * float(ewma)

    def _refill(self, rate: float) -> float:
        cap = rate * self.quota.burst_s
        now = self._clock()
        if self._level is None:
            self._level = cap
        else:
            self._level = min(cap, self._level
                              + (now - self._last) * rate)
        self._last = now
        return cap

    def try_take(self, n: int,
                 ewma: Optional[float]) -> Tuple[bool, float]:
        """``(admitted, retry_after_s)``. A request larger than the
        whole bucket is admitted whenever the bucket is FULL (its level
        goes negative, which enforces the long-run rate) — otherwise a
        single big request could never pass and would starve forever
        instead of being rate-limited."""
        rate = self._rate(ewma)
        if rate is None:
            return True, 0.0
        cap = self._refill(rate)
        need = float(n)
        if self._level >= min(need, cap):
            self._level -= need
            return True, 0.0
        return False, max(0.05, (min(need, cap) - self._level) / rate)

    def fill_fraction(self, ewma: Optional[float]) -> Optional[float]:
        """Live bucket fill in [0, 1] for ``/stats`` (None when the
        rate is unresolvable). Refills as a side effect — harmless: the
        level is a function of elapsed time either way."""
        rate = self._rate(ewma)
        if rate is None:
            return None
        cap = self._refill(rate)
        return max(0.0, min(1.0, self._level / cap)) if cap else None


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class Request:
    """A submitted generation request. ``tokens`` accumulates NEW tokens
    (the prompt is not echoed); timestamps are ``time.perf_counter()``."""

    id: int
    prompt: np.ndarray
    sampling: SamplingParams
    deadline_s: Optional[float] = None
    tenant: str = DEFAULT_TENANT
    slo_class: str = DEFAULT_SLO_CLASS
    status: RequestStatus = RequestStatus.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    exception: Optional[BaseException] = None
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    preemptions: int = 0                  # times parked mid-decode
    _wfq_start: float = dataclasses.field(default=0.0, repr=False)
    _wfq_finish: float = dataclasses.field(default=0.0, repr=False)
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _progress: threading.Condition = dataclasses.field(
        default_factory=threading.Condition, repr=False)

    def _notify_progress(self) -> None:
        """Wake streamers: new tokens appended or the request resolved.
        Called by the scheduler after every mutation a streaming reader
        cares about (its own Condition — never the scheduler lock)."""
        with self._progress:
            self._progress.notify_all()

    def wait_progress(self, seen: int,
                      timeout: Optional[float] = None
                      ) -> Tuple[List[int], bool]:
        """Block until the request holds MORE than ``seen`` tokens or
        reaches a terminal state (or ``timeout`` elapses — not an
        error: streaming pollers re-arm). Returns ``(tokens snapshot,
        terminal)``. The streaming read surface: a streamer keeps its
        own cursor, calls with it, and ships ``snapshot[seen:]`` —
        token chunks arrive at decode-chunk granularity because that is
        when the driver appends. Terminal FAILED is NOT raised here;
        the caller branches on ``status``/``exception`` so a streaming
        failover can splice instead of unwinding."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        with self._progress:
            while (len(self.tokens) <= seen
                   and not self._event.is_set()):
                rem = (None if deadline is None
                       else deadline - time.perf_counter())
                if rem is not None and rem <= 0:
                    break
                self._progress.wait(rem)
        return list(self.tokens), self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request completes; returns the new tokens or
        raises the TYPED failure (``DeadlineExceededError``,
        ``EngineFailedError``, ``SlotQuarantinedError``,
        ``SchedulerClosedError`` — all ``RuntimeError`` subclasses) /
        ``TimeoutError``."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} still "
                               f"{self.status.value} after {timeout}s")
        if self.status is RequestStatus.FAILED:
            if self.exception is not None:
                raise self.exception
            raise RequestFailedError(
                f"request {self.id} failed: {self.error}")
        return list(self.tokens)

    @property
    def deadline_t(self) -> Optional[float]:
        """Absolute ``perf_counter`` deadline (None = no deadline)."""
        if self.deadline_s is None:
            return None
        return self.submit_t + self.deadline_s

    @property
    def priority(self) -> int:
        """Admission priority from the SLO class (lower = more
        urgent); unknown classes rank as the default class."""
        return CLASS_PRIORITY.get(self.slo_class,
                                  CLASS_PRIORITY[DEFAULT_SLO_CLASS])

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def avg_token_latency_s(self) -> Optional[float]:
        """Mean inter-token latency AFTER the first token (TTFT is its
        own observable)."""
        if (self.done_t is None or self.first_token_t is None
                or len(self.tokens) < 2):
            return None
        return (self.done_t - self.first_token_t) / (len(self.tokens) - 1)


class Scheduler:
    """FCFS queue + slot assignment. One driver thread calls ``step``
    (or ``run``); any number of threads call ``submit``."""

    def __init__(self, engine: InferenceEngine, max_queue: int = 64,
                 metrics=None, prefix_window: int = 8,
                 starvation_rounds: int = 128,
                 quotas: Optional[Dict[str, ClassQuota]] = None,
                 preempt: bool = False, max_preemptions: int = 4,
                 quota_clock=time.monotonic):
        """``prefix_window``: how many queued requests the admit step may
        look ahead to prefer one whose prompt prefix is RESIDENT in the
        paged engine's prefix cache (most resident blocks win, FCFS
        breaks ties — so an unpaged engine, where every score is 0,
        keeps exact FCFS order). 1 = strict FCFS.

        ``starvation_rounds``: anti-starvation bound for the paged
        block pool — once the HEAD request has been passed over this
        many scheduling rounds for lack of blocks (while smaller
        requests kept admitting and re-pinning them), admission stops
        entirely until running slots drain and the head fits. Without
        it a large-block-need request could wait unboundedly under a
        sustained stream of small ones.

        ``quotas``: per-``slo_class`` refill-bucket token quotas
        (``ClassQuota``); a submit whose class bucket is dry fails
        typed ``QuotaExceededError`` (→ HTTP 429 + Retry-After). None
        (the default) disables quota enforcement entirely.

        ``preempt``: allow a STRICTLY more urgent queued request to
        park the least urgent running slot at a chunk boundary (paged
        engines only — parking is a host-side snapshot over pinned
        pages). The parked request keeps its ``Request`` object and
        stream; it resumes byte-identical once pressure clears, bounded
        by ``max_preemptions`` parks per request and the same
        ``starvation_rounds`` anti-starvation contract as the queue
        head. ``quota_clock`` injects the bucket clock for
        deterministic tests."""
        self.engine = engine
        self.max_queue = int(max_queue)
        self.metrics = metrics
        self.prefix_window = max(1, int(prefix_window))
        self.starvation_rounds = max(1, int(starvation_rounds))
        self._head_skip_id: Optional[int] = None
        self._head_skips = 0
        self.quotas: Dict[str, ClassQuota] = dict(quotas or {})
        self._buckets = {cls: _TokenBucket(q, quota_clock)
                         for cls, q in self.quotas.items()}
        self.preempt = bool(preempt)
        self.max_preemptions = max(0, int(max_preemptions))
        # parked (preempted) requests, oldest first: (Request, the
        # engine's ParkedSlot snapshot). Parked requests stay RUNNING —
        # their stream simply pauses and later resumes byte-identical.
        self._parked: List[Tuple[Request, Any]] = []
        self._parked_skip_id: Optional[int] = None
        self._parked_skips = 0
        self.preemptions = 0               # slots parked (cumulative)
        self.resumes = 0                   # parked snapshots resumed
        self.quota_rejections: Dict[str, int] = {}
        # start-time-fair-queuing state: the system virtual time
        # advances to the start tag of each admitted request; a
        # tenant's next request starts at max(vtime, its last finish)
        self._vtime = 0.0
        self._tenant_finish: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._drained = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._by_slot: Dict[int, Request] = {}
        self._ids = itertools.count()
        self._accepting = True
        self._shutdown_done = False
        self._epoch = 0
        # weight hot-swap support (serve/router.py): while paused, step()
        # keeps decoding the running slots but admits nothing new, so a
        # draining replica quiesces under sustained queued traffic
        self._admission_paused = False
        # queued requests carrying a deadline — lets the per-step shed
        # sweep early-out to one integer check in the (common)
        # no-deadline deployment instead of an O(queue) scan
        self._queued_deadlines = 0
        # the request popped from the queue but not yet placed in
        # _by_slot (the driver is inside engine.admit): failover and
        # shutdown must be able to fail it too — it is in NEITHER
        # collection while the prefill runs
        self._admitting: Optional[Request] = None
        # request ids cancelled by their caller (client disconnect):
        # swept at the next decode-chunk boundary alongside the
        # deadline cancellations — the single-driver contract means a
        # cancel can NEVER touch the engine from the caller's thread
        self._cancelled: set = set()

    # -- submit side ------------------------------------------------------

    def _estimate_service_s(self, max_new: int) -> Optional[float]:
        """Seconds until a request submitted NOW would finish, from the
        live tokens/s EWMA (``metrics``) and the tokens already committed
        ahead of it (queued max_new + remaining of running). Aggregate
        rate over total pending tokens is the right model for a slot
        batch: the engine serves the whole backlog concurrently at the
        EWMA rate. ``None`` when no rate is established yet (cold
        engine) — admission is then optimistic and the deadline is
        enforced downstream by shedding/cancellation."""
        if self.metrics is None:
            return None
        rate = self.metrics.tokens_per_s_ewma()
        if rate is None or rate <= 0:
            return None
        backlog = sum(r.sampling.max_new_tokens for r in self._queue)
        backlog += sum(
            max(0, r.sampling.max_new_tokens - len(r.tokens))
            for r in self._by_slot.values())
        backlog += sum(
            max(0, r.sampling.max_new_tokens - len(r.tokens))
            for r, _parked in self._parked)
        return (backlog + max_new) / rate

    def submit(self, prompt, sampling: Optional[SamplingParams] = None,
               block: bool = True, timeout: Optional[float] = 30.0,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None,
               slo_class: Optional[str] = None) -> Request:
        fault_point("serve.admit")
        t_entry = time.perf_counter()
        sampling = sampling or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.engine.validate(prompt, sampling)   # typed ValueError, early
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        slo_class = (DEFAULT_SLO_CLASS if slo_class is None
                     else str(slo_class))
        if slo_class not in CLASS_PRIORITY:
            raise ValueError(
                f"unknown slo_class {slo_class!r} (known: "
                f"{', '.join(SLO_CLASSES)})")
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(
                f"deadline_s must be > 0 (got {deadline_s}); omit it for "
                f"no deadline")
        # the deadline clock starts at submit ENTRY and also caps the
        # queue-full blocking wait — "bounds the request end to end"
        # must include time spent waiting for queue space
        cap = timeout
        if deadline_s is not None:
            cap = deadline_s if cap is None else min(cap, deadline_s)
        wait_deadline = None if cap is None else t_entry + cap
        with self._drained:
            if not self._accepting:
                raise SchedulerClosedError("scheduler is shutting down")
            bucket = self._buckets.get(slo_class)
            if bucket is not None:
                ewma = (self.metrics.tokens_per_s_ewma()
                        if self.metrics is not None else None)
                ok, retry = bucket.try_take(
                    sampling.max_new_tokens, ewma)
                if not ok:
                    self.quota_rejections[slo_class] = \
                        self.quota_rejections.get(slo_class, 0) + 1
                    if self.metrics is not None:
                        self.metrics.request_rejected(
                            queue_depth=len(self._queue),
                            active_slots=self.engine.stats.active_slots,
                            tenant=tenant, slo_class=slo_class)
                    raise QuotaExceededError(
                        f"slo_class={slo_class} token quota exhausted: "
                        f"{sampling.max_new_tokens} committed tokens "
                        f"exceed the class refill bucket — retry after "
                        f"{retry:.2g}s", retry_after_s=retry)
            if deadline_s is not None:
                est = self._estimate_service_s(sampling.max_new_tokens)
                if est is not None and est > deadline_s:
                    if self.metrics is not None:
                        self.metrics.request_rejected(
                            queue_depth=len(self._queue),
                            active_slots=self.engine.stats.active_slots,
                            tenant=tenant, slo_class=slo_class)
                    raise AdmissionRejectedError(
                        f"deadline_s={deadline_s:.3g} infeasible: estimated "
                        f"service time {est:.3g}s at the current "
                        f"{self.metrics.tokens_per_s_ewma() or 0.0:.1f} "
                        f"tok/s — shed at admission",
                        retry_after_s=max(0.1, est - deadline_s))
            while len(self._queue) >= self.max_queue:
                if not block:
                    raise QueueFullError(
                        f"request queue at capacity ({self.max_queue})")
                rem = None if wait_deadline is None \
                    else wait_deadline - time.perf_counter()
                if rem is not None and rem <= 0:
                    raise QueueFullError(
                        f"request queue still at capacity "
                        f"({self.max_queue}) after {cap}s")
                self._drained.wait(rem)
                if not self._accepting:
                    raise SchedulerClosedError("scheduler is shutting down")
            req = Request(id=next(self._ids), prompt=prompt,
                          sampling=sampling, deadline_s=deadline_s,
                          tenant=tenant, slo_class=slo_class,
                          submit_t=t_entry)
            # start-time fair queuing tags (arrival-stamped): start at
            # max(system virtual time, this tenant's last finish);
            # finish advances by cost/weight — the weighted-fair share
            w = CLASS_WEIGHT.get(slo_class, 1.0)
            cost = float(prompt.size + sampling.max_new_tokens)
            req._wfq_start = max(self._vtime,
                                 self._tenant_finish.get(tenant, 0.0))
            req._wfq_finish = req._wfq_start + cost / w
            self._tenant_finish[tenant] = req._wfq_finish
            self._queue.append(req)
            if deadline_s is not None:
                self._queued_deadlines += 1
        return req

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def active_requests(self) -> int:
        with self._lock:
            return len(self._by_slot)

    def inflight(self) -> int:
        """Requests the engine currently holds state for: running slots,
        parked (preempted — their pages stay pinned) and one
        mid-``admit``. Queued requests do NOT count — they carry no
        engine state and survive an engine swap untouched. The router's
        rolling weight reload waits for this to reach 0."""
        with self._lock:
            return (len(self._by_slot) + len(self._parked)
                    + (1 if self._admitting is not None else 0))

    def backlog_tokens(self) -> int:
        """Committed future work in tokens (queued max_new + remaining of
        running/parked + mid-admission) — the router's least-loaded
        dispatch score. Same accounting as ``_estimate_service_s``'s
        backlog."""
        with self._lock:
            t = sum(r.sampling.max_new_tokens for r in self._queue)
            t += sum(max(0, r.sampling.max_new_tokens - len(r.tokens))
                     for r in self._by_slot.values())
            t += sum(max(0, r.sampling.max_new_tokens - len(r.tokens))
                     for r, _parked in self._parked)
            if self._admitting is not None:
                t += self._admitting.sampling.max_new_tokens
            return t

    def backlog_tokens_by_class(self) -> Dict[str, int]:
        """``backlog_tokens`` split by ``slo_class`` — the router's
        class-aware dispatch input: a replica drowning in preemptible
        batch backlog is still a fine home for interactive traffic."""
        with self._lock:
            return self._backlog_by_class_locked()

    def _backlog_by_class_locked(self) -> Dict[str, int]:
        out: Dict[str, int] = {}

        def add(req: Request, tokens: int) -> None:
            out[req.slo_class] = out.get(req.slo_class, 0) + tokens

        for r in self._queue:
            add(r, r.sampling.max_new_tokens)
        for r in self._by_slot.values():
            add(r, max(0, r.sampling.max_new_tokens - len(r.tokens)))
        for r, _parked in self._parked:
            add(r, max(0, r.sampling.max_new_tokens - len(r.tokens)))
        if self._admitting is not None:
            add(self._admitting,
                self._admitting.sampling.max_new_tokens)
        return out

    def tenant_snapshot(self) -> Dict[str, Union[int, Dict]]:
        """Live multi-tenant observables for ``/stats``: per-class
        quota fill (None = unresolvable/cold), preempt/resume/rejection
        counters, parked depth and the per-class backlog."""
        ewma = (self.metrics.tokens_per_s_ewma()
                if self.metrics is not None else None)
        with self._lock:
            fills = {cls: b.fill_fraction(ewma)
                     for cls, b in self._buckets.items()}
            return {
                "preemptions": self.preemptions,
                "resumes": self.resumes,
                "parked": len(self._parked),
                "quota_rejections": dict(self.quota_rejections),
                "quota_fill": fills,
                "backlog_by_class": self._backlog_by_class_locked(),
            }

    # -- caller-side cancellation (client disconnect) ---------------------

    def cancel(self, req: Request,
               reason: str = "client disconnected") -> bool:
        """Cancel ``req`` on behalf of its caller (the HTTP handler saw
        EPIPE mid-stream). A QUEUED request is failed immediately (it
        holds no engine state); a RUNNING one is flagged and the driver
        cancels it at the NEXT decode-chunk boundary — same mechanics,
        same granularity as deadline cancellation — freeing the slot.
        Returns True if the cancel took (False: already resolved). The
        stored failure is ``RequestCancelledError``, which metrics maps
        to ``status=disconnected``."""
        queued = False
        with self._drained:
            if req.status in (RequestStatus.DONE, RequestStatus.FAILED):
                return False
            if req in self._queue:
                self._queue.remove(req)
                if req.deadline_s is not None:
                    self._queued_deadlines -= 1
                self._drained.notify_all()
                queued = True
            else:
                # running, or mid-admission (it will be RUNNING by the
                # time the driver's next sweep sees the flag)
                self._cancelled.add(req.id)
        if queued:
            self._fail(req, RequestCancelledError(
                f"request {req.id} cancelled while queued — {reason}"))
        return True

    # -- admission pause (rolling weight hot-swap) ------------------------

    def pause_admission(self) -> None:
        """Stop admitting queued requests into slots (running slots keep
        decoding to completion; submits still enqueue). The router pauses
        a replica, waits for ``inflight() == 0``, swaps the engine, then
        ``resume_admission`` — queued requests admit onto the NEW
        engine, which is what makes the weight swap zero-downtime."""
        with self._lock:
            self._admission_paused = True

    def resume_admission(self) -> None:
        with self._lock:
            self._admission_paused = False

    # -- driver side ------------------------------------------------------

    def _shed_expired_queued(self, now: float) -> List[Request]:
        """Remove queued requests whose deadline already passed — shed
        BEFORE prefill, even when every slot is busy (an expired request
        must not wait for a free slot just to be told it is late)."""
        shed: List[Request] = []
        with self._drained:
            if not self._queued_deadlines:
                return shed
            keep = deque()
            for req in self._queue:
                dl = req.deadline_t
                if dl is not None and now > dl:
                    shed.append(req)
                else:
                    keep.append(req)
            if shed:
                self._queue = keep
                self._queued_deadlines -= len(shed)
                self._drained.notify_all()
        return shed

    def _pick_admit_index(self, engine: InferenceEngine) -> Optional[int]:
        """Index of the next queued request to admit (caller holds the
        lock).

        SINGLE tenant queued (the default deployment): FCFS, except
        that within the first ``prefix_window`` queued requests the one
        with the most prompt-prefix blocks RESIDENT in the paged
        engine's prefix cache wins (FCFS breaks ties) — admit ordering
        is the cheapest way to turn shared-prefix bursts into cache
        hits before eviction churn loses them.

        MULTIPLE tenants queued: weighted-fair queuing — the candidates
        are each tenant's OLDEST queued request (per-tenant FIFO, so a
        flooding tenant cannot push a quiet tenant's head out of any
        bounded window) and the earliest virtual finish tag wins, with
        the resident-prefix score as a bounded tie-break and FCFS after
        that. At one tenant the candidate set and scoring degrade to
        exactly the single-tenant path above.

        Requests the block pool cannot serve right now are passed over
        (running slots will free their blocks; ``engine.validate``
        guarantees every queued request fits an idle pool) — bounded by
        the starvation guard: once the HEAD request has been passed
        over ``starvation_rounds`` times — whether for lack of blocks
        OR because hotter-prefix/fairer requests kept outscoring it —
        it is the only admissible choice: admit it, or (if the pool
        still can't serve it) admit nothing until the pool drains.
        None = admit nothing this round."""
        head = self._queue[0]
        if self._head_skip_id != head.id:
            self._head_skip_id, self._head_skips = head.id, 0
        starved = self._head_skips > self.starvation_rounds
        # candidate set: each tenant's first queued request; one tenant
        # present → the first prefix_window requests (the prefix window)
        tenant_heads: Dict[str, Tuple[int, Request]] = {}
        for i, req in enumerate(self._queue):
            if req.tenant not in tenant_heads:
                tenant_heads[req.tenant] = (i, req)
        wfq = len(tenant_heads) > 1
        if wfq:
            candidates = sorted(tenant_heads.values())
        else:
            candidates = list(enumerate(
                itertools.islice(self._queue, self.prefix_window)))
        best, best_key, head_ok = None, None, False
        for i, req in candidates:
            ok, score = engine.admit_probe(req.prompt, req.sampling)
            if i == 0:
                head_ok = ok
                if starved:
                    break        # the head's turn: it or nothing
            if not ok:
                continue
            # min() keys: WFQ ranks by virtual finish first; the
            # single-tenant key is (-score, i) — most resident blocks,
            # FCFS ties — the exact pre-tenant ordering
            key = ((req._wfq_finish, -score, i) if wfq
                   else (-score, i))
            if best_key is None or key < best_key:
                best, best_key = i, key
        if starved:
            best = 0 if head_ok else None
        if best == 0:
            self._head_skips = 0
        else:
            self._head_skips += 1
        return best

    def _admit_from_queue(self, epoch: int,
                          engine: InferenceEngine) -> int:
        admitted = 0
        while engine.free_slots():
            with self._drained:
                # _admission_paused re-checked HERE, not just in step()'s
                # snapshot: it shares this lock with pause_admission, so
                # once the router has paused and observed inflight()==0,
                # no driver iteration — however stale its snapshot — can
                # still pop a request into the about-to-be-swapped engine
                if (self._epoch != epoch or self._admission_paused
                        or not self._queue):
                    break
                idx = self._pick_admit_index(engine)
                if idx is None:
                    break          # block pool busy: admit next round
                req = self._queue[idx]
                del self._queue[idx]
                # SFQ virtual time: advance to the admitted request's
                # start tag so idle tenants re-enter at the live edge
                self._vtime = max(self._vtime, req._wfq_start)
                if req.deadline_s is not None:
                    self._queued_deadlines -= 1
                self._admitting = req
                self._drained.notify_all()
            dl = req.deadline_t
            if dl is not None and time.perf_counter() > dl:
                # expired between the shed sweep and this pop
                with self._lock:
                    if self._admitting is req:
                        self._admitting = None
                self._fail(req, DeadlineExceededError(
                    f"deadline_s={req.deadline_s:.3g} elapsed in queue — "
                    f"shed before prefill"))
                continue
            try:
                slot, ev = engine.admit(req.prompt, req.sampling)
            except NoFreeBlocksError:
                # transient paged-pool shortage that appeared between the
                # capacity probe and admit — reinsert at the ORIGINAL
                # queue position (the request is fine; the blocks aren't
                # there yet; jumping older requests would also perturb
                # the starvation guard's head tracking). Positions ahead
                # of idx only ever shrink via this driver thread, so the
                # clamp preserves relative order. Skipped when a
                # failover raced us: fail_inflight already owns the
                # in-admission request's resolution.
                with self._drained:
                    mine = self._admitting is req
                    if mine:
                        self._admitting = None
                    if mine and self._epoch == epoch:
                        self._queue.insert(min(idx, len(self._queue)),
                                           req)
                        if req.deadline_s is not None:
                            self._queued_deadlines += 1
                break
            except Exception as e:  # noqa: BLE001 — a bad request must
                # fail ITSELF, not tear the serving loop down
                with self._lock:
                    if self._admitting is req:
                        self._admitting = None
                self._fail(req, e)
                continue
            with self._lock:
                # clear only OUR marker: a stale waking driver must not
                # wipe the live generation's in-admission request
                if self._admitting is req:
                    self._admitting = None
                stale = self._epoch != epoch
                # a failover/shutdown may have failed this request while
                # we were inside admit — never resurrect a resolved one
                resolved = req.status in (RequestStatus.DONE,
                                          RequestStatus.FAILED)
                if not stale and not resolved:
                    req.status = RequestStatus.RUNNING
                    req.first_token_t = time.perf_counter()
                    req.tokens.append(ev.token)
                    admitted += 1
                    if not ev.finished:
                        self._by_slot[slot] = req
            if not stale and not resolved:
                req._notify_progress()     # first token: wake streamers
            if resolved and not stale:
                engine.release(slot)   # same engine; free the row
                continue
            if stale:
                # the engine was replaced mid-admit (supervisor failover):
                # this prefill went into the DEAD engine
                self._fail(req, EngineFailedError(
                    "engine replaced during admission (supervisor "
                    "failover) — retry"))
                break
            if ev.finished:
                self._complete(req)
        return admitted

    # -- preemptible decode (driver side) ---------------------------------

    def _preempt_for_queued(self, epoch: int,
                            engine: InferenceEngine) -> None:
        """Park the least urgent running slot when a STRICTLY more
        urgent request is queued and no slot is free — at most one park
        per scheduling round (the driver loop converges within a few
        chunks under a flood; one-at-a-time keeps each round bounded).
        Chunk-boundary semantics for free: this runs between engine
        dispatches. The victim keeps its ``Request`` (stream pauses),
        is bounded by ``max_preemptions`` parks, and its pages stay
        pinned for the byte-identical resume."""
        if not engine.paged or engine.free_slots():
            return
        victim = None
        with self._lock:
            if self._epoch != epoch or not self._queue:
                return
            urgent = min(r.priority for r in self._queue)
            cands = [(slot, req) for slot, req in self._by_slot.items()
                     if req.priority > urgent
                     and req.preemptions < self.max_preemptions]
            if not cands:
                return
            # least urgent class first; most remaining work second (the
            # slot that would hold its pages/slot hostage the longest)
            slot, victim = max(cands, key=lambda it: (
                it[1].priority,
                it[1].sampling.max_new_tokens - len(it[1].tokens)))
            parked = engine.park(slot)
            del self._by_slot[slot]
            victim.preemptions += 1
            self._parked.append((victim, parked))
            self.preemptions += 1
        if self.metrics is not None:
            self.metrics.request_preempted(
                victim, queue_depth=self.queue_depth(),
                active_slots=engine.stats.active_slots)

    def _resume_parked(self, epoch: int,
                       engine: InferenceEngine) -> None:
        """Resume parked requests (oldest first) into free slots. A
        parked request YIELDS to strictly more urgent queued work — the
        admit pass gets the slot — but only up to ``starvation_rounds``
        passes, the same anti-starvation contract as the queue head:
        a batch request always eventually progresses."""
        resumed: List[Request] = []
        while True:
            with self._lock:
                if (self._epoch != epoch or not self._parked
                        or not engine.free_slots()):
                    break
                req, parked = self._parked[0]
                if self._parked_skip_id != req.id:
                    self._parked_skip_id, self._parked_skips = req.id, 0
                if req.status in (RequestStatus.DONE,
                                  RequestStatus.FAILED):
                    # resolved while parked (failover/shutdown race):
                    # drop the snapshot, never resurrect
                    self._parked.pop(0)
                    engine.release_parked(parked)
                    continue
                starved = self._parked_skips > self.starvation_rounds
                urgent_queued = any(r.priority < req.priority
                                    for r in self._queue)
                if urgent_queued and not starved:
                    self._parked_skips += 1
                    break        # the admit pass takes the free slot
                slot = engine.resume(parked)
                self._parked.pop(0)
                self._parked_skips = 0
                self._by_slot[slot] = req
                self.resumes += 1
                resumed.append(req)
        for req in resumed:
            if self.metrics is not None:
                self.metrics.request_resumed(
                    req, queue_depth=self.queue_depth(),
                    active_slots=engine.stats.active_slots)

    def step(self) -> int:
        """One scheduling round; returns the number of tokens produced
        (0 = idle). Admission happens BEFORE the decode step so a freed
        slot turns around within one round. Epoch-guarded: a stale driver
        (one that wedged, was failed over past, and finally woke) discards
        its events instead of touching the rebuilt engine's requests."""
        now0 = time.perf_counter()
        for req in self._shed_expired_queued(now0):
            self._fail(req, DeadlineExceededError(
                f"deadline_s={req.deadline_s:.3g} elapsed in queue after "
                f"{now0 - req.submit_t:.3g}s — shed before prefill"))
        with self._lock:
            epoch = self._epoch
            engine = self.engine
            paused = self._admission_paused
        if not paused:
            if self._parked:
                self._resume_parked(epoch, engine)
            if self.preempt:
                self._preempt_for_queued(epoch, engine)
        produced = 0 if paused else self._admit_from_queue(epoch, engine)
        events = engine.step()
        now = time.perf_counter()
        completed: List[Request] = []
        failed: List[Tuple[Request, BaseException]] = []
        progressed: List[Request] = []
        with self._lock:
            if self._epoch != epoch:
                return produced        # stale driver: discard the chunk
            for ev in events:
                req = self._by_slot.get(ev.slot)
                if req is None:      # slot freed by a cancel between steps
                    continue
                if ev.poisoned:
                    # NaN/Inf quarantine: the engine already deactivated
                    # the slot; this chunk's tokens are garbage — fail
                    # ONLY this request, drop its events
                    del self._by_slot[ev.slot]
                    failed.append((req, SlotQuarantinedError(
                        f"non-finite logits in slot {ev.slot} — request "
                        f"quarantined after {len(req.tokens)} tokens")))
                    continue
                req.tokens.append(ev.token)
                produced += 1
                if req not in progressed:
                    progressed.append(req)
                if ev.finished:
                    del self._by_slot[ev.slot]
                    completed.append(req)
            # deadline + caller cancellation at the chunk boundary: the
            # slot is freed for the next admit, the partial generation
            # reported (or, for a disconnect, silently dropped — the
            # client is gone)
            for slot, req in list(self._by_slot.items()):
                dl = req.deadline_t
                if req.id in self._cancelled:
                    self._cancelled.discard(req.id)
                    engine.release(slot)
                    del self._by_slot[slot]
                    failed.append((req, RequestCancelledError(
                        f"request {req.id} cancelled mid-generation "
                        f"({len(req.tokens)} tokens in) — slot freed at "
                        f"chunk boundary")))
                elif dl is not None and now > dl:
                    engine.release(slot)
                    del self._by_slot[slot]
                    failed.append((req, DeadlineExceededError(
                        f"deadline_s={req.deadline_s:.3g} exceeded "
                        f"mid-generation ({len(req.tokens)} tokens in) — "
                        f"cancelled at chunk boundary")))
            # the same sweep over PARKED requests: a preempted request
            # whose caller disconnected or deadline passed must release
            # its pinned pages and fail typed, never linger parked
            if self._parked:
                keep_parked = []
                for req, parked in self._parked:
                    dl = req.deadline_t
                    if req.id in self._cancelled:
                        self._cancelled.discard(req.id)
                        engine.release_parked(parked)
                        failed.append((req, RequestCancelledError(
                            f"request {req.id} cancelled while parked "
                            f"({len(req.tokens)} tokens in)")))
                    elif dl is not None and now > dl:
                        engine.release_parked(parked)
                        failed.append((req, DeadlineExceededError(
                            f"deadline_s={req.deadline_s:.3g} exceeded "
                            f"while parked ({len(req.tokens)} tokens "
                            f"in) — preempted and never resumed in "
                            f"time")))
                    else:
                        keep_parked.append((req, parked))
                self._parked = keep_parked
        for req in completed:
            self._complete(req, now)
        for req, exc in failed:
            self._fail(req, exc)
        if progressed:
            for req in progressed:
                req._notify_progress()
        return produced

    def _complete(self, req: Request,
                  now: Optional[float] = None) -> None:
        with self._lock:   # idempotent: failover/shutdown may race us
            if req.status in (RequestStatus.DONE, RequestStatus.FAILED):
                return
            req.done_t = now if now is not None else time.perf_counter()
            req.status = RequestStatus.DONE
            self._cancelled.discard(req.id)
        req._event.set()
        req._notify_progress()
        if self.metrics is not None:
            self.metrics.request_done(
                req, queue_depth=self.queue_depth(),
                active_slots=self.engine.stats.active_slots)

    def _fail(self, req: Request,
              error: Union[str, BaseException]) -> None:
        with self._lock:   # idempotent: only the FIRST resolution wins
            if req.status in (RequestStatus.DONE, RequestStatus.FAILED):
                return
            if isinstance(error, BaseException):
                req.exception = error
                req.error = f"{type(error).__name__}: {error}"
            else:
                req.error = error
            req.status = RequestStatus.FAILED
            req.done_t = time.perf_counter()
            self._cancelled.discard(req.id)
        req._event.set()
        req._notify_progress()
        if self.metrics is not None:
            self.metrics.request_done(
                req, queue_depth=self.queue_depth(),
                active_slots=self.engine.stats.active_slots)

    # -- failover hooks (supervisor) --------------------------------------

    def fail_inflight(self, error: BaseException) -> List[Request]:
        """Fail every RUNNING request typed and advance the epoch so a
        stale (wedged) driver that eventually wakes cannot apply its
        events or admissions. Called by the supervisor on an engine crash
        or watchdog-detected wedge; queued requests stay queued — they
        resume on the rebuilt engine."""
        with self._drained:
            self._epoch += 1
            victims = list(self._by_slot.values())
            self._by_slot.clear()
            # parked requests die with the engine too: their pinned
            # pages lived in the DEAD engine's pool — no release needed
            # (the rebuilt engine starts with a fresh allocator), but
            # their futures must resolve typed, never silently drop
            victims.extend(req for req, _parked in self._parked)
            self._parked.clear()
            if self._admitting is not None:
                # popped from the queue but wedged inside engine.admit —
                # in NEITHER collection; its future must not wait for
                # the abandoned thread to wake (maybe never)
                victims.append(self._admitting)
        for req in victims:
            self._fail(req, error)
        return victims

    def replace_engine(self, engine: InferenceEngine) -> None:
        """Swap in a rebuilt engine (after ``fail_inflight``, or a
        drained hot-swap). The global program LRUs make the swap warm:
        same config → no recompiles. The epoch bump invalidates any
        driver iteration that snapshotted the OLD engine before the
        swap: without it, a preempted driver could still admit a queued
        request into the detached engine (old weights, slots the new
        engine never steps)."""
        with self._lock:
            self.engine = engine
            self._epoch += 1

    def run(self, stop: threading.Event, idle_wait_s: float = 0.005):
        """Drive ``step`` until ``stop`` is set; sleeps briefly when idle
        (no busy spin — submissions are picked up at the next round)."""
        while not stop.is_set():
            produced = self.step()
            if self.metrics is not None:
                self.metrics.engine_tick(
                    self.engine.stats, queue_depth=self.queue_depth())
            if produced == 0:
                stop.wait(idle_wait_s)

    def shutdown(self, finish_running: bool = True,
                 deadline_s: float = 300.0) -> None:
        """Graceful drain (the SIGTERM path): stop accepting, FAIL queued
        requests (typed ``SchedulerClosedError`` — reported, not
        dropped), and either answer every in-flight request
        (``finish_running=True``, bounded by ``deadline_s``) or fail
        those too. Call from the driver thread or after the driver loop
        has stopped. Idempotent: a second call returns immediately
        instead of re-draining."""
        with self._drained:
            if self._shutdown_done:
                return
            self._shutdown_done = True
            self._accepting = False
            queued = list(self._queue)
            self._queue.clear()
            self._queued_deadlines = 0
            self._drained.notify_all()
        for req in queued:
            self._fail(req, SchedulerClosedError(
                "server shutting down before this request was scheduled"))
        if finish_running:
            deadline = time.perf_counter() + deadline_s
            while ((self._by_slot or self._parked)
                   and time.perf_counter() < deadline):
                try:
                    self.step()
                except Exception as e:  # noqa: BLE001 — a broken engine
                    # cannot drain (e.g. a persistent fault raced the
                    # stop); fall through and fail the remainder typed
                    # instead of killing the drain thread mid-shutdown
                    sys.stderr.write(
                        f"gym_tpu.serve: drain step raised "
                        f"{type(e).__name__}: {e} — failing remaining "
                        f"in-flight requests\n")
                    break
        for slot, req in list(self._by_slot.items()):
            self.engine.release(slot)
            del self._by_slot[slot]
            self._fail(req, SchedulerClosedError(
                "server shut down mid-generation"))
        for req, parked in self._parked:
            self.engine.release_parked(parked)
            self._fail(req, SchedulerClosedError(
                "server shut down while this request was parked "
                "(preempted)"))
        self._parked = []
        with self._lock:
            admitting = self._admitting
        if admitting is not None:
            # mid-admission under a wedged driver: resolve its future
            # (idempotent _fail — a no-op if the driver got there first)
            self._fail(admitting, SchedulerClosedError(
                "server shut down during admission"))
