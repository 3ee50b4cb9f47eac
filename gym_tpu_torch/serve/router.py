"""Fleet serving: N in-process engine replicas behind one health-aware
router (counterpart of ``gym_tpu/serve/router.py``'s in-process half).

One engine+scheduler+supervisor stack caps out at one card's throughput,
and a wedged or killed engine takes the whole service down with it until
its supervisor rebuilds. The router is the layer that survives the loss of
a *replica*:

- **Replicas** — in-process engine+scheduler+supervisor stacks
  (``build_fleet`` constructs them over one shared params dict and one
  shared ``ServeMetrics``; each replica writes through a
  ``replica_view`` so ``serve.csv`` rows and EWMAs stay per-replica).
  Health is DERIVED, not polled: a replica is out of dispatch exactly
  when its supervisor declared the engine dead (``failed`` set, hooked
  live via ``Supervisor.on_dead``) or while a rolling reload drains it.
- **Dispatch** — least-loaded by committed backlog tokens
  (``Scheduler.backlog_tokens``) with a prefix-cache-aware bonus: on
  paged engines ``admit_probe``'s resident-prefix score (× page_size
  tokens of elided prefill work) is subtracted from the load, so
  shared-prefix traffic sticks to the replica that already holds the
  pages. Ties break to the lowest replica id (a single replica is the
  single-engine server exactly).
- **Failover** — a replica that dies or wedges mid-request fails its
  in-flight requests typed; ``FleetRequest.result`` catches those and
  transparently re-dispatches to a sibling under the request's REMAINING
  deadline (anchored at the fleet submit entry, so a retried request can
  never wait two full deadlines), bounded by ``max_failovers``. The engine
  is deterministic (same params, same seed ⇒ the exact ``generate_fast``
  stream), so the winning attempt's stream IS the uncontended stream.
- **Degradation** — every live replica rejecting a deadline at admission
  re-raises the cheapest ``AdmissionRejectedError`` (HTTP 429 +
  Retry-After); every queue full waits bounded by the submit timeout or
  deadline, then raises ``QueueFullError``; every replica dead raises
  ``NoHealthyReplicaError`` (HTTP 503).
- **Zero-downtime weight hot-swap** (``reload``) — roll new params
  through the replicas ONE AT A TIME: pause the replica's admission and
  stop dispatching to it, wait for its in-flight requests to finish
  (queued requests keep their place), build the new engine from the
  updated params box via the replica's factory (which captures the new
  engine's CUDA graphs before it serves: a graph holds its engine's
  addresses, so no graph of the old engine is ever pointed at the new
  weights), swap it into the scheduler, close the old engine (its graphs,
  staging buffers and caches, so peak memory does not grow from reload
  to reload), resume. A fresh engine also gets a fresh paged allocator
  and prefix cache: blocks computed under the old weights are never
  served against the new ones.

The out-of-process fleet (``WorkerSpawner``, ``ProcessReplica``,
``ProcessRouter``, ``build_process_fleet``, ``gym_tpu/serve/router.py:
732-1877``) and its autoscaler are ROADMAP item 15.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..programs import warm_engine_programs
from ..utils.resilience import dump_thread_stacks
from .engine import InferenceEngine, SamplingParams
from .scheduler import (CLASS_PRIORITY, AdmissionRejectedError,
                        DeadlineExceededError, EngineFailedError,
                        QueueFullError, Request, RequestStatus, Scheduler,
                        SchedulerClosedError)
from .supervisor import Supervisor

PyTree = Any


class NoHealthyReplicaError(RuntimeError):
    """Every replica in the fleet is dead (or the fleet is empty): the
    request cannot be dispatched anywhere. HTTP maps this to 503 —
    fleet-level degradation, not a traceback."""

    def __init__(self, msg: str, retry_after_s: float = 10.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class FleetReloadError(RuntimeError):
    """A rolling weight reload could not proceed: one is already in
    flight (``retry_after_s`` is None → HTTP 409), or a replica failed
    to drain inside the bound (``retry_after_s`` set → HTTP 503, the
    condition is transient; the partial state is reported —
    already-swapped replicas STAY swapped)."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class Replica:
    """One fleet member: its scheduler/supervisor stack plus the engine
    factory the supervisor rebuilds from (reading the router's params
    box, so a post-reload failover rebuilds with the NEW weights)."""

    id: int
    scheduler: Scheduler
    supervisor: Supervisor
    engine_factory: Callable[[], InferenceEngine]
    metrics: Any = None
    draining: bool = False

    @property
    def dead(self) -> bool:
        return self.supervisor.failed is not None

    @property
    def healthy(self) -> bool:
        return not self.dead and not self.draining


class FleetRequest:
    """Router-level request handle, mirroring ``scheduler.Request``'s
    wait surface (``result`` / ``tokens`` / ``ttft_s`` / ``done_t``) so
    the HTTP handler treats both alike. ``result`` performs the bounded
    failover retries; ``replica_id`` names the replica currently (or
    finally) serving the request and ``failovers`` how many times it was
    re-dispatched. TTFT is anchored at the FLEET submit entry, so a
    failed-over request's reported latency honestly includes the
    failover."""

    def __init__(self, router: "Router", prompt: np.ndarray,
                 sampling: SamplingParams, deadline_s: Optional[float],
                 submit_t: float, tenant: Optional[str] = None,
                 slo_class: Optional[str] = None):
        self._router = router
        self.prompt = prompt
        self.sampling = sampling
        self.deadline_s = deadline_s
        self.submit_t = submit_t
        self.tenant = tenant
        self.slo_class = slo_class
        self.failovers = 0
        self.replica_id: int = -1
        self._inner: Optional[Request] = None

    # -- Request-compatible surface --------------------------------------

    @property
    def id(self) -> int:
        return self._inner.id

    @property
    def status(self) -> RequestStatus:
        return self._inner.status

    @property
    def tokens(self) -> List[int]:
        return list(self._inner.tokens)

    @property
    def error(self) -> Optional[str]:
        return self._inner.error

    @property
    def exception(self) -> Optional[BaseException]:
        return self._inner.exception

    @property
    def done_t(self) -> Optional[float]:
        return self._inner.done_t

    @property
    def ttft_s(self) -> Optional[float]:
        if self._inner.first_token_t is None:
            return None
        return self._inner.first_token_t - self.submit_t

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block for the tokens, transparently failing over to a sibling
        replica (bounded retries, remaining-deadline forwarded) when the
        serving replica dies mid-request. Raises the TYPED terminal
        failure otherwise — exactly ``Request.result``'s contract."""
        return self._router._await(self, timeout)

    def cancel(self, reason: str = "client disconnected") -> bool:
        """Caller-side cancellation (HTTP client went away): stop the
        generation at the next decode-chunk boundary on whichever
        replica currently serves it, free the slot."""
        inner = self._inner
        rep = next((r for r in self._router.replicas
                    if r.id == self.replica_id), None)
        if rep is None or inner is None:
            return False
        return rep.scheduler.cancel(inner, reason=reason)

    def stream(self, timeout: Optional[float] = None,
               poll_s: float = 0.25):
        """Yield lists of NEW tokens as the request produces them, at
        decode-chunk granularity — the streaming read surface. A replica
        that dies mid-stream is failed over exactly like ``result``,
        and the retry's replayed prefix (the deterministic engine
        re-derives the already-yielded tokens) is SUPPRESSED, so the
        concatenation of everything yielded is byte-identical to an
        uncontended run: the failover splice. Terminal failures raise
        TYPED, after whatever prefix was already delivered."""
        wait_deadline = (None if timeout is None
                         else time.perf_counter() + timeout)
        yielded: List[int] = []
        while True:
            inner = self._inner
            rem = (None if wait_deadline is None
                   else wait_deadline - time.perf_counter())
            if rem is not None and rem <= 0:
                # the reader gave up: stop the generation at the next
                # chunk boundary — a timed-out stream must not keep a
                # slot busy for nobody (the process router's
                # _stream_timeout twin)
                self.cancel(reason="stream wait timed out")
                raise TimeoutError(
                    f"request {inner.id} still {inner.status.value} "
                    f"after {timeout}s ({len(yielded)} tokens streamed)")
            step = poll_s if rem is None else min(poll_s, rem)
            snapshot, terminal = inner.wait_progress(len(yielded), step)
            if len(snapshot) > len(yielded):
                if snapshot[:len(yielded)] != yielded:
                    raise EngineFailedError(
                        f"stream splice mismatch after failover: "
                        f"replayed prefix diverged at request "
                        f"{inner.id} — non-deterministic replica?")
                chunk = snapshot[len(yielded):]
                yielded.extend(chunk)
                yield chunk
            if terminal:
                if inner.status is RequestStatus.DONE:
                    return
                exc = inner.exception or RuntimeError(
                    inner.error or "request failed")
                if not isinstance(exc, (EngineFailedError,
                                        SchedulerClosedError)):
                    raise exc
                # replica died mid-stream: re-dispatch under the
                # remaining deadline; the new attempt replays the
                # yielded prefix, which the loop above suppresses
                self._router._failover_redispatch(self, exc,
                                                  wait_deadline)


class Router:
    """Health-aware dispatch + failover + rolling weight reload over a
    list of ``Replica``s. Thread-safe: any number of handler threads
    call ``submit``/``result``; the internal lock guards only counters
    and flags (never held across a blocking call)."""

    def __init__(self, replicas: Sequence[Replica], *,
                 metrics=None, max_failovers: Optional[int] = None,
                 params_box: Optional[Dict[str, Any]] = None,
                 prefix_bonus_weight: float = 1.0, log=print):
        """``max_failovers`` bounds per-request re-dispatches; the
        default ``min(2, N-1)`` keeps a single-replica fleet EXACTLY
        the single-engine server (a typed failure surfaces to the client, no silent
        same-replica retry) while a real fleet retries on siblings.
        ``params_box`` is the mutable weights container every replica's
        engine factory reads (``reload`` updates it first, so failover
        rebuilds during a rolling swap already use the new params)."""
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")
        self.metrics = metrics
        self.params_box = params_box if params_box is not None else {}
        self.max_failovers = (min(2, len(self.replicas) - 1)
                              if max_failovers is None
                              else max(0, int(max_failovers)))
        self.prefix_bonus_weight = float(prefix_bonus_weight)
        self._log = log
        self._lock = threading.Lock()
        self._closing = False
        self._reloading = False
        self.failovers = 0
        self.retries_exhausted = 0
        self.reloads = 0
        for rep in self.replicas:
            rep.supervisor.on_dead = (
                lambda error, rid=rep.id: self._on_replica_dead(rid, error))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Router":
        for rep in self.replicas:
            rep.supervisor.start()
        return self

    def close(self, drain_deadline_s: float = 300.0) -> bool:
        """Stop every replica's driver and drain it (answer in-flight,
        fail queued typed). A replica whose driver is WEDGED past the
        deadline gets its thread stacks dumped (per-replica evidence)
        and its requests failed typed without touching its engine.
        Returns True when every replica drained cleanly."""
        with self._lock:
            self._closing = True
        clean = True
        for rep in self.replicas:
            if rep.supervisor.stop(join_timeout_s=drain_deadline_s):
                rep.scheduler.shutdown(finish_running=True,
                                       deadline_s=drain_deadline_s)
                rep.scheduler.engine.close()
            else:
                clean = False
                sys.stderr.write(dump_thread_stacks(
                    f"gym_tpu_torch.serve: router — replica {rep.id} driver "
                    f"wedged past the {drain_deadline_s:.0f}s drain "
                    f"deadline:"))
                sys.stderr.flush()
                # flag writes only — never step a wedged engine from
                # another thread; blocked handlers still get answers
                rep.scheduler.shutdown(finish_running=False,
                                       deadline_s=0.0)
        return clean

    def _on_replica_dead(self, rid: int, error: BaseException) -> None:
        # health is derived from supervisor.failed (already set when
        # this fires); the hook exists for the log line and so tests can
        # observe the exact moment a replica left dispatch
        self._log(f"gym_tpu_torch.serve: router — replica {rid} declared dead "
                  f"({type(error).__name__}: {error}); excluded from "
                  f"dispatch", flush=True)

    # -- dispatch ---------------------------------------------------------

    def _score(self, rep: Replica, prompt: np.ndarray,
               sp: SamplingParams,
               slo_class: Optional[str] = None) -> float:
        """Lower = better: committed backlog tokens minus the resident
        shared-prefix bonus (tokens of prefill work the replica's paged
        cache would elide). The probe reads allocator state owned by the
        replica's driver thread — it is ADVISORY, so a racing mutation
        degrades to bonus 0, never to a failed dispatch.

        Class-aware: when the replica can PREEMPT, backlog
        belonging to strictly lower-priority classes barely counts
        against a more urgent request — a batch flood parked on one
        replica must not strand interactive traffic fleet-wide when
        that replica would simply park the batch decode. Without
        preemption the full backlog is the honest wait, so no discount.
        """
        sched = rep.scheduler
        load = float(sched.backlog_tokens())
        pri = CLASS_PRIORITY.get(slo_class) if slo_class else None
        if pri is not None and getattr(sched, "preempt", False):
            try:
                lower = sum(
                    tok for cls, tok in
                    sched.backlog_tokens_by_class().items()
                    if CLASS_PRIORITY.get(cls, 1) > pri)
                load -= 0.75 * lower
            except Exception:  # noqa: BLE001 — advisory, like the probe
                pass
        bonus = 0.0
        try:
            eng = sched.engine
            if getattr(eng, "paged", False):
                bonus = (eng.admit_probe(prompt, sp)[1] * eng.page_size
                         * self.prefix_bonus_weight)
        except Exception:  # noqa: BLE001 — cross-thread probe race:
            bonus = 0.0    # stickiness lost for one pick, nothing else
        return load - bonus

    def _candidates(self, prompt: np.ndarray, sp: SamplingParams,
                    exclude: Tuple[int, ...] = (),
                    slo_class: Optional[str] = None) -> List[Replica]:
        alive = [r for r in self.replicas
                 if not r.dead and r.id not in exclude]
        ready = [r for r in alive if not r.draining]
        # a fully-draining fleet (rolling reload on N=1) still ACCEPTS:
        # requests queue on the paused scheduler and admit onto the new
        # engine — that is what makes the swap zero-downtime at N=1
        pool = ready or alive
        return sorted(pool,
                      key=lambda r: (self._score(r, prompt, sp,
                                                 slo_class), r.id))

    def submit(self, prompt, sampling: Optional[SamplingParams] = None,
               block: bool = True, timeout: Optional[float] = 30.0,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None,
               slo_class: Optional[str] = None) -> FleetRequest:
        """Dispatch to the best healthy replica. Same contract as
        ``Scheduler.submit`` (typed ``ValueError`` for bad requests,
        ``AdmissionRejectedError``/``QueueFullError`` backpressure,
        deadline caps the queue-full wait) plus
        ``NoHealthyReplicaError`` when the whole fleet is dead.
        ``tenant``/``slo_class`` ride through to the replica scheduler
        (quotas, weighted-fair queuing, preemption priority)."""
        sampling = sampling or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        t_entry = time.perf_counter()
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(
                f"deadline_s must be > 0 (got {deadline_s}); omit it for "
                f"no deadline")
        cap = timeout
        if deadline_s is not None:
            cap = deadline_s if cap is None else min(cap, deadline_s)
        wait_deadline = None if cap is None else t_entry + cap
        fr = FleetRequest(self, prompt, sampling, deadline_s, t_entry,
                          tenant=tenant, slo_class=slo_class)
        fr._inner, fr.replica_id = self._dispatch(
            prompt, sampling, deadline_s, exclude=(), block=block,
            wait_deadline=wait_deadline, tenant=tenant,
            slo_class=slo_class)
        return fr

    def _dispatch(self, prompt: np.ndarray, sampling: SamplingParams,
                  deadline_s: Optional[float],
                  exclude: Tuple[int, ...], block: bool,
                  wait_deadline: Optional[float],
                  tenant: Optional[str] = None,
                  slo_class: Optional[str] = None
                  ) -> Tuple[Request, int]:
        """Try candidates best-first; degrade typed. ``exclude`` is a
        PREFERENCE (a failover avoids the replica that just failed it)
        — when exclusion empties the pool it is lifted rather than
        refusing a dispatch a live replica could serve."""
        while True:
            with self._lock:
                if self._closing:
                    raise SchedulerClosedError(
                        "router shutting down — request not dispatched")
            cands = self._candidates(prompt, sampling, exclude,
                                     slo_class)
            if not cands and exclude:
                cands = self._candidates(prompt, sampling, (),
                                         slo_class)
            if not cands:
                raise NoHealthyReplicaError(
                    f"all {len(self.replicas)} replica(s) are dead — "
                    f"fleet unrecoverable without a restart")
            rejects: List[AdmissionRejectedError] = []
            full = closing = 0
            for rep in cands:
                try:
                    req = rep.scheduler.submit(
                        prompt, sampling, block=False,
                        deadline_s=deadline_s, tenant=tenant,
                        slo_class=slo_class)
                    return req, rep.id
                except AdmissionRejectedError as e:
                    rejects.append(e)
                except QueueFullError:
                    full += 1
                except SchedulerClosedError:
                    closing += 1    # replica died between the pick and
                    #                 the submit (its scheduler refuses
                    #                 before `failed` is set); the next
                    #                 loop re-derives health
                # ValueError (bad request) propagates: every replica
                # runs the same config, no sibling would accept it
            if rejects and not full:
                # every live replica's admission control says the
                # deadline is infeasible: fleet-level shed, cheapest
                # retry hint wins
                raise min(rejects, key=lambda e: e.retry_after_s)
            if not block and full:
                raise QueueFullError(
                    f"every replica's queue is at capacity")
            if not block:
                # nothing was full — every candidate was mid-death: a
                # health signal (503 + retry), not a backpressure one
                raise NoHealthyReplicaError(
                    f"every dispatchable replica is shutting down or "
                    f"being declared dead", retry_after_s=1.0)
            rem = (None if wait_deadline is None
                   else wait_deadline - time.perf_counter())
            if rem is not None and rem <= 0:
                if full:
                    raise QueueFullError(
                        f"every replica's queue still at capacity after "
                        f"the submit wait")
                raise NoHealthyReplicaError(
                    f"every dispatchable replica still shutting down or "
                    f"being declared dead after the submit wait",
                    retry_after_s=1.0)
            time.sleep(min(0.02, rem) if rem is not None else 0.02)

    # -- result wait + failover -------------------------------------------

    def _await(self, fr: FleetRequest,
               timeout: Optional[float]) -> List[int]:
        wait_deadline = (None if timeout is None
                         else time.perf_counter() + timeout)
        while True:
            rem = (None if wait_deadline is None
                   else max(0.0, wait_deadline - time.perf_counter()))
            try:
                return fr._inner.result(rem)
            except (EngineFailedError, SchedulerClosedError) as e:
                self._failover_redispatch(fr, e, wait_deadline)

    def _failover_redispatch(self, fr: FleetRequest, e: BaseException,
                             wait_deadline: Optional[float]) -> None:
        """The shared failover step (``result`` and ``stream`` both land
        here when the serving replica dies): re-dispatch to a sibling
        under the request's REMAINING deadline, bounded by the retry
        budget — or re-raise the triggering failure typed."""
        with self._lock:
            closing = self._closing
        if closing:
            raise e
        if fr.failovers >= self.max_failovers:
            if self.max_failovers:
                with self._lock:
                    self.retries_exhausted += 1
                self._log(
                    f"gym_tpu_torch.serve: router — request {fr.id} "
                    f"exhausted its {self.max_failovers} "
                    f"failover retr"
                    f"{'y' if self.max_failovers == 1 else 'ies'}"
                    f"; surfacing {type(e).__name__}", flush=True)
            raise e
        # satellite: forward the REMAINING deadline, anchored at
        # the fleet submit entry — a retried request can never
        # wait two full deadlines
        rem_dl = None
        if fr.deadline_s is not None:
            rem_dl = (fr.deadline_s
                      - (time.perf_counter() - fr.submit_t))
            if rem_dl <= 0:
                raise DeadlineExceededError(
                    f"deadline_s={fr.deadline_s:.3g} exhausted "
                    f"during replica failover — not retried"
                ) from e
        failed_rid = fr.replica_id
        # a failed dispatch here degrades typed (all dead → 503,
        # sibling sheds the remaining deadline → 429, …): the
        # client gets the fleet's honest answer, chained to the
        # failure that triggered the retry
        inner, rid = self._dispatch(
            fr.prompt, fr.sampling, rem_dl,
            exclude=(failed_rid,), block=True,
            wait_deadline=wait_deadline, tenant=fr.tenant,
            slo_class=fr.slo_class)
        fr.failovers += 1
        with self._lock:
            self.failovers += 1
        fr._inner, fr.replica_id = inner, rid
        self._log(
            f"gym_tpu_torch.serve: router — failover: request retried "
            f"on replica {rid} (replica {failed_rid} failed it: "
            f"{type(e).__name__}; retry {fr.failovers}/"
            f"{self.max_failovers}"
            + (f", {rem_dl:.3g}s of deadline left)"
               if rem_dl is not None else ")"), flush=True)

    # -- zero-downtime weight hot-swap -------------------------------------

    def reload(self, params: PyTree, *, weights_tag: Optional[str] = None,
               drain_timeout_s: float = 300.0) -> Dict[str, Any]:
        """Roll ``params`` through the fleet one replica at a time with
        ZERO dropped requests: pause the replica's admission + stop
        dispatching to it, wait for its in-flight requests to finish,
        build its new engine from the updated params box (the factory
        captures its graphs), swap, close the old engine, resume. Dead replicas are skipped (a later supervisor rebuild
        would use the new params anyway — the box is already updated).
        Serialized: a second concurrent reload raises
        ``FleetReloadError`` instead of interleaving two rollouts."""
        with self._lock:
            if self._closing:
                raise SchedulerClosedError(
                    "router shutting down — reload refused")
            if self._reloading:
                raise FleetReloadError(
                    "a weight reload is already in progress")
            self._reloading = True
        t0 = time.perf_counter()
        swapped: List[int] = []
        skipped: List[int] = []
        try:
            # box first: any failover rebuild from here on — including
            # on replicas not yet reached — already serves the new
            # weights (its in-flight died with the old engine regardless)
            self.params_box["params"] = params
            if weights_tag is not None:
                self.params_box["tag"] = weights_tag
            for rep in self.replicas:
                if rep.dead:
                    skipped.append(rep.id)
                    continue
                rep.draining = True
                rep.scheduler.pause_admission()
                try:
                    deadline = time.perf_counter() + drain_timeout_s
                    while rep.scheduler.inflight() and not rep.dead:
                        if time.perf_counter() > deadline:
                            raise FleetReloadError(
                                f"replica {rep.id} did not drain within "
                                f"{drain_timeout_s:.0f}s — rolling "
                                f"reload aborted (replicas {swapped} "
                                f"already swapped, {skipped} skipped)",
                                retry_after_s=max(5.0, drain_timeout_s))
                        time.sleep(0.002)
                    if rep.dead:
                        skipped.append(rep.id)
                        continue
                    engine = rep.engine_factory()
                    old = rep.scheduler.engine
                    rep.scheduler.replace_engine(engine)
                    old.close()
                    if rep.metrics is not None:
                        rep.metrics.engine_reloaded()
                    swapped.append(rep.id)
                finally:
                    rep.scheduler.resume_admission()
                    rep.draining = False
            with self._lock:
                self.reloads += 1
            wall = time.perf_counter() - t0
            self._log(
                f"gym_tpu_torch.serve: router — weight reload "
                f"{'(' + str(self.params_box.get('tag')) + ') ' if self.params_box.get('tag') else ''}"
                f"rolled through replicas {swapped} in {wall:.2f}s"
                + (f" (skipped dead: {skipped})" if skipped else ""),
                flush=True)
            return {"swapped": swapped, "skipped": skipped,
                    "weights_tag": self.params_box.get("tag"),
                    "wall_s": round(wall, 3)}
        finally:
            with self._lock:
                self._reloading = False

    # -- observability -----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        reps = []
        for rep in self.replicas:
            eng = rep.scheduler.engine
            entry = {
                "id": rep.id,
                "healthy": rep.healthy,
                "dead": rep.dead,
                "draining": rep.draining,
                "restarts": rep.supervisor.restarts,
                "engine_generation": rep.supervisor.generation,
                "queue_depth": rep.scheduler.queue_depth(),
                "active_requests": rep.scheduler.active_requests(),
                "backlog_tokens": rep.scheduler.backlog_tokens(),
                "weights_tag": getattr(eng, "weights_tag", None),
            }
            if rep.metrics is not None:
                entry["tokens_per_s_ewma"] = rep.metrics.tokens_per_s_ewma()
            reps.append(entry)
        with self._lock:
            return {
                "replicas": reps,
                "healthy_replicas": sum(1 for r in reps if r["healthy"]),
                "failovers": self.failovers,
                "retries_exhausted": self.retries_exhausted,
                "weight_reloads": self.reloads,
                "weights_tag": self.params_box.get("tag"),
            }


def build_fleet(params: PyTree, config, *, replicas: int = 1,
                num_slots: int = 4, decode_chunk: int = 1,
                paged: bool = False, page_size: int = 16,
                kv_pages: Optional[int] = None, spec_tokens: int = 0,
                max_queue: int = 64, metrics=None,
                dispatch_timeout_s: float = 120.0, max_restarts: int = 5,
                max_failovers: Optional[int] = None,
                weights_tag: Optional[str] = None,
                prefix_bonus_weight: float = 1.0,
                quotas: Optional[Dict[str, Any]] = None,
                preempt: bool = False, device="cuda",
                warm_rebuilds: bool = True, log=print) -> Router:
    """Construct a ``Router`` over N identical in-process replica
    stacks sharing one params tree and one metrics collector (each
    replica writes through its ``replica_view``). Supervisors are NOT
    started — call ``router.start()``. With ``replicas=1`` and the
    default retry budget (0), the stack behaves exactly like the
    single-engine server. ``warm_rebuilds``: an engine the factory builds
    later (a supervisor rebuild, a hot swap) captures its whole program
    family before it serves; the first engines are warmed by the
    caller's background warmup. ``device`` is every engine's."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    box: Dict[str, Any] = {"params": params, "tag": weights_tag}
    reps: List[Replica] = []
    for rid in range(int(replicas)):
        view = (metrics.replica_view(rid)
                if metrics is not None else None)

        def make_engine():
            return InferenceEngine(
                box["params"], config, num_slots=num_slots,
                decode_chunk=decode_chunk, paged=paged,
                page_size=page_size, kv_pages=kv_pages,
                spec_tokens=spec_tokens, weights_tag=box.get("tag"),
                device=device)

        def factory():
            engine = make_engine()
            if warm_rebuilds:
                warm_engine_programs(engine, start=False).run()
            return engine

        sched = Scheduler(make_engine(), max_queue=max_queue, metrics=view,
                          quotas=quotas, preempt=preempt)
        sup = Supervisor(sched, factory,
                         dispatch_timeout_s=dispatch_timeout_s,
                         max_restarts=max_restarts, metrics=view, log=log)
        reps.append(Replica(id=rid, scheduler=sched, supervisor=sup,
                            engine_factory=factory, metrics=view))
    return Router(reps, metrics=metrics, max_failovers=max_failovers,
                  params_box=box, prefix_bonus_weight=prefix_bonus_weight,
                  log=log)
