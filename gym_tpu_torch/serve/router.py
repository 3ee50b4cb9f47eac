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

The out-of-process fleet below (``WorkerSpawner``, ``ProcessReplica``,
``ProcRequest``, ``ProcessRouter``, ``build_process_fleet``; the JAX
router's second half) runs each replica as a worker subprocess
(``serve/worker.py``) over a local socket, with a ``kill -9``'d worker's
streams spliced onto a sibling byte for byte; ``serve/autoscale.py``
drives it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import os
import queue
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..programs import warm_engine_programs
from ..utils.resilience import dump_thread_stacks
from . import wire
from .engine import InferenceEngine, SamplingParams
from .scheduler import (CLASS_PRIORITY, AdmissionRejectedError,
                        DeadlineExceededError, EngineFailedError,
                        QueueFullError, Request, RequestCancelledError,
                        RequestStatus, Scheduler, SchedulerClosedError)
from .load import config_to_json, dump_params_snapshot
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


# ==========================================================================
# Out-of-process fleet: subprocess replicas behind the same dispatch
# semantics, spoken over local sockets
# ==========================================================================
#
# The in-process ``Router`` above shares one GIL, one CUDA context and one
# failure domain across N replicas. The classes below
# move each replica into a real subprocess (``serve/worker.py``) behind
# a THIN dispatcher: one asyncio event loop (a single background
# thread) multiplexes every worker connection — health ticks, submits,
# token-chunk streams — while synchronous callers (the HTTP handler
# threads) interact through per-request queues. Same health/failover
# protocol as the in-process router: least-loaded dispatch from
# worker-reported backlog, dead replicas out of dispatch the moment
# their connection drops, bounded failover under the REMAINING
# deadline — upgraded to STREAMING: a replica killed mid-stream has its
# request re-dispatched with the already-delivered tokens as a
# ``prefix`` the sibling re-derives (deterministic engine), verifies,
# and suppresses, so the concatenated client stream is byte-identical
# to an uncontended run.


class WorkerSpawner:
    """Launches ``python -m gym_tpu_torch.serve.worker`` subprocesses
    sharing one params/config snapshot. The snapshot is materialized ONCE
    into ``base_dir`` (``load.dump_params_snapshot`` + the config as JSON:
    one checkpoint restore, and under ``--quant`` one quantization, in the
    parent, N cheap loads in the workers); alternatively ``ckpt`` makes
    each worker restore the run dir itself. Worker stdout/stderr land in
    ``base_dir/worker-<rid>.log``.

    ``device``: every worker's (the card by default; ``"cpu"`` for tests).
    On the card the parent builds the kernel library into
    ``program_cache_dir`` (default: this process's build directory, which
    it becomes) before the first spawn, with ``nvcc`` alone and no CUDA
    context, and hands every worker that directory: N workers starting
    together on a cold directory would each run the compilers, and a
    worker (a respawn too) reports ``programs_compiled`` 0 against it.
    Without a card a fleet on the card raises; it never falls back to the
    CPU."""

    def __init__(self, base_dir: str, *, params: Any = None,
                 config: Any = None, ckpt: Optional[str] = None,
                 step: Optional[int] = None,
                 config_path: Optional[str] = None,
                 num_slots: int = 4, decode_chunk: int = 1,
                 page_size: int = 16, kv_pages: Optional[int] = None,
                 spec_tokens: int = 0, max_queue: int = 64,
                 dispatch_timeout_s: float = 120.0,
                 max_restarts: int = 5,
                 program_cache_dir: Optional[str] = None,
                 weights_tag: Optional[str] = None,
                 no_warmup: bool = False, device: str = "cuda",
                 env: Optional[Dict[str, str]] = None,
                 quotas_json: Optional[str] = None,
                 preempt: bool = False):
        self.base_dir = os.path.abspath(base_dir)
        os.makedirs(self.base_dir, exist_ok=True)
        self.params_file: Optional[str] = None
        self.config_file: Optional[str] = None
        self.ckpt, self.step, self.config_path = ckpt, step, config_path
        if params is not None:
            if config is None:
                raise ValueError("params without config — the worker "
                                 "needs both")
            self.params_file = dump_params_snapshot(
                params, os.path.join(self.base_dir, "params.pkl"))
            self.config_file = config_to_json(
                config, os.path.join(self.base_dir, "config.json"))
        elif ckpt is None:
            raise ValueError(
                "WorkerSpawner needs params+config or a ckpt run dir")
        self.num_slots = int(num_slots)
        self.decode_chunk = int(decode_chunk)
        self.page_size = int(page_size)
        self.kv_pages = kv_pages
        self.spec_tokens = int(spec_tokens)
        self.max_queue = int(max_queue)
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.max_restarts = int(max_restarts)
        self.device = str(device)
        if self.device != "cpu":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"a fleet on device={self.device!r} needs a CUDA card "
                    f"and none was found; pass device='cpu' to serve on "
                    f"the CPU")
            from ..ops import _build
            if program_cache_dir:
                _build.use_build_dir(program_cache_dir)
            program_cache_dir = os.path.dirname(_build.build())
        self.program_cache_dir = program_cache_dir
        self.weights_tag = weights_tag
        self.no_warmup = bool(no_warmup)
        self.env = dict(env or {})
        self.quotas_json = quotas_json
        self.preempt = bool(preempt)
        self._reload_seq = itertools.count()

    def reload_file(self, params: Any,
                    tag: Optional[str] = None) -> str:
        """A fresh params snapshot for a rolling reload (sequence-
        numbered: an in-flight worker read of the PREVIOUS snapshot
        must never race an overwrite)."""
        name = f"reload-{next(self._reload_seq)}"
        if tag:
            name += f"-{str(tag).replace(os.sep, '_')[:40]}"
        return dump_params_snapshot(
            params, os.path.join(self.base_dir, name + ".pkl"))

    def sock_path(self, rid: int) -> str:
        path = os.path.join(self.base_dir, f"w{rid}.sock")
        if len(os.fsencode(path)) > 107:
            raise ValueError(
                f"socket path {path} is longer than an AF_UNIX address "
                f"holds (107 bytes): give the fleet a shorter base_dir")
        return path

    def spawn(self, rid: int) -> Tuple[subprocess.Popen, str, str]:
        """Start worker ``rid``; returns ``(proc, socket_path,
        log_path)``. The caller owns the connect-and-wait."""
        sock = self.sock_path(rid)
        try:
            os.unlink(sock)
        except FileNotFoundError:
            pass
        log_path = os.path.join(self.base_dir, f"worker-{rid}.log")
        cmd = [sys.executable, "-m", "gym_tpu_torch.serve.worker",
               "--socket", sock, "--replica-id", str(rid),
               "--num_slots", str(self.num_slots),
               "--decode_chunk", str(self.decode_chunk),
               "--page_size", str(self.page_size),
               "--spec_tokens", str(self.spec_tokens),
               "--max_queue", str(self.max_queue),
               "--dispatch-timeout", str(self.dispatch_timeout_s),
               "--max-restarts", str(self.max_restarts)]
        if self.kv_pages is not None:
            cmd += ["--kv_pages", str(self.kv_pages)]
        if self.params_file:
            cmd += ["--params-file", self.params_file,
                    "--config-json", self.config_file]
        else:
            cmd += ["--ckpt", self.ckpt]
            if self.step is not None:
                cmd += ["--step", str(self.step)]
            if self.config_path:
                cmd += ["--config", self.config_path]
        if self.program_cache_dir:
            cmd += ["--program-cache-dir", self.program_cache_dir]
        if self.weights_tag:
            cmd += ["--weights-tag", str(self.weights_tag)]
        if self.no_warmup:
            cmd += ["--no-warmup"]
        if self.quotas_json:
            cmd += ["--quotas-json", self.quotas_json]
        if self.preempt:
            cmd += ["--preempt"]
        cmd += ["--device", self.device]
        env = dict(os.environ)
        env.update(self.env)
        # the worker must import gym_tpu_torch exactly as this process does
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(
                                 os.pathsep)
        with open(log_path, "ab") as logf:
            proc = subprocess.Popen(cmd, stdout=logf, stderr=logf,
                                    env=env)
        return proc, sock, log_path


class ProcessReplica:
    """Router-side handle on one worker subprocess: the Popen, the
    socket, the last health report, and the router's own committed-
    token accounting (health reports lag; the local add keeps
    least-loaded dispatch responsive between ticks)."""

    def __init__(self, rid: int, proc: Optional[subprocess.Popen],
                 sock_path: str, log_path: str):
        self.id = int(rid)
        self.proc = proc
        self.sock_path = sock_path
        self.log_path = log_path
        self.pid: Optional[int] = proc.pid if proc is not None else None
        self.connected = False
        self.dead = False
        self.draining = False
        self.retired = False
        self.death_reason: Optional[str] = None
        self.last_health: Dict[str, Any] = {}
        self.inflight_tokens = 0
        # (accept time, committed tokens) of requests the worker has
        # ACCEPTED but whose tokens may predate the last health report:
        # expired against health ticks so a request is never counted
        # both locally and in the worker-reported backlog
        self._accepts: List[Tuple[float, int]] = []
        self.writer: Any = None

    @property
    def healthy(self) -> bool:
        return (self.connected and not self.dead
                and not self.draining and not self.retired)

    def load(self) -> float:
        return (float(self.last_health.get("backlog_tokens", 0) or 0)
                + self.inflight_tokens)

    def load_for(self, slo_class: Optional[str]) -> float:
        """Class-aware dispatch load: when the worker can
        PREEMPT, backlog belonging to strictly lower-priority classes
        barely counts against a more urgent request — the in-process
        ``Router._score`` discount, read off the health report."""
        load = self.load()
        pri = CLASS_PRIORITY.get(slo_class) if slo_class else None
        if pri is None or not self.last_health.get("preempt"):
            return load
        by_cls = self.last_health.get("backlog_by_class") or {}
        lower = sum(float(tok or 0) for cls, tok in by_cls.items()
                    if CLASS_PRIORITY.get(cls, 1) > pri)
        return load - 0.75 * lower


class ProcRequest:
    """Process-fleet request handle — the same wait surface as
    ``FleetRequest`` (``result``/``stream``/``tokens``/``ttft_s``/
    ``done_t``/``replica_id``/``failovers``) fed by wire frames instead
    of a shared-memory ``Request``. ``tokens`` holds exactly what was
    delivered to the caller, across failovers — the splice invariant's
    source of truth."""

    def __init__(self, router: "ProcessRouter", prompt: np.ndarray,
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
        self.tokens: List[int] = []
        self.failovers = 0
        self.replica_id = -1
        self.pid: Optional[int] = None
        self.id: Optional[int] = None        # wire id, current attempt
        self._rep: Optional[ProcessReplica] = None
        self._q: "queue.Queue" = queue.Queue()
        self.first_chunk_t: Optional[float] = None
        self.done_t: Optional[float] = None
        self.done_frame: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.exception: Optional[BaseException] = None
        self.streaming = True
        self.coalesce_s: Optional[float] = None
        self._finished = False

    @property
    def ttft_s(self) -> Optional[float]:
        """Client-observable time to first token (= first streamed
        chunk), anchored at the fleet submit entry — for a spliced
        request this is the FIRST attempt's first chunk, honestly.
        Result-only requests (no chunk frames) fall back to the
        worker-reported first-token time."""
        if self.first_chunk_t is not None:
            return self.first_chunk_t - self.submit_t
        if self.done_frame is not None:
            return self.done_frame.get("ttft_s")
        return None

    @property
    def avg_token_latency_s(self) -> Optional[float]:
        if (self.done_t is None or self.first_chunk_t is None
                or len(self.tokens) < 2):
            return None
        return ((self.done_t - self.first_chunk_t)
                / (len(self.tokens) - 1))

    def stream(self, timeout: Optional[float] = None):
        """Yield lists of NEW tokens as chunk frames arrive; failover
        splices transparently (see ``ProcessRouter._stream``)."""
        return self._router._stream(self, timeout)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        for _ in self._router._stream(self, timeout):
            pass
        return list(self.tokens)

    def cancel(self, reason: str = "client disconnected") -> bool:
        return self._router._cancel(self, reason)


class ProcessRouter:
    """Dispatcher over N worker subprocesses. One asyncio loop thread
    owns every worker connection (connects, reads frames, health
    ticks); synchronous callers submit and consume through thread-safe
    queues — the ``Router`` dispatch/failover/degradation semantics,
    spoken over sockets, with token streaming end to end."""

    kind = "process"

    def __init__(self, spawner: WorkerSpawner, *, replicas: int = 2,
                 metrics=None, max_failovers: Optional[int] = None,
                 health_interval_s: float = 0.5,
                 connect_timeout_s: float = 240.0,
                 submit_ack_timeout_s: float = 30.0, log=print):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.spawner = spawner
        self.metrics = metrics
        self._want = int(replicas)
        self.max_failovers = (min(2, self._want - 1)
                              if max_failovers is None
                              else max(0, int(max_failovers)))
        self.health_interval_s = float(health_interval_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.submit_ack_timeout_s = float(submit_ack_timeout_s)
        self._log = log
        self._lock = threading.Lock()
        self._closing = False
        self._reloading = False
        self.failovers = 0
        self.retries_exhausted = 0
        self.reloads = 0
        self.replicas_spawned = 0
        self.replicas_retired = 0
        self.replicas: List[ProcessReplica] = []
        self._rids = itertools.count()
        self._ids = itertools.count(1)
        self._pending: Dict[int, Tuple["queue.Queue",
                                       ProcessReplica]] = {}
        self._weights_tag = spawner.weights_tag
        self._loop = asyncio.new_event_loop()
        self._loop_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ProcessRouter":
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="gym-tpu-torch-proc-router",
            daemon=True)
        self._loop_thread.start()
        for _ in range(self._want):
            self.scale_up()
        return self

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.run_forever()
        # drain cancelled callbacks so close() leaves nothing running
        pending = asyncio.all_tasks(self._loop)
        for t in pending:
            t.cancel()
        if pending:
            self._loop.run_until_complete(
                asyncio.gather(*pending, return_exceptions=True))
        self._loop.close()

    def wait_ready(self, n: Optional[int] = None,
                   timeout_s: float = 240.0) -> bool:
        """Block until ``n`` (default: all requested) replicas are
        connected and healthy. Raises ``NoHealthyReplicaError`` when
        every spawned worker died instead (startup crash — the worker
        logs carry the traceback)."""
        want = self._want if n is None else int(n)
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            with self._lock:
                live = [r for r in self.replicas if not r.retired]
                up = sum(1 for r in live if r.healthy)
                all_dead = bool(live) and all(r.dead for r in live)
            if up >= want:
                return True
            if all_dead:
                raise NoHealthyReplicaError(
                    f"every spawned worker died during startup — see "
                    f"worker logs under {self.spawner.base_dir}")
            time.sleep(0.1)
        raise NoHealthyReplicaError(
            f"fleet not ready ({want} replicas) after {timeout_s:.0f}s "
            f"— see worker logs under {self.spawner.base_dir}")

    def scale_up(self) -> ProcessReplica:
        """Spawn one more worker process and connect to it (async; use
        ``wait_ready`` to block on health). The autoscaler's up-arrow
        AND the respawn path for killed workers."""
        with self._lock:
            if self._closing:
                raise SchedulerClosedError(
                    "router shutting down — not spawning")
            rid = next(self._rids)
        proc, sock, log_path = self.spawner.spawn(rid)
        rep = ProcessReplica(rid, proc, sock, log_path)
        with self._lock:
            self.replicas.append(rep)
            self.replicas_spawned += 1
        if self.metrics is not None:
            self.metrics.replica_spawned(replica_id=rid, pid=rep.pid)
        asyncio.run_coroutine_threadsafe(self._connect(rep), self._loop)
        self._log(f"gym_tpu_torch.serve: proc-router — spawned replica {rid} "
                  f"(pid {rep.pid}, {os.path.basename(sock)})",
                  flush=True)
        return rep

    def scale_down(self, drain_timeout_s: float = 60.0
                   ) -> Optional[ProcessReplica]:
        """Retire the newest healthy replica (drain, stop, reap) — the
        autoscaler's down-arrow. Refuses to go below one healthy
        replica. Returns the retired replica, or None."""
        with self._lock:
            cands = [r for r in self.replicas if r.healthy]
            if len(cands) <= 1:
                return None
            rep = max(cands, key=lambda r: r.id)
            rep.draining = True
        deadline = time.perf_counter() + drain_timeout_s
        while time.perf_counter() < deadline:
            with self._lock:
                busy = any(r is rep for _, r in self._pending.values())
            if not busy:
                break
            time.sleep(0.05)
        self._stop_worker(rep, graceful=True,
                          timeout_s=max(5.0, drain_timeout_s))
        with self._lock:
            rep.retired = True
            rep.connected = False
            self.replicas_retired += 1
        if self.metrics is not None:
            self.metrics.replica_retired(replica_id=rep.id, pid=rep.pid)
        self._log(f"gym_tpu_torch.serve: proc-router — retired replica "
                  f"{rep.id} (pid {rep.pid})", flush=True)
        return rep

    def _stop_worker(self, rep: ProcessReplica, graceful: bool,
                     timeout_s: float = 15.0) -> bool:
        """Stop one worker and REAP it (no zombies): stop frame →
        wait → SIGTERM → wait → SIGKILL → wait."""
        proc = rep.proc
        if graceful and rep.connected:
            try:
                self._send(rep, {"type": "stop",
                                 "id": next(self._ids)}, timeout=5.0)
            except Exception:  # noqa: BLE001 — fall through to signals
                pass
        if proc is None:
            return True
        try:
            proc.wait(timeout=timeout_s)
            return True
        except subprocess.TimeoutExpired:
            pass
        proc.terminate()
        try:
            proc.wait(timeout=10.0)
            return True
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10.0)
            return False

    def close(self, drain_deadline_s: float = 300.0) -> bool:
        """Stop every worker (graceful drain where the worker is still
        healthy), fail still-pending requests typed, reap every child,
        stop the event loop."""
        with self._lock:
            if self._closing:
                return True
            self._closing = True
        clean = True
        live = [r for r in self.replicas if not r.retired]
        # broadcast the stop frames FIRST so every worker drains
        # CONCURRENTLY — then reap under one shared deadline; a serial
        # stop-and-wait would multiply the drain bound by the fleet size
        for rep in live:
            if not rep.dead and rep.connected:
                try:
                    self._send(rep, {"type": "stop",
                                     "id": next(self._ids)},
                               timeout=5.0)
                except Exception:  # noqa: BLE001 — signals below
                    pass
        overall = time.perf_counter() + drain_deadline_s
        for rep in live:
            rem = max(5.0, overall - time.perf_counter())
            try:
                ok = self._stop_worker(
                    rep, graceful=False,   # stop already broadcast
                    timeout_s=(rem if not rep.dead else 5.0))
                clean = clean and ok
            except Exception:  # noqa: BLE001 — keep reaping siblings
                clean = False
        with self._lock:
            pend = list(self._pending.items())
            self._pending.clear()
        for wid, (q, _rep) in pend:
            q.put({"type": "error", "id": wid,
                   "error_type": "SchedulerClosedError",
                   "message": "router shutting down"})
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
        except RuntimeError:
            pass
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)
        return clean

    # -- async plumbing (loop thread) --------------------------------------

    async def _read_one(self, reader) -> Dict[str, Any]:
        return await wire.read_frame_async(reader)

    async def _connect(self, rep: ProcessReplica) -> None:
        deadline = self._loop.time() + self.connect_timeout_s
        reader = writer = None
        while True:
            if rep.proc is not None and rep.proc.poll() is not None:
                self._mark_dead(
                    rep, f"worker exited rc={rep.proc.returncode} "
                         f"during startup (log: {rep.log_path})")
                return
            try:
                reader, writer = await asyncio.open_unix_connection(
                    rep.sock_path)
                break
            except (FileNotFoundError, ConnectionRefusedError,
                    OSError):
                if self._loop.time() > deadline:
                    self._mark_dead(
                        rep, f"no socket after "
                             f"{self.connect_timeout_s:.0f}s")
                    return
                await asyncio.sleep(0.2)
        try:
            hello = await asyncio.wait_for(self._read_one(reader),
                                           timeout=60.0)
        except Exception as e:  # noqa: BLE001 — handshake failed
            self._mark_dead(rep, f"handshake failed: {e}")
            writer.close()
            return
        rep.writer = writer
        rep.pid = int(hello.get("pid", rep.pid or -1))
        rep.last_health = hello
        rep.connected = True
        self._log(f"gym_tpu_torch.serve: proc-router — replica {rep.id} "
                  f"connected (pid {rep.pid})", flush=True)
        self._loop.create_task(self._reader_loop(rep, reader))
        self._loop.create_task(self._health_loop(rep))

    async def _reader_loop(self, rep: ProcessReplica, reader) -> None:
        try:
            while True:
                frame = await self._read_one(reader)
                ftype = frame.get("type")
                if ftype in ("health_ok", "hello", "stats_ok"):
                    rep.last_health = frame
                    # accepted requests older than one health interval
                    # are reflected in this report's backlog_tokens —
                    # drop their local add (no double count)
                    now = time.perf_counter()
                    with self._lock:
                        keep = []
                        for t, committed in rep._accepts:
                            if now - t > self.health_interval_s:
                                rep.inflight_tokens = max(
                                    0, rep.inflight_tokens - committed)
                            else:
                                keep.append((t, committed))
                        rep._accepts = keep
                    if frame.get("dead"):
                        self._mark_dead(
                            rep, "worker engine unrecoverable "
                                 "(supervisor gave up)")
                if "id" in frame and frame.get("id") is not None:
                    with self._lock:
                        entry = self._pending.get(frame["id"])
                    if entry is not None:
                        entry[0].put(frame)
        except (asyncio.IncompleteReadError, wire.WireError,
                ConnectionError, OSError) as e:
            self._mark_dead(rep, f"connection lost: "
                                 f"{type(e).__name__}: {e}")
        except asyncio.CancelledError:
            raise

    async def _health_loop(self, rep: ProcessReplica) -> None:
        while rep.connected and not rep.dead:
            try:
                await self._send_async(rep, {"type": "health"})
            except Exception:  # noqa: BLE001 — connection died
                self._mark_dead(rep, "health send failed")
                return
            await asyncio.sleep(self.health_interval_s)
            if rep.proc is not None and rep.proc.poll() is not None:
                self._mark_dead(
                    rep, f"worker process exited "
                         f"rc={rep.proc.returncode}")
                return

    async def _send_async(self, rep: ProcessReplica,
                          frame: Dict[str, Any]) -> None:
        if rep.writer is None:
            raise ConnectionError(f"replica {rep.id} not connected")
        rep.writer.write(wire.encode_frame(frame))
        await rep.writer.drain()

    def _send(self, rep: ProcessReplica, frame: Dict[str, Any],
              timeout: float = 10.0) -> None:
        fut = asyncio.run_coroutine_threadsafe(
            self._send_async(rep, frame), self._loop)
        fut.result(timeout)

    def _mark_dead(self, rep: ProcessReplica, why: str) -> None:
        """Declare one replica dead (idempotent; any thread): out of
        dispatch immediately, every pending request on it gets a typed
        engine-failure frame (the failover trigger), and the corpse is
        reaped in the background so ``kill -9`` never leaves a
        zombie."""
        with self._lock:
            if rep.dead or rep.retired:
                return
            closing = self._closing
            rep.dead = True
            rep.connected = False
            rep.death_reason = why
            victims = [(wid, q) for wid, (q, r)
                       in self._pending.items() if r is rep]
        w = rep.writer
        if w is not None:
            try:
                self._loop.call_soon_threadsafe(w.close)
            except RuntimeError:
                pass
        for wid, q in victims:
            q.put({"type": "error", "id": wid,
                   "error_type": "EngineFailedError",
                   "message": f"replica {rep.id} (pid {rep.pid}) "
                              f"lost: {why}"})
        if not closing:
            # a worker leaving DURING close() is the stop we asked for,
            # not a death worth alerting on
            self._log(f"gym_tpu_torch.serve: proc-router — replica {rep.id} "
                      f"(pid {rep.pid}) declared dead ({why}); excluded "
                      f"from dispatch", flush=True)
        if rep.proc is not None and rep.proc.poll() is None:
            threading.Thread(
                target=self._stop_worker, args=(rep, False, 5.0),
                name=f"reap-worker-{rep.id}", daemon=True).start()

    # -- dispatch ----------------------------------------------------------

    def submit(self, prompt, sampling: Optional[SamplingParams] = None,
               block: bool = True, timeout: Optional[float] = 30.0,
               deadline_s: Optional[float] = None,
               stream: bool = True,
               coalesce_s: Optional[float] = None,
               tenant: Optional[str] = None,
               slo_class: Optional[str] = None) -> ProcRequest:
        """Same contract as ``Router.submit``: typed backpressure and
        health degradation, deadline caps the dispatch wait.
        ``stream=False`` marks a result-only request: the worker skips
        per-chunk frames entirely and ships the tokens on the ``done``
        frame — per-token wire overhead drops to zero for callers that
        never wanted a stream. ``coalesce_s`` overrides the worker's
        post-first-chunk batching window (None = worker default; 0 =
        one frame per decode chunk — chaos drills use this to pin the
        kill inside the stream)."""
        sampling = sampling or SamplingParams()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        t_entry = time.perf_counter()
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(
                f"deadline_s must be > 0 (got {deadline_s}); omit it "
                f"for no deadline")
        cap = timeout
        if deadline_s is not None:
            cap = deadline_s if cap is None else min(cap, deadline_s)
        wait_deadline = None if cap is None else t_entry + cap
        pr = ProcRequest(self, prompt, sampling, deadline_s, t_entry,
                         tenant=tenant, slo_class=slo_class)
        pr.streaming = bool(stream)
        pr.coalesce_s = coalesce_s
        self._dispatch_proc(pr, deadline_s, prefix=[], exclude=(),
                            block=block, wait_deadline=wait_deadline)
        return pr

    def _dispatch_proc(self, pr: ProcRequest,
                       deadline_s: Optional[float], prefix: List[int],
                       exclude: Tuple[int, ...], block: bool,
                       wait_deadline: Optional[float]) -> None:
        sp_dict = wire.sampling_to_dict(pr.sampling)
        committed = int(pr.sampling.max_new_tokens)
        prompt_list = [int(t) for t in pr.prompt]
        while True:
            with self._lock:
                if self._closing:
                    raise SchedulerClosedError(
                        "router shutting down — request not dispatched")
                live = [r for r in self.replicas if not r.retired]
                cands = [r for r in live
                         if r.healthy and r.id not in exclude]
                if not cands and exclude:
                    cands = [r for r in live if r.healthy]
                cands.sort(key=lambda r: (r.load_for(pr.slo_class),
                                          r.id))
                n_live = len(live)
            if not cands:
                starting = any(not r.connected and not r.dead
                               and not r.retired for r in live)
                if not starting:
                    raise NoHealthyReplicaError(
                        f"all {n_live} replica(s) are dead — fleet "
                        f"unrecoverable without a respawn")
            rejects: List[AdmissionRejectedError] = []
            full = 0
            for rep in cands:
                wid = next(self._ids)
                with self._lock:
                    if not rep.healthy:
                        continue   # died/started draining since the
                        #            candidate snapshot (scale_down
                        #            race) — a stop-frame'd worker
                        #            would never ack this submit
                    self._pending[wid] = (pr._q, rep)
                    rep.inflight_tokens += committed
                frame = {"type": "submit", "id": wid,
                         "prompt": prompt_list, "sampling": sp_dict,
                         "deadline_s": deadline_s, "prefix": prefix,
                         "stream": pr.streaming,
                         "submit_timeout": max(
                             1.0, self.submit_ack_timeout_s - 5.0)}
                if pr.coalesce_s is not None:
                    frame["coalesce_s"] = float(pr.coalesce_s)
                # only when tagged: a default (single-tenant) frame
                # stays byte-identical to the pre-tenant protocol, and
                # an old worker never sees fields it would note about
                if pr.tenant is not None:
                    frame["tenant"] = str(pr.tenant)
                if pr.slo_class is not None:
                    frame["slo_class"] = str(pr.slo_class)
                try:
                    self._send(rep, frame, timeout=10.0)
                    first = self._next_frame(
                        pr, wid, self.submit_ack_timeout_s)
                except queue.Empty:
                    self._unpend(wid, rep, committed)
                    self._mark_dead(
                        rep, f"no submit ack within "
                             f"{self.submit_ack_timeout_s:.0f}s")
                    continue
                except Exception as e:  # noqa: BLE001 — send failed:
                    # the connection is gone; health will confirm
                    self._unpend(wid, rep, committed)
                    self._mark_dead(rep, f"submit send failed: {e}")
                    continue
                if first.get("type") == "accepted":
                    pr.id, pr.replica_id = wid, rep.id
                    pr.pid, pr._rep = rep.pid, rep
                    with self._lock:
                        # from here the WORKER owns the load accounting
                        # (its next health report includes this
                        # request); the local add expires against that
                        # report instead of at completion
                        rep._accepts.append(
                            (time.perf_counter(), committed))
                    return
                self._unpend(wid, rep, committed)
                exc = wire.frame_to_exception(first)
                if isinstance(exc, AdmissionRejectedError):
                    rejects.append(exc)
                elif isinstance(exc, QueueFullError):
                    full += 1
                elif isinstance(exc, ValueError):
                    raise exc        # every replica runs one config
                # engine-failure/closing: candidate mid-death — the
                # next loop re-derives health
            if rejects and not full:
                raise min(rejects, key=lambda e: e.retry_after_s)
            if not block and full:
                raise QueueFullError(
                    "every replica's queue is at capacity")
            if not block:
                # empty candidate set (fleet still starting) or every
                # candidate mid-death: the non-blocking contract is
                # fast-fail, not a silent spin until the deadline
                raise NoHealthyReplicaError(
                    "no replica is dispatchable right now (starting, "
                    "draining or being declared dead)",
                    retry_after_s=1.0)
            rem = (None if wait_deadline is None
                   else wait_deadline - time.perf_counter())
            if rem is not None and rem <= 0:
                if full:
                    raise QueueFullError(
                        "every replica's queue still at capacity "
                        "after the submit wait")
                raise NoHealthyReplicaError(
                    "no replica became dispatchable within the submit "
                    "wait", retry_after_s=1.0)
            time.sleep(min(0.05, rem) if rem is not None else 0.05)

    @staticmethod
    def _next_frame(pr: ProcRequest, wid: int,
                    timeout: float) -> Dict[str, Any]:
        """Next frame belonging to attempt ``wid``. The request's queue
        can hold STALE frames from a previous failover attempt (the
        worker's own error AND ``_mark_dead``'s synthetic one can both
        land for the same dead attempt) — consuming one of those as the
        new attempt's ack or as a fresh failure would burn the failover
        budget on a ghost. Raises ``queue.Empty`` on timeout."""
        deadline = time.perf_counter() + timeout
        while True:
            rem = deadline - time.perf_counter()
            if rem <= 0:
                raise queue.Empty
            frame = pr._q.get(timeout=rem)
            if frame.get("id") == wid:
                return frame
            # stale attempt's frame: drop it

    def _unpend(self, wid: Optional[int],
                rep: Optional[ProcessReplica], committed: int) -> None:
        with self._lock:
            if wid is not None:
                self._pending.pop(wid, None)
            if rep is not None:
                rep.inflight_tokens = max(
                    0, rep.inflight_tokens - committed)

    # -- streaming consume + failover splice -------------------------------

    def _stream(self, pr: ProcRequest, timeout: Optional[float]):
        if pr._finished:
            if pr.exception is not None:
                raise pr.exception
            return
        wait_deadline = (None if timeout is None
                         else time.perf_counter() + timeout)
        while True:
            rem = (None if wait_deadline is None
                   else wait_deadline - time.perf_counter())
            if rem is not None and rem <= 0:
                raise self._stream_timeout(pr, timeout)
            try:
                frame = pr._q.get(timeout=rem)
            except queue.Empty:
                raise self._stream_timeout(pr, timeout) from None
            if frame.get("id") != pr.id:
                continue      # stale frame from a failed-over attempt
            ftype = frame.get("type")
            if ftype == "chunk":
                toks = [int(t) for t in frame.get("tokens", [])]
                if toks:
                    if pr.first_chunk_t is None:
                        pr.first_chunk_t = time.perf_counter()
                    pr.tokens.extend(toks)
                    yield toks
            elif ftype == "done":
                pr.done_frame = frame
                pr.done_t = time.perf_counter()
                final = [int(t) for t in frame.get("tokens", [])]
                if final:        # result-only path: tokens ride done
                    pr.tokens.extend(final)
                self._finish(pr, None)   # AFTER tokens: the metrics
                #                          row reads len(pr.tokens)
                if final:
                    yield final
                return
            elif ftype == "error":
                exc = wire.frame_to_exception(frame)
                with self._lock:
                    closing = self._closing
                if (isinstance(exc, (EngineFailedError,
                                     SchedulerClosedError))
                        and not closing):
                    try:
                        self._proc_failover(pr, exc, wait_deadline)
                    except BaseException as e2:
                        self._finish(pr, e2)
                        raise
                    continue
                self._finish(pr, exc)
                raise exc
            # accepted/stray frames: ignore

    def _stream_timeout(self, pr: ProcRequest,
                        timeout: Optional[float]) -> TimeoutError:
        """The caller's wait elapsed: tell the worker to stop generating
        for a reader that gave up, and FINISH the request so its pending
        entry and load accounting are released — a timed-out stream
        must never leak dispatch weight or a queue entry."""
        exc = TimeoutError(
            f"request still streaming after {timeout}s "
            f"({len(pr.tokens)} tokens delivered)")
        rep = pr._rep
        if rep is not None and rep.connected:
            try:
                self._send(rep, {"type": "cancel", "id": pr.id},
                           timeout=5.0)
            except Exception:  # noqa: BLE001 — best effort
                pass
        # recorded as a DISCONNECT (the reader gave up), exactly like
        # the in-process fleet's timeout-cancel path — never inflating
        # requests_failed for a client decision
        self._finish(pr, RequestCancelledError(
            f"stream reader gave up after {timeout}s"))
        return exc

    def _proc_failover(self, pr: ProcRequest, e: BaseException,
                       wait_deadline: Optional[float]) -> None:
        """Mid-stream failover: re-dispatch with the already-delivered
        tokens as the splice ``prefix`` (the sibling re-derives,
        verifies and suppresses them), under the REMAINING deadline and
        the retry budget — the in-process router's failover upgraded to
        streaming across a process boundary."""
        if pr.failovers >= self.max_failovers:
            if self.max_failovers:
                with self._lock:
                    self.retries_exhausted += 1
                self._log(
                    f"gym_tpu_torch.serve: proc-router — request exhausted "
                    f"its {self.max_failovers} failover budget; "
                    f"surfacing {type(e).__name__}", flush=True)
            raise e
        rem_dl = None
        if pr.deadline_s is not None:
            rem_dl = (pr.deadline_s
                      - (time.perf_counter() - pr.submit_t))
            if rem_dl <= 0:
                raise DeadlineExceededError(
                    f"deadline_s={pr.deadline_s:.3g} exhausted during "
                    f"replica failover — not retried") from e
        failed_rid = pr.replica_id
        # pop the pending entry only: load accounting was handed to the
        # worker at accept (the _accepts expiry), and the dead worker's
        # counters are out of dispatch anyway
        self._unpend(pr.id, pr._rep, 0)
        self._dispatch_proc(pr, rem_dl, prefix=list(pr.tokens),
                            exclude=(failed_rid,), block=True,
                            wait_deadline=wait_deadline)
        pr.failovers += 1
        with self._lock:
            self.failovers += 1
        self._log(
            f"gym_tpu_torch.serve: proc-router — failover: request retried "
            f"on replica {pr.replica_id} with a "
            f"{len(pr.tokens)}-token splice prefix (replica "
            f"{failed_rid} failed it: {type(e).__name__}; retry "
            f"{pr.failovers}/{self.max_failovers}"
            + (f", {rem_dl:.3g}s of deadline left)"
               if rem_dl is not None else ")"), flush=True)

    def _finish(self, pr: ProcRequest,
                exc: Optional[BaseException]) -> None:
        if pr._finished:
            return
        pr._finished = True
        if exc is not None:
            pr.exception = exc
            pr.error = f"{type(exc).__name__}: {exc}"
            if pr.done_t is None:
                pr.done_t = time.perf_counter()
        # pending entry only — post-accept load accounting lives in the
        # worker's health reports (see the _accepts expiry)
        self._unpend(pr.id, pr._rep, 0)
        if self.metrics is not None:
            try:
                self.metrics.request_done(
                    pr, queue_depth=0, active_slots=0,
                    replica_id=pr.replica_id, pid=pr.pid)
            except Exception:  # noqa: BLE001 — observability only
                pass

    def _cancel(self, pr: ProcRequest, reason: str) -> bool:
        if pr._finished:
            return False
        rep = pr._rep
        if rep is not None and rep.connected:
            try:
                self._send(rep, {"type": "cancel", "id": pr.id},
                           timeout=5.0)
            except Exception:  # noqa: BLE001 — best effort: the
                pass           # worker reaps via router-disconnect too
        self._finish(pr, RequestCancelledError(
            f"request cancelled — {reason}"))
        return True

    # -- rolling weight hot-swap -------------------------------------------

    def reload(self, params: Any, *, weights_tag: Optional[str] = None,
               drain_timeout_s: float = 300.0) -> Dict[str, Any]:
        """Roll new params through the worker fleet one process at a
        time: snapshot the tree once, then each worker drains, rebuilds
        warm and resumes — zero dropped requests, same contract as the
        in-process ``Router.reload``."""
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
            path = self.spawner.reload_file(params, weights_tag)
            for rep in list(self.replicas):
                if not rep.healthy:
                    skipped.append(rep.id)
                    continue
                rep.draining = True
                wid = next(self._ids)
                q: "queue.Queue" = queue.Queue()
                with self._lock:
                    self._pending[wid] = (q, rep)
                try:
                    self._send(rep, {
                        "type": "reload", "id": wid,
                        "params_file": path, "tag": weights_tag,
                        "drain_timeout_s": drain_timeout_s})
                    frame = q.get(timeout=drain_timeout_s + 30.0)
                except queue.Empty:
                    raise FleetReloadError(
                        f"replica {rep.id} did not confirm the reload "
                        f"within {drain_timeout_s:.0f}s — rolling "
                        f"reload aborted ({swapped} already swapped)",
                        retry_after_s=max(5.0, drain_timeout_s))
                except Exception as e:  # noqa: BLE001 — send failure
                    raise FleetReloadError(
                        f"replica {rep.id} unreachable during reload: "
                        f"{e}", retry_after_s=5.0)
                finally:
                    with self._lock:
                        self._pending.pop(wid, None)
                    rep.draining = False
                if frame.get("type") != "reload_ok":
                    raise FleetReloadError(
                        f"replica {rep.id} reload failed: "
                        f"{frame.get('message')}", retry_after_s=5.0)
                swapped.append(rep.id)
            with self._lock:
                self.reloads += 1
                self._weights_tag = weights_tag
            wall = time.perf_counter() - t0
            self._log(
                f"gym_tpu_torch.serve: proc-router — weight reload "
                f"{'(' + str(weights_tag) + ') ' if weights_tag else ''}"
                f"rolled through replicas {swapped} in {wall:.2f}s"
                + (f" (skipped: {skipped})" if skipped else ""),
                flush=True)
            return {"swapped": swapped, "skipped": skipped,
                    "weights_tag": weights_tag,
                    "wall_s": round(wall, 3)}
        finally:
            with self._lock:
                self._reloading = False

    # -- observability -----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._lock:
            reps_l = list(self.replicas)
        reps = []
        for rep in reps_l:
            h = rep.last_health
            reps.append({
                "id": rep.id,
                "pid": rep.pid,
                "healthy": rep.healthy,
                "dead": rep.dead,
                "death_reason": rep.death_reason,
                "draining": rep.draining,
                "retired": rep.retired,
                "connected": rep.connected,
                "backlog_tokens": h.get("backlog_tokens", 0),
                "queue_depth": h.get("queue_depth", 0),
                "active_requests": h.get("active_requests", 0),
                "active_slots": h.get("active_slots", 0),
                "num_slots": h.get("num_slots", 0),
                "tokens_generated": h.get("tokens_generated", 0),
                "tokens_per_s_ewma": h.get("tokens_per_s_ewma"),
                "programs_compiled": h.get("programs_compiled"),
                "graphs_captured": h.get("graphs_captured"),
                "engine_generation": h.get("engine_generation", 0),
                "restarts": h.get("engine_restarts", 0),
                "weights_tag": h.get("weights_tag"),
                "warmup": h.get("warmup"),
                # multi-tenant observables off the health frame (absent
                # from pre-tenant workers — a mixed fleet reports what
                # each worker knows)
                "backlog_by_class": h.get("backlog_by_class"),
                "tenants": h.get("tenants"),
            })
        with self._lock:
            live = [r for r in reps if not r["retired"]]
            return {
                "fleet": "process",
                "replicas": reps,
                "healthy_replicas": sum(1 for r in live
                                        if r["healthy"]),
                "failovers": self.failovers,
                "retries_exhausted": self.retries_exhausted,
                "weight_reloads": self.reloads,
                "replicas_spawned": self.replicas_spawned,
                "replicas_retired": self.replicas_retired,
                "weights_tag": self._weights_tag,
            }

    def autoscale_snapshot(self) -> Dict[str, Any]:
        """The autoscaler's tick input: healthy/starting counts, total
        backlog (worker-reported + router-committed) and the aggregate
        live tokens/s EWMA — exactly the per-replica observables the
        in-process fleet prices admission with."""
        with self._lock:
            live = [r for r in self.replicas if not r.retired]
            healthy = [r for r in live if r.healthy]
            # spawned-but-connecting AND draining (rolling reload)
            # replicas are TEMPORARY capacity, not missing capacity:
            # without counting them the floor rule would spawn a
            # spurious worker during every reload on a min-sized fleet
            starting = [r for r in live if not r.dead
                        and (not r.connected or r.draining)]
            backlog = sum(r.load() for r in healthy)
            ewmas = [r.last_health.get("tokens_per_s_ewma")
                     for r in healthy]
            live_rates = [e for e in ewmas if e]
            return {
                "healthy": len(healthy),
                "starting": len(starting),
                "dead": sum(1 for r in live if r.dead),
                "backlog_tokens": float(backlog),
                "tokens_per_s": (sum(live_rates)
                                 if live_rates else None),
            }


def build_process_fleet(params: Any, config: Any, base_dir: str, *,
                        replicas: int = 2, num_slots: int = 4,
                        decode_chunk: int = 1, page_size: int = 16,
                        kv_pages: Optional[int] = None,
                        spec_tokens: int = 0, max_queue: int = 64,
                        metrics=None,
                        dispatch_timeout_s: float = 120.0,
                        max_restarts: int = 5,
                        max_failovers: Optional[int] = None,
                        weights_tag: Optional[str] = None,
                        program_cache_dir: Optional[str] = None,
                        no_warmup: bool = False,
                        device: str = "cuda",
                        env: Optional[Dict[str, str]] = None,
                        quotas: Optional[Dict[str, Any]] = None,
                        preempt: bool = False,
                        log=print) -> ProcessRouter:
    """``build_fleet``'s out-of-process twin: materialize the params
    snapshot under ``base_dir`` and stand up a ``ProcessRouter`` over
    N worker subprocesses on ``device`` (the card unless ``"cpu"``). Not
    started — call ``.start()`` (and ``wait_ready()`` to block on worker
    health). Keep ``base_dir`` short: an AF_UNIX socket path holds at
    most 107 bytes."""
    spawner = WorkerSpawner(
        base_dir, params=params, config=config, num_slots=num_slots,
        decode_chunk=decode_chunk, page_size=page_size,
        kv_pages=kv_pages, spec_tokens=spec_tokens,
        max_queue=max_queue, dispatch_timeout_s=dispatch_timeout_s,
        max_restarts=max_restarts, program_cache_dir=program_cache_dir,
        weights_tag=weights_tag, no_warmup=no_warmup, device=device,
        env=env,
        quotas_json=(None if not quotas else json.dumps(
            {cls: (dataclasses.asdict(q)
                   if dataclasses.is_dataclass(q) else dict(q))
             for cls, q in quotas.items()})),
        preempt=preempt)
    return ProcessRouter(spawner, replicas=replicas, metrics=metrics,
                         max_failovers=max_failovers, log=log)
