"""The serving fleet's analytic twin: a discrete-event
queueing model that prices a (trace × policy) point in milliseconds.

What it models — and what it deliberately shares with the live stack:

- **Replicas** are slot-batch servers with a CONSTANT per-slot token
  rate: the engine's decode step advances every active slot one token
  at a roughly fixed step time, so each running request decodes at
  ``tokens_per_s / num_slots`` regardless of how many slots are busy
  (aggregate throughput scales with occupancy up to the saturated
  ``tokens_per_s`` — continuous batching's actual shape, NOT processor
  sharing). Each request additionally pays ``request_overhead_s`` of
  fixed service time (prefill + dispatch), which dominates TTFT on
  small models. Both numbers come from a MEASURED two-point
  calibration against the real engine (``calibrate_router``), so the
  model is anchored, not guessed.
- **Admission control** is the scheduler's own pricing re-applied to
  the modeled backlog: a deadline'd request is rejected when
  ``(backlog_tokens + max_new) / rate > deadline_s`` — the exact
  ``Scheduler._estimate_service_s`` formula — and, mirroring the EWMA's
  cold-start behavior, admission is optimistic until the replica has
  produced its first token.
- **Autoscaling** runs the ACTUAL ``AutoscaleController.tick`` (the
  same object the live ``Autoscaler`` drives) on the modeled snapshot
  at the same cadence, so a policy point's decisions in the model are
  the decisions the real controller would make on the same
  observables. Spawns become serving after ``startup_s``; retires
  drain first, like ``ProcessRouter.scale_down``.

What it does NOT model (the stated sim-vs-live tolerance absorbs
these): prefill cost (folded into the calibrated rate on average),
prefix-cache hits, dispatch/wire overhead, and GIL/host scheduling
noise. The tracesim bench (``bench.py --tracesim-only``) asserts the
model's p99 TTFT and shed rate against a real replay of the same trace
within explicit tolerances — the agreement contract that makes sweep
results trustworthy.

A copy of ``gym_tpu/servesim/cost_model.py``, which imports no JAX; ``tests/test_torch_servesim.py``
pins the copy to its original.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Tuple

from ..serve.autoscale import AutoscaleController, AutoscalePolicy
from .replay import Outcome, slo_report
from .traces import RequestEvent

_EPS = 1e-9

#: mirrors ``serve.scheduler.CLASS_PRIORITY`` (pinned equal by a test);
#: duplicated here because importing the scheduler would pull the engine into
#: the sweep's fast path. Unclassed requests price as ``standard``.
_CLASS_PRIORITY = {"interactive": 0, "standard": 1, "batch": 2}


class _QuotaBucket:
    """The modeled twin of ``scheduler._TokenBucket``: a per-class
    refill bucket over the fleet's MODELED capacity. ``share`` quotas
    scale with the live healthy-replica count (each live replica runs
    its own bucket over its own EWMA; the fleet-level model folds them
    into one bucket at ``share × tokens_per_s × n_healthy``); explicit
    ``tokens_per_s`` quotas are absolute. Starts full (a cold bucket
    must not reject the first burst — same as live)."""

    def __init__(self, spec: Any, profile: "ServiceProfile"):
        spec = (dict(spec) if isinstance(spec, dict)
                else {"tokens_per_s": float(spec)})
        self.tokens_per_s = spec.get("tokens_per_s")
        self.share = spec.get("share")
        self.burst_s = float(spec.get("burst_s", 2.0))
        self.profile = profile
        self.fill: Optional[float] = None
        self.last = 0.0
        self.rejected = 0

    def rate(self, n_healthy: int) -> float:
        if self.tokens_per_s is not None:
            return float(self.tokens_per_s)
        return (float(self.share or 0.0) * self.profile.tokens_per_s
                * max(1, n_healthy))

    def take(self, now: float, n_healthy: int, tokens: float) -> bool:
        r = self.rate(n_healthy)
        cap = max(r * self.burst_s, 1.0)
        if self.fill is None:
            self.fill = cap
        self.fill = min(cap, self.fill + max(0.0, now - self.last) * r)
        self.last = now
        if tokens <= self.fill + _EPS:
            self.fill -= tokens
            return True
        self.rejected += 1
        return False


@dataclasses.dataclass(frozen=True)
class ServiceProfile:
    """The measured per-replica serving capability the model is
    anchored to."""

    #: SATURATED aggregate decode rate of one replica (all slots busy);
    #: the per-slot rate is ``tokens_per_s / num_slots``
    tokens_per_s: float
    num_slots: int = 4
    max_queue: int = 64
    #: fixed per-request service seconds (prefill + dispatch) paid
    #: before the first token — the TTFT floor
    request_overhead_s: float = 0.0
    #: spawn → serving latency (process start + restore + warm programs)
    startup_s: float = 5.0

    @property
    def slot_tokens_per_s(self) -> float:
        return self.tokens_per_s / max(1, self.num_slots)


def calibrate_router(router: Any, vocab_size: int, *,
                     num_slots: int = 4, max_queue: int = 64,
                     startup_s: float = 5.0,
                     m1: int = 8, m2: int = 32,
                     probes: int = 3,
                     saturate_burst: int = 0) -> ServiceProfile:
    """Two-point live calibration against a WARM fleet: median latency
    of single requests at ``m1`` and ``m2`` new tokens gives the
    per-slot token rate (the slope) and the fixed per-request overhead
    (the intercept) — ``latency(m) ≈ overhead + m / slot_rate``. Run
    after warmup; compiles would poison the intercept.

    ``saturate_burst > 0`` additionally measures the SATURATED
    aggregate rate with that many concurrent client threads (tokens /
    wall) and uses it for ``tokens_per_s`` instead of extrapolating
    the single-request slope — on a shared host the concurrent burst
    folds in the client-side contention an open-loop replay actually
    imposes, which the idle-engine slope cannot see."""
    import concurrent.futures as _cf
    import time as _time

    import numpy as np

    from ..serve.engine import SamplingParams

    def probe(m: int, seed: int) -> float:
        prompt = np.arange(1, 9, dtype=np.int32) % vocab_size
        t0 = _time.perf_counter()
        req = router.submit(prompt, SamplingParams(max_new_tokens=m,
                                                   seed=seed),
                            timeout=120.0)
        req.result(timeout=300.0)
        return _time.perf_counter() - t0

    l1 = sorted(probe(m1, 100 + i) for i in range(probes))[probes // 2]
    l2 = sorted(probe(m2, 200 + i) for i in range(probes))[probes // 2]
    slot_rate = (m2 - m1) / max(l2 - l1, 1e-6)
    overhead = max(0.0, l1 - m1 / slot_rate)
    agg = slot_rate * num_slots
    if saturate_burst > 0:
        def one(seed: int) -> int:
            prompt = np.arange(1, 9, dtype=np.int32) % vocab_size
            req = router.submit(
                prompt, SamplingParams(max_new_tokens=m2,
                                       seed=1000 + seed),
                timeout=120.0)
            return len(req.result(timeout=300.0))
        t0 = _time.perf_counter()
        with _cf.ThreadPoolExecutor(saturate_burst) as ex:
            toks = sum(ex.map(one, range(saturate_burst)))
        agg = min(agg, toks / (_time.perf_counter() - t0))
    return ServiceProfile(tokens_per_s=agg,
                          num_slots=num_slots, max_queue=max_queue,
                          request_overhead_s=overhead,
                          startup_s=startup_s)


class _Req:
    __slots__ = ("ev", "out", "remaining", "done_tok", "overhead_tok",
                 "admit_t", "pri", "seq")

    def __init__(self, ev: RequestEvent, out: Outcome,
                 overhead_tok: float):
        self.ev = ev
        self.out = out
        # fixed overhead rides as equivalent tokens at the slot rate,
        # so one advance loop covers prefill + decode
        self.overhead_tok = overhead_tok
        self.remaining = float(ev.max_new) + overhead_tok
        self.done_tok = 0.0
        self.admit_t: Optional[float] = None
        # class priority + arrival order: with one class every pri is
        # equal and (pri, seq) admission IS the old FIFO
        self.pri = _CLASS_PRIORITY.get(
            getattr(ev, "slo_class", None), 1)
        self.seq = int(ev.seed)

    @property
    def tokens_produced(self) -> float:
        return max(0.0, self.done_tok - self.overhead_tok)

    @property
    def deadline_t(self) -> Optional[float]:
        if self.ev.deadline_s is None:
            return None
        return self.out.arrival_s + self.ev.deadline_s

    def settle(self, status: str, when: float, rid: int) -> None:
        """Write the terminal outcome — the ONE place both the event
        loop and admission-time sheds resolve a request through."""
        self.out.status = status
        # round, don't truncate: a completed request produced exactly
        # max_new (float drift must not eat a token)
        self.out.tokens = (self.ev.max_new if status == "done"
                           else int(round(self.tokens_produced)))
        self.out.replica = rid
        if status == "done":
            self.out.latency_s = when - self.out.arrival_s


class _Replica:
    """One modeled fleet member: FCFS queue + PS-shared slots, advanced
    lazily to each macro-event time."""

    def __init__(self, rid: int, profile: ServiceProfile,
                 ready_at: float, preempt: bool = False):
        self.id = rid
        self.profile = profile
        self.ready_at = ready_at
        self.preempt = bool(preempt)
        self.preemptions = 0
        self.retired = False
        self.draining = False
        self.queue: List[_Req] = []
        self.running: List[_Req] = []
        self.t = ready_at
        #: mirrors the live EWMA's cold start: admission prices only
        #: after the first token was produced
        self.rate_established = False

    def healthy(self, now: float) -> bool:
        return (not self.retired and not self.draining
                and now >= self.ready_at - _EPS)

    def backlog_tokens(self) -> float:
        """Committed future work — the same accounting as
        ``Scheduler.backlog_tokens`` (queued max_new + remaining NEW
        tokens of running; the modeled overhead is not a token)."""
        return (sum(r.ev.max_new - r.tokens_produced
                    for r in self.queue)
                + sum(r.ev.max_new - r.tokens_produced
                      for r in self.running))

    # -- internal time advance --------------------------------------------

    def _sweep_expired(self,
                       done: List[Tuple[_Req, str, float]]) -> None:
        """Shed queued requests whose deadline passed — even while
        every slot is busy, exactly like ``Scheduler.
        _shed_expired_queued`` runs every driver round (an expired
        request must not keep occupying queue capacity or counting in
        the backlog the admission/autoscale pricing reads)."""
        keep: List[_Req] = []
        for r in self.queue:
            dl = r.deadline_t
            if dl is not None and self.t > dl:
                done.append((r, "shed", dl))
            else:
                keep.append(r)
        self.queue = keep

    def _admit(self, done: List[Tuple[_Req, str, float]]) -> None:
        self._sweep_expired(done)
        while (len(self.running) < self.profile.num_slots
               and self.queue):
            # (pri, seq): weighted-fair order — strict FIFO when every
            # request shares a class (pri ties break on arrival order)
            i = min(range(len(self.queue)),
                    key=lambda j: (self.queue[j].pri,
                                   self.queue[j].seq))
            req = self.queue.pop(i)
            req.admit_t = self.t
            self.running.append(req)
        # preemptible decode: park the LOWEST-priority
        # running request for a strictly-more-urgent queued one. The
        # parked request keeps its progress (done_tok survives the
        # round-trip through the queue — the modeled twin of the
        # engine's park/resume keeping pages pinned) and re-admits by
        # the same (pri, seq) order.
        while self.preempt and self.queue and self.running:
            qi = min(range(len(self.queue)),
                     key=lambda j: (self.queue[j].pri,
                                    self.queue[j].seq))
            vi = max(range(len(self.running)),
                     key=lambda j: (self.running[j].pri,
                                    self.running[j].seq))
            if self.queue[qi].pri >= self.running[vi].pri:
                break
            urgent = self.queue.pop(qi)
            victim = self.running.pop(vi)
            self.queue.append(victim)
            urgent.admit_t = self.t
            self.running.append(urgent)
            self.preemptions += 1

    def advance(self, t_target: float
                ) -> List[Tuple[_Req, str, float]]:
        """Run this replica forward to ``t_target``, emitting
        (request, terminal-status, when) triples for completions,
        deadline cancellations and queue sheds along the way."""
        done: List[Tuple[_Req, str, float]] = []
        if self.retired:
            self.t = t_target
            return done
        self.t = max(self.t, self.ready_at)
        self._admit(done)
        while self.t < t_target - _EPS and self.running:
            # constant per-slot rate: the decode step advances every
            # active slot one token at ~fixed step time (continuous
            # batching — aggregate scales with occupancy, per-request
            # rate does not)
            rate_each = self.profile.slot_tokens_per_s
            # next internal event: a completion or a running deadline
            dt = t_target - self.t
            for r in self.running:
                dt = min(dt, r.remaining / rate_each)
                dl = r.deadline_t
                if dl is not None:
                    dt = min(dt, max(0.0, dl - self.t))
            dt = max(dt, 0.0)
            for r in self.running:
                before = r.done_tok
                r.done_tok += dt * rate_each
                r.remaining -= dt * rate_each
                mark = r.overhead_tok + 1.0
                if (r.out.ttft_s is None and before < mark
                        and r.done_tok >= mark - _EPS):
                    first_t = self.t + (mark - before) / rate_each
                    r.out.ttft_s = first_t - r.out.arrival_s
                    self.rate_established = True
            self.t += dt
            still: List[_Req] = []
            progressed = False
            for r in self.running:
                dl = r.deadline_t
                if r.remaining <= _EPS:
                    done.append((r, "done", self.t))
                    progressed = True
                elif dl is not None and self.t >= dl - _EPS:
                    # running past deadline: cancelled at the (modeled)
                    # chunk boundary
                    done.append((r, "shed", self.t))
                    progressed = True
                else:
                    still.append(r)
            if not progressed and dt <= _EPS:
                break    # safety: nothing can make progress
            self.running = still
            self._admit(done)
        if not self.running:
            # a still-starting replica never lags behind its ready time
            self.t = max(t_target, self.ready_at)
        if self.draining and not self.queue and not self.running:
            self.retired = True
            self.draining = False   # the retire transition fires once
        return done


@dataclasses.dataclass
class CostModelResult:
    outcomes: List[Outcome]
    replica_seconds: float
    spawns: int
    retires: int
    #: the modeled audit trail — one entry per controller tick, the
    #: same fields the live ``autoscale`` serve.csv rows carry
    autoscale_log: List[Dict[str, Any]]
    max_replicas_seen: int
    #: multi-tenant counters; zero/empty without quotas or
    #: preemption, so pre-tenant reports are unchanged
    preemptions: int = 0
    quota_rejected: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    def report(self, slo_ttft_s: Optional[float] = None,
               wall_s: Optional[float] = None) -> Dict[str, Any]:
        rep = slo_report(self.outcomes, slo_ttft_s=slo_ttft_s,
                         replica_seconds=self.replica_seconds,
                         wall_s=wall_s)
        rep["spawns"] = self.spawns
        rep["retires"] = self.retires
        rep["max_replicas"] = self.max_replicas_seen
        if self.preemptions or self.quota_rejected:
            rep["preemptions"] = self.preemptions
            rep["quota_rejected"] = dict(self.quota_rejected)
        return rep


def class_reports(events: List[RequestEvent],
                  outcomes: List[Outcome],
                  slo_ttft_s: Optional[float] = None
                  ) -> Dict[str, Dict[str, Any]]:
    """Per-SLO-class ``slo_report`` breakdown: outcomes join back to
    their events on ``index == seed`` (unique per trace), so the
    tenant sweep reads per-class tails without the Outcome schema
    growing fields the single-tenant replay arm would have to fake."""
    cls_of = {int(e.seed): (e.slo_class or "default") for e in events}
    groups: Dict[str, List[Outcome]] = {}
    for o in outcomes:
        groups.setdefault(cls_of.get(o.index, "default"),
                          []).append(o)
    return {cls: slo_report(outs, slo_ttft_s=slo_ttft_s)
            for cls, outs in sorted(groups.items())}


class FleetCostModel:
    """Discrete-event fleet simulation: arrivals + autoscale ticks are
    the macro events; each replica advances lazily between them (PS
    completions, deadline cancels, queue sheds computed in closed form
    inside the gaps). One ``run`` on a thousand-request trace costs
    milliseconds — the sweep's fast path."""

    def __init__(self, profile: ServiceProfile,
                 policy: Optional[AutoscalePolicy] = None,
                 initial_replicas: int = 1, autoscale: bool = True,
                 autoscale_interval_s: float = 1.0,
                 quotas: Optional[Dict[str, Any]] = None,
                 preempt: bool = False):
        self.profile = profile
        self.policy = policy or AutoscalePolicy()
        self.autoscale = bool(autoscale)
        self.interval_s = float(autoscale_interval_s)
        self.initial_replicas = int(initial_replicas)
        #: per-class admission quotas, same spec shape as the live
        #: ``--quotas`` JSON ({cls: {"share": f}} or
        #: {cls: {"tokens_per_s": r}}, optional "burst_s")
        self.quotas = dict(quotas) if quotas else None
        self.preempt = bool(preempt)
        if self.initial_replicas < 1:
            raise ValueError("initial_replicas must be >= 1")

    # -- the run -----------------------------------------------------------

    def run(self, events: List[RequestEvent],
            horizon_s: Optional[float] = None) -> CostModelResult:
        events = sorted(events, key=lambda e: e.arrival_s)
        controller = AutoscaleController(self.policy)
        replicas = [
            _Replica(i, self.profile, ready_at=0.0,
                     preempt=self.preempt)
            for i in range(self.initial_replicas)]
        buckets: Dict[str, _QuotaBucket] = {
            cls: _QuotaBucket(spec, self.profile)
            for cls, spec in (self.quotas or {}).items()}
        outcomes: List[Outcome] = []
        live: Dict[int, _Req] = {}
        spawns = retires = 0
        replica_seconds = 0.0
        max_seen = len(replicas)
        last_t = 0.0
        auditlog: List[Dict[str, Any]] = []

        def paying(now: float) -> int:
            # you pay for starting AND draining replicas; only retired
            # ones leave the bill
            return sum(1 for r in replicas if not r.retired)

        def settle(req: _Req, status: str, now: float,
                   rid: int) -> None:
            req.settle(status, now, rid)
            live.pop(id(req), None)

        # event heap: (time, seq, kind, payload) — seq breaks ties
        # deterministically (arrivals before the same-time tick would
        # otherwise compare dicts)
        heap: List[Tuple[float, int, str, Any]] = []
        seq = 0
        for ev in events:
            heapq.heappush(heap, (ev.arrival_s, seq, "arrive", ev))
            seq += 1
        end = horizon_s
        if end is None:
            # run past the last arrival long enough to drain: the total
            # offered tokens at one replica's rate is a safe upper bound
            total_tok = sum(e.max_new for e in events) or 1
            end = ((events[-1].arrival_s if events else 0.0)
                   + total_tok / self.profile.tokens_per_s + 10.0)
        if self.autoscale:
            t = self.interval_s
            while t <= end + self.interval_s:
                heapq.heappush(heap, (t, seq, "tick", None))
                seq += 1
                t += self.interval_s

        def advance_all(now: float) -> None:
            nonlocal replica_seconds, last_t, retires
            replica_seconds += paying(last_t) * (now - last_t)
            last_t = now
            for rep in replicas:
                was_draining = rep.draining
                for req, status, when in rep.advance(now):
                    settle(req, status, when, rep.id)
                if was_draining and rep.retired:
                    retires += 1

        arrivals_left = len(events)
        while heap:
            # the bill and the run end when the offered work does:
            # every arrival dispatched and every request settled. The
            # live arm's ReplicaSecondsProbe integrates over the replay
            # wall (arrivals + drain) — the model must price the same
            # window, not an arbitrary post-drain idle tail at the
            # floor replica count.
            if arrivals_left == 0 and not live:
                break
            t, _, kind, payload = heapq.heappop(heap)
            if t > end and not live:
                break
            advance_all(t)
            if kind == "arrive":
                arrivals_left -= 1
                self._arrive(payload, replicas, outcomes, live, t,
                             buckets)
            elif kind == "tick" and self.autoscale:
                decision = self._tick(controller, replicas, t,
                                      auditlog)
                if decision > 0:
                    rid = max((r.id for r in replicas), default=-1) + 1
                    replicas.append(_Replica(
                        rid, self.profile,
                        ready_at=t + self.profile.startup_s,
                        preempt=self.preempt))
                    spawns += 1
                    max_seen = max(
                        max_seen, sum(1 for r in replicas
                                      if not r.retired))
                elif decision < 0:
                    cands = [r for r in replicas if r.healthy(t)]
                    if len(cands) > 1:
                        victim = max(cands, key=lambda r: r.id)
                        victim.draining = True
        # drain whatever is still in flight
        guard = 0
        while live and guard < 10_000:
            advance_all(last_t + 1.0)
            guard += 1
        return CostModelResult(
            outcomes=sorted(outcomes, key=lambda o: o.index),
            replica_seconds=replica_seconds, spawns=spawns,
            retires=retires, autoscale_log=auditlog,
            max_replicas_seen=max_seen,
            preemptions=sum(r.preemptions for r in replicas),
            quota_rejected={cls: b.rejected
                            for cls, b in buckets.items()
                            if b.rejected})

    # -- pieces ------------------------------------------------------------

    def _arrive(self, ev: RequestEvent, replicas: List[_Replica],
                outcomes: List[Outcome], live: Dict[int, _Req],
                now: float,
                buckets: Optional[Dict[str, _QuotaBucket]] = None
                ) -> None:
        out = Outcome(index=ev.seed, arrival_s=ev.arrival_s,
                      t_submit=ev.arrival_s, status="failed",
                      max_new=ev.max_new, deadline_s=ev.deadline_s)
        outcomes.append(out)
        # per-class quota first, like the live scheduler: a class out
        # of budget is rejected typed BEFORE any replica is consulted
        bucket = (buckets or {}).get(getattr(ev, "slo_class", None))
        if bucket is not None:
            n_healthy = sum(1 for r in replicas if r.healthy(now))
            if not bucket.take(now, n_healthy, float(ev.max_new)):
                out.status = "rejected"
                out.error = "quota"
                return
        cands = sorted((r for r in replicas if r.healthy(now)),
                       key=lambda r: (r.backlog_tokens(), r.id))
        if not cands:
            out.error = "no_healthy_replica"
            return
        rejected = full = 0
        for rep in cands:
            # the scheduler's admission pricing on the modeled backlog
            # (optimistic while the replica's rate is unestablished —
            # the live EWMA's cold start)
            if (ev.deadline_s is not None and rep.rate_established):
                est = ((rep.backlog_tokens() + ev.max_new)
                       / self.profile.tokens_per_s)
                if est > ev.deadline_s:
                    rejected += 1
                    continue
            if len(rep.queue) >= self.profile.max_queue:
                full += 1
                continue
            req = _Req(ev, out,
                       overhead_tok=(self.profile.request_overhead_s
                                     * self.profile.slot_tokens_per_s))
            live[id(req)] = req
            rep.queue.append(req)
            # immediate slot fill (the driver admits between steps;
            # advancing to the replica's own time performs only admits
            # and zero-dt queue sheds)
            for r2, status, when in rep.advance(rep.t):
                r2.settle(status, when, rep.id)
                live.pop(id(r2), None)
            return
        out.status = "rejected"
        out.error = ("queue_full" if full and not rejected
                     else "admission")

    def _tick(self, controller: AutoscaleController,
              replicas: List[_Replica], now: float,
              auditlog: List[Dict[str, Any]]) -> int:
        healthy = [r for r in replicas if r.healthy(now)]
        starting = [r for r in replicas
                    if not r.retired and not r.draining
                    and now < r.ready_at - _EPS]
        backlog = sum(r.backlog_tokens() for r in healthy)
        rates = [self.profile.tokens_per_s for r in healthy
                 if r.rate_established]
        rate = sum(rates) if rates else None
        decision = controller.tick(len(healthy), len(starting),
                                   backlog, rate)
        auditlog.append({
            "t": round(now, 3), "healthy": len(healthy),
            "starting": len(starting),
            "backlog_tokens": round(backlog, 1),
            "tokens_per_s": rate, "decision": decision,
            "reason": controller.last_reason})
        return decision
