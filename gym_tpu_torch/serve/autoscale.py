"""Load-adaptive autoscaling for the out-of-process fleet (a copy of
``gym_tpu/serve/autoscale.py``, which imports no JAX; only its log lines
name this package).

Three layers, so the POLICY is unit-testable on synthetic traces with
no subprocesses anywhere near it:

- ``AutoscalePolicy`` — the knobs: replica bounds, the drain-time
  watermarks, patience/hysteresis/cooldown tick counts.
- ``AutoscaleController`` — a pure state machine: feed it one
  ``tick(healthy, starting, backlog_tokens, tokens_per_s)`` per
  interval and it answers ``+1`` (spawn), ``-1`` (retire) or ``0``
  (hold). Decisions are priced exactly the way fleet admission control
  prices deadlines: estimated drain seconds = total backlog tokens /
  the aggregate live tokens/s EWMA. Scale-up needs ``up_patience``
  consecutive over-watermark ticks (a one-tick burst is noise);
  scale-down needs ``down_patience`` consecutive under-watermark ticks
  (hysteresis — retiring is expensive to undo) and never goes below
  ``min_replicas``. Both respect a post-action ``cooldown`` so a
  spawning worker's cold window cannot trigger a second spawn.
- ``Autoscaler`` — the thread that drives a ``ProcessRouter`` with the
  controller's decisions, and RESPAWNS dead replicas (a ``kill -9``'d
  worker leaves the healthy count under ``min_replicas``; the next
  tick spawns a replacement — with a warm ``--program-cache-dir`` the
  newcomer deserializes its whole program family and reports
  ``programs_compiled=0``, which is what makes spawning cheap enough
  to be load-adaptive).
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import traceback
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Autoscaling knobs. The defaults suit the 2-core CI box: patient
    up (2 ticks), much more patient down (8 ticks), bounded 1..4."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: scale up when the backlog would take longer than this to drain
    #: at the current aggregate rate
    up_drain_s: float = 4.0
    #: scale down when it would drain faster than this (must be well
    #: under ``up_drain_s`` — the hysteresis band lives between them)
    down_drain_s: float = 0.5
    #: with no rate established (cold fleet), fall back to a per-replica
    #: backlog-token watermark for the up decision
    up_backlog_tokens_per_replica: float = 256.0
    up_patience: int = 2
    down_patience: int = 8
    #: ticks to hold after ANY action (spawn or retire)
    cooldown: int = 4

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas {self.max_replicas} < min_replicas "
                f"{self.min_replicas}")
        if self.down_drain_s >= self.up_drain_s:
            raise ValueError(
                f"down_drain_s {self.down_drain_s} must sit below "
                f"up_drain_s {self.up_drain_s} (the hysteresis band)")


class AutoscaleController:
    """Pure decision state machine (no threads, no processes, no
    clocks — ticks ARE the clock). See module docstring."""

    def __init__(self, policy: Optional[AutoscalePolicy] = None):
        self.policy = policy or AutoscalePolicy()
        self._over = 0          # consecutive ticks above the up mark
        self._under = 0         # consecutive ticks below the down mark
        self._cooldown = 0
        self.decisions = 0      # non-hold decisions issued (observable)
        #: why the LAST tick decided what it decided — the audit-trail
        #: string ``ServeMetrics.autoscale_tick`` persists per tick;
        #: greppable prefixes: floor/cooldown/up/down/hold
        self.last_reason = "init"

    def tick(self, healthy: int, starting: int, backlog_tokens: float,
             tokens_per_s: Optional[float]) -> int:
        """One autoscale interval. Returns +1 spawn / -1 retire / 0
        hold. ``starting`` (spawned, not yet serving) counts toward
        capacity for the up decision — never spawn a third replica
        because the second is still starting up."""
        p = self.policy
        total = healthy + starting
        # replica-count floor dominates EVERYTHING: a dead fleet (or a
        # kill -9 below min) respawns immediately, cooldown or not —
        # availability is not a load decision
        if total < p.min_replicas:
            self._over = self._under = 0
            self._cooldown = p.cooldown
            self.decisions += 1
            self.last_reason = (f"floor: {total} < min_replicas "
                                f"{p.min_replicas}")
            return +1
        if self._cooldown > 0:
            self._cooldown -= 1
            self.last_reason = f"cooldown: {self._cooldown + 1} to go"
            return 0
        # price the backlog in seconds at the live aggregate rate; with
        # no rate yet (cold fleet), use the per-replica token watermark
        if tokens_per_s and tokens_per_s > 0:
            drain_s = backlog_tokens / tokens_per_s
            over = drain_s > p.up_drain_s
            under = drain_s < p.down_drain_s
            gauge = f"drain_s={drain_s:.2f}"
        else:
            over = (healthy > 0
                    and backlog_tokens / max(1, healthy)
                    > p.up_backlog_tokens_per_replica)
            under = backlog_tokens == 0
            gauge = (f"cold_backlog/replica="
                     f"{backlog_tokens / max(1, healthy):.0f}")
        self._over = self._over + 1 if over else 0
        self._under = self._under + 1 if under else 0
        if (self._over >= p.up_patience and total < p.max_replicas):
            self._over = self._under = 0
            self._cooldown = p.cooldown
            self.decisions += 1
            self.last_reason = (f"up: {gauge} over for "
                                f"{p.up_patience} tick(s)")
            return +1
        if (self._under >= p.down_patience
                and total > p.min_replicas and starting == 0):
            self._over = self._under = 0
            self._cooldown = p.cooldown
            self.decisions += 1
            self.last_reason = (f"down: {gauge} under for "
                                f"{p.down_patience} tick(s)")
            return -1
        self.last_reason = (f"hold: {gauge} over={self._over}/"
                            f"{p.up_patience} under={self._under}/"
                            f"{p.down_patience}")
        return 0


class Autoscaler:
    """Drive a ``ProcessRouter`` from an ``AutoscaleController``: every
    ``interval_s`` take the router's ``autoscale_snapshot()``, tick the
    controller, act. Spawn failures are logged and retried next tick —
    an autoscaler must never die of one bad spawn."""

    def __init__(self, router: Any,
                 policy: Optional[AutoscalePolicy] = None,
                 interval_s: float = 1.0, metrics: Any = None,
                 log=print):
        """``metrics``: a ``ServeMetrics`` — every tick is persisted as
        an ``autoscale`` audit row (snapshot, decision, reason) so
        decisions are reconstructible from ``serve.csv`` alone."""
        self.router = router
        self.controller = AutoscaleController(policy)
        self.interval_s = float(interval_s)
        self.metrics = metrics
        self._log = log
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="gym-tpu-autoscaler", daemon=True)
        self.ticks = 0
        self.spawns = 0
        self.retires = 0

    @property
    def policy(self) -> AutoscalePolicy:
        return self.controller.policy

    def start(self) -> "Autoscaler":
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout=join_timeout_s)

    def tick_once(self) -> int:
        """One autoscale step (also the testable unit): snapshot →
        decide → act. Returns the decision."""
        snap: Dict[str, Any] = self.router.autoscale_snapshot()
        decision = self.controller.tick(
            int(snap.get("healthy", 0)), int(snap.get("starting", 0)),
            float(snap.get("backlog_tokens", 0.0)),
            snap.get("tokens_per_s"))
        if self.metrics is not None:
            try:
                self.metrics.autoscale_tick(
                    healthy=int(snap.get("healthy", 0)),
                    starting=int(snap.get("starting", 0)),
                    backlog_tokens=float(snap.get("backlog_tokens",
                                                  0.0)),
                    tokens_per_s=snap.get("tokens_per_s"),
                    decision=decision,
                    reason=self.controller.last_reason)
            except Exception:  # noqa: BLE001 — observability must not
                pass           # kill the control loop
        if decision > 0:
            rep = self.router.scale_up()
            self.spawns += 1
            self._log(
                f"gym_tpu_torch.serve: autoscaler — scale UP -> replica "
                f"{rep.id} (healthy {snap['healthy']}, backlog "
                f"{snap['backlog_tokens']:.0f} tok, rate "
                f"{snap.get('tokens_per_s') or 0.0:.1f} tok/s)",
                flush=True)
        elif decision < 0:
            rep = self.router.scale_down()
            if rep is not None:
                self.retires += 1
                self._log(
                    f"gym_tpu_torch.serve: autoscaler — scale DOWN -> "
                    f"retired replica {rep.id} (healthy "
                    f"{snap['healthy']}, backlog "
                    f"{snap['backlog_tokens']:.0f} tok)", flush=True)
        self.ticks += 1
        return decision

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick_once()
            except Exception:  # noqa: BLE001 — one bad tick (a spawn
                # raced shutdown, a snapshot raced a close) must not
                # kill the control loop; the next tick retries
                sys.stderr.write(
                    "gym_tpu_torch.serve: autoscaler tick failed:\n"
                    + traceback.format_exc())

    def status(self) -> Dict[str, Any]:
        return {"ticks": self.ticks, "spawns": self.spawns,
                "retires": self.retires,
                "min_replicas": self.policy.min_replicas,
                "max_replicas": self.policy.max_replicas}
