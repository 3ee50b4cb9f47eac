"""Seeded chaos campaigns over the fault registry (counterpart of
``gym_tpu/utils/chaos.py``, a copy of its stdlib-only code held to it line
for line by ``tests/test_torch_isolation.py``; only this docstring is the
port's own).

The kill harness proves ONE fault at a time; a campaign samples a seeded
random MIX of faults — crashes, corruption, latency — across every
compatible registered site of the train pipeline, runs it, and asserts the
invariant suite: no silent divergence (the completed run's ``train.csv`` is
byte-identical to a fault-free run's), every failure typed, and recovery
completing within the relaunch budget. ``run_train_campaign`` drives a
caller-supplied ``launch(faults_spec) -> {...}`` closure, so the fault gate
(``scripts/ci_torch_faults.sh``) runs it over the subprocess worker of
``tests/test_torch_kill_harness.py`` and unit tests drive a stub. One
integer seed fixes the whole schedule.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: Sites on the TRAIN pipeline (the campaign target) with the actions
#: that make sense there. ``hang`` is excluded — it needs a watchdog
#: multiple of the run length and would dominate the campaign's wall
#: time; the watchdog has its own dedicated coverage.
TRAIN_SITE_ACTIONS: Dict[str, Tuple[str, ...]] = {
    "dispatch.boundary": ("kill", "sigterm", "delay"),
    "prefetch.fill": ("kill", "oserror", "delay"),
    "checkpoint.write": ("kill", "oserror", "delay"),
    "checkpoint.device_get": ("oserror", "delay"),
    "checkpoint.bytes": ("bitflip", "truncate"),
    "dispatch.state": ("bitflip",),
}

#: Exception type names whose appearance in a failed attempt's stderr
#: classifies the failure as TYPED (invariant 2). Everything here is a
#: deliberately raised, documented failure mode of the stack.
TYPED_ERRORS = (
    "InjectedFault",
    "CheckpointWriteError",
    "CheckpointNotFoundError",
    "CheckpointWriterStuckError",
    "ChecksumMismatchError",
    "GuardTrippedError",
    "WatchdogTimeoutError",
    "FrameCorruptError",
    "TruncatedFrameError",
    "FrameTooLargeError",
    "MalformedFrameError",
    "OSError",
)

#: Watchdog's loud-death status (resilience.Watchdog.EXIT_CODE),
#: duplicated literally so chaos stays importable without jax in the
#: classifier's process — pinned equal in tests/test_chaos_campaign.py.
WATCHDOG_EXIT_CODE = 86

#: Earliest hit the sampler will schedule ``dispatch.state`` corruption
#: at. Live-state corruption BEFORE the guard's EWMA has ``warmup``
#: (default 3) reference observations is undetectable by construction —
#: there is no baseline to spike against, and a checkpoint taken in that
#: window would commit the corrupt state under a VALID sidecar. The
#: floor keeps every sampled event detectable (integrity.Guard warmup 3
#: → first spike-checked observation is the 4th; 5 leaves slack).
GUARD_SAFE_FIRST_HIT = 5


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault: ``site:action[=arg][@window]``."""

    site: str
    action: str
    arg: float = 0.0
    first: int = 1
    last: Optional[int] = None

    def spec(self) -> str:
        part = f"{self.site}:{self.action}"
        if self.arg:
            part += f"={self.arg:g}"
        if self.last == self.first:
            part += f"@{self.first}"
        elif self.last is None and self.first > 1:
            part += f"@{self.first}+"
        elif self.last is not None:
            part += f"@{self.first}-{self.last}"
        return part


def faults_spec(events: Sequence[ChaosEvent]) -> str:
    """``GYM_TPU_FAULTS`` string for a schedule."""
    return ",".join(e.spec() for e in events)


def sample_schedule(seed: int, n_events: Optional[int] = None,
                    max_hit: int = 8,
                    site_actions: Optional[Dict[str, Tuple[str, ...]]]
                    = None) -> List[ChaosEvent]:
    """Seeded random fault schedule: ``n_events`` (default 1-3) single-hit
    events over the compatible (site, action) pairs. Single-hit windows
    (``@N``) keep every event recoverable by construction: a
    once-per-run fault either kills THAT attempt or corrupts ONE
    payload — open-ended windows would make 'relaunch until it
    completes' undecidable. Delay args are kept tiny (the campaign
    measures correctness, not patience)."""
    rng = random.Random(seed)
    sa = site_actions or TRAIN_SITE_ACTIONS
    pairs = [(s, a) for s, acts in sorted(sa.items()) for a in acts]
    n = n_events if n_events is not None else rng.randint(1, 3)
    events = []
    for _ in range(n):
        site, action = rng.choice(pairs)
        hit = rng.randint(1, max_hit)
        if site == "dispatch.state":
            hit = rng.randint(GUARD_SAFE_FIRST_HIT,
                              max(GUARD_SAFE_FIRST_HIT, max_hit))
        arg = 0.0
        if action == "delay":
            arg = round(rng.uniform(0.01, 0.1), 3)
        elif action == "bitflip":
            arg = float(rng.randint(1, 4))
        events.append(ChaosEvent(site, action, arg, first=hit, last=hit))
    return events


def classify_exit(returncode: int, stderr: str = "") -> str:
    """Classify one attempt's exit: ``clean``, a known signal death,
    the watchdog's loud exit, a TYPED error, or ``unclassified`` — the
    last being invariant violation 2 (an untyped escape)."""
    if returncode == 0:
        return "clean"
    if returncode == -9 or returncode == 137:
        return "killed"
    if returncode == -15 or returncode == 143:
        return "sigterm"
    if returncode == WATCHDOG_EXIT_CODE:
        return "watchdog"
    for name in TYPED_ERRORS:
        if name in stderr:
            return f"typed:{name}"
    return "unclassified"


@dataclasses.dataclass
class CampaignResult:
    seed: int
    events: List[ChaosEvent]
    attempts: List[str]          # classification of each launch
    completed: bool
    violations: List[str]

    @property
    def ok(self) -> bool:
        return self.completed and not self.violations


def run_train_campaign(
        seed: int,
        launch: Callable[[str], Dict[str, Any]],
        verify: Optional[Callable[[], List[str]]] = None,
        max_launches: int = 6,
        n_events: Optional[int] = None,
        site_actions: Optional[Dict[str, Tuple[str, ...]]] = None,
) -> CampaignResult:
    """Run one seeded campaign.

    ``launch(faults_spec)`` runs the pipeline once under the given
    ``GYM_TPU_FAULTS`` spec and returns at least ``{"returncode": int,
    "stderr": str, "completed": bool}``. The FIRST launch is armed with
    the sampled schedule; every subsequent launch is fault-free — the
    scheduler-restarts-the-job model, identical to the kill harness.
    ``verify()`` runs after completion and returns violation strings
    (the caller owns the oracles: train.csv byte-compare, serve
    handoff); launch/verify exceptions are violations, not crashes of
    the campaign itself.
    """
    events = sample_schedule(seed, n_events=n_events,
                             site_actions=site_actions)
    attempts: List[str] = []
    violations: List[str] = []
    completed = False
    for i in range(max_launches):
        spec = faults_spec(events) if i == 0 else ""
        try:
            out = launch(spec)
        except Exception as e:  # noqa: BLE001 — harness bug, not SDC
            violations.append(
                f"launch {i} raised {type(e).__name__}: {e}")
            break
        cls = classify_exit(int(out.get("returncode", -1)),
                            str(out.get("stderr", "")))
        attempts.append(cls)
        if cls == "unclassified":
            violations.append(
                f"launch {i} died UNTYPED (rc={out.get('returncode')}): "
                f"{str(out.get('stderr', ''))[-500:]}")
            break
        if out.get("completed"):
            completed = True
            break
    if not completed and not violations:
        violations.append(
            f"campaign did not complete within {max_launches} launches "
            f"(attempts: {attempts})")
    if completed and verify is not None:
        try:
            violations.extend(verify())
        except Exception as e:  # noqa: BLE001 — oracle failure IS a finding
            violations.append(
                f"verify() raised {type(e).__name__}: {e}")
    return CampaignResult(seed=seed, events=events, attempts=attempts,
                          completed=completed, violations=violations)
