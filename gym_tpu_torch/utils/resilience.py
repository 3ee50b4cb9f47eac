"""Host-resilience layer: fault injection, retry policy, watchdog.

The device side already simulates node failures (``strategy/faults.py``
partial participation); this module is the HOST side of the fault story —
the failures real TPU fleets see between the accelerator and the
filesystem: preemption, torn checkpoint writes, transient IO errors,
hung threads. Three independent pieces:

- **Fault injection** (``fault_point`` / ``faults``): named sites in the
  host pipeline where tests and the kill harness deterministically
  inject crashes, errors, delays, or hangs. Sites are hit-counted per
  process, so "die at the 3rd dispatch boundary" reproduces exactly.
  Configured programmatically (``faults.install``) or via the
  ``GYM_TPU_FAULTS`` env var, which is how the subprocess kill harness
  arms a child run.
- **Retry policy** (``RetryPolicy`` / ``with_retries``): exponential
  backoff + jitter for transient IO, wrapped around checkpoint writes so
  one flaky ``OSError`` no longer poisons the run via the writer
  thread's error latch.
- **Watchdog** (``Watchdog``): monitors named blocking regions (a
  dispatch drain, a checkpoint write) and, if one exceeds its deadline,
  dumps EVERY thread's stack and fails the process loudly — a hung run
  becomes a diagnosable crash instead of an eternal silent stall.

Registered fault sites (each lists who fires it):

====================== ====================================================
``checkpoint.write``    ``CheckpointManager._write`` — per write attempt
``checkpoint.device_get`` checkpoint writer thread, before the snapshot fetch
``prefetch.fill``       ``HostPrefetcher`` worker, before each batch assembly
``dispatch.boundary``   Trainer fit loop, top of every dispatch iteration
``serve.prefill``       ``InferenceEngine.admit``, before the prefill dispatch
``serve.decode``        ``InferenceEngine.step``, before the decode dispatch
``serve.admit``         ``Scheduler.submit``, before admission control
``serve.http``          ``gym_tpu.serve`` HTTP handler, top of ``POST``
``checkpoint.bytes``    ``integrity.corrupt_checkpoint_files``, after every
                        finalized checkpoint save (corruption-only site)
``wire.frame``          ``serve/wire.py:encode_frame``, every outgoing
                        frame's encoded bytes (corruption-only site)
``dispatch.state``      ``integrity.corrupt_state_tree``, top of every
                        dispatch iteration (corruption-only site)
====================== ====================================================

``GYM_TPU_FAULTS`` spec: comma-separated ``site:action[=arg][@window]``
where action is one of ``kill`` (SIGKILL self — simulated preemption
without grace), ``sigterm`` (SIGTERM self — preemption WITH grace, the
Trainer's handler takes an emergency checkpoint), ``oserror`` (raise
``OSError``), ``delay`` (sleep ``arg`` seconds), ``hang`` (sleep
``arg or 3600`` seconds — watchdog bait), ``bitflip=<n>`` (flip ``n``
deterministically-random bits of the site's payload — silent data
corruption), or ``truncate[=n]`` (drop the payload's last ``n`` bytes,
default half — a torn write); and window is ``@N`` (Nth hit only,
1-based), ``@N-M`` (hits N..M), or ``@N+`` (every hit from N). Default
window: every hit. ``bitflip``/``truncate`` only take effect at the
corruption-capable sites, which pass their payload through
``faults.corrupt``; at plain ``fault_point`` sites they count the hit
and do nothing. Example::

    GYM_TPU_FAULTS="checkpoint.write:oserror@1-2,dispatch.boundary:kill@5"
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import sys
import threading
import time
import traceback
import zlib
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional, Tuple

FAULT_SITES = (
    "checkpoint.write",
    "checkpoint.device_get",
    "prefetch.fill",
    "dispatch.boundary",
    "serve.prefill",
    "serve.decode",
    "serve.admit",
    "serve.http",
    "checkpoint.bytes",
    "wire.frame",
    "dispatch.state",
)

_ACTIONS = ("kill", "sigterm", "oserror", "delay", "hang",
            "bitflip", "truncate")

#: Actions that transform a payload instead of performing a side effect.
#: They fire only through ``FaultRegistry.corrupt`` / ``fire_matched`` —
#: a plain ``fault_point`` has no bytes to corrupt.
_CORRUPT_ACTIONS = ("bitflip", "truncate")


class InjectedFault(OSError):
    """The error raised by an ``oserror`` fault — an ``OSError`` subclass
    so retry policies treat it exactly like a real transient IO error,
    but distinguishable in test assertions."""


class WatchdogTimeoutError(RuntimeError):
    """A watchdog-protected region exceeded its deadline and the run is
    being failed loudly (thread stacks already dumped to stderr). Typed
    so callers distinguish a diagnosed hang from an ordinary error."""


@dataclasses.dataclass
class _Rule:
    site: str
    action: str
    arg: float = 0.0
    first: int = 1               # 1-based hit window [first, last]
    last: Optional[int] = None   # None = open-ended


class FaultRegistry:
    """Deterministic per-process fault injection over named sites."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[_Rule] = []
        self._hits: Dict[str, int] = {}

    def install(self, site: str, action: str, arg: float = 0.0,
                first: int = 1, last: Optional[int] = None) -> None:
        """Arm ``action`` at ``site`` for hit numbers in [first, last]
        (1-based; ``last=None`` means every hit from ``first``,
        ``last=first`` a single hit)."""
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        if site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {site!r}; registered: {FAULT_SITES}")
        with self._lock:
            self._rules.append(_Rule(site, action, arg, first, last))

    def configure(self, spec: str) -> None:
        """Parse a ``GYM_TPU_FAULTS``-format spec (see module docstring)."""
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            window = None
            if "@" in part:
                part, window = part.rsplit("@", 1)
            site, _, action = part.partition(":")
            arg = 0.0
            if "=" in action:
                action, argstr = action.split("=", 1)
                arg = float(argstr)
            first, last = 1, None
            if window:
                if window.endswith("+"):
                    first, last = int(window[:-1]), None
                elif "-" in window:
                    a, b = window.split("-", 1)
                    first, last = int(a), int(b)
                else:
                    first = last = int(window)
            self.install(site.strip(), action.strip(), arg, first, last)

    def reset(self) -> None:
        with self._lock:
            self._rules.clear()
            self._hits.clear()

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    @property
    def active(self) -> bool:
        return bool(self._rules)

    def fire(self, site: str) -> None:
        """Count a hit at ``site`` and perform any matching rule's action.
        Called via ``fault_point`` — a no-op (one attribute read) when no
        rules are armed."""
        self.fire_matched(site)

    def fire_matched(self, site: str) -> Tuple[int, List[_Rule]]:
        """Count a hit, PERFORM matching side-effect rules (kill, delay,
        ...) and return ``(hit, corruption_rules)`` — the hook for sites
        whose payload isn't plain bytes (``dispatch.state`` applies the
        returned ``bitflip`` rules to a live device tree itself)."""
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
            matched = [r for r in self._rules
                       if r.site == site and r.first <= n
                       and (r.last is None or n <= r.last)]
        corrupt_rules = []
        for r in matched:
            if r.action in _CORRUPT_ACTIONS:
                corrupt_rules.append(r)
            else:
                self._perform(r, site, n)
        return n, corrupt_rules

    def corrupt(self, site: str, data: bytes) -> bytes:
        """Count a hit at ``site`` and pass ``data`` through any matching
        ``bitflip``/``truncate`` rules (side-effect rules still perform).
        Deterministic: corrupted positions are seeded from site + hit
        number, so a campaign seed reproduces the exact same wrong
        bytes. Returns ``data`` unchanged when nothing matches."""
        n, rules = self.fire_matched(site)
        out = data
        for r in rules:
            if out:
                out = self._corrupt_payload(out, r, site, n)
        return out

    @staticmethod
    def _corrupt_payload(data: bytes, rule: _Rule, site: str,
                         hit: int) -> bytes:
        tag = f"injected fault at {site} (hit {hit})"
        rng = random.Random(zlib.crc32(f"{site}:{hit}".encode()))
        if rule.action == "bitflip":
            buf = bytearray(data)
            nbits = max(1, int(rule.arg))
            for _ in range(nbits):
                buf[rng.randrange(len(buf))] ^= 1 << rng.randrange(8)
            sys.stderr.write(
                f"{tag}: bitflip {nbits} bit(s) in {len(buf)} bytes\n")
            sys.stderr.flush()
            return bytes(buf)
        if rule.action == "truncate":
            drop = int(rule.arg) or max(1, len(data) // 2)
            drop = min(drop, len(data))
            sys.stderr.write(
                f"{tag}: truncate last {drop} of {len(data)} bytes\n")
            sys.stderr.flush()
            return data[:len(data) - drop]
        return data

    @staticmethod
    def _perform(rule: _Rule, site: str, hit: int) -> None:
        tag = f"injected fault at {site} (hit {hit})"
        if rule.action == "kill":
            sys.stderr.write(f"{tag}: SIGKILL\n")
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        elif rule.action == "sigterm":
            sys.stderr.write(f"{tag}: SIGTERM\n")
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGTERM)
        elif rule.action == "oserror":
            raise InjectedFault(f"{tag}: OSError")
        elif rule.action == "delay":
            time.sleep(rule.arg)
        elif rule.action == "hang":
            time.sleep(rule.arg or 3600.0)


#: Process-global registry. Armed from ``GYM_TPU_FAULTS`` at import time
#: (how the subprocess kill harness reaches a child run) and
#: programmatically by in-process tests (``faults.install`` /
#: ``faults.reset``).
faults = FaultRegistry()
faults.configure(os.environ.get("GYM_TPU_FAULTS", ""))


def fault_point(site: str) -> None:
    """Mark a named fault-injection site. Near-zero cost when no faults
    are armed; otherwise counts the hit and performs matching actions."""
    if faults.active:
        faults.fire(site)


def corrupt_point(site: str, data: bytes) -> bytes:
    """Payload-carrying twin of ``fault_point``: pass ``data`` through
    any armed corruption rules at ``site``. Returns ``data`` unchanged
    (no hit counted) when no faults are armed at all — the hot-path
    cost stays one attribute read, same contract as ``fault_point``."""
    if faults.active:
        return faults.corrupt(site, data)
    return data


# -- retry policy ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter for transient host IO.

    Delay before retry k (0-based) is
    ``min(max_delay, base_delay * factor**k) * (1 + U(-jitter, +jitter))``.
    ``attempts`` is the TOTAL number of tries, so ``attempts=1`` disables
    retrying.
    """

    attempts: int = 4
    base_delay: float = 0.1
    factor: float = 2.0
    max_delay: float = 5.0
    jitter: float = 0.25
    retry_on: Tuple[type, ...] = (OSError,)

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Defaults, overridable via ``GYM_TPU_IO_RETRIES`` /
        ``GYM_TPU_IO_RETRY_BASE_S`` / ``GYM_TPU_IO_RETRY_MAX_S`` — the
        kill harness shrinks the delays so crash tests stay fast."""
        return cls(
            attempts=int(os.environ.get("GYM_TPU_IO_RETRIES", 4)),
            base_delay=float(os.environ.get("GYM_TPU_IO_RETRY_BASE_S", 0.1)),
            max_delay=float(os.environ.get("GYM_TPU_IO_RETRY_MAX_S", 5.0)),
        )

    def delay(self, attempt: int, rng: Optional[random.Random] = None
              ) -> float:
        d = min(self.max_delay, self.base_delay * self.factor ** attempt)
        j = (rng or random).uniform(-self.jitter, self.jitter)
        return max(0.0, d * (1.0 + j))


def with_retries(fn: Callable, policy: RetryPolicy, *,
                 describe: str = "operation",
                 on_retry: Optional[Callable] = None,
                 rng: Optional[random.Random] = None):
    """Run ``fn()`` under ``policy``. Retries only ``policy.retry_on``
    exceptions; the final failure propagates unwrapped. ``on_retry(k, exc,
    delay)`` (1-based retry index) observes each retry; the default logs
    to stderr so silent-retry loops don't mask a dying filesystem.

    ``attempts`` is clamped to >= 1: ``GYM_TPU_IO_RETRIES=0`` (a natural
    spelling of "disable retries") must disable RETRYING, not silently
    skip the wrapped operation itself."""
    attempts = max(1, policy.attempts)
    for attempt in range(attempts):
        try:
            return fn()
        except policy.retry_on as e:
            if attempt == attempts - 1:
                raise
            d = policy.delay(attempt, rng)
            if on_retry is not None:
                on_retry(attempt + 1, e, d)
            else:
                sys.stderr.write(
                    f"gym_tpu: transient failure in {describe} "
                    f"(attempt {attempt + 1}/{policy.attempts}): "
                    f"{type(e).__name__}: {e}; retrying in {d:.2f}s\n")
            time.sleep(d)


# -- watchdog -------------------------------------------------------------


def dump_thread_stacks(header: str) -> str:
    """Every live thread's current stack, formatted — the payload a hung
    run leaves behind instead of an eternal silent stall. When the
    program registry reports compiled programs in flight, their keys
    lead the dump, so a wedged dispatch is attributable to a SPECIFIC
    compiled program, not just 'the main thread is inside jax'."""
    lines = [header]
    try:
        # Deferred + guarded: the registry pulls jax; the watchdog must
        # dump stacks even in a process where jax never imported.
        from ..programs.registry import inflight_programs
        inflight = inflight_programs()
    except Exception:
        inflight = {}
    if inflight:
        lines.append("in-flight registry programs (thread id -> key):")
        for tid, key in sorted(inflight.items()):
            lines.append(f"  thread {tid}: program {key}")
    frames = sys._current_frames()
    for t in threading.enumerate():
        lines.append(f"\n--- thread {t.name} (daemon={t.daemon}) ---")
        frame = frames.get(t.ident)
        if frame is None:
            lines.append("  <no frame>")
        else:
            lines.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(lines) + "\n"


class Watchdog:
    """Deadline monitor for named blocking regions.

    Wrap each potentially-hanging operation in ``with wd.watch(label):``.
    A monitor thread polls; if any active region outlives ``timeout``
    seconds the watchdog (once) dumps every thread's stack to stderr and
    fails the run: by default it interrupts the main thread and, if the
    process is still alive after a grace period (the main thread may be
    stuck inside a C call that never returns), hard-exits with status
    86 — loud death over silent hang. Tests pass ``on_timeout`` to
    observe the firing without killing the process.
    """

    EXIT_CODE = 86
    _GRACE_S = 10.0

    def __init__(self, timeout: float,
                 on_timeout: Optional[Callable[[str, str], None]] = None,
                 poll: Optional[float] = None):
        self.timeout = float(timeout)
        self._on_timeout = on_timeout
        self._poll = poll if poll is not None else min(
            1.0, max(0.05, self.timeout / 4.0))
        self._lock = threading.Lock()
        self._active: Dict[int, Tuple[str, float]] = {}
        self._next_token = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired: Optional[str] = None  # label of the region that fired

    def start(self) -> "Watchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._monitor, name="gym-tpu-watchdog", daemon=True)
            self._thread.start()
        return self

    @contextmanager
    def watch(self, label: str, timeout: Optional[float] = None):
        """Deadline-protect a blocking region."""
        deadline = time.monotonic() + (timeout or self.timeout)
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._active[token] = (label, deadline)
        try:
            yield
        finally:
            with self._lock:
                self._active.pop(token, None)

    def _monitor(self) -> None:
        while not self._stop.wait(self._poll):
            now = time.monotonic()
            with self._lock:
                expired = [label for label, dl in self._active.values()
                           if now > dl]
            if expired and self.fired is None:
                self._fire(expired[0])
                return

    def _fire(self, label: str) -> None:
        self.fired = label
        msg = dump_thread_stacks(
            f"gym_tpu watchdog: '{label}' exceeded {self.timeout:.0f}s — "
            f"dumping all thread stacks and failing the run")
        sys.stderr.write(msg)
        sys.stderr.flush()
        if self._on_timeout is not None:
            self._on_timeout(label, msg)
            return
        import _thread
        _thread.interrupt_main()
        # The main thread may be hung inside a C call KeyboardInterrupt
        # can't reach; a watchdog that can itself hang is no watchdog.
        if not self._stop.wait(self._GRACE_S):
            os._exit(self.EXIT_CODE)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def watch_or_null(wd: Optional[Watchdog], label: str):
    """``wd.watch(label)`` or a no-op context — callers wire the watchdog
    optionally without branching at every site."""
    return wd.watch(label) if wd is not None else nullcontext()
