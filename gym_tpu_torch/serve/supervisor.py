"""Self-healing driver loop: watchdog + engine rebuild on crash/wedge
(counterpart of ``gym_tpu/serve/supervisor.py``, on the port's ``Watchdog``
and ``dump_thread_stacks``).

The scheduler's ``run`` loop dies with its engine: an exception in a
dispatch unwinds the driver thread and every in-flight future waits
forever; a WEDGED dispatch (a hung kernel, an injected
``serve.decode:hang``) is worse — nothing unwinds at all. The
``Supervisor`` wraps the loop with the resilience primitives
(``utils/resilience.py``) so the HTTP server stays up through an engine
failure:

- every ``scheduler.step()`` runs inside a ``Watchdog.watch`` region
  (``serve.dispatch``); a dispatch that outlives ``dispatch_timeout_s``
  is declared wedged and the watchdog's callback triggers failover from
  its monitor thread — the stuck driver thread is ABANDONED, not joined
  (a thread hung inside a C call cannot be interrupted);
- failover: dump every thread's stack (the wedge evidence), fail all
  in-flight requests with a typed ``EngineFailedError`` (their KV-cache
  rows died with the engine), rebuild the engine via ``engine_factory``
  (the kernel library is loaded already; the new engine captures its own
  CUDA graphs, since a graph belongs to one engine), swap it into the
  scheduler, close the old engine (its graphs, staging buffers and
  caches; a wedged one only once its thread lets go), and start a fresh
  driver generation. Queued requests survive and resume on the new
  engine.
- the scheduler EPOCH (bumped by ``fail_inflight``) makes the abandoned
  thread harmless: when it finally wakes it finds the epoch advanced and
  discards its admissions and events instead of cross-talking with the
  new generation's slots.

``max_restarts`` bounds the crash loop: past it the supervisor declares
the engine unrecoverable, fails queued requests too, and stops — the
HTTP layer keeps answering (typed 503s), which is still better than a
silent hang.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Optional

from ..utils.resilience import Watchdog, dump_thread_stacks
from .engine import InferenceEngine
from .scheduler import EngineFailedError, Scheduler


class Supervisor:
    """Run the scheduler's driver loop under a watchdog; on an engine
    exception or wedged dispatch, fail in-flight requests typed, rebuild
    the engine, and resume the queue.

    One supervisor per scheduler. ``start()`` spawns the driver thread;
    ``stop()`` is the graceful half of shutdown (the caller then runs
    ``scheduler.shutdown`` for the drain semantics).
    """

    def __init__(self, scheduler: Scheduler,
                 engine_factory: Callable[[], InferenceEngine], *,
                 dispatch_timeout_s: float = 120.0,
                 max_restarts: int = 5,
                 metrics=None,
                 idle_wait_s: float = 0.005,
                 on_dead: Optional[Callable[[BaseException], None]] = None,
                 log=print):
        """``on_dead(error)`` fires once, AFTER the supervisor declares
        the engine unrecoverable (queued requests already failed typed,
        ``failed`` set) — the fleet router hooks it to pull the replica
        out of dispatch the moment it dies instead of on the next
        health poll."""
        self.scheduler = scheduler
        self.engine_factory = engine_factory
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self.max_restarts = int(max_restarts)
        self.metrics = metrics
        self.idle_wait_s = float(idle_wait_s)
        self.on_dead = on_dead
        self._log = log
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._gen = 0
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[Watchdog] = None
        self.restarts = 0
        self.failed: Optional[BaseException] = None  # set past max_restarts

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Supervisor":
        with self._lock:
            self._spawn_locked(self._gen)
        return self

    def _spawn_locked(self, gen: int) -> None:
        """Start the driver thread for generation ``gen`` with a FRESH
        watchdog (a Watchdog fires at most once by design)."""
        wd = Watchdog(self.dispatch_timeout_s,
                      on_timeout=lambda label, msg, g=gen:
                      self._failover(g, EngineFailedError(
                          f"dispatch wedged past "
                          f"{self.dispatch_timeout_s:.0f}s watchdog "
                          f"deadline ({label})"), wedged=True)).start()
        self._watchdog = wd
        t = threading.Thread(target=self._drive, args=(gen, wd),
                             name=f"gym-tpu-torch-serve-driver-{gen}",
                             daemon=True)
        self._thread = t
        t.start()

    def _drive(self, gen: int, wd: Watchdog) -> None:
        sched = self.scheduler
        while not self._stop.is_set():
            with self._lock:
                if self._gen != gen:
                    return           # failed over past this generation
            try:
                with wd.watch("serve.dispatch"):
                    produced = sched.step()
            except Exception as e:  # noqa: BLE001 — ANY engine error
                # means this generation is over; the failover path
                # decides whether a rebuild is still allowed
                sys.stderr.write(
                    f"gym_tpu_torch.serve: engine exception in driver "
                    f"generation {gen}:\n{traceback.format_exc()}")
                self._failover(gen, EngineFailedError(
                    f"engine raised {type(e).__name__}: {e}"),
                    wedged=False)
                return
            with self._lock:
                # re-check AFTER the step: a thread that was failed over
                # past while wedged inside the dispatch must not tick
                # metrics against the new generation's engine
                if self._gen != gen:
                    return
            if self.metrics is not None:
                self.metrics.engine_tick(
                    sched.engine.stats, queue_depth=sched.queue_depth())
            if produced == 0:
                self._stop.wait(self.idle_wait_s)
        wd.close()

    # -- failover ---------------------------------------------------------

    def _failover(self, gen: int, error: BaseException,
                  wedged: bool) -> None:
        """Fail in-flight typed, rebuild the engine, start the next
        generation. Runs on the dying driver thread (exception path) or
        the watchdog monitor thread (wedge path) — never both for one
        generation: the gen check under the lock deduplicates."""
        with self._lock:
            if self._gen != gen or self._stop.is_set():
                return               # stale or already shutting down
            self._gen += 1
            new_gen = self._gen
            self.restarts += 1
            restarts = self.restarts
            old_wd = self._watchdog
        if wedged:
            # the watchdog already dumped stacks when it fired; this line
            # ties the dump to the supervisor's decision in the log
            self._log(f"gym_tpu_torch.serve: supervisor — driver generation "
                      f"{gen} wedged; abandoning its thread", flush=True)
        victims = self.scheduler.fail_inflight(error)
        self._log(f"gym_tpu_torch.serve: supervisor — engine failure "
                  f"({error}); failed {len(victims)} in-flight "
                  f"request(s) typed, restart {restarts}/"
                  f"{self.max_restarts}", flush=True)
        if restarts > self.max_restarts:
            self._declare_dead(error)
            return
        try:
            t0 = time.perf_counter()
            engine = self.engine_factory()
            self._log(f"gym_tpu_torch.serve: supervisor — engine rebuilt in "
                      f"{time.perf_counter() - t0:.2f}s, resuming queue "
                      f"(depth {self.scheduler.queue_depth()})",
                      flush=True)
        except Exception as e:  # noqa: BLE001 — a factory that cannot
            # rebuild (unreadable checkpoint, OOM) is unrecoverable
            sys.stderr.write(
                f"gym_tpu_torch.serve: supervisor — engine rebuild FAILED:\n"
                f"{traceback.format_exc()}")
            self._declare_dead(e)
            return
        old = self.scheduler.engine
        self.scheduler.replace_engine(engine)
        # a wedged driver still holds the old engine's dispatch lock:
        # close it without waiting (what it runs on stays until it lets go)
        old.close(wait_s=0.0 if wedged else 30.0)
        if self.metrics is not None:
            # counted HERE, after the swap: a terminal attempt that
            # never rebuilt must not inflate the restart observable
            self.metrics.engine_restarted()
        with self._lock:
            if self._stop.is_set():
                return
            self._spawn_locked(new_gen)
        if not wedged and old_wd is not None:
            old_wd.close()

    def _declare_dead(self, error: BaseException) -> None:
        # fail queued typed too — their futures must not wait forever
        self.scheduler.shutdown(finish_running=False, deadline_s=0.0)
        sys.stderr.write(dump_thread_stacks(
            f"gym_tpu_torch.serve: supervisor — engine unrecoverable after "
            f"{self.restarts} restart(s) ({error}); failing queued "
            f"requests and stopping the driver:"))
        sys.stderr.flush()
        # set LAST: anyone who observes `failed` may rely on the
        # scheduler already refusing new work
        self.failed = error
        if self.on_dead is not None:
            try:
                self.on_dead(error)
            except Exception:  # noqa: BLE001 — a broken death observer
                # must not mask the death itself
                sys.stderr.write(
                    f"gym_tpu_torch.serve: supervisor on_dead callback "
                    f"raised:\n{traceback.format_exc()}")

    # -- shutdown ---------------------------------------------------------

    def stop(self, join_timeout_s: float = 300.0) -> bool:
        """Signal the driver loop to exit and join it. Returns True when
        the driver exited (safe to run ``scheduler.shutdown`` from the
        caller); False means the driver is wedged mid-dispatch — do NOT
        touch the engine from another thread in that case."""
        self._stop.set()
        with self._lock:
            t, wd = self._thread, self._watchdog
        if t is not None:
            t.join(timeout=join_timeout_s)
        if wd is not None:
            wd.close()
        return t is None or not t.is_alive()

    @property
    def generation(self) -> int:
        with self._lock:
            return self._gen

    def status(self) -> dict:
        # engine_restarts (actual rebuilds) deliberately lives in
        # ServeMetrics — ONE source of truth for /stats; `restarts` here
        # counts failover ATTEMPTS (incl. a terminal one)
        return {"engine_generation": self.generation,
                "engine_dead": self.failed is not None}
