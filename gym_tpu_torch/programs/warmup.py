"""Background warmup: build every program of an engine's family off the
request path (counterpart of ``gym_tpu/programs/warmup.py``).

``WarmupThread`` walks ``ProgramDef``s through the registry in a daemon
thread at server construction. On the card each build is a CUDA-graph
capture, taken under the owning engine's dispatch lock (``ProgramDef.
lock``), one program at a time: a request waits for at most the capture in
flight and then finds its program built, or single-flights into the same
entry. On the CPU each build runs its program once, eagerly. Order is the
JAX warmup's: decode family first, then prefill buckets smallest first. A
program whose engine was torn down meanwhile (``ProgramOwnerClosedError``)
is skipped; any other failure aborts the warmup, logged, and never the
server it is warming.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from .registry import (ProgramDef, ProgramOwnerClosedError, ProgramRegistry,
                       default_registry)


class WarmupThread(threading.Thread):
    """Daemon thread building ``defs`` through ``registry``. ``stats()``
    reports progress (``/stats`` exports it); ``wait()`` blocks until
    done."""

    def __init__(self, defs: List[ProgramDef],
                 registry: Optional[ProgramRegistry] = None,
                 log=None):
        super().__init__(daemon=True, name="gym-tpu-torch-program-warmup")
        self._defs = list(defs)
        self.total = len(self._defs)
        # NOT `registry or ...`: an empty registry is falsy (__len__)
        self._registry = (registry if registry is not None
                          else default_registry())
        self._log = log
        # NOT named _stop: Thread.join calls self._stop() as a method
        self._stop_evt = threading.Event()
        self._done = threading.Event()
        self.warmed = 0
        self.skipped = 0
        self.seconds = 0.0

    def run(self) -> None:
        t0 = time.perf_counter()
        try:
            for d in self._defs:
                if self._stop_evt.is_set():
                    break
                try:
                    self._registry.acquire(d, eager=True)
                except ProgramOwnerClosedError:
                    self.skipped += 1
                    continue
                self.warmed += 1
                # yield between builds: a request waiting on the dispatch
                # lock should win the next slot
                time.sleep(0)
        except Exception as e:  # noqa: BLE001 — warmup must never kill
            if self._log is not None:  # the server it is warming
                self._log(f"gym_tpu_torch.programs: warmup aborted after "
                          f"{self.warmed}/{self.total} programs "
                          f"({type(e).__name__}: {e})\n")
        finally:
            self.seconds = time.perf_counter() - t0
            # the definitions hold their engines: a finished warmup must
            # not keep a torn-down engine (and its weights) alive
            self._defs = []
            self._done.set()
            if self._log is not None and not self._stop_evt.is_set():
                self._log(f"gym_tpu_torch.programs: warmup — {self.warmed}/"
                          f"{self.total} programs ready in "
                          f"{self.seconds:.2f}s\n")

    def stop(self) -> None:
        self._stop_evt.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def stats(self) -> Dict[str, object]:
        return {"total": self.total, "warmed": self.warmed,
                "done": self._done.is_set(),
                "seconds": round(self.seconds, 3)}


def warm_engine_programs(engines, registry: Optional[ProgramRegistry]
                         = None, *, start: bool = True,
                         log=None) -> WarmupThread:
    """Warmup thread over the program families
    (``InferenceEngine.warmup_defs``) of one engine or a list of them: a
    graph belongs to one engine, so a fleet warms every replica's."""
    if not isinstance(engines, (list, tuple)):
        engines = [engines]
    defs = [d for eng in engines for d in eng.warmup_defs()]
    t = WarmupThread(defs, registry=registry, log=log)
    if start:
        t.start()
    return t
