"""The device-program registry (counterpart of ``gym_tpu/programs/
registry.py``): one keyed, observable owner of the serving engine's CUDA
graphs.

The JAX registry stores XLA executables; here an entry is a built program
of ``programs.graphs.StagedProgram``: on the card, a CUDA graph captured
once and replayed; on the CPU, the same program run eagerly. The semantics
are the JAX registry's:

- **Single flight.** Programs are keyed by ``programs.keys.program_key``.
  N threads asking for one key build it once: the first holds the key's
  build lock, the rest block on it and share the result. A ``ProgramDef``
  may name an owner's lock (``lock``): every build of it holds that lock
  first, so a capture never overlaps its engine's dispatches and a request
  waits for at most the one capture in flight. Builds are serialised
  process-wide (one capture at a time).
- **Pinning.** ``acquire(pin_owner=...)`` pins an entry for the owner's
  lifetime (a weakref finalizer unpins it); a pinned entry is never
  evicted.
- **LRU eviction** of unpinned entries past ``capacity``; ``discard``
  drops an owner's entries when it is torn down.

What the counters count (``counters()``, exported by ``/stats`` and
``serve.csv``):

- ``builds``: programs this registry built (each a capture on the card);
  ``hits``: acquisitions answered by a built entry.
- ``graphs_captured``: the builds that captured a CUDA graph. A graph
  holds device addresses of one process and one engine: a restart, a
  supervisor rebuild and a hot swap capture again.
- ``xla_compiles`` (``programs_compiled`` in ``/stats``): the ``nvcc``
  builds of the kernel library (``ops/_build.py``) that this process ran.
  The library is the one artifact that persists across processes, in its
  build directory (``use_program_cache_dir``, the server's
  ``--program-cache-dir``), so a restart against a warm build directory
  counts 0. ``disk_hits``: the loads answered by that directory.
- ``compile_seconds``: wall seconds inside builds (warm-up run, capture).

There is no disk tier for programs: a CUDA graph cannot outlive its
process. ``enable_disk_tier`` refuses by name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..ops import _build
from .keys import program_key


class ProgramOwnerClosedError(RuntimeError):
    """The program's owner (an engine) was torn down before the build ran:
    there is nothing to capture against. The warmup skips such a program;
    a caller that still holds the owner gets this error typed."""


def _library_counters() -> Tuple[int, int]:
    return _build.stats["nvcc_builds"], _build.stats["cache_hits"]


def disk_event_counters() -> Dict[str, int]:
    """The kernel library's build-directory events of this process: loads
    answered by the directory and builds that ran ``nvcc`` (the JAX
    registry's persistent-cache hit and miss counters)."""
    builds, hits = _library_counters()
    return {"xla_cache_hits": hits, "xla_cache_misses": builds}


def enable_disk_tier(cache_dir: Optional[str] = None, **_kw) -> str:
    raise NotImplementedError(
        "enable_disk_tier: a CUDA graph holds device addresses of one "
        "process and cannot be stored on disk; the kernel library is the "
        "artifact a restart reuses — name its build directory with "
        "use_program_cache_dir (the server's --program-cache-dir)")


def use_program_cache_dir(path: str) -> str:
    """Build and load the kernel library in ``path`` (before the first
    kernel launch of the process); returns the absolute path."""
    return _build.use_build_dir(path)


#: serialises builds process-wide: one capture at a time
_BUILD_LOCK = threading.Lock()


@dataclasses.dataclass
class ProgramDef:
    """One registrable program: enough to compute its key without building
    it (``args`` are its inputs' ``(shape, dtype)`` descriptors) and to
    build it on demand. ``builder()`` returns the callable, whose
    ``captured`` attribute says whether it is a CUDA graph. ``lock``, when
    given, is held around every build (the owning engine's dispatch
    lock)."""

    name: str
    config: Dict[str, Any]
    args: Tuple[Any, ...]
    builder: Callable[[], Callable]
    lock: Any = None

    def key(self) -> Tuple[str, str]:
        return program_key(self.name, self.config, self.args)


class Program:
    """Callable handle to a registry entry. ``ensure()`` builds (or joins
    the single-flight build of) the program; ``__call__`` ensures, then
    runs it. After the first ensure the program is cached on the handle:
    the hot path never re-enters the registry."""

    __slots__ = ("_registry", "_key_hash", "_fn", "name")

    def __init__(self, registry: "ProgramRegistry", key_hash: str,
                 name: str):
        self._registry = registry
        self._key_hash = key_hash
        self._fn: Optional[Callable] = None
        self.name = name

    @property
    def key_hash(self) -> str:
        return self._key_hash

    def ensure(self) -> Callable:
        if self._fn is None:
            self._fn, _ = self._registry._ensure_built(self._key_hash)
        return self._fn

    def ensure_reporting(self) -> bool:
        """Ensure built; True iff THIS call ran the build (the exact
        per-key build observable: a global counter's difference would
        charge a concurrent warmup's builds to this call)."""
        if self._fn is not None:
            return False
        self._fn, built_now = self._registry._ensure_built(self._key_hash)
        return built_now

    def __call__(self, *args, **kwargs):
        fn = self._fn
        if fn is None:
            fn = self.ensure()
        tid = threading.get_ident()
        _INFLIGHT[tid] = f"{self.name} [{self._key_hash[:12]}]"
        try:
            return fn(*args, **kwargs)
        finally:
            _INFLIGHT.pop(tid, None)


@dataclasses.dataclass
class _Entry:
    pdef: Optional[ProgramDef]
    name: str
    fn: Optional[Callable] = None
    pins: int = 0
    build_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)


class ProgramRegistry:
    """Keyed, bounded, single-flight store of built device programs.

    Thread-safe. ``acquire`` registers a key and returns a handle without
    building; the build happens at ``ensure`` or the first call, or at
    once with ``eager=True`` (what the warmup thread does)."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.RLock()
        self._store: "OrderedDict[str, _Entry]" = OrderedDict()
        self._hits = 0
        self._builds = 0
        self._graphs = 0
        self._compile_seconds = 0.0
        self._evictions = 0

    # -- introspection ----------------------------------------------------

    def counters(self) -> Dict[str, Any]:
        builds, hits = _library_counters()
        with self._lock:
            return {
                "hits": self._hits,
                "builds": self._builds,
                "xla_compiles": builds,
                "disk_hits": hits,
                "compile_seconds": round(self._compile_seconds, 4),
                "evictions": self._evictions,
                "programs": len(self._store),
                "graphs_captured": self._graphs,
            }

    def keys(self) -> Dict[str, str]:
        """``{key_hash: program name}`` for every registered program."""
        with self._lock:
            return {k: e.name for k, e in self._store.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    # -- registration / acquisition ---------------------------------------

    def _register_locked(self, key_hash: str, pdef: ProgramDef) -> None:
        ent = self._store.get(key_hash)
        if ent is None:
            self._store[key_hash] = _Entry(pdef=pdef, name=pdef.name)
            self._evict_over_capacity_locked(protect=key_hash)
        elif ent.pdef is None:
            ent.pdef = pdef

    def acquire(self, pdef: ProgramDef, *, eager: bool = False,
                pin_owner: Optional[object] = None) -> Program:
        """Handle for ``pdef``'s program. ``eager=True`` builds before
        returning (single flight). ``pin_owner`` pins the entry against
        eviction for the owner's lifetime. Registration, pin and eviction
        happen atomically, so a pinned acquire into a fully pinned store
        runs over capacity instead of evicting what it hands out."""
        _canon, key_hash = pdef.key()
        with self._lock:
            self._register_locked(key_hash, pdef)
            self._store.move_to_end(key_hash)
            if pin_owner is not None:
                self._pin_locked(key_hash, pin_owner)
            self._evict_over_capacity_locked(protect=key_hash)
        h = Program(self, key_hash, pdef.name)
        if eager:
            h.ensure()
        return h

    def unpin(self, key_hash: str) -> None:
        with self._lock:
            ent = self._store.get(key_hash)
            if ent is not None and ent.pins > 0:
                ent.pins -= 1

    def _pin_locked(self, key_hash: str, owner: Optional[object]) -> None:
        ent = self._store[key_hash]
        ent.pins += 1
        if owner is not None:
            weakref.finalize(owner, self.unpin, key_hash)

    def discard(self, key_hashes: Iterable[str]) -> List[Callable]:
        """Drop these entries whatever their pins (their owner was torn
        down: nothing can run them any more); returns the programs that
        were built, for the owner to free."""
        built = []
        with self._lock:
            for k in key_hashes:
                ent = self._store.pop(k, None)
                if ent is not None and ent.fn is not None:
                    built.append(ent.fn)
        return built

    # -- build path --------------------------------------------------------

    def _ensure_built(self, key_hash: str) -> Tuple[Callable, bool]:
        """Returns ``(callable, built_now)``: ``built_now`` is True only
        for the one caller that ran the build."""
        with self._lock:
            ent = self._store.get(key_hash)
            if ent is None:
                raise KeyError(
                    f"program {key_hash} was evicted before it was "
                    f"built — re-acquire it from its ProgramDef")
            if ent.fn is not None:
                self._hits += 1
                self._store.move_to_end(key_hash)
                return ent.fn, False
            if ent.pdef is None:
                raise KeyError(
                    f"program {key_hash} ({ent.name}) was registered "
                    f"key-only — acquire it with a full ProgramDef")
            build_lock, pdef = ent.build_lock, ent.pdef
        # the owner's lock first, then the key's: the owner's dispatching
        # thread already holds its own lock when it asks for a program
        owner_lock = (pdef.lock if pdef.lock is not None
                      else contextlib.nullcontext())
        with owner_lock, build_lock:                 # single flight
            with self._lock:
                if ent.fn is not None:
                    self._hits += 1
                    return ent.fn, False
            with _BUILD_LOCK:
                t0 = time.perf_counter()
                fn = pdef.builder()
                dt = time.perf_counter() - t0
            with self._lock:
                ent.fn = fn
                self._builds += 1
                self._graphs += int(bool(getattr(fn, "captured", False)))
                self._compile_seconds += dt
            return fn, True

    # -- eviction ----------------------------------------------------------

    def _evict_over_capacity_locked(self,
                                    protect: Optional[str] = None) -> None:
        """LRU-evict unpinned entries past capacity. Pinned entries, the
        key being registered (``protect``) and entries whose build is in
        flight are never evicted: if everything is held the store runs
        over capacity rather than dropping a live program."""
        while len(self._store) > self.capacity:
            victim = None
            for k, e in self._store.items():          # oldest first
                if (e.pins == 0 and k != protect
                        and not e.build_lock.locked()):
                    victim = k
                    break
            if victim is None:
                return
            del self._store[victim]
            self._evictions += 1


# -- in-flight dispatch tracking -------------------------------------------

#: thread ident -> program name for every registry program running now;
#: the watchdog's stack dump names the program a wedged dispatch is in
_INFLIGHT: Dict[int, str] = {}


def inflight_programs() -> Dict[int, str]:
    """Snapshot of registry programs currently running, by thread ident."""
    return dict(_INFLIGHT)


# -- the process-wide registry ---------------------------------------------

_DEFAULT = ProgramRegistry()


def default_registry() -> ProgramRegistry:
    """The registry every engine and server of the process shares."""
    return _DEFAULT


def xla_compile_counter() -> int:
    """``nvcc`` builds of the kernel library this process ran: the restart
    drill's ``programs_compiled`` (0 against a warm build directory)."""
    return _library_counters()[0]


def graphs_captured_counter() -> int:
    """CUDA graphs the default registry has captured."""
    return _DEFAULT.counters()["graphs_captured"]
