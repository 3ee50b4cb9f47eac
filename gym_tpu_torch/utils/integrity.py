"""Silent-data-corruption defense: integrity tags and the training guard
(counterpart of ``gym_tpu/utils/integrity.py``).

- **crc32c** and the **checkpoint sidecars** (``write_sidecar`` /
  ``verify_sidecar``, the typed errors, the ``checkpoint.bytes`` site
  ``corrupt_checkpoint_files``): a copy of the JAX package's stdlib-only
  code, held to it line for line by ``tests/test_torch_isolation.py``
  (two docstring lines reworded). Where the port's kernel library is built
  (the machine with the card), ``crc32c`` is replaced by the library's C
  twin at the end of this module, as the stdlib replaces a pure-Python
  definition by its accelerated one: the same values at disk speed, where
  the Python loop hashes a few MB/s and a GPT-2 base step dir holds 4 GB.
- **Tree fingerprints** on nested dicts, lists and dataclasses of tensors:
  ``tree_fingerprint`` is one f32 sum that stays where the tensors are
  (the guard's on-card probe, read one step late with the loss),
  ``tree_fingerprint_host`` the float64 twin written into sidecars.
- ``corrupt_state_tree``: the ``dispatch.state`` fault hook. It flips
  exponent bits of the largest float tensor at the positions the JAX
  package flips for the same site and hit, so one spec corrupts the same
  element in both.
- **Training guard** (``Guard``, ``GuardRuntime``, ``_InnerGuard``): plain
  Python, copied line for line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import sys
import zlib
from typing import Any, Dict, List, Optional, Tuple

PyTree = Any

SIDECAR_NAME = "integrity.json"

# -- crc32c (Castagnoli, reflected 0x82F63B78) -----------------------------

_CRC32C_POLY = 0x82F63B78


def _build_tables() -> List[List[int]]:
    t0 = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([t0[prev[n] & 0xFF] ^ (prev[n] >> 8)
                       for n in range(256)])
    return tables


_T = _build_tables()


def crc32c(data: bytes, crc: int = 0) -> int:
    """crc32c of ``data`` (chainable via ``crc``). Slicing-by-8: 8 bytes
    per loop iteration keeps pure-Python hashing usable on multi-MB
    checkpoint shards."""
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    crc = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    mv = memoryview(data)
    n8 = len(mv) - (len(mv) % 8)
    i = 0
    while i < n8:
        b0, b1, b2, b3, b4, b5, b6, b7 = mv[i:i + 8]
        crc ^= b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
               ^ t3[b4] ^ t2[b5] ^ t1[b6] ^ t0[b7])
        i += 8
    for b in mv[n8:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def checksum_file(path: str, chunk_bytes: int = 1 << 20
                  ) -> Tuple[int, int]:
    """``(crc32c, size)`` of a file, streamed (shards never fully
    buffered)."""
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            crc = crc32c(block, crc)
            size += len(block)
    return crc, size


# -- typed errors ----------------------------------------------------------


class IntegrityError(RuntimeError):
    """Base class for every integrity violation this module detects."""


class ChecksumMismatchError(IntegrityError):
    """Stored checksum disagrees with the bytes on disk — the content
    changed after it was written (bit rot, torn write, injected
    corruption). The checkpoint restore fallback quarantines on this."""


class GuardTrippedError(RuntimeError):
    """The training guard detected a per-dispatch invariant violation
    (non-finite or spiking loss, fingerprint jump). ``fit(guard=...)``
    catches this to roll back and replay; with rollback exhausted or
    unconfigured it propagates to the caller. Not an ``IntegrityError``
    subclass: a loss spike is an ANOMALY, not proof of bad bytes."""

    def __init__(self, message: str, step: Optional[int] = None,
                 reason: str = ""):
        super().__init__(message)
        self.step = step
        self.reason = reason


# -- checkpoint sidecars ---------------------------------------------------


def _walk_files(step_dir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            if name == SIDECAR_NAME:
                continue
            full = os.path.join(root, name)
            out.append(os.path.relpath(full, step_dir))
    return sorted(out)


def write_sidecar(step_dir: str,
                  fingerprint: Optional[Dict[str, Any]] = None) -> str:
    """Hash every file under ``step_dir`` into
    ``<step_dir>/integrity.json`` (atomic: tmp + fsync + rename). Called
    right after the step's files are written; the sidecar travels with the
    step dir through pruning and quarantine for free."""
    record: Dict[str, Any] = {"algo": "crc32c", "files": {}}
    for rel in _walk_files(step_dir):
        crc, size = checksum_file(os.path.join(step_dir, rel))
        record["files"][rel] = {"crc32c": f"{crc:08x}", "size": size}
    if fingerprint is not None:
        record["fingerprint"] = fingerprint
    path = os.path.join(step_dir, SIDECAR_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def verify_sidecar(step_dir: str) -> bool:
    """Re-hash ``step_dir`` against its sidecar. Returns True when
    verified, False when no sidecar exists (a sidecar-less checkpoint:
    accepted, soft-degrade). Raises ``ChecksumMismatchError`` on any
    missing file or crc/size mismatch — the typed signal the restore
    fallback quarantines on."""
    path = os.path.join(step_dir, SIDECAR_NAME)
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ChecksumMismatchError(
            f"unreadable integrity sidecar {path}: "
            f"{type(e).__name__}: {e}") from e
    bad = []
    for rel, want in sorted(record.get("files", {}).items()):
        full = os.path.join(step_dir, rel)
        if not os.path.exists(full):
            bad.append(f"{rel}: file missing")
            continue
        crc, size = checksum_file(full)
        if size != int(want.get("size", -1)):
            bad.append(f"{rel}: size {size} != recorded {want['size']}")
        elif f"{crc:08x}" != want.get("crc32c"):
            bad.append(
                f"{rel}: crc32c {crc:08x} != recorded {want['crc32c']}")
    if bad:
        raise ChecksumMismatchError(
            f"checkpoint content mismatch under {step_dir} "
            f"({len(bad)} file(s)): " + "; ".join(bad))
    return True


def corrupt_checkpoint_files(step_dir: str) -> None:
    """The ``checkpoint.bytes`` fault site: pass the LARGEST file in a
    just-written step dir (deterministically the array shard) through
    the corruption registry. A no-op (beyond the hit count) unless a
    ``bitflip``/``truncate`` rule is armed there."""
    from .resilience import faults
    if not faults.active:
        return
    candidates = [(os.path.getsize(os.path.join(step_dir, rel)), rel)
                  for rel in _walk_files(step_dir)]
    if not candidates:
        faults.fire("checkpoint.bytes")  # keep the hit count honest
        return
    _size, rel = max(candidates)
    path = os.path.join(step_dir, rel)
    with open(path, "rb") as f:
        data = f.read()
    out = faults.corrupt("checkpoint.bytes", data)
    if out != data:
        with open(path, "wb") as f:
            f.write(out)
            f.flush()
            os.fsync(f.fileno())


# -- tree fingerprints -----------------------------------------------------


def _leaves(tree: PyTree, path: Tuple = ()):
    """``(path, leaf)`` in the JAX package's flatten order: dict keys
    sorted, lists and tuples in order, a dataclass's fields in order; None
    is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (f.name,))
    elif tree is not None:
        yield path, tree


def _replace_at(tree: PyTree, path: Tuple, leaf) -> PyTree:
    """A copy of ``tree`` with the leaf at ``path`` replaced; the
    containers along the path are new, everything else is shared."""
    if not path:
        return leaf
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {**tree, head: _replace_at(tree[head], rest, leaf)}
    if isinstance(tree, (list, tuple)):
        out = list(tree)
        out[head] = _replace_at(tree[head], rest, leaf)
        return type(tree)(out)
    return dataclasses.replace(
        tree, **{head: _replace_at(getattr(tree, head), rest, leaf)})


def tree_fingerprint(tree: PyTree):
    """Folded f32 sum over every numeric tensor — ONE 0-d tensor that
    moves when any value moves, left where the tensors are (on the card the
    guard reads it with the step's loss, one step late). Used by the
    training guard (finiteness and jump detection), NOT for byte integrity
    — that is crc32c's job."""
    import torch
    total = None
    for _path, leaf in _leaves(tree):
        if torch.is_tensor(leaf) and leaf.dtype != torch.bool \
                and not leaf.is_complex():
            s = leaf.detach().float().sum()
            total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total


def tree_fingerprint_host(tree: PyTree) -> Optional[Dict[str, Any]]:
    """Float64 twin of ``tree_fingerprint``, recorded in the checkpoint
    sidecar: per-leaf float64 sums folded (computed where each tensor is,
    so a snapshot on the card is summed there), numpy arrays included; the
    leaf count pins the tree shape."""
    import numpy as np
    import torch
    sums = []  # a leaf's float64 sum: a 0-d tensor or a float
    for _path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            sums.append(leaf.detach().to(torch.float64).sum())
        elif isinstance(leaf, np.ndarray) and leaf.dtype.kind in ("f", "i",
                                                                  "u", "b"):
            sums.append(float(np.sum(leaf.astype(np.float64))))
    # one read-back a device, not one a leaf
    on = {}
    for s in sums:
        if torch.is_tensor(s):
            on.setdefault(s.device, []).append(s)
    host = {dev: iter(torch.stack(ts).cpu().tolist())
            for dev, ts in on.items()}
    total = 0.0
    for s in sums:
        total += next(host[s.device]) if torch.is_tensor(s) else s
    return {"sum": total, "num_leaves": len(sums)}


def corrupt_state_tree(tree: PyTree) -> PyTree:
    """The ``dispatch.state`` fault hook: when a ``bitflip`` rule
    matches this hit, flip exponent bits in the LARGEST float tensor of
    the live tree (the first of equal sizes in the JAX package's leaf
    order; positions seeded by site+hit, as there). Exponent bits are the
    worst-case SDC — a huge, silent value change the guard must catch.
    Returns the (possibly corrupted) tree; the corrupted tensor is a new
    one on the leaf's device, the live one is not written."""
    from .resilience import faults
    if not faults.active:
        return tree
    hit, rules = faults.fire_matched("dispatch.state")
    rules = [r for r in rules if r.action == "bitflip"]
    if not rules:
        return tree
    import torch
    floats = [(path, leaf) for path, leaf in _leaves(tree)
              if torch.is_tensor(leaf) and leaf.is_floating_point()]
    if not floats:
        return tree
    path, leaf = max(floats, key=lambda pl: pl[1].numel())
    arr = leaf.detach().to("cpu", copy=True).contiguous()
    itemsize = arr.element_size()
    view = arr.reshape(-1).view(torch.uint8).reshape(arr.numel(), itemsize)
    rng = random.Random(zlib.crc32(f"dispatch.state:{hit}".encode()))
    nbits = sum(max(1, int(r.arg)) for r in rules)
    for _ in range(nbits):
        el = rng.randrange(arr.numel())
        # little-endian: the top byte of a float holds sign + exponent
        # MSBs; 0x40 lands on an exponent bit for f32/f16/bf16/f64
        view[el, itemsize - 1] ^= 0x40
    sys.stderr.write(
        f"injected fault at dispatch.state (hit {hit}): flipped {nbits} "
        f"exponent bit(s) in a {tuple(arr.shape)} {arr.dtype} state leaf\n")
    sys.stderr.flush()
    return _replace_at(tree, path, arr.to(leaf.device))


# -- training guard --------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Guard:
    """Anomaly-detection policy for ``Trainer.fit(guard=...)``.

    Per-drained-step checks: loss must be finite, and past ``warmup``
    observations it must stay under
    ``max(spike_factor * ewma, ewma + spike_slack)`` — the factor term
    scales with the loss, the absolute slack keeps near-zero converged
    losses from tripping on noise. ``fingerprint_interval`` > 0 adds an
    on-device state-fingerprint probe every N steps (finiteness + a
    relative-jump bound of ``fingerprint_factor``) — the channel that
    sees strategy-state corruption a healthy-looking loss can hide
    until the next outer sync. ``max_rollbacks`` bounds the
    rollback-and-replay loop; a trip past the budget propagates."""

    ewma_alpha: float = 0.2
    spike_factor: float = 3.0
    spike_slack: float = 2.0
    warmup: int = 3
    fingerprint_interval: int = 0
    fingerprint_factor: float = 1e3
    max_rollbacks: int = 2


class GuardRuntime:
    """Mutable guard state, carried ACROSS rollback-and-replay attempts
    (the config dataclass stays frozen). ``observe_loss`` /
    ``observe_fingerprint`` raise ``GuardTrippedError``;
    ``note_rollback`` resets the statistics (the EWMA saw corrupt
    losses) and counts the attempt."""

    def __init__(self, cfg: Optional[Guard] = None):
        self.cfg = cfg or Guard()
        self.rollbacks = 0
        self.trips: List[Tuple[int, str]] = []
        self._reset_stats()

    def _reset_stats(self) -> None:
        self._ewma: Optional[float] = None
        self._seen = 0
        self._last_fp: Optional[float] = None

    def note_rollback(self) -> None:
        self.rollbacks += 1
        self._reset_stats()

    def _trip(self, step: int, reason: str) -> None:
        self.trips.append((step, reason))
        raise GuardTrippedError(
            f"training guard tripped at step {step}: {reason}",
            step=step, reason=reason)

    def observe_loss(self, step: int, loss: float,
                     worst: Optional[float] = None) -> None:
        """``loss`` is the canonical (node 0) value that drives the EWMA;
        ``worst`` is the max across data-parallel nodes and is what the
        trip checks run on. A bitflip in ONE node's replica shows up in
        that node's loss a full step before the all-reduce spreads it —
        checking only the logged loss lets a checkpoint boundary commit
        the corrupt state under a valid sidecar in that window."""
        if worst is None:
            worst = loss
        if not math.isfinite(worst):
            self._trip(step, f"non-finite loss {worst!r}")
        cfg = self.cfg
        if self._ewma is not None and self._seen >= cfg.warmup:
            bound = max(cfg.spike_factor * abs(self._ewma),
                        self._ewma + cfg.spike_slack)
            if worst > bound:
                self._trip(
                    step,
                    f"loss spike {worst:.6g} > bound {bound:.6g} "
                    f"(ewma {self._ewma:.6g})")
        self._ewma = (loss if self._ewma is None
                      else (1 - cfg.ewma_alpha) * self._ewma
                      + cfg.ewma_alpha * loss)
        self._seen += 1

    def observe_fingerprint(self, step: int, fp: float) -> None:
        if not math.isfinite(fp):
            self._trip(step, f"non-finite state fingerprint {fp!r}")
        if self._last_fp is not None:
            jump = abs(fp - self._last_fp)
            bound = self.cfg.fingerprint_factor * (abs(self._last_fp)
                                                   + 1.0)
            if jump > bound:
                self._trip(
                    step,
                    f"state fingerprint jump {jump:.6g} > bound "
                    f"{bound:.6g} (prev {self._last_fp:.6g}, now "
                    f"{fp:.6g})")
        self._last_fp = fp


class _InnerGuard:
    """Internal marker wrapping the runtime for the recursive fit call:
    distinguishes 'the rollback wrapper already owns this run' from a
    user-supplied Guard/GuardRuntime (which engages the wrapper)."""

    __slots__ = ("runtime",)

    def __init__(self, runtime: GuardRuntime):
        self.runtime = runtime


# -- crc32c in C where the kernel library is built ------------------------

_crc32c_python = crc32c


def crc32c(data: bytes, crc: int = 0) -> int:  # noqa: F811
    """``crc32c`` above, through the port's library where it is built
    (``_native_crc32c``), else the pure-Python loop; equal values, pinned
    by the tests. ``checksum_file`` and the sidecars hash through this."""
    native = _native_crc32c()
    if native is None:
        return _crc32c_python(data, crc)
    if not isinstance(data, bytes):
        data = bytes(data)
    return int(native(data, len(data), crc & 0xFFFFFFFF))


def _native_crc32c():
    """The library's ``gym_crc32c`` on a machine with a CUDA card, where the
    port builds its kernels (the first call may build them); None on a
    machine without one, where checkpoints are small."""
    import torch
    if not torch.cuda.is_available():
        return None
    from ..ops import _build
    return _build.load().gym_crc32c
