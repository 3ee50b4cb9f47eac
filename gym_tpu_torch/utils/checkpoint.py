"""Checkpoint and resume of a fit, in a format of the port's own
(counterpart of ``gym_tpu/utils/checkpoint.py``, whose Orbax store the
machine with the card does not have).

Layout: ``<save_dir>/<run_name>/<step>/`` holds

- ``state.pt``: every tensor of the state, one flat dict written by
  ``torch.save`` and read with ``torch.load(weights_only=True)``;
- ``meta.json``: ``data_state`` (the iterator position), ``extra`` (the
  exact comm accumulator, the node layout) and ``tree``, the state's
  structure with its non-tensor leaves (Python ints, floats, None; a numpy
  array's dtype, its values stored as an int64 or float tensor), so a
  restore rebuilds every leaf in its own type and dtype;
- ``integrity.json``: the crc32c sidecar (``utils/integrity.py``).

The state is a tree of dicts, lists and tuples over tensors, numpy arrays
and JSON scalars; the trainer hands over its ``TrainState`` as one such
dict, the node dimension first in every per-node tensor, as it holds them.

The behaviour is the JAX package's manager's:

- **Atomic commit.** A step is written into a temporary sibling dir
  (``.<step>.tmp-<pid>``), fsynced, given its sidecar, then renamed to
  ``<step>``. Restore sees only numeric dirs; a kill mid-write leaves a
  dotted dir a later manager removes.
- **Restore** walks the steps newest-first (``step=None``), verifies each
  sidecar, and quarantines an unreadable step as ``<step>.corrupt-k``
  (never deleting; the next free ``k``) before falling back to an older
  one; a pinned step that is missing raises ``CheckpointNotFoundError``
  and one that is corrupt raises its own error. A restored state must
  match the live template's structure, shapes and dtypes, else it counts as
  unreadable, as a template mismatch does under Orbax.
- **Saving.** ``save`` is synchronous. ``save_async`` snapshots the state
  on the caller's stream (a clone of every tensor and an event recorded
  after it, so the step that follows may overwrite the live state), then
  hands it to one writer thread, whose device-to-host copy waits on that
  event on a stream of its own into pinned memory. A pending save is
  replaced by a newer one: one pending plus one in flight at most. The
  writer's errors surface on the caller's thread as
  ``CheckpointWriteError`` at the next save, wait or close; a writer that
  does not join within ``close_timeout`` raises
  ``CheckpointWriterStuckError`` with the thread stacks. Every write, and
  the writer's copy, runs under a ``RetryPolicy`` and the watchdog.
- **Pruning** keeps ``max_to_keep`` (2) steps, so a corrupt newest one
  still has a valid fallback.
- **Fault sites**: ``checkpoint.write`` (each write attempt),
  ``checkpoint.device_get`` (the writer's copy) and ``checkpoint.bytes``
  (``corrupt_checkpoint_files`` after the sidecar, so an armed bit flip is
  caught at restore).
"""

from __future__ import annotations

import errno
import json
import os
import shutil
import sys
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from . import integrity
from .resilience import (RetryPolicy, Watchdog, dump_thread_stacks,
                         fault_point, watch_or_null, with_retries)

PyTree = Any

STATE_FILE = "state.pt"
META_FILE = "meta.json"
# the node layout a checkpoint records in ``extra["elastic"]``: every
# per-node tensor [K, ...] (the other, ZeRO-2's, is ``elastic.ZERO2_LAYOUT``)
STACKED_LAYOUT = "stacked"


class CheckpointNotFoundError(RuntimeError):
    """No (valid) checkpoint exists to restore — either the run directory
    has no committed steps, or every committed step is corrupt."""


class CheckpointWriteError(RuntimeError):
    """The async writer thread's save failed after retries; raised on the
    caller's thread at the next ``save_async``/``wait``/``close``."""


class CheckpointWriterStuckError(RuntimeError):
    """``close()`` could not join the writer thread — a write is hung;
    the message carries every thread's stack as evidence."""


# -- the format -------------------------------------------------------------


def _encode(tree: PyTree, tensors: dict, path: str):
    """JSON skeleton of ``tree``; its tensors (and numpy arrays, as
    tensors) go into ``tensors`` under their path."""
    if torch.is_tensor(tree):
        tensors[path] = tree
        return {"$tensor": path}
    if isinstance(tree, np.ndarray):
        arr = np.ascontiguousarray(tree)
        kind = arr.dtype.kind
        if kind in "iub":
            # weights_only loads refuse numpy; the bits round-trip through
            # int64 exactly (uint64 wraps and wraps back)
            t = torch.from_numpy(arr.astype(np.int64))
        elif kind == "f":
            t = torch.from_numpy(arr)
        else:
            raise TypeError(f"cannot checkpoint a {arr.dtype} array at "
                            f"{path!r}")
        tensors[path] = t
        return {"$ndarray": path, "dtype": arr.dtype.str}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, got "
                                f"{k!r} at {path!r}")
        return {"$dict": [[k, _encode(v, tensors, f"{path}/{k}")]
                          for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        items = [_encode(v, tensors, f"{path}/{i}")
                 for i, v in enumerate(tree)]
        return {"$tuple": items} if isinstance(tree, tuple) else items
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{path!r}")


def _decode(node, tensors: dict):
    if isinstance(node, list):
        return [_decode(v, tensors) for v in node]
    if not isinstance(node, dict):
        return node
    if "$tensor" in node:
        return tensors[node["$tensor"]]
    if "$ndarray" in node:
        return tensors[node["$ndarray"]].cpu().numpy().astype(
            np.dtype(node["dtype"]))
    if "$tuple" in node:
        return tuple(_decode(v, tensors) for v in node["$tuple"])
    return {k: _decode(v, tensors) for k, v in node["$dict"]}


def _like(got, want, path: str = "state"):
    """``got`` laid out as the live template ``want``: the same structure,
    dict keys in the template's order, every tensor a fresh one of the
    template's shape and dtype on its device. Raises ValueError on a
    mismatch."""
    if torch.is_tensor(want):
        if not torch.is_tensor(got) or got.shape != want.shape \
                or got.dtype != want.dtype:
            raise ValueError(
                f"checkpoint leaf {path} is {_describe(got)}, the live state "
                f"holds {_describe(want)}")
        # a fresh tensor: a loaded one is a view of its dtype's whole buffer
        return got.to(want.device, copy=True)
    if isinstance(want, np.ndarray):
        if not isinstance(got, np.ndarray) or got.shape != want.shape \
                or got.dtype != want.dtype:
            raise ValueError(
                f"checkpoint leaf {path} is {_describe(got)}, the live state "
                f"holds {_describe(want)}")
        return got
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(
                f"checkpoint subtree {path} has keys "
                f"{sorted(got) if isinstance(got, dict) else type(got)}, "
                f"the live state {sorted(want)}")
        return {k: _like(got[k], want[k], f"{path}/{k}") for k in want}
    if isinstance(want, (list, tuple)):
        if type(got) is not type(want) or len(got) != len(want):
            raise ValueError(f"checkpoint subtree {path} differs in "
                             f"structure from the live state")
        return type(want)(_like(g, w, f"{path}/{i}")
                          for i, (g, w) in enumerate(zip(got, want)))
    if (want is None) != (got is None) or torch.is_tensor(got) \
            or isinstance(got, (dict, list, tuple, np.ndarray)):
        raise ValueError(f"checkpoint leaf {path} is {_describe(got)}, the "
                         f"live state holds {_describe(want)}")
    return got


def _describe(x) -> str:
    if torch.is_tensor(x) or isinstance(x, np.ndarray):
        return f"{type(x).__name__} {tuple(x.shape)} {x.dtype}"
    return type(x).__name__


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _numeric_steps(directory: str) -> List[int]:
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(directory,
                                                                n)))


def _read_step(step_dir: str, device=None) -> Tuple[PyTree, dict]:
    """(state tree, meta) of a committed step dir, after its sidecar is
    verified (a missing sidecar passes: a step from before sidecars)."""
    integrity.verify_sidecar(step_dir)
    with open(os.path.join(step_dir, META_FILE)) as f:
        meta = json.load(f)
    tensors = torch.load(os.path.join(step_dir, STATE_FILE),
                         map_location=device or "cpu", weights_only=True)
    return _decode(meta["tree"], tensors), meta


def restore_params(run_dir: str, step: Optional[int] = None,
                   retry_policy: Optional[RetryPolicy] = None,
                   device=None) -> Tuple[int, PyTree, dict]:
    """Params-only restore from a checkpoint run dir
    (``<save_dir>/<run_name>``), with no train-state template:
    ``(step, state['params'], extra)``, the params node-stacked ``[K,
    ...]`` as saved, on ``device`` (default the CPU). Walks the committed
    steps newest-first (or takes the pinned ``step``). Read-only by design:
    an unreadable step is SKIPPED, never quarantined — a serving process
    must not mutate a run dir a trainer may still own. Raises
    ``CheckpointNotFoundError`` when no (valid) step exists, or when a
    pinned ``step`` is absent."""
    path = os.path.abspath(run_dir)
    if not os.path.isdir(path):
        raise CheckpointNotFoundError(
            f"checkpoint run dir {path} does not exist")
    retry = retry_policy or RetryPolicy.from_env()
    steps = sorted(_numeric_steps(path), reverse=True)
    if step is not None:
        if step not in steps:
            raise CheckpointNotFoundError(
                f"checkpoint step {step} not found under {path} "
                f"(have {sorted(steps)})")
        steps = [step]
    if not steps:
        raise CheckpointNotFoundError(
            f"no checkpoint to restore under {path}")

    def read(s):
        tree, meta = _read_step(os.path.join(path, str(s)), device)
        if not isinstance(tree, dict) or "params" not in tree:
            raise ValueError(f"checkpoint step {s} has no 'params' subtree")
        return int(s), tree["params"], dict(meta.get("extra", {}))

    errors = []
    for s in steps:
        try:
            return with_retries(lambda s=s: read(s), retry,
                                describe=f"params-only restore (step {s})")
        except Exception as e:  # noqa: BLE001 — corrupt-step skip
            errors.append((s, e))
            sys.stderr.write(
                f"gym_tpu_torch: skipping unreadable checkpoint step {s} "
                f"under {path} ({type(e).__name__}: {e})\n")
    raise CheckpointNotFoundError(
        f"no valid checkpoint under {path}: every step in {steps} failed "
        f"to restore (newest: {type(errors[0][1]).__name__}: "
        f"{errors[0][1]})") from errors[0][1]


# a view's offset in its flat buffer, in bytes: every view starts aligned
_ALIGN_BYTES = 64


class _Layout:
    """Where each tensor of a tree sits in one flat buffer a (device,
    dtype): a snapshot is one allocation and its copy to the host one
    transfer a buffer, where a tensor at a time would make hundreds. The
    same object appearing twice shares its place."""

    def __init__(self, tree: PyTree):
        self.sizes: dict = {}  # (device, dtype) -> elements
        self.offsets: dict = {}  # id(tensor) -> (key, offset, numel)
        for _path, leaf in integrity._leaves(tree):
            if not torch.is_tensor(leaf) or id(leaf) in self.offsets:
                continue
            key = (leaf.device, leaf.dtype)
            step = max(1, _ALIGN_BYTES // leaf.element_size())
            off = self.sizes.get(key, 0)
            self.offsets[id(leaf)] = (key, off, leaf.numel())
            self.sizes[key] = off + -(-leaf.numel() // step) * step

    def copy_into(self, tree: PyTree, bufs: dict, non_blocking=False):
        """``tree`` with every tensor copied into its place in ``bufs``
        (on the current stream), numpy arrays copied, the rest as it is."""
        if torch.is_tensor(tree):
            key, off, n = self.offsets[id(tree)]
            view = bufs[key][off:off + n].view(tree.shape)
            view.copy_(tree.detach(), non_blocking=non_blocking)
            return view
        if isinstance(tree, np.ndarray):
            return tree.copy()
        if isinstance(tree, dict):
            return {k: self.copy_into(v, bufs, non_blocking)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.copy_into(v, bufs, non_blocking)
                              for v in tree)
        return tree


def _rebase(tree: PyTree, bufs: dict) -> PyTree:
    """``tree``, whose tensors are views of flat buffers keyed by (device,
    dtype), with each view moved to the same place in ``bufs``' buffer of
    its dtype (no copy)."""
    if torch.is_tensor(tree):
        (buf,) = [b for (_, dt), b in bufs.items() if dt == tree.dtype]
        off = tree.storage_offset()
        return buf[off:off + tree.numel()].view(tree.shape)
    if isinstance(tree, dict):
        return {k: _rebase(v, bufs) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebase(v, bufs) for v in tree)
    return tree


class CheckpointManager:
    """Checkpoints of one run: ``<save_dir>/<run_name>/<step>/``, all K
    simulated nodes in one state (the node dimension leads every per-node
    tensor)."""

    def __init__(self, save_dir: str, run_name: str, max_to_keep: int = 2,
                 async_save: bool = True,
                 retry_policy: Optional[RetryPolicy] = None,
                 watchdog: Optional[Watchdog] = None,
                 close_timeout: float = 600.0):
        """``async_save=False`` makes ``save_async`` synchronous (the
        ``async_checkpoint=False`` switch of ``fit``). ``max_to_keep``
        defaults to 2: restore falls back past a corrupt newest checkpoint,
        which only helps if an older valid one survives pruning."""
        path = os.path.abspath(os.path.join(save_dir, run_name))
        os.makedirs(path, exist_ok=True)
        self.directory = path
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._retry = retry_policy or RetryPolicy.from_env()
        self._watchdog = watchdog
        self._close_timeout = close_timeout
        self._writer: Optional[threading.Thread] = None
        self._work = threading.Condition()
        self._pending: Optional[tuple] = None
        self._inflight = False
        self._closing = False
        self._writer_error: Optional[BaseException] = None
        self._stream = None  # the writer's copy stream, on a card
        self._pinned: dict = {}  # (device, dtype) -> pinned host buffer
        # what a killed writer left: uncommitted, so never a checkpoint
        for name in os.listdir(path):
            if name.startswith(".") and ".tmp-" in name:
                shutil.rmtree(os.path.join(path, name), ignore_errors=True)

    # -- writes -----------------------------------------------------------

    def _write(self, step: int, host_state: PyTree, data_state: dict,
               extra: Optional[dict], fingerprint: Optional[dict]) -> None:
        """Commit ``host_state`` (tensors on the host) as step ``step``;
        ``fingerprint`` is its ``tree_fingerprint_host``, taken where the
        tensors were (a card sums 4 GB in milliseconds)."""
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")

        def attempt():
            fault_point("checkpoint.write")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            tensors: dict = {}
            tree = _encode(host_state, tensors, "")
            state_path = os.path.join(tmp, STATE_FILE)
            torch.save(tensors, state_path)
            _fsync_path(state_path)
            meta = {"data_state": data_state, "extra": extra or {},
                    "tree": tree}
            with open(os.path.join(tmp, META_FILE), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            # the sidecar records the good bytes before the commit
            integrity.write_sidecar(tmp, fingerprint=fingerprint)
            _fsync_path(tmp)
            if os.path.exists(final):
                # a re-save of a step: the newest write wins
                old = f"{tmp}.old"
                os.replace(final, old)
                os.replace(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(tmp, final)
            _fsync_path(self.directory)

        with watch_or_null(self._watchdog, f"checkpoint.write step {step}"):
            with_retries(attempt, self._retry,
                         describe=f"checkpoint write (step {step})")
        self._prune()
        # the checkpoint.bytes site: an armed corruption lands after the
        # sidecar recorded the good bytes, like bit rot between write and
        # read
        integrity.corrupt_checkpoint_files(final)

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self._max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def _host_buffers(self, layout: "_Layout") -> dict:
        """Pinned host buffers of ``layout``'s sizes, one a (device, dtype),
        kept across saves: page-locking 4 GB takes about a second,
        once per manager, not once per save. ``reserve`` takes that second
        before training starts."""
        for key, n in layout.sizes.items():
            buf = self._pinned.get(key)
            if buf is None or buf.numel() != n:
                # exact size: torch.save writes a view's whole storage
                self._pinned[key] = torch.empty(n, dtype=key[1],
                                                pin_memory=True)
        return {key: self._pinned[key] for key in layout.sizes}

    def reserve(self, state: PyTree) -> None:
        """Allocate the pinned host buffers a save of ``state`` copies into,
        now rather than at the first save (a card's state only)."""
        layout = _Layout(state)
        if any(dev.type == "cuda" for dev, _ in layout.sizes):
            self._host_buffers(layout)

    def _to_host(self, layout: "_Layout", tree: PyTree) -> PyTree:
        """``tree`` (laid out by ``layout``) on the host: a card's tensors
        copied into the pinned buffers, then synchronised; the CPU's as
        they are."""
        cards = [dev for dev, _ in layout.sizes if dev.type == "cuda"]
        if not cards:
            return tree
        host = layout.copy_into(tree, self._host_buffers(layout),
                                non_blocking=True)
        for dev in cards:
            torch.cuda.current_stream(dev).synchronize()
        return host

    def save(self, step: int, state: PyTree, data_state: dict,
             extra: Optional[dict] = None) -> None:
        """Synchronous save: the state's tensors copied to the host and
        committed before this returns (waiting out any async write
        first)."""
        self.wait()
        fingerprint = integrity.tree_fingerprint_host(state)
        self._write(step, self._to_host(_Layout(state), state), data_state,
                    extra, fingerprint)

    def save_async(self, step: int, state: PyTree, data_state: dict,
                   extra: Optional[dict] = None) -> None:
        """Snapshot ``state`` and return; the writer thread copies the
        snapshot to the host and commits it. The snapshot is a copy into
        one flat buffer a dtype on the caller's current stream, with an
        event recorded after it: the writer's copy waits on that event,
        never on the live tensors, which the next step may overwrite. A
        still-PENDING older save is replaced (newest wins): one pending
        plus one in flight at most."""
        if not self._async:
            self.save(step, state, data_state, extra)
            return
        with self._work:
            self._raise_writer_error()
        layout = _Layout(state)
        snap_bufs = {key: torch.empty(n, dtype=key[1], device=key[0])
                     for key, n in layout.sizes.items()}
        snap = layout.copy_into(state, snap_bufs)
        event = None
        cards = [dev for dev, _ in layout.sizes if dev.type == "cuda"]
        if cards:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cards[0]))
            event = (event, cards[0])
        with self._work:
            self._raise_writer_error()
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, name="gym-tpu-torch-ckpt-writer",
                    daemon=True)
                self._writer.start()
            self._pending = (step, layout, snap_bufs, snap, event,
                             data_state, extra)
            self._work.notify_all()

    def _fetch(self, layout, snap_bufs, snapshot, event):
        """(host copy, fingerprint) of a snapshot; on the card both wait on
        the snapshot's event on the writer's own stream: the fingerprint's
        sums first (read back once), then one copy a buffer into the pinned
        ones, the host tree their views at the snapshot's offsets."""
        fault_point("checkpoint.device_get")
        if event is None:
            return snapshot, integrity.tree_fingerprint_host(snapshot)
        ev, dev = event
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        host_bufs = self._host_buffers(layout)
        with torch.cuda.device(dev), torch.cuda.stream(self._stream):
            self._stream.wait_event(ev)
            fp = integrity.tree_fingerprint_host(snapshot)
            for key, buf in snap_bufs.items():
                host_bufs[key].copy_(buf, non_blocking=True)
        self._stream.synchronize()
        return _rebase(snapshot, host_bufs), fp

    def _writer_loop(self) -> None:
        while True:
            with self._work:
                while self._pending is None and not self._closing:
                    self._work.wait()
                if self._pending is None:
                    return
                item, self._pending = self._pending, None
                self._inflight = True
            try:
                (step, layout, snap_bufs, snapshot, event, data_state,
                 extra) = item
                item = None
                with watch_or_null(self._watchdog,
                                   f"checkpoint.device_get step {step}"):
                    host_state, fp = with_retries(
                        lambda: self._fetch(layout, snap_bufs, snapshot,
                                            event),
                        self._retry,
                        describe=f"checkpoint device_get (step {step})")
                # release the card's copy before the write: the next
                # snapshot reuses its memory
                snap_bufs = snapshot = event = None
                self._write(step, host_state, data_state, extra, fp)
                host_state = None
            except BaseException as e:  # noqa: BLE001 — surfaced on wait()
                self._writer_error = e
            finally:
                with self._work:
                    self._inflight = False
                    self._work.notify_all()

    def _raise_writer_error(self) -> None:
        if self._writer_error is not None:
            e, self._writer_error = self._writer_error, None
            raise CheckpointWriteError(
                "async checkpoint write failed") from e

    # -- reads / lifecycle ------------------------------------------------

    def all_steps(self) -> List[int]:
        return _numeric_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _restore_step(self, step: int, template_state: PyTree
                      ) -> Tuple[int, PyTree, dict, dict]:
        step_dir = os.path.join(self.directory, str(step))
        tree, meta = _read_step(step_dir)
        if template_state is not None:
            tree = _like(tree, template_state)
        return (int(step), tree, dict(meta["data_state"]),
                dict(meta.get("extra", {})))

    def peek_meta(self, step: Optional[int] = None) -> Optional[dict]:
        """The ``{"data_state", "extra"}`` of the newest (or pinned) step
        whose meta is readable, without its tensors; None if none is. The
        trainer reads the saved node layout here before it restores."""
        steps = sorted(self.all_steps(), reverse=True)
        if step is not None:
            steps = [step] if step in steps else []
        for s in steps:
            try:
                with open(os.path.join(self.directory, str(s),
                                       META_FILE)) as f:
                    meta = json.load(f)
                return {"data_state": meta["data_state"],
                        "extra": meta.get("extra", {})}
            except (OSError, ValueError, KeyError):  # peek is best-effort
                continue
        return None

    def restore(self, template_state: PyTree,
                step: Optional[int] = None) -> Tuple[int, PyTree, dict, dict]:
        """Restore ``(step, state, data_state, extra)``. ``template_state``
        (the freshly initialised state) fixes the structure, shapes,
        dtypes and devices; None restores the tree as saved, on the host.

        With ``step=None``, walks committed steps NEWEST-FIRST and falls
        back past unreadable ones, each logged and QUARANTINED (renamed
        aside, never deleted). Raises ``CheckpointNotFoundError`` when no
        step, or no VALID step, exists. With an explicit ``step``, a
        missing step raises ``CheckpointNotFoundError``; a corrupt one
        propagates its error."""
        if step is not None:
            if step not in self.all_steps():
                raise CheckpointNotFoundError(
                    f"checkpoint step {step} not found under "
                    f"{self.directory} (have {self.all_steps()})")
            return with_retries(
                lambda: self._restore_step(step, template_state),
                self._retry, describe=f"checkpoint restore (step {step})")
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise CheckpointNotFoundError(
                f"no checkpoint to restore under {self.directory}")
        skipped = []
        out = None
        for s in steps:
            try:
                # transient IO errors are retried BEFORE a step is
                # classified corrupt and quarantined
                out = with_retries(
                    lambda s=s: self._restore_step(s, template_state),
                    self._retry, describe=f"checkpoint restore (step {s})")
                break
            except Exception as e:  # noqa: BLE001 — corrupt-dir fallback
                skipped.append((s, e))
        for s, e in skipped:
            sys.stderr.write(
                f"gym_tpu_torch: skipping unreadable checkpoint step {s} "
                f"under {self.directory} ({type(e).__name__}: {e}); "
                f"quarantining it and falling back to an older step\n")
            self._quarantine_step(s)
        if out is None:
            raise CheckpointNotFoundError(
                f"no valid checkpoint under {self.directory}: every step "
                f"in {steps} failed to restore "
                f"(newest: {type(skipped[0][1]).__name__}: {skipped[0][1]})"
            ) from skipped[0][1]
        return out

    def _quarantine_step(self, step: int) -> None:
        """Move an unreadable step dir aside (``<step>.corrupt-k``, the
        next free ``k``) rather than deleting it: what restore skips must
        stay recoverable by hand, and a non-numeric name no longer blocks a
        re-save of the step."""
        src = os.path.join(self.directory, str(step))
        for k in range(100):
            dst = f"{src}.corrupt-{k}"
            if os.path.exists(dst):
                continue
            try:
                os.rename(src, dst)
                return
            except OSError as e:
                # a racing quarantine can land between the exists() probe
                # and the rename: a collision, so try the next suffix
                if e.errno in (errno.EEXIST, errno.ENOTEMPTY,
                               errno.ENOTDIR, errno.EISDIR):
                    continue
                break
        shutil.rmtree(src, ignore_errors=True)  # last resort: unblock

    def purge(self) -> None:
        """Delete every committed step — ``fit(resume="never")``'s
        start-over semantics."""
        self.wait()
        for s in self.all_steps():
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def wait(self) -> None:
        """Block until every enqueued save is durable."""
        with watch_or_null(self._watchdog, "checkpoint.wait"):
            with self._work:
                while self._pending is not None or self._inflight:
                    self._work.wait()
                self._raise_writer_error()

    def close(self) -> None:
        with self._work:
            self._closing = True
            self._work.notify_all()
        if self._writer is not None:
            self._writer.join(timeout=self._close_timeout)
            if self._writer.is_alive():
                raise CheckpointWriterStuckError(
                    f"checkpoint writer thread still alive after "
                    f"{self._close_timeout:.0f}s close timeout — a write "
                    f"is hung\n" + dump_thread_stacks("thread stacks:"))
        with self._work:
            self._raise_writer_error()
