"""Host-overlap pipeline: background batch assembly and transfer
(counterpart of ``gym_tpu/data/prefetch.py``).

The synchronous fit loop pays for every piece of host work — drawing
per-node indices, the ``take`` gathers, the [K, S, ...] multi-step stacking,
the copy to the card from pageable memory — on the dispatch path.
``HostPrefetcher`` moves it onto a worker thread that runs one dispatch
ahead: it walks ``dispatch_schedule``, assembles each batch into pinned host
buffers and copies it to the card on a side stream, recording an event after
the copy. The consumer makes its current stream wait on that event before
the step reads the batch, and a buffer is refilled only after its copy's
event has completed. The queue is bounded (one batch with the consumer, one
staged), so lookahead stays constant.

On the CPU every batch owns fresh arrays, never a buffer the worker refills:
the tensors handed out alias their arrays.

Determinism contract (the JAX package's): the worker draws from the SAME
``NodeBatchIterator`` in the SAME order as the synchronous loop, so batch
contents are bit-identical with prefetch on or off. Each queue item carries
a snapshot of the iterator state taken right after its batch was drawn;
``consumed_state()`` returns the snapshot of the last batch the trainer
actually consumed — what ``train_iter.state()`` would read in the
synchronous loop — so a checkpoint records the consumed position, not the
worker's.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import List, Sequence

import numpy as np
import torch

from ..utils.resilience import fault_point

_SENTINEL_ERROR = "__prefetch_error__"
_SENTINEL_DONE = "__prefetch_done__"


class PrefetchError(RuntimeError):
    """The prefetch pipeline broke on the host side: the worker died
    without reporting a typed error, or the consumer drew past the
    dispatch schedule. Worker-side exceptions re-raise as themselves;
    this class covers the pipeline's own invariants."""


def dispatch_schedule(start_step: int, max_steps: int, steps_per_call: int,
                      has_multi: bool) -> List[int]:
    """Steps consumed by each dispatch of the fit loop, in order — the
    loop's ``s`` sequence made explicit so the prefetch worker can walk
    it independently. Full calls run ``steps_per_call`` on the multi-step
    program, any remainder falls back to single-step dispatches."""
    sched = []
    i = start_step
    while i < max_steps:
        s = min(steps_per_call, max_steps - i)
        if s < steps_per_call or not has_multi:
            s = 1
        sched.append(s)
        i += s
    return sched


class HostPrefetcher:
    """Bounded background pipeline over a ``NodeBatchIterator``.

    ``train_iter``: after ``start()`` the worker thread OWNS it — the
    caller must not touch it until ``close()``. ``device``: where batches
    go (a card: pinned buffers and a side stream; the CPU: fresh arrays).
    ``schedule``: ``dispatch_schedule(...)``. ``n_micro``, ``micro_bs``:
    forwarded to ``next_batch``.
    """

    def __init__(self, train_iter, device, schedule: Sequence[int], *,
                 n_micro: int, micro_bs: int):
        self._iter = train_iter
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            # the worker thread selects it and makes its stream there
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._schedule = list(schedule)
        self._n_micro = n_micro
        self._micro_bs = micro_bs
        # one batch staged while the consumer holds one
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker,
                                        name="gym-tpu-torch-prefetch",
                                        daemon=True)
        self._consumed_state = copy.deepcopy(train_iter.state())
        # s -> (pinned tensors, their numpy views, the last copy's event)
        self._buffers = {}
        # field shapes/dtypes come from the FIRST real draw — a probe
        # `take` would advance stateful datasets (augmentation call
        # counters) and break bit-identity with the sync path
        self._field_meta = None
        self._started = False

    # -- worker side ------------------------------------------------------

    def _shape(self, shape, s: int):
        return (shape[0], s) + tuple(shape[1:]) if s > 1 else tuple(shape)

    def _acquire_buffers(self, s: int):
        """Numpy arrays to fill for an s-step batch: on a card the views of
        pinned buffers, reused once their last copy has completed; on the
        CPU fresh arrays every time."""
        if not self._cuda:
            return tuple(np.empty(self._shape(shape, s), dtype)
                         for shape, dtype in self._field_meta)
        bufs = self._buffers.get(s)
        if bufs is None:
            pinned = tuple(
                torch.empty(self._shape(shape, s),
                            dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                            pin_memory=True)
                for shape, dtype in self._field_meta)
            bufs = [pinned, tuple(t.numpy() for t in pinned), None]
            self._buffers[s] = bufs
        elif bufs[2] is not None:
            bufs[2].synchronize()  # the card has its copy: refill is safe
        return bufs[1]

    def _assemble(self, s: int):
        """Draw s steps' worth of microbatch grids straight into the
        buffers: [K, S, n_micro, micro_bs, ...] per field for a multi-step
        dispatch, [K, n_micro, micro_bs, ...] for s == 1. The very first
        draw runs through the allocating ``next_batch`` path to DISCOVER
        field shapes (one extra copy, once)."""
        first = None
        if self._field_meta is None:
            first = self._iter.next_batch(self._n_micro, self._micro_bs)
            self._field_meta = [(a.shape, a.dtype) for a in first]
            if s == 1:
                return first
        bufs = self._acquire_buffers(s)
        if s > 1:
            start = 0
            if first is not None:
                for f, a in zip(bufs, first):
                    f[:, 0] = a
                start = 1
            for j in range(start, s):
                self._iter.next_batch(self._n_micro, self._micro_bs,
                                      out=tuple(f[:, j] for f in bufs))
        else:
            self._iter.next_batch(self._n_micro, self._micro_bs, out=bufs)
        return bufs

    def _transfer(self, host, s: int, stream):
        """(device tensors, event) of a host batch: on a card an async copy
        on the side stream and the event after it (a pinned buffer's event
        also gates its refill); on the CPU the arrays themselves."""
        if not self._cuda:
            return tuple(torch.from_numpy(a) for a in host), None
        bufs = self._buffers.get(s)
        pinned = bufs[0] if bufs is not None and host is bufs[1] else None
        with torch.cuda.stream(stream):
            if pinned is None:  # the first, allocating draw
                batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
                    self._device) for a in host)
            else:
                batch = tuple(t.to(self._device, non_blocking=True)
                              for t in pinned)
            event = torch.cuda.Event()
            event.record(stream)
        if pinned is not None:
            bufs[2] = event
        return batch, event

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to ``close()``."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            stream = None
            if self._cuda:
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(device=self._device)
            for s in self._schedule:
                if self._stop.is_set():
                    return
                fault_point("prefetch.fill")
                host_batch = self._assemble(s)
                state = copy.deepcopy(self._iter.state())
                batch, event = self._transfer(host_batch, s, stream)
                if not self._put(("batch", (batch, event), state)):
                    return
                del batch  # the consumer owns it
            self._put((_SENTINEL_DONE, None, None))
        except BaseException as e:  # noqa: BLE001 — must cross threads
            self._put((_SENTINEL_ERROR, e, None))

    # -- consumer side ----------------------------------------------------

    def start(self) -> "HostPrefetcher":
        self._thread.start()
        self._started = True
        return self

    def get(self):
        """Next batch on the device, in schedule order, safe to read on the
        caller's current stream. Re-raises any worker-side exception in
        the caller's thread."""
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise PrefetchError(
                        "prefetch worker died without reporting an error")
        tag, payload, state = item
        if tag == _SENTINEL_ERROR:
            self._stop.set()
            raise payload
        if tag == _SENTINEL_DONE:
            raise PrefetchError("prefetch schedule exhausted")
        batch, event = payload
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in batch:
                # allocated on the side stream, read on this one
                t.record_stream(current)
        self._consumed_state = state
        return batch

    def consumed_state(self) -> dict:
        """Iterator state as-if the consumed batches had been drawn
        synchronously — the checkpointable position, independent of
        worker lookahead."""
        return self._consumed_state

    def close(self) -> None:
        """Idempotent shutdown: unblocks and joins the worker even when
        the fit loop exits early (exception, max_steps reached with
        batches still staged)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._started and self._thread.is_alive():
            self._thread.join(timeout=10.0)
