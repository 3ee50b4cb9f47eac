"""A device program with staged inputs, captured as a CUDA graph on the card.

``StagedProgram`` wraps one of the serving engine's programs
(``serve/programs.py``), a function of device tensors whose other state
(parameters, the KV cache) it reaches through its closure, updated in
place:

- **Inputs** are staged: the caller's numpy arrays are written into one
  pinned host buffer and copied to the device in ONE copy, into static
  device buffers at fixed addresses (each segment 16-byte aligned). The
  function reads them there; no host scalar enters it.
- **Outputs** are packed into one device buffer (largest item size first,
  so every output sits at a multiple of its own item size) and read back
  in ONE device-to-host copy into a pinned buffer, then copied out.
- **On the card** (``capture=True``) the function runs once eagerly, then
  is captured into a ``torch.cuda.CUDAGraph``, after the kernel library is
  loaded; a call stages, replays, and reads back. The captured outputs
  live in the graph's pool and the next replay overwrites them, which is
  why a call copies them out before it returns. The graph holds the
  addresses of its closure's tensors: it belongs to the engine that built
  it, and ``close()`` frees it with the engine.
- **Launch counters.** The serving kernels' ``launches`` counters count in
  Python, where a capture records a launch without running it. The
  program takes back what its capture counted, records it, and adds it
  again at every replay, so the counters count what ran. The same holds
  for R1's and B6's launches by shape (``row_linear.shape_counts``), which
  a capture records always and a replay adds while a caller tallies.
- **Eagerly** (the CPU, or ``capture=False``), a call stages and runs the
  function: the same kernels in the same order as the graph.

Capture mode ``thread_local``: other threads (other engines' drivers) may
synchronise and allocate while a capture is open; the capture itself runs
under its engine's dispatch lock (``programs.registry``), so its own
engine never dispatches meanwhile.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_ALIGN = 16


def _kernel_wrappers() -> List[Callable]:
    """The serving path's kernel wrappers, each with a ``launches``
    counter: B7, R1, L1 (with the residual add it takes) and T1's bits
    rows; B6 and B7 int8 under quantized weights and KV; L1 without the
    add; B8's grouped product under MoE layers."""
    from ..ops import decode_attention, grouped_matmul, row_linear, threefry
    return [decode_attention.decode_attention,
            decode_attention.decode_attention_int8, row_linear.row_linear,
            row_linear.row_qlinear, row_linear.row_layer_norm,
            row_linear.row_add_layer_norm, threefry.random_bits_rows,
            grouped_matmul.grouped_dot]


def _launch_counts() -> List[int]:
    return [w.launches for w in _kernel_wrappers()]


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dt)).dtype


class StagedProgram:
    """One program: ``fn(**inputs) -> tuple of tensors``, its inputs
    described by ``inputs`` (``{name: (shape, numpy dtype)}``) and first
    filled with ``warm`` (``{name: value}``, zeros otherwise) for the
    eager run that precedes a capture. ``__call__(**arrays)`` returns the
    outputs as numpy arrays, in ``fn``'s order."""

    def __init__(self, name: str, fn: Callable,
                 inputs: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
                 device, capture: bool,
                 warm: Optional[Dict[str, object]] = None):
        self.name = name
        self.device = torch.device(device)
        self._fn = fn
        self._cuda = self.device.type == "cuda"
        self.captured = False
        self._graph = None
        self._packed = None
        off, layout = 0, {}
        for n, (shape, dt) in inputs.items():
            dt = np.dtype(dt)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            layout[n] = (tuple(shape), dt, off, nbytes)
            off += -(-nbytes // _ALIGN) * _ALIGN
        self._host = torch.empty(max(off, _ALIGN), dtype=torch.uint8,
                                 pin_memory=self._cuda)
        host_np = self._host.numpy()
        self._dev = (torch.empty_like(self._host, device=self.device)
                     if self._cuda else self._host)
        self._in_host: Dict[str, np.ndarray] = {}
        self._in_dev: Dict[str, torch.Tensor] = {}
        for n, (shape, dt, o, nb) in layout.items():
            self._in_host[n] = host_np[o:o + nb].view(dt).reshape(shape)
            self._in_dev[n] = self._dev[o:o + nb].view(
                _torch_dtype(dt)).view(shape)
        for n, v in self._in_host.items():
            v[...] = (warm or {}).get(n, 0)
        self._stage()
        with torch.no_grad():
            outs = fn(**self._in_dev)
        order = sorted(range(len(outs)),
                       key=lambda i: -outs[i].element_size())
        self._out_layout = [None] * len(outs)
        off = 0
        for i in order:
            o = outs[i]
            dt = torch.empty(0, dtype=o.dtype).numpy().dtype
            nbytes = o.numel() * o.element_size()
            self._out_layout[i] = (tuple(o.shape), dt, off, nbytes)
            off += nbytes
        self._order = order
        self._host_out = torch.empty(max(off, 1), dtype=torch.uint8,
                                     pin_memory=self._cuda)
        if capture and self._cuda:
            self._capture()

    # -- building ---------------------------------------------------------

    def _pack(self, outs) -> torch.Tensor:
        return torch.cat([outs[i].detach().contiguous().reshape(-1)
                          .view(torch.uint8) for i in self._order])

    def _capture(self) -> None:
        from ..ops import _build, row_linear
        _build.load()               # the kernels' library, before capture
        before = _launch_counts()
        tally, row_linear.shape_counts = (row_linear.shape_counts,
                                          collections.Counter())
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                packed = self._pack(self._fn(**self._in_dev))
        finally:
            self._shapes, row_linear.shape_counts = (
                row_linear.shape_counts, tally)
        after = _launch_counts()
        self._graph_deltas = [a - b for a, b in zip(after, before)]
        # a capture records launches without running them: uncount them
        for w, b in zip(_kernel_wrappers(), before):
            w.launches = b
        self._graph, self._packed = graph, packed
        self.captured = True

    # -- running ----------------------------------------------------------

    def _stage(self) -> None:
        if self._cuda:
            self._dev.copy_(self._host, non_blocking=True)

    def __call__(self, **arrays) -> Tuple[np.ndarray, ...]:
        if self._fn is None:
            raise RuntimeError(f"{self.name}: program closed")
        if arrays.keys() != self._in_host.keys():
            raise ValueError(
                f"{self.name}: inputs {sorted(arrays)} differ from "
                f"{sorted(self._in_host)}")
        for n, a in arrays.items():
            self._in_host[n][...] = a
        self._stage()
        if self._graph is not None:
            self._graph.replay()
            for w, d in zip(_kernel_wrappers(), self._graph_deltas):
                w.launches += d
            from ..ops import row_linear
            if row_linear.shape_counts is not None:
                row_linear.shape_counts.update(self._shapes)
            packed = self._packed
        else:
            with torch.no_grad():
                packed = self._pack(self._fn(**self._in_dev))
        self._host_out.copy_(packed, non_blocking=True)
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        buf = self._host_out.numpy()
        return tuple(buf[o:o + nb].view(dt).reshape(shape).copy()
                     for shape, dt, o, nb in self._out_layout)

    def close(self) -> None:
        """Free the graph, its pool and the staging buffers; the program
        cannot run afterwards."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._packed = self._fn = None
        self._in_dev, self._in_host = {}, {}
        self._dev = self._host = self._host_out = None
