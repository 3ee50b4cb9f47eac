"""D1: DeMo's deterministic scatter-mean decode, a hand-written CUDA kernel
(``csrc/scatter_mean.cu``) with its plain PyTorch twin.

Counterpart of ``gym_tpu/ops/topk_compress.py:scatter_mean_decode``, which
XLA runs as a serial scatter-add of values and counts (no Pallas kernel).
``out[g, s]`` is the mean of the ``val[g, u]`` whose ``idx[g, u] == s``, 0
where there is none. The summation order is part of the contract: a slot's
sum starts at 0.0 and adds its picks in increasing ``u``, in f32, as XLA's
scatter-add does. DeMo's update is ``sign(decoded)``, so two nodes that send
v and −v to one slot must sum to exactly 0; any other order leaves rounding
noise that ``sign`` turns into a full step. PyTorch's ``index_add_`` and
``scatter_reduce_`` promise no order on the card, hence the kernel.

``scatter_mean_decode`` launches the kernel for a CUDA tensor (or raises) and
runs the twin for a CPU tensor; ``scatter_mean_decode.launches`` counts the
kernel's launches. The kernel is D1's second design (warps own runs of
slots and walk a row's picks 32 at a time); ``scatter_mean_decode_ref``
runs the first kernel, kept as its oracle on the card, and
``scatter_mean_decode_tuned`` the kernel at another launch plan, for a
sweep (``scripts/d1_t1_sweep.py``). Both are card only and uncounted: the
card checks hold the kernel to them bit for bit.
"""

from __future__ import annotations

import ctypes

import torch


def plain_scatter_mean_decode(idx: torch.Tensor, val: torch.Tensor,
                              chunk_elems: int) -> torch.Tensor:
    """The twin: ``[G, m]`` picks → ``[G, chunk_elems]``, one pick column at
    a time in increasing ``u`` (each column touches one slot a row, so every
    add is the serial scatter-add's)."""
    g, m = idx.shape
    sums = torch.zeros(g, chunk_elems, dtype=torch.float32, device=idx.device)
    cnts = torch.zeros_like(sums)
    ones = torch.ones(g, 1, dtype=torch.float32, device=idx.device)
    cols = idx.long()
    for u in range(m):
        col = cols[:, u:u + 1]
        sums.scatter_add_(1, col, val[:, u:u + 1].float())
        cnts.scatter_add_(1, col, ones)
    return torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0),
                       torch.zeros_like(sums))


def _check(idx: torch.Tensor, val: torch.Tensor, chunk_elems: int) -> None:
    if idx.dim() != 2 or val.shape != idx.shape:
        raise ValueError(f"idx and val must be [G, m] of one shape, got "
                         f"{tuple(idx.shape)} and {tuple(val.shape)}")
    if idx.dtype != torch.int32 or val.dtype != torch.float32:
        raise ValueError(f"idx must be int32 and val float32, got "
                         f"{idx.dtype} and {val.dtype}")
    if idx.device != val.device:
        raise ValueError(f"idx on {idx.device}, val on {val.device}")
    if idx.device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {idx.device}")
    if chunk_elems < 1 or chunk_elems >= 2 ** 31:
        raise ValueError(f"chunk_elems must be in [1, 2^31), got "
                         f"{chunk_elems}")


def _launch(idx: torch.Tensor, val: torch.Tensor, chunk_elems: int,
            plan, ref: bool) -> torch.Tensor:
    """One launch of D1 (``plan`` = (slots a warp, warps a block), 0 for
    the kernel's own choice) or of its oracle (``ref``) on CUDA tensors
    that ``_check`` passed."""
    if not (idx.is_contiguous() and val.is_contiguous()):
        raise ValueError("idx and val must be contiguous")
    g, m = idx.shape
    if g >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"[G, m] = [{g}, {m}] too large")
    out = torch.empty(g, chunk_elems, dtype=torch.float32, device=idx.device)
    if g == 0:
        return out
    from . import _build
    lib = _build.load()
    with torch.cuda.device(idx.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(idx.device).cuda_stream)
        if ref:
            name = "gym_scatter_mean_ref"
            code = lib.gym_scatter_mean_ref(idx.data_ptr(), val.data_ptr(),
                                            g, m, chunk_elems,
                                            out.data_ptr(), stream)
        else:
            name = "gym_scatter_mean"
            code = lib.gym_scatter_mean(idx.data_ptr(), val.data_ptr(), g, m,
                                        chunk_elems, *plan, out.data_ptr(),
                                        stream)
    _build.check(lib, code, name)
    return out


def _on_card(idx: torch.Tensor, what: str) -> None:
    if idx.device.type != "cuda":
        raise ValueError(f"{what}: device must be cuda, got {idx.device}")


def scatter_mean_decode(idx: torch.Tensor, val: torch.Tensor,
                        chunk_elems: int) -> torch.Tensor:
    """``(idx, val)`` ``[G, m]`` (int32 slot indices in ``[0,
    chunk_elems)``, f32 values) → dense ``[G, chunk_elems]`` f32: duplicate
    indices averaged, untouched slots 0. On the card one launch of D1; on
    the CPU the twin."""
    _check(idx, val, chunk_elems)
    if idx.device.type == "cpu":
        return plain_scatter_mean_decode(idx, val, chunk_elems)
    out = _launch(idx, val, chunk_elems, (0, 0), False)
    if idx.shape[0]:
        scatter_mean_decode.launches += 1
    return out


def scatter_mean_decode_ref(idx: torch.Tensor, val: torch.Tensor,
                            chunk_elems: int) -> torch.Tensor:
    """D1's oracle on the card: ``scatter_mean_decode``'s function in the
    first kernel (a block a row, every thread scanning all of the row's
    picks). Never on the main path; not counted. A CUDA tensor only."""
    _check(idx, val, chunk_elems)
    _on_card(idx, "scatter_mean_decode_ref")
    return _launch(idx, val, chunk_elems, None, True)


def scatter_mean_decode_tuned(idx: torch.Tensor, val: torch.Tensor,
                              chunk_elems: int, slots: int,
                              warps: int) -> torch.Tensor:
    """One launch of D1 at at most ``slots`` slots a warp and ``warps``
    warps a block (at most 8), not the kernel's own choice, for a sweep
    (``scripts/d1_t1_sweep.py``): the same bits. Not counted. A CUDA tensor
    only."""
    _check(idx, val, chunk_elems)
    _on_card(idx, "scatter_mean_decode_tuned")
    if slots < 1 or not 1 <= warps <= 8:
        raise ValueError(f"slots must be >= 1 and warps in [1, 8], got "
                         f"{slots}, {warps}")
    return _launch(idx, val, chunk_elems, (slots, warps), False)


def launch_plan(rows: int, chunk_elems: int, slots: int = 0,
                warps: int = 0) -> dict:
    """D1's launch at ``rows`` rows of ``chunk_elems`` slots (``slots``,
    ``warps`` 0: the kernel's own choice): each warp's run of slots, the
    warps a block, the blocks a row and the block's dynamic shared memory
    in bytes. Needs the kernel library."""
    from . import _build
    lib = _build.load()
    plan = (ctypes.c_int * 4)()
    code = lib.gym_scatter_mean_plan(rows, chunk_elems, slots, warps, plan)
    _build.check(lib, code, "gym_scatter_mean_plan")
    return dict(zip(("run", "warps", "blocks_a_row", "smem_bytes"), plan))


scatter_mean_decode.launches = 0


def reset_launch_counts() -> None:
    scatter_mean_decode.launches = 0
