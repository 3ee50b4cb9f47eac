"""B7: the serving path's decode attention, a hand-written CUDA kernel
(``csrc/decode_attention.cu``) with its plain PyTorch twin.

Counterpart of the attends of ``gym_tpu/models/nanogpt.py``'s decode mode
(``_decode_attend`` and ``_decode_attend_paged``), which XLA runs as an
einsum, a mask, a softmax and an einsum over each row's whole ``[S]``
window (no Pallas kernel). Query ``j`` of row ``r`` sits at logical
position ``cursor[r] + j`` and attends to the logical positions ``0 ..
min(cursor[r] + j, S - 1)``; position ``p`` lives in the pool's page
``block_table[r, p // page]`` at offset ``p % page``. The unpaged per-row
cache ``[b, S, H, hd]`` is the same thing: ``b`` pages of size ``S``, row
``r``'s table ``[r]`` (``unpaged_table``).

A query's result depends only on its q, its position and the K and V at its
logical positions, never on the batch, the number of queries, the page size
or the page ids: the kernel holds every query's arithmetic fixed by its
positions, and the twin computes each query alone, from tensors whose shapes
only its position sets (so on the CPU it is row-invariant too). That is what
keeps the serving engine's token streams equal across slots, buckets,
verify chunks and paging.

``decode_attention`` launches the kernel for CUDA tensors (or raises) and
runs the twin for CPU tensors; ``decode_attention.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

HEAD_DIMS = (16, 32, 64, 128)


def unpaged_table(b: int, device) -> torch.Tensor:
    """Row r's block table ``[r]``: a per-row cache ``[b, S, H, hd]`` as a
    pool of b pages of size S."""
    return torch.arange(b, dtype=torch.int32, device=device).view(b, 1)


def plain_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           cursor: torch.Tensor) -> torch.Tensor:
    """The twin: each query alone over its own positions, softmax in f32."""
    b, t, h, hd = q.shape
    page = k_pool.shape[1]
    s = block_table.shape[1] * page
    out = torch.empty(b, t, h, hd, dtype=torch.float32, device=q.device)
    cur = cursor.tolist()
    scale = math.sqrt(hd)
    for r in range(b):
        pages = block_table[r].long()
        kw = k_pool[pages].reshape(s, h, hd)
        vw = v_pool[pages].reshape(s, h, hd)
        for j in range(t):
            n = min(cur[r] + j, s - 1) + 1
            kk = kw[:n].permute(1, 2, 0).contiguous()        # [H, hd, n]
            vv = vw[:n].permute(1, 0, 2).contiguous()        # [H, n, hd]
            qq = q[r, j].float().unsqueeze(1).contiguous()   # [H, 1, hd]
            p = torch.softmax(torch.bmm(qq, kk) / scale, dim=-1)
            out[r, j] = torch.bmm(p, vv)[:, 0]
    return out


def _check(q, k_pool, v_pool, block_table, cursor) -> None:
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"q must be [b, t, H, hd] and the pools [P, page, "
                         f"H, hd] of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, _, h, hd = q.shape
    if k_pool.shape[2:] != (h, hd):
        raise ValueError(f"pool heads {tuple(k_pool.shape[2:])} differ from "
                         f"q's {(h, hd)}")
    if block_table.dim() != 2 or block_table.shape[0] != b or \
            cursor.shape != (b,):
        raise ValueError(f"block_table must be [b, nblk] and cursor [b] for "
                         f"b={b}, got {tuple(block_table.shape)} and "
                         f"{tuple(cursor.shape)}")
    if block_table.dtype != torch.int32 or cursor.dtype != torch.int32:
        raise ValueError("block_table and cursor must be int32")
    if any(x.dtype != torch.float32 for x in (q, k_pool, v_pool)):
        raise ValueError("q and the pools must be float32")
    devs = {x.device for x in (q, k_pool, v_pool, block_table, cursor)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {q.device}")


def decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     cursor: torch.Tensor) -> torch.Tensor:
    """q ``[b, t, H, hd]`` over the pools ``[P, page, H, hd]`` through
    ``block_table`` ``[b, S // page]`` and ``cursor`` ``[b]`` (int32) →
    ``[b, t, H, hd]`` f32. On the card one launch of B7; on the CPU the
    twin."""
    _check(q, k_pool, v_pool, block_table, cursor)
    if q.device.type == "cpu":
        return plain_decode_attention(q, k_pool, v_pool, block_table, cursor)
    b, t, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or q.stride(2) != hd:
        raise ValueError("q's heads and head dims must be contiguous")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()
            and block_table.is_contiguous() and cursor.is_contiguous()):
        raise ValueError("the pools, block_table and cursor must be "
                         "contiguous")
    out = torch.empty(b, t, h, hd, dtype=torch.float32, device=q.device)
    from . import _build
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(q.device).cuda_stream)
        code = lib.gym_decode_attention(
            q.data_ptr(), q.stride(0), q.stride(1), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), block_table.shape[1],
            k_pool.shape[1], cursor.data_ptr(), b, t, h, hd,
            float(math.sqrt(hd)), out.data_ptr(), stream)
    _build.check(lib, code, "gym_decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def reset_launch_counts() -> None:
    decode_attention.launches = 0
