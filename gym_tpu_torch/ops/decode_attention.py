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
kernel's launches. The kernel has two paths, chosen by t alone: a block a
query (a decode step) and a block a tile of 16 queries (a verify chunk, a
prefill), every query computed the same way on both.
``decode_attention_ref`` runs B7's first kernel, the oracle whose bits the
served path keeps, on the card only; the card checks hold every path to it
bit for bit.

B7 int8 (``decode_attention_int8``): the same attention over int8 pools
with one f32 scale per (position, head) (a ``kv_dtype="int8"`` cache,
``ops/fused_attention.py`` ``kv_quantize``), bit for bit B7 on the
``kv_dequantize``'d pools: the kernel stages the int8 rows and their
scales and dequantizes each element once into an f32 tile, on which B7's
chains run. ``decode_attention_int8.launches`` counts its launches, and
``decode_attention_int8_ref`` is its oracle.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .fused_attention import kv_dequantize

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


def plain_decode_attention_int8(q, k_pool, v_pool, k_scale, v_scale,
                                block_table, cursor) -> torch.Tensor:
    """B7 int8's twin: the pools dequantized, then B7's twin."""
    return plain_decode_attention(q, kv_dequantize(k_pool, k_scale),
                                  kv_dequantize(v_pool, v_scale),
                                  block_table, cursor)


def _check(q, k_pool, v_pool, block_table, cursor,
           pool_dtype=torch.float32) -> None:
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
    if q.dtype != torch.float32:
        raise ValueError("q must be float32")
    if k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise ValueError(f"the pools must be {pool_dtype}, got "
                         f"{k_pool.dtype} and {v_pool.dtype}")
    devs = {x.device for x in (q, k_pool, v_pool, block_table, cursor)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {q.device}")


def _launch(q, k_pool, v_pool, scales, block_table, cursor, path, ref):
    """One launch of B7, or of B7 int8 with ``scales`` (k_scale, v_scale):
    the kernel on ``path`` (-1 the dispatch's, else a sweep's), or the
    oracle when ``ref``. The shape checks are the caller's."""
    b, t, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or q.stride(2) != hd:
        raise ValueError("q's heads and head dims must be contiguous")
    pools = (k_pool, v_pool) + tuple(scales)
    if not all(x.is_contiguous() for x in pools + (block_table, cursor)):
        raise ValueError("the pools, the scale pools, block_table and "
                         "cursor must be contiguous")
    out = torch.empty(b, t, h, hd, dtype=torch.float32, device=q.device)
    from . import _build
    lib = _build.load()
    name = "gym_decode_attention" + ("_int8" if scales else "") + (
        "_ref" if ref else "")
    args = (q.data_ptr(), q.stride(0), q.stride(1),
            *(x.data_ptr() for x in pools), block_table.data_ptr(),
            block_table.shape[1], k_pool.shape[1], cursor.data_ptr(), b, t,
            h, hd, float(math.sqrt(hd)), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(q.device).cuda_stream)
        fn = getattr(lib, name)
        code = fn(*args, stream) if ref else fn(*args, path, stream)
    _build.check(lib, code, name)
    return out


def _on_card(q, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: device must be cuda, got {q.device}")


def _check_scales(q, k_pool, k_scale, v_scale) -> None:
    if k_scale.shape != k_pool.shape[:3] or v_scale.shape != k_scale.shape:
        raise ValueError(f"the scale pools must be {tuple(k_pool.shape[:3])}"
                         f", got {tuple(k_scale.shape)} and "
                         f"{tuple(v_scale.shape)}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("the scale pools must be float32")
    if k_scale.device != q.device or v_scale.device != q.device:
        raise ValueError("the scale pools are on another device")


def decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_table: torch.Tensor,
                     cursor: torch.Tensor) -> torch.Tensor:
    """q ``[b, t, H, hd]`` over the pools ``[P, page, H, hd]`` through
    ``block_table`` ``[b, S // page]`` and ``cursor`` ``[b]`` (int32) →
    ``[b, t, H, hd]`` f32. On the card one launch of B7, on the path its
    dispatch picks for t; on the CPU the twin."""
    _check(q, k_pool, v_pool, block_table, cursor)
    if q.device.type == "cpu":
        return plain_decode_attention(q, k_pool, v_pool, block_table, cursor)
    out = _launch(q, k_pool, v_pool, (), block_table, cursor, -1, False)
    decode_attention.launches += 1
    return out


def decode_attention_int8(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, block_table: torch.Tensor,
                          cursor: torch.Tensor) -> torch.Tensor:
    """``decode_attention`` over int8 pools ``[P, page, H, hd]`` and their
    f32 scale pools ``[P, page, H]``. On the card one launch of B7 int8; on
    the CPU its twin."""
    _check(q, k_pool, v_pool, block_table, cursor, torch.int8)
    _check_scales(q, k_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return plain_decode_attention_int8(q, k_pool, v_pool, k_scale,
                                           v_scale, block_table, cursor)
    out = _launch(q, k_pool, v_pool, (k_scale, v_scale), block_table, cursor,
                  -1, False)
    decode_attention_int8.launches += 1
    return out


def decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_table: torch.Tensor,
                         cursor: torch.Tensor) -> torch.Tensor:
    """B7's oracle on the card: ``decode_attention``'s function in the
    first kernel (a block a query, K staged a key at a time, V read from
    global memory), the bits the served path has always had. Never on the
    serving path: the card checks hold B7 to it bit for bit. A CUDA tensor
    only."""
    _check(q, k_pool, v_pool, block_table, cursor)
    _on_card(q, "decode_attention_ref")
    return _launch(q, k_pool, v_pool, (), block_table, cursor, -1, True)


def decode_attention_int8_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor,
                              block_table: torch.Tensor,
                              cursor: torch.Tensor) -> torch.Tensor:
    """B7 int8's oracle on the card, as ``decode_attention_ref`` is B7's.
    A CUDA tensor only."""
    _check(q, k_pool, v_pool, block_table, cursor, torch.int8)
    _check_scales(q, k_pool, k_scale, v_scale)
    _on_card(q, "decode_attention_int8_ref")
    return _launch(q, k_pool, v_pool, (k_scale, v_scale), block_table, cursor,
                   -1, True)


def decode_attention_on_path(q, k_pool, v_pool, block_table, cursor,
                             path: int, scales=()) -> torch.Tensor:
    """One launch of B7 (or of B7 int8, with ``scales`` = (k_scale,
    v_scale)) on the path ``decode_attention.cu``'s ``enum Path`` names,
    not the dispatch's choice, for a sweep of the paths
    (``scripts/b7_sweep.py``): the same bits. Not counted. A CUDA tensor
    only."""
    _check(q, k_pool, v_pool, block_table, cursor,
           torch.int8 if scales else torch.float32)
    if scales:
        _check_scales(q, k_pool, *scales)
    _on_card(q, "decode_attention_on_path")
    return _launch(q, k_pool, v_pool, tuple(scales), block_table, cursor,
                   path, False)


def path_of(t: int) -> int:
    """The path B7's dispatch picks for t queries a row
    (``decode_attention.cu``'s ``enum Path``); needs the kernel library."""
    from . import _build
    return _build.load().gym_decode_attention_path(t)


# decode_attention.cu's enum Path
PATHS = ("decode", "tile 16")


decode_attention.launches = 0
decode_attention_int8.launches = 0


def reset_launch_counts() -> None:
    decode_attention.launches = 0
    decode_attention_int8.launches = 0
