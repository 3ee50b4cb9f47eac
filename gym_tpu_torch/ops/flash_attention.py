"""Fused attention dispatch (counterpart of ``gym_tpu/ops/flash_attention.py``)
and the long-context causal attention it dispatches to (TPU kernel B5).

On the card, shapes the fused whole-context kernels take (T ≤ 1024) go to
them (``ops/fused_attention.py``); longer contexts go to the tiled
long-context pair of this module, the counterpart of JAX's bundled Pallas
TPU ``flash_attention`` that the JAX package calls there. On the CPU, and
for shapes ``_flash_ok`` rejects or with active dropout, attention is dense,
as in the JAX package off the TPU. A shape ``_flash_ok`` accepts but the
CUDA kernels do not take (a head dim outside 16/32/64/128) raises on the
card; nothing falls back quietly.

The pair: ``_flash_fwd`` launches ``gym_flash_fwd`` (``csrc/
flash_attention.cu``, a single-pass online-softmax forward; in f32 a
pre-pass that splits k and v once into a workspace the wrapper allocates,
then the forward) and ``_flash_bwd`` the FA2 backward kernels of
``csrc/fused_attention.cu`` given lse. Each counts its calls in
``launches`` (``_flash_fwd`` also ``launches_f32`` and ``launches_bf16``)
and runs its plain version (``plain_flash_fwd`` / ``plain_flash_bwd``)
only for CPU tensors.
The plain versions follow the TPU kernel's arithmetic block by block, at the
block sizes the JAX package would pick for the shape.

Inputs carry any number of leading node dimensions before the batch
(``[..., B, H, T, D]`` or ``[..., B, T, C]``). The eligibility gates see the
per-node shape, as the JAX package's gates do under ``vmap``; the kernels
then see the node axis folded into the batch.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .attention import dense_causal_attention
from .fused_attention import (_DTYPES, _check, _check_stats, _count,
                              _grad_layout, _launch_bwd, _stream, _strides,
                              fused_causal_attention,
                              fused_causal_attention_packed, fused_supported,
                              packed_supported)

# the TPU kernel's mask: added to masked scores, so exp(s - m) is exactly 0
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def _flash_ok(q: torch.Tensor) -> bool:
    t, d = q.shape[-2], q.shape[-1]
    return t >= 128 and t % 128 == 0 and d <= 256


def _block_sizes(t: int, d: int):
    """(block_q, block_k) of the forward and (block_q, block_k) of the
    backward, as ``gym_tpu/ops/flash_attention.py:71-85`` chooses them: the
    tuned 1024/2048 and 512/1024 where D ≤ 64 and T divides, the bundled
    kernel's default 128 everywhere otherwise."""
    bq, bk = min(1024, t), min(2048, t)
    bqb, bkb = min(512, t), min(1024, t)
    if d > 64 or t % bq or t % bk or t % bqb or t % bkb:
        return 128, 128, 128, 128
    return bq, bk, bqb, bkb


def _runs(i: int, bq: int, j: int, bk: int) -> bool:
    """The TPU kernel's causal block test: the block's bottom-left corner is
    on or below the diagonal."""
    return (i + 1) * bq - 1 > j * bk


def _masked(s, r0, c0):
    rows = torch.arange(r0, r0 + s.shape[-2], device=s.device)[:, None]
    cols = torch.arange(c0, c0 + s.shape[-1], device=s.device)[None, :]
    return s + torch.where(cols <= rows, 0.0, MASK_VALUE)


# -- plain versions: the TPU kernel's arithmetic, block by block ------------


def plain_flash_fwd(q, k, v, scale):
    """[N, H, T, D] → (o [N, H, T, D], lse [N, H, T, 1] f32). Online softmax
    over key blocks with the normalised accumulator of the TPU kernel's
    multi-step body; where one key block spans T, its single-step body
    (p normalised, then rounded)."""
    n, h, t, d = q.shape
    bq, bk = _block_sizes(t, d)[:2]
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty_like(q)
    lse = torch.empty((n, h, t, 1), dtype=torch.float32, device=q.device)
    for i in range(t // bq):
        rows = slice(i * bq, (i + 1) * bq)
        if bk == t:
            s = _masked(torch.matmul(qf[:, :, rows], kf.transpose(-1, -2))
                        * scale, i * bq, 0)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True)
            acc = torch.matmul((p / l).to(v.dtype).float(), vf)
        else:
            m = torch.full((n, h, bq, 1), -math.inf, device=q.device)
            l = torch.zeros((n, h, bq, 1), device=q.device)
            acc = torch.zeros((n, h, bq, d), device=q.device)
            for j in range(t // bk):
                if not _runs(i, bq, j, bk):
                    continue
                cols = slice(j * bk, (j + 1) * bk)
                s = _masked(torch.matmul(qf[:, :, rows],
                                         kf[:, :, cols].transpose(-1, -2))
                            * scale, i * bq, j * bk)
                m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_next)
                l_corr = torch.exp(m - m_next) * l
                l_next = p.sum(dim=-1, keepdim=True) + l_corr
                inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
                acc = acc * (l_corr * inv) + torch.matmul(
                    p.to(v.dtype).float(), vf[:, :, cols]) * inv
                m, l = m_next, l_next
        o[:, :, rows] = acc.to(q.dtype)
        lse[:, :, rows] = m + torch.log(l)
    return o, lse


def plain_flash_bwd(q, k, v, o, do, lse, scale):
    """(dq, dk, dv) of the causal attention above, given its lse: the TPU
    kernel's dk/dv and dq bodies over (query, key) blocks, p = exp(s − lse)
    rounded to do's dtype for dv, ds = (dp − δ)·p·scale rounded to q's dtype
    for dk and dq, every sum accumulated in f32 in block order."""
    n, h, t, d = q.shape
    bq, bk = _block_sizes(t, d)[2:]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (o.float() * dof).sum(dim=-1, keepdim=True)
    dq = torch.zeros(q.shape, device=q.device)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for j in range(t // bk):
        cols = slice(j * bk, (j + 1) * bk)
        for i in range(t // bq):
            if not _runs(i, bq, j, bk):
                continue
            rows = slice(i * bq, (i + 1) * bq)
            s = _masked(torch.matmul(qf[:, :, rows],
                                     kf[:, :, cols].transpose(-1, -2))
                        * scale, i * bq, j * bk)
            p = torch.exp(s - lse[:, :, rows])
            dv[:, :, cols] += torch.matmul(
                p.to(do.dtype).float().transpose(-1, -2), dof[:, :, rows])
            dp = torch.matmul(dof[:, :, rows],
                              vf[:, :, cols].transpose(-1, -2))
            ds = ((dp - delta[:, :, rows]) * p * scale).to(q.dtype).float()
            dk[:, :, cols] += torch.matmul(ds.transpose(-1, -2),
                                           qf[:, :, rows])
            dq[:, :, rows] += torch.matmul(ds, kf[:, :, cols])
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# -- the two wrappers (B5's forward and backward) ---------------------------


def _check_blocks(q, what):
    """Refuse T % 128 != 0 on either device. The bundled Pallas kernel takes
    only block sizes that divide the sequence (its ``_verify_block``), and
    the JAX package sends such T to dense attention; the plain versions step
    over whole 128-row blocks and the card's forward over 128-row query
    blocks, so neither covers a ragged last block."""
    t = q.shape[-2]
    if t % 128:
        raise ValueError(f"{what}: T={t} is not a multiple of 128 (the "
                         f"bundled Pallas kernel's blocks divide T)")


def _check_flash(tensors, what):
    """Raise on anything the kernels do not take; (N, H, T, D)."""
    q = tensors[0]
    if q.dim() != 4 or any(x.shape != q.shape for x in tensors):
        raise ValueError(f"{what}: shapes "
                         f"{[tuple(x.shape) for x in tensors]}, expected "
                         f"equal [N, H, T, D]")
    n, h, t, d = q.shape
    _check(tensors, n, h, t, d, what)
    return n, h, t, d


def _flash_fwd(q, k, v, scale):
    """Causal forward on [N, H, T, D] (strided views with a unit last
    stride), T % 128 == 0 → (o [N, H, T, D], lse [N, H, T, 1] f32). In f32
    the kernel's split copies of k and v (hi and lo of k and of vᵀ) go to a
    workspace of 16·N·H·T·D bytes; one call counts as one launch."""
    what = "flash attention forward"
    _check_blocks(q, what)
    if not q.is_cuda:
        return plain_flash_fwd(q, k, v, scale)
    from . import _build
    n, h, t, d = _check_flash((q, k, v), what)
    o = torch.empty((n, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, t, 1), dtype=torch.float32, device=q.device)
    work = (torch.empty(16 * n * h * t * d, dtype=torch.uint8,
                        device=q.device) if q.dtype == torch.float32 else None)
    lib = _build.load()
    st = (ctypes.c_longlong * 15)(*[int(s) for x in (q, k, v, o, lse)
                                    for s in _strides(x, "blk")])
    with torch.cuda.device(q.device):
        code = lib.gym_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(),
                                 None if work is None else work.data_ptr(),
                                 st, n, h, t, d, float(scale),
                                 _DTYPES[q.dtype], _stream(q))
    _build.check(lib, code, "gym_flash_fwd")
    _count(_flash_fwd, q.dtype)
    return o, lse


def _flash_bwd(q, k, v, o, do, lse, scale):
    """(dq, dk, dv) of ``_flash_fwd`` given its o and lse."""
    what = "flash attention backward"
    _check_blocks(q, what)
    if not q.is_cuda:
        return plain_flash_bwd(q, k, v, o, do, lse, scale)
    n, h, t, d = _check_flash((q, k, v, o, do), what)
    _check_stats(lse, None, (n, h, t, 1), what)
    dq, dk, dv = (torch.empty((n, h, t, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    lse_st = _strides(lse, "blk")
    strides = (*(s for x in (q, k, v, o, do, dq, dk, dv)
                 for s in _strides(x, "blk")), *lse_st, *lse_st)
    _launch_bwd(q, k, v, o, do, lse, None, dq, dk, dv, strides, n, h, t, d,
                True, scale)
    _flash_bwd.launches += 1
    return dq, dk, dv


def reset_launch_counts() -> None:
    _flash_fwd.launches = _flash_fwd.launches_f32 = 0
    _flash_fwd.launches_bf16 = 0
    _flash_bwd.launches = 0


reset_launch_counts()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, _grad_layout(do).to(q.dtype),
                                lse, ctx.scale)
        return dq, dk, dv, None


def long_causal_attention(q, k, v, scale=None):
    """softmax(mask(QKᵀ·scale))·V on [N, H, T, D], T % 128 == 0 (other T
    raise ValueError), no dropout, through the B5 pair."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, scale)


# -- dispatch ----------------------------------------------------------------


def _per_node(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """The first node's slice: the shape the gates are written for."""
    return x[(0,) * (x.dim() - ndim)]


def flash_causal_attention(
    q: torch.Tensor,  # [..., B, H, T, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    dropout_rng=None,
    deterministic: bool = True,
) -> torch.Tensor:
    use_dropout = dropout_rate > 0.0 and not deterministic
    if not q.is_cuda or use_dropout or not _flash_ok(q):
        return dense_causal_attention(
            q, k, v, dropout_rate=dropout_rate, dropout_rng=dropout_rng,
            deterministic=deterministic)
    h, t, d = q.shape[-3:]

    def fold(x):
        return x.reshape(-1, h, t, d)

    attend = (fused_causal_attention if fused_supported(_per_node(q, 4))
              else long_causal_attention)
    return attend(fold(q), fold(k), fold(v)).reshape(q.shape)


def packed_flash_attention_or_none(q, k, v, n_head: int):
    """Packed-layout fast path: q, k, v [..., B, T, C] → [..., B, T, C] with
    no head transposes, through the packed kernels. Returns None when they
    are not eligible (off the card, or the per-node shape fails
    ``packed_supported``), so that the caller takes the [B, H, T, D] path.
    The one dispatch point for packed eligibility."""
    if not q.is_cuda or not packed_supported(_per_node(q, 3), n_head):
        return None
    t, c = q.shape[-2:]

    def fold(x):
        return x.reshape(-1, t, c)

    return fused_causal_attention_packed(
        fold(q), fold(k), fold(v), n_head).reshape(q.shape)
