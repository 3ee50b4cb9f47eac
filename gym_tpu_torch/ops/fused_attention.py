"""Fused whole-context causal attention: hand-written CUDA kernels for Hopper
with their plain PyTorch versions.

Counterpart of ``gym_tpu/ops/fused_attention.py`` (Pallas, TPU). The same
FA2 math in two layouts: per-head ``[B, H, T, D]`` and packed ``[B, T, C]``
(C = H·D, heads looped inside the kernel, no head transposes). One strided
CUDA forward and one strided CUDA backward (``csrc/fused_attention.cu``)
serve both layouts: each wrapper passes the element strides of its layout,
so the packed q, k and v are read in place as column slices of the
``c_attn`` output.

Each wrapper (``_fwd_packed``, ``_bwd_packed``, ``_blk_fwd``, ``_blk_bwd``)
launches its kernel for CUDA tensors, or raises on anything the kernel does
not take; it runs the plain version only for CPU tensors. ``launches`` on
each wrapper counts its kernel launches, ``launches_f32`` and
``launches_bf16`` those of each dtype's kernel. The node axis of the
simulator is folded into the batch by the callers
(``ops/flash_attention.py``), as Pallas' batching rule folds the vmapped
axis into the grid. Contexts longer
than 1024 go to the long-context pair of ``ops/flash_attention.py``, whose
backward launches the backward kernels here.

``kv_quantize`` and ``kv_dequantize`` are the int8 KV codec of quantized
serving (plain PyTorch: elementwise, each step exact or one IEEE
rounding).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

NEG = -1e30
# Gates copied unchanged from the JAX package so that every shape takes the
# same pair of kernels there and here. They budget TPU VMEM; re-deriving
# them for H100 shared memory is later work (ROADMAP).
_VMEM_SCORE_BYTES = 1024 * 1024


def _batch_chunk(b: int, t: int) -> int:
    per_row = t * t * 4
    bc = max(1, _VMEM_SCORE_BYTES // per_row)
    while b % bc:
        bc -= 1
    return bc


def _packed_chunk(b: int, t: int) -> int:
    per_row = t * t * 4 * 2  # two live score blocks per head iteration
    bc = max(1, _VMEM_SCORE_BYTES // per_row)
    while b % bc:
        bc -= 1
    return bc


def fused_supported(q) -> bool:
    t = q.shape[-2]
    return t <= 1024 and t % 128 == 0


def packed_supported(q, n_head: int) -> bool:
    """Eligibility for the packed [B, T, C] kernels, on the per-node shape:
    the TPU kernel keeps all heads' rows in VMEM, so the gate estimates the
    backward's live set at the chosen batch chunk and rejects anything near
    the 16 MB scoped-VMEM limit (GPT-2 base at T=1024 takes the per-head
    pair instead)."""
    b, t, c = q.shape[0], q.shape[-2], q.shape[-1]
    if not (fused_supported(q) and c % n_head == 0):
        return False
    bc = _packed_chunk(b, t)
    vmem = 8 * bc * t * c * q.dtype.itemsize + 3 * bc * t * t * 4
    return vmem <= 10 * 1024 * 1024


# -- plain versions: the Pallas kernels' arithmetic --------------------------


def _mask(t: int, device) -> torch.Tensor:
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def plain_fwd(q, k, v, scale, causal):
    """[N, H, T, D] → (o [N, H, T, D], lse [N, H, T, 1] f32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_mask(s.shape[-1], s.device), s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    lse = m + torch.log(l)
    o = torch.matmul((p / l).to(v.dtype).float(), v.float())
    return o.to(q.dtype), lse


def plain_bwd(q, k, v, o, do, lse, dlse, scale, causal):
    """FA2 backward with an lse cotangent: ds = p·(dp − δ + dlse)·scale."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_mask(s.shape[-1], s.device), s, NEG)
    p = torch.exp(s - lse)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    if dlse is not None:
        ds = p * (dp - delta + dlse) * scale
    else:
        ds = p * (dp - delta) * scale
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def plain_fwd_packed(q, k, v, scale, nh):
    """Packed forward: q, k, v [N, T, C] → (o [N, T, C], lse [N, T, H])."""
    o, lse = plain_fwd(_heads(q, nh), _heads(k, nh), _heads(v, nh), scale,
                       True)
    return _packed(o), lse[..., 0].transpose(1, 2).contiguous()


def plain_bwd_packed(q, k, v, o, do, lse, scale, nh):
    """Packed backward: → (dq, dk, dv), each [N, T, C]."""
    lse_h = lse.transpose(1, 2)[..., None]
    grads = plain_bwd(*(_heads(x, nh) for x in (q, k, v, o, do)), lse_h,
                      None, scale, True)
    return tuple(_packed(g) for g in grads)


def _heads(x, nh):
    """Packed [N, T, C] → per-head view [N, H, T, D]."""
    n, t, c = x.shape
    return x.view(n, t, nh, c // nh).permute(0, 2, 1, 3)


def _packed(x):
    """Per-head [N, H, T, D] → packed [N, T, C]."""
    n, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(n, t, h * d)


# -- kernel launches --------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _check(tensors, n, h, t, d, what):
    """Raise on anything the CUDA kernels do not take."""
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{what}: tensors on {x.device} and {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{what}: mixed dtypes {x.dtype} and {dtype}")
        if x.stride(-1) != 1:
            raise ValueError(f"{what}: last dimension must be contiguous")
        # the bf16 kernels copy rows with 16-byte cp.async
        if dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:-1])):
            raise ValueError(f"{what}: bf16 views must be 16-byte aligned "
                             f"(base and strides), got strides {x.stride()}")
    if t % 64 or d not in _HEAD_DIMS or not (0 < n <= 65535) or h > 65535:
        raise ValueError(f"{what}: shape N={n} H={h} T={t} D={d} not "
                         f"supported (T % 64 == 0, D in {_HEAD_DIMS})")


def _strides(x, layout, nh=None):
    """(batch, head, token) element strides of a packed or per-head tensor."""
    if layout == "packed":        # [N, T, C], head h at column offset h·D
        return (x.stride(0), x.shape[-1] // nh, x.stride(1))
    if layout == "lse_packed":    # [N, T, H]
        return (x.stride(0), x.stride(2), x.stride(1))
    return (x.stride(0), x.stride(1), x.stride(2))  # [N, H, T, ...]


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _launch_fwd(q, k, v, o, lse, strides, n, h, t, d, causal, scale):
    from . import _build
    lib = _build.load()
    st = (ctypes.c_longlong * 15)(*[int(s) for s in strides])
    with torch.cuda.device(q.device):
        code = lib.gym_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), lse.data_ptr(), st, n, h, t, d,
                                int(causal), float(scale), _DTYPES[q.dtype],
                                _stream(q))
    _build.check(lib, code, "gym_attn_fwd")


def _launch_bwd(q, k, v, o, do, lse, dlse, dq, dk, dv, strides, n, h, t, d,
                causal, scale):
    from . import _build
    lib = _build.load()
    delta = torch.empty((n, h, t), dtype=torch.float32, device=q.device)
    st = (ctypes.c_longlong * 30)(*[int(s) for s in strides])
    with torch.cuda.device(q.device):
        code = lib.gym_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                None if dlse is None else dlse.data_ptr(),
                                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                delta.data_ptr(), st, n, h, t, d, int(causal),
                                float(scale), _DTYPES[q.dtype], _stream(q))
    _build.check(lib, code, "gym_attn_bwd")


def _check_stats(lse, dlse, shape, what):
    for name, x in (("lse", lse), ("dlse", dlse)):
        if x is None:
            continue
        if x.device != lse.device or x.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32 on {lse.device}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")


# -- the four wrappers (the Pallas kernels' call sites) ---------------------


def _fwd_packed(q, k, v, scale, nh):
    """Packed forward: q, k, v [N, T, C] → (o [N, T, C], lse [N, T, H])."""
    n, t, c = q.shape
    if not q.is_cuda:
        return plain_fwd_packed(q, k, v, scale, nh)
    d = c // nh
    _check((q, k, v), n, nh, t, d, "attention forward (packed)")
    if c % nh or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention forward (packed): shapes {q.shape}, "
                         f"{k.shape}, {v.shape} with {nh} heads")
    o = torch.empty((n, t, c), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, t, nh), dtype=torch.float32, device=q.device)
    strides = (*_strides(q, "packed", nh), *_strides(k, "packed", nh),
               *_strides(v, "packed", nh), *_strides(o, "packed", nh),
               *_strides(lse, "lse_packed"))
    _launch_fwd(q, k, v, o, lse, strides, n, nh, t, d, True, scale)
    _count(_fwd_packed, q.dtype)
    return o, lse


def _bwd_packed(q, k, v, o, do, lse, scale, nh):
    """Packed backward: → (dq, dk, dv), each [N, T, C]."""
    n, t, c = q.shape
    if not q.is_cuda:
        return plain_bwd_packed(q, k, v, o, do, lse, scale, nh)
    d = c // nh
    _check((q, k, v, o, do), n, nh, t, d, "attention backward (packed)")
    if any(x.shape != q.shape for x in (k, v, o, do)) or c % nh:
        raise ValueError("attention backward (packed): shape mismatch")
    _check_stats(lse, None, (n, t, nh), "attention backward (packed)")
    dq, dk, dv = (torch.empty((n, t, c), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    lse_st = _strides(lse, "lse_packed")
    strides = (*(s for x in (q, k, v, o, do, dq, dk, dv)
                 for s in _strides(x, "packed", nh)), *lse_st, *lse_st)
    _launch_bwd(q, k, v, o, do, lse, None, dq, dk, dv, strides, n, nh, t, d,
                True, scale)
    _count(_bwd_packed, q.dtype)
    return dq, dk, dv


def _blk_fwd(q, k, v, scale, causal):
    """Per-head forward: [N, H, T, D] → (o, lse [N, H, T, 1] f32)."""
    if not q.is_cuda:
        return plain_fwd(q, k, v, scale, causal)
    n, h, t, d = q.shape
    _check((q, k, v), n, h, t, d, "attention forward")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention forward: shapes {q.shape}, {k.shape}, "
                         f"{v.shape}")
    o = torch.empty((n, h, t, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, t, 1), dtype=torch.float32, device=q.device)
    strides = tuple(s for x in (q, k, v, o, lse) for s in _strides(x, "blk"))
    _launch_fwd(q, k, v, o, lse, strides, n, h, t, d, causal, scale)
    _count(_blk_fwd, q.dtype)
    return o, lse


def _blk_bwd(q, k, v, o, do, lse, dlse, scale, causal):
    """Per-head backward with an optional lse cotangent (None = 0)."""
    if not q.is_cuda:
        return plain_bwd(q, k, v, o, do, lse, dlse, scale, causal)
    n, h, t, d = q.shape
    _check((q, k, v, o, do), n, h, t, d, "attention backward")
    if any(x.shape != q.shape for x in (k, v, o, do)):
        raise ValueError("attention backward: shape mismatch")
    _check_stats(lse, dlse, (n, h, t, 1), "attention backward")
    dq, dk, dv = (torch.empty((n, h, t, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    lse_st = _strides(lse, "blk")
    dlse_st = lse_st if dlse is None else _strides(dlse, "blk")
    strides = (*(s for x in (q, k, v, o, do, dq, dk, dv)
                 for s in _strides(x, "blk")), *lse_st, *dlse_st)
    _launch_bwd(q, k, v, o, do, lse, dlse, dq, dk, dv, strides, n, h, t, d,
                causal, scale)
    _count(_blk_bwd, q.dtype)
    return dq, dk, dv


def _count(wrapper, dtype) -> None:
    """One launch of ``wrapper``'s kernel: ``launches`` counts them all,
    ``launches_f32`` and ``launches_bf16`` each instantiation's."""
    wrapper.launches += 1
    if dtype == torch.float32:
        wrapper.launches_f32 += 1
    else:
        wrapper.launches_bf16 += 1


def reset_launch_counts() -> None:
    for w in (_fwd_packed, _bwd_packed, _blk_fwd, _blk_bwd):
        w.launches = w.launches_f32 = w.launches_bf16 = 0


reset_launch_counts()


# -- autograd --------------------------------------------------------------


def _grad_layout(do):
    # the kernels read rows with a unit last stride; a cotangent with any
    # other layout is copied once to that layout
    return do if do.stride(-1) == 1 else do.contiguous()


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, n_head, scale):
        o, lse = _fwd_packed(q, k, v, scale, n_head)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.n_head, ctx.scale = n_head, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_packed(q, k, v, o, _grad_layout(do).to(q.dtype),
                                 lse, ctx.scale, ctx.n_head)
        return dq, dk, dv, None, None


class _CausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _blk_fwd(q, k, v, scale, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _blk_bwd(q, k, v, o, _grad_layout(do).to(q.dtype), lse,
                              None, ctx.scale, True)
        return dq, dk, dv, None


class _BlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _blk_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dlse = None if dlse is None else _grad_layout(dlse).float()
        dq, dk, dv = _blk_bwd(q, k, v, o, _grad_layout(do).to(q.dtype), lse,
                              dlse, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def fused_causal_attention(q, k, v, scale=None):
    """softmax(mask(QKᵀ·scale))·V on [B, H, T, D], T ≤ 1024, no dropout: the
    whole-context causal case of the block kernels (dlse = 0)."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    return _CausalAttention.apply(q, k, v, scale)


def fused_block_attention(q, k, v, causal, scale=None):
    """One attention block: ``(o, lse)`` with lse [B, H, T, 1] f32; both
    outputs are differentiable (the lse cotangent flows into ds)."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    return _BlockAttention.apply(q, k, v, causal, scale)


def fused_causal_attention_packed(q, k, v, n_head, scale=None):
    """Packed-layout fused attention: q, k, v and output are [B, T, C]
    (C = n_head·head_dim), no head transposes. T ≤ 1024, no dropout."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1] // n_head)
    return _PackedAttention.apply(q, k, v, n_head, scale)


# -- the int8 KV cache of quantized serving ----------------------------------
#
# A decode config with kv_dtype="int8" stores each written position's K and V
# head vectors as int8 with one f32 scale per (position, head), amax / 127:
# quantized once, as they are written, to nearest (QuantizeCodec's
# stochastic=False idiom with the tile set to the head vector), so a shared
# prompt page holds the same (int8, scale) pairs for every reader and a
# copy-on-write copies them as they are. B7's int8 form
# (ops/decode_attention.py) reads them dequantized.

KV_QMAX = 127  # int8's symmetric range, QuantizeCodec(bits=8)'s
# XLA compiles kv_quantize's ``amax / 127`` into a multiply by the f32
# reciprocal of the constant: the bits of the JAX package's decode programs
_INV_QMAX = float(np.float32(1.0) / np.float32(KV_QMAX))


def kv_quantize(x: torch.Tensor):
    """x ``[..., H, hd]`` f32 → (q int8 ``[..., H, hd]``, scale f32
    ``[..., H]``): ``scale = amax · f32(1/127)`` over each head vector (1.0
    for an all-zero or NaN one; the JAX function's ``amax / 127`` as XLA
    compiles it), ``q = clamp(round(x / scale), ±127)``, rounded half to
    even; a NaN element gives 0, as XLA converts it. Each step is exact or
    one IEEE rounding, elementwise, and the division is by a tensor (the
    card divides by a host scalar as a multiply by its reciprocal), so the
    card and the CPU give the bits of the JAX package's jitted decode."""
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax * torch.full_like(amax, _INV_QMAX),
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(x / scale[..., None]), -KV_QMAX, KV_QMAX)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """The inverse of :func:`kv_quantize`: q ``[..., H, hd]`` int8 ×
    scale ``[..., H]`` → ``[..., H, hd]``, one rounding an element."""
    return q.to(dtype) * scale[..., None].to(dtype)
