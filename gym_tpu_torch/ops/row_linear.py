"""R1 and L1: the serving path's row-invariant f32 linear layer and layer
norm, hand-written CUDA kernels (``csrc/row_gemm.cu``) with their plain
PyTorch twins; and ``row_cumsum``, a row-invariant scan built on R1.

The serving engine's contracts are equalities between one row computed at
different batch geometries: one slot alone and among 16, a prompt and its
power-of-two bucket, one position and a verify chunk. ``torch.matmul`` and
PyTorch's reductions choose their algorithm by shape, on the card and in
MKL on the CPU, so the same row can come out in other bits, and sampling
turns a last-bit difference at a near-tie into another token. Here a row's
bits never depend on the other rows:

- ``row_linear`` (R1): y = x·W (+ b) in flax's ``[in, out]`` layout, or
  x·Wᵀ for the tied lm head (``w_nk=True``, W = wte ``[V, C]``). The
  kernel chains each output element's FMAs over k in order; the twin
  multiplies one row at a time. The bias is added to the rounded product,
  as flax adds it.
- ``row_layer_norm`` (L1): flax ``nn.LayerNorm`` with its arithmetic (f32
  mean and E[x²] − E[x]², then (x − mean)·(rsqrt(var + eps)·scale) + bias);
  the kernel reduces each row in one warp in an order fixed by C.
- ``row_cumsum``: the inclusive cumsum of the sampler's top-p, as blocks
  of 32 summed by R1 against an upper-triangular 0/1 matrix, their totals
  scanned the same way: each element's sums are fixed by the row's length
  alone. ``torch.cumsum`` on the card is not: one row goes to CUB's scan,
  whose look-back may combine a tile's predecessors in another order from
  run to run, and several rows to a scan whose tree width follows the row
  count.

On a CPU tensor each wrapper runs its twin, on a CUDA tensor it launches its
kernel or raises; ``row_linear.launches`` and ``row_layer_norm.launches``
count the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

SCAN_BLOCK = 32


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def plain_row_linear(x2: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor = None,
                     w_nk: bool = False) -> torch.Tensor:
    """The twin: ``[M, K]`` → ``[M, N]``, one row at a time, each row a fresh
    ``[1, K]`` tensor (the same product call for every row)."""
    wt = w.t() if w_nk else w
    out = torch.empty(x2.shape[0], wt.shape[1], dtype=torch.float32,
                      device=x2.device)
    for m in range(x2.shape[0]):
        out[m] = (x2[m:m + 1].clone() @ wt)[0]
    if bias is not None:
        out = out + bias
    return out


def row_linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor = None,
               w_nk: bool = False) -> torch.Tensor:
    """x ``[..., K]`` · W (``[K, N]``, or ``[N, K]`` read transposed when
    ``w_nk``) (+ bias ``[N]``) → ``[..., N]`` f32, each row's bits
    independent of the other rows. On the card one launch of R1."""
    k = x.shape[-1]
    n, kw = (w.shape[0], w.shape[1]) if w_nk else (w.shape[1], w.shape[0])
    if w.dim() != 2 or kw != k:
        raise ValueError(f"x [..., {k}] does not fit W {tuple(w.shape)} "
                         f"(w_nk={w_nk})")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} is not [{n}]")
    tensors = (x, w) if bias is None else (x, w, bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("row_linear is float32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, W and bias on several devices")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if x.device.type == "cpu":
        return plain_row_linear(x2, w, bias, w_nk).view(*lead, n)
    if x.device.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {x.device}")
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    if m == 0:
        return out.view(*lead, n)
    if m >= 2 ** 31 or n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"[{m}, {k}] x [{k}, {n}] too large")
    x2 = x2.contiguous()
    if not w.is_contiguous() or (bias is not None
                                 and not bias.is_contiguous()):
        raise ValueError("W and bias must be contiguous")
    from . import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.gym_row_gemm(
            x2.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            k, 0 if w_nk else 1, _stream(x.device))
    _build.check(lib, code, "gym_row_gemm")
    row_linear.launches += 1
    return out.view(*lead, n)


def plain_row_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """The twin: flax's layer norm over the last dimension, in f32."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * scale)
    if bias is not None:
        y = y + bias
    return y


def row_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor = None,
                   eps: float = 1e-5) -> torch.Tensor:
    """Layer norm of each row of x ``[..., C]`` (f32) with ``scale`` and
    ``bias`` ``[C]``. On the card one launch of L1."""
    c = x.shape[-1]
    if scale.shape != (c,) or (bias is not None and bias.shape != (c,)):
        raise ValueError(f"scale/bias must be [{c}]")
    tensors = (x, scale) if bias is None else (x, scale, bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("row_layer_norm is float32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, scale and bias on several devices")
    if x.device.type == "cpu":
        return plain_row_layer_norm(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {x.device}")
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    out = torch.empty_like(x2)
    if m == 0:
        return out.view(x.shape)
    if m >= 2 ** 31 or c >= 2 ** 31:
        raise ValueError(f"[{m}, {c}] too large")
    from . import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.gym_row_layer_norm(
            x2.data_ptr(), scale.contiguous().data_ptr(),
            None if bias is None else bias.contiguous().data_ptr(),
            out.data_ptr(), m, c, float(eps), _stream(x.device))
    _build.check(lib, code, "gym_row_layer_norm")
    row_layer_norm.launches += 1
    return out.view(x.shape)


row_linear.launches = 0
row_layer_norm.launches = 0


def reset_launch_counts() -> None:
    row_linear.launches = 0
    row_layer_norm.launches = 0


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along the last dimension of x ``[R, V]`` (f32),
    each row's bits fixed by V alone: blocks of 32 through R1 against a
    [32, 32] 0/1 matrix with 1 where k <= i (each column a chain of adds in
    order: x·1 and x·0 are exact, and adding 0 changes no sum), the
    blocks' totals scanned the same way and added to the blocks after
    them."""
    tri = torch.triu(torch.ones(SCAN_BLOCK, SCAN_BLOCK, device=x.device))
    return _scan(x, tri)


def _scan(x: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    r, v = x.shape
    nb = -(-v // SCAN_BLOCK)
    xp = F.pad(x, (0, nb * SCAN_BLOCK - v))
    inner = row_linear(xp.reshape(r * nb, SCAN_BLOCK), tri).view(
        r, nb, SCAN_BLOCK)
    if nb > 1:
        tot = _scan(inner[:, :, -1].contiguous(), tri)          # [R, nb]
        before = F.pad(tot[:, :-1], (1, 0))                     # exclusive
        inner = inner + before[:, :, None]
    return inner.reshape(r, nb * SCAN_BLOCK)[:, :v]
