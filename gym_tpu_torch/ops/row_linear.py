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
- ``row_qlinear`` (B6): R1 over quantized weights (int8 values, int4
  stored in int8, one f32 scale per ``t`` consecutive elements of the
  row-major weight), in both layouts; bit for bit ``row_linear`` on
  ``dequantize_tiles(q, scale)``: the kernel dequantizes each weight once,
  as it stages it, and runs R1's chains on it.
- ``row_linear_ref`` and ``row_qlinear_ref``: R1's and B6's first
  kernels, whose bits the served path keeps, on the card only: the oracle
  the card checks hold every tiling of R1 and B6 to, bit for bit.
- ``row_layer_norm`` (L1): flax ``nn.LayerNorm`` with its arithmetic (f32
  mean and E[x²] − E[x]², then (x − mean)·(rsqrt(var + eps)·scale) + bias);
  the kernel reduces each row in one warp in an order fixed by C.
- ``row_add_layer_norm``: L1 with the residual add it follows, one launch
  for ``s = x + d`` and L1 of s, bit for bit a torch add then
  ``row_layer_norm`` (the decode forward's every layer norm; L1's first
  kernel, ``row_layer_norm``, is its oracle on the card).
- ``row_cumsum``: the inclusive cumsum of the sampler's top-p, as blocks
  of 32 summed by R1 against an upper-triangular 0/1 matrix, their totals
  scanned the same way: each element's sums are fixed by the row's length
  alone. ``torch.cumsum`` on the card is not: one row goes to CUB's scan,
  whose look-back may combine a tile's predecessors in another order from
  run to run, and several rows to a scan whose tree width follows the row
  count.

On a CPU tensor each wrapper runs its twin, on a CUDA tensor it launches its
kernel or raises; ``row_linear.launches``, ``row_qlinear.launches``,
``row_layer_norm.launches`` and ``row_add_layer_norm.launches`` count the
launches, and ``shape_counts``, while
a caller sets it to a ``Counter``, R1's and B6's launches by shape.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .grouped_matmul import dequantize_tiles

SCAN_BLOCK = 32
# (kernel, M, K, N, W's layout) -> launches of R1 ("R1") and B6 ("B6"), while
# a caller tallies them (scripts/profile_serve.py); None otherwise
shape_counts = None


def _note_shape(kernel: str, m: int, k: int, n: int, w_nk: bool) -> None:
    if shape_counts is not None:
        shape_counts[(kernel, m, k, n, "nk" if w_nk else "kn")] += 1


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


def _linear_args(x, w, bias, w_nk):
    """R1's checks: ``(lead, x2, m, k, n)``."""
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
    x2 = x.reshape(-1, k)
    return x.shape[:-1], x2, x2.shape[0], k, n


def _on_card(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: device must be cuda, got {x.device}")


def _launch_gemm(x2, m, k, n, w, bias, w_nk, tiling, ref):
    """One launch of R1 (``tiling``: -1 the dispatch's, else a sweep's),
    or of the oracle when ``ref``; ``[m, n]``, or None at m = 0."""
    if m == 0:
        return None
    if m >= 2 ** 31 or n >= 2 ** 31 or k >= 2 ** 31:
        raise ValueError(f"[{m}, {k}] x [{k}, {n}] too large")
    x2 = x2.contiguous()
    if not w.is_contiguous() or (bias is not None
                                 and not bias.is_contiguous()):
        raise ValueError("W and bias must be contiguous")
    out = torch.empty(m, n, dtype=torch.float32, device=x2.device)
    from . import _build
    lib = _build.load()
    ptrs = (x2.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            k, 0 if w_nk else 1)
    with torch.cuda.device(x2.device):
        if ref:
            name = "gym_row_gemm_ref"
            code = lib.gym_row_gemm_ref(*ptrs, _stream(x2.device))
        else:
            name = "gym_row_gemm"
            code = lib.gym_row_gemm(*ptrs, tiling, _stream(x2.device))
    _build.check(lib, code, name)
    return out


def row_linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor = None,
               w_nk: bool = False) -> torch.Tensor:
    """x ``[..., K]`` · W (``[K, N]``, or ``[N, K]`` read transposed when
    ``w_nk``) (+ bias ``[N]``) → ``[..., N]`` f32, each row's bits
    independent of the other rows. On the card one launch of R1, in the
    tiling its dispatch picks for the shape."""
    lead, x2, m, k, n = _linear_args(x, w, bias, w_nk)
    if x.device.type == "cpu":
        return plain_row_linear(x2, w, bias, w_nk).view(*lead, n)
    _on_card(x, "row_linear")
    out = _launch_gemm(x2, m, k, n, w, bias, w_nk, -1, ref=False)
    if out is None:
        return x.new_empty(*lead, n)
    row_linear.launches += 1
    _note_shape("R1", m, k, n, w_nk)
    return out.view(*lead, n)


def row_linear_ref(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor = None,
                   w_nk: bool = False) -> torch.Tensor:
    """R1's oracle on the card: ``row_linear``'s function in the first
    kernel's tilings (no pipelining), the bits the served path has always
    had. Never on the serving path: the card checks hold R1 to it bit for
    bit. A CUDA tensor only."""
    lead, x2, m, k, n = _linear_args(x, w, bias, w_nk)
    _on_card(x, "row_linear_ref")
    out = _launch_gemm(x2, m, k, n, w, bias, w_nk, -1, ref=True)
    return x.new_empty(*lead, n) if out is None else out.view(*lead, n)


def row_gemm_tiled(x: torch.Tensor, w: torch.Tensor, w_nk: bool,
                   tiling: int, scale: torch.Tensor = None) -> torch.Tensor:
    """One launch of R1 (or of B6, with ``scale``: ``w`` is q) in the
    tiling ``row_gemm.cu``'s ``enum Tiling`` names, not the dispatch's
    choice, for a sweep of the tilings (``scripts/r1_sweep.py``): the same
    bits. No bias, not counted. A CUDA tensor only."""
    _on_card(x, "row_gemm_tiled")
    if scale is None:
        _, x2, m, k, n = _linear_args(x, w, None, w_nk)
        return _launch_gemm(x2, m, k, n, w, None, w_nk, tiling, ref=False)
    _, x2, m, k, n, t = _qlinear_args(x, w, scale, None, w_nk)
    return _launch_qgemm(x2, m, k, n, t, w, scale, None, w_nk, tiling,
                         ref=False)


def tiling_of(m: int, k: int, n: int, w_nk: bool = False) -> int:
    """The tiling R1's and B6's dispatch picks for ``[m, k] x [k, n]``
    (``row_gemm.cu``'s ``enum Tiling``: by M and N); needs the kernel
    library."""
    from . import _build
    return _build.load().gym_row_gemm_tiling(m, n, 0 if w_nk else 1)


# row_gemm.cu's enum Tiling
TILINGS = ("few 16x16", "mid 64x64", "wide 128x64", "scan 32x32",
           "nk 16x128")


def plain_row_qlinear(x2: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor = None,
                      w_nk: bool = False) -> torch.Tensor:
    """B6's twin: the weights dequantized, then R1's twin."""
    return plain_row_linear(x2, dequantize_tiles(q, scale), bias, w_nk)


def _qlinear_args(x, q, scale, bias, w_nk):
    """B6's checks: ``(lead, x2, m, k, n, t)``."""
    k = x.shape[-1]
    if q.dim() != 2 or (q.shape[1] if w_nk else q.shape[0]) != k:
        raise ValueError(f"x [..., {k}] does not fit q {tuple(q.shape)} "
                         f"(w_nk={w_nk})")
    n = q.shape[0] if w_nk else q.shape[1]
    if q.dtype != torch.int8:
        raise ValueError(f"q must be int8, got {q.dtype}")
    if scale.dim() != 1 or scale.numel() == 0 or \
            q.numel() % scale.numel():
        raise ValueError(f"scale {tuple(scale.shape)} does not tile q "
                         f"{tuple(q.shape)}")
    t = q.numel() // scale.numel()
    if q.shape[1] % t:
        raise ValueError(f"tile {t} does not divide q's rows of "
                         f"{q.shape[1]}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} is not [{n}]")
    floats = (x, scale) if bias is None else (x, scale, bias)
    if any(f.dtype != torch.float32 for f in floats):
        raise ValueError("x, scale and bias must be float32")
    if len({f.device for f in floats + (q,)}) != 1:
        raise ValueError("x, q, scale and bias on several devices")
    x2 = x.reshape(-1, k)
    return x.shape[:-1], x2, x2.shape[0], k, n, t


def _launch_qgemm(x2, m, k, n, t, q, scale, bias, w_nk, tiling, ref):
    """One launch of B6 (or of its oracle when ``ref``); ``[m, n]``, or
    None at m = 0."""
    if m == 0:
        return None
    if m >= 2 ** 31 or q.numel() >= 2 ** 31:
        raise ValueError(f"[{m}, {k}] x {tuple(q.shape)} too large")
    x2 = x2.contiguous()
    if not (q.is_contiguous() and scale.is_contiguous()) or (
            bias is not None and not bias.is_contiguous()):
        raise ValueError("q, scale and bias must be contiguous")
    out = torch.empty(m, n, dtype=torch.float32, device=x2.device)
    from . import _build
    lib = _build.load()
    ptrs = (x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            k, 0 if w_nk else 1, t)
    with torch.cuda.device(x2.device):
        if ref:
            name = "gym_row_qgemm_ref"
            code = lib.gym_row_qgemm_ref(*ptrs, _stream(x2.device))
        else:
            name = "gym_row_qgemm"
            code = lib.gym_row_qgemm(*ptrs, tiling, _stream(x2.device))
    _build.check(lib, code, name)
    return out


def row_qlinear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor = None, w_nk: bool = False) -> torch.Tensor:
    """x ``[..., K]`` · dequant(q, scale) (q int8 ``[K, N]``, or ``[N, K]``
    read transposed when ``w_nk``; scale f32 ``[q.numel() / t]``, t
    dividing q's trailing axis) (+ bias ``[N]``) → ``[..., N]`` f32, the
    bits of ``row_linear`` on the dequantized weight. On the card one
    launch of B6."""
    lead, x2, m, k, n, t = _qlinear_args(x, q, scale, bias, w_nk)
    if x.device.type == "cpu":
        return plain_row_qlinear(x2, q, scale, bias, w_nk).view(*lead, n)
    _on_card(x, "row_qlinear")
    out = _launch_qgemm(x2, m, k, n, t, q, scale, bias, w_nk, -1, ref=False)
    if out is None:
        return x.new_empty(*lead, n)
    row_qlinear.launches += 1
    _note_shape("B6", m, k, n, w_nk)
    return out.view(*lead, n)


def row_qlinear_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor = None,
                    w_nk: bool = False) -> torch.Tensor:
    """B6's oracle on the card, as ``row_linear_ref`` is R1's. A CUDA
    tensor only."""
    lead, x2, m, k, n, t = _qlinear_args(x, q, scale, bias, w_nk)
    _on_card(x, "row_qlinear_ref")
    out = _launch_qgemm(x2, m, k, n, t, q, scale, bias, w_nk, -1, ref=True)
    return x.new_empty(*lead, n) if out is None else out.view(*lead, n)


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


def row_add_layer_norm(x: torch.Tensor, d: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor = None,
                       eps: float = 1e-5, want_sum: bool = True):
    """L1 with the residual add it follows: ``(s, y)``, s = x + d (one
    rounding: the residual stream) and y the layer norm of each row of s
    ``[..., C]`` (f32) with ``scale`` and ``bias`` ``[C]``, bit for bit
    ``row_layer_norm(x + d)``. ``want_sum=False`` leaves s unwritten and
    returns ``(None, y)`` (the last layer norm, whose sum nothing reads).
    On the card one launch of ``row_add_layer_norm_kernel``; on the CPU
    ``x + d``, then the twin."""
    c = x.shape[-1]
    if d.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and d {tuple(d.shape)} differ")
    if scale.shape != (c,) or (bias is not None and bias.shape != (c,)):
        raise ValueError(f"scale/bias must be [{c}]")
    tensors = (x, d, scale) if bias is None else (x, d, scale, bias)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("row_add_layer_norm is float32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, d, scale and bias on several devices")
    if x.device.type == "cpu":
        s = x + d
        return (s if want_sum else None), plain_row_layer_norm(s, scale,
                                                               bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {x.device}")
    x2 = x.reshape(-1, c).contiguous()
    d2 = d.reshape(-1, c).contiguous()
    m = x2.shape[0]
    y = torch.empty_like(x2)
    s = torch.empty_like(x2) if want_sum else None
    if m == 0:
        return (s.view(x.shape) if want_sum else None), y.view(x.shape)
    if m >= 2 ** 31 or c >= 2 ** 31:
        raise ValueError(f"[{m}, {c}] too large")
    from . import _build
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.gym_row_add_layer_norm(
            x2.data_ptr(), d2.data_ptr(), scale.contiguous().data_ptr(),
            None if bias is None else bias.contiguous().data_ptr(),
            None if s is None else s.data_ptr(), y.data_ptr(), m, c,
            float(eps), _stream(x.device))
    _build.check(lib, code, "gym_row_add_layer_norm")
    row_add_layer_norm.launches += 1
    return (s.view(x.shape) if want_sum else None), y.view(x.shape)


row_linear.launches = 0
row_qlinear.launches = 0
row_layer_norm.launches = 0
row_add_layer_norm.launches = 0


def reset_launch_counts() -> None:
    row_linear.launches = 0
    row_qlinear.launches = 0
    row_layer_norm.launches = 0
    row_add_layer_norm.launches = 0


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
