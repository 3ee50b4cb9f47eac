"""The grouped matmuls of the MoE layers and the quantized matmuls of the
serving path (counterpart of ``gym_tpu/ops/grouped_matmul.py``).

A quantized serving config stores every block kernel (and, with
``quant_embed``, the tied ``wte``) as int8 values (int4 values are stored
in int8) and one f32 scale per ``t`` consecutive elements of the
row-major weight, the ``QuantizeCodec`` tiling (``serve/load.py``
``quantize_params``). ``t`` divides the trailing axis
(``quant_tile_for``), so no tile straddles two rows.

``quantized_dot`` and ``quantized_attend`` consume that layout through B6
(``ops/row_linear.py`` ``row_qlinear``): on the card one launch that
dequantizes each weight as it is staged and then runs R1's FMA chains, bit
for bit R1 on ``dequantize_tiles(q, scale)``; on the CPU its plain version.
No f32 weight is stored.

The grouped matmuls (B8, the MoE layers' expert products,
``csrc/grouped_gemm.cu``): ``grouped_dot(x, w, gs)`` is ``lax.ragged_dot``,
``y[r] = x[r] @ w[g(r)]`` with the first ``gs[0]`` rows on ``w[0]``, the
next ``gs[1]`` on ``w[1]`` and so on, rows past ``sum(gs)`` zeros, empty
groups legal; ``grouped_outer(x, g, gs)`` is its w-cotangent, ``out[e] =
x_eᵀ @ g_e``. Their gradients are ``torch.autograd.Function``s that close
over each other, the JAX transposes: ``ct_x = grouped_dot(ct, wᵀ)``, w
read transposed through its strides (no copy), ``ct_w = grouped_outer(x,
ct)``. K problems of the same shape are one call: stack the rows ``[K·R,
C]``, the weights ``[K·E, C, H]`` and the sizes ``[K·E]``, so that problem
n's rows land in groups n·E … n·E+E−1 (JAX's flattening batch rule).
``gs`` stays on the device: nothing here reads it on the host for a CUDA
tensor. On a CPU tensor the entries run ``plain_grouped_dot`` and
``plain_grouped_outer`` (torch over the groups, also the tests' oracle); on
a CUDA tensor they launch B8 or raise.

On the card a bf16 call takes one of two paths, by a rule on its views
(``tma_path_dot``, ``tma_path_outer``): TMA takes 16-byte-aligned bases
and row strides, so the TMA/``wgmma`` kernels run where x, w (or ct) lie
16-byte aligned, K, N (C, H) are multiples of 8 and one of w's last two
axes is contiguous with the other's stride a multiple of 8; every other
bf16 view runs the first kernels (``mma.sync``), kept as the oracle
(``grouped_dot_ref``, ``grouped_outer_ref``, uncounted). f32 always runs
the ring kernels (R1's in-order FMA chains on a ``cp.async`` ring), the
forward at the tiling ``f32_tiling`` picks from the row count; the first
f32 kernels are their oracle, reached only through ``grouped_dot_ref`` and
``grouped_outer_ref`` on f32 tensors. ``grouped_dot.launches`` and
``grouped_outer.launches`` count the launches of the TMA and f32 kernels
(one a call: the outer has no second pass), ``launches_f32`` the f32
ones among them, ``launches_ref`` those of the first kernels for bf16
views TMA does not take, and ``grouped_dot.launches_wt`` the launches, on
either path, that read w transposed. A CUDA graph's replays add to
``launches`` alone (``programs/graphs.py``); the others count the calls
that run the wrapper.
"""

from __future__ import annotations

import ctypes

import torch


def quant_tile_for(shape, tile: int) -> int:
    """The codec tile for a weight of ``shape``: the largest divisor of the
    trailing axis that is at most ``tile``, so every tile lies inside one
    row of the flattened weight and the codec pads nothing."""
    h = int(shape[-1])
    t = max(1, min(int(tile), h))
    while h % t:
        t -= 1
    return t


def dequantize_tiles(q: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """``q`` (int8, ``len(scale) * tile`` elements, any shape) times its
    tiles' scales ``[T]``, in ``q``'s shape: each element
    ``q.to(f32) * scale``, one rounding."""
    t = scale.shape[0]
    return (q.to(dtype).reshape(t, -1)
            * scale[:, None].to(dtype)).reshape(q.shape)


def quantized_dot(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor = None) -> torch.Tensor:
    """``x @ dequant(q, scale)`` (+ ``bias``, added to the rounded
    product): x ``[..., C]`` f32, q ``[C, H]`` int8, scale ``[C·H / t]``
    f32 → ``[..., H]``. B6 on the card."""
    from .row_linear import row_qlinear
    return row_qlinear(x, q, scale, bias)


def quantized_attend(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q, scale).T``: logits against a quantized ``[V, C]``
    embedding (the tied lm head), B6 reading q transposed."""
    from .row_linear import row_qlinear
    return row_qlinear(x, q, scale, w_nk=True)


# -- B8: the grouped matmuls -----------------------------------------------


def _group_rows(gs: torch.Tensor, rows: int):
    """(group, first row, row count) of each non-empty group, the sizes
    clamped so that no group passes ``rows`` (read on the host: the plain
    versions only)."""
    start = 0
    for g, n in enumerate(gs.tolist()):
        n = max(0, min(int(n), rows - start))
        if n:
            yield g, start, n
        start += n


# the f32 forward's tilings (``grouped_gemm.cu`` ``f32::Tiling``) and the
# rows of a tile of each: few rows (the served decode steps), the prefill
# buckets, many rows (training, the evals)
F32_FEW, F32_MID, F32_WIDE = 0, 1, 2
F32_TILE_ROWS = {F32_FEW: 16, F32_MID: 64, F32_WIDE: 128}
# the most rows of the few-row tiling and the fewest of the many-row one,
# from scripts/b8_f32_sweep.py on the H100 at the MoE widths (PERF.md)
F32_FEW_MAX_ROWS, F32_WIDE_MIN_ROWS = 128, 4096


def f32_tiling(rows: int) -> int:
    """The f32 forward's tiling for a call of ``rows`` rows, from the
    static row count alone (never the group sizes, so a graph holds the
    launch): 16-row slots that read each expert's weights once up to 64
    tokens routed top-2, 64 x 64 tiles for the prefill buckets, 128 x 128
    tiles from 4096 rows."""
    if rows <= F32_FEW_MAX_ROWS:
        return F32_FEW
    return F32_MID if rows < F32_WIDE_MIN_ROWS else F32_WIDE


def row_slots(gs, rows: int, bm: int = 128):
    """The forward's row slots (``grouped_gemm.cu`` ``find_row_tile``),
    plain Python: (group, first row, end row) of each group's tiles of
    ``bm`` rows, group by group, then ``(-1, r0, r1)`` for the tiles of the
    rows past the groups, up to ``rows / bm + G + 1`` slots (the grid's)
    with ``None`` for a slot past them all."""
    sizes = [int(n) for n in gs]
    out, start = [], 0
    for g, n in enumerate(sizes):
        n = max(0, min(n, rows - start))
        out += [(g, r0, min(start + n, r0 + bm))
                for r0 in range(start, start + n, bm)]
        start += n
    out += [(-1, r0, min(rows, r0 + bm)) for r0 in range(start, rows, bm)]
    slots = -(-rows // bm) + len(sizes) + 1
    return out + [None] * (slots - len(out))


def outer_order(gs, rows: int):
    """The outer's groups in its blocks' order (``grouped_gemm.cu``
    ``nth_longest``), plain Python: (group, first row, row count), the
    longest first, equal counts by group index; sizes clamped so that no
    group passes ``rows``."""
    spans, start = [], 0
    for g, n in enumerate(int(n) for n in gs):
        n = max(0, min(n, rows - start))
        spans.append((g, start, n))
        start += n
    return sorted(spans, key=lambda s: (-s[2], s[0]))


def plain_grouped_dot(x: torch.Tensor, w: torch.Tensor,
                      gs: torch.Tensor) -> torch.Tensor:
    """B8's plain version: x ``[R, K]``, w ``[G, K, N]`` (any strides), gs
    ``[G]`` → ``[R, N]`` in x's dtype, one ``matmul`` a group; rows past
    ``sum(gs)`` zeros."""
    out = x.new_zeros(x.shape[0], w.shape[-1])
    for g, start, n in _group_rows(gs, x.shape[0]):
        out[start:start + n] = x[start:start + n] @ w[g]
    return out


def plain_grouped_outer(x: torch.Tensor, g: torch.Tensor,
                        gs: torch.Tensor) -> torch.Tensor:
    """B8's plain w-cotangent: x ``[R, C]``, g ``[R, H]``, gs ``[G]`` →
    ``[G, C, H]`` in x's dtype, ``x_eᵀ @ g_e`` a group, zeros for an empty
    one."""
    out = x.new_zeros(gs.shape[0], x.shape[1], g.shape[1])
    for e, start, n in _group_rows(gs, x.shape[0]):
        out[e] = x[start:start + n].t() @ g[start:start + n]
    return out


def _b8_dtype(*ts) -> int:
    """1 for bf16 operands, 0 for f32 (B8's ``bf16`` argument); raises on
    anything else or on mixed dtypes or devices."""
    if len({t.dtype for t in ts}) != 1 or ts[0].dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"B8 takes f32 or bf16 operands of one dtype, got "
                         f"{[t.dtype for t in ts]}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("B8's operands lie on several devices")
    return int(ts[0].dtype == torch.bfloat16)


def _sizes(gs: torch.Tensor, device) -> torch.Tensor:
    if gs.device != device:
        raise ValueError(f"gs on {gs.device}, operands on {device}")
    return gs.to(torch.int32).contiguous()


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _dot_checks(x, w, gs):
    if x.dim() != 2 or w.dim() != 3 or gs.dim() != 1:
        raise ValueError(f"grouped_dot shapes: x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} gs{tuple(gs.shape)}")
    if x.shape[1] != w.shape[1] or w.shape[0] != gs.shape[0]:
        raise ValueError(f"grouped_dot dims disagree: x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} gs{tuple(gs.shape)} (need "
                         f"x[1]==w[1] and w[0]==gs[0])")


def tma_path_dot(x, w) -> bool:
    """Whether a bf16 ``grouped_dot`` on the card takes the TMA kernels (x
    contiguous): x and w 16-byte aligned, K and N multiples of 8, w's
    expert stride a multiple of 8, and w's k axis contiguous with its n
    stride a multiple of 8 (w read transposed) or its n axis contiguous
    with its k stride a multiple of 8 (w as it lies). ``gym_grouped_gemm``
    holds the same rule."""
    k, n = w.shape[1], w.shape[2]
    sg, sk, sn = w.stride()
    lay = sn % 8 == 0 if sk == 1 else (sn == 1 and sk % 8 == 0)
    return (x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0 and k % 8 == 0 and n % 8 == 0
            and sg % 8 == 0 and lay)


def tma_path_outer(x, g) -> bool:
    """Whether a bf16 ``grouped_outer`` on the card takes the TMA kernel
    (x and g contiguous, at least one row): both 16-byte aligned, C and H
    multiples of 8 (``gym_grouped_outer``'s rule)."""
    return (x.dtype == torch.bfloat16 and x.data_ptr() % 16 == 0
            and g.data_ptr() % 16 == 0 and x.shape[1] % 8 == 0
            and g.shape[1] % 8 == 0)


def _launch_dot(x, w, gs, ref=False, tiling=None):
    """One launch of B8's grouped GEMM: ``[R, N]``. bf16 takes the TMA
    kernel where ``tma_path_dot`` allows, f32 the ring kernels at
    ``tiling`` (by default ``f32_tiling``'s), and ``ref`` (or a bf16 view
    TMA does not take) the first kernel of the dtype. Returns (y, the path
    launched: "tma", "ref", "f32", or None for nothing launched)."""
    bf16 = _b8_dtype(x, w)
    r, k = x.shape
    g, _, n = w.shape
    y = torch.empty(r, n, dtype=x.dtype, device=x.device)
    if r == 0 or n == 0:
        return y, None
    if k == 0 or g == 0:
        return y.zero_(), None
    x = x.contiguous()
    path = ("ref" if ref else "f32" if not bf16 else
            "tma" if tma_path_dot(x, w) else "ref")
    gs = _sizes(gs, x.device)
    from . import _build
    lib = _build.load()
    args = (x.data_ptr(), w.data_ptr(), gs.data_ptr(), y.data_ptr(), r, k,
            n, g, w.stride(0), w.stride(1), w.stride(2), bf16)
    with torch.cuda.device(x.device):
        if path == "ref":
            name = "gym_grouped_gemm_ref"
            code = lib.gym_grouped_gemm_ref(*args, _stream(x.device))
        else:
            name = "gym_grouped_gemm"
            if bf16:
                tiling = -1
            elif tiling is None:
                tiling = f32_tiling(r)
            code = lib.gym_grouped_gemm(*args, tiling, _stream(x.device))
    _build.check(lib, code, name)
    return y, path


def _launch_outer(x, g, gs, ref=False):
    """One launch of B8's outer kernel: ``[G, C, H]``, bf16 on the TMA
    kernel where ``tma_path_outer`` allows, f32 on the ring kernel, the
    first kernel of the dtype for ``ref``; returns (out, the path) as
    ``_launch_dot``."""
    bf16 = _b8_dtype(x, g)
    r, c = x.shape
    h = g.shape[1]
    e = gs.shape[0]
    out = torch.empty(e, c, h, dtype=x.dtype, device=x.device)
    if e == 0 or c == 0 or h == 0:
        return out, None
    if r == 0:
        return out.zero_(), None
    x, g = x.contiguous(), g.contiguous()
    path = ("ref" if ref else "f32" if not bf16 else
            "tma" if tma_path_outer(x, g) else "ref")
    gs = _sizes(gs, x.device)
    from . import _build
    lib = _build.load()
    args = (x.data_ptr(), g.data_ptr(), gs.data_ptr(), out.data_ptr(), r, c,
            h, e, bf16)
    with torch.cuda.device(x.device):
        name = "gym_grouped_outer_ref" if path == "ref" else \
            "gym_grouped_outer"
        code = getattr(lib, name)(*args, _stream(x.device))
    _build.check(lib, code, name)
    return out, path


def _count(fn, path):
    if path == "ref":
        fn.launches_ref += 1
    elif path is not None:
        fn.launches += 1
        fn.launches_f32 += path == "f32"


def _on_card(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: a cpu or cuda tensor, got {x.device}")


def _dot(x, w, gs):
    _dot_checks(x, w, gs)
    if x.device.type == "cpu":
        return plain_grouped_dot(x, w, gs)
    _on_card(x, "grouped_dot")
    y, path = _launch_dot(x, w, gs)
    _count(grouped_dot, path)
    if path is not None and w.stride(2) != 1:
        grouped_dot.launches_wt += 1
    return y


def _outer_checks(x, g, gs):
    if x.dim() != 2 or g.dim() != 2 or gs.dim() != 1 \
            or x.shape[0] != g.shape[0]:
        raise ValueError(f"grouped_outer shapes: x{tuple(x.shape)} "
                         f"g{tuple(g.shape)} gs{tuple(gs.shape)}")


def _outer(x, g, gs):
    _outer_checks(x, g, gs)
    if x.device.type == "cpu":
        return plain_grouped_outer(x, g, gs)
    _on_card(x, "grouped_outer")
    out, path = _launch_outer(x, g, gs)
    _count(grouped_outer, path)
    return out


def grouped_dot_ref(x: torch.Tensor, w: torch.Tensor,
                    gs: torch.Tensor) -> torch.Tensor:
    """B8's first kernel on the card, any view: in bf16 (``mma.sync``) the
    TMA path's oracle, in f32 (R1's chains, one shared stage) the ring
    kernels'. Not counted; no autograd. A CUDA tensor only."""
    _dot_checks(x, w, gs)
    _on_card(x, "grouped_dot_ref")
    return _launch_dot(x, w, gs, ref=True)[0]


def grouped_outer_ref(x: torch.Tensor, g: torch.Tensor,
                      gs: torch.Tensor) -> torch.Tensor:
    """B8's first outer kernel on the card, the oracle of the TMA path
    (bf16) and of the ring kernel (f32). Not counted; no autograd. A CUDA
    tensor only."""
    _outer_checks(x, g, gs)
    _on_card(x, "grouped_outer_ref")
    return _launch_outer(x, g, gs, ref=True)[0]


class _GroupedDot(torch.autograd.Function):
    # y = dot(x, w): ct_x = dot(ct, wᵀ), ct_w = outer(x, ct)

    @staticmethod
    def forward(ctx, x, w, gs):
        ctx.save_for_backward(x, w, gs)
        return _dot(x, w, gs)

    @staticmethod
    def backward(ctx, ct):
        x, w, gs = ctx.saved_tensors
        ct_x = ct_w = None
        if ctx.needs_input_grad[0]:
            ct_x = grouped_dot(ct, w.transpose(1, 2), gs)
        if ctx.needs_input_grad[1]:
            ct_w = grouped_outer(x, ct, gs)
        return ct_x, ct_w, None


class _GroupedOuter(torch.autograd.Function):
    # o = outer(x, g): ct_x = dot(g, o_ctᵀ), ct_g = dot(x, o_ct)

    @staticmethod
    def forward(ctx, x, g, gs):
        ctx.save_for_backward(x, g, gs)
        return _outer(x, g, gs)

    @staticmethod
    def backward(ctx, ct):
        x, g, gs = ctx.saved_tensors
        ct_x = ct_g = None
        if ctx.needs_input_grad[0]:
            ct_x = grouped_dot(g, ct.transpose(1, 2), gs)
        if ctx.needs_input_grad[1]:
            ct_g = grouped_dot(x, ct, gs)
        return ct_x, ct_g, None


def grouped_dot(x: torch.Tensor, w: torch.Tensor,
                gs: torch.Tensor) -> torch.Tensor:
    """``y[r] = x[r] @ w[e(r)]``: x ``[R, C]``, w ``[E, C, H]`` (any
    strides: a transposed view is read as it lies), gs ``[E]`` int on x's
    device → ``[R, H]`` in x's dtype (f32 or bf16), rows past ``sum(gs)``
    zeros. Differentiable in x and w. One launch of B8 on the card."""
    return _GroupedDot.apply(x, w, gs)


def grouped_outer(x: torch.Tensor, g: torch.Tensor,
                  gs: torch.Tensor) -> torch.Tensor:
    """``out[e] = x_eᵀ @ g_e`` over the rows of group e: x ``[R, C]``, g
    ``[R, H]``, gs ``[E]`` → ``[E, C, H]`` in x's dtype, zeros for an empty
    group. Differentiable in x and g. One launch of B8's outer kernel on
    the card."""
    return _GroupedOuter.apply(x, g, gs)


def reset_launch_counts() -> None:
    for fn in (grouped_dot, grouped_outer):
        fn.launches = 0
        fn.launches_f32 = 0
        fn.launches_ref = 0
    grouped_dot.launches_wt = 0


reset_launch_counts()
