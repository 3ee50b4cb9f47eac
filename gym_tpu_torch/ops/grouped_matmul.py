"""Quantized matmuls of the serving path (counterpart of the quantization
half of ``gym_tpu/ops/grouped_matmul.py``).

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

The grouped matmuls of the same JAX module (``grouped_dot`` and
``grouped_outer``, the MoE kernels B8) are ported with the MoE layers
(ROADMAP item 16).
"""

from __future__ import annotations

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
