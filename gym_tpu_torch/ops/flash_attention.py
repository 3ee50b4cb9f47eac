"""Fused attention dispatch (counterpart of ``gym_tpu/ops/flash_attention.py``).

On the card, shapes the fused whole-context kernels take go to them
(``ops/fused_attention.py``); on the CPU, and for shapes ``_flash_ok``
rejects or with active dropout, attention is dense, as in the JAX package
off the TPU. Contexts longer than 1024 need the tiled long-context kernel
(TPU kernel B5), which the port does not have yet: on the card they raise
rather than fall back silently to dense.

Inputs carry any number of leading node dimensions before the batch
(``[..., B, H, T, D]`` or ``[..., B, T, C]``). The eligibility gates see the
per-node shape, as the JAX package's gates do under ``vmap``; the kernels
then see the node axis folded into the batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import dense_causal_attention


def _flash_ok(q: torch.Tensor) -> bool:
    t, d = q.shape[-2], q.shape[-1]
    return t >= 128 and t % 128 == 0 and d <= 256


def _per_node(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """The first node's slice: the shape the gates are written for."""
    return x[(0,) * (x.dim() - ndim)]


def flash_causal_attention(
    q: torch.Tensor,  # [..., B, H, T, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    use_dropout = dropout_rate > 0.0 and not deterministic
    if not q.is_cuda or use_dropout or not _flash_ok(q):
        return dense_causal_attention(
            q, k, v, dropout_rate=dropout_rate, generator=generator,
            deterministic=deterministic)
    from .fused_attention import fused_causal_attention, fused_supported
    if not fused_supported(_per_node(q, 4)):
        raise NotImplementedError(
            f"causal attention at T={q.shape[-2]} > 1024 needs the tiled "
            f"long-context kernel (TPU kernel B5), not yet ported to "
            f"gym_tpu_torch")
    h, t, d = q.shape[-3:]

    def fold(x):
        return x.reshape(-1, h, t, d)

    return fused_causal_attention(fold(q), fold(k), fold(v)).reshape(q.shape)


def packed_flash_attention_or_none(q, k, v, n_head: int):
    """Packed-layout fast path: q, k, v [..., B, T, C] → [..., B, T, C] with
    no head transposes, through the packed kernels. Returns None when they
    are not eligible (off the card, or the per-node shape fails
    ``packed_supported``), so that the caller takes the [B, H, T, D] path.
    The one dispatch point for packed eligibility."""
    from .fused_attention import (fused_causal_attention_packed,
                                  packed_supported)
    if not q.is_cuda or not packed_supported(_per_node(q, 3), n_head):
        return None
    t, c = q.shape[-2:]

    def fold(x):
        return x.reshape(-1, t, c)

    return fused_causal_attention_packed(
        fold(q), fold(k), fold(v), n_head).reshape(q.shape)
