"""Attention ops behind a single interface (counterpart of
``gym_tpu/ops/attention.py``).

- ``dense_causal_attention``: the reference implementation, softmax in f32
  with the score mask at ``finfo(float32).min``.
- ``flash_causal_attention`` (``ops/flash_attention.py``): the fused
  whole-context kernels on the card.
- ring (context-parallel) attention belongs to a later slice of the port.

Every function takes ``[..., B, H, T, D]``: leading dimensions (the
simulated-node axis) are batch dimensions. Attention dropout takes
``[K, B, H, T, D]`` and ``dropout_rng``, the K nodes' keys (a ``[K, 2]``
threefry key table): node k's mask is ``jax.random.bernoulli(keys[k], keep,
[B, H, T, T])``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import threefry


def dense_causal_attention(
    q: torch.Tensor,  # [..., H, T, D]
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    dropout_rate: float = 0.0,
    dropout_rng: Optional[np.ndarray] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Causal softmax(QKᵀ/√d)V with f32 scores and softmax."""
    t = q.shape[-2]
    # 1/√d rounded as the JAX package rounds it: a float32 sqrt and divide
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(causal, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and not deterministic:
        n = probs[0].numel()
        keep = threefry.bernoulli_rows(dropout_rng, 1.0 - dropout_rate, n,
                                       probs.device).view(probs.shape)
        probs = probs * keep / (1.0 - dropout_rate)
    probs = probs.to(v.dtype)
    return torch.matmul(probs, v)


def causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "dense",
    seq_axis: Optional[str] = None,
    seq_layout: str = "contiguous",
    dropout_rate: float = 0.0,
    dropout_rng: Optional[np.ndarray] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Dispatch: ``'dense'`` (reference behaviour), ``'flash'`` (the fused
    kernels on the card, dense on the CPU). ``'ring'`` is context-parallel
    attention, which the port does not have yet."""
    if impl == "ring":
        raise NotImplementedError(
            "ring attention (context parallelism) is ported in a later slice "
            "of gym_tpu_torch (ROADMAP Queue A, Slice 5)")
    if seq_axis is not None:
        raise NotImplementedError(
            "seq_axis (context parallelism) is ported in a later slice")
    if impl == "flash":
        from .flash_attention import flash_causal_attention
        return flash_causal_attention(
            q, k, v, dropout_rate=dropout_rate, dropout_rng=dropout_rng,
            deterministic=deterministic)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}; expected "
                         f"ring/flash/dense")
    return dense_causal_attention(
        q, k, v, dropout_rate=dropout_rate, dropout_rng=dropout_rng,
        deterministic=deterministic)
