"""Per-chunk top-k selection and the duplicate-aware decode weights
(counterpart of ``gym_tpu/ops/topk_compress.py``).

``topk_compress`` selects exactly what the JAX package selects, in its
order (the pick order that D1 sums in):

- packed path (f32, chunks of ≤ 2¹⁶ elements, DeMo's ``[chunks, 4096]``):
  the chunk-local index goes into the low ``nbits`` bits of |value|'s bit
  pattern, clamped to the largest finite pattern so that Inf and NaN rank
  first, and the int32 keys are ranked with ``torch.topk``. The keys are
  unique and non-negative, so the set and its descending order equal XLA's
  ``approx_max_k(recall_target=1.0)``. Magnitudes that agree above the low
  ``nbits`` bits tie, and the tie goes to the higher index, as in JAX. One
  exception: a key whose float is denormal (|value| < 2⁻¹²⁶, zeros
  included) compares as 0.0 in XLA on the CPU, so such keys tie there and
  XLA's sort orders them its own way; the port orders them by index. Those
  picks carry values of (nearly) 0;
- paired path (other dtypes, larger chunks: ``TopKCodec`` over a flat
  model): ``lax.top_k(|c|)`` breaks ties toward the lower index, which
  ``torch.topk`` leaves unspecified on the card; the 64-bit key ``(|c|
  bits) << 32 | (n − 1 − i)`` reproduces JAX's order.

``scatter_mean_decode`` is D1 (``ops/scatter_mean.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .scatter_mean import scatter_mean_decode  # noqa: F401  (re-export)


def topk_compress(c: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``c`` ``[..., n]`` → (idx int32, val) each ``[..., k']``, k clamped
    to ``[1, n]``."""
    n = c.shape[-1]
    k = max(1, min(int(k), n))
    nbits = max(1, (n - 1).bit_length())
    if c.dtype == torch.float32 and nbits <= 16:
        mask = (1 << nbits) - 1
        bits = c.view(torch.int32) & 0x7FFFFFFF
        bits = torch.clamp(bits, max=0x7F7FFFFF)
        iota = torch.arange(n, dtype=torch.int32, device=c.device)
        keys = (bits & ~mask) | iota
        kv = torch.topk(keys, k, dim=-1).values
        idx = kv & mask
    else:
        mag = c.abs().float().view(torch.int32).long()
        rank = (n - 1) - torch.arange(n, dtype=torch.int64, device=c.device)
        pos = torch.topk((mag << 32) | rank, k, dim=-1).values & 0xFFFFFFFF
        idx = ((n - 1) - pos).to(torch.int32)
    val = torch.gather(c, -1, idx.long())
    return idx, val


def mean_weights(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Per-pick weights w with Σ_{duplicates of a slot} w == mean of the
    slot's values: w[g,u] = (Σ_v [idx_v == idx_u]·val_v) / cnt_u². The
    duplicate-masked sum runs before the basis product
    (``dct.sparse_decode_chunks``), so exact cancellations stay exactly
    zero. O(G·m²): for modest m (≤ 128 picks a chunk)."""
    eq = (idx.unsqueeze(-1) == idx.unsqueeze(-2)).to(val.dtype)
    cnt = eq.sum(dim=-1)
    sums = torch.matmul(eq, val.unsqueeze(-1)).squeeze(-1)
    return sums / (cnt * cnt)
