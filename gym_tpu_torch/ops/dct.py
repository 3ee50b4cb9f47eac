"""Chunked 2-D DCT for DeMo's gradient compression (counterpart of
``gym_tpu/ops/dct.py``).

The DCT is a product with precomputed orthonormal DCT-II bases, built from
the same numpy closed form as the JAX package's (the f32 matrices are
byte-equal). A tensor is viewed as 2-D ``(A, B) = (prod(shape[:-1]),
shape[-1])`` and both axes are tiled by the largest divisor ≤
``target_chunk``; 1-D tensors tile only the last axis. The shapes are the
per-node parameter shapes in flax's layouts (dense ``[in, out]``, conv
HWIO), which the port keeps: a torch ``[out, in]`` view would tile the
other axes. The batched products go to ``torch.matmul`` (cuBLAS on the
card), as the JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _divisors(n: int) -> list:
    out = [d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0]
    return sorted(set(out + [n // d for d in out]))


def largest_divisor_at_most(n: int, target: int) -> int:
    """Largest divisor of n that is ≤ target."""
    best = 1
    for d in _divisors(n):
        if d <= target:
            best = d
        else:
            break
    return best


@functools.lru_cache(maxsize=64)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D with D[k, m] = s_k · cos(π(2m+1)k / 2n),
    s_0 = √(1/n), s_k = √(2/n): DCT(v) = D @ v, IDCT(v) = Dᵀ @ v. One entry
    a chunk-divisor size (bounded: the n = target_chunk matrix is MBs)."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=1024)
def chunk_shape_for(shape: tuple, target_chunk: int) -> tuple:
    """(rows_chunk, cols_chunk) tile sizes for a tensor of ``shape``."""
    if len(shape) == 0:
        return (1, 1)
    cols = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    b = largest_divisor_at_most(int(shape[-1]), target_chunk)
    a = largest_divisor_at_most(cols, target_chunk) if cols > 1 else 1
    return (a, b)


@functools.lru_cache(maxsize=64)
def _basis(n: int, device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(dct_matrix(n)).to(device, dtype)


def basis(n: int, device, dtype=torch.float32) -> torch.Tensor:
    """``dct_matrix(n)`` as a tensor on ``device``, cached (bounded: a
    model has a handful of chunk sizes). Read-only."""
    return _basis(n, str(torch.device(device)), dtype)


class ChunkedDCT:
    """Per-tensor tiling: the tensor in its natural shape ↔ its tiles
    ``[..., n_chunks, a, b]`` (leading dims, e.g. the K nodes, carried).
    The DCT runs on tiles pooled from many tensors (``encode_chunks``)."""

    def __init__(self, shape: tuple, target_chunk: int):
        self.shape = tuple(shape) or (1,)  # scalars as 1-element vectors
        self.a, self.b = chunk_shape_for(self.shape, target_chunk)
        rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        cols = int(shape[-1]) if len(shape) >= 1 else 1
        self.ya, self.xb = rows // self.a, cols // self.b
        self.n_chunks = self.ya * self.xb
        self.chunk_elems = self.a * self.b

    def to_chunks(self, x: torch.Tensor) -> torch.Tensor:
        """``[*lead, *shape]`` → ``[*lead, n_chunks, a, b]`` (data
        movement only)."""
        lead = x.shape[:x.dim() - len(self.shape)]
        x = x.reshape(*lead, self.ya, self.a, self.xb, self.b)
        return x.transpose(-3, -2).reshape(*lead, self.n_chunks, self.a,
                                            self.b)

    def from_chunks(self, c: torch.Tensor) -> torch.Tensor:
        """Inverse of ``to_chunks``: ``[*lead, n_chunks, a, b]`` →
        ``[*lead, *shape]``."""
        lead = c.shape[:-3]
        c = c.reshape(*lead, self.ya, self.xb, self.a, self.b)
        return c.transpose(-3, -2).reshape(*lead, *self.shape)


def encode_chunks(chunks: torch.Tensor, d_a: torch.Tensor,
                  d_b: torch.Tensor) -> torch.Tensor:
    """Batched 2-D DCT: ``[G, a, b]`` tiles → ``[G, a·b]`` coefficients,
    ``D_a x D_bᵀ`` a tile."""
    c = torch.matmul(torch.matmul(d_a, chunks), d_b.T)
    return c.reshape(chunks.shape[0], -1)


def decode_chunks(c: torch.Tensor, d_a: torch.Tensor,
                  d_b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``encode_chunks``: ``[G, a·b]`` → ``[G, a, b]`` tiles,
    ``D_aᵀ c D_b`` a tile."""
    cc = c.reshape(c.shape[0], d_a.shape[0], d_b.shape[0])
    return torch.matmul(torch.matmul(d_a.T, cc), d_b)


def sparse_decode_chunks(idx: torch.Tensor, w: torch.Tensor,
                         d_a: torch.Tensor, d_b: torch.Tensor
                         ) -> torch.Tensor:
    """Decode m sparse picks a tile straight to ``[G, a, b]``: x[g] = Σ_u
    w[g,u] · D_a[i_u]ᵀ ⊗ D_b[j_u] with (i, j) = divmod(idx, b), a batched
    ``[a, m] × [m, b]`` product of the basis rows the picks name. For
    duplicated indices pass ``topk_compress.mean_weights`` (the slot mean);
    plain values are right only where the indices are unique."""
    b = d_b.shape[0]
    idx = idx.long()
    ra = d_a[idx // b]                          # [G, m, a]
    rb = d_b[idx % b]                           # [G, m, b]
    return torch.matmul((w.unsqueeze(-1) * ra).transpose(-1, -2), rb)


@functools.lru_cache(maxsize=256)
def codec_for(shape: tuple, target_chunk: int) -> ChunkedDCT:
    """One tiling a (param shape × chunk), bounded."""
    return ChunkedDCT(shape, target_chunk)
