"""T1 bits on its main path: ``QuantizeCodec``'s per-tile max-abs quantize
with threefry stochastic rounding, a hand-written CUDA kernel
(``csrc/quantize_tiles.cu``) with its plain PyTorch version.

Counterpart of ``gym_tpu/strategy/compress.py:112-126``
(``QuantizeCodec.compress``) as the strategies run it: inside the jitted
step, where XLA fuses ``jax.random.uniform``'s threefry into the rounding
and compiles ``amax / qmax`` into ``amax * f32(1 / qmax)``. For x ``[R,
n]`` f32 and ``t = ceil(n / tile)`` tiles a row (zero-filled past n):

- ``scale = amax · f32(1/qmax)`` over each tile, 1 where ``amax > 0``
  fails (NaN amax included: the max propagates NaN);
- ``q = clamp(floor(x / scale + u), ±qmax)``, u the ``[t, tile]`` uniform of
  the row's key (the counter the flat index in the row), or ``round(x /
  scale)`` half to even; NaN to 0; int8.

Returns ``(q [R, t, tile] int8, scale [R, t, 1] f32)``. ``keys`` is one
threefry key shared by every row (DynamiQ's hop keys: each row rounds
with the same noise) or one key a row (the links' per-node keys).

``quantize_tiles`` launches the kernel for a CUDA tensor (or raises: no
fallback) and runs ``plain_quantize_tiles`` for a CPU one;
``quantize_tiles.launches`` counts the kernel's launches. The kernel draws a
key's bits where it rounds with them; a key shared by more than one row has
them drawn once by the first bits kernel (``threefry.random_bits``, counted
there), and the kernel reads them for every row: at DynamiQ's hop 1 on the
flagship that takes about half the time of drawing them in each of the 16
rows, which costs what 16 keys a row cost (``chip_smoke.py`` phase 7). On
the card, ``quantize_tiles_ref`` (the first bits kernel's uniform, then the
plain quantize) is the oracle the kernel equals bit for bit; card only and
uncounted.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Union

import numpy as np
import torch

from . import threefry

Keys = Union[threefry.Key, Sequence[threefry.Key], None]


def inv_qmax(qmax: int) -> float:
    """``f32(1 / qmax)``: the constant XLA multiplies ``amax`` by."""
    return float(np.float32(1.0) / np.float32(qmax))


def key_rows(keys: Keys, rows: int) -> np.ndarray:
    """One key shared by every row → a [1, 2] uint32 table; a key a row →
    [rows, 2]."""
    if keys is None:
        raise ValueError("a stochastic codec needs a key")
    if isinstance(keys, tuple) and len(keys) == 2 and isinstance(keys[0],
                                                                  int):
        return threefry.key_table([keys])
    table = threefry.key_table(list(keys))
    if table.shape[0] != rows:
        raise ValueError(f"{table.shape[0]} keys for {rows} rows")
    return table


def _tiles(x: torch.Tensor, tile: int) -> torch.Tensor:
    """x [R, n] → [R, t, tile] f32, zero-filled past n."""
    rows, n = x.shape
    t = -(-n // tile)
    xt = torch.nn.functional.pad(x.float(), (0, t * tile - n))
    return xt.view(rows, t, tile)


def quantize_with(xt: torch.Tensor, u, qmax: int):
    """The plain quantize of tiles ``xt`` [R, t, tile] with the uniforms
    ``u`` ([R or 1, t·tile] f32; None rounds half to even): each step the
    kernel's, elementwise or a max over a tile."""
    amax = xt.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0,
                        amax * torch.full_like(amax, inv_qmax(qmax)),
                        torch.ones_like(amax))
    y = xt / scale
    if u is None:
        r = torch.round(y)
    else:
        r = torch.floor(y + u.view(-1, *xt.shape[1:]))
    r = torch.nan_to_num(torch.clamp(r, -qmax, qmax), nan=0.0)
    return r.to(torch.int8), scale


def _uniform_rows(table: np.ndarray, n: int, device, draw) -> torch.Tensor:
    """[Rk, n]: row k the uniform of key k, each drawn by ``draw(key, n,
    device)``."""
    return torch.stack([draw((int(k0), int(k1)), n, device)
                        for k0, k1 in table])


def _plain_uniform(key, n, device):
    return threefry.bits_to_uniform(threefry.plain_random_bits(key, n,
                                                               device))


def plain_quantize_tiles(x: torch.Tensor, keys: Keys, qmax: int, tile: int,
                         stochastic: bool = True):
    """The plain version, on x's device: the uniforms from the threefry
    twin."""
    xt = _tiles(x, tile)
    u = None
    if stochastic:
        u = _uniform_rows(key_rows(keys, x.shape[0]),
                          xt.shape[1] * tile, x.device, _plain_uniform)
    return quantize_with(xt, u, qmax)


def _check(x: torch.Tensor, qmax: int, tile: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [R, n], got {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {x.device}")
    if qmax not in (7, 127) or tile < 1:
        raise ValueError(f"qmax must be 7 or 127 and tile >= 1, got {qmax}, "
                         f"{tile}")


def _launch(x: torch.Tensor, keys: Keys, qmax: int, tile: int,
            stochastic: bool):
    """One launch of ``gym_quantize_tiles`` (after the first kernel's draw,
    for a key shared by several rows) into fresh tensors."""
    x = x.float().contiguous()
    rows, n = x.shape
    t = -(-n // tile)
    dev = x.device
    q = torch.empty(rows, t, tile, dtype=torch.int8, device=dev)
    scale = torch.empty(rows, t, 1, dtype=torch.float32, device=dev)
    table = key_rows(keys, rows) if stochastic else None
    if rows * t == 0:
        return q, scale
    if rows > 2 ** 31 - 1 or t * tile >= 2 ** 62:
        raise ValueError(f"[{rows}, {n}] too large")
    key_t = bits = None
    if table is not None and table.shape[0] < rows:
        bits = threefry.random_bits((int(table[0, 0]), int(table[0, 1])),
                                    t * tile, dev)
    elif table is not None:
        key_t = torch.from_numpy(table.view(np.int32)).pin_memory().to(
            dev, non_blocking=True)
    from . import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.gym_quantize_tiles(
            x.data_ptr(), n, rows, tile,
            None if key_t is None else key_t.data_ptr(),
            None if bits is None else bits.data_ptr(), int(stochastic),
            float(qmax), inv_qmax(qmax), q.data_ptr(), scale.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, code, "gym_quantize_tiles")
    return q, scale


def quantize_tiles(x: torch.Tensor, keys: Keys, qmax: int, tile: int,
                   stochastic: bool = True):
    """``QuantizeCodec.compress``: x ``[R, n]`` → ``(q, scale)``; on the
    card one launch of the kernel, on the CPU the plain version."""
    _check(x, qmax, tile)
    if x.device.type == "cpu":
        return plain_quantize_tiles(x, keys, qmax, tile, stochastic)
    out = _launch(x, keys, qmax, tile, stochastic)
    if x.shape[0] and x.shape[1]:
        quantize_tiles.launches += 1
    return out


def _on_card(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: device must be cuda, got {x.device}")


def quantize_tiles_ref(x: torch.Tensor, keys: Keys, qmax: int, tile: int,
                       stochastic: bool = True):
    """The oracle on the card: the first bits kernel's uniform of each key
    (``threefry.uniform_ref``), then the plain quantize. Never on the main
    path; not counted. A CUDA tensor only."""
    _check(x, qmax, tile)
    _on_card(x, "quantize_tiles_ref")
    xt = _tiles(x, tile)
    u = None
    if stochastic:
        u = _uniform_rows(key_rows(keys, x.shape[0]), xt.shape[1] * tile,
                          x.device, threefry.uniform_ref)
    return quantize_with(xt, u, qmax)


quantize_tiles.launches = 0


def reset_launch_counts() -> None:
    quantize_tiles.launches = 0
