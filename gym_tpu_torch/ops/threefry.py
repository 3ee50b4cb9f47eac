"""JAX's threefry PRNG, bit for bit: the host-side key algebra in Python ints
and the device functions as a hand-written CUDA kernel with its plain
PyTorch twin.

Counterpart of ``jax.random`` as the JAX package uses it (jax 0.9.0,
``jax_threefry_partitionable`` on): every random choice of the stochastic
strategies (SPARTA's masks, FedAvg's island shuffle, the failure draws)
comes from a shared threefry key, so the port reproduces the same bits to be
held to ``gym_tpu``'s losses. ``torch.rand`` is Philox, a different function.

Keys are pairs of uint32 held as Python ints:

- ``PRNGKey(seed)`` = ``(seed >> 32, seed & 0xFFFFFFFF)`` (of the seed as
  jax stores it: a 32-bit int without x64);
- ``fold_in(key, d)`` = ``threefry2x32(key, (0, d))``;
- ``split(key, n)[i]`` = ``threefry2x32(key, (0, i))`` (the fold-like split).

Device functions take an explicit ``device``; element i of ``random_bits``
is ``b0 ^ b1`` of ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))`` over the
row-major flat index. ``uniform`` is ``bitcast_f32((bits >> 9) |
0x3F800000) − 1``, ``bernoulli`` is ``uniform < float32(p)``, and
``permutation`` is ``ceil(3·ln n / ln(2³²−1))`` rounds of a stable sort by
fresh bits, each round's key split off the last.

``random_bits``, ``bernoulli``, ``bernoulli_rows`` and ``bernoulli_segments``
dispatch on the device: on the card they launch ``csrc/threefry.cu``
(``gym_threefry_bits``; the masks all through ``gym_bernoulli_segments``,
one launch for a table of keys, each with its own length and place in the
output) or raise; on the CPU they run the plain twin, threefry in int64
tensors masked to 32 bits. ``launches`` on each counts its kernel
launches. Bits are returned as int32 tensors holding the uint32 pattern
(PyTorch has no usable uint32 arithmetic).

``random_bits_rows`` draws R rows of bits, row r under ``fold_in(keys[r],
data[r])`` with the keys and data on the device (one launch of
``gym_threefry_bits_rows``): the serving sampler's ``categorical``, the
argmax of logits plus ``jax.random.gumbel``'s noise. Its kernel is the
rows' second design (every warp folds its own row's key, several groups a
lane); ``random_bits_rows_ref`` runs the first kernel, kept as its oracle
on the card, and ``random_bits_rows_tuned`` the kernel at another launch
plan, for a sweep (``scripts/d1_t1_sweep.py``); both card only and
uncounted.

flax derives a module's dropout key from the step key with
``fold_in_static``: the SHA-1 of the module path and the scope's call
counter, folded in (``flax/core/scope.py`` ``_fold_in_static``, flax 0.12.3,
``flax_fix_rng_separator`` off). The K simulated nodes each hold a key, so
the key algebra also runs on key tables, ``[R, 2]`` numpy uint32 arrays
(``fold_in_rows``), and ``bernoulli_rows`` draws one mask a row in one
launch; SPARTA draws one mask a leaf, all in one ``bernoulli_segments``
launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
from typing import Tuple

import numpy as np
import torch

Key = Tuple[int, int]
M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


# -- host key algebra (Python ints) ------------------------------------------


def _rotl(x, r):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key: Key, count):
    """threefry2x32 (20 rounds) of one counter pair under ``key``. The
    words may be Python ints, int64 tensors holding uint32 values (the
    plain twin) or uint32 arrays (key tables); the result has their type."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (count[0] + k0) & M32
    x1 = (count[1] + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: without x64 the seed is a 32-bit int,
    so the high word is 0 and the low word its bit pattern."""
    return (0, int(seed) & M32)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key, (0, int(data) & M32))


def split(key: Key, num: int = 2):
    return [threefry2x32(key, (0, i)) for i in range(num)]


@functools.lru_cache(maxsize=None)
def static_hash(parts: Tuple) -> int:
    """flax's fold value of a path: the big-endian first 4 bytes of the SHA-1
    of its parts, strings as UTF-8 and ints as their minimal big-endian
    bytes, with no separator. Cached: a model has a fixed set of paths."""
    m = hashlib.sha1()
    for x in parts:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
        else:
            raise TypeError(f"expected int or str, got {x!r}")
    return int.from_bytes(m.digest()[:4], "big")


def fold_in_static(key, *parts):
    """flax's ``_fold_in_static(key, parts)``: a module's key from its
    path and call counter, e.g. ``fold_in_static(k, "CNN_0", "Dropout_0",
    1)``. ``key`` is a Key or a key table (``fold_in_rows``)."""
    if not parts:
        return key
    h = static_hash(tuple(parts))
    if isinstance(key, np.ndarray):
        return fold_in_rows(key, h)
    return fold_in(key, h)


# -- key tables: [R, 2] uint32 arrays ---------------------------------------


def key_table(keys) -> np.ndarray:
    """Keys (a Key, a sequence of them or a table) as an [R, 2] table."""
    return np.asarray(keys, dtype=np.uint32).reshape(-1, 2)


def fold_in_rows(keys: np.ndarray, data) -> np.ndarray:
    """``fold_in`` of every row of a key table, vectorised over the rows;
    ``data`` an int or one int a row. ``threefry2x32``'s arithmetic runs
    unchanged on uint32 arrays."""
    keys = key_table(keys)
    count = (0, np.asarray(data, dtype=np.int64).astype(np.uint32))
    return np.stack(threefry2x32((keys[:, 0], keys[:, 1]), count), axis=1)


def fold_in_paths(keys: np.ndarray, paths) -> list:
    """``[fold_in_static(keys, *path) for path in paths]`` in one fold over
    all of them: a model's dropout keys for one microbatch."""
    keys = key_table(keys)
    r = keys.shape[0]
    data = np.repeat([static_hash(tuple(p)) for p in paths], r)
    out = fold_in_rows(np.tile(keys, (len(paths), 1)), data)
    return [out[i * r:(i + 1) * r] for i in range(len(paths))]


def node_keys(seed: int, num_nodes: int) -> np.ndarray:
    """Node i's key ``fold_in(PRNGKey(seed), i + 1)``, for the K nodes: the
    per-node stream of the JAX package's ``TrainState.rng``."""
    base = key_table([PRNGKey(seed)] * num_nodes)
    return fold_in_rows(base, np.arange(1, num_nodes + 1))


# -- plain twin (int64 tensors masked to 32 bits) ----------------------------


def _signed32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values in int64 → the same bit pattern as int32."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def plain_bits_at(key: Key, idx: torch.Tensor) -> torch.Tensor:
    """The bits of the elements at flat indices ``idx`` (int64), as int32
    bit patterns."""
    b0, b1 = threefry2x32(key, (idx >> 32, idx & M32))
    return _signed32(b0 ^ b1)


def plain_random_bits(key: Key, n: int, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` as int32 bit patterns, in plain
    PyTorch on ``device``."""
    return plain_bits_at(key, torch.arange(n, dtype=torch.int64,
                                            device=device))


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) floats from int32 bit patterns: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1 (exact)."""
    mant = (bits >> 9) & 0x7FFFFF  # arithmetic shift: mask the sign fill
    return (mant | 0x3F800000).view(torch.float32) - 1.0


def plain_bernoulli(key: Key, p: float, n: int, device="cpu"):
    return bits_to_uniform(plain_random_bits(key, n, device)) < _f32(p)


def plain_bernoulli_rows(keys, p: float, n: int, device="cpu"):
    """[R, n] bool: row r is ``plain_bernoulli(keys[r], p, n)``."""
    rows = [plain_bernoulli((int(k0), int(k1)), p, n, device)
            for k0, k1 in key_table(keys)]
    if not rows:
        return torch.empty(0, n, dtype=torch.bool, device=device)
    return torch.stack(rows)


def plain_bernoulli_segments(keys, p: float, sizes, device="cpu"):
    """[plain_bernoulli(keys[s], p, sizes[s]) for each segment s]."""
    return [plain_bernoulli((int(k0), int(k1)), p, int(n), device)
            for (k0, k1), n in zip(key_table(keys), sizes)]


def _f32(p: float) -> torch.Tensor:
    return torch.tensor(p, dtype=torch.float32)


# -- kernel launches ---------------------------------------------------------


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_n(n: int, device) -> torch.device:
    device = torch.device(device)
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return device


def _draw_bits(key: Key, n: int, device: torch.device) -> torch.Tensor:
    """One launch of ``gym_threefry_bits`` into a fresh [n] int32 tensor
    (none for n = 0), uncounted."""
    from . import _build
    lib = _build.load()
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        with torch.cuda.device(device):
            code = lib.gym_threefry_bits(key[0], key[1], n, out.data_ptr(),
                                         _stream(device))
        _build.check(lib, code, "gym_threefry_bits")
    return out


def random_bits(key: Key, n: int, device) -> torch.Tensor:
    """[n] int32: ``jax.random.bits(key, (n,))``'s uint32 bit patterns."""
    device = _check_n(n, device)
    if device.type == "cpu":
        return plain_random_bits(key, n, device)
    out = _draw_bits(key, n, device)
    if n:
        random_bits.launches += 1
    return out


# segments a launch: the kernel keeps their table in shared memory
MAX_SEGMENTS = 1536


def _draw_segments(keys: np.ndarray, p: float, sizes, offsets,
                   out: torch.Tensor) -> None:
    """One launch of ``gym_bernoulli_segments``: the mask of ``keys[s]``
    over ``sizes[s]`` elements into ``out``'s bytes from ``offsets[s]``.
    The segment table goes to the card from pinned memory without blocking
    the host."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if len(sizes) > MAX_SEGMENTS:
        raise ValueError(f"{len(sizes)} segments: at most {MAX_SEGMENTS} a "
                         f"launch")
    groups = (sizes + 3) // 4
    if not groups.sum():
        return
    first = np.concatenate([[0], np.cumsum(groups)[:-1]])
    key = keys[:, 0].astype(np.int64) | (keys[:, 1].astype(np.int64) << 32)
    table = np.stack([first, key, sizes,
                      np.asarray(offsets, dtype=np.int64)])
    from . import _build
    lib = _build.load()
    dev = out.device
    table = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        code = lib.gym_bernoulli_segments(
            table.data_ptr(), len(sizes), int(groups.sum()), float(p),
            out.data_ptr(), _stream(dev))
    _build.check(lib, code, "gym_bernoulli_segments")


def bernoulli(key: Key, p: float, n: int, device) -> torch.Tensor:
    """[n] bool: ``jax.random.bernoulli(key, p, (n,))``; on the card one
    fused pass (bits, uniform, compare) writing one byte an element."""
    device = _check_n(n, device)
    if device.type == "cpu":
        return plain_bernoulli(key, p, n, device)
    out = torch.empty(n, dtype=torch.bool, device=device)
    if n:
        _draw_segments(key_table([key]), p, [n], [0], out)
        bernoulli.launches += 1
    return out


def bernoulli_rows(keys, p: float, n: int, device) -> torch.Tensor:
    """[R, n] bool: row r is ``jax.random.bernoulli(keys[r], p, (n,))``, the
    R rows of a key table in one launch on the card (R segments of n)."""
    device = _check_n(n, device)
    keys = key_table(keys)
    if device.type == "cpu":
        return plain_bernoulli_rows(keys, p, n, device)
    rows = keys.shape[0]
    out = torch.empty(rows, n, dtype=torch.bool, device=device)
    if rows and n:
        _draw_segments(keys, p, [n] * rows, np.arange(rows) * n, out)
        bernoulli_rows.launches += 1
    return out


def bernoulli_segments(keys, p: float, sizes, device):
    """Segment s is ``jax.random.bernoulli(keys[s], p, (sizes[s],))``, all
    in one launch on the card → (one flat bool buffer, [a view of it per
    segment]). Each segment starts 16-byte aligned in the buffer; the
    bytes between segments are not written."""
    keys = key_table(keys)
    sizes = [int(n) for n in sizes]
    for n in sizes:
        _check_n(n, device)
    device = torch.device(device)
    if keys.shape[0] != len(sizes):
        raise ValueError(f"{keys.shape[0]} keys for {len(sizes)} segments")
    offsets = np.concatenate([[0], np.cumsum([(n + 15) // 16 * 16
                                              for n in sizes])])
    out = torch.empty(int(offsets[-1]), dtype=torch.bool, device=device)
    views = [out[a:a + n] for a, n in zip(offsets.tolist(), sizes)]
    if device.type == "cpu":
        for view, mask in zip(views, plain_bernoulli_segments(keys, p, sizes,
                                                               device)):
            view.copy_(mask)
    elif sum(sizes):
        _draw_segments(keys, p, sizes, offsets[:-1], out)
        bernoulli_segments.launches += 1
    return out, views


def key_tensor(keys, device) -> torch.Tensor:
    """A key table ([R, 2] uint32, or keys) as the int32 tensor the rows
    entry reads: the same bit patterns."""
    return torch.from_numpy(key_table(keys).view(np.int32).copy()).to(device)


def plain_random_bits_rows(keys: torch.Tensor, data, n: int) -> torch.Tensor:
    """[R, n]: row r is ``plain_random_bits(fold_in(keys[r], data[r]),
    n)`` (``keys[r]`` itself when ``data`` is None), vectorised over the
    rows."""
    k = keys.long() & M32
    k0, k1 = k[:, 0:1], k[:, 1:2]
    if data is not None:
        d = data.long().view(-1, 1) & M32
        k0, k1 = threefry2x32((k0, k1), (torch.zeros_like(d), d))
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32((k0, k1), (idx >> 32, idx & M32))
    return _signed32(b0 ^ b1)


def _check_rows(keys: torch.Tensor, data, n: int) -> torch.device:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be an [R, 2] int32 tensor, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    r = keys.shape[0]
    if data is not None and (data.shape != (r,) or data.dtype != torch.int32
                             or data.device != keys.device):
        raise ValueError(f"data must be an [{r}] int32 tensor on "
                         f"{keys.device}")
    return _check_n(n, keys.device)


def _draw_rows(keys: torch.Tensor, data, n: int, plan) -> torch.Tensor:
    """One launch of the rows kernel on the card (``plan`` = (groups a lane
    a tile, warps an SM, warps a block), 0 for the kernel's own choice), or
    of its oracle (``plan`` None), into a fresh [R, n] int32 tensor."""
    r = keys.shape[0]
    out = torch.empty(r, n, dtype=torch.int32, device=keys.device)
    if r and n:
        if r > 65535:
            raise ValueError(f"{r} rows: at most 65535 a launch")
        from . import _build
        lib = _build.load()
        keys = keys.contiguous()
        data = None if data is None else data.contiguous()
        args = (keys.data_ptr(), None if data is None else data.data_ptr(),
                r, n)
        with torch.cuda.device(keys.device):
            if plan is None:
                name = "gym_threefry_bits_rows_ref"
                code = lib.gym_threefry_bits_rows_ref(
                    *args, out.data_ptr(), _stream(keys.device))
            else:
                name = "gym_threefry_bits_rows"
                code = lib.gym_threefry_bits_rows(
                    *args, *plan, out.data_ptr(), _stream(keys.device))
        _build.check(lib, code, name)
    return out


def random_bits_rows(keys: torch.Tensor, data, n: int) -> torch.Tensor:
    """[R, n] int32 bit patterns: row r is ``jax.random.bits(fold_in(
    keys[r], data[r]), (n,))``, or of ``keys[r]`` when ``data`` is None.
    ``keys`` is an [R, 2] int32 tensor of key words (``key_tensor``) and
    ``data`` an [R] int32 tensor, both on the device that draws: on the
    card the keys are folded there too, in one launch for all the rows
    (``gym_threefry_bits_rows``), so a decode step's keys need no read
    back to the host."""
    device = _check_rows(keys, data, n)
    if device.type == "cpu":
        return plain_random_bits_rows(keys, data, n)
    out = _draw_rows(keys, data, n, (0, 0, 0))
    if keys.shape[0] and n:
        random_bits_rows.launches += 1
    return out


def _on_card(device: torch.device, what: str) -> None:
    if device.type != "cuda":
        raise ValueError(f"{what}: device must be cuda, got {device}")


def random_bits_rows_ref(keys: torch.Tensor, data, n: int) -> torch.Tensor:
    """The rows' oracle on the card: ``random_bits_rows``' function in the
    first kernel (a block a 1024 elements of a row, its thread 0 folding
    the key). Never on the main path; not counted. A CUDA tensor only."""
    _on_card(_check_rows(keys, data, n), "random_bits_rows_ref")
    return _draw_rows(keys, data, n, None)


def random_bits_rows_tuned(keys: torch.Tensor, data, n: int, per_thread: int,
                           warps_per_sm: int,
                           warps_a_block: int) -> torch.Tensor:
    """One launch of the rows kernel at ``per_thread`` groups of 4 a lane
    a tile (1, 2, 4 or 8), at most ``warps_per_sm`` warps an SM and
    ``warps_a_block`` warps a block (1-8), not the kernel's own choice, for
    a sweep (``scripts/d1_t1_sweep.py``): the same bits. Not counted. A
    CUDA tensor only."""
    _on_card(_check_rows(keys, data, n), "random_bits_rows_tuned")
    if per_thread not in (1, 2, 4, 8) or warps_per_sm < 1 or \
            not 1 <= warps_a_block <= 8:
        raise ValueError(f"per_thread must be 1, 2, 4 or 8, warps_per_sm >= "
                         f"1 and warps_a_block 1-8, got {per_thread}, "
                         f"{warps_per_sm}, {warps_a_block}")
    return _draw_rows(keys, data, n, (per_thread, warps_per_sm,
                                      warps_a_block))


random_bits.launches = 0
bernoulli.launches = 0
bernoulli_rows.launches = 0
bernoulli_segments.launches = 0
random_bits_rows.launches = 0


def reset_launch_counts() -> None:
    random_bits.launches = 0
    bernoulli.launches = 0
    bernoulli_rows.launches = 0
    bernoulli_segments.launches = 0
    random_bits_rows.launches = 0


# -- composites --------------------------------------------------------------


def uniform(key: Key, n: int, device) -> torch.Tensor:
    """[n] float32: ``jax.random.uniform(key, (n,))``."""
    return bits_to_uniform(random_bits(key, n, device))


def uniform_ref(key: Key, n: int, device) -> torch.Tensor:
    """``uniform`` through the first bits kernel, uncounted: the draws of
    the codec kernel's oracle (``ops/quantize_tiles.quantize_tiles_ref``).
    Never on the main path. A CUDA device only."""
    device = _check_n(n, device)
    _on_card(device, "uniform_ref")
    return bits_to_uniform(_draw_bits(key, n, device))


def _scalar_bits(key: Key) -> int:
    """``jax.random.bits(key, ())``: the uint32 of counter 0."""
    b0, b1 = threefry2x32(key, (0, 0))
    return b0 ^ b1


def randint(key: Key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` (int32), on the host:
    jax 0.9.0's ``_randint`` — two 32-bit draws from ``split(key)``, each
    reduced mod the span, combined as ``hi·(2³² mod span) + lo`` in uint32
    arithmetic and reduced again. ``maxval <= minval`` returns ``minval``."""
    k1, k2 = split(key)
    hi, lo = _scalar_bits(k1), _scalar_bits(k2)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    off = ((((hi % span) * mult) & M32) + lo % span) & M32
    return minval + off % span


def sort_rounds(n: int) -> int:
    """Rounds of ``jax.random.permutation``'s shuffle for n elements."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1)))


def permutation(key: Key, n: int, device) -> torch.Tensor:
    """[n] int64: ``jax.random.permutation(key, n)``. Each round sorts the
    current order by fresh bits, stably, as unsigned ints (the sign bit
    flipped so that int32 order is uint32 order)."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(sort_rounds(n)):
        key, sub = split(key)
        sort_keys = random_bits(sub, n, device) ^ -0x80000000
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """[n] int32 ``pos`` with ``pos[perm[j]] = j``: ``argsort(perm)`` for a
    permutation."""
    pos = torch.empty(perm.shape[0], dtype=torch.int32, device=perm.device)
    pos[perm] = torch.arange(perm.shape[0], dtype=torch.int32,
                             device=perm.device)
    return pos


# the smallest normal float32, jnp.finfo(float32).tiny
F32_TINY = float(np.finfo(np.float32).tiny)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel``'s values from its bits: ``-log(-log(u))`` with
    u ``uniform(minval=tiny, maxval=1)``, which is the [0, 1) uniform with
    0 raised to tiny (the affine map is exact in f32: 1 − tiny rounds to
    1, and adding tiny to a nonzero uniform changes nothing)."""
    u = torch.clamp(bits_to_uniform(bits), min=F32_TINY)
    return -torch.log(-torch.log(u))


def categorical(logits: torch.Tensor, keys: torch.Tensor,
                data=None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for logits [R, V]:
    argmax of logits plus gumbel noise, the first index on ties. ``keys``
    is an [R, 2] int32 tensor, one key a row, each row's noise the bits of
    its own key over V (as ``jax.vmap`` over rows draws them), or a [1, 2]
    tensor, one key for all of ``logits``, its noise the bits over the flat
    R·V elements (as one call on [R, V] draws them); ``data`` folds into
    the keys first (``random_bits_rows``). Returns [R] int64."""
    r, v = logits.shape
    if keys.shape[0] == r:
        bits = random_bits_rows(keys, data, v)
    elif keys.shape[0] == 1:
        bits = random_bits_rows(keys, data, r * v).view(r, v)
    else:
        raise ValueError(f"{keys.shape[0]} keys for {r} rows")
    return torch.argmax(gumbel_from_bits(bits) + logits, dim=-1)
