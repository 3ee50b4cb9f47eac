"""Collective-payload codecs and the compressed link (counterpart of
``gym_tpu/strategy/compress.py``).

A codec is a ``compress(x, keys) -> payload`` / ``decompress(payload, n)``
pair over rows of flat f32 vectors, ``x`` ``[R, n]`` (one row a node, or a
single row). ``keys`` is one threefry key shared by every row or one key a
row; ``wire_bytes(n)`` is the honest size of one row's payload on a real
wire, side channel included, which ``comm_bytes`` and ``comm_events``
declare while the emulation moves dense f32.

- ``QuantizeCodec``: int8/int4 with a per-tile max-abs scale; stochastic
  rounding ``floor(q + u)`` with ``u = jax.random.uniform(key, (t, tile))``,
  which is ``threefry.uniform(key, t·tile)`` (the counter is the row-major
  flat index). The bits of the codec as the strategies run it in the
  jitted step, where XLA compiles ``amax / qmax`` into ``amax · f32(1 /
  qmax)``: ``ops/quantize_tiles`` (one kernel launch a call on the card,
  its plain version on the CPU). The serving loader's eager form divides
  (``serve/load.py``).
- ``TopKCodec``: the ``max(1, round(frac·n))`` largest |x| as (idx, val),
  selected by ``ops/topk_compress.topk_compress`` in JAX's order; decompress
  is a scatter of unique indices.
- ``CompressedLink``: the codec, the error-feedback recursion (``send = x +
  residual``, ``residual' = send − delivered``) and the key discipline
  (``link_key``: the seed folded with the step, the hop and, for per-node
  payloads, the node index).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..ops import threefry
from ..ops.quantize_tiles import Keys, quantize_tiles
from ..ops.topk_compress import topk_compress

Payload = Tuple[torch.Tensor, ...]


class Codec(abc.ABC):
    """A lossy (or lossless) codec for rows of flat f32 vectors."""

    #: does the owning strategy need to carry an error-feedback residual?
    error_feedback: bool = False

    @abc.abstractmethod
    def compress(self, x: torch.Tensor, keys: Keys) -> Payload:
        """``x`` ``[R, n]`` f32 → payload tensors, each ``[R, ...]``."""

    @abc.abstractmethod
    def decompress(self, payload: Payload, n: int) -> torch.Tensor:
        """Payload → ``[R, n]`` f32."""

    @abc.abstractmethod
    def wire_bytes(self, n: int) -> float:
        """Honest wire bytes of one row of ``n`` elements."""

    def roundtrip(self, x: torch.Tensor, keys: Keys) -> torch.Tensor:
        return self.decompress(self.compress(x, keys), int(x.shape[-1]))

    def error(self, send: torch.Tensor, payload: Payload,
              x_hat: torch.Tensor) -> torch.Tensor:
        """The error-feedback residual ``send − x_hat`` of a payload and
        its decompression ``x_hat``."""
        return send - x_hat

    @abc.abstractmethod
    def config(self) -> Dict[str, Any]:
        """Static knobs for run configs."""


@dataclasses.dataclass(frozen=True)
class QuantizeCodec(Codec):
    """int8/int4 quantization with a per-tile max-abs scale; values kept
    as int8 whatever ``bits`` (``wire_bytes`` counts ``bits`` an element
    plus one f32 scale a tile)."""

    bits: int = 8
    tile: int = 256
    stochastic: bool = True

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.tile < 1:
            raise ValueError(f"tile must be >= 1, got {self.tile}")

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1   # 127 / 7

    def _tiles(self, n: int) -> int:
        return -(-n // self.tile)

    def compress(self, x: torch.Tensor, keys: Keys) -> Payload:
        return quantize_tiles(x, keys, self.qmax, self.tile, self.stochastic)

    def decompress(self, payload: Payload, n: int) -> torch.Tensor:
        q, scale = payload
        return (q.float() * scale).reshape(q.shape[0], -1)[:, :n]

    def error(self, send: torch.Tensor, payload: Payload,
              x_hat: torch.Tensor) -> torch.Tensor:
        """``send − q·scale`` rounded once, as the jitted link computes it
        (XLA fuses the decompress into the subtraction as one multiply-
        add), in f32: with the scale split as hi + lo, 12 significant bits
        each, q·hi and q·lo are exact, so the product's rounding error
        ``err = (q·hi − x_hat) + q·lo`` is exact (the difference by
        Sterbenz's lemma), and ``send − x_hat`` is exact wherever err is
        not 0 (|q| >= 3, where send lies within a factor 2 of x_hat); then
        ``(send − x_hat) − err`` is the one rounding. The exception is a
        product that overflows (a tile holding ±FLT_MAX or the float
        below it), whose delivered value is ±inf in the jitted link too."""
        q, scale = payload
        rows, n = send.shape
        hi = (scale.view(torch.int32) & -4096).view(torch.float32)
        qf = q.float()
        a = qf * hi
        b = qf.mul_(scale - hi)

        def flat(t):
            return t.view(rows, -1)[:, :n]

        err = flat(a).sub_(x_hat).add_(flat(b))
        return (send - x_hat).sub_(err)

    def wire_bytes(self, n: int) -> float:
        t = self._tiles(n)
        return t * self.tile * self.bits / 8.0 + t * 4.0

    def config(self) -> Dict[str, Any]:
        return {"codec": f"int{self.bits}", "tile": self.tile,
                "stochastic": self.stochastic}


@dataclasses.dataclass(frozen=True)
class TopKCodec(Codec):
    """Top-k magnitude sparsification of each row, as (int32 index, f32
    value) pairs; biased, so the owning strategy carries an error-feedback
    residual. ``frac >= 1`` keeps everything (lossless)."""

    frac: float = 0.01
    error_feedback: bool = True

    def __post_init__(self):
        if not 0.0 < self.frac:
            raise ValueError(f"frac must be positive, got {self.frac}")

    def k_of(self, n: int) -> int:
        return max(1, min(int(round(self.frac * n)), n))

    def compress(self, x: torch.Tensor, keys: Keys) -> Payload:
        return topk_compress(x.float(), self.k_of(x.shape[-1]))

    def decompress(self, payload: Payload, n: int) -> torch.Tensor:
        idx, val = payload
        out = torch.zeros(idx.shape[0], n, dtype=torch.float32,
                          device=idx.device)
        return out.scatter_(1, idx.long(), val)

    def wire_bytes(self, n: int) -> float:
        return self.k_of(n) * 8.0   # int32 idx + f32 val

    def config(self) -> Dict[str, Any]:
        return {"codec": "topk", "frac": self.frac}


def make_codec(spec: Union[str, Codec, None], **kwargs) -> Codec:
    """``"int8"`` / ``"int4"`` / ``"topk"`` / a Codec → Codec; ``None`` is
    int8."""
    if isinstance(spec, Codec):
        return spec
    name = "int8" if spec is None else str(spec)
    if name == "int8":
        return QuantizeCodec(bits=8, **kwargs)
    if name == "int4":
        return QuantizeCodec(bits=4, **kwargs)
    if name == "topk":
        return TopKCodec(**kwargs)
    raise ValueError(
        f"unknown codec {spec!r}; expected 'int8', 'int4', 'topk' or a "
        f"Codec instance")


def hop_keys(seed: int, step: int, n_hops: int = 2):
    """One step's shared rounding keys, a hop each: ``split(fold_in(
    PRNGKey(seed), step), n_hops)``, the same on every node."""
    key = threefry.fold_in(threefry.PRNGKey(seed), step)
    return threefry.split(key, n_hops)


def link_key(seed: int, step: int, hop: int = 0, node: Optional[int] = None):
    """``CompressedLink``'s key: the seed folded with the step, the hop
    and, for a payload a node compresses on its own, the node index."""
    key = threefry.fold_in(threefry.PRNGKey(seed), step)
    key = threefry.fold_in(key, hop)
    if node is not None:
        key = threefry.fold_in(key, node)
    return key


class CompressedLink:
    """One outer-loop hop as compress → wire → decompress, with the codec
    (``None``/``"dense"`` is the identity), an error-feedback residual
    (default on for every lossy codec) and ``link_key``'s keys."""

    def __init__(self, codec: Union[str, Codec, None] = None,
                 seed: int = 0, error_feedback: Optional[bool] = None,
                 **codec_kwargs):
        if codec is None or codec == "dense":
            if codec_kwargs:
                raise ValueError(
                    f"codec kwargs {sorted(codec_kwargs)} given for the "
                    f"dense (identity) link")
            self.codec: Optional[Codec] = None
        else:
            self.codec = make_codec(codec, **codec_kwargs)
        self.seed = int(seed)
        if error_feedback is None:
            error_feedback = self.codec is not None
        self.error_feedback = bool(error_feedback) and self.codec is not None

    @property
    def compressed(self) -> bool:
        return self.codec is not None

    def init(self, n: int, rows: int, device) -> Dict[str, torch.Tensor]:
        """The residual ``[rows, n]`` (empty without error feedback)."""
        if not self.error_feedback:
            return {}
        return {"ef_residual": torch.zeros(rows, int(n), dtype=torch.float32,
                                           device=device)}

    def key(self, step: int, hop: int = 0, node: Optional[int] = None):
        return link_key(self.seed, step, hop, node)

    def node_keys(self, step: int, k: int, hop: int = 0):
        """Every node's key for a per-node payload, in node order."""
        return [self.key(step, hop, i) for i in range(k)]

    def encode(self, x: torch.Tensor, residual: Optional[torch.Tensor],
               keys: Keys):
        """``[R, n]`` rows through the link: ``(delivered, new_residual)``;
        ``residual=None`` carries none (dense link, or a strategy whose own
        state is the residual)."""
        if self.codec is None:
            return x, residual
        send = x if residual is None else x + residual
        payload = self.codec.compress(send, keys)
        x_hat = self.codec.decompress(payload, int(send.shape[-1]))
        if residual is None:
            return x_hat, None
        return x_hat, self.codec.error(send, payload, x_hat)

    def send(self, x: torch.Tensor, lstate: Dict[str, torch.Tensor], keys):
        """``encode`` over ``init``'s state layout."""
        residual = lstate["ef_residual"] if self.error_feedback else None
        x_hat, new_residual = self.encode(x, residual, keys)
        if not self.error_feedback:
            return x_hat, lstate
        return x_hat, dict(lstate, ef_residual=new_residual)

    def wire_bytes(self, n: int) -> float:
        if self.codec is None:
            return 4.0 * n
        return self.codec.wire_bytes(n)

    def config(self) -> Dict[str, Any]:
        if self.codec is None:
            return {"codec": "dense"}
        cfg = dict(self.codec.config())
        cfg["link_error_feedback"] = self.error_feedback
        return cfg
