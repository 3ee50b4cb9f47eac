"""DeMo: Decoupled Momentum Optimization (arXiv:2411.19870), and decoupled
momentum at the outer cadence (counterpart of ``gym_tpu/strategy/demo.py``).

``DeMoStrategy``, each step, per tile signature ``(a, b)`` (the leaves that
share one, pooled in ``jax.tree.flatten``'s order):

1. ``delta ← β·delta + lr·grad`` (the momentum residual, stored pre-chunked
   as ``delta["{a}x{b}"]`` ``[K, G, a·b]``);
2. DCT-encode every node's tiles (batched matmuls) and keep the top-k
   coefficients a tile (``ops/topk_compress.py``, JAX's picks in JAX's
   order);
3. subtract each node's own transmitted estimate (a sparse decode);
4. "exchange": the ``[K, G, k]`` picks laid out ``[G, K·k]`` node-major,
   as the JAX package's all_gather lays them out;
5. decode once for all K nodes (the result is node-identical): for K·k ≤
   128 the sparse decode of ``mean_weights``, else the dense grid from D1
   (``ops/scatter_mean.py``, the deterministic scatter-mean) and the
   inverse DCT;
6. sign-SGD with the optional step weight decay, per leaf, the bf16 sign
   broadcast to the K nodes.

``comm_bytes`` is Σ n_chunks·k·8 (int32 index + f32 value a pick) and
``comm_recv_bytes`` that times K − 1, as in the reference's counters.
``segment_bytes`` processes a signature in row segments (memory, never the
math) and ``delta_dtype`` stores the residual and the staged gradient in
another dtype (the encode computes in f32).

``DecoupledMomentumStrategy`` (arXiv 2510.03371): inner AdamW every step and
every H steps ``m ← β·m + (θ − master)``, the fast component ``q = C(m)``
through a ``CompressedLink`` (top-k by default; the momentum is the
residual, so the link carries none), ``m ← m − q`` and ``master ← master +
outer_lr·mean(q)``; the nodes restart from the master, stored once.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..convert import jax_leaf_order
from ..ops.dct import (basis, codec_for, decode_chunks, encode_chunks,
                       sparse_decode_chunks)
from ..ops.topk_compress import (mean_weights, scatter_mean_decode,
                                 topk_compress)
from .base import (CollectiveEvent, Strategy, comm_metric, require_finalized,
                   tree_num_params)
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .compress import Codec, CompressedLink
from .diloco import on_every_node
from .optim import OptimSpec, ensure_optim_spec
from .sharding import ravel_nodes, unshard

# K·k picks a chunk up to which the sparse decode beats the dense grid
SPARSE_PICKS = 128


def _segmented(fn, n_rows: int, n_seg: int, *arrays, dim: int = 0):
    """``fn`` over ``n_seg`` row segments of ``arrays`` along ``dim``, each
    output concatenated back (a bare tensor in → a bare tensor out)."""
    if n_seg <= 1:
        return fn(*arrays)
    seg = -(-n_rows // n_seg)
    parts = []
    for lo in range(0, n_rows, seg):
        out = fn(*(x.narrow(dim, lo, min(seg, n_rows - lo)) for x in arrays))
        parts.append(out if isinstance(out, tuple) else (out,))
    cat = tuple(torch.cat([p[i] for p in parts], dim)
                for i in range(len(parts[0])))
    return cat if len(cat) > 1 else cat[0]


class DeMoStrategy(Strategy):
    """The DeMo optimizer as a strategy (SGD-based; lr 1e-3 by default)."""

    def __init__(
        self,
        optim_spec: Optional[Union[str, OptimSpec]] = None,
        compression_decay: float = 0.999,
        compression_topk: int = 32,
        compression_chunk: int = 64,
        weight_decay: float = 0.0,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
        segment_bytes: int = 256 * 1024 * 1024,
        delta_dtype=None,
    ):
        super().__init__(lr_scheduler, lr_scheduler_kwargs, max_norm)
        self.optim_spec = ensure_optim_spec(optim_spec,
                                            OptimSpec("sgd", lr=1e-3))
        if not (0.0 <= compression_decay < 1.0):
            raise ValueError("compression_decay must be in [0, 1)")
        if compression_topk <= 0 or compression_chunk <= 0:
            raise ValueError("compression_topk/chunk must be positive")
        self.compression_decay = float(compression_decay)
        self.compression_topk = int(compression_topk)
        self.compression_chunk = int(compression_chunk)
        self.weight_decay = float(weight_decay)
        # a signature whose f32 working set ([K, G, a·b]) exceeds this is
        # processed in row segments; 0 disables
        self.segment_bytes = int(segment_bytes)
        self.delta_dtype = delta_dtype

    def _groups(self, shapes):
        """``shapes``: {name: per-node shape} → (each name's tiling, the
        names of each (a, b) signature in JAX leaf order, signatures
        sorted)."""
        order = jax_leaf_order(shapes)
        codecs = {n: codec_for(tuple(shapes[n]), self.compression_chunk)
                  for n in shapes}
        groups = {}
        for n in sorted(shapes, key=order.__getitem__):
            groups.setdefault((codecs[n].a, codecs[n].b), []).append(n)
        return codecs, dict(sorted(groups.items()))

    def init(self, params):
        require_finalized(self)
        first = next(iter(params.values()))
        k, dev = first.shape[0], first.device
        codecs, groups = self._groups(
            {n: tuple(p.shape[1:]) for n, p in params.items()})
        dt = self.delta_dtype or torch.float32
        return {"delta": {
            f"{a}x{b}": torch.zeros(
                k, sum(codecs[n].n_chunks for n in names), a * b, dtype=dt,
                device=dev)
            for (a, b), names in groups.items()}}

    def _n_segments(self, rows: int, a: int, b: int) -> int:
        """Segments that keep ``rows`` × a × b f32 under
        ``segment_bytes``."""
        if self.segment_bytes <= 0:
            return 1
        return max(1, -(-(rows * a * b * 4) // self.segment_bytes))

    def _lr(self, step: int) -> float:
        base = self.optim_spec.lr
        if self._lr_scale is None:
            return float(np.float32(base))
        return float(np.float32(base) * np.float32(self._lr_scale(step)))

    def step(self, grads, params, state, step, ctx):
        grads = self._maybe_clip(grads, ctx)
        lr = self._lr(step)
        beta = self.compression_decay
        topk = self.compression_topk
        first = next(iter(params.values()))
        k_nodes, dev = first.shape[0], first.device
        codecs, groups = self._groups(
            {n: tuple(p.shape[1:]) for n, p in params.items()})
        stage_dt = self.delta_dtype or torch.float32
        new_delta, signs = {}, {}
        comm_tx = 0.0
        for (a, b), names in groups.items():
            key = f"{a}x{b}"
            d_a, d_b = basis(a, dev), basis(b, dev)
            g_cat = torch.cat(
                [codecs[n].to_chunks(grads[n].to(stage_dt))
                 .reshape(k_nodes, codecs[n].n_chunks, a * b)
                 for n in names], dim=1)                 # [K, G, a·b]
            n_chunks = g_cat.shape[1]

            def encode_one(d_seg, g_seg):
                # f32 whatever the storage dtype: decay + accumulate, DCT,
                # top-k, minus the own picks' estimate (own picks are
                # distinct within a chunk: a sparse decode of the values)
                delta = (beta * d_seg.float() + lr * g_seg.float())
                delta3 = delta.reshape(-1, a, b)
                coeffs = encode_chunks(delta3, d_a, d_b)
                i_s, v_s = topk_compress(coeffs, topk)
                est = sparse_decode_chunks(i_s, v_s, d_a, d_b)
                nd = (delta3 - est).reshape(d_seg.shape).to(stage_dt)
                rows = d_seg.shape[:2]
                return (nd, i_s.reshape(*rows, -1), v_s.reshape(*rows, -1))

            new_delta[key], idx, val = _segmented(
                encode_one, n_chunks,
                self._n_segments(k_nodes * n_chunks, a, b),
                state["delta"][key], g_cat, dim=1)
            k = idx.shape[-1]
            # every node's picks a chunk, node-major: [G, K·k]
            all_idx = idx.transpose(0, 1).reshape(n_chunks, k_nodes * k)
            all_val = val.transpose(0, 1).reshape(n_chunks, k_nodes * k)

            def decode_one(ii, vv):
                if k_nodes * k <= SPARSE_PICKS:
                    dec = sparse_decode_chunks(ii, mean_weights(ii, vv),
                                               d_a, d_b)
                else:
                    dec = decode_chunks(scatter_mean_decode(
                        ii.contiguous(), vv.contiguous(), a * b), d_a, d_b)
                # only the sign survives: ±1/0 is exact in bf16
                return torch.sign(dec).reshape(-1, a * b).to(torch.bfloat16)

            signs[key] = _segmented(decode_one, n_chunks,
                                    self._n_segments(n_chunks, a, b),
                                    all_idx, all_val)
            comm_tx += float(n_chunks * k * 8)

        # sign-SGD with the optional step weight decay, per leaf; the decay
        # factor in f32, as the JAX package computes it
        decay = float(np.float32(1.0) - np.float32(lr)
                      * np.float32(self.weight_decay))
        new_params = {}
        for (a, b), names in groups.items():
            off = 0
            for n in names:
                c = codecs[n]
                sgn = c.from_chunks(signs[f"{a}x{b}"][off:off + c.n_chunks]
                                    .view(c.n_chunks, a, b))
                off += c.n_chunks
                p = params[n]
                new_p = p.reshape(k_nodes, *c.shape)
                if self.weight_decay:
                    new_p = new_p * decay
                new_p = new_p - lr * sgn.float()
                new_params[n] = new_p.reshape(p.shape).to(p.dtype)
        new_params = {n: new_params[n] for n in params}
        recv = torch.full((k_nodes,), comm_tx * (k_nodes - 1),
                          dtype=torch.float32, device=dev)
        return (new_params, {"delta": new_delta},
                {"comm_bytes": comm_metric(comm_tx),
                 "comm_recv_bytes": recv})

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        """One all_gather of the picks a signature, every step; a node
        transmits its n_chunks·k picks of 8 bytes."""
        codecs, groups = self._groups(
            {n: tuple(p.shape) for n, p in params.items()})
        events = []
        for (a, b), names in groups.items():
            n_chunks = sum(codecs[n].n_chunks for n in names)
            k = max(1, min(self.compression_topk, a * b))
            payload = float(n_chunks * k * 8)
            events.append(CollectiveEvent(
                "all_gather", payload * num_nodes, num_nodes,
                label=f"picks_{a}x{b}", tx_bytes=payload))
        return events

    def config(self):
        cfg = super().config()
        cfg.update({
            "compression_decay": self.compression_decay,
            "compression_topk": self.compression_topk,
            "compression_chunk": self.compression_chunk,
            "weight_decay": self.weight_decay,
            "segment_bytes": self.segment_bytes,
            "delta_dtype": (str(self.delta_dtype).replace("torch.", "")
                            if self.delta_dtype else "float32"),
        })
        return cfg


class DeMoOuterCommunicator(CommunicationModule):
    """Decoupled momentum at the outer cadence: every H steps each node's
    outer momentum accumulates ``θ − master``, its fast component goes
    through the link and leaves the momentum, and the master advances by
    ``outer_lr`` times the node mean of the fast components."""

    def __init__(
        self,
        H: int = 10,
        outer_lr: float = 0.7,
        momentum: float = 0.9,
        codec: Union[str, Codec, None] = "topk",
        seed: int = 2510,   # arXiv 2510.03371
        **codec_kwargs,
    ):
        if H < 1:
            raise ValueError(f"H must be >= 1, got {H}")
        if not 0.0 <= momentum < 1.0:
            raise ValueError(f"momentum must be in [0, 1), got {momentum}")
        self.H = int(H)
        self.outer_lr = float(outer_lr)
        self.momentum = float(momentum)
        # no error feedback: the momentum buffer is the residual
        self.link = CompressedLink(codec, seed=seed, error_feedback=False,
                                   **codec_kwargs)

    def init(self, params):
        first = next(iter(params.values()))
        return {
            "master": {n: p[0].clone() for n, p in params.items()},
            "momentum": torch.zeros(first.shape[0], tree_num_params(params)
                                    // first.shape[0],
                                    dtype=torch.float32, device=first.device),
        }

    def communicate(self, params, mstate, step, ctx):
        k = ctx.num_nodes
        if k <= 1 or not (step % self.H == 0 and step > 0):
            return params, mstate, 0.0
        master = mstate["master"]
        flat_p = ravel_nodes(params, k)
        flat_m = ravel_nodes({n: m.unsqueeze(0) for n, m in master.items()},
                             1)
        m = self.momentum * mstate["momentum"] + (flat_p - flat_m)
        q, _ = self.link.encode(m, None, self.link.node_keys(step, k))
        m = m - q                                 # the decoupled remainder
        master_flat = flat_m + self.outer_lr * q.mean(dim=0, keepdim=True)
        master = unshard(master_flat, master_flat.shape[1], params)
        comm = 2.0 * (k - 1) / k * self.link.wire_bytes(flat_p.shape[1])
        return (on_every_node(master, k),
                {"master": master, "momentum": m}, comm)

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        if num_nodes <= 1 or not (step % self.H == 0 and step > 0):
            return []
        n = tree_num_params(params)
        return [CollectiveEvent("all_reduce", self.link.wire_bytes(n),
                                num_nodes, label="outer_momentum_fast")]

    def config(self):
        cfg = {"module": "DeMoOuterCommunicator", "H": self.H,
               "outer_lr": self.outer_lr, "outer_momentum": self.momentum}
        cfg.update(self.link.config())
        return cfg


class DecoupledMomentumStrategy(CommunicateOptimizeStrategy):
    """Inner optimizer (default AdamW) + decoupled outer momentum."""

    def __init__(
        self,
        optim_spec: Optional[Union[str, OptimSpec]] = None,
        H: int = 10,
        outer_lr: float = 0.7,
        outer_momentum: float = 0.9,
        codec: Union[str, Codec, None] = "topk",
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
        **codec_kwargs,
    ):
        self.H = int(H)
        super().__init__(
            communication_modules=[
                DeMoOuterCommunicator(H=H, outer_lr=outer_lr,
                                      momentum=outer_momentum,
                                      codec=codec, **codec_kwargs)],
            inner_optim=ensure_optim_spec(optim_spec, OptimSpec("adamw")),
            max_norm=max_norm,
            lr_scheduler=lr_scheduler,
            lr_scheduler_kwargs=lr_scheduler_kwargs,
        )

    def config(self):
        cfg = super().config()
        cfg["H"] = self.H
        return cfg
