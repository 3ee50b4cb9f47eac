"""DynamiQ: DDP with both hops of the gradient all-reduce compressed
(arXiv:2602.08923; counterpart of ``gym_tpu/strategy/dynamiq.py``).

Hop 1 compresses each node's flat gradient and reduce-scatters it (node i
receives the mean of chunk i); hop 2 compresses the reduced chunks and
all-gathers them. Both hops go through a ``CompressedLink`` with the shared
keys ``hop_keys(seed, step)``: the key is the same on every node, so one
draw a hop (one launch of the bits kernel on the card, for the quantizing
codecs) serves all K. Top-k is biased, so it carries the double
error-feedback residuals ``residual`` ``[K, n]`` (hop 1) and ``residual2``
``[K, ⌈n/K⌉]`` (hop 2, the chunk each node owns). ``comm_bytes`` is
(K−1)/K of the two hops' wire bytes, the canonical compressed schedule.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .base import (CollectiveEvent, Strategy, StrategyLifecycleError,
                   comm_metric, require_finalized, tree_num_params)
from .compress import Codec, CompressedLink, hop_keys, make_codec
from .optim import OptimSpec, apply_updates, ensure_optim_spec
from .sharding import ravel_nodes, unravel_nodes


class DynamiQStrategy(Strategy):
    """DDP with both all-reduce hops compressed."""

    def __init__(
        self,
        optim_spec: Optional[Union[str, OptimSpec]] = None,
        codec: Union[str, Codec, None] = None,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
        seed: int = 2602,   # arXiv 2602.08923
        **codec_kwargs,
    ):
        super().__init__(lr_scheduler, lr_scheduler_kwargs, max_norm)
        self.optim_spec = ensure_optim_spec(optim_spec, OptimSpec("adamw"))
        self.codec = make_codec(codec, **codec_kwargs)
        self.seed = int(seed)
        self._link = CompressedLink(self.codec, seed=self.seed,
                                    error_feedback=self.codec.error_feedback)
        self.tx = None

    def _build(self):
        self.tx = self.optim_spec.build(self._lr_scale)

    def init(self, params):
        require_finalized(self)
        state = {"opt": self.tx.init(params)}
        if self.codec.error_feedback:
            if self._ctx is None:
                raise StrategyLifecycleError(
                    "DynamiQStrategy with an error-feedback codec needs "
                    "the node count before init to size the hop-2 "
                    "residual: the Trainer binds it, or call "
                    "strategy.bind_ctx(ctx).")
            first = next(iter(params.values()))
            k = self._ctx.num_nodes
            n = tree_num_params(params) // first.shape[0]
            state["residual"] = torch.zeros(k, n, dtype=torch.float32,
                                            device=first.device)
            state["residual2"] = torch.zeros(k, -(-n // k),
                                             dtype=torch.float32,
                                             device=first.device)
        return state

    def _wires(self, n: int, k: int):
        """(hop-1, hop-2) wire bytes: hop 1 a node's full gradient, hop 2
        its reduced chunk, counted as the gather's assembled output."""
        shard = -(-n // k)
        return (self.codec.wire_bytes(n), k * self.codec.wire_bytes(shard))

    def step(self, grads, params, state, step, ctx):
        k = ctx.num_nodes
        new_state = dict(state)
        if k == 1:
            mean = {n: g.float() for n, g in grads.items()}
            comm = 0.0
        else:
            flat_g = ravel_nodes(grads, k)
            n = flat_g.shape[1]
            shard = -(-n // k)
            k_hop1, k_hop2 = hop_keys(self.seed, step)
            ef = self.codec.error_feedback
            g_hat, res1 = self._link.encode(
                flat_g, state["residual"] if ef else None, k_hop1)
            g_pad = torch.nn.functional.pad(g_hat, (0, k * shard - n))
            # hop 1: reduce-scatter, node i receives the mean of chunk i
            chunk = ctx.reduce_scatter(g_pad) / k
            # hop 2: each node compresses its reduced chunk; all gather
            chunk_hat, res2 = self._link.encode(
                chunk, state["residual2"] if ef else None, k_hop2)
            if ef:
                new_state["residual"], new_state["residual2"] = res1, res2
            mean_flat = chunk_hat.reshape(1, -1)[:, :n].expand(k, n)
            mean = unravel_nodes(mean_flat, grads)
            w1, w2 = self._wires(n, k)
            comm = (k - 1) / k * (w1 + w2)
        mean = self._maybe_clip(mean, ctx)
        mean = {n: m.to(grads[n].dtype) for n, m in mean.items()}
        updates, new_state["opt"] = self.tx.update(mean, state["opt"],
                                                   params)
        return (apply_updates(params, updates), new_state,
                {"comm_bytes": comm_metric(comm)})

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        if num_nodes <= 1:
            return []
        w1, w2 = self._wires(tree_num_params(params), num_nodes)
        return [CollectiveEvent("reduce_scatter", w1, num_nodes,
                                label="grads_compressed"),
                CollectiveEvent("all_gather", w2, num_nodes,
                                label="chunks_compressed")]

    def config(self):
        cfg = super().config()
        cfg.update(self.codec.config())
        cfg["codec_seed"] = self.seed
        return cfg
