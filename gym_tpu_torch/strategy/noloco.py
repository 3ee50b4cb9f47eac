"""NoLoCo: all-reduce-free training by randomized partner averaging
(arXiv:2506.10911; counterpart of ``gym_tpu/strategy/noloco.py``).

Every H steps each node averages its params with one partner's and takes a
local outer Nesterov step on ``master − avg``; the master and the outer
momentum are per node (``[K, ...]``), so replicas part after a sync and
consensus comes from the gossip. The partner map σ is drawn from the shared
key ``fold_in(PRNGKey(seed), step)``: a random permutation π conjugating a
random non-zero rotation r, ``σ[π[j]] = π[(j + r) % K]``, so no node is its
own partner (σ has gcd(r, K) cycles: one K-cycle only where gcd is 1),
JAX's ``permutation`` and ``randint`` bit for bit (``ops/threefry.py``),
drawn on the host (K values). Node i reads node σ(i)'s params, an
``index_select`` over the node dimension; every node sends |θ| to one peer.

With a codec the params travel compressed through a ``CompressedLink``
with a per-node error-feedback residual and per-node keys; the node's own
side stays lossless.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from ..ops import threefry
from .base import CollectiveEvent, tree_bytes, tree_num_params
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .compress import Codec, CompressedLink
from .optim import OptimSpec, apply_updates, ensure_optim_spec
from .sharding import ravel_nodes, unravel_nodes

_DEFAULT_SEED = 2506  # arXiv 2506.10911


class NoLoCoCommunicator(CommunicationModule):
    """Randomized partner averaging + local Nesterov outer step."""

    def __init__(
        self,
        H: int = 10,
        outer_optim_spec: Optional[Union[str, OptimSpec]] = None,
        seed: int = _DEFAULT_SEED,
        codec: Union[str, Codec, None] = None,
        error_feedback: Optional[bool] = None,
        **codec_kwargs,
    ):
        if H < 1:
            raise ValueError(f"H must be >= 1, got {H}")
        self.H = int(H)
        self.seed = int(seed)
        self.link = CompressedLink(codec, seed=self.seed,
                                   error_feedback=error_feedback,
                                   **codec_kwargs)
        self.outer_optim_spec = ensure_optim_spec(
            outer_optim_spec,
            OptimSpec("sgd", lr=0.7, nesterov=True, momentum=0.9))
        self.outer_tx = self.outer_optim_spec.build()

    def partner_permutation(self, step: int, k: int) -> np.ndarray:
        """σ as a [k] int array: node i's partner is σ[i]."""
        key = threefry.fold_in(threefry.PRNGKey(self.seed), int(step))
        k_pi, k_rot = threefry.split(key)
        pi = threefry.permutation(k_pi, k, "cpu").numpy()
        r = threefry.randint(k_rot, 1, k)
        sigma = np.zeros(k, dtype=np.int64)
        sigma[pi] = pi[(np.arange(k) + r) % k]
        return sigma

    def init(self, params):
        first = next(iter(params.values()))
        master = {n: p.clone() for n, p in params.items()}
        return {"master": master, "outer_opt": self.outer_tx.init(master),
                **self.link.init(tree_num_params(params) // first.shape[0],
                                 first.shape[0], first.device)}

    def communicate(self, params, mstate, step, ctx):
        k = ctx.num_nodes
        if k <= 1 or not (step % self.H == 0 and step > 0):
            return params, mstate, 0.0
        first = next(iter(params.values()))
        sigma = torch.from_numpy(self.partner_permutation(step, k)).to(
            first.device)
        extra = {}
        if self.link.compressed:
            flat_p = ravel_nodes(params, k)
            lstate = ({"ef_residual": mstate["ef_residual"]}
                      if self.link.error_feedback else {})
            p_hat, extra = self.link.send(flat_p, lstate,
                                          self.link.node_keys(step, k))
            avg = unravel_nodes(0.5 * (flat_p + p_hat.index_select(0, sigma)),
                                params)
            comm = self.link.wire_bytes(flat_p.shape[1])
        else:
            avg = {n: (0.5 * (p + p.index_select(0, sigma))).to(p.dtype)
                   for n, p in params.items()}
            comm = float(tree_bytes(params) // k)
        master = mstate["master"]
        pseudo = {n: master[n] - avg[n] for n in master}
        updates, outer_opt = self.outer_tx.update(pseudo, mstate["outer_opt"],
                                                  master)
        master = apply_updates(master, updates)
        return master, {"master": master, "outer_opt": outer_opt,
                        **extra}, comm

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        if num_nodes <= 1 or not (step % self.H == 0 and step > 0):
            return []
        sigma = self.partner_permutation(step, num_nodes)
        # data moves σ(i) → i: the (sender, receiver) edges
        pairs = tuple((int(sigma[i]), i) for i in range(num_nodes))
        if self.link.compressed:
            return [CollectiveEvent(
                "p2p", self.link.wire_bytes(tree_num_params(params)),
                num_nodes, label="gossip_compressed", pairs=pairs)]
        return [CollectiveEvent("p2p", float(tree_bytes(params)), num_nodes,
                                label="gossip", pairs=pairs)]

    def config(self):
        cfg = {"module": "NoLoCoCommunicator", "H": self.H,
               "gossip_seed": self.seed,
               "outer_optimizer": self.outer_optim_spec.name,
               "outer_lr": self.outer_optim_spec.lr}
        if self.link.compressed:
            cfg.update(self.link.config())
        return cfg


class NoLoCoStrategy(CommunicateOptimizeStrategy):
    """Inner optimizer (default AdamW) + NoLoCo's partner gossip."""

    def __init__(
        self,
        optim_spec: Optional[Union[str, OptimSpec]] = None,
        outer_optim_spec: Optional[Union[str, OptimSpec]] = None,
        H: int = 10,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
        gossip_seed: int = _DEFAULT_SEED,
        codec: Union[str, Codec, None] = None,
        error_feedback: Optional[bool] = None,
        **codec_kwargs,
    ):
        self.H = int(H)
        super().__init__(
            communication_modules=[
                NoLoCoCommunicator(H=H, outer_optim_spec=outer_optim_spec,
                                   seed=gossip_seed, codec=codec,
                                   error_feedback=error_feedback,
                                   **codec_kwargs)],
            inner_optim=ensure_optim_spec(optim_spec, OptimSpec("adamw")),
            max_norm=max_norm,
            lr_scheduler=lr_scheduler,
            lr_scheduler_kwargs=lr_scheduler_kwargs,
        )

    def partner_permutation(self, step: int, k: int) -> np.ndarray:
        return self.communication_modules[0].partner_permutation(step, k)

    def config(self):
        cfg = super().config()
        cfg["H"] = self.H
        return cfg
