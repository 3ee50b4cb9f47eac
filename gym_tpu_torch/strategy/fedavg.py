"""FedAvg / local SGD with optional random islands (counterpart of
``gym_tpu/strategy/fedavg.py``).

Every H steps (gate ``step % H == 0 and step > 0``) the nodes average their
params: over all K nodes, or, with ``island_size < K``, within islands of
that size drawn by a shared-PRNG shuffle of the node list (JAX's threefry
``permutation`` of K under ``fold_in(PRNGKey(seed), step)``, on the host).
The JAX package all_gathers the K models onto every node and takes a
membership-weighted mean there, [K, K, ...]; here each island's mean is
computed once over its members and handed to them, so nothing larger than
the node-stacked params is built. ``participation < 1`` drops a
shared-PRNG subset of nodes from the round (``faults.py``); they keep
their local params.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..ops import threefry
from .base import CollectiveEvent, tree_bytes
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .faults import (alive_tensor, host_participation, host_values,
                     masked_mean, mean_ring_tx, participation_round,
                     ring_bytes, sync_alive)
from .optim import OptimSpec


def shuffled_nodes(seed: int, step: int, k: int) -> List[int]:
    """The node in each slot of the shuffled node list at ``step``; slots
    ``s·isl ... (s+1)·isl − 1`` form island s."""
    key = threefry.fold_in(threefry.PRNGKey(seed), step)
    return threefry.permutation(key, k, "cpu").tolist()


class AveragingCommunicator(CommunicationModule):
    """Full or island-subset parameter averaging."""

    def __init__(self, island_size: Optional[int] = None, seed: int = 1234,
                 participation: float = 1.0, fault_seed: int = 5678):
        if not 0.0 < participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {participation}")
        self.island_size = island_size
        self.seed = seed
        self.participation = float(participation)
        self.fault_seed = fault_seed

    def communicate(self, params, mstate, step, ctx):
        k = ctx.num_nodes
        if k == 1:
            return params, mstate, 0.0
        psize = float(tree_bytes(params) // k)
        isl = self.island_size if self.island_size is not None else k
        alive, group = participation_round(self.fault_seed, step,
                                           self.participation, k)
        frac = group / k
        dev = next(iter(params.values())).device
        if self.participation < 1.0:
            alive_t = alive_tensor(alive, dev)

        if isl >= k:
            if self.participation < 1.0:
                avg = masked_mean(params, alive_t)
                return (sync_alive(avg, params, alive_t), mstate,
                        mean_ring_tx(group, frac, psize))
            avg = {n: p.mean(dim=0, keepdim=True).expand_as(p).contiguous()
                   for n, p in params.items()}
            return avg, mstate, ring_bytes(k, psize)

        # islands: the nodes gathered in shuffled order (padded to whole
        # islands with weight 0), one weighted sum per island over its alive
        # members, and each node's island mean gathered back
        perm = shuffled_nodes(self.seed, step, k)
        n_isl = -(-k // isl)
        pad = n_isl * isl - k
        weight = [float(alive[j]) for j in perm] + [0.0] * pad
        counts = [max(sum(weight[s * isl:(s + 1) * isl]), 1.0)
                  for s in range(n_isl)]
        island = [0] * k
        for slot, j in enumerate(perm):
            island[j] = slot // isl
        order = host_values(perm + [0] * pad, torch.long, dev)
        weight = host_values(weight, torch.float32, dev)
        counts = host_values(counts, torch.float32, dev)
        island = host_values(island, torch.long, dev)
        avg = {}
        for name, p in params.items():
            rest = (1,) * (p.dim() - 1)
            g = p.index_select(0, order) * weight.view(-1, *rest)
            means = (g.view(n_isl, isl, *p.shape[1:]).sum(dim=1)
                     / counts.view(-1, *rest))
            avg[name] = means.index_select(0, island)
        if self.participation < 1.0:
            avg = sync_alive(avg, params, alive_t)
        # all_gather: each alive node transmits its full model once
        return avg, mstate, frac * psize

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        if num_nodes <= 1:
            return []
        psize = float(tree_bytes(params))
        isl = self.island_size if self.island_size is not None else num_nodes
        group, frac = host_participation(self.fault_seed, step, num_nodes,
                                         self.participation)
        if isl >= num_nodes:
            tx = None if frac >= 1.0 else mean_ring_tx(group, frac, psize)
            return [CollectiveEvent("all_reduce", psize, group,
                                    label="avg", tx_bytes=tx)]
        return [CollectiveEvent("all_gather", float(isl) * psize,
                                min(isl, group), label="island_avg",
                                tx_bytes=frac * psize)]

    def config(self):
        cfg = {"module": "AveragingCommunicator",
               "island_size": self.island_size}
        if self.participation < 1.0:
            cfg["participation"] = self.participation
        return cfg


class FedAvgStrategy(CommunicateOptimizeStrategy):
    """Local steps + periodic (island) averaging."""

    def __init__(
        self,
        inner_optim: Optional[Union[str, OptimSpec]] = None,
        island_size: Optional[int] = None,
        H: int = 1,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
        participation: float = 1.0,
    ):
        super().__init__(
            communication_modules=[
                AveragingCommunicator(island_size,
                                      participation=participation)
            ],
            inner_optim=inner_optim,
            max_norm=max_norm,
            lr_scheduler=lr_scheduler,
            lr_scheduler_kwargs=lr_scheduler_kwargs,
        )
        self.island_size = island_size
        self.H = int(H)

    def _should_communicate(self, step: int) -> bool:
        return step % self.H == 0 and step > 0

    def config(self):
        cfg = super().config()
        cfg["H"] = self.H
        return cfg
