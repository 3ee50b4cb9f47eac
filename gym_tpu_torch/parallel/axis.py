"""Node-axis collective context (counterpart of ``gym_tpu/parallel/axis.py``).

In the JAX package the K simulated nodes are a mesh axis of one SPMD program
and a strategy's collectives are ``psum``/``pmean`` over it. Here the K nodes
are the leading dimension of every tensor, on one card, and the collectives
are reductions and gathers over dim 0. Each reduction is computed once and
broadcast, so every node receives bit-identical values (the property
DiLoCo's replicated outer step relies on).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class AxisCtx:
    """Collectives over the K simulated nodes, the leading dimension of
    every tensor passed in. Results keep that dimension: ``pmean`` returns
    [K, ...] with the same mean in every row (a broadcast view)."""

    num_nodes: int

    def psum(self, tree):
        """Sum across nodes (reference all_reduce SUM)."""
        return _map(lambda x: x.sum(dim=0, keepdim=True).expand_as(x), tree)

    def pmean(self, tree):
        """Mean across nodes (all_reduce SUM then /K)."""
        return _map(lambda x: x.mean(dim=0, keepdim=True).expand_as(x), tree)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Sum across nodes, node i receiving the i-th of K equal chunks:
        [K, K·c] → [K, c] (reference reduce_scatter SUM, ``psum_scatter``
        of a flat vector)."""
        k = x.shape[0]
        if x.shape[-1] % k:
            raise ValueError(f"reduce_scatter: length {x.shape[-1]} is not "
                             f"a multiple of the {k} nodes")
        return x.sum(dim=0).view(k, x.shape[-1] // k)

    def all_gather(self, tree):
        """Every node receives all K values: [K, ...] → [K, K, ...], ordered
        by node index."""
        return _map(lambda x: x.unsqueeze(0).expand(x.shape[0], *x.shape),
                    tree)

    def node_index(self, device=None) -> torch.Tensor:
        """Linear index of each simulated node, [K]."""
        return torch.arange(self.num_nodes, device=device)

    def broadcast_from(self, tree, src: int = 0):
        """Every node receives node ``src``'s value."""
        return _map(lambda x: x[src:src + 1].expand_as(x), tree)
