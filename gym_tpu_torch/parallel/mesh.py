"""Node runtime on one card (the single-GPU subset of
``gym_tpu/parallel/mesh.py:NodeRuntime``).

The JAX runtime shards the K simulated nodes over a device mesh and vmaps
the rest. Here all K nodes live on one device as the leading dimension of
every tensor, and PyTorch runs eagerly, so there is no program to compile:
the runtime only carries the device and the collective context.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .axis import AxisCtx


@dataclasses.dataclass
class NodeRuntime:
    num_nodes: int
    device: torch.device
    ctx: AxisCtx

    @classmethod
    def create(cls, num_nodes: int, device) -> "NodeRuntime":
        return cls(num_nodes=num_nodes, device=torch.device(device),
                   ctx=AxisCtx(num_nodes=num_nodes))

    def init_state(self, init_fn: Callable[[torch.Tensor], Any]):
        """``init_fn(node_index [K]) -> state`` with every tensor [K, ...]."""
        return init_fn(self.ctx.node_index(self.device))

    def to_host(self, tree):
        if isinstance(tree, dict):
            return {k: self.to_host(v) for k, v in tree.items()}
        return tree.detach().cpu() if torch.is_tensor(tree) else tree

    def average_over_nodes(self, tree):
        """Uniform average over the node dimension, on the host (numpy), of
        a tensor or a tree of nested dicts: the single-process path of
        ``gym_tpu``'s ``NodeRuntime.average_over_nodes``, whose integer
        leaves are averaged in float64 and cast back."""
        if isinstance(tree, dict):
            return {k: self.average_over_nodes(v) for k, v in tree.items()}
        x = tree.detach().cpu().numpy() if torch.is_tensor(tree) \
            else np.asarray(tree)
        if np.issubdtype(x.dtype, np.integer) or x.dtype == np.bool_:
            return x.astype(np.float64).mean(axis=0).astype(x.dtype)
        return x.mean(axis=0)
