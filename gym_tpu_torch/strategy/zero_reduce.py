"""ZeRO-1 data parallelism: DDP with the optimizer state sharded over the
nodes (counterpart of ``gym_tpu/strategy/zero_reduce.py``).

The gradient is reduce-scattered over the node dimension, each node updates
only its 1/K slice of the flat parameter vector with its 1/K slice of the
optimizer state, and the updated slices are reassembled with one all_gather.
The optimizer state is ``[K, shard]``: the moments of all K nodes together
take one model's bytes, where SimpleReduce's take K models'. Clipping keeps
SimpleReduce's semantics (after the mean, by the global norm), the norm
assembled from the chunk norms with one scalar sum. This is the JAX
package's canonical schedule, which its single node axis runs:
``comm_bytes`` is (K−1)/K·(|g| + |θ|).
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .base import (CollectiveEvent, Strategy, StrategyLifecycleError,
                   comm_metric, require_finalized, tree_bytes)
from .optim import OptimSpec, ensure_optim_spec
from .sharding import ravel, shard_size, take_shard, unshard


class NodeCountMismatchError(StrategyLifecycleError):
    """Sharded state built for K nodes was fed to a step on K' != K: the
    optimizer state's shard size pins the node count it was built at."""


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


class ZeroReduceStrategy(Strategy):
    def __init__(
        self,
        optim_spec: Optional[Union[str, OptimSpec]] = None,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
    ):
        super().__init__(lr_scheduler, lr_scheduler_kwargs, max_norm)
        self.optim_spec = ensure_optim_spec(optim_spec, OptimSpec("adamw"))
        self.tx = None

    def _build(self):
        self.tx = self.optim_spec.build(self._lr_scale)

    def init(self, params):
        require_finalized(self)
        if self._ctx is None:
            raise StrategyLifecycleError(
                "ZeroReduceStrategy shards optimizer state across the nodes "
                "and must know their number: pass ctx to make_init_fn (the "
                "Trainer does) or call strategy.bind_ctx(runtime.ctx).")
        k = self._ctx.num_nodes
        dev = next(iter(params.values())).device
        shard = torch.zeros(k, shard_size(params, k), dtype=torch.float32,
                            device=dev)
        return {"opt": self.tx.init({"flat": shard})}

    def step(self, grads, params, state, step, ctx):
        k = ctx.num_nodes
        shard = shard_size(params, k)
        saved = {x.shape[1] for x in _tensors(state["opt"]) if x.dim() == 2}
        if saved and saved != {shard}:
            raise NodeCountMismatchError(
                f"ZeRO optimizer state holds shards of {sorted(saved)} "
                f"elements but the step has num_nodes={k} (shard size "
                f"{shard}). The state was built for a different node count: "
                f"run at the original K.")
        # reduce-scatter: node i receives the i-th chunk of the summed
        # gradient, then its mean
        g_my = ctx.reduce_scatter(ravel(grads, k)) / k
        if self.max_norm:
            norm = torch.sqrt(g_my.square().sum(dim=1).sum())
            g_my = g_my * torch.clamp(self.max_norm / (norm + 1e-6), max=1.0)
        # this node's 1/K slice: optimizer state exists only for it
        p_my, n = take_shard(params, k)
        updates, opt_state = self.tx.update({"flat": g_my}, state["opt"],
                                            {"flat": p_my})
        p_my = p_my + updates["flat"]
        # all_gather: every node reassembles the full parameters
        full = unshard(p_my, n, params)
        new_params = {name: v.unsqueeze(0).repeat(k, *([1] * v.dim()))
                      for name, v in full.items()}
        comm = (k - 1) / k * (tree_bytes(grads) // k + tree_bytes(params)
                              // k)
        return new_params, {"opt": opt_state}, {"comm_bytes":
                                                 comm_metric(comm)}

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        nbytes = float(tree_bytes(params))  # |g| == |θ|
        return [CollectiveEvent("reduce_scatter", nbytes, num_nodes,
                                label="grads"),
                CollectiveEvent("all_gather", nbytes, num_nodes,
                                label="params")]
