"""SimpleReduce: synchronous data-parallel AllReduce (DDP equivalent),
counterpart of ``gym_tpu/strategy/simple_reduce.py``: one gradient mean over
the nodes, clip, optimizer step. A ring all-reduce moves ``2·(K−1)/K ×
|grads|`` bytes per node per step.
"""

from __future__ import annotations

from typing import List, Optional, Union

from .base import (CollectiveEvent, Strategy, comm_metric, require_finalized,
                   tree_bytes)
from .optim import OptimSpec, apply_updates, ensure_optim_spec


class SimpleReduceStrategy(Strategy):
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
        return {"opt": self.tx.init(params)}

    def step(self, grads, params, state, step, ctx):
        grads = ctx.pmean(grads)
        grads = self._maybe_clip(grads, ctx)
        updates, opt_state = self.tx.update(grads, state["opt"], params)
        params = apply_updates(params, updates)
        k = ctx.num_nodes
        comm = 2.0 * (k - 1) / max(k, 1) * (tree_bytes(grads) // k)
        return params, {"opt": opt_state}, {"comm_bytes": comm_metric(comm)}

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        return [CollectiveEvent("all_reduce", float(tree_bytes(params)),
                                num_nodes, label="grads")]
