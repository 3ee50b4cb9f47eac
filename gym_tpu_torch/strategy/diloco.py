"""DiLoCo: inner optimizer every step, outer Nesterov step every H steps
(counterpart of ``gym_tpu/strategy/diloco.py``).

Every H steps (gate ``step % H == 0 and step > 0`` on the pre-increment
step, after the inner update) the nodes average their params, the outer
pseudo-gradient is ``master − mean``, an outer SGD (lr 0.7, Nesterov,
momentum 0.9 by default) steps the master, and every node restarts from it.

The JAX package keeps the master and outer momentum replicated on every
node, bit-identical because every node computes the same step from the same
mean. Here they are stored once (no node dimension): the node mean is
computed once and every node receives the same new master, so the replicas
cannot drift. Only the replicated outer state with full participation and
no codec is ported in this slice; the rest raises.
"""

from __future__ import annotations

from typing import List, Optional, Union

from .base import CollectiveEvent, tree_bytes
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .optim import OptimSpec, apply_updates, ensure_optim_spec


def ring_bytes(group, per_node_bytes):
    """All-reduce ring cost over the group: 2(a−1)/a · bytes."""
    return 2.0 * (group - 1) / max(group, 1) * per_node_bytes


def _later_slice(what: str):
    return NotImplementedError(
        f"DiLoCo {what} is ported in a later slice of gym_tpu_torch "
        f"(ROADMAP Queue A, Slice 2)")


class DiLoCoCommunicator(CommunicationModule):
    """Outer-loop model averaging + outer Nesterov step on a master stored
    once for all nodes."""

    def __init__(
        self,
        H: int = 100,
        outer_optim_spec: Optional[Union[str, OptimSpec]] = None,
        shard_outer: bool = False,
        participation: float = 1.0,
        fault_seed: int = 5678,
        codec=None,
        codec_seed: int = 1206,
        error_feedback: Optional[bool] = None,
        **codec_kwargs,
    ):
        if not 0.0 < participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {participation}")
        if shard_outer:
            raise _later_slice("shard_outer (node-sharded outer state)")
        if participation < 1.0:
            raise _later_slice("participation < 1 (simulated failures)")
        if codec is not None or error_feedback is not None or codec_kwargs:
            raise _later_slice("codec (compressed outer delta)")
        self.H = int(H)
        self.outer_optim_spec = ensure_optim_spec(
            outer_optim_spec,
            OptimSpec("sgd", lr=0.7, nesterov=True, momentum=0.9),
        )
        self.outer_tx = self.outer_optim_spec.build()

    def init(self, params):
        # replicas start identical, so node 0's params are the master
        master = {n: p[0].clone() for n, p in params.items()}
        return {"master": master, "outer_opt": self.outer_tx.init(master)}

    def communicate(self, params, mstate, step, ctx):
        if not (step % self.H == 0 and step > 0):
            return params, mstate, 0.0
        k = ctx.num_nodes
        psize = float(tree_bytes(params) // k)
        master = mstate["master"]
        # outer pseudo-gradient: master − node mean (computed once)
        pseudo = {n: master[n] - p.mean(dim=0) for n, p in params.items()}
        updates, outer_opt = self.outer_tx.update(pseudo, mstate["outer_opt"],
                                                  master)
        master = apply_updates(master, updates)
        # every node restarts from the new master
        new_params = {n: m.unsqueeze(0).repeat(k, *([1] * m.dim()))
                      for n, m in master.items()}
        return (new_params, {"master": master, "outer_opt": outer_opt},
                ring_bytes(k, psize))

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        if num_nodes <= 1 or not (step % self.H == 0 and step > 0):
            return []
        return [CollectiveEvent("all_reduce", float(tree_bytes(params)),
                                num_nodes, label="outer_avg")]

    def config(self):
        return {"module": "DiLoCoCommunicator", "H": self.H,
                "outer_optimizer": self.outer_optim_spec.name,
                "outer_lr": self.outer_optim_spec.lr}


class DiLoCoStrategy(CommunicateOptimizeStrategy):
    """Inner optimizer (default AdamW) + DiLoCo outer loop."""

    def __init__(
        self,
        optim_spec: Optional[Union[str, OptimSpec]] = None,
        outer_optim_spec: Optional[Union[str, OptimSpec]] = None,
        H: int = 100,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
        shard_outer: bool = False,
        participation: float = 1.0,
        codec=None,
        error_feedback: Optional[bool] = None,
        **codec_kwargs,
    ):
        self.H = int(H)
        super().__init__(
            communication_modules=[
                DiLoCoCommunicator(H=H, outer_optim_spec=outer_optim_spec,
                                   shard_outer=shard_outer,
                                   participation=participation,
                                   codec=codec,
                                   error_feedback=error_feedback,
                                   **codec_kwargs)
            ],
            inner_optim=ensure_optim_spec(optim_spec, OptimSpec("adamw")),
            max_norm=max_norm,
            lr_scheduler=lr_scheduler,
            lr_scheduler_kwargs=lr_scheduler_kwargs,
        )

    def config(self):
        cfg = super().config()
        cfg["H"] = self.H
        return cfg
