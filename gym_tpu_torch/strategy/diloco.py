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
cannot drift. ``participation < 1`` averages only a shared-PRNG subset of
nodes (``faults.py``); the master still steps once for all, and the dead
nodes keep their params. ``shard_outer`` is the JAX package's layout in
which node i keeps and steps only slice i of the master and momentum, and
one all_gather reassembles the master: 3(K−1)/K·|θ| a round. Its outer
update is elementwise, so the values are the replicated path's; stored
once, the replicated state already takes one model's bytes. The port runs
the replicated path for it and counts the sharded schedule's bytes.

``codec`` ships each node's outer delta ``θ_i − master`` through a
``CompressedLink`` (``compress.py``) with a per-node error-feedback residual
``[K, n]`` and per-node rounding keys (the node index folded in); the round
average is ``master + mean(deltâ)`` and costs 2(K−1)/K of the link's wire
bytes. It needs the replicated outer state and full participation, as in
the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Union

from .base import CollectiveEvent, tree_bytes, tree_num_params
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .compress import CompressedLink
from .faults import (alive_tensor, host_participation, masked_mean,
                     mean_ring_tx, participation_round, sync_alive)
from .optim import OptimSpec, apply_updates, ensure_optim_spec
from .sharding import ravel_nodes, unshard


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
        if shard_outer and participation < 1.0:
            # a failed node could not serve its master shard for the
            # all_gather that reassembles the master
            raise ValueError(
                "shard_outer=True cannot be combined with participation<1: "
                "dead nodes would still have to serve their master shard. "
                "Use the replicated outer state for fault simulation.")
        self.link = CompressedLink(codec, seed=codec_seed,
                                   error_feedback=error_feedback,
                                   **codec_kwargs)
        if self.link.compressed and shard_outer:
            raise ValueError(
                "codec cannot be combined with shard_outer=True: the "
                "compressed outer delta needs the replicated outer state")
        if self.link.compressed and participation < 1.0:
            raise ValueError(
                "codec cannot be combined with participation<1: a dead "
                "node's error-feedback residual would silently freeze")
        self.H = int(H)
        self.shard_outer = bool(shard_outer)
        self.participation = float(participation)
        self.fault_seed = fault_seed
        self.outer_optim_spec = ensure_optim_spec(
            outer_optim_spec,
            OptimSpec("sgd", lr=0.7, nesterov=True, momentum=0.9),
        )
        self.outer_tx = self.outer_optim_spec.build()

    def init(self, params):
        # replicas start identical, so node 0's params are the master
        master = {n: p[0].clone() for n, p in params.items()}
        first = next(iter(params.values()))
        return {"master": master, "outer_opt": self.outer_tx.init(master),
                **self.link.init(tree_num_params(master), first.shape[0],
                                 first.device)}

    def communicate(self, params, mstate, step, ctx):
        if not (step % self.H == 0 and step > 0):
            return params, mstate, 0.0
        k = ctx.num_nodes
        if self.link.compressed:
            return self._communicate_compressed(params, mstate, step, k)
        psize = float(tree_bytes(params) // k)
        alive, group = participation_round(self.fault_seed, step,
                                           self.participation, k)
        if self.participation < 1.0:
            alive_t = alive_tensor(alive,
                                   next(iter(params.values())).device)
            avg = masked_mean(params, alive_t)
        else:
            avg = {n: p.mean(dim=0) for n, p in params.items()}
        master = mstate["master"]
        # outer pseudo-gradient: master − node mean (computed once)
        pseudo = {n: master[n] - avg[n] for n in master}
        updates, outer_opt = self.outer_tx.update(pseudo, mstate["outer_opt"],
                                                  master)
        master = apply_updates(master, updates)
        new_state = {"master": master, "outer_opt": outer_opt}
        if self.participation < 1.0:
            # a dead node misses the sync and keeps its local params
            return (sync_alive(master, params, alive_t), new_state,
                    mean_ring_tx(group, group / k, psize))
        # shard_outer: the round average, then the all_gather of the
        # master's K slices
        comm = (3.0 * (k - 1) / k * psize if self.shard_outer
                else mean_ring_tx(k, 1.0, psize))
        return on_every_node(master, k), new_state, comm

    def _communicate_compressed(self, params, mstate, step, k):
        """Each node's outer delta through the link; the round average is
        the master plus the node mean of the delivered deltas."""
        master = mstate["master"]
        flat_p = ravel_nodes(params, k)
        flat_m = ravel_nodes({n: m.unsqueeze(0) for n, m in master.items()},
                             1)
        lstate = ({"ef_residual": mstate["ef_residual"]}
                  if self.link.error_feedback else {})
        delta_hat, lstate = self.link.send(flat_p - flat_m, lstate,
                                           self.link.node_keys(step, k))
        avg_flat = flat_m + delta_hat.mean(dim=0, keepdim=True)
        avg = unshard(avg_flat, avg_flat.shape[1], params)
        pseudo = {n: master[n] - avg[n] for n in master}
        updates, outer_opt = self.outer_tx.update(pseudo, mstate["outer_opt"],
                                                  master)
        master = apply_updates(master, updates)
        comm = 2.0 * (k - 1) / k * self.link.wire_bytes(flat_p.shape[1])
        return (on_every_node(master, k),
                {"master": master, "outer_opt": outer_opt, **lstate}, comm)

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        if num_nodes <= 1 or not (step % self.H == 0 and step > 0):
            return []
        psize = float(tree_bytes(params))
        if self.link.compressed:
            # the node mean of the compressed outer deltas, at the link's
            # wire bytes
            return [CollectiveEvent(
                "all_reduce", self.link.wire_bytes(tree_num_params(params)),
                num_nodes, label="outer_delta_compressed")]
        if self.shard_outer:
            # round average + the all_gather of the sharded master
            return [CollectiveEvent("all_reduce", psize, num_nodes,
                                    label="outer_avg"),
                    CollectiveEvent("all_gather", psize, num_nodes,
                                    label="outer_master")]
        group, frac = host_participation(self.fault_seed, step, num_nodes,
                                         self.participation)
        tx = None if frac >= 1.0 else mean_ring_tx(group, frac, psize)
        return [CollectiveEvent("all_reduce", psize, group,
                                label="outer_avg", tx_bytes=tx)]

    def config(self):
        cfg = {"module": "DiLoCoCommunicator", "H": self.H,
               "outer_optimizer": self.outer_optim_spec.name,
               "outer_lr": self.outer_optim_spec.lr}
        if self.shard_outer:
            cfg["shard_outer"] = True
        if self.participation < 1.0:
            cfg["participation"] = self.participation
        if self.link.compressed:
            cfg.update(self.link.config())
        return cfg


def on_every_node(tree, k):
    """Every node restarts from the same values: [K, ...] copies."""
    return {n: m.unsqueeze(0).repeat(k, *([1] * m.dim()))
            for n, m in tree.items()}


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
