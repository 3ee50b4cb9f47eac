"""SPARTA: sparse parameter gossip, a random fraction p of the parameters
averaged each step (counterpart of ``gym_tpu/strategy/sparta.py``).

Every node derives the same mask from a key folded with the leaf's index
and the iteration, so no mask is broadcast; the exchange is dense masked
arithmetic, ``where(mask, mean(θ), θ)``. The masks are JAX's, bit for bit
(``ops/threefry.py``): drawn over the per-node shape (one mask shared by
the K nodes), with each leaf keyed by its index in ``jax.tree.flatten``'s
order (``convert.jax_leaf_order``), not by its place in the port's dict.
On the card the Bernoulli masks come from the fused threefry kernel
(``csrc/threefry.cu``), every leaf's in one launch a step
(``RandomIndexSelector.masks``). ``comm_bytes`` counts the realized masked
bytes, so it stays on the device as a 0-d tensor.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..convert import jax_leaf_order
from ..ops import threefry
from .base import CollectiveEvent
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .faults import (alive_tensor, host_participation, masked_mean,
                     mean_ring_tx, participation_round)
from .optim import OptimSpec


class IndexSelector:
    """Base mask generator: selects all indices."""

    def __init__(self, p: float, seed: int = 7):
        self.p = float(p)
        self.seed = int(seed)
        self._keys: Dict[int, threefry.Key] = {}

    def _leaf_key(self, leaf_idx: int) -> threefry.Key:
        key = self._keys.get(leaf_idx)
        if key is None:
            key = threefry.fold_in(threefry.PRNGKey(self.seed), leaf_idx)
            key = self._keys[leaf_idx] = threefry.fold_in(key, 0)
        return key

    def mask(self, x: torch.Tensor, leaf_idx: int,
             iteration: int) -> torch.Tensor:
        """Bool mask of ``x``'s shape (a per-node tensor) on its device."""
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)

    def masks(self, params, iteration: int):
        """One mask per leaf of a per-node tree."""
        order = jax_leaf_order(params)
        return {n: self.mask(x, order[n], iteration)
                for n, x in params.items()}


class RandomIndexSelector(IndexSelector):
    """Bernoulli(p) mask per step."""

    def __init__(self, p: float, seed: int = 7):
        super().__init__(p, seed)
        self._tables: Dict[int, np.ndarray] = {}

    def mask(self, x, leaf_idx, iteration):
        key = threefry.fold_in(self._leaf_key(leaf_idx), iteration)
        return threefry.bernoulli(key, self.p, x.numel(),
                                  x.device).view(x.shape)

    def masks(self, params, iteration: int):
        """Every leaf's mask in one draw: the leaf keys (a cached [L, 2]
        table in JAX leaf order) folded with the iteration in one
        ``fold_in_rows``, one ``bernoulli_segments`` launch on the card."""
        order = jax_leaf_order(params)
        table = self._tables.get(len(order))
        if table is None:
            table = self._tables[len(order)] = threefry.key_table(
                [self._leaf_key(i) for i in range(len(order))])
        names = list(params)
        keys = threefry.fold_in_rows(table, iteration)[
            [order[n] for n in names]]
        x = params[names[0]]
        _, views = threefry.bernoulli_segments(
            keys, self.p, [params[n].numel() for n in names], x.device)
        return {n: v.view(params[n].shape) for n, v in zip(names, views)}


class ShuffledSequentialIndexSelector(IndexSelector):
    """A fixed shuffled order, cycled in ⌈1/p⌉ chunks, one per iteration
    (chunk sizes differ by at most 1). The order's key does not depend on
    the iteration, so each leaf's positions are built once and kept (int32,
    4 bytes an element)."""

    def __init__(self, p: float, seed: int = 7):
        super().__init__(p, seed)
        self._pos: Dict[tuple, torch.Tensor] = {}

    def mask(self, x, leaf_idx, iteration):
        n = x.numel()
        if n == 0:
            return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        num_partitions = max(1, math.ceil(1.0 / self.p))
        cache = (leaf_idx, n, x.device)
        pos = self._pos.get(cache)
        if pos is None:
            perm = threefry.permutation(self._leaf_key(leaf_idx), n,
                                        x.device)
            pos = self._pos[cache] = threefry.inverse_permutation(perm)
        chunk = iteration % num_partitions
        chunk_size, rem = divmod(n, num_partitions)
        start = chunk * chunk_size + min(chunk, rem)
        end = start + chunk_size + (chunk < rem)
        return ((pos >= start) & (pos < end)).view(x.shape)


class PartitionedIndexSelector(IndexSelector):
    """A random partition into ⌈1/p⌉ cells, one cell per iteration,
    re-drawn each full cycle: ``argsort(uniform) mod cells``. Uniforms tie
    (2²³ values), so the sort is stable, as JAX's is."""

    def mask(self, x, leaf_idx, iteration):
        n = x.numel()
        if n == 0:
            return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        num_partitions = max(1, min(math.ceil(1.0 / self.p), n))
        cycle, curr = divmod(iteration, num_partitions)
        key = threefry.fold_in(self._leaf_key(leaf_idx), cycle)
        u = threefry.uniform(key, n, x.device)
        cell = torch.sort(u, stable=True).indices % num_partitions
        return (cell == curr).view(x.shape)


class SparseCommunicator(CommunicationModule):
    """Masked parameter averaging every ``interval`` steps.
    ``participation < 1`` drops a shared-PRNG subset of nodes from each
    exchange: they neither contribute to nor receive it."""

    def __init__(self, index_selector: IndexSelector, interval: int = 1,
                 participation: float = 1.0, fault_seed: int = 5678):
        if not 0.0 < participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {participation}")
        self.index_selector = index_selector
        self.interval = int(interval)
        self.participation = float(participation)
        self.fault_seed = fault_seed

    def communicate(self, params, mstate, step, ctx):
        k = ctx.num_nodes
        if k == 1 or step % self.interval:
            return params, mstate, 0.0
        iteration = step // self.interval
        alive, group = participation_round(self.fault_seed, step,
                                           self.participation, k)
        dev = next(iter(params.values())).device
        if self.participation < 1.0:
            alive_t = alive_tensor(alive, dev)
            avg = masked_mean(params, alive_t)
        else:
            avg = {n: p.mean(dim=0) for n, p in params.items()}
        masks = self.index_selector.masks(
            {n: p[0] for n, p in params.items()}, iteration)
        new_params, nbytes = {}, 0
        for name, p in params.items():
            m = masks[name]
            nbytes = nbytes + m.sum() * p.element_size()
            if self.participation < 1.0:
                m = m & alive_t.view(-1, *([1] * m.dim()))
            new_params[name] = torch.where(m, avg[name], p)
        # dead nodes transmit nothing: the node mean is frac × the alive cost
        return new_params, mstate, mean_ring_tx(group, group / k, nbytes)

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        if num_nodes <= 1 or step % self.interval:
            return []
        # the masks are deterministic in (seed, leaf, iteration): count the
        # realized bytes, as the step's comm_bytes does
        iteration = step // self.interval
        masks = self.index_selector.masks(params, iteration)
        nbytes = float(sum(int(masks[n].sum()) * p.element_size()
                           for n, p in params.items()))
        group, frac = host_participation(self.fault_seed, step, num_nodes,
                                         self.participation)
        tx = None if frac >= 1.0 else mean_ring_tx(group, frac, nbytes)
        return [CollectiveEvent("all_reduce", nbytes, group,
                                label="sparse_avg", tx_bytes=tx)]

    def config(self):
        cfg = {"module": "SparseCommunicator",
               "p_sparta": self.index_selector.p,
               "selector": type(self.index_selector).__name__,
               "interval": self.interval}
        if self.participation < 1.0:
            cfg["participation"] = self.participation
        return cfg


class SPARTAStrategy(CommunicateOptimizeStrategy):
    """Inner optimizer + sparse exchange."""

    def __init__(
        self,
        inner_optim: Optional[Union[str, OptimSpec]] = None,
        p_sparta: float = 0.005,
        index_selector: Optional[IndexSelector] = None,
        interval: int = 1,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
        participation: float = 1.0,
    ):
        selector = index_selector or RandomIndexSelector(p_sparta)
        super().__init__(
            communication_modules=[
                SparseCommunicator(selector, interval,
                                   participation=participation)
            ],
            inner_optim=inner_optim,
            max_norm=max_norm,
            lr_scheduler=lr_scheduler,
            lr_scheduler_kwargs=lr_scheduler_kwargs,
        )
        self.p_sparta = p_sparta
        self.index_selector = selector
        self.interval = int(interval)
