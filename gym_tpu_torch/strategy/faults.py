"""Simulated node failures: partial participation (counterpart of
``gym_tpu/strategy/faults.py``).

Every communication round a shared-PRNG subset of the K nodes is down: they
neither contribute to nor receive that round's exchange and keep their local
params. The draw is JAX's, bit for bit (``ops/threefry.py``): node i is alive
iff ``u_i < rate`` with ``u = uniform(fold_in(PRNGKey(seed), round), K)``,
and the node of smallest ``u`` (the first on ties) is forced alive. K draws
are host work, so the draw, the alive count and the node-mean comm bytes
are all known on the host; only the alive mask goes to the device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..ops import threefry


@functools.lru_cache(maxsize=1024)
def alive_mask(seed: int, round_index: int, k: int,
               rate: float) -> Tuple[bool, ...]:
    """[k] alive flags, the same for every node."""
    key = threefry.fold_in(threefry.PRNGKey(seed), round_index)
    u = threefry.uniform(key, k, "cpu").tolist()
    r = float(np.float32(rate))
    first_min = min(range(k), key=u.__getitem__)
    return tuple(x < r or i == first_min for i, x in enumerate(u))


def participation_round(seed: int, step: int, rate: float,
                        k: int) -> Tuple[Tuple[bool, ...], int]:
    """One fault draw for a round: ``(alive flags, alive count)``; with
    ``rate >= 1`` every node is alive."""
    if rate >= 1.0:
        return (True,) * k, k
    alive = alive_mask(seed, int(step), k, rate)
    return alive, sum(alive)


def host_participation(seed: int, step: int, k: int, rate: float):
    """``(alive count, alive fraction)`` of the round's draw."""
    alive, group = participation_round(seed, step, rate, k)
    return group, group / k


def ring_bytes(group, per_node_bytes):
    """All-reduce ring cost over the alive group: 2(a−1)/a · bytes."""
    return 2.0 * (group - 1) / max(group, 1) * per_node_bytes


def mean_ring_tx(group: int, frac: float, nbytes):
    """Node-mean ring bytes under partial participation: alive nodes pay
    ``ring_bytes(group, nbytes)``, dead nodes 0 (the logged metric is the
    mean over nodes, as ``gym_tpu``'s trainer logs it)."""
    return frac * ring_bytes(group, nbytes)


def host_values(values, dtype, device) -> torch.Tensor:
    """A small host list on ``device``. To the card it goes from pinned
    memory without blocking: a copy from pageable memory would wait for
    all the work queued on the stream, and the host would lose its lead."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def alive_tensor(alive, device) -> torch.Tensor:
    return host_values(alive, torch.bool, device)


def _node_view(flags: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return flags.view(-1, *([1] * (x.dim() - 1)))


def sync_alive(new, old, alive: torch.Tensor):
    """Dead nodes miss the round: keep ``old`` on them. ``new`` leaves may
    lack the node dimension (one value for every node)."""
    return {n: torch.where(_node_view(alive, o), new[n], o)
            for n, o in old.items()}


def masked_mean(tree, alive: torch.Tensor):
    """Mean over the alive nodes, computed once (no node dimension):
    ``sum(alive·x) / sum(alive)`` in float32, cast back to each leaf's
    dtype."""
    w = alive.to(torch.float32)
    denom = w.sum()
    return {n: ((x.to(torch.float32) * _node_view(w, x)).sum(dim=0)
                / denom).to(x.dtype)
            for n, x in tree.items()}
