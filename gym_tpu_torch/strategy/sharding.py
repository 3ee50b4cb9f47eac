"""Flat-vector 1/K sharding of ZeRO-1's optimizer state
(counterpart of ``gym_tpu/strategy/sharding.py:24-44``).

A node's tree is raveled into one flat vector in ``jax.tree.flatten``'s
order (``convert.jax_leaf_order``), zero-padded to K·shard, and node i keeps
the shard-sized slice i: a ``[K, shard]`` tensor over the node dimension.
``unshard`` reassembles the tree from every node's slice (the all_gather).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..convert import jax_leaf_order

Tree = Dict[str, torch.Tensor]


def ravel_order(tree: Tree) -> List[str]:
    """The names of a tree in the order its leaves are raveled."""
    order = jax_leaf_order(tree)
    return sorted(tree, key=order.__getitem__)


def shard_size(params: Tree, k: int) -> int:
    """ceil(per-node parameter count / K) of node-stacked ``params``; the
    last shard is zero-padded."""
    n = sum(p[0].numel() for p in params.values())
    return -(-n // k)


def ravel_nodes(tree: Tree, k: int, dtype=torch.float32) -> torch.Tensor:
    """Every node's raveled tree: [K, n]."""
    return torch.cat([tree[n].reshape(k, -1).to(dtype)
                      for n in ravel_order(tree)], dim=1)


def ravel(tree: Tree, k: int, dtype=torch.float32) -> torch.Tensor:
    """Every node's raveled tree, zero-padded: [K, K·shard]."""
    flat = ravel_nodes(tree, k, dtype)
    pad = k * shard_size(tree, k) - flat.shape[1]
    return torch.nn.functional.pad(flat, (0, pad))


def unravel_nodes(flat: torch.Tensor, like: Tree) -> Tree:
    """Inverse of ``ravel_nodes``: [K, n] → a node-stacked tree with the
    names, shapes and dtypes of node-stacked ``like``."""
    out, off = {}, 0
    for name in ravel_order(like):
        ref = like[name]
        size = ref[0].numel()
        out[name] = flat[:, off:off + size].reshape(ref.shape).to(ref.dtype)
        off += size
    return {name: out[name] for name in like}


def take_shard(tree: Tree, k: int,
               dtype=torch.float32) -> Tuple[torch.Tensor, int]:
    """``([K, shard], n)``: row i is slice i of node i's raveled tree, n the
    unpadded length. Each slice is cut from the leaves it overlaps, so the
    K full ravels are never built."""
    shard = shard_size(tree, k)
    names = ravel_order(tree)
    sizes = [tree[n][0].numel() for n in names]
    rows = []
    for i in range(k):
        lo, hi, off, parts = i * shard, (i + 1) * shard, 0, []
        for name, size in zip(names, sizes):
            a, b = max(lo, off), min(hi, off + size)
            if a < b:
                parts.append(tree[name][i].reshape(-1)[a - off:b - off])
            off += size
        row = (torch.cat(parts).to(dtype) if parts else
               torch.zeros(0, dtype=dtype, device=tree[names[0]].device))
        rows.append(torch.nn.functional.pad(row, (0, shard - row.numel())))
    return torch.stack(rows), sum(sizes)


def unshard(shards: torch.Tensor, n: int, like: Tree) -> Tree:
    """The per-node tree (no node dimension) assembled from every node's
    slice, in node order; names, shapes and dtypes from node-stacked
    ``like``."""
    flat = shards.reshape(-1)[:n]
    out, off = {}, 0
    for name in ravel_order(like):
        ref = like[name][0]
        out[name] = flat[off:off + ref.numel()].view(ref.shape).to(ref.dtype)
        off += ref.numel()
    return {name: out[name] for name in like}
