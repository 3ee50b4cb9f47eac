"""Elastic membership: map any checkpointed (K, layout) onto (K', layout')
(counterpart of ``gym_tpu/elastic/reshard.py``).

Two layers live here:

- the **ZeRO-2 checkpoint codec** (``make_zero2_codec``): when a strategy
  advertises ``shard_checkpoint`` (``ZeroReduceStrategy``), checkpoints
  store each node's 1/K slice of the flat parameter vector
  (``[K, ceil(n/K)]`` f32) instead of the stacked ``[K, n]``-worth of
  replicas, beside the moments, which are 1/K shards already: a step dir
  holds O(model) bytes where the stacked layout holds O(K·model).

- the **reshard path** (``reshard_state``): a checkpoint written at K
  nodes, restored as saved (host tensors in the saved shapes), is
  redistributed onto the live K'-node state. Every redistribution is a
  registry program (``programs/elastic_defs.py``), one a (K→K', shapes,
  dtype) signature, so a second resume at the same membership builds
  nothing. Flat ZeRO slices re-partition exactly (drop the old zero pad
  tail, re-pad for ceil(n/K')); AdamW's moments in the pad tail are
  exactly zero (the pad's gradient and parameter are), so K→K'→K
  round-trips bit-identical, the tail included.

The port's strategy state is not stacked the way the JAX package's is
(there every leaf carries the node axis; here DiLoCo's master and outer
optimizer, and every optimizer's step count, are one node-free copy), so
each leaf is classified against the fresh K'-node init, not by assuming
a leading node axis:

- a leaf whose shape is the live one's is carried over as is (node-free
  state; at an unchanged K, everything);
- a ``[K, ceil(n/K)]`` flat ZeRO slice whose live form is
  ``[K', ceil(n/K')]`` is re-partitioned;
- a ``[K, ...]`` leaf whose live form is ``[K', ...]`` is re-replicated,
  after checking that its rows are equal: per-node state that differs
  across rows (a mid-cycle DiLoCo replica, an error-feedback residual,
  per-node Adam moments) has no generic redistribution, and raises the
  typed ``NodeCountMismatchError`` instead of corrupting the trajectory;
- anything else raises the same error.

Per-node RNG is not carried across a membership change: node i's key is
``fold_in(PRNGKey(seed), i + 1)``, never mutated, so the fresh K'-node
init already holds exactly the keys a K'-node run has.

``reshard_events``/``cold_restart_events`` describe the membership change
as ``CollectiveEvent``s, so ``gym_tpu_torch.sim`` prices reshard against
cold restart on any topology preset.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..programs import default_registry
from ..programs.elastic_defs import (elastic_shard_size, replicate_rows_def,
                                     reshard_flat_def, unshard_params_def)
from ..strategy.base import CollectiveEvent
from ..strategy.sharding import ravel_order, take_shard
from ..strategy.zero_reduce import NodeCountMismatchError
from ..utils.checkpoint import STACKED_LAYOUT  # every per-node tensor [K, ...]

#: the other layout ``extra["elastic"]["layout"]`` records: flat param
#: shards [K, ceil(n/K)] beside the sharded optimizer state
ZERO2_LAYOUT = "zero2"

#: the parts of a checkpointed ``TrainState`` besides its params
_BODY = ("model_state", "strategy_state", "step", "rng")

LeafSpecs = List[Tuple[str, Tuple[int, ...], torch.dtype]]


def param_leaf_specs(stacked_params: Dict[str, torch.Tensor]
                     ) -> Tuple[LeafSpecs, int]:
    """``([(name, per-node shape, dtype), ...], n)`` of a stacked
    ``[K, ...]`` parameter dict in the ravel order (JAX's leaf order,
    ``strategy.sharding.ravel_order``): flat offsets line up with the ZeRO
    shards, and with ``gym_tpu``'s."""
    specs = [(name, tuple(stacked_params[name].shape[1:]),
              stacked_params[name].dtype)
             for name in ravel_order(stacked_params)]
    n = sum(int(math.prod(s)) for _, s, _ in specs)
    return specs, n


def elastic_meta(num_nodes: int, layout: str, n_params: int) -> dict:
    """The membership record a checkpoint carries in ``extra["elastic"]``:
    what the trainer peeks before it restores."""
    return {"num_nodes": int(num_nodes), "layout": str(layout),
            "n_params": int(n_params)}


# -- ZeRO-2 checkpoint codec (to_canon / from_canon) -----------------------


def make_zero2_codec(state_tree: Dict[str, Any], num_nodes: int,
                     registry=None):
    """``(to_canon, from_canon)`` for the ZeRO-2 checkpoint layout, over
    the trainer's checkpointed state tree (``{"params", "model_state",
    "strategy_state", "step", "rng"}``).

    ``to_canon(tree)`` → ``{"zero2": {...}}`` with the params as
    ``[K, ceil(n/K)]`` f32 flat shards: row i is slice i of the raveled
    per-node vector, which is right while the stacked params are replicas
    (ZeRO-1's all_gather makes them so). The rest passes through (the
    moments are 1/K shards already). f32 staging is lossless for every
    float dtype of at most 32 bits. ``from_canon`` inverts it through the
    registry's unshard program, on the shards' device."""
    reg = registry or default_registry()
    k = int(num_nodes)
    specs, n = param_leaf_specs(state_tree["params"])
    unshard = reg.acquire(unshard_params_def(specs, n, k, k), eager=True)

    def to_canon(tree):
        shards, _ = take_shard(tree["params"], k, torch.float32)
        return {"zero2": {"param_shards": shards,
                          **{key: tree[key] for key in _BODY}}}

    def from_canon(canon):
        z = canon["zero2"]
        return {"params": unshard(z["param_shards"]),
                **{key: z[key] for key in _BODY}}

    return to_canon, from_canon


# -- reshard: checkpointed (K, layout) → live (K', stacked) ----------------


def _mismatch(path: str, detail: str) -> NodeCountMismatchError:
    return NodeCountMismatchError(
        f"cannot reshard checkpointed state leaf {path}: {detail}")


def _replicate(reg, x: torch.Tensor, k_from: int, k_to: int,
               path: str) -> torch.Tensor:
    """Node-replicated state onto the new membership: check that the rows
    really are replicas, then repeat row 0 (a registry program)."""
    if k_from == k_to:
        return x
    if not torch.equal(x[:1].expand_as(x), x):
        raise _mismatch(
            path, f"rows differ across the {k_from} nodes (per-node "
            "state, not a replica) — this state has no generic "
            f"redistribution onto {k_to} nodes; resume at the original "
            "node count")
    pdef = replicate_rows_def(tuple(x.shape[1:]), k_from, k_to, x.dtype)
    return reg.acquire(pdef, eager=True)(x)


def reshard_state(raw: Dict[str, Any], saved: Optional[dict],
                  target: Dict[str, Any], registry=None) -> Dict[str, Any]:
    """Redistribute a restored checkpoint tree ``raw`` (written at
    ``saved["num_nodes"]`` nodes in ``saved["layout"]``, restored as saved)
    onto the layout of ``target``, the live state tree freshly initialised
    for K' nodes. Returns a tree in the live layout, on ``raw``'s device
    (the trainer places it on the live state's).

    Keeps from the checkpoint: params, model_state, strategy_state and
    step. Keeps from the fresh init: the per-node RNG when K changes.
    ``saved=None`` (a checkpoint without the record) means stacked at the
    K its params pin."""
    reg = registry or default_registry()
    k_to = int(target["rng"].shape[0])
    specs, n = param_leaf_specs(target["params"])
    saved = saved or {}
    if saved.get("layout", STACKED_LAYOUT) == ZERO2_LAYOUT:
        z = raw["zero2"]
        body = {key: z[key] for key in _BODY}
        shards = z["param_shards"]
        k_from = int(saved.get("num_nodes", shards.shape[0]))
        params = reg.acquire(unshard_params_def(specs, n, k_from, k_to),
                             eager=True)(shards.to(torch.float32))
    else:
        body = {key: raw[key] for key in _BODY}
        raw_params = raw["params"]
        k_from = int(saved.get("num_nodes",
                               next(iter(raw_params.values())).shape[0]))
        if set(raw_params) != set(target["params"]):
            raise _mismatch("params", "checkpointed parameter names do not "
                            "match the live model")
        params = {name: _replicate(reg, raw_params[name], k_from, k_to,
                                   f"params/{name}")
                  for name in target["params"]}
    s_from = elastic_shard_size(n, k_from)
    s_to = elastic_shard_size(n, k_to)

    def leaf(x, t, path):
        if isinstance(t, np.ndarray):
            return leaf(torch.from_numpy(np.asarray(x)), torch.from_numpy(t),
                        path).numpy()
        xs, ts = tuple(x.shape), tuple(t.shape)
        if xs == ts:
            return x
        if (xs == (k_from, s_from) and ts == (k_to, s_to)):
            # a flat ZeRO slice: re-partition the concatenated vector
            pdef = reshard_flat_def(n, k_from, k_to, x.dtype)
            return reg.acquire(pdef, eager=True)(x)
        if (len(xs) >= 1 and len(ts) >= 1 and xs[0] == k_from
                and ts[0] == k_to and xs[1:] == ts[1:]):
            return _replicate(reg, x, k_from, k_to, path)
        raise _mismatch(path, f"shape {xs} matches neither the live shape "
                        f"{ts}, a node-stacked form of it, nor a flat shard "
                        f"of {n} params")

    def walk(x, t, path):
        if torch.is_tensor(t) or isinstance(t, np.ndarray):
            if not (torch.is_tensor(x) or isinstance(x, np.ndarray)):
                raise _mismatch(path, f"a {type(x).__name__} where the live "
                                "state holds a tensor")
            return leaf(x, t, path)
        if isinstance(t, dict):
            if not isinstance(x, dict) or set(x) != set(t):
                raise _mismatch(path, "checkpointed tree structure does not "
                                "match the live state (another strategy or "
                                "model?)")
            return {key: walk(x[key], t[key], f"{path}/{key}") for key in t}
        if isinstance(t, (list, tuple)):
            if not isinstance(x, (list, tuple)) or len(x) != len(t):
                raise _mismatch(path, "checkpointed tree structure does not "
                                "match the live state")
            return type(t)(walk(a, b, f"{path}/{i}")
                           for i, (a, b) in enumerate(zip(x, t)))
        return x  # Python scalars (step counts) and None carry over

    return {
        "params": params,
        "model_state": walk(body["model_state"], target["model_state"],
                            "model_state"),
        "strategy_state": walk(body["strategy_state"],
                               target["strategy_state"], "strategy_state"),
        "step": body["step"],
        "rng": body["rng"] if k_from == k_to else target["rng"],
    }


# -- analytic pricing of the membership change -----------------------------


def reshard_events(n_params: int, k_from: int, k_to: int,
                   moment_vectors: int = 2) -> List[CollectiveEvent]:
    """The live reshard as collective events: re-partitioning the flat
    param + moment vectors is one all_gather of each (every node needs
    bytes from almost every old owner when the offsets shift), priced over
    the larger of the two memberships."""
    g = max(int(k_from), int(k_to), 2)
    b = 4.0 * float(n_params)
    return [
        CollectiveEvent("all_gather", b, g, label="elastic.params"),
        CollectiveEvent("all_gather", moment_vectors * b, g,
                        label="elastic.moments"),
    ]


def cold_restart_events(n_params: int, k_to: int,
                        moment_vectors: int = 2) -> List[CollectiveEvent]:
    """The alternative to resharding: a cold restart re-broadcasts the
    full replicated state to every one of the K' nodes (on top of the
    recomputed lost steps, which the caller prices separately)."""
    b = 4.0 * float(n_params) * (1 + moment_vectors)
    return [CollectiveEvent("broadcast", b, max(int(k_to), 2),
                            label="elastic.cold_restart")]
