"""Weights from the JAX package: the flax param tree, as numpy, into the
port's parameters.

Neither the init nor the threefry keys of the JAX package can be matched in
PyTorch, so both packages start from the same weights this way: a flax tree
``{"h_0": {"attn": {"c_attn": {"kernel": ...}}}, ...}`` becomes the port's
flat dict ``{"h_0.attn.c_attn.kernel": ...}``, stacked over the K simulated
nodes. Kernels keep flax's layouts: dense ``[in, out]``, conv HWIO ``[kh,
kw, in, out]``. Non-parameter collections (BatchNorm's ``batch_stats``)
keep their collection names above the flat dict.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import numpy as np
import torch


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts → {"a.b.c": leaf}, leaves as numpy arrays."""
    out: Dict[str, np.ndarray] = {}
    for key in tree:
        val = tree[key]
        name = f"{prefix}{key}"
        if hasattr(val, "keys"):
            out.update(flatten_tree(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def jax_leaf_order(names: Iterable[str]) -> Dict[str, int]:
    """The index ``jax.tree.flatten`` gives each flat name's leaf in the
    nested tree: dict keys sorted at every level (``h_0, h_1, h_10, ...,
    ln_f, wpe, wte``), where the port's dicts keep flax's insertion order.
    What a leaf's random draws are keyed by (SPARTA's masks) and the order
    a tree is raveled in (ZeRO's and DiLoCo's flat shards)."""
    ordered = sorted(names, key=lambda n: n.split("."))
    return {n: i for i, n in enumerate(ordered)}


def params_from_jax(tree: Any, num_nodes: int = 1,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """The port's f32 parameters from one node's flax param tree: every
    leaf copied to each of the ``num_nodes`` nodes, ``[K, ...]``."""
    out = {}
    for name, arr in flatten_tree(tree).items():
        t = torch.as_tensor(np.array(arr, dtype=np.float32))
        out[name] = t.to(device).unsqueeze(0).repeat(
            num_nodes, *([1] * t.dim())).contiguous()
    return out


def model_state_from_jax(tree: Any, num_nodes: int = 1,
                         device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's model state from one node's flax non-parameter
    collections, ``{"batch_stats": {"CNN_0": {"BatchNorm_0": {"mean": ...}}}}``
    → ``{"batch_stats": {"CNN_0.BatchNorm_0.mean": [K, ...]}}``, each leaf
    copied to every node in its own dtype."""
    out = {}
    for coll in tree:
        out[coll] = {}
        for name, arr in flatten_tree(tree[coll]).items():
            t = torch.as_tensor(np.array(arr))
            out[coll][name] = t.to(device).unsqueeze(0).repeat(
                num_nodes, *([1] * t.dim())).contiguous()
    return out


def serving_params_from_jax(tree: Any, device="cuda") -> Dict[str, torch.Tensor]:
    """One model's flat f32 parameters, no node dimension, from a flax
    param tree: what the decode path and the serving engine take, so the
    port serves what the JAX package trained."""
    return {name: torch.as_tensor(np.array(arr, dtype=np.float32)).to(device)
            for name, arr in flatten_tree(tree).items()}


def serving_params(fit_params, node=None,
                   device=None) -> Dict[str, torch.Tensor]:
    """One model's parameters from node-stacked ``[K, ...]`` parameters
    (tensors or arrays, e.g. ``FitResult.node_state.params``): the mean
    over the nodes, as ``FitResult.params`` holds it, or node ``node``'s
    own; on ``device`` (default: where they are)."""
    out = {}
    for name, p in fit_params.items():
        t = torch.as_tensor(p).float()
        t = t.mean(dim=0) if node is None else t[node]
        out[name] = t.to(device if device is not None else t.device
                         ).contiguous()
    return out
