"""Model contract: a module maps a raw data batch to per-node losses.

Counterpart of ``gym_tpu/models/base.py``. The JAX package's module returns
one node's scalar loss and ``vmap`` makes K of them; here every parameter
carries a leading node dimension ``[K, ...]`` and the module returns the K
per-node losses ``[K]`` at once. Because the nodes are independent,
``loss.sum()`` differentiates to each node's own gradient.

A module's non-parameter state (BatchNorm's ``batch_stats``) is
``model_state``: ``{collection: {name: [K, ...]}}``, one set a node, which
the training step threads through its microbatches in train mode and no
strategy averages. Dropout draws from per-node threefry keys (``rng``, a
``[K, 2]`` key table), as flax's ``nn.Dropout`` draws from the ``dropout``
stream (``dropout_mask``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import threefry

Params = Dict[str, torch.Tensor]


def _cast(x, dtype):
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


def _cast_state(state, dtype):
    return {c: {n: _cast(v, dtype) for n, v in coll.items()}
            for c, coll in state.items()}


def dropout_mask(keys: np.ndarray, keep: float, shape: Sequence[int],
                 device) -> torch.Tensor:
    """[K, *shape] bool: node k's ``jax.random.bernoulli(keys[k], keep,
    shape)``, all K nodes in one launch of the threefry kernel on the card."""
    n = math.prod(shape)
    return threefry.bernoulli_rows(keys, keep, n, device).view(-1, *shape)


def dropout(x: torch.Tensor, rate: float, keys: Optional[np.ndarray],
            train: bool, broadcast_dims: Sequence[int] = ()) -> torch.Tensor:
    """flax ``nn.Dropout`` for K nodes, x ``[K, ...]``: a mask per node over
    its shape with ``broadcast_dims`` (dims of the per-node shape) set to 1,
    broadcast, then ``select(mask, x / keep, 0)``. ``keys`` are the
    module's own (``threefry.fold_in_static`` of the step keys and its
    path)."""
    if not train or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    shape = list(x.shape[1:])
    for d in broadcast_dims:
        shape[d] = 1
    mask = dropout_mask(keys, keep, shape, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class LossModel:
    """Adapter: ``module(params, batch, train=, rng=[, state=])``.

    A module without state returns the per-node losses; one with state
    (``init_state``) returns ``(losses, new_state)``, the state updated in
    train mode and returned as given in eval.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): every floating parameter,
    state tensor and input is cast to it for the forward pass, layer-norm
    weights included — the JAX package's cast-everything rule, deliberately
    not ``torch.autocast`` (which keeps layer norms and softmax in f32).
    The stored parameters stay f32, and the new state is cast back to the
    stored state's dtypes (``gym_tpu/models/base.py:70-74``)."""

    def __init__(self, module, compute_dtype: Optional[torch.dtype] = None):
        self.module = module
        self.compute_dtype = compute_dtype

    def init(self, num_nodes: int, seed: int,
             device) -> Tuple[Params, Dict[str, Any]]:
        """(params stacked over the K nodes, identical on every node; the
        non-parameter state, per node, empty for a module without it)."""
        params = self.module.init_params(num_nodes, seed, device)
        init_state = getattr(self.module, "init_state", None)
        state = init_state(num_nodes, device) if init_state else {}
        return params, state

    def loss(self, params: Params, model_state: Dict[str, Any], batch,
             rng: Optional[np.ndarray],
             train: bool) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(per-node f32 losses [K], the new model state); ``rng`` is the
        [K, 2] key table of this microbatch (unused in eval)."""
        state = model_state
        if self.compute_dtype is not None:
            params = {n: _cast(p, self.compute_dtype)
                      for n, p in params.items()}
            batch = tuple(_cast(x, self.compute_dtype) for x in batch)
            state = _cast_state(state, self.compute_dtype)
        if not model_state:
            loss = self.module(params, batch, train=train, rng=rng)
            return loss.float(), model_state
        loss, new_state = self.module(params, batch, train=train, rng=rng,
                                      state=state)
        if not train:
            return loss.float(), model_state
        new_state = {c: {n: v.to(model_state[c][n].dtype)
                         for n, v in coll.items()}
                     for c, coll in new_state.items()}
        return loss.float(), {**model_state, **new_state}


def as_loss_model(model) -> LossModel:
    if isinstance(model, LossModel):
        return model
    if isinstance(model, torch.nn.Module):
        return LossModel(model)
    raise TypeError(
        f"model must be a torch Module or LossModel, got {type(model)}")
