"""Model contract: a module maps a raw data batch to per-node losses.

Counterpart of ``gym_tpu/models/base.py``. The JAX package's module returns
one node's scalar loss and ``vmap`` makes K of them; here every parameter
carries a leading node dimension ``[K, ...]`` and the module returns the K
per-node losses ``[K]`` at once. Because the nodes are independent,
``loss.sum()`` differentiates to each node's own gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def _cast(x, dtype):
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


class LossModel:
    """Adapter: ``module(params, batch, train=, generator=) -> losses [K]``.

    ``compute_dtype`` (e.g. ``torch.bfloat16``): every floating parameter and
    input is cast to it for the forward pass, layer-norm weights included —
    the JAX package's cast-everything rule, deliberately not
    ``torch.autocast`` (which keeps layer norms and softmax in f32). The
    stored parameters stay f32."""

    def __init__(self, module, compute_dtype: Optional[torch.dtype] = None):
        self.module = module
        self.compute_dtype = compute_dtype

    def init(self, num_nodes: int, seed: int,
             device) -> Tuple[Params, Dict[str, Any]]:
        """(params stacked over the K nodes, identical on every node; the
        non-parameter state, empty for the models of this slice)."""
        return self.module.init_params(num_nodes, seed, device), {}

    def loss(self, params: Params, model_state: Dict[str, Any], batch,
             generator: Optional[torch.Generator],
             train: bool) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if self.compute_dtype is not None:
            params = {n: _cast(p, self.compute_dtype)
                      for n, p in params.items()}
            batch = tuple(_cast(x, self.compute_dtype) for x in batch)
        loss = self.module(params, batch, train=train, generator=generator)
        return loss.float(), model_state


def as_loss_model(model) -> LossModel:
    if isinstance(model, LossModel):
        return model
    if isinstance(model, torch.nn.Module):
        return LossModel(model)
    raise TypeError(
        f"model must be a torch Module or LossModel, got {type(model)}")
