"""Training and eval steps over K simulated nodes (counterpart of
``gym_tpu/train_node.py``).

The JAX package traces one node's step and compiles it over the node mesh;
here one step runs eagerly on all K nodes at once, every tensor carrying
the node dimension first. Gradient accumulation is a loop over
microbatches, rescaled by their count, as in the reference's
grad-accumulation loop (``train_node.py:157-171``).

Each node's dropout key is the JAX package's, bit for bit: node i holds
``fold_in(PRNGKey(seed), i + 1)``, a step folds in the step counter and a
microbatch its index (``train_node.py:71,83,114,126``); the model then folds
in each dropout module's path (``threefry.fold_in_static``). The key algebra
runs on the host over the K nodes at once (``threefry.fold_in_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .models.base import LossModel
from .ops import threefry
from .parallel.axis import AxisCtx
from .strategy.base import Strategy

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    params: Tree                  # f32, [K, ...] per tensor
    model_state: Dict[str, Any]   # non-param collections, [K, ...] each
    strategy_state: Dict[str, Any]
    step: int                     # host step counter
    rng: np.ndarray               # [K, 2] per-node threefry keys (host)


def make_init_fn(loss_model: LossModel, strategy: Strategy, seed: int,
                 init_params=None, device=None, ctx: Optional[AxisCtx] = None):
    """``init_fn(node_index [K]) -> TrainState``. Parameters come from the
    same seed for every node (replicas start identical), or from
    ``init_params``: a dict of per-node tensors (or arrays) by parameter
    name, copied to every node, or already stacked ``[K, ...]``. Shapes
    come from the model's config, so no example batch is needed.
    ``device=None`` is the card (``default_device``: an error without
    one), as in ``Trainer.fit``. ``ctx`` is bound to the strategy before
    its ``init`` (ZeRO lays its state out by the node count)."""
    device = default_device(device)
    if ctx is not None:
        strategy.bind_ctx(ctx)

    def init_fn(node_index: torch.Tensor) -> TrainState:
        k = int(node_index.shape[0])
        params, model_state = loss_model.init(k, seed, device)
        if init_params is not None:
            params = _stack_given(params, init_params, k, device)
        return TrainState(params=params, model_state=model_state,
                          strategy_state=strategy.init(params), step=0,
                          rng=threefry.node_keys(seed, k))

    return init_fn


def _stack_given(ref: Tree, given, k: int, device) -> Tree:
    if set(given) != set(ref):
        raise ValueError(
            f"init_params names differ from the model's: missing "
            f"{sorted(set(ref) - set(given))}, unknown "
            f"{sorted(set(given) - set(ref))}")
    out = {}
    for name, r in ref.items():
        g = torch.as_tensor(given[name]).to(device=device, dtype=r.dtype)
        if tuple(g.shape) == tuple(r.shape[1:]):
            g = g.unsqueeze(0).repeat(k, *([1] * g.dim()))
        elif tuple(g.shape) != tuple(r.shape):
            raise ValueError(f"init_params[{name!r}] has shape "
                             f"{tuple(g.shape)}, expected {tuple(r.shape)} "
                             f"or {tuple(r.shape[1:])}")
        out[name] = g.contiguous()
    return out


def _finite_per_node(loss: torch.Tensor, grads: Tree) -> torch.Tensor:
    ok = torch.isfinite(loss)
    for g in grads.values():
        ok = ok & torch.isfinite(g.reshape(g.shape[0], -1)).all(dim=1)
    return ok


def micro_keys(node_keys: np.ndarray, step: int, n_micro: int):
    """[n_micro, K, 2]: microbatch i's keys ``fold_in(fold_in(k, step),
    i)`` for every node key k, in two folds over all of them."""
    k = node_keys.shape[0]
    step_keys = threefry.fold_in_rows(node_keys, step)
    keys = threefry.fold_in_rows(np.tile(step_keys, (n_micro, 1)),
                                 np.repeat(np.arange(n_micro), k))
    return keys.reshape(n_micro, k, 2)


def make_train_step(loss_model: LossModel, strategy: Strategy, ctx: AxisCtx,
                    skip_nonfinite: bool = False):
    """``node_step(state, batch) -> (state, metrics)``; batch tensors are
    [K, n_micro, micro_bs, ...]. Metrics: ``loss`` [K] on the device,
    ``comm_bytes`` as the node mean (a host float, or a 0-d tensor on the
    device where it counts random masks) and, with ``skip_nonfinite``,
    ``nonfinite`` [K]: a node whose loss or gradients go non-finite
    contributes zero gradient instead, so one diverged replica cannot
    poison the collective mean."""

    def node_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        n_micro = batch[0].shape[1]
        names = list(state.params)
        leaves = [state.params[n].detach().requires_grad_(True)
                  for n in names]
        params = dict(zip(names, leaves))
        gsum, lsum = None, None
        model_state = state.model_state
        keys = micro_keys(state.rng, state.step, n_micro)
        for i in range(n_micro):
            mb = tuple(x[:, i] for x in batch)
            loss, model_state = loss_model.loss(params, model_state, mb,
                                                keys[i], True)
            g = torch.autograd.grad(loss.sum(), leaves)
            gsum = list(g) if gsum is None else [a + b
                                                 for a, b in zip(gsum, g)]
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
        grads = {n: g / n_micro for n, g in zip(names, gsum)}
        loss = lsum / n_micro

        ok = None
        if skip_nonfinite:
            ok = _finite_per_node(loss, grads)
            # select, not multiply: NaN·0 is NaN
            grads = {n: torch.where(
                ok.view(-1, *([1] * (g.dim() - 1))), g, torch.zeros_like(g))
                for n, g in grads.items()}

        new_params, sstate, metrics = strategy.step(
            grads, state.params, state.strategy_state, state.step, ctx)
        new_state = dataclasses.replace(
            state, params=new_params, model_state=model_state,
            strategy_state=sstate, step=state.step + 1)
        metrics = dict(metrics)
        metrics["loss"] = loss
        if skip_nonfinite:
            metrics["nonfinite"] = 1.0 - ok.float()
        return new_state, metrics

    return node_step


def make_multi_train_step(loss_model: LossModel, strategy: Strategy,
                          ctx: AxisCtx, skip_nonfinite: bool = False):
    """S steps per call: batch tensors are [K, S, n_micro, micro_bs, ...];
    per-node metrics gain a step axis, [K, S] (``comm_bytes`` a list of its
    S values)."""
    node_step = make_train_step(loss_model, strategy, ctx, skip_nonfinite)

    def node_multi(state: TrainState, batches):
        per_step = []
        for s in range(batches[0].shape[1]):
            state, m = node_step(state, tuple(x[:, s] for x in batches))
            per_step.append(m)
        metrics = {}
        for key in per_step[0]:
            vals = [m[key] for m in per_step]
            metrics[key] = vals if key == "comm_bytes" else torch.stack(
                vals, dim=1)
        return state, metrics

    return node_multi


def make_eval_step(loss_model: LossModel, ctx: AxisCtx):
    """``node_eval(state, batch) -> (local_loss [K], global_loss [K])``: each
    node's loss with its own params and with the node-mean params, on its
    own validation stream (the reference's local/global protocol,
    ``train_node.py:181-246``). Both use the node's own model state
    (BatchNorm's running stats stay local, as in the reference)."""

    @torch.no_grad()
    def node_eval(state: TrainState, batch):
        avg_params = ctx.pmean(state.params)
        n = batch[0].shape[1]
        l_loc = l_glob = None
        for i in range(n):
            mb = tuple(x[:, i] for x in batch)
            loc, _ = loss_model.loss(state.params, state.model_state, mb,
                                     None, False)
            glob, _ = loss_model.loss(avg_params, state.model_state, mb,
                                      None, False)
            l_loc = loc if l_loc is None else l_loc + loc
            l_glob = glob if l_glob is None else l_glob + glob
        return l_loc / n, l_glob / n

    return node_eval


def default_device(device: Optional[str]) -> torch.device:
    """The card unless the caller asks for the CPU; never a silent fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "gym_tpu_torch runs on a CUDA card and none was found; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    dev = torch.device("cuda" if device == "gpu" else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           f"available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
