"""Declarative optimizer factory (counterpart of ``gym_tpu/strategy/optim.py``).

``OptimSpec`` holds a torch-style optimizer name and kwargs (``lr``,
``betas``, ``eps``, ``weight_decay``, ``momentum``, ``nesterov``), validated,
and ``build()`` returns a transform with optax's arithmetic, so that the
port's optimizers step in lockstep with the JAX package's:

- adamw: u = −lr·(m̂/(√v̂+ε) + wd·p), decoupled decay (``optax.adamw``);
- adam: torch's L2 decay, g ← g + wd·p before the moments;
- sgd: optax's ``trace`` momentum (Nesterov: u = g + μ·(g + μ·t)),
  L2 decay;
- rmsprop: optax ``rmsprop``, ``scale_by_rms`` (ν = α·ν + (1−α)·g² from 0,
  then g·rsqrt(ν + ε), ε inside the root), the learning rate, then
  ``trace(momentum)``; not torch's RMSprop;
- adagrad: optax ``adagrad``, ``scale_by_rss`` (accumulator from 0.1, then
  where(acc > 0, g·rsqrt(acc + ε), 0)), then the learning rate.

rmsprop and adagrad take torch's L2 weight decay ahead of the transform
(optax ``add_decayed_weights``).

A transform is ``init(params) -> state`` and ``update(grads, state, params)
-> (updates, state)`` over dicts of tensors; the step count lives in the
state, as optax's does, and the learning-rate schedule is evaluated on the
host from it in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

# torch defaults, per torch.optim docs
_TORCH_DEFAULTS = {
    "adam": dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0),
    "adamw": dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2),
    "sgd": dict(lr=1e-3, momentum=0.0, nesterov=False, weight_decay=0.0),
    "rmsprop": dict(lr=1e-2, alpha=0.99, eps=1e-8, momentum=0.0,
                    weight_decay=0.0),
    "adagrad": dict(lr=1e-2, eps=1e-10, weight_decay=0.0),
}

ScheduleFn = Callable[[Any], Any]  # step -> lr multiplier (host, float32)
Tree = Dict[str, torch.Tensor]


def _f32(x) -> float:
    """A Python float holding exactly the float32 value of ``x``."""
    return float(np.float32(x))


class _LR:
    """optax ``scale_by_learning_rate``: −lr, or −base·scale(count)."""

    def __init__(self, base_lr: float, lr_scale: Optional[ScheduleFn]):
        self.base_lr = base_lr
        self.lr_scale = lr_scale

    def step_size(self, count: int) -> float:
        if self.lr_scale is None:
            return _f32(-self.base_lr)
        return _f32(-(np.float32(self.base_lr)
                      * np.float32(self.lr_scale(count))))


class Adam:
    """optax ``adam``/``adamw`` (``scale_by_adam`` → decoupled decay →
    learning rate), or torch Adam's L2 decay ahead of the moments."""

    def __init__(self, lr: _LR, b1: float, b2: float, eps: float,
                 weight_decay: float, decoupled: bool):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay, self.decoupled = weight_decay, decoupled

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(self, grads: Tree, state, params: Tree):
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        count = state["count"] + 1
        bc1 = _f32(1 - np.power(np.float32(b1), np.float32(count)))
        bc2 = _f32(1 - np.power(np.float32(b2), np.float32(count)))
        lr = self.lr.step_size(state["count"])
        mus, nus, updates = {}, {}, {}
        for n, g in grads.items():
            p = params[n]
            if wd and not self.decoupled:
                g = g + wd * p
            mu = (1 - b1) * g + b1 * state["mu"][n]
            nu = (1 - b2) * (g * g) + b2 * state["nu"][n]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if wd and self.decoupled:
                u = u + wd * p
            mus[n], nus[n], updates[n] = mu, nu, lr * u
        return updates, {"count": count, "mu": mus, "nu": nus}


class SGD:
    """optax ``sgd`` (``trace`` momentum, optionally Nesterov), with torch's
    L2 weight decay ahead of it."""

    def __init__(self, lr: _LR, momentum: Optional[float], nesterov: bool,
                 weight_decay: float):
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov
        self.weight_decay = weight_decay

    def init(self, params: Tree) -> Dict[str, Any]:
        trace = ({n: torch.zeros_like(p) for n, p in params.items()}
                 if self.momentum else None)
        return {"count": 0, "trace": trace}

    def update(self, grads: Tree, state, params: Tree):
        lr = self.lr.step_size(state["count"])
        mom, traces, updates = self.momentum, {}, {}
        for n, g in grads.items():
            if self.weight_decay:
                g = g + self.weight_decay * params[n]
            if mom:
                t = g + mom * state["trace"][n]
                traces[n] = t
                g = g + mom * t if self.nesterov else t
            updates[n] = lr * g
        return updates, {"count": state["count"] + 1,
                         "trace": traces if mom else None}


class RMSprop:
    """optax ``rmsprop`` (not centered, no bias correction), with torch's L2
    weight decay ahead of it."""

    def __init__(self, lr: _LR, decay: float, eps: float,
                 momentum: Optional[float], weight_decay: float):
        self.lr, self.decay, self.eps = lr, decay, eps
        self.momentum, self.weight_decay = momentum, weight_decay

    def init(self, params: Tree) -> Dict[str, Any]:
        trace = ({n: torch.zeros_like(p) for n, p in params.items()}
                 if self.momentum else None)
        return {"count": 0,
                "nu": {n: torch.zeros_like(p) for n, p in params.items()},
                "trace": trace}

    def update(self, grads: Tree, state, params: Tree):
        lr = self.lr.step_size(state["count"])
        a, mom = self.decay, self.momentum
        nus, traces, updates = {}, {}, {}
        for n, g in grads.items():
            if self.weight_decay:
                g = g + self.weight_decay * params[n]
            nu = (1 - a) * (g * g) + a * state["nu"][n]
            u = lr * (torch.rsqrt(nu + self.eps) * g)
            if mom:
                u = traces[n] = u + mom * state["trace"][n]
            nus[n], updates[n] = nu, u
        return updates, {"count": state["count"] + 1, "nu": nus,
                         "trace": traces if mom else None}


class Adagrad:
    """optax ``adagrad`` (initial accumulator 0.1), with torch's L2 weight
    decay ahead of it."""

    INITIAL_ACCUMULATOR = 0.1

    def __init__(self, lr: _LR, eps: float, weight_decay: float):
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay

    def init(self, params: Tree) -> Dict[str, Any]:
        return {"count": 0, "sum_of_squares": {
            n: torch.full_like(p, self.INITIAL_ACCUMULATOR)
            for n, p in params.items()}}

    def update(self, grads: Tree, state, params: Tree):
        lr = self.lr.step_size(state["count"])
        sums, updates = {}, {}
        for n, g in grads.items():
            if self.weight_decay:
                g = g + self.weight_decay * params[n]
            acc = g * g + state["sum_of_squares"][n]
            inv = torch.where(acc > 0, torch.rsqrt(acc + self.eps),
                              torch.zeros_like(acc))
            sums[n], updates[n] = acc, lr * (inv * g)
        return updates, {"count": state["count"] + 1,
                         "sum_of_squares": sums}


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {n: p + updates[n] for n, p in params.items()}


@dataclasses.dataclass
class OptimSpec:
    """Named optimizer + kwargs; ``build()`` returns a transform. Unknown
    kwargs raise instead of being silently dropped."""

    name: str = "adamw"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __init__(self, name: str = "adamw", **kwargs: Any):
        if callable(name):
            name = getattr(name, "__name__", str(name))
        name = str(name).lower()
        if name not in _TORCH_DEFAULTS:
            available = ", ".join(sorted(_TORCH_DEFAULTS))
            raise ValueError(
                f"Unknown optimizer '{name}'. Available options: {available}"
            )
        allowed = set(_TORCH_DEFAULTS[name]) | {"betas", "b1", "b2"}
        unknown = set(kwargs) - allowed
        if unknown:
            raise ValueError(
                f"Unknown kwargs for optimizer '{name}': {sorted(unknown)}"
            )
        self.name = name
        self.kwargs = dict(kwargs)

    @property
    def lr(self) -> float:
        return float(self.kwargs.get("lr", _TORCH_DEFAULTS[self.name]["lr"]))

    def build(self, lr_scale: Optional[ScheduleFn] = None):
        cfg = {**_TORCH_DEFAULTS[self.name], **self.kwargs}
        lr = _LR(float(cfg["lr"]), lr_scale)
        if self.name in ("adam", "adamw"):
            b1, b2 = cfg.get("betas", (0.9, 0.999))
            b1 = cfg.get("b1", b1)
            b2 = cfg.get("b2", b2)
            return Adam(lr, float(b1), float(b2), float(cfg["eps"]),
                        float(cfg["weight_decay"]),
                        decoupled=self.name == "adamw")
        if self.name == "sgd":
            return SGD(lr, float(cfg["momentum"]) or None,
                       bool(cfg["nesterov"]), float(cfg["weight_decay"]))
        if self.name == "rmsprop":
            return RMSprop(lr, float(cfg["alpha"]), float(cfg["eps"]),
                           float(cfg["momentum"]) or None,
                           float(cfg["weight_decay"]))
        return Adagrad(lr, float(cfg["eps"]), float(cfg["weight_decay"]))

    def config(self) -> Dict[str, Any]:
        return {"optimizer": self.name, **self.kwargs}


def ensure_optim_spec(
    optim: Union[str, OptimSpec, None],
    default: Optional[OptimSpec] = None,
    **kwargs: Any,
) -> OptimSpec:
    if optim is None:
        return default if default is not None else OptimSpec("adamw", **kwargs)
    if isinstance(optim, str):
        return OptimSpec(optim, **kwargs)
    if isinstance(optim, OptimSpec):
        if kwargs:
            return OptimSpec(optim.name, **{**optim.kwargs, **kwargs})
        return optim
    raise TypeError(f"Expected str, OptimSpec, or None, got {type(optim)}")
