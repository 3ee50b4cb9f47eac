"""Strategy base: "optimizer ∪ communication schedule" (counterpart of
``gym_tpu/strategy/base.py``).

    state = strategy.init(params)
    params', state', metrics = strategy.step(grads, params, state, step, ctx)

``params`` and ``grads`` are dicts of tensors with the K simulated nodes as
their leading dimension; ``ctx`` (``parallel/axis.py:AxisCtx``) supplies the
collectives over it. ``step`` is the host step counter (a Python int), so
the strategy's gates branch on the host with no device round trip.
``finalize(max_steps)`` must be called before ``init``, and strategies
whose state layout depends on the node count (ZeRO) need ``bind_ctx(ctx)``
before it (``make_init_fn(..., ctx=)`` and ``Trainer.fit`` do that). Every ``step`` returns
``comm_bytes``: the payload the algorithm would transmit on a real
network, as the mean over the nodes.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.axis import AxisCtx
from .schedule import build_lr_scale

Tree = Dict[str, torch.Tensor]


class StrategyLifecycleError(RuntimeError):
    """A strategy was used out of order (``init`` before ``finalize``)."""


def require_finalized(strategy: "Strategy") -> None:
    if not getattr(strategy, "_finalized", False):
        raise StrategyLifecycleError(
            f"{type(strategy).__name__}: call strategy.finalize(max_steps) "
            f"before init")


def tree_bytes(tree) -> int:
    """Total payload size of a tree of tensors (or shapes with dtypes) in
    bytes. Pass per-node tensors (or divide by K) for per-node bytes."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return int(sum(x.numel() * x.element_size() for x in leaves))


def tree_num_params(tree) -> int:
    leaves = tree.values() if isinstance(tree, dict) else tree
    return int(sum(x.numel() for x in leaves))


def comm_metric(x):
    """Canonical form of the per-step ``comm_bytes`` metric, a float32
    value: a Python float where the host knows it (shapes, the step and the
    host's fault draw fix it), or a 0-d float32 tensor left on the device
    where it counts realized random masks (SPARTA), read back one step late
    with the loss."""
    if torch.is_tensor(x):
        return x.to(torch.float32).reshape(())
    return float(np.float32(x))


COLLECTIVE_OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
                  "p2p")


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective a strategy step performs, described analytically (op
    kind, payload bytes, participant group); ``per_node_tx()`` reproduces
    the strategy's own ``comm_bytes`` accounting."""

    op: str
    bytes: float
    group: int
    label: str = ""
    tx_bytes: Optional[float] = None  # None: the ring formula for `op`

    def __post_init__(self):
        if self.op not in COLLECTIVE_OPS:
            raise ValueError(f"unknown collective op {self.op!r}; "
                             f"expected one of {COLLECTIVE_OPS}")

    def per_node_tx(self) -> float:
        if self.tx_bytes is not None:
            return float(self.tx_bytes)
        g = max(int(self.group), 1)
        if self.op == "all_reduce":
            return 2.0 * (g - 1) / g * self.bytes
        if self.op in ("all_gather", "reduce_scatter"):
            return (g - 1) / g * self.bytes
        return float(self.bytes)


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tree:
    """Per-node global-norm gradient clipping (torch ``clip_grad_norm_``
    semantics): each node's gradients are scaled by its own norm."""
    sq = None
    for g in tree.values():
        s = g.reshape(g.shape[0], -1).float().square().sum(dim=1)
        sq = s if sq is None else sq + s
    scale = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-6), max=1.0)
    return {n: g * scale.view(-1, *([1] * (g.dim() - 1)))
            for n, g in tree.items()}


class Strategy(abc.ABC):
    """Base strategy: ``init`` and ``step`` over node-stacked dicts."""

    def __init__(
        self,
        lr_scheduler: Optional[str] = None,
        lr_scheduler_kwargs: Optional[dict] = None,
        max_norm: Optional[float] = None,
    ):
        self.lr_scheduler = lr_scheduler
        self.lr_scheduler_kwargs = lr_scheduler_kwargs
        self.max_norm = max_norm
        self.max_steps = 1
        self._lr_scale = None
        self._finalized = False
        self._ctx: Optional[AxisCtx] = None

    def bind_ctx(self, ctx: AxisCtx) -> "Strategy":
        """Attach the node context before ``init``; most strategies ignore
        it."""
        self._ctx = ctx
        return self

    def finalize(self, max_steps: int) -> "Strategy":
        """Bind ``max_steps`` (needed by the lr schedule) and build the
        optimizers. Idempotent."""
        self.max_steps = int(max_steps)
        self._lr_scale = build_lr_scale(
            self.lr_scheduler, self.lr_scheduler_kwargs, self.max_steps)
        self._build()
        self._finalized = True
        return self

    def _build(self) -> None:
        """Subclass hook: construct the optimizers from self._lr_scale."""

    @abc.abstractmethod
    def init(self, params: Tree) -> Dict[str, Any]:
        """Strategy state for node-stacked ``params``."""

    @abc.abstractmethod
    def step(self, grads: Tree, params: Tree, state: Dict[str, Any],
             step: int, ctx: AxisCtx
             ) -> Tuple[Tree, Dict[str, Any], Dict[str, Any]]:
        """One post-gradient step: communicate + optimize. Returns (params,
        state, metrics); ``metrics['comm_bytes']`` is the node mean."""

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        """The collectives ``step`` schedules at host step ``step``, from a
        per-node ``params`` template; ``[]`` on steps with none."""
        return []

    def lr_at(self, step: int) -> float:
        """Host-side lr for logging."""
        base = getattr(self, "optim_spec", None)
        base_lr = base.lr if base is not None else 0.0
        if self._lr_scale is None:
            return base_lr
        return float(base_lr * self._lr_scale(step))

    def config(self) -> Dict[str, Any]:
        cfg: Dict[str, Any] = {"strategy": type(self).__name__}
        if self.lr_scheduler:
            cfg["lr_scheduler"] = self.lr_scheduler
            cfg.update(
                {f"lr_{k}": v
                 for k, v in (self.lr_scheduler_kwargs or {}).items()})
        if self.max_norm is not None:
            cfg["max_norm"] = self.max_norm
        spec = getattr(self, "optim_spec", None)
        if spec is not None:
            cfg.update(spec.config())
        return cfg

    def _maybe_clip(self, grads: Tree, ctx: AxisCtx = None) -> Tree:
        if not self.max_norm:
            return grads
        return clip_by_global_norm(grads, self.max_norm)
