"""Composition base: local optimize + pluggable communication modules
(counterpart of ``gym_tpu/strategy/communicate_optimize.py``).

    mstate                  = module.init(params)
    params', mstate', bytes = module.communicate(params, mstate, step, ctx)
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Sequence, Union

from .base import CollectiveEvent, Strategy, comm_metric, require_finalized
from .optim import OptimSpec, apply_updates, ensure_optim_spec


class CommunicationModule(abc.ABC):
    """Communication transformer over the node dimension."""

    _ctx = None  # node context, bound before init for layout decisions

    def bind_ctx(self, ctx) -> "CommunicationModule":
        self._ctx = ctx
        return self

    def init(self, params) -> Dict[str, Any]:
        return {}

    @abc.abstractmethod
    def communicate(self, params, mstate, step, ctx):
        """Returns (new_params, new_mstate, comm_bytes as the node mean: a
        host float or a 0-d device tensor)."""

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        return []

    def config(self) -> Dict[str, Any]:
        return {"module": type(self).__name__}


class CommunicateOptimizeStrategy(Strategy):
    """Inner optimizer step, then each communication module in order."""

    def __init__(
        self,
        communication_modules: Sequence[CommunicationModule],
        inner_optim: Optional[Union[str, OptimSpec]] = None,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
    ):
        super().__init__(lr_scheduler, lr_scheduler_kwargs, max_norm)
        self.optim_spec = ensure_optim_spec(inner_optim, OptimSpec("adamw"))
        self.communication_modules: List[CommunicationModule] = list(
            communication_modules)
        self.tx = None

    def _build(self):
        self.tx = self.optim_spec.build(self._lr_scale)

    def bind_ctx(self, ctx):
        super().bind_ctx(ctx)
        for m in self.communication_modules:
            m.bind_ctx(ctx)
        return self

    def init(self, params):
        require_finalized(self)
        return {
            "opt": self.tx.init(params),
            "modules": [m.init(params) for m in self.communication_modules],
        }

    def _should_communicate(self, step: int) -> bool:
        """Gate hook; FedAvg overrides it with its H-periodic gate."""
        return True

    def comm_events(self, step: int, params,
                    num_nodes: int) -> List[CollectiveEvent]:
        if not self._should_communicate(step):
            return []
        events: List[CollectiveEvent] = []
        for m in self.communication_modules:
            events.extend(m.comm_events(step, params, num_nodes))
        return events

    def step(self, grads, params, state, step, ctx):
        grads = self._maybe_clip(grads, ctx)
        updates, opt_state = self.tx.update(grads, state["opt"], params)
        params = apply_updates(params, updates)
        mstates = state["modules"]
        total = 0.0
        if self._should_communicate(step):
            new_mstates = []
            for mod, ms in zip(self.communication_modules, mstates):
                params, ms, nbytes = mod.communicate(params, ms, step, ctx)
                new_mstates.append(ms)
                total += nbytes
            mstates = new_mstates
        return (params, {"opt": opt_state, "modules": mstates},
                {"comm_bytes": comm_metric(total)})

    def config(self):
        cfg = super().config()
        for i, m in enumerate(self.communication_modules):
            for k, v in m.config().items():
                cfg[f"{k}_{i}" if k in cfg else k] = v
        return cfg
