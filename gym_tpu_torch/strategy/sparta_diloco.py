"""SPARTA × DiLoCo: sparse gossip every step, then the outer loop every H
steps (counterpart of ``gym_tpu/strategy/sparta_diloco.py``). Both are
communication modules and compose in order. They share one fault draw per
step (the same seed): a node down for the gossip is down for the outer
loop too.
"""

from __future__ import annotations

from typing import Optional, Union

from .communicate_optimize import CommunicateOptimizeStrategy
from .diloco import DiLoCoCommunicator
from .optim import OptimSpec, ensure_optim_spec
from .sparta import IndexSelector, RandomIndexSelector, SparseCommunicator


class SPARTADiLoCoStrategy(CommunicateOptimizeStrategy):
    def __init__(
        self,
        optim_spec: Optional[Union[str, OptimSpec]] = None,
        outer_optim_spec: Optional[Union[str, OptimSpec]] = None,
        p_sparta: float = 0.005,
        H: int = 100,
        sparta_interval: int = 1,
        index_selector: Optional[IndexSelector] = None,
        max_norm: Optional[float] = None,
        lr_scheduler=None,
        lr_scheduler_kwargs=None,
        participation: float = 1.0,
    ):
        selector = index_selector or RandomIndexSelector(p_sparta)
        super().__init__(
            communication_modules=[
                SparseCommunicator(selector, interval=sparta_interval,
                                   participation=participation),
                DiLoCoCommunicator(H=H, outer_optim_spec=outer_optim_spec,
                                   participation=participation),
            ],
            inner_optim=ensure_optim_spec(optim_spec, OptimSpec("adamw")),
            max_norm=max_norm,
            lr_scheduler=lr_scheduler,
            lr_scheduler_kwargs=lr_scheduler_kwargs,
        )
        self.p_sparta = p_sparta
        self.H = int(H)
        self.sparta_interval = int(sparta_interval)

    def config(self):
        cfg = super().config()
        cfg.update({"H": self.H, "p_sparta": self.p_sparta})
        return cfg
