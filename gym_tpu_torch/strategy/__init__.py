"""Sync strategies of the port's first slice: SimpleReduce (DDP) and DiLoCo."""

from .base import CollectiveEvent, Strategy, StrategyLifecycleError
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .diloco import DiLoCoCommunicator, DiLoCoStrategy
from .optim import OptimSpec, ensure_optim_spec
from .simple_reduce import SimpleReduceStrategy

__all__ = ["CollectiveEvent", "Strategy", "StrategyLifecycleError",
           "CommunicateOptimizeStrategy", "CommunicationModule",
           "DiLoCoCommunicator", "DiLoCoStrategy", "OptimSpec",
           "ensure_optim_spec", "SimpleReduceStrategy"]
