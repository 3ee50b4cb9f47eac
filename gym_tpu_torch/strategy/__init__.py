"""Sync strategies of the port: SimpleReduce (DDP), ZeRO-1, DiLoCo (with
participation and the sharded outer state), FedAvg (islands,
participation), SPARTA (three index selectors) and SPARTA-DiLoCo."""

from .base import CollectiveEvent, Strategy, StrategyLifecycleError
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .diloco import DiLoCoCommunicator, DiLoCoStrategy
from .fedavg import AveragingCommunicator, FedAvgStrategy
from .optim import OptimSpec, ensure_optim_spec
from .simple_reduce import SimpleReduceStrategy
from .sparta import (IndexSelector, PartitionedIndexSelector,
                     RandomIndexSelector, ShuffledSequentialIndexSelector,
                     SparseCommunicator, SPARTAStrategy)
from .sparta_diloco import SPARTADiLoCoStrategy
from .zero_reduce import NodeCountMismatchError, ZeroReduceStrategy

__all__ = ["CollectiveEvent", "Strategy", "StrategyLifecycleError",
           "CommunicateOptimizeStrategy", "CommunicationModule",
           "DiLoCoCommunicator", "DiLoCoStrategy", "AveragingCommunicator",
           "FedAvgStrategy", "OptimSpec", "ensure_optim_spec",
           "SimpleReduceStrategy", "IndexSelector", "RandomIndexSelector",
           "ShuffledSequentialIndexSelector", "PartitionedIndexSelector",
           "SparseCommunicator", "SPARTAStrategy", "SPARTADiLoCoStrategy",
           "NodeCountMismatchError", "ZeroReduceStrategy"]
