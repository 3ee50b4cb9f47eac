"""Sync strategies of the port: SimpleReduce (DDP), ZeRO-1, DiLoCo (with
participation, the sharded outer state and the compressed outer delta),
FedAvg (islands, participation), SPARTA (three index selectors),
SPARTA-DiLoCo, DeMo, decoupled outer momentum, NoLoCo and DynamiQ, and the
codecs and link they share."""

from .base import CollectiveEvent, Strategy, StrategyLifecycleError
from .communicate_optimize import (CommunicateOptimizeStrategy,
                                   CommunicationModule)
from .compress import (Codec, CompressedLink, QuantizeCodec, TopKCodec,
                       make_codec)
from .demo import (DecoupledMomentumStrategy, DeMoOuterCommunicator,
                   DeMoStrategy)
from .diloco import DiLoCoCommunicator, DiLoCoStrategy
from .dynamiq import DynamiQStrategy
from .fedavg import AveragingCommunicator, FedAvgStrategy
from .noloco import NoLoCoCommunicator, NoLoCoStrategy
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
           "NodeCountMismatchError", "ZeroReduceStrategy", "Codec",
           "CompressedLink", "QuantizeCodec", "TopKCodec", "make_codec",
           "DeMoStrategy", "DeMoOuterCommunicator",
           "DecoupledMomentumStrategy", "DynamiQStrategy",
           "NoLoCoCommunicator", "NoLoCoStrategy"]
