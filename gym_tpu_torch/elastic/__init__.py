"""gym_tpu_torch.elastic — elastic membership for training (counterpart of
``gym_tpu.elastic``).

Resume at any node count: ``reshard`` maps a checkpointed (K, layout)
onto the live (K', layout) through the program registry's reshard
programs, and owns the ZeRO-2 sharded checkpoint codec; ``controller``
drives the training node set with the serving fleet's
``AutoscaleController``.
"""

from .controller import ElasticTrainController, elastic_fit
from .reshard import (STACKED_LAYOUT, ZERO2_LAYOUT, cold_restart_events,
                      elastic_meta, make_zero2_codec, param_leaf_specs,
                      reshard_events, reshard_state)

__all__ = [
    "ZERO2_LAYOUT", "STACKED_LAYOUT",
    "elastic_meta", "param_leaf_specs", "make_zero2_codec",
    "reshard_state", "reshard_events", "cold_restart_events",
    "ElasticTrainController", "elastic_fit",
]
