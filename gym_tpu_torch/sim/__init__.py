"""gym_tpu_torch.sim — the network simulator and the strategy sweep
(counterpart of ``gym_tpu/sim``).

Turns the strategies' per-step collective event traces
(``strategy.base.CollectiveEvent``) into simulated wall-clock on
declarative topologies:

- ``topology``   — per-link bandwidth/latency networks + presets
  ("datacenter", "wan" a.k.a. cross-region DiLoCo, "federated").
- ``cost_model`` — alpha-beta timing for ring/tree all-reduce,
  all-gather, reduce-scatter, broadcast, p2p.
- ``simulator``  — modeled comm + measured compute → simulated step/run
  wall-clock with an overlap toggle, plus the cost-vs-loss frontier;
  ``template.node_template`` builds the per-node shapes it prices.
- ``sweep``      — the resumable grid runner (strategy × H × nodes ×
  topology × codec × membership event) over real port fits;
  ``python -m gym_tpu_torch.sim.sweep --help``.
- ``frontier_gate`` / ``elastic_frontier`` — the cost-model regression
  gates against the committed baselines under ``logs/frontier/``.
- ``gridlib``    — the crash-safe cell protocol the sweeps share.

Everything but the sweep's fits is host-side Python over the analytic
traces.
"""

from ..strategy.base import COLLECTIVE_OPS, CollectiveEvent
from .cost_model import (collective_time, events_time, events_tx_bytes,
                         p2p_time, ring_all_gather_time,
                         ring_all_reduce_time, ring_reduce_scatter_time,
                         tree_all_reduce_time, tree_broadcast_time)
from .simulator import (NetworkSimulator, SimResult, loss_frontier,
                        make_simulator)
from .template import node_template
from .topology import PRESETS, Link, Topology, resolve_topology

__all__ = [
    "CollectiveEvent", "COLLECTIVE_OPS",
    "Link", "Topology", "PRESETS", "resolve_topology",
    "collective_time", "events_time", "events_tx_bytes",
    "ring_all_reduce_time", "ring_all_gather_time",
    "ring_reduce_scatter_time", "tree_all_reduce_time",
    "tree_broadcast_time", "p2p_time",
    "NetworkSimulator", "SimResult", "make_simulator", "loss_frontier",
    "node_template",
]
