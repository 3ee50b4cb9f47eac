"""Combine a strategy's modeled comm time with measured compute time.

The gym measures per-step *compute* on whatever hardware it actually has
(the simulated collectives run on-device and cost ~nothing there), and
models per-step *communication* from the strategy's collective event
trace priced on a declarative topology (``cost_model``). The two combine
into a simulated per-step wall-clock:

    no overlap:  sim_step = compute + comm
    overlap:     sim_step = max(compute, comm)   (perfect compute/comm
                 overlap — the upper bound a DiLoCo-style async schedule
                 approaches)

which answers the question the scalar ``comm_bytes`` column could not:
"what would this run's wall-clock be on 8 nodes over 1 Gbps WAN links?"
— per strategy, per topology, with a cost-vs-loss frontier.

The code is ``gym_tpu/sim/simulator.py``'s (``tests/test_torch_sim.py``
pins it), over the port's ``Strategy.comm_events``: its ``params`` is a
per-node template, a dict of tensors by parameter name whose shapes and
dtypes alone are read (``node_template`` builds one without storage).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..strategy.base import CollectiveEvent, Strategy
from .cost_model import events_time, events_tx_bytes
from .topology import Topology, resolve_topology

PyTree = Any


@dataclasses.dataclass
class SimResult:
    """A simulated run: per-step and total modeled wall-clock."""

    topology: str
    num_nodes: int
    overlap: bool
    steps: int
    compute_s_per_step: float
    step_s: List[float]            # simulated seconds per step
    comm_s: List[float]            # modeled comm seconds per step
    total_s: float                 # sum of step_s
    total_comm_s: float
    total_compute_s: float
    tx_bytes: float                # per-node bytes the trace accounts

    def summary(self) -> Dict[str, Any]:
        return {
            "topology": self.topology,
            "num_nodes": self.num_nodes,
            "overlap": self.overlap,
            "steps": self.steps,
            "compute_s_per_step": self.compute_s_per_step,
            "sim_total_s": self.total_s,
            "sim_comm_s": self.total_comm_s,
            "sim_compute_s": self.total_compute_s,
            "trace_tx_bytes": self.tx_bytes,
        }


class NetworkSimulator:
    """Prices one (strategy, node count, topology) triple step by step.

    ``params`` is a per-node template (``node_template``: a dict of
    storage-free tensors by parameter name — only shapes/dtypes are
    read). Per-step comm
    times are memoized: strategy cadences revisit the same few event
    shapes, but memoizing by step keeps the fault-draw (participation)
    path exact too.
    """

    def __init__(self, strategy: Strategy, params: PyTree, num_nodes: int,
                 topology: Union[str, Topology], overlap: bool = False,
                 algo: str = "ring"):
        self.strategy = strategy
        self.params = params
        self.num_nodes = int(num_nodes)
        self.topology = resolve_topology(topology, num_nodes)
        self.overlap = bool(overlap)
        self.algo = algo
        self._comm_cache: Dict[int, Tuple[float, float]] = {}

    def events(self, step: int) -> List[CollectiveEvent]:
        return self.strategy.comm_events(int(step), self.params,
                                         self.num_nodes)

    def _comm(self, step: int) -> Tuple[float, float]:
        """(modeled comm seconds, per-node tx bytes) at ``step``."""
        hit = self._comm_cache.get(step)
        if hit is None:
            evs = self.events(step)
            hit = (events_time(evs, self.topology, self.algo),
                   events_tx_bytes(evs))
            self._comm_cache[step] = hit
        return hit

    def comm_time(self, step: int) -> float:
        return self._comm(step)[0]

    def tx_bytes(self, step: int) -> float:
        return self._comm(step)[1]

    def step_time(self, step: int, compute_s: float) -> float:
        comm = self.comm_time(step)
        return max(compute_s, comm) if self.overlap else compute_s + comm

    def trace_tx_bytes(self, steps: int, start_step: int = 0) -> float:
        """Total per-node transmitted bytes over ``[start_step, steps)`` —
        must reconcile with the logged ``cum_comm_bytes`` column."""
        return sum(self.tx_bytes(t) for t in range(start_step, steps))

    def simulate(self, steps: int, compute_s_per_step: float,
                 start_step: int = 0) -> SimResult:
        step_s, comm_s = [], []
        for t in range(start_step, steps):
            c = self.comm_time(t)
            comm_s.append(c)
            step_s.append(max(compute_s_per_step, c) if self.overlap
                          else compute_s_per_step + c)
        n = len(step_s)
        return SimResult(
            topology=self.topology.name,
            num_nodes=self.num_nodes,
            overlap=self.overlap,
            steps=n,
            compute_s_per_step=compute_s_per_step,
            step_s=step_s,
            comm_s=comm_s,
            total_s=sum(step_s),
            total_comm_s=sum(comm_s),
            total_compute_s=compute_s_per_step * n,
            tx_bytes=self.trace_tx_bytes(steps, start_step),
        )


def loss_frontier(result: SimResult,
                  loss_history: Sequence[Tuple[int, float]],
                  start_step: int = 0) -> List[Tuple[float, float]]:
    """Cost-vs-loss frontier: (simulated elapsed seconds, loss) pairs —
    the curve strategy comparisons actually trade on (a cheap strategy
    that converges slower can still lose the frontier).

    ``loss_history`` is the trainer's ``history["train_loss"]``:
    (step, loss) with step being the pre-increment index of
    ``result.step_s``' rows.
    """
    cum = []
    acc = 0.0
    for s in result.step_s:
        acc += s
        cum.append(acc)
    out = []
    for step, loss in loss_history:
        i = step - start_step
        if 0 <= i < len(cum):
            out.append((cum[i], float(loss)))
    return out


def make_simulator(network: Union[str, Topology], strategy: Strategy,
                   params: PyTree, num_nodes: int, overlap: bool = False,
                   algo: str = "ring") -> NetworkSimulator:
    """The Trainer's entry point: resolve the preset and build the
    per-step simulator."""
    return NetworkSimulator(strategy, params, num_nodes, network,
                            overlap=overlap, algo=algo)
