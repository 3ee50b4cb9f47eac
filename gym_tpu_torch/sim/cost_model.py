"""Alpha-beta cost model for the strategies' collective events.

Classic LogP-style accounting (Hockney's alpha-beta: a message of N bytes
over one link costs ``alpha + N / bandwidth``) applied to the standard
collective algorithms:

- **ring all-reduce**: ``2(g−1)`` rounds, each moving an ``N/g`` chunk
  across every ring hop simultaneously; a round finishes when its slowest
  hop does. Homogeneous links collapse to the textbook closed form
  ``2(g−1)/g · N/bw + 2(g−1)·alpha`` — the oracle ``tests/test_sim.py``
  pins exactly.
- **tree all-reduce**: reduce up + broadcast down a binomial tree —
  ``2·ceil(log2 g)`` full-payload hops over the bottleneck link. Fewer
  latency terms than the ring (log vs linear in g) at g× the bandwidth
  term: the classic small-message/large-message trade the ``algo`` knob
  exposes.
- **ring all-gather / reduce-scatter**: ``g−1`` rounds of ``N/g``.
- **broadcast**: binomial tree, ``ceil(log2 g)`` full-payload hops.
- **p2p**: one hop.

Payload-size conventions per op match ``strategy.base.CollectiveEvent``
(all_reduce/reduce_scatter: full vector; all_gather: assembled output;
broadcast/p2p: message). All pure host-side float math — closed-form
testable with no device in sight.

A copy of ``gym_tpu/sim/cost_model.py`` over the port's
``strategy.base.CollectiveEvent``; ``tests/test_torch_sim.py`` pins the
copy to its original.
"""

from __future__ import annotations

import math
from typing import List

from ..strategy.base import CollectiveEvent
from .topology import Link, Topology


def _round_time(chunk_bytes: float, links: List[Link]) -> float:
    """One ring round: every hop moves ``chunk_bytes`` concurrently; the
    round is as slow as its slowest hop (bandwidth AND latency per hop)."""
    return max(chunk_bytes / l.bandwidth + l.latency for l in links)


def _homogeneous(links: List[Link]) -> bool:
    return all(l == links[0] for l in links[1:])


def ring_all_reduce_time(n_bytes: float, links: List[Link]) -> float:
    g = len(links)
    if g <= 1:
        return 0.0
    if _homogeneous(links):
        # textbook closed form, evaluated in ITS grouping so the oracle
        # test's `2(g−1)/g · N/bw + 2(g−1)·α` holds bit-exactly (the
        # per-round product below differs in float rounding order)
        l = links[0]
        return (2 * (g - 1) / g * n_bytes / l.bandwidth
                + 2 * (g - 1) * l.latency)
    return 2 * (g - 1) * _round_time(n_bytes / g, links)


def ring_all_gather_time(n_bytes: float, links: List[Link]) -> float:
    """``n_bytes`` = assembled output size (each node contributes N/g)."""
    g = len(links)
    if g <= 1:
        return 0.0
    if _homogeneous(links):
        l = links[0]
        return (g - 1) / g * n_bytes / l.bandwidth + (g - 1) * l.latency
    return (g - 1) * _round_time(n_bytes / g, links)


def ring_reduce_scatter_time(n_bytes: float, links: List[Link]) -> float:
    """``n_bytes`` = full input vector size (each node keeps N/g)."""
    return ring_all_gather_time(n_bytes, links)


def tree_all_reduce_time(n_bytes: float, bottleneck: Link,
                         group: int) -> float:
    if group <= 1:
        return 0.0
    depth = math.ceil(math.log2(group))
    return 2 * depth * (n_bytes / bottleneck.bandwidth + bottleneck.latency)


def tree_broadcast_time(n_bytes: float, bottleneck: Link,
                        group: int) -> float:
    if group <= 1:
        return 0.0
    depth = math.ceil(math.log2(group))
    return depth * (n_bytes / bottleneck.bandwidth + bottleneck.latency)


def p2p_time(n_bytes: float, link: Link) -> float:
    return n_bytes / link.bandwidth + link.latency


def gossip_round_time(n_bytes: float, pairs, topology: Topology) -> float:
    """One randomized-gossip round (NoLoCo): every (sender, receiver)
    pair exchanges ``n_bytes`` CONCURRENTLY, so the round costs the
    slowest pair's single hop — priced on the link each pair actually
    crosses (intra- vs inter-host on hierarchical topologies), not the
    group bottleneck. Self-pairs (a node sitting a round out) are
    free."""
    times = [p2p_time(n_bytes, topology.link(i, j))
             for i, j in pairs if i != j]
    return max(times) if times else 0.0


def collective_time(event: CollectiveEvent, topology: Topology,
                    algo: str = "ring") -> float:
    """Modeled wall-clock seconds for one collective event.

    ``algo`` selects the all-reduce algorithm ("ring" or "tree"); the
    other ops have one canonical algorithm each (gather/scatter ring,
    broadcast tree).
    """
    g = int(event.group)
    if g <= 1 or event.bytes <= 0:
        return 0.0
    links = topology.ring_links(g)
    if event.op == "all_reduce":
        if algo == "tree":
            return tree_all_reduce_time(event.bytes,
                                        topology.bottleneck(g), g)
        if algo != "ring":
            raise ValueError(f"unknown all-reduce algo {algo!r}")
        return ring_all_reduce_time(event.bytes, links)
    if event.op == "all_gather":
        return ring_all_gather_time(event.bytes, links)
    if event.op == "reduce_scatter":
        return ring_reduce_scatter_time(event.bytes, links)
    if event.op == "broadcast":
        return tree_broadcast_time(event.bytes, topology.bottleneck(g), g)
    if event.op == "p2p":
        if event.pairs is not None:
            return gossip_round_time(event.bytes, event.pairs, topology)
        return p2p_time(event.bytes, topology.bottleneck(g))
    raise ValueError(f"unknown collective op {event.op!r}")


def events_time(events: List[CollectiveEvent], topology: Topology,
                algo: str = "ring") -> float:
    """Serial total for one step's event list (collectives within a step
    are dependency-ordered in every strategy here: they do not overlap)."""
    return sum(collective_time(ev, topology, algo) for ev in events)


def events_tx_bytes(events: List[CollectiveEvent]) -> float:
    """Per-node transmitted bytes — the trace-side twin of the
    ``comm_bytes`` metric."""
    return sum(ev.per_node_tx() for ev in events)
