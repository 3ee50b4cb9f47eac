"""Declarative network topologies for the collective cost model.

A topology assigns every inter-node hop a (bandwidth, latency) pair. The
model is deliberately two-level — a fast *intra-host* link shared by the
``nodes_per_host`` nodes co-located on one host/region, and a slower
*inter-host* link between hosts — because that is the shape every setting
the gym simulates reduces to: TPU ICI vs DCN inside a datacenter,
datacenter LANs vs cross-region WAN for DiLoCo (arXiv:2311.08105), and
home uplinks vs the internet for federated averaging. A flat network is
the special case ``nodes_per_host=1`` (every hop inter) or
``intra == inter``; the cost model provably reduces to the flat closed
form there (``tests/test_sim.py``).

Bandwidths are bytes/second, latencies seconds. Presets are deliberately
round published numbers, not measurements — the simulator's job is
trade-off *ordering* (which strategy wins where), not datasheet fidelity.

A copy of ``gym_tpu/sim/topology.py``, which imports no JAX;
``tests/test_torch_sim.py`` pins the copy to its original.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union


@dataclasses.dataclass(frozen=True)
class Link:
    bandwidth: float  # bytes / second
    latency: float    # seconds (the alpha in the alpha-beta model)

    def __post_init__(self):
        if self.bandwidth <= 0 or self.latency < 0:
            raise ValueError(f"invalid link {self!r}")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Hierarchical (intra/inter-host) node network.

    ``ring_links(group)`` yields the per-hop links of a ring over nodes
    ``0..group-1`` in index order (node ``i``'s host is
    ``i // nodes_per_host``) — the participant sets of the gym's
    collectives are node-index prefixes, so this is exact for them and a
    bottleneck-faithful approximation for randomized subgroups (islands,
    partial participation).
    """

    name: str
    num_nodes: int
    intra: Link
    inter: Link
    nodes_per_host: int = 1

    def __post_init__(self):
        if self.num_nodes < 1 or self.nodes_per_host < 1:
            raise ValueError(
                f"bad topology sizes: num_nodes={self.num_nodes}, "
                f"nodes_per_host={self.nodes_per_host}")

    def link(self, i: int, j: int) -> Link:
        """The link a message from node ``i`` to node ``j`` crosses."""
        same_host = (i // self.nodes_per_host) == (j // self.nodes_per_host)
        return self.intra if same_host else self.inter

    def ring_links(self, group: int) -> List[Link]:
        """Per-hop links of the ring 0 → 1 → … → group−1 → 0."""
        g = max(1, min(int(group), self.num_nodes))
        if g == 1:
            return []
        return [self.link(i, (i + 1) % g) for i in range(g)]

    def bottleneck(self, group: int) -> Link:
        """Slowest link in the group's ring (max latency, min bandwidth —
        evaluated jointly per hop by the cost model; this helper reports
        the single worst hop for tree-shaped collectives)."""
        links = self.ring_links(group)
        if not links:
            return self.intra
        return min(links, key=lambda l: (l.bandwidth, -l.latency))

    def config(self) -> dict:
        return {
            "topology": self.name,
            "num_nodes": self.num_nodes,
            "nodes_per_host": self.nodes_per_host,
            "intra_bw_Bps": self.intra.bandwidth,
            "intra_lat_s": self.intra.latency,
            "inter_bw_Bps": self.inter.bandwidth,
            "inter_lat_s": self.inter.latency,
        }


# -- presets ---------------------------------------------------------------

_GBPS = 1e9 / 8  # bytes/sec per Gbit/sec


def _datacenter(num_nodes: int) -> Topology:
    # intra-host: TPU-pod-slice-class ICI (~400 Gbps, sub-10µs);
    # inter-host: 25 Gbps DCN at ~100 µs — one accelerator host per
    # 4 simulated nodes.
    return Topology("datacenter", num_nodes,
                    intra=Link(400 * _GBPS, 10e-6),
                    inter=Link(25 * _GBPS, 100e-6),
                    nodes_per_host=min(4, num_nodes))


def _wan(num_nodes: int) -> Topology:
    # cross-region DiLoCo: every node is its own site; 1 Gbps WAN links
    # at 50 ms RTT-ish latency (the arXiv:2311.08105 / DeMo regime).
    return Topology("wan", num_nodes,
                    intra=Link(1 * _GBPS, 50e-3),
                    inter=Link(1 * _GBPS, 50e-3),
                    nodes_per_host=1)


def _federated(num_nodes: int) -> Topology:
    # consumer-uplink federated: 50 Mbps uplinks, 30 ms latency.
    return Topology("federated", num_nodes,
                    intra=Link(50e6 / 8, 30e-3),
                    inter=Link(50e6 / 8, 30e-3),
                    nodes_per_host=1)


PRESETS = {
    "datacenter": _datacenter,
    "wan": _wan,
    "cross-region": _wan,       # alias: the DiLoCo setting
    "federated": _federated,
    "consumer-uplink": _federated,
}


def resolve_topology(spec: Union[str, Topology],
                     num_nodes: Optional[int] = None) -> Topology:
    """A preset name or an explicit Topology → Topology sized to
    ``num_nodes`` (explicit topologies are validated against it)."""
    if isinstance(spec, Topology):
        if num_nodes is not None and spec.num_nodes < num_nodes:
            raise ValueError(
                f"topology {spec.name!r} has {spec.num_nodes} nodes but "
                f"the run simulates {num_nodes}")
        return spec
    try:
        factory = PRESETS[str(spec)]
    except KeyError:
        raise ValueError(
            f"unknown topology preset {spec!r}; known: "
            f"{sorted(set(PRESETS))}") from None
    return factory(num_nodes if num_nodes is not None else 1)
