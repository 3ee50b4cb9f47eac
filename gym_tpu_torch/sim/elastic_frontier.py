"""Elastic-membership frontier gate: reshard-vs-cold-restart, cost-model
fast path, CI-cheap (counterpart of ``gym_tpu/sim/elastic_frontier.py``,
against the same committed baseline).

The sweep's membership-event cells (``--events join@k,leave@k``) measure
real elastic fits; this gate re-prices the SAME membership events — a
node joining and a node leaving at a mid-interval step, on every
topology preset — through the pure alpha-beta cost model (milliseconds,
no devices, no fits) and compares each event's cold-restart/reshard
latency ratio against a RECORDED baseline committed beside the sweep
frontiers. The path is fully deterministic (analytic collective events,
fixed compute estimate), so any drop beyond float noise is a pricing or
accounting regression: reshard events that stopped declaring their
bytes, a broadcast priced as free, a lost-step model that forgot the
recompute.

    # the check (scripts/ci_torch_elastic.sh); the baseline is read, and
    # --record PATH writes a new one elsewhere:
    python -m gym_tpu_torch.sim.elastic_frontier --baseline logs/frontier/elastic_frontier.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict, List, Optional

PRESETS = ("datacenter", "wan", "federated")


def _n_params(n_layer: int = 2, n_embd: int = 64,
              block_size: int = 64) -> int:
    """Per-node parameter count of the sweep workload (the payload the
    membership change redistributes)."""
    from .frontier_gate import _params_template

    params = _params_template(n_layer, n_embd, block_size)
    return sum(int(math.prod(x.shape)) for x in params.values())


def elastic_frontier(nodes: int = 4, steps: int = 30, event_step: int = 15,
                     checkpoint_interval: int = 10,
                     compute_s_per_step: float = 0.05) -> Dict[str, Any]:
    """Price join@k and leave@k on every preset: the reshard (collective
    redistribution of params + moments onto the new membership) against
    the cold restart (full-state broadcast to K' nodes PLUS recomputing
    the steps since the last periodic checkpoint — a preemption does not
    get a graceful final save)."""
    from ..elastic import cold_restart_events, reshard_events
    from .cost_model import events_time, events_tx_bytes
    from .topology import resolve_topology

    n = _n_params()
    lost_steps = event_step % checkpoint_interval
    cells: Dict[str, Dict[str, Any]] = {}
    for preset in PRESETS:
        for kind, k_to in (("join", nodes + 1), ("leave", nodes - 1)):
            topo = resolve_topology(preset, max(nodes, k_to))
            rev = reshard_events(n, nodes, k_to)
            reshard_s = events_time(rev, topo)
            cold_s = (events_time(cold_restart_events(n, k_to), topo)
                      + lost_steps * compute_s_per_step)
            cells[f"{preset}_{kind}@{event_step}"] = {
                "preset": preset, "event": f"{kind}@{event_step}",
                "nodes": nodes, "nodes_after": k_to,
                "reshard_s": reshard_s,
                "reshard_bytes": events_tx_bytes(rev),
                "cold_restart_s": cold_s,
                "speedup": cold_s / reshard_s if reshard_s else None,
            }
    worst = min((c for c in cells.values() if c["speedup"]),
                key=lambda c: c["speedup"])
    return {
        "n_params": n, "nodes": nodes, "steps": steps,
        "event_step": event_step,
        "checkpoint_interval": checkpoint_interval,
        "compute_s_per_step": compute_s_per_step,
        "lost_steps": lost_steps,
        "cells": cells,
        "worst_case": {"cell": f"{worst['preset']}_{worst['event']}",
                       "speedup": worst["speedup"]},
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Elastic membership frontier gate: fail if the "
                    "worst-case reshard-vs-cold-restart speedup drops "
                    "below the recorded baseline")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--event-step", type=int, default=15)
    p.add_argument("--checkpoint-interval", type=int, default=10)
    p.add_argument("--compute", type=float, default=0.05,
                   help="modeled compute seconds per step")
    p.add_argument("--baseline",
                   default=os.path.join("logs", "frontier",
                                        "elastic_frontier.json"),
                   help="recorded baseline to gate against")
    p.add_argument("--record", metavar="PATH", default=None,
                   help="write the current frontier as the new baseline "
                        "to PATH and exit 0")
    p.add_argument("--rel-tol", type=float, default=0.01,
                   help="allowed relative drop before failing (the path "
                        "is deterministic; 1%% absorbs float/platform "
                        "noise only)")
    args = p.parse_args(argv)

    cur = elastic_frontier(args.nodes, args.steps, args.event_step,
                           args.checkpoint_interval, args.compute)
    worst = cur["worst_case"]
    if args.record:
        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(cur, f, indent=2)
        print(f"elastic_frontier: recorded baseline at {args.record} "
              f"(worst case {worst['cell']}: reshard "
              f"{worst['speedup']:.2f}x faster than cold restart)")
        return 0

    try:
        with open(args.baseline) as f:
            ref = json.load(f)
    except OSError as e:
        print(f"elastic_frontier: cannot read baseline "
              f"{args.baseline}: {e}")
        return 2
    ref_worst = ref["worst_case"]
    floor = ref_worst["speedup"] * (1.0 - args.rel_tol)
    ok = (worst["speedup"] is not None
          and math.isfinite(worst["speedup"])
          and worst["speedup"] >= floor
          and worst["speedup"] > 1.0)
    print(f"elastic_frontier[{cur['nodes']} nodes, "
          f"{len(cur['cells'])} membership events]: worst case "
          f"{worst['cell']} = {worst['speedup']:.2f}x vs cold restart "
          f"(baseline {ref_worst['cell']} = {ref_worst['speedup']:.2f}x, "
          f"floor {floor:.2f}x) -> {'OK' if ok else 'REGRESSION'}")
    if not ok:
        for label, c in sorted(cur["cells"].items()):
            print(f"  {label}: reshard {c['reshard_s']:.3f}s vs cold "
                  f"{c['cold_restart_s']:.3f}s ({c['speedup']:.2f}x)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
