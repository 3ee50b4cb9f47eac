"""Frontier regression gate: the compressed-gossip headline, cost-model
fast path, CI-cheap (counterpart of ``gym_tpu/sim/frontier_gate.py``,
against the same committed baseline).

The acceptance sweep (``gym_tpu_torch.sim.sweep``) measures real fits; this
gate re-prices the SAME family — {AllReduce, DiLoCo, NoLoCo, DynamiQ,
decoupled momentum} × {dense, int8, int4, top-k} — through the pure
alpha-beta cost model (``comm_events`` → ``NetworkSimulator``; no
devices, no fits, milliseconds) and compares the best compressed-gossip
speedup over AllReduce against a RECORDED baseline stored beside the
committed ``frontier.csv``. Because the path is fully deterministic
(host-replayed traces, fixed compute estimate), any drop beyond float
noise means a pricing or accounting regression — a codec whose
``wire_bytes`` grew, a gossip round priced as a serial chain again, a
trace that stopped declaring its compressed bytes — and the gate fails.

    # the check (scripts/ci_torch_sim.sh); the baseline is read, and
    # --record PATH writes a new one elsewhere:
    python -m gym_tpu_torch.sim.frontier_gate --baseline logs/frontier/frontier_baseline.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict, List, Optional

# the sweep family at the gate's fixed shape: one strategy ctor per
# (strategy, codec) cell, mirroring sweep.make_strategy
_CODECS = ("dense", "int8", "int4", "topk")


def _params_template(n_layer: int = 2, n_embd: int = 64,
                     block_size: int = 64):
    """The sweep workload's per-node parameter shapes (f32, no weights:
    ``sim.node_template``) from the port's ``GPT`` — the gate prices the
    same payload the acceptance sweep ships."""
    import torch

    from ..models.nanogpt import GPT, GPTConfig
    from .template import node_template

    cfg = GPTConfig(block_size=block_size, vocab_size=65, n_layer=n_layer,
                    n_head=max(1, n_embd // 32), n_embd=n_embd,
                    dropout=0.0, bias=True)
    specs = GPT(cfg)._param_specs()
    return node_template({name: torch.empty((), dtype=torch.float32)
                          .expand(shape)
                          for name, (shape, _) in specs.items()},
                         device="cpu")


def family_cells(H: int = 10,
                 topk_frac: float = 0.05) -> List[Dict[str, Any]]:
    """(strategy, codec) cells of the whole low-communication family."""
    cells = [{"strategy": "simple_reduce", "codec": None, "H": None}]
    for s in ("diloco", "noloco", "demo_outer"):
        for c in _CODECS:
            cells.append({"strategy": s,
                          "codec": None if c == "dense" else c, "H": H})
    for c in _CODECS[1:]:                      # dynamiq is never dense
        cells.append({"strategy": "dynamiq", "codec": c, "H": None})
    return cells


def fast_frontier(preset: str = "federated", nodes: int = 4,
                  steps: int = 30, H: int = 10,
                  compute_s_per_step: float = 0.05,
                  topk_frac: float = 0.05) -> Dict[str, Any]:
    """Price every family cell on ``preset`` and report speedups vs
    AllReduce plus the best compressed-gossip (NoLoCo × non-dense
    codec) cell — the headline quantity."""
    from .simulator import NetworkSimulator
    from .sweep import make_strategy

    params = _params_template()
    rows: Dict[str, Dict[str, Any]] = {}
    for cell in family_cells(H=H, topk_frac=topk_frac):
        strategy = make_strategy(cell["strategy"], cell["H"], 1e-3,
                                 cell["codec"], topk_frac)
        strategy.finalize(steps)
        sim = NetworkSimulator(strategy, params, nodes, preset)
        total = sim.simulate(steps, compute_s_per_step).total_s
        label = cell["strategy"] + (f"_{cell['codec']}"
                                    if cell["codec"] else "")
        rows[label] = {"strategy": cell["strategy"],
                       "codec": cell["codec"], "sim_total_s": total}
    base = rows["simple_reduce"]["sim_total_s"]
    best_label, best = None, 0.0
    for label, r in rows.items():
        r["speedup"] = base / r["sim_total_s"] if r["sim_total_s"] else None
        if (r["strategy"] == "noloco" and r["codec"] is not None
                and r["speedup"] and r["speedup"] > best):
            best_label, best = label, r["speedup"]
    return {
        "preset": preset, "nodes": nodes, "steps": steps, "H": H,
        "compute_s_per_step": compute_s_per_step,
        "topk_frac": topk_frac,
        "allreduce_sim_s": base,
        "cells": rows,
        "best_compressed_gossip": {"config": best_label, "speedup": best},
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Cost-model frontier regression gate: fail if the "
                    "best compressed-gossip speedup drops below the "
                    "recorded baseline")
    p.add_argument("--preset", default="federated")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--H", type=int, default=10)
    p.add_argument("--compute", type=float, default=0.05,
                   help="modeled compute seconds per step")
    p.add_argument("--topk_frac", type=float, default=0.05)
    p.add_argument("--baseline",
                   default=os.path.join("logs", "frontier",
                                        "frontier_baseline.json"),
                   help="recorded baseline to gate against")
    p.add_argument("--record", metavar="PATH", default=None,
                   help="write the current frontier as the new baseline "
                        "to PATH and exit 0")
    p.add_argument("--rel-tol", type=float, default=0.01,
                   help="allowed relative drop before failing (the path "
                        "is deterministic; 1%% absorbs float/platform "
                        "noise only)")
    args = p.parse_args(argv)

    cur = fast_frontier(args.preset, args.nodes, args.steps, args.H,
                        args.compute, args.topk_frac)
    best = cur["best_compressed_gossip"]
    if args.record:
        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(cur, f, indent=2)
        print(f"frontier_gate: recorded baseline at {args.record} "
              f"(best compressed gossip: {best['config']} "
              f"{best['speedup']:.2f}x)")
        return 0

    try:
        with open(args.baseline) as f:
            ref = json.load(f)
    except OSError as e:
        print(f"frontier_gate: cannot read baseline {args.baseline}: {e}")
        return 2
    ref_best = ref["best_compressed_gossip"]
    floor = ref_best["speedup"] * (1.0 - args.rel_tol)
    ok = (best["speedup"] is not None
          and math.isfinite(best["speedup"])
          and best["speedup"] >= floor)
    print(f"frontier_gate[{cur['preset']} x {cur['nodes']}]: best "
          f"compressed gossip {best['config']} = "
          f"{best['speedup']:.2f}x vs AllReduce "
          f"(baseline {ref_best['config']} = {ref_best['speedup']:.2f}x, "
          f"floor {floor:.2f}x) -> {'OK' if ok else 'REGRESSION'}")
    if not ok:
        # name the cells so the failure is actionable without rerunning
        for label, r in sorted(cur["cells"].items()):
            print(f"  {label}: {r['sim_total_s']:.3f}s "
                  f"({r['speedup']:.2f}x)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
