"""Serving-frontier regression gate: the policy sweep's headline,
cost-model fast path, CI-cheap.

The committed artifact (``logs/servesim/frontier.csv`` +
``report.md``) prices the autoscale-policy grid on the deterministic
cost model (seeded traces, fixed service profile, the real
``AutoscaleController``). This gate re-runs the SAME default grid in a
few seconds and compares, per trace family, the headline quantity —
the cheapest policy's replica-seconds among cells meeting the SLO
attainment target — against a RECORDED baseline. The path is fully
deterministic, so any drift beyond float noise means a behavior
regression: the controller scaling later, admission pricing changing,
the queueing model slowing — exactly what ``sim/frontier_gate.py``
does for the training frontier.

    # record / refresh the baseline (once per intentional change):
    python -m gym_tpu_torch.servesim.frontier_gate --record \\
        logs/servesim/frontier_baseline.json
    # CI check (scripts/ci_deploy.sh):
    python -m gym_tpu_torch.servesim.frontier_gate --baseline \\
        logs/servesim/frontier_baseline.json

A copy of ``gym_tpu/servesim/frontier_gate.py``, which imports no JAX; ``tests/test_torch_servesim.py``
pins the copy to its original.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

from .sweep import ServeSweepConfig, best_cost_at_slo, grid, run_cell
from .sweep import _trace_for


def fast_frontier(cfg: Optional[ServeSweepConfig] = None
                  ) -> Dict[str, Any]:
    """Run the default policy grid through the cost model (no disk, no
    resumability — the gate wants the numbers, not the artifact) and
    return the per-family headline."""
    cfg = cfg or ServeSweepConfig()
    traces = {tr: _trace_for(cfg, tr) for tr in cfg.traces}
    rows: List[Dict[str, Any]] = [
        run_cell(cell, cfg, traces[cell.trace]) for cell in grid(cfg)]
    families: Dict[str, Any] = {}
    for tr in cfg.traces:
        best = best_cost_at_slo(rows, tr, cfg.slo_attainment_target)
        families[tr] = (None if best is None else {
            "policy": best["policy"],
            "replica_seconds": best["replica_seconds"],
            "ttft_p99_s": best["ttft_p99_s"],
            "shed_rate": best["shed_rate"],
            "slo_attainment": best["slo_attainment"],
        })
    return {
        "slo_ttft_s": cfg.slo_ttft_s,
        "slo_attainment_target": cfg.slo_attainment_target,
        "cells": len(rows),
        "families": families,
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Serving-policy frontier regression gate: fail if "
                    "the cheapest SLO-meeting policy's cost grows (or "
                    "a family stops meeting the SLO at all)")
    p.add_argument("--baseline",
                   default=os.path.join("logs", "servesim",
                                        "frontier_baseline.json"))
    p.add_argument("--record", metavar="PATH", default=None,
                   help="write the current frontier as the new "
                        "baseline to PATH and exit 0")
    p.add_argument("--rel-tol", type=float, default=0.02,
                   help="allowed relative replica-seconds growth (the "
                        "path is deterministic; 2%% absorbs float/"
                        "platform noise only)")
    args = p.parse_args(argv)

    cur = fast_frontier()
    if args.record:
        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(cur, f, indent=2)
        print(f"servesim frontier_gate: recorded baseline at "
              f"{args.record}")
        for tr, best in cur["families"].items():
            print(f"  {tr}: " + (
                "NO SLO-meeting policy" if best is None else
                f"{best['policy']} = {best['replica_seconds']:.0f} "
                f"replica-s"))
        return 0

    try:
        with open(args.baseline) as f:
            ref = json.load(f)
    except OSError as e:
        print(f"servesim frontier_gate: cannot read baseline "
              f"{args.baseline}: {e}")
        return 2
    ok = True
    for tr, ref_best in ref["families"].items():
        best = cur["families"].get(tr)
        if ref_best is None:
            continue     # the baseline never met the SLO here
        if best is None:
            print(f"servesim frontier_gate[{tr}]: baseline met the "
                  f"SLO with {ref_best['policy']} but NO current "
                  f"policy does -> REGRESSION")
            ok = False
            continue
        ceil = ref_best["replica_seconds"] * (1.0 + args.rel_tol)
        verdict = best["replica_seconds"] <= ceil
        print(f"servesim frontier_gate[{tr}]: cheapest SLO-meeting "
              f"policy {best['policy']} = "
              f"{best['replica_seconds']:.1f} replica-s "
              f"(baseline {ref_best['replica_seconds']:.1f}, ceiling "
              f"{ceil:.1f}) -> {'OK' if verdict else 'REGRESSION'}")
        ok = ok and verdict
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
