"""Tenant-isolation frontier regression gate: the
class-mix × quota-policy sweep's headline, cost-model fast path,
CI-cheap — the multi-tenant sibling of ``frontier_gate.py``.

The committed artifact (``logs/servesim/tenant/frontier.csv`` +
``report.md``) prices the quota-policy grid on the deterministic cost
model (seeded multi-tenant traces, fixed fleet, the modeled twins of
the scheduler's token buckets and the engine's preemptible decode).
This gate re-runs the SAME default grid in seconds and checks, per
workload group:

- **Isolation holds**: every group where the baseline's best policy
  met the interactive SLO attainment target must still have SOME
  policy meeting it — losing that is the regression the tentpole
  exists to prevent.
- **Goodput holds**: the best policy's kept batch tokens must not
  drop below the baseline beyond ``--rel-tol`` (isolation that
  silently starves the neighbor harder is also a regression).
- **Structural invariant** (baseline-free): on ``noisy_neighbor``,
  ``quota+preempt`` must achieve interactive attainment ≥ ``none`` —
  if turning isolation ON ever hurts the victim, the machinery is
  wired backwards.

    # record / refresh the baseline (once per intentional change):
    python -m gym_tpu_torch.servesim.tenant_gate --record \\
        logs/servesim/tenant/tenant_baseline.json
    # CI check (scripts/ci_deploy.sh):
    python -m gym_tpu_torch.servesim.tenant_gate --baseline \\
        logs/servesim/tenant/tenant_baseline.json

A copy of ``gym_tpu/servesim/tenant_gate.py``, which imports no JAX; ``tests/test_torch_servesim.py``
pins the copy to its original.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

from .sweep import (TenantSweepConfig, best_isolation_policy,
                    run_tenant_cell, tenant_grid)


def fast_tenant_frontier(cfg: Optional[TenantSweepConfig] = None
                         ) -> Dict[str, Any]:
    """Run the default quota-policy grid through the cost model (no
    disk, no resumability) and return the per-group headline plus the
    raw rows the structural checks read."""
    cfg = cfg or TenantSweepConfig()
    rows: List[Dict[str, Any]] = [
        run_tenant_cell(cell, cfg) for cell in tenant_grid(cfg)]
    groups: Dict[str, Any] = {}
    for grp in sorted({r["group"] for r in rows}):
        best = best_isolation_policy(rows, grp,
                                     cfg.slo_attainment_target)
        groups[grp] = (None if best is None else {
            "policy": best["policy"],
            "inter_ttft_p99_s": best["inter_ttft_p99_s"],
            "inter_slo_attainment": best["inter_slo_attainment"],
            "batch_tokens_out": best["batch_tokens_out"],
            "preemptions": best["preemptions"],
        })
    return {
        "slo_ttft_s": cfg.slo_ttft_s,
        "slo_attainment_target": cfg.slo_attainment_target,
        "cells": len(rows),
        "groups": groups,
        "rows": [{k: v for k, v in r.items() if k != "by_class"}
                 for r in rows],
    }


def structural_check(cur: Dict[str, Any]) -> bool:
    """Baseline-free invariant: isolation ON must not hurt the victim
    on the headline noisy-neighbor workload."""
    att = {r["policy"]: (r["inter_slo_attainment"] or 0.0)
           for r in cur["rows"] if r["trace"] == "noisy_neighbor"}
    if not att:
        return True
    on, off = att.get("quota+preempt", 0.0), att.get("none", 0.0)
    ok = on >= off
    print(f"tenant_gate[structural]: noisy_neighbor interactive "
          f"attainment quota+preempt={on:.1%} vs none={off:.1%} -> "
          f"{'OK' if ok else 'ISOLATION WIRED BACKWARDS'}")
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Tenant-isolation frontier regression gate: fail "
                    "if a workload group stops meeting the "
                    "interactive SLO, batch goodput collapses, or "
                    "isolation hurts the victim")
    p.add_argument("--baseline",
                   default=os.path.join("logs", "servesim", "tenant",
                                        "tenant_baseline.json"))
    p.add_argument("--record", metavar="PATH", default=None,
                   help="write the current frontier as the new "
                        "baseline to PATH and exit 0")
    p.add_argument("--rel-tol", type=float, default=0.02,
                   help="allowed relative batch-goodput shrink (the "
                        "path is deterministic; 2%% absorbs float/"
                        "platform noise only)")
    args = p.parse_args(argv)

    cur = fast_tenant_frontier()
    if args.record:
        os.makedirs(os.path.dirname(args.record) or ".",
                    exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(cur, f, indent=2)
        print(f"tenant_gate: recorded baseline at {args.record}")
        for grp, best in cur["groups"].items():
            print(f"  {grp}: " + (
                "NO SLO-meeting policy" if best is None else
                f"{best['policy']} @ "
                f"{best['inter_slo_attainment']:.1%} attainment, "
                f"{best['batch_tokens_out']} batch tokens kept"))
        return 0 if structural_check(cur) else 1

    ok = structural_check(cur)
    try:
        with open(args.baseline) as f:
            ref = json.load(f)
    except OSError as e:
        print(f"tenant_gate: cannot read baseline "
              f"{args.baseline}: {e}")
        return 2
    for grp, ref_best in ref["groups"].items():
        best = cur["groups"].get(grp)
        if ref_best is None:
            continue     # the baseline never met the SLO here
        if best is None:
            print(f"tenant_gate[{grp}]: baseline met the interactive "
                  f"SLO with {ref_best['policy']} but NO current "
                  f"policy does -> REGRESSION")
            ok = False
            continue
        floor = (ref_best["batch_tokens_out"]
                 * (1.0 - args.rel_tol))
        verdict = best["batch_tokens_out"] >= floor
        print(f"tenant_gate[{grp}]: best policy {best['policy']} "
              f"keeps {best['batch_tokens_out']} batch tokens at "
              f"{best['inter_slo_attainment']:.1%} attainment "
              f"(baseline {ref_best['batch_tokens_out']}, floor "
              f"{floor:.0f}) -> {'OK' if verdict else 'REGRESSION'}")
        ok = ok and verdict
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
