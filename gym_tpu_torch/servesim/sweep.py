"""Serving-policy sweep: autoscale watermarks × replica bounds × trace
family, priced on the cost-model fast path.

The serving twin of ``sim/sweep.py``: where the training sweep prices
communication strategies on modeled networks, this one prices
AUTOSCALING POLICIES (drain-time watermarks, patience, cooldown,
replica bounds) against SLO attainment under the synthetic traffic
families — every cell one ``FleetCostModel.run`` (the real
``AutoscaleController`` on the modeled backlog), milliseconds per
point, the whole grid in seconds:

    python -m gym_tpu_torch.servesim.sweep --out logs/servesim

Resumable through the SAME crash-safe cell machinery as the training
sweep (``sim/gridlib``): each finished cell persists atomically as
``<out>/cells/<id>.json``; rerunning skips them; changing the workload
config wipes them.

Outputs: ``results.csv``/``results.json``, the cost-vs-SLO
``frontier.csv`` (replica-seconds ↓ vs p99 TTFT ↓ vs shed rate ↓ —
3-axis Pareto per trace family) and ``report.md`` with the
cheapest-policy-meeting-SLO headline per family. The committed
artifacts live under ``logs/servesim/`` with a regression gate
(``servesim/frontier_gate.py``), exactly as ``sim/frontier_gate.py``
gates the training frontier.

A copy of ``gym_tpu/servesim/sweep.py``, which imports no JAX; ``tests/test_torch_servesim.py``
pins the copy to its original.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from ..serve.autoscale import AutoscalePolicy
from ..sim import gridlib
from .cost_model import FleetCostModel, ServiceProfile, class_reports
from .traces import RequestEvent, make_trace, trace_stats


@dataclasses.dataclass
class ServeSweepConfig:
    """The grid axes + the fixed modeled workload under them."""

    traces: List[str] = dataclasses.field(
        default_factory=lambda: ["diurnal", "bursty", "flash_crowd"])
    up_drain_s: List[float] = dataclasses.field(
        default_factory=lambda: [2.0, 4.0])
    down_drain_s: List[float] = dataclasses.field(
        default_factory=lambda: [0.25, 0.5])
    up_patience: List[int] = dataclasses.field(
        default_factory=lambda: [1, 2, 4])
    cooldown: List[int] = dataclasses.field(
        default_factory=lambda: [2, 4])
    bounds: List[Tuple[int, int]] = dataclasses.field(
        default_factory=lambda: [(1, 2), (1, 4), (2, 6)])
    # modeled workload (part of the cell cache signature)
    duration_s: float = 120.0
    seed: int = 0
    tokens_per_s: float = 120.0
    num_slots: int = 4
    max_queue: int = 64
    request_overhead_s: float = 0.05
    startup_s: float = 5.0
    autoscale_interval_s: float = 1.0
    deadline_s: float = 10.0
    slo_ttft_s: float = 2.5
    #: the SLO bar for the "cheapest policy meeting the SLO" headline.
    #: 0.8, not 0.99: during a 5-6x surge a REACTIVE autoscaler
    #: necessarily degrades the requests that arrive inside its
    #: (patience x interval + startup_s) reaction window — the sweep's
    #: finding, not a bug — so a 99% bar under these traces would
    #: simply have no qualifying cells
    slo_attainment_target: float = 0.8
    down_patience_mult: int = 4   # down_patience = mult × up_patience
    out: str = os.path.join("logs", "servesim")


@dataclasses.dataclass(frozen=True)
class PolicyCell:
    trace: str
    up_drain_s: float
    down_drain_s: float
    up_patience: int
    cooldown: int
    min_replicas: int
    max_replicas: int

    @property
    def cell_id(self) -> str:
        return (f"{self.trace}_u{self.up_drain_s:g}_d{self.down_drain_s:g}"
                f"_p{self.up_patience}_c{self.cooldown}"
                f"_r{self.min_replicas}-{self.max_replicas}")

    def policy_label(self) -> str:
        return (f"u{self.up_drain_s:g}/d{self.down_drain_s:g} "
                f"p{self.up_patience} c{self.cooldown} "
                f"[{self.min_replicas}..{self.max_replicas}]")


def grid(cfg: ServeSweepConfig) -> List[PolicyCell]:
    cells = []
    for tr in cfg.traces:
        for mn, mx in cfg.bounds:
            for u in cfg.up_drain_s:
                for d in cfg.down_drain_s:
                    for p in cfg.up_patience:
                        for c in cfg.cooldown:
                            cells.append(PolicyCell(
                                tr, u, d, p, c, mn, mx))
    return cells


def _trace_for(cfg: ServeSweepConfig, family: str
               ) -> List[RequestEvent]:
    """One deterministic trace per family, sized so a min-fleet
    saturates during the peaks (otherwise every policy is equally
    good and the sweep prices nothing). A ``replay:<serve.csv>``
    family sweeps a RECORDED arrival process (only the deadline knob
    applies — the shapes are the recording's)."""
    if family.startswith("replay:"):
        return make_trace(family, deadline_s=cfg.deadline_s)
    shape = dict(prompt_lens=(8, 48), max_news=(12, 32),
                 deadline_s=cfg.deadline_s, deadline_frac=1.0,
                 duration_s=cfg.duration_s)
    if family == "diurnal":
        kw = dict(base_rps=8.0, amplitude=0.8, **shape)
    elif family == "bursty":
        kw = dict(calm_rps=2.0, burst_rps=16.0, mean_calm_s=15.0,
                  mean_burst_s=5.0, **shape)
    elif family == "flash_crowd":
        kw = dict(base_rps=3.0, flash_at_s=cfg.duration_s / 4,
                  flash_mult=6.0, flash_len_s=cfg.duration_s / 6,
                  **shape)
    else:
        kw = shape
    return make_trace(family, seed=cfg.seed, **kw)


def run_cell(cell: PolicyCell, cfg: ServeSweepConfig,
             events: List[RequestEvent]) -> Dict[str, Any]:
    policy = AutoscalePolicy(
        min_replicas=cell.min_replicas,
        max_replicas=cell.max_replicas,
        up_drain_s=cell.up_drain_s, down_drain_s=cell.down_drain_s,
        up_patience=cell.up_patience,
        down_patience=cfg.down_patience_mult * cell.up_patience,
        cooldown=cell.cooldown)
    profile = ServiceProfile(
        tokens_per_s=cfg.tokens_per_s, num_slots=cfg.num_slots,
        max_queue=cfg.max_queue,
        request_overhead_s=cfg.request_overhead_s,
        startup_s=cfg.startup_s)
    res = FleetCostModel(
        profile, policy, initial_replicas=cell.min_replicas,
        autoscale=True,
        autoscale_interval_s=cfg.autoscale_interval_s).run(events)
    rep = res.report(slo_ttft_s=cfg.slo_ttft_s)
    return {
        "cell": cell.cell_id,
        "trace": cell.trace,
        "policy": cell.policy_label(),
        "up_drain_s": cell.up_drain_s,
        "down_drain_s": cell.down_drain_s,
        "up_patience": cell.up_patience,
        "down_patience": cfg.down_patience_mult * cell.up_patience,
        "cooldown": cell.cooldown,
        "min_replicas": cell.min_replicas,
        "max_replicas": cell.max_replicas,
        "requests": rep["requests"],
        "done": rep["done"],
        "shed_rate": rep["shed_rate"],
        "ttft_p50_s": rep["ttft_p50_s"],
        "ttft_p99_s": rep["ttft_p99_s"],
        "slo_attainment": rep["slo_attainment"],
        "replica_seconds": rep["replica_seconds"],
        "spawns": rep["spawns"],
        "retires": rep["retires"],
        "max_replicas_seen": rep["max_replicas"],
    }


def pareto_frontier(group: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """3-axis Pareto within one trace family: replica-seconds ↓ (cost),
    p99 TTFT ↓ and shed rate ↓ (the two SLO axes). A cell with no
    completed requests (p99 None) never reaches the frontier."""
    rows = [r for r in group if r.get("ttft_p99_s") is not None]

    def dominated(r):
        return any(
            o is not r
            and o["replica_seconds"] <= r["replica_seconds"]
            and o["ttft_p99_s"] <= r["ttft_p99_s"]
            and o["shed_rate"] <= r["shed_rate"]
            and (o["replica_seconds"] < r["replica_seconds"]
                 or o["ttft_p99_s"] < r["ttft_p99_s"]
                 or o["shed_rate"] < r["shed_rate"])
            for o in rows)

    return sorted((r for r in rows if not dominated(r)),
                  key=lambda r: r["replica_seconds"])


def write_frontier_csv(path: str, rows: List[Dict[str, Any]]) -> None:
    """``frontier.csv``: every cell with its Pareto verdict, grouped by
    trace family — the artifact that answers 'which policy wins where'
    without eyeballing results.csv."""
    out: List[Dict[str, Any]] = []
    for tr in sorted({r["trace"] for r in rows}):
        group = [r for r in rows if r["trace"] == tr]
        front = {id(r) for r in pareto_frontier(group)}
        for r in sorted(group,
                        key=lambda r: r["replica_seconds"] or 0.0):
            out.append({
                "trace": tr, "policy": r["policy"],
                "up_drain_s": r["up_drain_s"],
                "down_drain_s": r["down_drain_s"],
                "up_patience": r["up_patience"],
                "cooldown": r["cooldown"],
                "replicas": (f"{r['min_replicas']}.."
                             f"{r['max_replicas']}"),
                "replica_seconds": r["replica_seconds"],
                "ttft_p99_s": r["ttft_p99_s"],
                "shed_rate": r["shed_rate"],
                "slo_attainment": r["slo_attainment"],
                "on_frontier": id(r) in front,
            })
    gridlib.write_csv(path, out)


def best_cost_at_slo(rows: List[Dict[str, Any]], trace: str,
                     target: float) -> Optional[Dict[str, Any]]:
    """The headline quantity per family: the CHEAPEST (fewest
    replica-seconds) policy whose SLO attainment meets ``target`` —
    what you would actually deploy."""
    ok = [r for r in rows if r["trace"] == trace
          and (r["slo_attainment"] or 0.0) >= target]
    return (min(ok, key=lambda r: r["replica_seconds"])
            if ok else None)


def write_report(rows: List[Dict[str, Any]], cfg: ServeSweepConfig,
                 stats_by_trace: Dict[str, Dict[str, Any]]) -> str:
    lines = ["# Serving-policy sweep (cost-model fast path)", ""]
    lines.append(
        f"Modeled replica: {cfg.tokens_per_s:g} tok/s saturated over "
        f"{cfg.num_slots} slots, {cfg.request_overhead_s * 1e3:.0f} ms "
        f"per-request overhead, {cfg.startup_s:g} s spawn latency, "
        f"queue {cfg.max_queue}. Every request carries a "
        f"{cfg.deadline_s:g} s deadline; SLO: TTFT ≤ "
        f"{cfg.slo_ttft_s:g} s on ≥ {cfg.slo_attainment_target:.0%} "
        f"of offered requests. Decisions by the REAL "
        f"`AutoscaleController.tick` at "
        f"{cfg.autoscale_interval_s:g} s cadence "
        f"(down_patience = {cfg.down_patience_mult} × up_patience).")
    lines.append("")
    for tr in cfg.traces:
        st = stats_by_trace.get(tr, {})
        lines.append(f"## {tr} ({st.get('requests')} requests, "
                     f"peak {st.get('peak_rps_1s')} rps)")
        lines.append("")
        best = best_cost_at_slo(rows, tr, cfg.slo_attainment_target)
        if best is not None:
            lines.append(
                f"**Cheapest policy meeting the SLO: "
                f"`{best['policy']}` — "
                f"{best['replica_seconds']:.0f} replica-seconds, "
                f"p99 TTFT {best['ttft_p99_s']:.2f}s, shed rate "
                f"{best['shed_rate']:.1%}, attainment "
                f"{best['slo_attainment']:.1%}.**")
        else:
            lines.append("**No policy in the grid meets the SLO on "
                         "this trace — widen max_replicas.**")
        lines.append("")
        lines.append("| policy | replica-s | p99 TTFT (s) | shed | "
                     "SLO att. | spawns | frontier |")
        lines.append("|---|---|---|---|---|---|---|")
        group = [r for r in rows if r["trace"] == tr]
        front = {id(r) for r in pareto_frontier(group)}
        for r in sorted(group,
                        key=lambda r: r["replica_seconds"] or 0.0):
            p99 = r["ttft_p99_s"]
            lines.append(
                f"| {r['policy']} | {r['replica_seconds']:.0f} "
                f"| {p99 if p99 is None else f'{p99:.2f}'} "
                f"| {r['shed_rate']:.1%} "
                f"| {(r['slo_attainment'] or 0.0):.1%} "
                f"| {r['spawns']} "
                f"| {'YES' if id(r) in front else ''} |")
        lines.append("")
    lines.append("Per-cell Pareto verdicts: `frontier.csv`. "
                 "Regression gate: `python -m "
                 "gym_tpu_torch.servesim.frontier_gate`.")
    lines.append("")
    return "\n".join(lines)


def _workload_sig(cfg: ServeSweepConfig) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d.pop("out", None)
    # round-trip through json so the marker comparison sees the same
    # types it will read back (tuples become lists)
    return json.loads(json.dumps(d))


def run_sweep(cfg: ServeSweepConfig) -> List[Dict[str, Any]]:
    gridlib.invalidate_if_stale(cfg.out, _workload_sig(cfg))
    cells = grid(cfg)
    traces = {tr: _trace_for(cfg, tr) for tr in cfg.traces}
    stats_by_trace = {tr: trace_stats(ev) for tr, ev in traces.items()}

    def _run_one(i: int) -> Dict[str, Any]:
        cell = cells[i]
        return run_cell(cell, cfg, traces[cell.trace])

    rows = gridlib.run_cells(cfg.out, [c.cell_id for c in cells],
                             _run_one)
    gridlib.write_csv(os.path.join(cfg.out, "results.csv"), rows)
    write_frontier_csv(os.path.join(cfg.out, "frontier.csv"), rows)
    gridlib.atomic_json(os.path.join(cfg.out, "results.json"),
                        {"config": dataclasses.asdict(cfg),
                         "traces": stats_by_trace, "rows": rows})
    report = write_report(rows, cfg, stats_by_trace)
    with open(os.path.join(cfg.out, "report.md"), "w") as f:
        f.write(report)
    print(f"\nreport: {os.path.join(cfg.out, 'report.md')}")
    return rows


# -- multi-tenant sweep: class-mix × quota-policy ---------------

#: the quota-policy axis — name → (quotas builder arg, preempt). The
#: ``batch_share`` placeholder is resolved per-config so the CLI can
#: move the knob without redefining the axis.
TENANT_POLICIES = ("none", "quota", "preempt", "quota+preempt")


@dataclasses.dataclass
class TenantSweepConfig:
    """Grid axes for the isolation sweep: trace family × class mix ×
    quota policy, on a FIXED fleet (no autoscaling — the question is
    what quotas/preemption buy at constant cost, so replica-seconds is
    held flat and the cost axis becomes forfeited batch goodput)."""

    traces: List[str] = dataclasses.field(
        default_factory=lambda: ["noisy_neighbor", "mixed_slo"])
    policies: List[str] = dataclasses.field(
        default_factory=lambda: list(TENANT_POLICIES))
    #: the class-mix axis (applies to ``mixed_slo``; ``noisy_neighbor``
    #: fixes its own two-tenant mix)
    interactive_fracs: List[float] = dataclasses.field(
        default_factory=lambda: [0.25, 0.5])
    batch_share: float = 0.5
    duration_s: float = 90.0
    seed: int = 0
    tokens_per_s: float = 120.0
    num_slots: int = 4
    max_queue: int = 64
    request_overhead_s: float = 0.05
    replicas: int = 2
    mixed_total_rps: float = 8.0
    #: the interactive-class SLO the frontier is judged against
    slo_ttft_s: float = 2.0
    slo_attainment_target: float = 0.9
    out: str = os.path.join("logs", "servesim", "tenant")


@dataclasses.dataclass(frozen=True)
class TenantCell:
    trace: str
    policy: str
    #: None for families whose mix is fixed by the family itself
    interactive_frac: Optional[float]

    @property
    def cell_id(self) -> str:
        mix = ("" if self.interactive_frac is None
               else f"_mix{self.interactive_frac:g}")
        return f"{self.trace}{mix}_{self.policy.replace('+', '-')}"

    @property
    def group_id(self) -> str:
        """The frontier groups cells that share a workload and differ
        only in policy."""
        mix = ("" if self.interactive_frac is None
               else f" mix={self.interactive_frac:g}")
        return f"{self.trace}{mix}"


def tenant_grid(cfg: TenantSweepConfig) -> List[TenantCell]:
    cells = []
    for tr in cfg.traces:
        mixes = (cfg.interactive_fracs if tr == "mixed_slo"
                 else [None])
        for mix in mixes:
            for pol in cfg.policies:
                cells.append(TenantCell(tr, pol, mix))
    return cells


def _tenant_trace(cfg: TenantSweepConfig, cell: TenantCell
                  ) -> List[RequestEvent]:
    if cell.trace == "mixed_slo":
        return make_trace(
            "mixed_slo", seed=cfg.seed, duration_s=cfg.duration_s,
            total_rps=cfg.mixed_total_rps,
            interactive_frac=float(cell.interactive_frac or 0.5))
    return make_trace(cell.trace, seed=cfg.seed,
                      duration_s=cfg.duration_s)


def _policy_args(cfg: TenantSweepConfig, policy: str):
    quotas = ({"batch": {"share": cfg.batch_share}}
              if "quota" in policy else None)
    return quotas, ("preempt" in policy)


def run_tenant_cell(cell: TenantCell, cfg: TenantSweepConfig
                    ) -> Dict[str, Any]:
    events = _tenant_trace(cfg, cell)
    quotas, preempt = _policy_args(cfg, cell.policy)
    profile = ServiceProfile(
        tokens_per_s=cfg.tokens_per_s, num_slots=cfg.num_slots,
        max_queue=cfg.max_queue,
        request_overhead_s=cfg.request_overhead_s)
    res = FleetCostModel(
        profile, initial_replicas=cfg.replicas, autoscale=False,
        quotas=quotas, preempt=preempt).run(events)
    per = class_reports(events, res.outcomes,
                        slo_ttft_s=cfg.slo_ttft_s)
    inter = per.get("interactive", per.get("standard", {}))
    batch = per.get("batch", {})
    return {
        "cell": cell.cell_id,
        "group": cell.group_id,
        "trace": cell.trace,
        "policy": cell.policy,
        "interactive_frac": cell.interactive_frac,
        "requests": len(events),
        "inter_ttft_p50_s": inter.get("ttft_p50_s"),
        "inter_ttft_p99_s": inter.get("ttft_p99_s"),
        "inter_slo_attainment": inter.get("slo_attainment"),
        "inter_shed_rate": inter.get("shed_rate"),
        "batch_tokens_out": batch.get("tokens_out", 0),
        "batch_shed_rate": batch.get("shed_rate"),
        "preemptions": res.preemptions,
        "quota_rejected": sum(res.quota_rejected.values()),
        "replica_seconds": round(res.replica_seconds, 1),
        "by_class": per,
    }


def best_isolation_policy(rows: List[Dict[str, Any]], group: str,
                          target: float) -> Optional[Dict[str, Any]]:
    """The headline per workload group: among policies whose
    INTERACTIVE attainment meets ``target``, the one forfeiting the
    least batch goodput — isolation at the lowest cost to the
    neighbor being isolated against."""
    ok = [r for r in rows if r["group"] == group
          and (r["inter_slo_attainment"] or 0.0) >= target]
    return (max(ok, key=lambda r: (r["batch_tokens_out"] or 0,
                                   r["policy"]))
            if ok else None)


def write_tenant_report(rows: List[Dict[str, Any]],
                        cfg: TenantSweepConfig) -> str:
    lines = ["# Multi-tenant isolation sweep "
             "(class-mix × quota-policy, cost-model fast path)", ""]
    lines.append(
        f"Fixed fleet of {cfg.replicas} modeled replicas "
        f"({cfg.tokens_per_s:g} tok/s over {cfg.num_slots} slots "
        f"each); interactive SLO: TTFT ≤ {cfg.slo_ttft_s:g} s on ≥ "
        f"{cfg.slo_attainment_target:.0%} of offered interactive "
        f"requests. Cost axis: batch tokens forfeited to shedding/"
        f"quota — replica-seconds is constant by construction.")
    lines.append("")
    for grp in sorted({r["group"] for r in rows}):
        lines.append(f"## {grp}")
        lines.append("")
        best = best_isolation_policy(rows, grp,
                                     cfg.slo_attainment_target)
        if best is not None:
            lines.append(
                f"**Best isolation policy: `{best['policy']}` — "
                f"interactive p99 TTFT "
                f"{best['inter_ttft_p99_s']:.3f}s at "
                f"{best['inter_slo_attainment']:.1%} attainment, "
                f"{best['batch_tokens_out']} batch tokens kept.**")
        else:
            lines.append("**No policy meets the interactive SLO on "
                         "this workload — the fleet is undersized.**")
        lines.append("")
        lines.append("| policy | inter p99 TTFT (s) | inter SLO att. "
                     "| batch tokens | batch shed | preempts "
                     "| quota rej |")
        lines.append("|---|---|---|---|---|---|---|")
        for r in [r for r in rows if r["group"] == grp]:
            p99 = r["inter_ttft_p99_s"]
            lines.append(
                f"| {r['policy']} "
                f"| {p99 if p99 is None else f'{p99:.3f}'} "
                f"| {(r['inter_slo_attainment'] or 0.0):.1%} "
                f"| {r['batch_tokens_out']} "
                f"| {(r['batch_shed_rate'] or 0.0):.1%} "
                f"| {r['preemptions']} | {r['quota_rejected']} |")
        lines.append("")
    lines.append("Regression gate: `python -m "
                 "gym_tpu_torch.servesim.tenant_gate`.")
    lines.append("")
    return "\n".join(lines)


def run_tenant_sweep(cfg: TenantSweepConfig) -> List[Dict[str, Any]]:
    sig = json.loads(json.dumps(dataclasses.asdict(cfg)))
    sig.pop("out", None)
    gridlib.invalidate_if_stale(cfg.out, sig)
    cells = tenant_grid(cfg)

    def _run_one(i: int) -> Dict[str, Any]:
        return run_tenant_cell(cells[i], cfg)

    rows = gridlib.run_cells(cfg.out, [c.cell_id for c in cells],
                             _run_one)
    flat = [{k: v for k, v in r.items() if k != "by_class"}
            for r in rows]
    gridlib.write_csv(os.path.join(cfg.out, "frontier.csv"), flat)
    gridlib.atomic_json(os.path.join(cfg.out, "results.json"),
                        {"config": dataclasses.asdict(cfg),
                         "rows": rows})
    with open(os.path.join(cfg.out, "report.md"), "w") as f:
        f.write(write_tenant_report(rows, cfg))
    print(f"\nreport: {os.path.join(cfg.out, 'report.md')}")
    return rows


def _floats(s: str) -> List[float]:
    return [float(x) for x in s.split(",") if x.strip()]


def _ints(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Autoscale-policy × replica-bounds × trace-family "
                    "sweep on the cost-model fast path (resumable; "
                    "rerun the same command after a crash)")
    p.add_argument("--tenant", action="store_true",
                   help="run the multi-tenant isolation sweep "
                        "(class-mix × quota-policy on a fixed fleet) "
                        "instead of the autoscale-policy sweep")
    p.add_argument("--traces", default="diurnal,bursty,flash_crowd")
    p.add_argument("--up-drain", default="2,4")
    p.add_argument("--down-drain", default="0.25,0.5")
    p.add_argument("--up-patience", default="1,2,4")
    p.add_argument("--cooldown", default="2,4")
    p.add_argument("--bounds", default="1-2,1-4,2-6",
                   help="comma list of min-max replica bounds (must "
                        "match ServeSweepConfig.bounds for the "
                        "committed artifact the gate re-prices)")
    p.add_argument("--duration", type=float, default=120.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokens-per-s", type=float, default=120.0)
    p.add_argument("--startup", type=float, default=5.0)
    p.add_argument("--slo-ttft", type=float, default=2.5)
    p.add_argument("--out", default=os.path.join("logs", "servesim"))
    args = p.parse_args(argv)

    if args.tenant:
        out = args.out
        if out == os.path.join("logs", "servesim"):
            out = os.path.join("logs", "servesim", "tenant")
        # default workload knobs on purpose: the committed artifact
        # must match what tenant_gate re-prices (its config defaults)
        run_tenant_sweep(TenantSweepConfig(seed=args.seed, out=out))
        return 0

    bounds = []
    for b in args.bounds.split(","):
        mn, mx = b.split("-")
        bounds.append((int(mn), int(mx)))
    cfg = ServeSweepConfig(
        traces=[t.strip() for t in args.traces.split(",") if t.strip()],
        up_drain_s=_floats(args.up_drain),
        down_drain_s=_floats(args.down_drain),
        up_patience=_ints(args.up_patience),
        cooldown=_ints(args.cooldown),
        bounds=bounds, duration_s=args.duration, seed=args.seed,
        tokens_per_s=args.tokens_per_s, startup_s=args.startup,
        slo_ttft_s=args.slo_ttft, out=args.out)
    run_sweep(cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
