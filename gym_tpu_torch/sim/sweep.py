"""Resumable strategy-comparison sweep: strategy × H × nodes × topology ×
codec × membership event (counterpart of ``gym_tpu/sim/sweep.py``).

Run each communication strategy for real (a tiny GPT through the port's
``Trainer.fit``, on the card unless ``--device cpu``), price its collective
trace on each topology, and emit a comparison table — "what wall-clock
would DiLoCo H=10 vs plain AllReduce take on 4 nodes over 1 Gbps WAN
links?" answered with measured compute and modeled comm.

    python -m gym_tpu_torch.sim.sweep --preset wan --strategies \\
        diloco,simple_reduce --nodes 4 --steps 30 --block_size 128

Resumability is two-level and crash-safe (kill -9 mid-sweep, rerun the
same command):

- **across cells**: each finished cell writes ``<out>/cells/<id>.json``
  atomically; a rerun skips cells whose result file exists.
- **within a cell**: every fit checkpoints and resumes (``save_dir`` per
  cell, ``resume="auto"``), so the re-run of a killed cell restarts
  mid-fit; the kernels come from the one shared build directory
  (``ops/_build.py``), so it builds nothing either.

Each cell gets its OWN logger run dir (``<out>/logs/<cell_id>``): same-named
``CSVLogger`` runs would clobber each other's ``train.csv``.

The workload's attention is the fused kernels' (``attn_impl="flash"``): on
the card the port's gate (``ops/fused_attention.py``, the JAX package's)
picks the pair, and a block size the kernels do not take (not a multiple
of 128) is refused rather than run through dense attention. Each row
records the attention kernels' launches of its fits
(``attention_launches``); on the CPU attention is dense and they are 0.

Outputs: ``results.csv``, ``results.json``, ``report.md`` with the
DiLoCo-vs-AllReduce headline and per-cell trace-vs-logged byte
reconciliation, and ``frontier.csv``.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from . import gridlib

# strategies that take a sync-interval H
_H_STRATEGIES = ("diloco", "fedavg", "diloco_sparta", "noloco",
                 "demo_outer")
# outer-loop strategies whose CompressedLink takes the --codecs axis
# (codec × outer loop is orthogonal — "dense" is the identity link)
_CODEC_STRATEGIES = ("diloco", "noloco", "demo_outer")
# strategies that are compressed BY DEFINITION (the dense cell is just
# simple_reduce): they take the non-dense codecs + the legacy --bits axis
_BITS_STRATEGIES = ("dynamiq",)
_KNOWN_CODECS = ("dense", "int8", "int4", "topk")
_STRATEGY_ALIASES = {
    "base": "simple_reduce", "allreduce": "simple_reduce",
    "zero": "zero_reduce", "sparta_diloco": "diloco_sparta",
    "dynamiq_int8": "dynamiq", "dynamiq_int4": "dynamiq",
    "decoupled_momentum": "demo_outer",
}
# aliases that NAME a codec pin it: `dynamiq_int8` runs int8 cells
# whatever --bits/--codecs say (the bare `dynamiq` name takes the axes)
_ALIAS_PINNED_CODEC = {"dynamiq_int8": "int8", "dynamiq_int4": "int4"}
STRATEGIES = ("simple_reduce", "zero_reduce", "diloco", "fedavg",
              "sparta", "diloco_sparta", "demo", "noloco", "dynamiq",
              "demo_outer")
# membership events (ROADMAP: Elastic ZeRO): "join@k" / "leave@k" split
# the cell into a K-node fit to step k and an elastic resume at K±1 for
# the rest — the membership change itself is priced with the reshard
# collective events on the cell's topology preset
_EVENT_RE = re.compile(r"^(join|leave)@(\d+)$")
# the strategies whose per-node state is a replica (or ZeRO's flat shards)
# at every step, so a membership event reshards it. The others hold state
# that differs across nodes (DiLoCo's and FedAvg's replicas mid-cycle,
# per-node AdamW moments, error-feedback residuals), which the reshard
# refuses with NodeCountMismatchError (gym_tpu's sweep dies on such a
# cell): their event cells are left out of the grid, and the report says so
ELASTIC_STRATEGIES = ("simple_reduce", "zero_reduce")


def parse_event(event: str) -> Tuple[str, int]:
    m = _EVENT_RE.match(event)
    if not m:
        raise ValueError(f"unknown membership event {event!r}; known: "
                         f"none, join@<step>, leave@<step>")
    return m.group(1), int(m.group(2))


@dataclasses.dataclass
class SweepConfig:
    strategies: List[str]
    presets: List[str]
    nodes: List[int]
    H: List[int]
    bits: List[int] = dataclasses.field(default_factory=lambda: [8])
    codecs: List[str] = dataclasses.field(default_factory=lambda: ["dense"])
    events: List[str] = dataclasses.field(default_factory=lambda: ["none"])
    topk_frac: float = 0.05
    steps: int = 30
    batch_size: int = 8
    block_size: int = 64
    n_layer: int = 2
    n_head: int = 2
    n_embd: int = 64
    lr: float = 1e-3
    seed: int = 42
    overlap: bool = False
    checkpoint_interval: int = 0   # 0 → steps // 3
    out: str = os.path.join("logs", "sim_sweep")
    device: Optional[str] = None   # None: the card

    def __post_init__(self):
        # (resolved name, pinned codec or None) per requested entry
        self._strategy_entries = [
            (_STRATEGY_ALIASES.get(s, s), _ALIAS_PINNED_CODEC.get(s))
            for s in self.strategies]
        self.strategies = [name for name, _ in self._strategy_entries]
        for s in self.strategies:
            if s not in STRATEGIES:
                raise ValueError(f"unknown strategy {s!r}; "
                                 f"known: {STRATEGIES}")
        for b in self.bits:
            if b not in (4, 8):
                raise ValueError(f"unknown bit-width {b!r}; known: 4, 8")
        for c in self.codecs:
            if c not in _KNOWN_CODECS:
                raise ValueError(f"unknown codec {c!r}; "
                                 f"known: {_KNOWN_CODECS}")
        if self.checkpoint_interval <= 0:
            self.checkpoint_interval = max(2, self.steps // 3)
        for e in self.events:
            if e == "none":
                continue
            _, k = parse_event(e)
            if not 0 < k < self.steps:
                raise ValueError(
                    f"membership event {e!r} must land strictly inside "
                    f"the run (0 < step < {self.steps})")


@dataclasses.dataclass(frozen=True)
class Cell:
    strategy: str
    H: Optional[int]      # None for strategies without a sync interval
    nodes: int
    preset: str
    codec: Optional[str] = None   # None = dense / codec-free strategy
    event: Optional[str] = None   # None = static membership

    @property
    def cell_id(self) -> str:
        h = f"_H{self.H}" if self.H is not None else ""
        c = f"_{self.codec}" if self.codec is not None else ""
        e = f"_{self.event}" if self.event is not None else ""
        return f"{self.strategy}{h}{c}_n{self.nodes}_{self.preset}{e}"

    @property
    def bits(self) -> Optional[int]:
        """Legacy bit-width view of the codec axis (results.csv
        back-compat: r03-era artifacts carried `bits`)."""
        return {"int8": 8, "int4": 4}.get(self.codec)


def grid(cfg: SweepConfig) -> List[Cell]:
    """The deduplicated cell grid: H, --codecs and --bits only multiply
    strategies that consume them — the CompressedLink family (diloco,
    noloco, demo_outer) takes the full codec axis incl. "dense", the
    definitionally-compressed dynamiq takes the non-dense codecs plus
    the legacy --bits widths. A codec-pinned alias (`dynamiq_int8`)
    contributes exactly its named cell, and a cell requested twice
    runs once."""
    cells: List[Cell] = []
    seen: set = set()
    for preset in cfg.presets:
        for n in cfg.nodes:
            for s, pinned in cfg._strategy_entries:
                hs = cfg.H if s in _H_STRATEGIES else [None]
                if s in _BITS_STRATEGIES:
                    if pinned is not None:
                        cs: List[Optional[str]] = [pinned]
                    else:
                        cs = [f"int{b}" for b in cfg.bits]
                        cs += [c for c in cfg.codecs
                               if c != "dense" and c not in cs]
                elif s in _CODEC_STRATEGIES:
                    cs = [None if c == "dense" else c for c in cfg.codecs]
                else:
                    cs = [None]
                for h in hs:
                    for c in cs:
                        for ev in cfg.events:
                            event = None if ev == "none" else ev
                            if (event is not None
                                    and parse_event(event)[0] == "leave"
                                    and n <= 1):
                                continue   # nothing left to leave
                            if (event is not None
                                    and s not in ELASTIC_STRATEGIES):
                                continue   # per-node state: no reshard
                            cell = Cell(s, h, n, preset, c, event)
                            if cell.cell_id not in seen:
                                seen.add(cell.cell_id)
                                cells.append(cell)
    return cells


def make_strategy(name: str, H: Optional[int], lr: float,
                  codec: Optional[str] = None, topk_frac: float = 0.05):
    from ..strategy import (DecoupledMomentumStrategy, DeMoStrategy,
                            DiLoCoStrategy, DynamiQStrategy,
                            FedAvgStrategy, NoLoCoStrategy, OptimSpec,
                            SimpleReduceStrategy, SPARTADiLoCoStrategy,
                            SPARTAStrategy, ZeroReduceStrategy)
    optim = OptimSpec("adamw", lr=lr)
    codec = None if codec == "dense" else codec
    ckw = {"frac": topk_frac} if codec == "topk" else {}
    if name == "simple_reduce":
        return SimpleReduceStrategy(optim_spec=optim)
    if name == "zero_reduce":
        return ZeroReduceStrategy(optim_spec=optim)
    if name == "diloco":
        return DiLoCoStrategy(optim_spec=optim, H=H, codec=codec, **ckw)
    if name == "fedavg":
        return FedAvgStrategy(inner_optim=optim, H=H)
    if name == "sparta":
        return SPARTAStrategy(inner_optim=optim, p_sparta=0.01)
    if name == "diloco_sparta":
        return SPARTADiLoCoStrategy(optim_spec=optim, p_sparta=0.01, H=H)
    if name == "demo":
        from ..strategy import OptimSpec as _OS
        return DeMoStrategy(optim_spec=_OS("sgd", lr=lr))
    if name == "noloco":
        return NoLoCoStrategy(optim_spec=optim, H=H, codec=codec, **ckw)
    if name == "demo_outer":
        return DecoupledMomentumStrategy(optim_spec=optim, H=H,
                                         codec=codec, **ckw)
    if name == "dynamiq":
        return DynamiQStrategy(optim_spec=optim, codec=codec or "int8",
                               **ckw)
    raise ValueError(name)


def _workload(cfg: SweepConfig, nodes: int):
    """Tiny GPT on a synthetic char-vocab corpus: hermetic (no dataset
    download), CPU-sized, but a REAL model so measured compute and the
    loss trajectory mean something. Its attention takes the fused kernels
    on the card; a block size they do not take is refused there."""
    import numpy as np

    from ..data import ArrayDataset
    from ..models.nanogpt import GPT, GPTConfig
    from ..train_node import default_device

    if default_device(cfg.device).type == "cuda" and cfg.block_size % 128:
        raise ValueError(
            f"--block_size {cfg.block_size}: the fused attention kernels "
            f"take a multiple of 128 on the card (the port's gate, "
            f"ops/fused_attention.py); run --block_size 128, or --device "
            f"cpu for dense attention")
    cfg_m = GPTConfig(block_size=cfg.block_size, vocab_size=65,
                      n_layer=cfg.n_layer, n_head=cfg.n_head,
                      n_embd=cfg.n_embd, dropout=0.0, bias=True,
                      attn_impl="flash")
    rng = np.random.default_rng(cfg.seed)
    n_samples = max(256, 2 * cfg.steps * cfg.batch_size * nodes)
    toks = rng.integers(0, 65, (n_samples, cfg.block_size + 1),
                        dtype=np.int64)
    ds = ArrayDataset(np.ascontiguousarray(toks[:, :-1]),
                      np.ascontiguousarray(toks[:, 1:]))
    return GPT(cfg_m), ds


# shared resumable-grid machinery (gridlib: the serving sweep,
# servesim/sweep.py, uses the same cell protocol)
_atomic_json = gridlib.atomic_json
_write_csv = gridlib.write_csv


def attention_launches() -> Dict[str, int]:
    """The attention kernels' launch counters (the fused pairs and the
    long-context pair), by wrapper."""
    from ..ops import flash_attention as tflash
    from ..ops import fused_attention as tfa
    return {"fwd_packed": tfa._fwd_packed.launches,
            "bwd_packed": tfa._bwd_packed.launches,
            "blk_fwd": tfa._blk_fwd.launches,
            "blk_bwd": tfa._blk_bwd.launches,
            "flash_fwd": tflash._flash_fwd.launches,
            "flash_bwd": tflash._flash_bwd.launches}


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in attention_launches().items()}


def _n_params(params) -> int:
    return sum(int(math.prod(x.shape)) for x in params.values())


def _recover_compute_estimate(run_dir: str, ns) -> Optional[float]:
    """Per-step compute seconds from the kept per-row ``sim_step_s``
    column. A cell killed after its final checkpoint resumes AT
    max_steps and trains zero new steps, so the resumed fit measures no
    compute — but crash+resume CSV stitching preserved every pre-kill
    row, each carrying the simulated step clock. Median over comm-free
    steps (where sim_step == compute); falls back to subtracting the
    modeled comm on comm-bearing steps."""
    path = os.path.join(run_dir, "train.csv")
    if not os.path.exists(path):
        return None
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    free, loaded = [], []
    for r in rows:
        try:
            t, s = int(r["step"]), float(r["sim_step_s"])
        except (KeyError, ValueError, TypeError):
            continue
        c = ns.comm_time(t)
        (free if c == 0 else loaded).append(s if c == 0
                                            else max(s - c, 0.0))
    vals = sorted(free or loaded)
    return vals[len(vals) // 2] if vals else None


def _last_csv_loss(run_dir: str) -> Optional[float]:
    """Final training loss from the stitched train.csv — the fallback for
    a zero-step resume, whose fit never drained a loss this process."""
    path = os.path.join(run_dir, "train.csv")
    if not os.path.exists(path):
        return None
    last = None
    with open(path, newline="") as f:
        for r in csv.DictReader(f):
            last = r
    try:
        return float(last["loss"]) if last else None
    except (KeyError, ValueError, TypeError):
        return None


def _run_event_cell(cell: Cell, cfg: SweepConfig) -> Dict[str, Any]:
    """A membership-event cell: a real K-node fit to the event step, an
    ELASTIC resume at K±1 for the rest (the checkpoint + reshard path —
    the same machinery a production join/leave would exercise), and the
    membership change itself priced as reshard collectives on the cell's
    topology. The cold-restart alternative (full state re-broadcast plus
    the steps a mid-interval preemption recomputes) is priced alongside
    for the reshard-vs-cold-restart verdict."""
    from .. import Trainer
    from ..elastic import cold_restart_events, reshard_events
    from .cost_model import events_time, events_tx_bytes
    from .simulator import NetworkSimulator
    from .template import node_template
    from .topology import resolve_topology

    kind, k = parse_event(cell.event)
    n1 = cell.nodes
    n2 = n1 + 1 if kind == "join" else n1 - 1
    model, ds = _workload(cfg, max(n1, n2))
    run_dir = os.path.join(cfg.out, "logs", cell.cell_id)
    common = dict(
        batch_size=cfg.batch_size, minibatch_size=cfg.batch_size,
        val_size=0, val_interval=0, seed=cfg.seed, show_progress=False,
        network=cell.preset, network_overlap=cfg.overlap,
        run_name=cell.cell_id, log_dir=os.path.join(cfg.out, "logs"),
        save_dir=os.path.join(cfg.out, "ckpt", cell.cell_id),
        checkpoint_interval=cfg.checkpoint_interval, resume="auto",
        device=cfg.device,
    )
    before = attention_launches()

    def _seg(num_nodes, max_steps):
        strategy = make_strategy(cell.strategy, cell.H, cfg.lr,
                                 cell.codec, cfg.topk_frac)
        res = Trainer(model, ds).fit(strategy=strategy,
                                     num_nodes=num_nodes,
                                     max_steps=max_steps, **common)
        if res.preempted:
            raise KeyboardInterrupt(
                f"sweep cell {cell.cell_id} preempted mid-fit")
        return strategy, res

    strat1, res1 = _seg(n1, k)
    strat2, res2 = _seg(n2, cfg.steps)

    # compose the simulated clock per segment at each segment's real
    # membership (each fit's own sim_summary re-prices its FULL step
    # range at one K — wrong on both sides of the event)
    ns1 = NetworkSimulator(strat1, node_template(res1.params), n1,
                           cell.preset, overlap=cfg.overlap)
    ns2 = NetworkSimulator(strat2, node_template(res2.params), n2,
                           cell.preset, overlap=cfg.overlap)
    c1 = float((res1.sim or {}).get("compute_s_per_step") or 0.0)
    c2 = float((res2.sim or {}).get("compute_s_per_step") or 0.0)
    if not c1 or not c2:
        # zero-step resume of a finished segment: rebuild from the
        # surviving per-row sim clock, or borrow the other segment's
        rec = _recover_compute_estimate(run_dir, ns2)
        c1 = c1 or rec or c2
        c2 = c2 or rec or c1
    sim1 = ns1.simulate(k, c1)
    sim2 = ns2.simulate(cfg.steps, c2, start_step=k)

    # the membership change itself: reshard vs cold restart, priced on
    # this cell's topology at the larger membership
    n_params = _n_params(res2.params)
    topo = resolve_topology(cell.preset, max(n1, n2))
    rev = reshard_events(n_params, n1, n2)
    reshard_s = events_time(rev, topo)
    lost_steps = k % cfg.checkpoint_interval
    cold_s = (events_time(cold_restart_events(n_params, n2), topo)
              + lost_steps * c2)

    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    final_loss = float(summary.get("final_train_loss",
                                   res2.final_train_loss))
    if not math.isfinite(final_loss):
        final_loss = _last_csv_loss(run_dir) or final_loss
    # the stitched cum_comm_bytes column spans BOTH memberships; the
    # trace reconciles segment-wise (reshard bytes move at restore time,
    # outside the step loop, and are reported separately)
    cum = float(summary.get("cum_comm_bytes", 0.0))
    trace = (ns1.trace_tx_bytes(k)
             + ns2.trace_tx_bytes(cfg.steps, start_step=k))
    denom = max(abs(cum), abs(trace), 1.0)
    rel_err = abs(cum - trace) / denom
    return {
        "cell": cell.cell_id,
        "strategy": cell.strategy,
        "H": cell.H,
        "codec": cell.codec,
        "bits": cell.bits,
        "nodes": cell.nodes,
        "topology": cell.preset,
        "event": cell.event,
        "nodes_after": n2,
        "steps": res2.steps,
        "final_train_loss": final_loss,
        "measured_it_s": float(summary.get("steps_per_second",
                                           res2.steps_per_second)),
        "compute_s_per_step": c2,
        "sim_total_s": sim1.total_s + reshard_s + sim2.total_s,
        "sim_comm_s": sim1.total_comm_s + reshard_s + sim2.total_comm_s,
        "sim_compute_s": sim1.total_compute_s + sim2.total_compute_s,
        "reshard_s": reshard_s,
        "cold_restart_s": cold_s,
        "reshard_bytes": events_tx_bytes(rev),
        "overlap": cfg.overlap,
        "cum_comm_bytes": cum,
        "trace_tx_bytes": trace,
        "reconcile_rel_err": rel_err,
        "reconciled": rel_err <= 1e-5,
        "attention_launches": _launches_since(before),
    }


def run_cell(cell: Cell, cfg: SweepConfig) -> Dict[str, Any]:
    """One grid cell: real fit with network simulation attached."""
    from .. import Trainer

    if cell.event is not None:
        return _run_event_cell(cell, cfg)

    model, ds = _workload(cfg, cell.nodes)
    strategy = make_strategy(cell.strategy, cell.H, cfg.lr, cell.codec,
                             cfg.topk_frac)
    run_dir = os.path.join(cfg.out, "logs", cell.cell_id)
    before = attention_launches()
    res = Trainer(model, ds).fit(
        strategy=strategy,
        num_nodes=cell.nodes,
        max_steps=cfg.steps,
        batch_size=cfg.batch_size,
        minibatch_size=cfg.batch_size,
        val_size=0,
        val_interval=0,
        seed=cfg.seed,
        show_progress=False,
        network=cell.preset,
        network_overlap=cfg.overlap,
        # a run dir a cell, and the checkpoint/resume machinery
        run_name=cell.cell_id,
        log_dir=os.path.join(cfg.out, "logs"),
        save_dir=os.path.join(cfg.out, "ckpt", cell.cell_id),
        checkpoint_interval=cfg.checkpoint_interval,
        resume="auto",
        device=cfg.device,
    )
    if res.preempted:
        raise KeyboardInterrupt(
            f"sweep cell {cell.cell_id} preempted mid-fit")

    # authoritative accumulators live in the run dir's summary.json (the
    # resume-continued values; FitResult.history only covers this
    # process's segment of a resumed run)
    with open(os.path.join(run_dir, "summary.json")) as f:
        summary = json.load(f)
    sim = res.sim or {}
    final_loss = float(summary.get("final_train_loss",
                                   res.final_train_loss))
    if not math.isfinite(final_loss):
        final_loss = _last_csv_loss(run_dir) or final_loss
    if sim and not sim.get("compute_s_per_step"):
        # zero-step resume (killed after the final checkpoint): rebuild
        # the compute estimate from the surviving per-row sim clock
        from .simulator import NetworkSimulator
        from .template import node_template
        ns = NetworkSimulator(strategy, node_template(res.params),
                              cell.nodes, cell.preset, overlap=cfg.overlap)
        comp = _recover_compute_estimate(run_dir, ns)
        if comp:
            sim = ns.simulate(res.steps, comp).summary()
    cum = float(summary.get("cum_comm_bytes", 0.0))
    trace = float(sim.get("trace_tx_bytes", 0.0))
    denom = max(abs(cum), abs(trace), 1.0)
    rel_err = abs(cum - trace) / denom
    return {
        "cell": cell.cell_id,
        "strategy": cell.strategy,
        "H": cell.H,
        "codec": cell.codec,
        "bits": cell.bits,
        "nodes": cell.nodes,
        "topology": cell.preset,
        "event": cell.event,
        "steps": res.steps,
        "final_train_loss": final_loss,
        "measured_it_s": float(summary.get("steps_per_second",
                                           res.steps_per_second)),
        "compute_s_per_step": sim.get("compute_s_per_step"),
        "sim_total_s": sim.get("sim_total_s"),
        "sim_comm_s": sim.get("sim_comm_s"),
        "sim_compute_s": sim.get("sim_compute_s"),
        "overlap": cfg.overlap,
        "cum_comm_bytes": cum,
        "trace_tx_bytes": trace,
        "reconcile_rel_err": rel_err,
        # float32 rounding of the per-step metric is the only permitted
        # divergence between the step's accounting and the host trace
        "reconciled": rel_err <= 1e-5,
        "attention_launches": _launches_since(before),
    }


def _baseline_of(rows: List[Dict[str, Any]], row) -> Optional[Dict]:
    """The AllReduce (simple_reduce) cell of the same (nodes, topology)
    group — the speedup denominator."""
    for r in rows:
        if (r["strategy"] == "simple_reduce" and r["nodes"] == row["nodes"]
                and r["topology"] == row["topology"]):
            return r
    return None


def _row_codec(r: Dict[str, Any]) -> Optional[str]:
    """The cell's codec, tolerating r03-era cached rows that only
    carried `bits`."""
    codec = r.get("codec")
    if codec is None:
        codec = {8: "int8", 4: "int4"}.get(r.get("bits"))
    return codec


def _config_label(r: Dict[str, Any]) -> str:
    """Human label for one cell's strategy configuration."""
    label = r["strategy"]
    if r.get("H") is not None:
        label += f" H={r['H']}"
    codec = _row_codec(r)
    if codec is not None:
        label += f" {codec}"
    if r.get("event"):
        label += f" {r['event']}"
    return label


def pareto_frontier(group: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The Pareto-efficient subset of one (topology, nodes) group over
    (simulated total seconds ↓, final loss ↓): a cell is ON the
    frontier iff no other cell is at least as fast AND at least as
    converged with one strictly better. Ties keep both. Diverged cells
    (non-finite loss) never reach the frontier — NaN compares False
    against everything, which would otherwise make them undominatable."""
    import math
    rows = [r for r in group
            if r.get("sim_total_s") is not None
            and math.isfinite(r["final_train_loss"])]

    def dominated(r):
        return any(
            o is not r
            and o["sim_total_s"] <= r["sim_total_s"]
            and o["final_train_loss"] <= r["final_train_loss"]
            and (o["sim_total_s"] < r["sim_total_s"]
                 or o["final_train_loss"] < r["final_train_loss"])
            for o in rows)

    return sorted((r for r in rows if not dominated(r)),
                  key=lambda r: r["sim_total_s"])


def write_frontier_csv(path: str, rows: List[Dict[str, Any]]) -> None:
    """``frontier.csv``: every cell with its Pareto verdict, grouped by
    (topology, nodes) — the one artifact that answers 'which strategy
    wins where' without eyeballing results.csv."""
    out: List[Dict[str, Any]] = []
    groups = sorted({(r["topology"], r["nodes"]) for r in rows})
    for preset, n in groups:
        group = [r for r in rows
                 if r["topology"] == preset and r["nodes"] == n]
        front = {id(r) for r in pareto_frontier(group)}
        for r in sorted(group, key=lambda r: r["sim_total_s"] or 0.0):
            out.append({
                "topology": preset, "nodes": n,
                "config": _config_label(r),
                "strategy": r["strategy"], "H": r.get("H"),
                "codec": _row_codec(r),
                "bits": r.get("bits"),
                "sim_total_s": r["sim_total_s"],
                "sim_comm_s": r["sim_comm_s"],
                "final_train_loss": r["final_train_loss"],
                "comm_mb_per_node": round(r["cum_comm_bytes"] / 1e6, 3),
                "on_frontier": id(r) in front,
            })
    _write_csv(path, out)


def write_report(rows: List[Dict[str, Any]], cfg: SweepConfig) -> str:
    lines = ["# Network-simulation sweep", ""]
    lines.append(
        f"Workload: {cfg.n_layer}-layer GPT (n_embd={cfg.n_embd}, "
        f"block={cfg.block_size}, synthetic char corpus), "
        f"batch {cfg.batch_size}/node, {cfg.steps} steps; comm "
        f"{'overlapped with' if cfg.overlap else 'serialized after'} "
        f"compute.")
    lines.append("")
    headline = None
    for preset in cfg.presets:
        for n in cfg.nodes:
            group = [r for r in rows
                     if r["topology"] == preset and r["nodes"] == n]
            if not group:
                continue
            lines.append(f"## {preset} × {n} nodes")
            lines.append("")
            lines.append("| strategy | H | codec | sim wall-clock (s) | "
                         "sim comm (s) | vs AllReduce | comm/node (MB) | "
                         "final loss | trace reconciles |")
            lines.append("|---|---|---|---|---|---|---|---|---|")
            base = _baseline_of(group, group[0])
            for r in sorted(group, key=lambda r: r["sim_total_s"] or 0.0):
                speed = (base["sim_total_s"] / r["sim_total_s"]
                         if base and r["sim_total_s"] else None)
                if (headline is None and preset == "wan"
                        and r["strategy"] == "diloco"
                        and _row_codec(r) is None and speed):
                    headline = (r, base, speed)
                lines.append(
                    f"| {r['strategy']} | {r['H'] or '—'} "
                    f"| {_row_codec(r) or 'dense'} "
                    f"| {r['sim_total_s']:.2f} | {r['sim_comm_s']:.2f} "
                    f"| {f'{speed:.1f}x' if speed else '—'} "
                    f"| {r['cum_comm_bytes'] / 1e6:.2f} "
                    f"| {r['final_train_loss']:.4f} "
                    f"| {'yes' if r['reconciled'] else 'NO'} |")
            lines.append("")
    # Pareto frontier: the strategies actually worth running per
    # (topology, nodes) — loss and simulated seconds trade, a cheap
    # strategy that converges slower can still lose
    lines.append("## Pareto frontier (final loss vs simulated seconds)")
    lines.append("")
    for preset in cfg.presets:
        for n in cfg.nodes:
            group = [r for r in rows
                     if r["topology"] == preset and r["nodes"] == n]
            front = pareto_frontier(group)
            if not front:
                continue
            members = ", ".join(
                f"{_config_label(r)} ({r['sim_total_s']:.2f}s, "
                f"loss {r['final_train_loss']:.4f})" for r in front)
            lines.append(f"- **{preset} × {n} nodes**: {members}")
    lines.append("")
    lines.append("Full per-cell verdicts: `frontier.csv`.")
    lines.append("")
    left_out = sorted(set(cfg.strategies) - set(ELASTIC_STRATEGIES))
    if left_out and any(e != "none" for e in cfg.events):
        lines.append(
            f"Membership-event cells left out for {', '.join(left_out)}: "
            f"their per-node state has no reshard (only "
            f"{', '.join(ELASTIC_STRATEGIES)} resume at another node "
            f"count).")
        lines.append("")
    if headline is not None:
        r, base, speed = headline
        lines.insert(2, (
            f"**Headline: DiLoCo (H={r['H']}) is {speed:.1f}× faster than "
            f"AllReduce in simulated wall-clock on the `wan` preset at "
            f"{r['nodes']} nodes ({r['sim_total_s']:.2f}s vs "
            f"{base['sim_total_s']:.2f}s for {r['steps']} steps).**"))
        lines.insert(3, "")
    bad = [r["cell"] for r in rows if not r["reconciled"]]
    lines.append(
        "All trace byte totals reconcile with the logged "
        "`cum_comm_bytes` to within float32 rounding."
        if not bad else
        f"RECONCILIATION FAILURES: {bad}")
    lines.append("")
    return "\n".join(lines)


def _workload_sig(cfg: SweepConfig) -> Dict[str, Any]:
    """The config fields that change what a cell MEASURES (the grid axes
    are part of each cell's identity already). Cached cell results are
    only valid under the same workload."""
    return {k: getattr(cfg, k) for k in (
        "steps", "batch_size", "block_size", "n_layer", "n_head",
        "n_embd", "lr", "seed", "overlap", "checkpoint_interval",
        "topk_frac", "device")}


def _invalidate_if_stale(out: str, sig: Dict[str, Any]) -> bool:
    """Compare the out dir's workload marker against ``sig``; on
    mismatch wipe the cell results, checkpoints, and per-cell logs (a
    rerun with e.g. --steps 100 must re-measure, not silently serve the
    30-step cache — and a half-trained checkpoint from the old workload
    must not seed the new fits). Returns True when state was wiped."""
    return gridlib.invalidate_if_stale(out, sig,
                                       state_dirs=("cells", "ckpt",
                                                   "logs"))


def run_sweep(cfg: SweepConfig) -> List[Dict[str, Any]]:
    _invalidate_if_stale(cfg.out, _workload_sig(cfg))
    cells = grid(cfg)

    def _run_one(i: int) -> Dict[str, Any]:
        row = run_cell(cells[i], cfg)
        print(f"    sim_total_s={row['sim_total_s']:.3f} "
              f"comm={row['cum_comm_bytes'] / 1e6:.2f}MB "
              f"loss={row['final_train_loss']:.4f} "
              f"reconciled={row['reconciled']}")
        return row

    rows = gridlib.run_cells(cfg.out, [c.cell_id for c in cells],
                             _run_one)
    _write_csv(os.path.join(cfg.out, "results.csv"), rows)
    write_frontier_csv(os.path.join(cfg.out, "frontier.csv"), rows)
    _atomic_json(os.path.join(cfg.out, "results.json"),
                 {"config": dataclasses.asdict(cfg), "rows": rows})
    report = write_report(rows, cfg)
    with open(os.path.join(cfg.out, "report.md"), "w") as f:
        f.write(report)
    print(f"\nreport: {os.path.join(cfg.out, 'report.md')}")
    return rows


def _csv_list(s: str) -> List[str]:
    return [x.strip() for x in s.split(",") if x.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Strategy × H × nodes × topology sweep with network "
                    "simulation (resumable: rerun the same command after "
                    "a crash and it picks up where it died)")
    p.add_argument("--strategies", default="diloco,simple_reduce",
                   help=f"comma list from {STRATEGIES}")
    p.add_argument("--preset", default="wan",
                   help="comma list of topology presets "
                        "(datacenter, wan, federated)")
    p.add_argument("--nodes", default="4", help="comma list of node counts")
    p.add_argument("--H", default="10",
                   help="comma list of sync intervals "
                        "(diloco/fedavg/noloco)")
    p.add_argument("--bits", default="8",
                   help="comma list of quantization bit-widths for the "
                        "compressed strategies (dynamiq): 8, 4")
    p.add_argument("--codecs", default="dense",
                   help="comma list of outer-loop codecs for the "
                        "CompressedLink family (diloco, noloco, "
                        "demo_outer; non-dense entries also multiply "
                        "dynamiq): dense, int8, int4, topk")
    p.add_argument("--topk_frac", type=float, default=0.05,
                   help="kept fraction for the topk codec cells")
    p.add_argument("--events", default="none",
                   help="comma list of membership events: none, "
                        "join@<step>, leave@<step> — an event cell runs "
                        "K nodes to the step then elastically resumes "
                        "at K±1, pricing the reshard on the preset")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--block_size", type=int, default=64)
    p.add_argument("--n_layer", type=int, default=2)
    p.add_argument("--n_embd", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--overlap", action="store_true",
                   help="model perfect compute/comm overlap "
                        "(default: comm serializes after compute)")
    p.add_argument("--out", default=os.path.join("logs", "sim_sweep"))
    p.add_argument("--device", default=None,
                   help="device of the measured fits (default: the card, "
                        "an error without one; 'cpu' runs them here)")
    args = p.parse_args(argv)

    cfg = SweepConfig(
        strategies=_csv_list(args.strategies),
        presets=_csv_list(args.preset),
        nodes=[int(x) for x in _csv_list(args.nodes)],
        H=[int(x) for x in _csv_list(args.H)],
        bits=[int(x) for x in _csv_list(args.bits)],
        codecs=_csv_list(args.codecs),
        events=_csv_list(args.events),
        topk_frac=args.topk_frac,
        steps=args.steps, batch_size=args.batch_size,
        block_size=args.block_size, n_layer=args.n_layer,
        n_head=max(1, args.n_embd // 32), n_embd=args.n_embd,
        lr=args.lr, seed=args.seed, overlap=args.overlap, out=args.out,
        device=args.device,
    )
    run_sweep(cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
