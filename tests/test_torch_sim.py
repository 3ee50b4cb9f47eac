"""The port's network simulator and sweep (``gym_tpu_torch.sim``) held to
``gym_tpu.sim`` on the CPU.

Oracles:

- ``topology.py``, ``cost_model.py`` and ``simulator.py`` are copies of
  their originals' code (docstrings apart), and every closed form and
  preset gives gym_tpu's float exactly at the same arguments;
- every ported strategy's ``comm_events`` trace (SimpleReduce, ZeRO-1,
  DiLoCo dense and int8, FedAvg islands, SPARTA's realized mask bytes,
  SPARTA-DiLoCo, DeMo, NoLoCo, DynamiQ) is gym_tpu's, event for event, and
  prices equal on all three presets; ``NetworkSimulator.simulate`` at a
  fixed compute rate gives gym_tpu's totals;
- a port fit with ``network=`` logs ``sim_step_s`` a row and returns
  ``FitResult.sim``, whose ``trace_tx_bytes`` equals the logged
  ``cum_comm_bytes``, for every ported strategy; an unknown preset raises
  as gym_tpu's does;
- the port's ``frontier_gate`` and ``elastic_frontier`` price gym_tpu's
  cells and pass against the committed baselines under ``logs/frontier/``;
- a tiny CPU sweep (DiLoCo, AllReduce and ZeRO-1 on ``wan``, static and
  ``join@3``): every cell reconciles, the join cells (AllReduce's and
  ZeRO's: DiLoCo's per-node state has no reshard) price their reshard,
  the report carries the DiLoCo headline, and a rerun after a killed cell
  re-runs that cell only."""

import ast
import csv
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

import gym_tpu.sim as jsim
from gym_tpu.parallel import NodeRuntime as JRuntime
from gym_tpu.sim import frontier_gate as jfrontier
from gym_tpu.strategy import (DecoupledMomentumStrategy as JDeMoOuter,
                              DeMoStrategy as JDeMo,
                              DiLoCoStrategy as JDiLoCo,
                              DynamiQStrategy as JDynamiQ,
                              FedAvgStrategy as JFedAvg,
                              NoLoCoStrategy as JNoLoCo, OptimSpec as JSpec,
                              SimpleReduceStrategy as JSimple,
                              SPARTADiLoCoStrategy as JSPARTADiLoCo,
                              SPARTAStrategy as JSPARTA,
                              ZeroReduceStrategy as JZero)
import gym_tpu_torch.sim as tsim
from gym_tpu_torch import Trainer
from gym_tpu_torch.data import ContiguousGPTTrainDataset
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
from gym_tpu_torch.sim import elastic_frontier, frontier_gate
from gym_tpu_torch.sim.sweep import SweepConfig, run_sweep
from gym_tpu_torch.strategy import (DecoupledMomentumStrategy, DeMoStrategy,
                                    DiLoCoStrategy, DynamiQStrategy,
                                    FedAvgStrategy, NoLoCoStrategy,
                                    OptimSpec, SimpleReduceStrategy,
                                    SPARTADiLoCoStrategy, SPARTAStrategy,
                                    ZeroReduceStrategy)

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, V = 32, 65
TINY = dict(block_size=T, vocab_size=V, n_layer=2, n_head=2, n_embd=32)
PRESETS = ("datacenter", "wan", "federated")
K = 4
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the copies, pinned ------------------------------------------------------


def _code(path):
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(tree)


@pytest.mark.parametrize("rel", ["sim/topology.py", "sim/cost_model.py",
                                 "sim/simulator.py"])
def test_copies_are_their_originals_code(rel):
    assert _code(ROOT / "gym_tpu_torch" / rel) == \
        _code(ROOT / "gym_tpu" / rel)


def test_closed_forms_and_presets_equal_jax():
    for name in sorted(jsim.PRESETS):
        for k in (1, 2, 3, 4, 5, 8, 16):
            jt = jsim.resolve_topology(name, k)
            tt = tsim.resolve_topology(name, k)
            assert tt.config() == jt.config()
            for op in ("all_reduce", "all_gather", "reduce_scatter",
                       "broadcast", "p2p"):
                for nbytes in (1.0, 4096.0, 7.5e8):
                    for g in sorted({1, 2, k}):
                        je = jsim.CollectiveEvent(op, nbytes, g)
                        te = tsim.CollectiveEvent(op, nbytes, g)
                        assert te.per_node_tx() == je.per_node_tx()
                        for algo in ("ring", "tree"):
                            assert tsim.collective_time(te, tt, algo) == \
                                jsim.collective_time(je, jt, algo)
    links = [tsim.Link(1e9, 1e-3), tsim.Link(2e8, 5e-3), tsim.Link(1e9, 0.0)]
    jlinks = [jsim.Link(l.bandwidth, l.latency) for l in links]
    assert tsim.ring_all_reduce_time(1e6, links) == \
        jsim.ring_all_reduce_time(1e6, jlinks)
    assert tsim.ring_all_gather_time(1e6, links) == \
        jsim.ring_all_gather_time(1e6, jlinks)
    assert tsim.tree_broadcast_time(3e5, links[1], 5) == \
        jsim.tree_broadcast_time(3e5, jlinks[1], 5)
    with pytest.raises(ValueError, match="unknown topology preset"):
        tsim.resolve_topology("nope", 2)


# -- the strategies' traces --------------------------------------------------


def _specs():
    """The tiny GPT's per-node parameter shapes, by port name."""
    return {n: s for n, (s, _) in GPT(GPTConfig(**TINY))
            ._param_specs().items()}


def _jax_template(specs):
    out = {}
    for name, shape in specs.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jax.ShapeDtypeStruct(shape, np.float32)
    return out


def _pair(which):
    """(gym_tpu's strategy, the port's), the same arguments."""
    a, b = JSpec("adamw", lr=1e-3), OptimSpec("adamw", lr=1e-3)
    if which == "simple_reduce":
        return JSimple(a), SimpleReduceStrategy(b)
    if which == "zero":
        return JZero(a), ZeroReduceStrategy(b)
    if which == "diloco":
        return JDiLoCo(a, H=2), DiLoCoStrategy(b, H=2)
    if which == "diloco_int8":
        return (JDiLoCo(a, H=2, codec="int8"),
                DiLoCoStrategy(b, H=2, codec="int8"))
    if which == "fedavg_islands":
        return (JFedAvg(a, H=2, island_size=2),
                FedAvgStrategy(b, H=2, island_size=2))
    if which == "sparta":
        return JSPARTA(a, p_sparta=0.05), SPARTAStrategy(b, p_sparta=0.05)
    if which == "sparta_diloco":
        return (JSPARTADiLoCo(a, p_sparta=0.05, H=3),
                SPARTADiLoCoStrategy(b, p_sparta=0.05, H=3))
    if which == "demo":
        return (JDeMo(JSpec("sgd", lr=1e-3)),
                DeMoStrategy(OptimSpec("sgd", lr=1e-3)))
    if which == "demo_outer_topk":
        return (JDeMoOuter(a, H=2, codec="topk"),
                DecoupledMomentumStrategy(b, H=2, codec="topk"))
    if which == "noloco":
        return JNoLoCo(a, H=2), NoLoCoStrategy(b, H=2)
    if which == "noloco_int4":
        return (JNoLoCo(a, H=2, codec="int4"),
                NoLoCoStrategy(b, H=2, codec="int4"))
    if which == "dynamiq":
        return JDynamiQ(a, codec="int8"), DynamiQStrategy(b, codec="int8")
    raise ValueError(which)


TRACED = ["simple_reduce", "zero", "diloco", "diloco_int8", "fedavg_islands",
          "sparta", "sparta_diloco", "demo", "demo_outer_topk", "noloco",
          "noloco_int4", "dynamiq"]


@pytest.fixture(scope="module")
def jax_zero_ctx():
    """The JAX node mesh of K devices, whose single node axis runs ZeRO's
    canonical schedule (the port's only one)."""
    return JRuntime.create(K, jax.devices("cpu")[:K]).ctx


def _event_key(e):
    return (e.op, e.bytes, e.group, e.label, e.per_node_tx(),
            None if e.pairs is None else tuple(map(tuple, e.pairs)))


@pytest.mark.parametrize("which", TRACED)
def test_trace_prices_equal_on_every_preset(which, jax_zero_ctx):
    j, t = _pair(which)
    j.finalize(STEPS)
    t.finalize(STEPS)
    if which == "zero":
        j.bind_ctx(jax_zero_ctx)
    specs = _specs()
    jt, tt = _jax_template(specs), tsim.node_template(
        {n: torch.empty(s) for n, s in specs.items()})
    assert all(x.untyped_storage().nbytes() <= 4 for x in tt.values())
    for step in range(STEPS):
        je, te = j.comm_events(step, jt, K), t.comm_events(step, tt, K)
        assert [_event_key(e) for e in te] == [_event_key(e) for e in je], \
            step
    for preset in PRESETS:
        js = jsim.NetworkSimulator(j, jt, K, preset)
        ts = tsim.NetworkSimulator(t, tt, K, preset)
        for step in range(STEPS):
            assert ts.comm_time(step) == js.comm_time(step), (preset, step)


@pytest.mark.parametrize("which,preset,overlap", [
    ("diloco", "wan", False), ("simple_reduce", "datacenter", True),
    ("noloco_int4", "federated", False), ("zero", "wan", True)])
def test_simulate_at_a_fixed_rate_equals_jax(which, preset, overlap,
                                             jax_zero_ctx):
    j, t = _pair(which)
    j.finalize(10)
    t.finalize(10)
    if which == "zero":
        j.bind_ctx(jax_zero_ctx)
    specs = _specs()
    jr = jsim.NetworkSimulator(j, _jax_template(specs), K, preset,
                               overlap=overlap).simulate(10, 0.05)
    tr = tsim.NetworkSimulator(
        t, tsim.node_template({n: torch.empty(s) for n, s in specs.items()}),
        K, preset, overlap=overlap).simulate(10, 0.05)
    assert tr.summary() == jr.summary()
    assert tr.step_s == jr.step_s and tr.comm_s == jr.comm_s
    hist = [(s, 4.0 - 0.1 * s) for s in range(10)]
    assert tsim.loss_frontier(tr, hist) == jsim.loss_frontier(jr, hist)


# -- fit(network=) -----------------------------------------------------------


def _fit(tmp_path, strategy, k=2, steps=4, **kw):
    toks = np.random.default_rng(0).integers(0, V, 6000).astype(np.int32)
    return Trainer(GPT(GPTConfig(**TINY)),
                   ContiguousGPTTrainDataset(toks, T)).fit(
        strategy=strategy, num_nodes=k, max_steps=steps, device="cpu",
        batch_size=4, val_size=0, seed=3, show_progress=False,
        log_dir=str(tmp_path), run_name="net", **kw)


@pytest.mark.parametrize("which", TRACED)
def test_fit_trace_reconciles_with_cum_comm_bytes(tmp_path, which):
    _, strategy = _pair(which)
    # overlap on for one strategy: the totals take max(compute, comm)
    res = _fit(tmp_path, strategy, network="wan",
               network_overlap=(which == "diloco"))
    sim = res.sim
    with open(tmp_path / "net" / "summary.json") as f:
        summary = json.load(f)
    cum = summary["cum_comm_bytes"]
    assert cum > 0
    np.testing.assert_allclose(sim["trace_tx_bytes"], cum, rtol=1e-6)
    for key in ("sim_total_s", "sim_comm_s", "sim_compute_s",
                "trace_tx_bytes"):
        assert summary[key] == sim[key]
    assert sim["steps"] == 4 and sim["topology"] == "wan"
    with open(tmp_path / "net" / "train.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [float(r["sim_step_s"]) > 0 for r in rows] == [True] * 4
    assert [s for s, _ in res.history["sim_step_s"]] == [0, 1, 2, 3]
    with open(tmp_path / "net" / "config.json") as f:
        assert json.load(f)["network"]["topology"] == "wan"


def test_fit_trace_tx_bytes_equals_cum_comm_bytes_exactly(tmp_path):
    """DiLoCo's dense trace (phase 15a's strategy) is the logged bytes to
    the last bit, with steps_per_call > 1 (rows drained in batches) too."""
    for spc in (1, 3):
        res = _fit(tmp_path / str(spc), DiLoCoStrategy(
            OptimSpec("adamw", lr=1e-3), H=2), steps=6, network="datacenter",
                   steps_per_call=spc)
        with open(tmp_path / str(spc) / "net" / "summary.json") as f:
            assert res.sim["trace_tx_bytes"] == \
                json.load(f)["cum_comm_bytes"]
        assert len(res.history["sim_step_s"]) == 6


def test_fit_rejects_unknown_network_preset(tmp_path):
    with pytest.raises(ValueError, match="unknown topology preset"):
        _fit(tmp_path, SimpleReduceStrategy(OptimSpec("sgd", lr=0.1)),
             network="not-a-preset")


# -- the frontier gates --------------------------------------------------------


def test_frontier_gate_prices_jax_cells_and_passes(capsys):
    cur = frontier_gate.fast_frontier()
    ref = jfrontier.fast_frontier()
    assert cur == ref
    assert frontier_gate.main(
        ["--baseline", str(ROOT / "logs/frontier/frontier_baseline.json")]
    ) == 0
    assert "-> OK" in capsys.readouterr().out


def test_elastic_frontier_passes_against_the_baseline(capsys):
    with open(ROOT / "logs/frontier/elastic_frontier.json") as f:
        ref = json.load(f)
    cur = elastic_frontier.elastic_frontier()
    assert cur["n_params"] == ref["n_params"] == 108_352
    assert cur["cells"] == ref["cells"]
    assert elastic_frontier.main(
        ["--baseline", str(ROOT / "logs/frontier/elastic_frontier.json")]
    ) == 0
    assert "-> OK" in capsys.readouterr().out


# -- the sweep ---------------------------------------------------------------


def test_cpu_sweep_reconciles_prices_joins_and_resumes(tmp_path):
    cfg = SweepConfig(strategies=["diloco", "simple_reduce", "zero"],
                      presets=["wan"], nodes=[2], H=[2],
                      events=["none", "join@3"], steps=6, batch_size=4,
                      block_size=32, n_layer=1, n_head=1, n_embd=32,
                      out=str(tmp_path / "sweep"), device="cpu")
    rows = run_sweep(cfg)
    assert len(rows) == 5 and all(r["reconciled"] for r in rows), rows
    joins = [r for r in rows if r["event"] == "join@3"]
    assert sorted(r["strategy"] for r in joins) == ["simple_reduce",
                                                    "zero_reduce"]
    for r in joins:
        assert r["nodes_after"] == 3 and r["steps"] == 6
        assert r["reshard_s"] > 0 and r["cold_restart_s"] > 0
        assert r["reshard_bytes"] > 0
    assert all(sum(r["attention_launches"].values()) == 0 for r in rows)
    out = cfg.out
    with open(os.path.join(out, "results.json")) as f:
        cells = {r["cell"] for r in json.load(f)["rows"]}
    assert cells == {"diloco_H2_n2_wan", "simple_reduce_n2_wan",
                     "simple_reduce_n2_wan_join@3", "zero_reduce_n2_wan",
                     "zero_reduce_n2_wan_join@3"}
    with open(os.path.join(out, "report.md")) as f:
        report = f.read()
    assert "Headline: DiLoCo" in report
    assert "RECONCILIATION FAILURES" not in report
    assert "Membership-event cells left out for diloco" in report
    with open(os.path.join(out, "frontier.csv"), newline="") as f:
        front = list(csv.DictReader(f))
    assert len(front) == 5 and any(r["on_frontier"] == "True" for r in front)
    # a killed cell: its marker gone and its fit's newest checkpoint kept;
    # the rerun re-runs it alone (resuming its fit), the rest from markers
    kept = os.path.join(out, "cells", "simple_reduce_n2_wan.json")
    mtime = os.path.getmtime(kept)
    os.remove(os.path.join(out, "cells", "diloco_H2_n2_wan.json"))
    rows2 = run_sweep(cfg)
    assert os.path.getmtime(kept) == mtime
    assert os.path.exists(os.path.join(out, "cells",
                                       "diloco_H2_n2_wan.json"))
    by = {r["cell"]: r for r in rows2}
    again = by["diloco_H2_n2_wan"]
    first = {r["cell"]: r for r in rows}["diloco_H2_n2_wan"]
    assert again["reconciled"] and again["steps"] == 6
    assert again["cum_comm_bytes"] == first["cum_comm_bytes"]
    # the fit resumed at its final checkpoint and trained no step: the
    # loss comes from the kept train.csv row, printed to 6 decimals
    assert again["final_train_loss"] == pytest.approx(
        first["final_train_loss"], abs=1e-6)
