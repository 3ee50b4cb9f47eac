"""Elastic membership of the port (``gym_tpu_torch.elastic``, the ZeRO-2
checkpoint layout and ``fit(resume=..., num_nodes=K')``) held to
``gym_tpu``'s on the CPU.

Oracles:

- a checkpointed ZeRO-1 fit writes the ZeRO-2 layout, its ``param_shards``
  bit-equal to ``gym_tpu``'s ``make_zero2_codec`` on the same params;
- K→K'→K through ``reshard_state`` is bit-identical for both layouts,
  K' ∈ {3, 5}, the zero pad tail of the flat shards included, and the
  K'-state equals ``gym_tpu``'s reshard of the same state;
- a fit at K=2 checkpointed at step 3 and resumed at K'=3 gives per-step
  losses within the f32 band (rtol 5e-5) of ``gym_tpu``'s same two fits,
  for ZeRO-1 and for DiLoCo resumed at a sync boundary, with no step
  quarantined;
- per-node state that no reshard can redistribute (a mid-cycle DiLoCo
  replica, an error-feedback residual) raises ``NodeCountMismatchError``
  and quarantines nothing;
- a second reshard at the same membership builds no program (the
  registry's ``builds`` counter);
- ``ElasticTrainController`` and ``elastic_fit`` decide as ``gym_tpu``'s
  on the same inputs, the controller being a copy pinned to its original;
- the kill drill: a ZeRO worker killed -9 past a durable save resumes at
  K-1 and K+1, keeps its pre-kill ``train.csv`` rows verbatim, and stays
  within 0.25 of the uninterrupted run's tail (the bound of
  ``tests/test_elastic_drill.py``).

Tiny GPTs: 2L/2H/32d, vocab 65, T=32."""

import ast
import csv
import json
import os
import pathlib
import shutil
import signal
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu import Trainer as JTrainer, TrainState as JState
from gym_tpu.data import ContiguousGPTTrainDataset as JDataset
from gym_tpu.elastic import (ElasticTrainController as JController,
                             cold_restart_events as jcold,
                             elastic_fit as jelastic_fit,
                             elastic_meta as jmeta,
                             make_zero2_codec as jzero2,
                             reshard_events as jreshard_events,
                             reshard_state as jreshard)
from gym_tpu.models.nanogpt import GPT as JGPT, GPTConfig as JConfig
from gym_tpu.strategy import (DiLoCoStrategy as JDiLoCo, OptimSpec as JSpec,
                              ZeroReduceStrategy as JZero)
from gym_tpu_torch import Trainer
from gym_tpu_torch.convert import params_from_jax
from gym_tpu_torch.data import ContiguousGPTTrainDataset
from gym_tpu_torch.elastic import (STACKED_LAYOUT, ZERO2_LAYOUT,
                                   ElasticTrainController,
                                   cold_restart_events, elastic_fit,
                                   elastic_meta, make_zero2_codec,
                                   reshard_events, reshard_state)
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
from gym_tpu_torch.ops import threefry
from gym_tpu_torch.programs import default_registry
from gym_tpu_torch.programs.elastic_defs import (elastic_program_defs,
                                                 elastic_shard_size)
from gym_tpu_torch.strategy import (DiLoCoStrategy, NodeCountMismatchError,
                                    OptimSpec, ZeroReduceStrategy)
from gym_tpu_torch.trainer import _state_tree
from gym_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_kill_harness import (CKPT_INTERVAL, MAX_STEPS, run_worker,
                                     train_csv)

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, V = 32, 65
TINY = dict(block_size=T, vocab_size=V, n_layer=2, n_head=2, n_embd=32)
FIT = dict(batch_size=4, minibatch_size=2, val_size=0, val_interval=0,
           seed=3, show_progress=False, checkpoint_interval=3)
RTOL = 5e-5
N = 11  # 5 + 3*2 params: every K in play pads the last shard


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens():
    return np.random.default_rng(0).integers(0, V, 6000).astype(np.int32)


def _init_tree():
    x = jnp.zeros((1, T), jnp.int32)
    p = JGPT(JConfig(**TINY)).init(jax.random.PRNGKey(7), (x, x),
                                   train=False)["params"]
    return jax.tree.map(np.asarray, p)


def _strategy(pkg, which, H=2):
    jx = pkg == "jax"
    spec = JSpec if jx else OptimSpec
    if which == "zero":
        return (JZero if jx else ZeroReduceStrategy)(spec("adamw", lr=1e-2))
    if which == "diloco_int8":
        # SGD keeps no per-node moments; the residual rows differ
        return DiLoCoStrategy(OptimSpec("sgd", lr=0.05), H=H, codec="int8")
    if which == "diloco_adamw":
        return DiLoCoStrategy(OptimSpec("adamw", lr=1e-2), H=H)
    # DiLoCo with a stateless inner SGD: at a sync boundary every per-node
    # leaf is a replica
    return (JDiLoCo if jx else DiLoCoStrategy)(spec("sgd", lr=0.05), H=H)


def _fit_port(base, which, k, steps, tag, tree=None, **kw):
    toks = _tokens()
    return Trainer(GPT(GPTConfig(**TINY)),
                   ContiguousGPTTrainDataset(toks, T)).fit(
        strategy=_strategy("torch", which, kw.pop("H", 2)), num_nodes=k,
        max_steps=steps, device="cpu",
        init_params=None if tree is None else params_from_jax(tree, k),
        save_dir=os.path.join(str(base), "ckpt"), run_name=tag,
        log_dir=os.path.join(str(base), "logs"), **{**FIT, **kw})


def _fit_jax(base, which, k, steps, tag, tree):
    return JTrainer(JGPT(JConfig(**TINY)), JDataset(_tokens(), T)).fit(
        strategy=_strategy("jax", which), num_nodes=k, max_steps=steps,
        device="cpu", init_params=tree,
        save_dir=os.path.join(str(base), "ckpt"), run_name=tag,
        log_dir=os.path.join(str(base), "logs"), **FIT)


def _rows(base, tag):
    with open(os.path.join(str(base), "logs", tag, "train.csv"),
              newline="") as f:
        return list(csv.DictReader(f))


def _quarantined(base, tag):
    return [n for n in os.listdir(os.path.join(str(base), "ckpt", tag))
            if "corrupt" in n]


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Both packages' fits of ZeRO-1 and of DiLoCo (inner SGD, H=2), each
    at K=2 to step 3 (DiLoCo's step 2 synced), then resumed at K=3 to 6,
    from the same weights and tokens."""
    base = tmp_path_factory.mktemp("elastic_resume")
    tree = _init_tree()
    out = {}
    for which in ("zero", "diloco"):
        for pkg, fit in (("jax", _fit_jax), ("torch", _fit_port)):
            tag = f"{pkg}_{which}"
            fit(base, which, 2, 3, tag, tree)
            res = fit(base, which, 3, 6, tag, tree)
            out[tag] = res
    return base, out


@pytest.mark.parametrize("which", ["zero", "diloco"])
def test_resume_at_k_plus_1_matches_jax(resumed, which):
    base, out = resumed
    res = out[f"torch_{which}"]
    assert res.steps == 6
    assert [s for s, _ in res.history["train_loss"]] == [3, 4, 5]
    jt, tt = _rows(base, f"jax_{which}"), _rows(base, f"torch_{which}")
    assert len(jt) == len(tt) == 6
    for a, b in zip(jt, tt):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=RTOL, err_msg=f"step {a['step']}")
        np.testing.assert_allclose(float(b["cum_comm_bytes"]),
                                   float(a["cum_comm_bytes"]), rtol=1e-6)
    assert _quarantined(base, f"torch_{which}") == []


def test_zero2_step_dir_shards_equal_jax_codec(resumed):
    """The last step dir of the port's resumed ZeRO fit (step 6, K=3): the
    ZeRO-2 layout, its param shards bit-equal to gym_tpu's codec on the
    same params, its moments already 1/K shards: O(model) bytes."""
    base, _ = resumed
    mgr = CheckpointManager(os.path.join(str(base), "ckpt"), "torch_zero")
    _, tree, _, extra = mgr.restore(None, step=6)
    mgr.close()
    assert extra["elastic"]["layout"] == ZERO2_LAYOUT
    assert extra["elastic"]["num_nodes"] == 3
    z = tree["zero2"]
    n = extra["elastic"]["n_params"]
    shards = z["param_shards"]
    assert shards.dtype == torch.float32
    assert tuple(shards.shape) == (3, elastic_shard_size(n, 3))
    mu = z["strategy_state"]["opt"]["mu"]["flat"]
    assert tuple(mu.shape) == tuple(shards.shape)
    # the fit's final params as gym_tpu's nested tree
    res = resumed[1]["torch_zero"]
    params = res.node_state.params
    nested = {}
    for name, x in params.items():
        *path, leaf = name.split(".")
        d = nested
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(x.numpy())
    jstate = JState(params=nested, model_state={}, strategy_state={},
                    step=jnp.zeros((3,), jnp.int32),
                    rng=jnp.zeros((3, 2), jnp.uint32))
    to_canon, _ = jzero2(jstate, 3)
    want = np.asarray(to_canon(jstate)["zero2"]["param_shards"])
    got = make_zero2_codec(_state_tree(res.node_state), 3)[0](
        _state_tree(res.node_state))["zero2"]["param_shards"]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(shards.numpy(), want)


def _mk_tree(k, seed=0, step=6):
    """A synthetic K-node ZeRO state tree: replicated params, flat
    [K, ceil(N/K)] moments with an all-zero pad tail, the per-node keys."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(5,)).astype(np.float32)
    w = rng.normal(size=(3, 2)).astype(np.float32)
    s = elastic_shard_size(N, k)

    def shard_vec(v):
        pad = np.zeros(k * s, np.float32)
        pad[:N] = v
        return pad.reshape(k, s)

    mu = rng.normal(size=(N,)).astype(np.float32)
    nu = np.abs(rng.normal(size=(N,))).astype(np.float32)
    return {
        "params": {"b": torch.tensor(np.repeat(b[None], k, 0)),
                   "w": torch.tensor(np.repeat(w[None], k, 0))},
        "model_state": {},
        "strategy_state": {"opt": {"count": step,
                                   "mu": {"flat": torch.tensor(shard_vec(mu))},
                                   "nu": {"flat": torch.tensor(
                                       shard_vec(nu))}}},
        "step": step,
        "rng": threefry.node_keys(3, k),
    }


def _jax_state(tree):
    k = tree["rng"].shape[0]
    opt = tree["strategy_state"]["opt"]
    return JState(
        params={n: jnp.asarray(x.numpy()) for n, x in tree["params"].items()},
        model_state={},
        strategy_state={"opt": {
            "count": jnp.full((k,), opt["count"], jnp.int32),
            "mu": jnp.asarray(opt["mu"]["flat"].numpy()),
            "nu": jnp.asarray(opt["nu"]["flat"].numpy())}},
        step=jnp.full((k,), tree["step"], jnp.int32),
        rng=jnp.asarray(tree["rng"]))


def _assert_trees_equal(a, b):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _assert_trees_equal(a[key], b[key])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("layout", [STACKED_LAYOUT, ZERO2_LAYOUT])
@pytest.mark.parametrize("k_mid", [3, 5])
def test_reshard_roundtrip_bit_identical(layout, k_mid):
    """K=4 → K' → 4: params re-replicated, flat moments re-partitioned,
    every leaf bit-identical on return, the pad tail included; the
    K'-state's params and moments equal gym_tpu's reshard of the same
    state."""
    saved = _mk_tree(4)
    raw = saved
    if layout == ZERO2_LAYOUT:
        to_canon, from_canon = make_zero2_codec(saved, 4)
        raw = to_canon(saved)
        assert tuple(raw["zero2"]["param_shards"].shape) == (
            4, elastic_shard_size(N, 4))
        _assert_trees_equal(from_canon(raw), saved)
    mid = reshard_state(raw, elastic_meta(4, layout, N), _mk_tree(k_mid, 9))
    assert tuple(mid["strategy_state"]["opt"]["mu"]["flat"].shape) == (
        k_mid, elastic_shard_size(N, k_mid))
    jsaved = _jax_state(saved)
    jraw = jsaved
    if layout == ZERO2_LAYOUT:
        jraw = jax.device_get(jzero2(jsaved, 4)[0](jsaved))
    jmid = jreshard(jraw, jmeta(4, layout, N),
                    _jax_state(_mk_tree(k_mid, 9)))
    for name in ("b", "w"):
        np.testing.assert_array_equal(mid["params"][name].numpy(),
                                      np.asarray(jmid.params[name]))
    for m in ("mu", "nu"):
        np.testing.assert_array_equal(
            mid["strategy_state"]["opt"][m]["flat"].numpy(),
            np.asarray(jmid.strategy_state["opt"][m]))
    back = reshard_state(mid, elastic_meta(k_mid, STACKED_LAYOUT, N),
                         _mk_tree(4, 17))
    _assert_trees_equal(back, saved)


def test_second_reshard_at_the_same_membership_builds_nothing():
    reg = default_registry()
    saved = _mk_tree(4)
    meta = elastic_meta(4, STACKED_LAYOUT, N)
    reshard_state(saved, meta, _mk_tree(3, 9))
    warm = reg.counters()["builds"]
    reshard_state(saved, meta, _mk_tree(3, 23))
    assert reg.counters()["builds"] == warm
    # the registry's elastic programs: one key a signature, each runs
    defs = elastic_program_defs()
    assert len({d.key()[1] for d in defs}) == len(defs) == 6
    for d in defs:
        args = [torch.zeros(shape, dtype=dt) for shape, dt in d.args]
        out = reg.acquire(d, eager=True)(*args)
        assert not getattr(reg.acquire(d).ensure(), "captured", True)
        assert out is not None


@pytest.mark.parametrize("which,H", [
    pytest.param("diloco_adamw", 4, id="mid_cycle_replicas"),
    pytest.param("diloco_int8", 2, id="error_feedback_residual")])
def test_per_node_state_raises_typed_and_quarantines_nothing(tmp_path,
                                                              which, H):
    """DiLoCo checkpointed at step 3: with H=4 the replicas have drifted
    apart (and AdamW's per-node moments with them); at H=2 the step-2 sync
    made the params replicas, but int8's error-feedback residual is one
    row a node. Neither has a generic redistribution onto K'=3."""
    _fit_port(tmp_path, which, 2, 3, "r", H=H)
    with pytest.raises(NodeCountMismatchError, match="rows differ"):
        _fit_port(tmp_path, which, 3, 6, "r", H=H)
    assert sorted(os.listdir(tmp_path / "ckpt" / "r")) == ["3",
                                                          "config.json"]
    # the original membership still resumes from the same step
    res = _fit_port(tmp_path, which, 2, 4, "r", H=H)
    assert [s for s, _ in res.history["train_loss"]] == [3]


def test_reshard_events_equal_jax():
    for k_from, k_to in ((4, 3), (4, 5), (2, 3)):
        for a, b in zip(reshard_events(N, k_from, k_to),
                        jreshard_events(N, k_from, k_to)):
            assert (a.op, a.bytes, a.group, a.label) == (
                b.op, b.bytes, b.group, b.label)
        (a,), (b,) = cold_restart_events(N, k_to), jcold(N, k_to)
        assert (a.op, a.bytes, a.group, a.label) == (
            b.op, b.bytes, b.group, b.label)


def test_controller_decisions_equal_jax():
    ticks = [(2, 1e6, 10.0), (2, 1e6, 10.0), (3, 1e6, 10.0),
             (3, 0.0, 1e6), (3, 0.0, 1e6), (3, 0.0, 1e6), (2, 0.0, None),
             (2, 5e5, 1e3), (2, 5e5, 1e3), (3, 5e5, 1e3)]
    t, j = ElasticTrainController(1, 3), JController(1, 3)
    for nodes, backlog, rate in ticks:
        kw = dict(num_nodes=nodes, backlog_tokens=backlog,
                  tokens_per_s=rate)
        assert t.tick(**kw) == j.tick(**kw)
        assert t.last_reason == j.last_reason
    assert t.decisions == j.decisions


def test_elastic_fit_paces_segments_as_jax(tmp_path):
    def stub(calls):
        class Stub:
            def fit(self, **kw):
                calls.append(kw)
                return SimpleNamespace(steps=kw["max_steps"],
                                       preempted=False)
        return Stub()

    runs = []
    for fn, ctl in ((elastic_fit, ElasticTrainController),
                    (jelastic_fit, JController)):
        calls = []
        hist, res = fn(stub(calls), controller=ctl(k_min=1, k_max=4),
                       num_nodes=2, max_steps=9, segment_steps=3,
                       tokens_per_step=16, save_dir=str(tmp_path))
        runs.append(([{k: h[k] for k in ("step", "nodes", "target")}
                      for h in hist],
                     [(c["num_nodes"], c["max_steps"], c["resume"])
                      for c in calls], res.steps))
    assert runs[0] == runs[1]
    assert [(m, r) for _, m, r in runs[0][1]] == [
        (3, "auto"), (6, "auto"), (9, "auto")]
    with pytest.raises(ValueError, match="save_dir"):
        elastic_fit(stub([]), controller=ElasticTrainController(),
                    num_nodes=1, max_steps=1, segment_steps=1,
                    tokens_per_step=1)


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


def test_controller_is_its_originals_code():
    assert _code(ROOT / "gym_tpu_torch/elastic/controller.py") == \
        _code(ROOT / "gym_tpu/elastic/controller.py")


# -- the kill drill at K±1 ----------------------------------------------------


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """An uninterrupted K=2 ZeRO worker run (the loss oracle) and one
    killed -9 at the 8th dispatch boundary, past the durable step-6 save,
    with its pre-kill ``train.csv``."""
    s = tmp_path_factory.mktemp("elastic_drill")
    p = run_worker(s / "b_ckpt", s / "b_logs", result=s / "b.json",
                   sync_ckpt=True, strategy="zero")
    assert p.returncode == 0, p.stderr[-4000:]
    base = json.loads((s / "b.json").read_text())
    p = run_worker(s / "c_ckpt", s / "c_logs", sync_ckpt=True,
                   strategy="zero", faults="dispatch.boundary:kill@8")
    assert p.returncode == -signal.SIGKILL, p.stderr[-4000:]
    return s, base, train_csv(s / "c_logs")


@pytest.mark.parametrize("k_new", [1, 3], ids=["K-1", "K+1"])
def test_kill9_resume_at_new_node_count(drill, k_new):
    s, base, pre_kill = drill
    save, log = s / f"r{k_new}_ckpt", s / f"r{k_new}_logs"
    shutil.copytree(s / "c_ckpt", save)
    shutil.copytree(s / "c_logs", log)
    p = run_worker(save, log, result=s / f"r{k_new}.json", sync_ckpt=True,
                   strategy="zero", num_nodes=k_new)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads((s / f"r{k_new}.json").read_text())
    assert res["steps"] == MAX_STEPS and not res["preempted"]
    first = res["losses"][0][0]
    assert first == 2 * CKPT_INTERVAL, res["losses"]
    stitched = train_csv(log)
    assert stitched.startswith(pre_kill)
    assert len(stitched.splitlines()) == 1 + MAX_STEPS
    tail = [l for st, l in base["losses"] if st >= first]
    got = [l for _, l in res["losses"]]
    assert abs(sum(got) / len(got) - sum(tail) / len(tail)) < 0.25, (
        got, tail)
    assert not [n for n in os.listdir(save / "kill") if "corrupt" in n]
