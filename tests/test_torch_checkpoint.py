"""Checkpoint and resume of the port's ``Trainer.fit``, and serving from a
run dir, on the CPU, held to the JAX package.

Oracles:

- a fit checkpointed every 3 steps, stopped at 3 and resumed to 6, writes
  a ``train.csv`` byte-identical to a straight 0→6 run and ends with
  bit-equal node params — under DiLoCo (AdamW and SGD outer state mid
  cycle), DeMo (its chunked momentum) and compressed DiLoCo (int4 with the
  error-feedback residual, the twin of ``test_kill_harness.py:143``);
- ``max_to_keep`` pruning, a torn-only step dir quarantined and re-saved;
  a node-count change resumed through the reshard where the state is a
  replica, and refused with the typed ``NodeCountMismatchError`` where it
  is per-node, no step quarantined either way; a strategy asking for
  sharded checkpoints writes the ZeRO-2 layout and resumes from it;
- the port's and ``gym_tpu``'s checkpointed fits, from the same weights
  (``convert.params_from_jax``) and the same batches, stopped at 3 and
  resumed to 6: per-step losses within the f32 band (rtol 5e-5), the
  same ``train.csv`` rows and columns, and ``summary.json`` with every
  key of ``gym_tpu``'s, ``mfu`` at the H100's stated peak and
  ``tokens_per_second`` by their formulas;
- a ``gym_tpu`` run dir carried across with ``convert`` serves through the
  port the greedy tokens ``gym_tpu.serve.load`` + ``generate_fast`` give;
  a port run dir serves bit for bit what the in-process weights serve,
  and ``--ckpt`` samples from it.

Tiny GPTs: 2L/2H/32d, vocab 65, T=32, K=2."""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from gym_tpu import Trainer as JTrainer
from gym_tpu.data import ContiguousGPTTrainDataset as JDataset
from gym_tpu.models.nanogpt import (GPT as JGPT, GPTConfig as JConfig,
                                    generate_fast as jgenerate)
from gym_tpu.strategy import DiLoCoStrategy as JDiLoCo, OptimSpec as JSpec
from gym_tpu_torch import Trainer
from gym_tpu_torch.convert import flatten_tree, params_from_jax, \
    serving_params
from gym_tpu_torch.data import ContiguousGPTTrainDataset
from gym_tpu_torch.models.nanogpt import GPT, GPTConfig, generate_fast, \
    node_mfu
from gym_tpu_torch.serve.load import (gpt_config_from_run,
                                      latest_checkpoint_step,
                                      load_for_serving, read_run_config)
from gym_tpu_torch.strategy import (DeMoStrategy, DiLoCoStrategy,
                                    NodeCountMismatchError, OptimSpec,
                                    SimpleReduceStrategy)
from gym_tpu_torch.trainer import H100_BF16_PEAK_FLOPS
from gym_tpu_torch.utils.checkpoint import (CheckpointManager,
                                            CheckpointNotFoundError)
from gym_tpu_torch.utils.resilience import RetryPolicy

K, T, V = 2, 32, 65
TINY = dict(block_size=T, vocab_size=V, n_layer=2, n_head=2, n_embd=32)
SCHED = dict(lr_scheduler="lambda_cosine",
             lr_scheduler_kwargs={"warmup_steps": 2})
FIT = dict(num_nodes=K, batch_size=4, minibatch_size=2, val_size=4,
           val_interval=4, seed=3, show_progress=False,
           checkpoint_interval=3)
RTOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These fits are tiny: one intra-op thread runs them fastest, and
    keeps them fast beside other test processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens():
    return np.random.default_rng(0).integers(0, V, 6000).astype(np.int32)


def _strategy(which):
    if which == "diloco":
        return DiLoCoStrategy(OptimSpec("adamw", lr=1e-2), H=2, **SCHED)
    if which == "diloco_int4":
        # H=2 < interval 3: the step-3 checkpoint holds a nonzero residual
        return DiLoCoStrategy(OptimSpec("sgd", lr=0.05), H=2, codec="int4")
    if which == "demo":
        return DeMoStrategy(OptimSpec("sgd", lr=1e-3), **SCHED)
    return SimpleReduceStrategy(OptimSpec("sgd", lr=0.05))


def _fit(base, max_steps, which="diloco", tag="run", **kw):
    base = str(base)
    toks = _tokens()
    kw = {**FIT, **kw}
    return Trainer(GPT(GPTConfig(**TINY)),
                   ContiguousGPTTrainDataset(toks[:5000], T),
                   ContiguousGPTTrainDataset(toks[5000:], T)).fit(
        strategy=_strategy(which), max_steps=max_steps, device="cpu",
        save_dir=os.path.join(base, "ckpt"), run_name=tag,
        log_dir=os.path.join(base, "logs"), **kw)


def _csv_bytes(base, tag="run"):
    with open(os.path.join(str(base), "logs", tag, "train.csv"), "rb") as f:
        return f.read()


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# -- resume equals a straight run ------------------------------------------


@pytest.mark.parametrize("which", ["diloco", "demo", "diloco_int4"])
def test_resume_matches_straight_run(tmp_path, which):
    straight = _fit(tmp_path / "s", 6, which)
    _fit(tmp_path / "r", 3, which)
    resumed = _fit(tmp_path / "r", 6, which)
    # genuinely resumed at 3 (a fresh same-seed run would also match)
    assert [s for s, _ in resumed.history["train_loss"]] == [3, 4, 5]
    assert _csv_bytes(tmp_path / "r") == _csv_bytes(tmp_path / "s")
    for n, p in straight.node_state.params.items():
        assert torch.equal(p, resumed.node_state.params[n]), n
    if which == "diloco_int4":
        got, want = (r.node_state.strategy_state["modules"][0]["ef_residual"]
                     for r in (resumed, straight))
        assert got.abs().sum() > 0 and torch.equal(got, want)


@pytest.mark.parametrize("async_checkpoint", [True, False],
                         ids=["async", "sync"])
def test_keep_latest_pruning(tmp_path, async_checkpoint):
    """``max_to_keep=2``: two steps survive, the latest 6. The async writer
    is newest-wins (a pending save is replaced by a newer one), so when
    the disk is slow step 4 may never be written and ``[2, 6]`` is as right
    as ``[4, 6]`` (``gym_tpu``'s test asserts the same two facts);
    synchronous saves write every step, so exactly ``[4, 6]`` survive."""
    _fit(tmp_path, 6, "simple", checkpoint_interval=2, val_size=0,
         async_checkpoint=async_checkpoint)
    mgr = CheckpointManager(os.path.join(str(tmp_path), "ckpt"), "run")
    steps = mgr.all_steps()
    assert len(steps) == 2 and steps[-1] == 6, steps
    if not async_checkpoint:
        assert steps == [4, 6]
    mgr.close()
    assert latest_checkpoint_step(mgr.directory) == 6


def test_torn_only_step_dir_quarantined_and_resaveable(tmp_path):
    d = str(tmp_path / "unc")
    os.makedirs(os.path.join(d, "run", "4"))
    with open(os.path.join(d, "run", "4", "garbage"), "w") as f:
        f.write("partial write")
    mgr = CheckpointManager(d, "run", async_save=False,
                            retry_policy=RetryPolicy(attempts=1))
    state = {"w": torch.zeros(2, 2)}
    with pytest.raises(CheckpointNotFoundError, match="no valid"):
        mgr.restore(state)
    assert os.path.exists(os.path.join(d, "run", "4.corrupt-0"))
    mgr.save(4, state, {"pos": 0})
    assert mgr.latest_step() == 4
    step, _, data_state, _ = mgr.restore(state)
    assert step == 4 and data_state == {"pos": 0}
    mgr.close()


def test_a_killed_writers_leftovers_are_not_a_step(tmp_path):
    """A write killed before its commit leaves a dotted temporary dir:
    never restored, removed by the next manager."""
    mgr = CheckpointManager(str(tmp_path), "run", async_save=False)
    mgr.save(3, {"w": torch.ones(2)}, {"pos": 1})
    mgr.close()
    left = os.path.join(mgr.directory, ".6.tmp-123")
    os.makedirs(left)
    assert latest_checkpoint_step(mgr.directory) == 3
    mgr = CheckpointManager(str(tmp_path), "run")
    assert not os.path.exists(left) and mgr.latest_step() == 3
    mgr.close()


def test_node_count_change_is_refused_typed(tmp_path):
    """A node-count change is refused, typed, only where the checkpoint
    holds per-node state: DiLoCo at step 3 with H=2 has per-node AdamW
    moments. SimpleReduce's state (SGD: the replicas alone) reshards onto
    K=4 and resumes. Neither quarantines the valid step."""
    _fit(tmp_path, 3, "diloco", val_size=0, tag="d")
    with pytest.raises(NodeCountMismatchError, match="rows differ"):
        _fit(tmp_path, 6, "diloco", val_size=0, tag="d", num_nodes=4)
    assert sorted(os.listdir(os.path.join(str(tmp_path), "ckpt", "d"))) \
        == ["3", "config.json"]
    _fit(tmp_path, 3, "simple", val_size=0)
    res = _fit(tmp_path, 6, "simple", val_size=0, num_nodes=4)
    assert [s for s, _ in res.history["train_loss"]] == [3, 4, 5]
    assert all(p.shape[0] == 4 for p in res.node_state.params.values())
    run_ckpt = os.path.join(str(tmp_path), "ckpt", "run")
    assert not [n for n in os.listdir(run_ckpt) if "corrupt" in n]
    with open(os.path.join(run_ckpt, "6", "meta.json")) as f:
        assert json.load(f)["extra"]["elastic"]["num_nodes"] == 4

    class Sharded(SimpleReduceStrategy):
        shard_checkpoint = True

    def sharded(steps):
        return Trainer(GPT(GPTConfig(**TINY)),
                       ContiguousGPTTrainDataset(_tokens(), T)).fit(
            strategy=Sharded(OptimSpec("sgd", lr=0.05)), max_steps=steps,
            device="cpu", save_dir=str(tmp_path / "z"), log_dir=str(
                tmp_path / "zl"), **{**FIT, "val_size": 0})

    sharded(3)
    with open(os.path.join(str(tmp_path), "z", "default", "3",
                           "meta.json")) as f:
        assert json.load(f)["extra"]["elastic"]["layout"] == "zero2"
    assert [s for s, _ in sharded(4).history["train_loss"]] == [3]


# -- the port against gym_tpu through a resume --------------------------------


def _init_tree():
    x = jax.numpy.zeros((1, T), jax.numpy.int32)
    p = JGPT(JConfig(**TINY)).init(jax.random.PRNGKey(7), (x, x),
                                   train=False)["params"]
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """gym_tpu's and the port's DiLoCo fits from the same weights and
    batches, each stopped at 3 and resumed to 6 in its own run dir."""
    base = tmp_path_factory.mktemp("ckpt_parity")
    toks, tree = _tokens(), _init_tree()
    for steps in (3, 6):
        JTrainer(JGPT(JConfig(**TINY)), JDataset(toks[:5000], T),
                 JDataset(toks[5000:], T)).fit(
            strategy=JDiLoCo(JSpec("adamw", lr=1e-2), H=2, **SCHED),
            max_steps=steps, device="cpu", init_params=tree,
            save_dir=str(base / "jckpt"), run_name="jax",
            log_dir=str(base / "logs"), **{**FIT, "val_size": 0})
        res = _fit(base, steps, tag="torch", val_size=0,
                   init_params=params_from_jax(tree, K))
    return base, res


def test_resumed_fit_matches_jax(both):
    base, res = both
    assert [s for s, _ in res.history["train_loss"]] == [3, 4, 5]
    jt = _rows(base / "logs" / "jax" / "train.csv")
    tt = _rows(base / "logs" / "torch" / "train.csv")
    assert len(jt) == len(tt) == 6 and list(jt[0]) == list(tt[0])
    for a, b in zip(jt, tt):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=RTOL, err_msg=f"step {a['step']}")
        np.testing.assert_allclose(float(b["lr"]), float(a["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(b["cum_comm_bytes"]),
                                   float(a["cum_comm_bytes"]), rtol=1e-6)
    # both run dirs carry the same run config beside the steps
    jcfg = read_run_config(str(base / "jckpt" / "jax"))
    tcfg = read_run_config(str(base / "ckpt" / "torch"))
    assert gpt_config_from_run(jcfg) == gpt_config_from_run(tcfg)
    assert tcfg["num_nodes"] == jcfg["num_nodes"] == K


def test_summary_keys_and_c11_formulas(both):
    base, res = both
    with open(base / "logs" / "jax" / "summary.json") as f:
        jsum = json.load(f)
    with open(base / "logs" / "torch" / "summary.json") as f:
        tsum = json.load(f)
    assert set(jsum) <= set(tsum), set(jsum) - set(tsum)
    assert tsum["mfu_peak_flops"] == H100_BF16_PEAK_FLOPS == 989e12
    sps = tsum["steps_per_second"]
    assert sps == pytest.approx(res.steps_per_second, rel=1e-12)
    # after the resume at 3 both figures count the 3 steps this fit ran
    bk = FIT["batch_size"] * K
    assert tsum["tokens_per_second"] == pytest.approx(bk * T * sps,
                                                      rel=1e-9)
    want = node_mfu(GPTConfig(**TINY), res.node_state.params, bk, 1.0 / sps,
                    peak_flops=989e12)
    assert tsum["mfu"] == pytest.approx(want, rel=1e-9)
    assert res.mfu == tsum["mfu"]


def test_jax_run_dir_serves_the_same_greedy_tokens(both):
    from gym_tpu.serve.load import load_for_serving as jload
    from gym_tpu.utils.checkpoint import restore_params as jrestore
    base, _ = both
    run_dir = str(base / "jckpt" / "jax")
    jparams, jcfg, info = jload(run_dir)
    prompt = np.array([[1, 2, 3, 4, 5]], np.int64)
    want = np.asarray(jgenerate(jparams, jcfg, prompt, 12, top_k=1))
    step, node_tree, _ = jrestore(run_dir)
    assert step == info["step"] == 6
    params = serving_params(
        {n: torch.from_numpy(np.asarray(a))
         for n, a in flatten_tree(node_tree).items()}, device="cpu")
    cfg = gpt_config_from_run(read_run_config(run_dir))
    got = generate_fast(params, cfg, prompt, 12, top_k=1)
    assert np.asarray(got).tolist() == want.tolist()


# -- serving a port run dir --------------------------------------------------


def test_run_dir_serves_what_the_fit_holds(both):
    base, res = both
    run_dir = str(base / "ckpt" / "torch")
    params, cfg, info = load_for_serving(run_dir, device="cpu")
    assert info["step"] == 6 and info["num_nodes"] == K
    live = serving_params(res.node_state.params)
    assert list(params) == list(live)
    for n in live:
        assert torch.equal(params[n], live[n]), n
    prompt = np.array([[3, 1, 4, 1, 5]], np.int64)
    assert np.array_equal(
        generate_fast(params, cfg, prompt, 10, temperature=0.8, top_k=40,
                      seed=2),
        generate_fast(live, cfg, prompt, 10, temperature=0.8, top_k=40,
                      seed=2))
    # quantize-at-load: the same averaged weights, quantized, the config
    # stamped with the dtypes
    qparams, qcfg, _ = load_for_serving(run_dir, device="cpu",
                                        weights_dtype="int8",
                                        kv_dtype="int8")
    assert (qcfg.weights_dtype, qcfg.kv_dtype) == ("int8", "int8")
    assert qparams["h_0.attn.c_attn.qkernel"].dtype == torch.int8
    assert torch.equal(qparams["wpe.embedding"], live["wpe.embedding"])
    from gym_tpu_torch.serve.load import quantize_params
    ref = quantize_params(live, qcfg)
    assert list(qparams) == list(ref)
    for n in ref:
        assert torch.equal(qparams[n], ref[n]), n
    bad = dict(read_run_config(run_dir), num_nodes=5)
    with open(base / "bad_config.json", "w") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError, match="num_nodes=5"):
        load_for_serving(run_dir, device="cpu",
                         config_path=str(base / "bad_config.json"))


def test_ckpt_cli_samples_from_a_run_dir(both, capsys):
    from gym_tpu_torch.examples.nanogpt import main
    base, _ = both
    run_dir = str(base / "ckpt" / "torch")
    assert main(["--ckpt", run_dir, "--sample", "8", "--device", "cpu"]) \
        is None
    out = capsys.readouterr().out
    assert f"restored step 6 (2-node average) from {run_dir}" in out
    assert "--- sample" in out
    with pytest.raises(SystemExit, match="cannot sample from .*nope"):
        main(["--ckpt", str(base / "nope"), "--device", "cpu"])
