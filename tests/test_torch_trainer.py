"""Port parity for the slice as a whole: ``Trainer.fit(device="cpu")`` of
``gym_tpu_torch`` against ``gym_tpu``'s, a tiny GPT at K = 4 simulated nodes
for 8 steps, from identical ``init_params`` and the same token stream (with
dropout, the same masks: both draw them from the per-node threefry keys).

The ``train.csv`` losses (node 0) and the ``validation.csv`` local and
global evals must agree in f32 within rtol 5e-5 (DeMo, NoLoCo and DynamiQ
too) (the per-step difference is
summation order; DiLoCo's outer step at lr 0.7 and Adam's normalisation
carry it forward over the 8 steps). The comm columns must agree within
rtol 1e-6.
"""

import csv
import os
import time

import jax
import numpy as np
import pytest
import torch

from gym_tpu import Trainer as JTrainer
from gym_tpu.data import ContiguousGPTTrainDataset as JDataset
from gym_tpu.models.nanogpt import GPT as JGPT, GPTConfig as JConfig
from gym_tpu.strategy import (DeMoStrategy as JDeMo,
                              DiLoCoStrategy as JDiLoCo,
                              DynamiQStrategy as JDynamiQ,
                              FedAvgStrategy as JFedAvg,
                              NoLoCoStrategy as JNoLoCo, OptimSpec as JSpec,
                              SimpleReduceStrategy as JSimple,
                              SPARTADiLoCoStrategy as JSPARTADiLoCo)
from gym_tpu_torch import Trainer as TTrainer
from gym_tpu_torch.convert import params_from_jax
from gym_tpu_torch.data import ContiguousGPTTrainDataset as TDataset
from gym_tpu_torch.models.nanogpt import GPT as TGPT, GPTConfig as TConfig
from gym_tpu_torch.strategy import (DeMoStrategy as TDeMo,
                                    DiLoCoStrategy as TDiLoCo,
                                    DynamiQStrategy as TDynamiQ,
                                    FedAvgStrategy as TFedAvg,
                                    NoLoCoStrategy as TNoLoCo,
                                    OptimSpec as TSpec,
                                    SimpleReduceStrategy as TSimple,
                                    SPARTADiLoCoStrategy as TSPARTADiLoCo)

K, T, V, STEPS = 4, 32, 65, 8
SMALL = dict(block_size=T, vocab_size=V, n_layer=2, n_head=2, n_embd=32,
             attn_impl="flash")
RTOL = 5e-5


def _tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, V, 6000).astype(np.int32)


def _init_tree():
    import jax.numpy as jnp
    x = jnp.zeros((1, T), jnp.int32)
    p = JGPT(JConfig(**SMALL)).init(jax.random.PRNGKey(7), (x, x),
                                    train=False)["params"]
    return jax.tree.map(np.asarray, p)


def _strategy(pkg, which):
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": 2})
    jax_pkg = pkg == "jax"
    spec = (JSpec if jax_pkg else TSpec)("adamw", lr=1e-2)
    if which == "diloco":
        return (JDiLoCo if jax_pkg else TDiLoCo)(spec, H=2, **sched)
    if which == "sparta_diloco":
        return (JSPARTADiLoCo if jax_pkg else TSPARTADiLoCo)(
            spec, p_sparta=0.3, H=2, participation=0.75, **sched)
    if which == "fedavg":
        return (JFedAvg if jax_pkg else TFedAvg)(spec, H=2, island_size=2,
                                                 **sched)
    if which == "demo":
        return (JDeMo if jax_pkg else TDeMo)(
            (JSpec if jax_pkg else TSpec)("sgd", lr=1e-3), **sched)
    if which == "noloco":
        return (JNoLoCo if jax_pkg else TNoLoCo)(spec, H=2, **sched)
    if which == "dynamiq":
        return (JDynamiQ if jax_pkg else TDynamiQ)(spec, codec="int8",
                                                   **sched)
    return (JSimple if jax_pkg else TSimple)(spec, **sched)


FIT = dict(num_nodes=K, max_steps=STEPS, batch_size=4, minibatch_size=2,
           device="cpu", val_size=4, val_interval=4, seed=3,
           show_progress=False)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _fit_port(tmp_path, which, tree, levers=None, **kw):
    toks = _tokens()
    return TTrainer(TGPT(TConfig(**SMALL, **(levers or {}))),
                    TDataset(toks[:5000], T),
                    TDataset(toks[5000:], T)).fit(
        strategy=_strategy("torch", which), log_dir=str(tmp_path),
        init_params=params_from_jax(tree, K), **{**FIT, **kw})


@pytest.mark.parametrize("which,levers", [
    pytest.param("diloco", {}, id="diloco"),
    pytest.param("simple_reduce", {}, id="simple_reduce"),
    # the stochastic strategies: threefry masks, fault draws and island
    # shuffles equal to the JAX package's
    pytest.param("sparta_diloco", {}, id="sparta_diloco"),
    pytest.param("fedavg", {}, id="fedavg"),
    # the compression strategies: DeMo (K = 4: its sparse decode), NoLoCo's
    # partner gossip, DynamiQ's int8 hops on the shared threefry keys
    pytest.param("demo", {}, id="demo"),
    pytest.param("noloco", {}, id="noloco"),
    pytest.param("dynamiq", {}, id="dynamiq"),
    # the memory levers: 48-row loss chunks do not divide a microbatch's 64
    pytest.param("diloco", dict(remat=True, loss_chunk=48),
                 id="diloco-remat-loss_chunk"),
    # dropout: flax's masks from the per-node keys, in every dropout of
    # the model and in the attention probabilities, recomputed under remat
    pytest.param("diloco", dict(dropout=0.1), id="diloco-dropout"),
    pytest.param("diloco", dict(dropout=0.1, remat=True),
                 id="diloco-dropout-remat")])
def test_fit_matches_jax(tmp_path, which, levers):
    toks = _tokens()
    tree = _init_tree()
    JTrainer(JGPT(JConfig(**SMALL, **levers)), JDataset(toks[:5000], T),
             JDataset(toks[5000:], T)).fit(
        strategy=_strategy("jax", which), log_dir=str(tmp_path),
        run_name="jax", init_params=tree, **FIT)
    res = _fit_port(tmp_path, which, tree, levers, run_name="torch")
    assert res.steps == STEPS and np.isfinite(res.final_train_loss)

    jt = _rows(os.path.join(tmp_path, "jax", "train.csv"))
    tt = _rows(os.path.join(tmp_path, "torch", "train.csv"))
    assert len(jt) == len(tt) == STEPS
    assert list(jt[0]) == list(tt[0])
    for a, b in zip(jt, tt):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=RTOL, err_msg=f"step {a['step']}")
        np.testing.assert_allclose(float(b["lr"]), float(a["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(b["comm_bytes"]),
                                   float(a["comm_bytes"]), rtol=1e-6)
    jv = _rows(os.path.join(tmp_path, "jax", "validation.csv"))
    tv = _rows(os.path.join(tmp_path, "torch", "validation.csv"))
    assert [(r["step"], r["name"]) for r in jv] == \
        [(r["step"], r["name"]) for r in tv]
    assert {r["name"] for r in tv} == {"local", "global"}
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=RTOL, err_msg=f"{a['name']} eval")


class _JRecv(JSimple):
    """SimpleReduce that also reports a per-node ``comm_recv_bytes``:
    100 · node + step."""

    def step(self, grads, params, state, step, ctx):
        import jax.numpy as jnp
        params, state, m = super().step(grads, params, state, step, ctx)
        recv = 100.0 * ctx.node_index().astype(jnp.float32) + step
        return params, state, {**m, "comm_recv_bytes": recv}


class _TRecv(TSimple):
    def step(self, grads, params, state, step, ctx):
        params, state, m = super().step(grads, params, state, step, ctx)
        recv = 100.0 * ctx.node_index(grads["wte.embedding"].device) + step
        return params, state, {**m, "comm_recv_bytes": recv.float()}


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_comm_recv_bytes_is_kept_as_the_node_mean(tmp_path, steps_per_call):
    """A strategy's per-node ``comm_recv_bytes`` lands in
    ``history["comm_recv_bytes"]`` as its node mean, as in the JAX
    trainer."""
    toks = _tokens()
    tree = _init_tree()
    kw = {**FIT, "max_steps": 4, "val_size": 0,
          "steps_per_call": steps_per_call}
    spec = dict(lr_scheduler="lambda_cosine",
                lr_scheduler_kwargs={"warmup_steps": 2})
    jres = JTrainer(JGPT(JConfig(**SMALL)), JDataset(toks, T)).fit(
        strategy=_JRecv(JSpec("adamw", lr=1e-2), **spec),
        log_dir=str(tmp_path), run_name="jax", init_params=tree, **kw)
    tres = TTrainer(TGPT(TConfig(**SMALL)), TDataset(toks, T)).fit(
        strategy=_TRecv(TSpec("adamw", lr=1e-2), **spec),
        log_dir=str(tmp_path), run_name="torch",
        init_params=params_from_jax(tree, K), **kw)
    want = [(s, 150.0 + s) for s in range(4)]  # K = 4: mean of 100·node
    assert jres.history["comm_recv_bytes"] == want
    assert tres.history["comm_recv_bytes"] == want


def test_steps_per_call_and_microbatches_are_the_same_run(tmp_path):
    """Several steps per call (and the grad-accumulation loop) change the
    dispatch, not the result."""
    tree = _init_tree()
    one = _fit_port(tmp_path, "diloco", tree, run_name="one")
    multi = _fit_port(tmp_path, "diloco", tree, run_name="multi",
                      steps_per_call=3)
    assert [l for _, l in one.history["train_loss"]] == \
        [l for _, l in multi.history["train_loss"]]


def test_bf16_autocast_fit_on_cpu(tmp_path):
    """bf16 compute trains; eval stays f32 and both evals are logged."""
    res = _fit_port(tmp_path, "diloco", _init_tree(), run_name="bf16",
                    autocast=True, skip_nonfinite=True)
    losses = [l for _, l in res.history["train_loss"]]
    assert len(losses) == STEPS and np.all(np.isfinite(losses))
    assert len(res.history["global_loss"]) == 3  # steps 0, 4 and the end
    assert set(res.params) == set(params_from_jax(_init_tree()))


def test_skip_nonfinite_quarantines_a_diverged_node(tmp_path):
    """A node whose loss is NaN contributes zero gradient: the other nodes
    stay finite and every step logs the quarantine."""
    init = params_from_jax(_init_tree(), K)
    init["wte.embedding"][1] = float("nan")
    toks = _tokens()
    res = TTrainer(TGPT(TConfig(**SMALL)), TDataset(toks[:5000], T)).fit(
        strategy=_strategy("torch", "simple_reduce"), init_params=init,
        skip_nonfinite=True, log_dir=str(tmp_path), run_name="nan",
        **{**FIT, "max_steps": 3})
    assert all(np.isfinite(l) for _, l in res.history["train_loss"])
    assert res.history["nonfinite"] == [(0, 1.0), (1, 1.0), (2, 1.0)]
    node = res.node_state.params["h_0.attn.c_attn.kernel"]
    assert torch.isfinite(node[0]).all() and torch.isfinite(node[2]).all()


class _SlowModel(torch.nn.Module):
    """One weight vector per node; every forward sleeps ``DELAY`` seconds,
    so a step takes at least that long."""
    DELAY = 0.15

    def init_params(self, num_nodes, seed, device):
        return {"w": torch.ones(num_nodes, 4, device=device)}

    def forward(self, params, batch, train=True, rng=None):
        time.sleep(self.DELAY)
        x = batch[0].float().mean(dim=(1, 2))
        return params["w"].sum(dim=1) * x


def test_steady_rate_counts_only_steps_inside_its_window(tmp_path):
    """Eagerly, reading the first step's loss waits for the second step
    too, so the steady clock may count only the steps after that: three
    steps of at least DELAY each give at most 1/DELAY steady steps/s."""
    res = TTrainer(_SlowModel(), TDataset(_tokens(), T)).fit(
        strategy=_strategy("torch", "simple_reduce"), num_nodes=2,
        max_steps=3, batch_size=2, device="cpu", val_size=0,
        log_dir=str(tmp_path), run_name="slow", show_progress=False)
    assert res.steps == 3
    assert 0 < res.steps_per_second_steady <= 1.0 / _SlowModel.DELAY


def test_fit_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: fit() would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TTrainer(TGPT(TConfig(**SMALL)), TDataset(_tokens(), T)).fit(
            strategy=_strategy("torch", "diloco"), num_nodes=2, max_steps=1)


@pytest.mark.parametrize("kwarg,value", [
    ("correlation_interval", 2), ("compilation_cache_dir", "c"),
    ("profile_dir", "p"), ("cp", 2), ("tp", 2), ("pp", 2), ("ep", 2)])
def test_later_slice_kwargs_raise(kwarg, value):
    with pytest.raises(NotImplementedError):
        TTrainer(TGPT(TConfig(**SMALL)), TDataset(_tokens(), T)).fit(
            strategy=_strategy("torch", "diloco"), num_nodes=2, max_steps=1,
            device="cpu", **{kwarg: value})


def test_network_kwargs_simulate_the_run(tmp_path):
    """``network=`` and ``network_overlap=`` (a later slice's kwargs once)
    price the run on the topology: ``sim_step_s`` a row and the totals."""
    res = TTrainer(TGPT(TConfig(**SMALL)), TDataset(_tokens(), T)).fit(
        strategy=_strategy("torch", "diloco"), num_nodes=2, max_steps=3,
        batch_size=2, device="cpu", val_size=0, log_dir=str(tmp_path),
        run_name="net", show_progress=False, network="federated",
        network_overlap=True)
    assert res.sim["topology"] == "federated" and res.sim["overlap"]
    assert res.sim["steps"] == 3
    assert [s for s, _ in res.history["sim_step_s"]] == [0, 1, 2]
    rows = _rows(tmp_path / "net" / "train.csv")
    assert all(float(r["sim_step_s"]) > 0 for r in rows)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_make_init_fn_takes_the_card_unless_told(device):
    """``make_init_fn`` without a device resolves it as ``fit()`` does: the
    card, or a RuntimeError where there is none; ``device="cpu"`` builds
    the node state on the CPU."""
    from gym_tpu_torch.models.base import as_loss_model
    from gym_tpu_torch.train_node import make_init_fn
    strategy = _strategy("torch", "simple_reduce").finalize(1)
    loss_model = as_loss_model(TGPT(TConfig(**SMALL)))
    if device is None:
        if torch.cuda.is_available():
            pytest.skip("a card is present: the state would go to it")
        with pytest.raises(RuntimeError, match="CUDA"):
            make_init_fn(loss_model, strategy, 0)
        return
    state = make_init_fn(loss_model, strategy, 0, device=device)(
        torch.arange(2))
    assert all(p.device.type == "cpu" and p.shape[0] == 2
               for p in state.params.values())
