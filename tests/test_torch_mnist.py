"""Port parity for the MNIST CNN: ``gym_tpu_torch.models.mnist_cnn``
against ``gym_tpu.models.MnistLossModel`` from the same weights, running
stats and numpy batches.

- The loss and the new ``batch_stats`` of one microbatch, f32, train (with
  dropout) and eval, K = 2 nodes with different weights: loss rtol 5e-5,
  stats atol 1e-6 / rtol 5e-5 (summation order only; the dropout masks are
  the same bits). bf16 (params, stats and inputs cast, as the JAX
  LossModel casts them): loss rtol 2e-2 and stats within 2e-2 of the f32
  scale, about three bf16 steps (2^-8) on values of order one.
- The dropout masks: each flax ``nn.Dropout``'s output against the port's
  mask from the per-node keys, bit for bit.
- ``Trainer.fit`` under SimpleReduce, DiLoCo (H 2) and SPARTA (p 0.3), K = 2
  nodes, 4 steps of 4 rows in 2 microbatches, on images and labels drawn
  with numpy: the train and validation CSV losses at rtol 5e-5, and
  ``FitResult.model_state``, the node mean of the running stats, within
  5e-5 of each tensor's largest magnitude (a running mean near zero sums
  activations of order one over 8 microbatches, so an elementwise rtol
  would measure cancellation).

Why the fits use SGD (lr 1e-3) on normal-noise images: a trajectory can be
held at rtol 5e-5 only where it is that well conditioned, and the port's
convolutions sum in another order than XLA's (step-0 losses agree to about
1e-6). Under Adam the conv biases ahead of BatchNorm get gradients of pure
rounding noise (about 1e-7), which Adam scales to steps of ±lr: ``gym_tpu``
against itself, from weights perturbed by 1e-7 relative, drifts 4.9e-5 in
the step-2 train loss and 1e-3 in a step-4 eval (SimpleReduce, Adam 1e-3,
the digits). On the digits, whose flat background leaves channels of small
variance for BatchNorm's 1/sqrt(var + 1e-5) to amplify, ``gym_tpu`` against
itself under SGD and DiLoCo drifts 5.8e-5 by step 3 from a 1e-6
perturbation, as the port does. On normal-noise images under SGD the port
stays within 2.3e-5 over these 4 steps. Adam's arithmetic is held to
optax's in ``test_torch_strategy.py``; the digits to the JAX package's
byte for byte in ``test_torch_offline_data.py``.

The Adam path through ``fit`` (configs 1-3 train with Adam) is held where
it is well conditioned: 2 steps of SimpleReduce, Adam 1e-3, warmup 2 (so
lr 0 at step 0 and both gradients are taken at the initial weights). The
train losses of steps 0 and 1 and the step-0 evals at rtol 5e-5 (measured
3.4e-7), the running stats' node mean as above, and the update of every
parameter but the conv biases ahead of BatchNorm within 1e-2 of its norm
(measured up to 7.9e-3 on ``Conv_1.kernel``: Adam's m/sqrt(v) of two
gradients of opposite sign cancels on a few elements, which then take
either sign). The conv biases' own updates are ±lr in both packages with
independent signs, the noise described above.
"""

import csv
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu import Trainer as JTrainer
from gym_tpu.data import ArrayDataset as JArrays
from gym_tpu.models import MnistLossModel as JMnist
from gym_tpu.models.base import LossModel as JLossModel
from gym_tpu.strategy import (DiLoCoStrategy as JDiLoCo, OptimSpec as JSpec,
                              SimpleReduceStrategy as JSimple,
                              SPARTAStrategy as JSPARTA)
from gym_tpu_torch import Trainer as TTrainer
from gym_tpu_torch.convert import (flatten_tree, model_state_from_jax,
                                   params_from_jax)
from gym_tpu_torch.data import ArrayDataset as TArrays
from gym_tpu_torch.models.base import LossModel as TLossModel, dropout_mask
from gym_tpu_torch.models.mnist_cnn import MnistLossModel as TMnist
from gym_tpu_torch.ops import threefry
from gym_tpu_torch.strategy import (DiLoCoStrategy as TDiLoCo,
                                    OptimSpec as TSpec,
                                    SimpleReduceStrategy as TSimple,
                                    SPARTAStrategy as TSPARTA)
from gym_tpu_torch.train_node import micro_keys

K, B = 2, 4
RTOL = 5e-5


def _batch(seed=0, nchw=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, B, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (K, B)).astype(np.int32)
    if nchw:
        x = np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3))
    return x, y


def _jax_nodes(x, y):
    """Each node's flax params and stats (different per node: node n from
    PRNGKey(n)), the stats moved off their init by one train step."""
    lm = JLossModel(JMnist())
    trees, states = [], []
    for n in range(K):
        p, s = lm.init(jax.random.PRNGKey(n), (jnp.asarray(x[0]),
                                               jnp.asarray(y[0])))
        _, s = lm.loss(p, s, (jnp.asarray(x[n]), jnp.asarray(y[n])),
                       jax.random.PRNGKey(9), True)
        trees.append(jax.tree.map(np.asarray, p))
        states.append(jax.tree.map(np.asarray, s))
    return lm, trees, states


def _port_state(trees, states):
    params = {n: torch.cat([params_from_jax(t)[n] for t in trees])
              for n in params_from_jax(trees[0])}
    ms = [model_state_from_jax(s, 1) for s in states]
    state = {c: {n: torch.cat([m[c][n] for m in ms]) for n in ms[0][c]}
             for c in ms[0]}
    return params, state


def _node_rng(seed, node, step, micro):
    r = jax.random.fold_in(jax.random.PRNGKey(seed), node + 1)
    return jax.random.fold_in(jax.random.fold_in(r, step), micro)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_loss_and_batch_stats_f32(train):
    x, y = _batch(1, nchw=not train)
    lm, trees, states = _jax_nodes(x, y)
    params, state = _port_state(trees, states)
    keys = micro_keys(threefry.node_keys(3, K), 5, 2)[1]
    loss, new = TLossModel(TMnist()).loss(
        params, state, (torch.tensor(x), torch.tensor(y)), keys, train)
    assert loss.dtype == torch.float32 and loss.shape == (K,)
    for n in range(K):
        jl, js = lm.loss(trees[n], states[n],
                         (jnp.asarray(x[n]), jnp.asarray(y[n])),
                         _node_rng(3, n, 5, 1), train)
        np.testing.assert_allclose(loss[n].item(), float(jl), rtol=RTOL)
        for name, v in flatten_tree(js["batch_stats"]).items():
            np.testing.assert_allclose(
                new["batch_stats"][name][n].numpy(), v, atol=1e-6,
                rtol=RTOL, err_msg=f"node {n} {name}")
    if not train:  # eval returns the state it was given
        assert new is state


def test_loss_and_batch_stats_bf16():
    x, y = _batch(2)
    lm = JLossModel(JMnist(), jnp.bfloat16)
    _, trees, states = _jax_nodes(x, y)
    params, state = _port_state(trees, states)
    keys = micro_keys(threefry.node_keys(3, K), 0, 1)[0]
    loss, new = TLossModel(TMnist(), torch.bfloat16).loss(
        params, state, (torch.tensor(x), torch.tensor(y)), keys, True)
    for n in range(K):
        jl, js = lm.loss(trees[n], states[n],
                         (jnp.asarray(x[n]), jnp.asarray(y[n])),
                         _node_rng(3, n, 0, 0), True)
        np.testing.assert_allclose(loss[n].item(), float(jl), rtol=2e-2)
        for name, v in flatten_tree(js["batch_stats"]).items():
            got = new["batch_stats"][name]
            assert got.dtype == torch.float32  # cast back to storage
            np.testing.assert_allclose(got[n].numpy(), v, atol=2e-2,
                                       rtol=2e-2, err_msg=name)


def test_dropout_masks_match_flax():
    """Record each flax ``nn.Dropout``'s input and output in train mode and
    hold it to the port's mask: out == where(mask, in / keep, 0)."""
    x, y = _batch(3)
    lm, trees, states = _jax_nodes(x, y)
    seed, step, micro = 11, 7, 2
    keys = micro_keys(threefry.node_keys(seed, K), step, 3)[micro]
    paths = TMnist().cnn.dropout_paths()
    site_keys = threefry.fold_in_paths(keys, paths)
    for n in range(K):
        seen = []

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, nn.Dropout):
                seen.append((context.module.rate, context.module.name,
                             np.asarray(args[0]), np.asarray(out)))
            return out

        with nn.intercept_methods(record):
            lm.loss(trees[n], states[n],
                    (jnp.asarray(x[n]), jnp.asarray(y[n])),
                    _node_rng(seed, n, step, micro), True)
        assert [s[1] for s in seen] == ["Dropout_0", "Dropout_1",
                                        "Dropout_2"]
        for (rate, name, inp, out), sk in zip(seen, site_keys):
            keep = 1.0 - rate
            shape = list(inp.shape)
            if inp.ndim == 4:  # Dropout2d: broadcast over H and W
                shape[1] = shape[2] = 1
            mask = dropout_mask(sk, keep, shape, "cpu")[n].numpy()
            mask = np.broadcast_to(mask, inp.shape)
            want = np.where(mask, inp / np.float32(keep), 0)
            assert np.array_equal(out, want), f"node {n} {name}"
            assert 0 < mask.mean() < 1


def test_nchw_and_nhwc_inputs_agree():
    x, y = _batch(4)
    params = TMnist().init_params(K, seed=0, device="cpu")
    state = TMnist().init_state(K, "cpu")
    keys = threefry.node_keys(0, K)
    lm = TLossModel(TMnist())
    a, _ = lm.loss(params, state, (torch.tensor(x), torch.tensor(y)), keys,
                   True)
    b, _ = lm.loss(params, state, (torch.tensor(x).permute(0, 1, 4, 2, 3),
                                   torch.tensor(y)), keys, True)
    assert torch.equal(a, b)


def test_init_matches_flax_shapes_and_scales():
    """flax's names and shapes, lecun-normal kernels (std sqrt(1/fan_in),
    truncated at 2 std), zero biases, unit BatchNorm scales, running stats
    0 and 1; replicas start identical."""
    jp, js = JLossModel(JMnist()).init(
        jax.random.PRNGKey(0), (jnp.zeros((1, 28, 28, 1)),
                                jnp.zeros((1,), jnp.int32)))
    p = TMnist().init_params(3, seed=0, device="cpu")
    flat = flatten_tree(jp)
    assert list(p) == list(flat)
    for name, w in p.items():
        assert tuple(w.shape) == (3,) + flat[name].shape
        assert torch.equal(w[0], w[2])
    k = p["CNN_0.Dense_0.kernel"][0]
    std = np.sqrt(1.0 / k.shape[0])
    assert abs(k.std().item() - std) < 0.02 * std
    assert k.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.all(p["CNN_0.BatchNorm_3.scale"] == 1)
    assert torch.all(p["CNN_0.Conv_2.bias"] == 0)
    st = TMnist().init_state(3, "cpu")["batch_stats"]
    assert set(st) == set(flatten_tree(js["batch_stats"]))
    assert torch.all(st["CNN_0.BatchNorm_1.var"] == 1)
    assert torch.all(st["CNN_0.BatchNorm_1.mean"] == 0)


def _strategy(pkg, which):
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": 2})
    jx = pkg == "jax"
    spec = (JSpec if jx else TSpec)("sgd", lr=1e-3)
    if which == "diloco":
        return (JDiLoCo if jx else TDiLoCo)(spec, H=2, **sched)
    if which == "sparta":
        return (JSPARTA if jx else TSPARTA)(spec, p_sparta=0.3, **sched)
    return (JSimple if jx else TSimple)(spec, **sched)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


FIT = dict(num_nodes=K, max_steps=4, batch_size=4, minibatch_size=2,
           device="cpu", val_size=4, val_interval=2, seed=3,
           show_progress=False)


def _images(arrays):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 256).astype(np.int32)
    return arrays(x[:200], y[:200]), arrays(x[200:], y[200:])


@pytest.mark.parametrize("which", ["simple_reduce", "diloco", "sparta"])
def test_fit_matches_jax(tmp_path, which):
    x = jnp.zeros((1, 28, 28, 1))
    tree = jax.tree.map(np.asarray, JMnist().init(
        jax.random.PRNGKey(7), (x, jnp.zeros((1,), jnp.int32)),
        train=False)["params"])
    jres = JTrainer(JMnist(), *_images(JArrays)).fit(
        strategy=_strategy("jax", which), log_dir=str(tmp_path),
        run_name="jax", init_params=tree, **FIT)
    tres = TTrainer(TMnist(), *_images(TArrays)).fit(
        strategy=_strategy("torch", which), log_dir=str(tmp_path),
        run_name="torch", init_params=params_from_jax(tree, K), **FIT)
    jt = _rows(os.path.join(tmp_path, "jax", "train.csv"))
    tt = _rows(os.path.join(tmp_path, "torch", "train.csv"))
    assert len(jt) == len(tt) == FIT["max_steps"]
    for a, b in zip(jt, tt):
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=RTOL, err_msg=f"step {a['step']}")
        np.testing.assert_allclose(float(b["comm_bytes"]),
                                   float(a["comm_bytes"]), rtol=1e-6)
    jv = _rows(os.path.join(tmp_path, "jax", "validation.csv"))
    tv = _rows(os.path.join(tmp_path, "torch", "validation.csv"))
    assert [(r["step"], r["name"]) for r in jv] == \
        [(r["step"], r["name"]) for r in tv] and len(tv) >= 4
    for a, b in zip(jv, tv):
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=RTOL, err_msg=f"{a['name']} eval")
    # the host node mean of the running stats (C10)
    want = flatten_tree(jres.model_state["batch_stats"])
    got = tres.model_state["batch_stats"]
    assert set(got) == set(want)
    for name, v in want.items():
        assert isinstance(got[name], np.ndarray) and got[name].shape == \
            v.shape
        np.testing.assert_allclose(got[name], v, rtol=RTOL,
                                   atol=RTOL * np.abs(v).max(),
                                   err_msg=name)
    # the stats moved off their init, and differ between the nodes
    node = tres.node_state.model_state["batch_stats"]["CNN_0.BatchNorm_0.mean"]
    assert not torch.equal(node[0], node[1]) and node.abs().sum() > 0


CONV_BIASES = {f"CNN_0.Conv_{i}.bias" for i in range(4)}


def test_fit_under_adam_matches_jax(tmp_path):
    x = jnp.zeros((1, 28, 28, 1))
    tree = jax.tree.map(np.asarray, JMnist().init(
        jax.random.PRNGKey(7), (x, jnp.zeros((1,), jnp.int32)),
        train=False)["params"])
    fit = dict(FIT, max_steps=2)
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": 2})
    jres = JTrainer(JMnist(), *_images(JArrays)).fit(
        strategy=JSimple(JSpec("adam", lr=1e-3), **sched),
        log_dir=str(tmp_path), run_name="jax", init_params=tree, **fit)
    tres = TTrainer(TMnist(), *_images(TArrays)).fit(
        strategy=TSimple(TSpec("adam", lr=1e-3), **sched),
        log_dir=str(tmp_path), run_name="torch",
        init_params=params_from_jax(tree, K), **fit)
    for csv_name in ("train", "validation"):
        jr = _rows(os.path.join(tmp_path, "jax", f"{csv_name}.csv"))
        tr = _rows(os.path.join(tmp_path, "torch", f"{csv_name}.csv"))
        assert len(jr) == len(tr) > 0
        for a, b in zip(jr, tr):
            if csv_name == "validation" and int(a["step"]) > 0:
                continue
            np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                       rtol=RTOL, err_msg=f"{csv_name} "
                                       f"step {a['step']}")
    want = flatten_tree(jres.model_state["batch_stats"])
    for name, v in want.items():
        np.testing.assert_allclose(tres.model_state["batch_stats"][name], v,
                                   rtol=RTOL, atol=RTOL * np.abs(v).max(),
                                   err_msg=name)
    init = flatten_tree(tree)
    moved = flatten_tree(jax.tree.map(np.asarray, jres.params))
    assert set(moved) == set(tres.params)
    for name, v in moved.items():
        if name in CONV_BIASES:
            continue
        dj = v - init[name]
        dt = np.asarray(tres.params[name]) - init[name]
        assert np.linalg.norm(dj) > 0
        rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
        assert rel < 1e-2, f"{name}: update differs by {rel:.3e} of its norm"
