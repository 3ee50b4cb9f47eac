"""The port's mixture of experts (``gym_tpu_torch/models/moe.py``, B8's
entry points in ``gym_tpu_torch/ops/grouped_matmul.py`` and the MoE GPT)
against ``gym_tpu`` on the CPU, from the same numpy-seeded inputs and
weights (``convert.params_from_jax``).

- ``grouped_dot`` and ``grouped_outer`` against ``gym_tpu.ops.
  grouped_matmul``, forward and gradients, with empty groups, rows past
  ``sum(gs)`` and K problems flattened into one call (JAX's vmap of the
  primitive): rtol 1e-4, atol 1e-6;
- the MoE MLP in its three dispatches at top-1 and top-2, its output, its
  auxiliary loss and every gradient against ``jax.grad`` of ``MoEMLP``:
  rtol 2e-4, atol 2e-5; in bf16 the output within phase 3's band (0.05 of
  the reference's rms plus 0.02 of each element);
- capacity drops under ``einsum``, the chunked grouped matmul equal to the
  unchunked one, and K stacked nodes equal to each node alone;
- the MoE GPT: the training loss with the router losses, the evaluation
  loss without them and every gradient against ``jax.grad``; a K=2 DiLoCo
  ``fit`` against ``gym_tpu``'s step by step; the cached decode against the
  full forward; ``generate_fast`` against ``gym_tpu``'s; the serving engine
  on a config pinned to ``einsum`` (decoded drop-free); the refusal of
  quantized weights with MoE; the MoE init's scales.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.models import nanogpt as J
from gym_tpu.models.base import LossModel as JLossModel
from gym_tpu.models.moe import MoEMLP, moe_active_params as jactive
from gym_tpu.ops import grouped_matmul as JG
from gym_tpu_torch.convert import (flatten_tree, params_from_jax,
                                   serving_params_from_jax)
from gym_tpu_torch.models import moe as TM
from gym_tpu_torch.models import nanogpt as T
from gym_tpu_torch.models.base import LossModel as TLossModel
from gym_tpu_torch.ops import grouped_matmul as TG

# (atol, rms_frac, rtol) of phase 3's bf16 band
BF16_BAND = (0.0, 5e-2, 2e-2)
MOE = dict(block_size=32, vocab_size=48, n_layer=2, n_head=2, n_embd=32,
           dropout=0.0, n_experts=4, expert_topk=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These models are tiny: one intra-op thread runs them fastest, and
    keeps them fast beside other test processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _band(got, ref, band):
    atol, frac, rtol = band
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rms = np.sqrt(np.mean(ref ** 2))
    assert np.all(np.abs(got - ref) <= atol + frac * rms + rtol * np.abs(ref))


# -- B8's entry points --------------------------------------------------------

# (rows, experts, group sizes): uneven, empty groups, rows past sum(gs)
GROUPINGS = {
    "uneven": (12, [5, 1, 4, 2]),
    "empty_groups": (12, [0, 7, 0, 5]),
    "rows_past_sum": (12, [3, 0, 4, 2]),
}


@pytest.mark.parametrize("case", sorted(GROUPINGS))
def test_grouped_dot_and_outer_match_jax(case):
    r, gs = GROUPINGS[case]
    gs = np.asarray(gs, np.int32)
    c, h = 6, 5
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(r, c)).astype(np.float32)
    w = rng.normal(size=(len(gs), c, h)).astype(np.float32)
    ct = rng.normal(size=(r, h)).astype(np.float32)
    co = rng.normal(size=(len(gs), c, h)).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: JG.grouped_dot(a, b, jnp.asarray(gs)),
                     jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(ct))
    o, vjp_o = jax.vjp(lambda a, b: JG.grouped_outer(a, b, jnp.asarray(gs)),
                       jnp.asarray(x), jnp.asarray(ct))
    jox, joc = vjp_o(jnp.asarray(co))

    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = TG.grouped_dot(tx, tw, torch.tensor(gs))
    ty.backward(torch.tensor(ct))
    tc = torch.tensor(ct, requires_grad=True)
    tx2 = torch.tensor(x, requires_grad=True)
    to = TG.grouped_outer(tx2, tc, torch.tensor(gs))
    to.backward(torch.tensor(co))
    for got, ref in ((ty, y), (tx.grad, jgx), (tw.grad, jgw), (to, o),
                     (tx2.grad, jox), (tc.grad, joc)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)
    if case == "rows_past_sum":
        assert torch.all(ty[int(gs.sum()):] == 0)
    if case == "empty_groups":
        assert torch.all(to[0] == 0) and torch.all(to[2] == 0)


def test_k_nodes_flatten_into_one_grouped_matmul():
    """K problems as one call over K·E groups (node n's rows in groups
    n·E … n·E+E−1) equal ``jax.vmap`` of the JAX primitive, whose batch rule
    flattens them the same way; gradients too."""
    k, r, e, c, h = 3, 10, 4, 6, 5
    rng = np.random.default_rng(5)
    x = rng.normal(size=(k, r, c)).astype(np.float32)
    w = rng.normal(size=(k, e, c, h)).astype(np.float32)
    gs = np.asarray([[2, 3, 0, 5], [10, 0, 0, 0], [1, 1, 1, 7]], np.int32)
    ct = rng.normal(size=(k, r, h)).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jax.vmap(JG.grouped_dot)(
        a, b, jnp.asarray(gs)), jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(ct))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = TG.grouped_dot(tx.reshape(k * r, c), tw.reshape(k * e, c, h),
                        torch.tensor(gs).reshape(-1)).view(k, r, h)
    ty.backward(torch.tensor(ct))
    for got, ref in ((ty, y), (tx.grad, jgx), (tw.grad, jgw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)


def test_transposed_weight_is_read_through_its_strides():
    """``w.transpose(1, 2)`` (the cotangent's read) gives the product with
    the transposed weights, and the entry points refuse a device they do
    not run on."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(7, 5)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(2, 6, 5)).astype(np.float32))
    gs = torch.tensor([3, 4], dtype=torch.int32)
    got = TG.grouped_dot(x, w.transpose(1, 2), gs)
    want = TG.grouped_dot(x, w.transpose(1, 2).contiguous(), gs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="dims disagree"):
        TG.grouped_dot(x, w, gs)
    assert TG.grouped_dot.launches == 0 and TG.grouped_outer.launches == 0


# -- the MoE MLP --------------------------------------------------------------

B, TT, C, E = 2, 8, 16, 4


@pytest.fixture(scope="module")
def mlp_inputs():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, TT, C)).astype(np.float32)
    r = rng.normal(size=(B, TT, C)).astype(np.float32)
    m = MoEMLP(n_embd=C, n_layer=2, n_experts=E, topk=2, dropout=0.0)
    shapes = jax.eval_shape(lambda: m.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x),
        train=False))["params"]
    p = jax.tree.map(lambda a: (0.3 * rng.normal(size=a.shape)).astype(
        np.float32), shapes)
    return x, r, p


def _jax_mlp(p, x, r, impl, topk, dtype=None, **kw):
    m = MoEMLP(n_embd=C, n_layer=2, n_experts=E, topk=topk, dropout=0.0,
               moe_impl=impl, **kw)
    if dtype is not None:
        p = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
        x = jnp.asarray(x, dtype)

    def f(pp, xx):
        y, aux = m.apply({"params": pp}, xx, train=False)
        return jnp.sum(y.astype(jnp.float32) * r) + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    return (np.asarray(y, np.float32), float(aux),
            flatten_tree(jax.tree.map(np.asarray, gp)), np.asarray(gx))


def _port_mlp(p, x, r, impl, topk, dtype=None, **kw):
    tp = {n: t.to(dtype or torch.float32).requires_grad_()
          for n, t in params_from_jax(p, 1).items()}
    tx = torch.tensor(x)[None].to(dtype or torch.float32).requires_grad_()
    y, aux = TM.moe_mlp(tp, "", tx, topk=topk, impl=impl, **kw)
    (torch.sum(y[0].float() * torch.tensor(r)) + aux[0]).backward()
    return (y[0].detach().float().numpy(), aux[0].item(),
            {n: t.grad[0].float().numpy() for n, t in tp.items()},
            tx.grad[0].float().numpy())


@pytest.mark.parametrize("topk", [1, 2])
@pytest.mark.parametrize("impl", ["ragged", "einsum", "dense"])
def test_moe_mlp_matches_jax(mlp_inputs, impl, topk):
    """Output, weighted aux and the gradient of every parameter and of x;
    the einsum dispatch at the default capacity factor, so both drop the
    same tokens."""
    x, r, p = mlp_inputs
    jy, jaux, jg, jgx = _jax_mlp(p, x, r, impl, topk)
    ty, taux, tg, tgx = _port_mlp(p, x, r, impl, topk)
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ty, jy, **tol)
    np.testing.assert_allclose(taux, jaux, **tol)
    np.testing.assert_allclose(tgx, jgx, **tol)
    assert set(tg) == set(jg)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], err_msg=name, **tol)


@pytest.mark.parametrize("topk", [1, 2])
def test_moe_mlp_bf16_within_the_band(mlp_inputs, topk):
    x, r, p = mlp_inputs
    jy, jaux, _, _ = _jax_mlp(p, x, r, "ragged", topk, jnp.bfloat16)
    ty, taux, _, _ = _port_mlp(p, x, r, "ragged", topk, torch.bfloat16)
    _band(ty, jy, BF16_BAND)
    np.testing.assert_allclose(taux, jaux, rtol=2e-2)


def test_einsum_capacity_drops_tokens():
    """At one slot an expert most tokens are dropped: at most E rows of the
    output are nonzero, and the port drops the tokens JAX drops."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 16, 8)).astype(np.float32)
    m = MoEMLP(n_embd=8, n_layer=2, n_experts=2, topk=1, moe_impl="einsum",
               capacity_factor=2 / 16, dropout=0.0)
    vs = jax.jit(lambda v: m.init({"params": jax.random.PRNGKey(2)}, v,
                                  train=False))(jnp.asarray(x))
    jy, _ = jax.jit(lambda v: m.apply(vs, v, train=False))(jnp.asarray(x))
    ty, _ = TM.moe_mlp(params_from_jax(vs["params"], 1), "",
                       torch.tensor(x)[None], topk=1, impl="einsum",
                       capacity_factor=2 / 16)
    nonzero = torch.any(ty[0].reshape(-1, 8) != 0, dim=-1)
    assert 0 < int(nonzero.sum()) <= 2
    np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-5)


def test_chunked_equals_unchunked(mlp_inputs):
    """``chunk_rows`` blocks (5 rows: a block ends inside a group, and the
    last one is padded with expert E−1) give the unchunked layer: the
    outputs exactly (each row's products are the same), the gradients
    within summation order."""
    x, r, p = mlp_inputs
    ty, taux, tg, tgx = _port_mlp(p, x, r, "ragged", 2)
    cy, caux, cg, cgx = _port_mlp(p, x, r, "ragged", 2, chunk_rows=5)
    np.testing.assert_array_equal(cy, ty)
    assert caux == taux
    np.testing.assert_allclose(cgx, tgx, rtol=1e-5, atol=1e-6)
    for name in tg:
        np.testing.assert_allclose(cg[name], tg[name], rtol=1e-5, atol=1e-6)


def test_stacked_nodes_equal_each_node_alone():
    """K=3 nodes with their own weights and tokens in one call (one grouped
    matmul over 3·E groups) equal each node run alone."""
    rng = np.random.default_rng(4)
    m = MoEMLP(n_embd=C, n_layer=2, n_experts=E, topk=2, dropout=0.0)
    x = rng.normal(size=(3, B, TT, C)).astype(np.float32)
    init = jax.jit(lambda key: m.init({"params": key}, jnp.asarray(x[0]),
                                      train=False)["params"])
    trees = [init(jax.random.PRNGKey(n)) for n in range(3)]
    one = [params_from_jax(t, 1) for t in trees]
    stacked = {n: torch.cat([o[n] for o in one]) for n in one[0]}
    y, aux = TM.moe_mlp(stacked, "", torch.tensor(x), topk=2)
    for n in range(3):
        yn, auxn = TM.moe_mlp(one[n], "", torch.tensor(x[n])[None], topk=2)
        np.testing.assert_allclose(y[n].numpy(), yn[0].numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(aux[n].item(), auxn[0].item(), rtol=1e-6)


def test_top_k_breaks_ties_toward_the_lower_expert():
    gates = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = TM.top_k(gates, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1, 2], [1, 3, 0]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# -- the MoE GPT --------------------------------------------------------------

K = 2


def _numpy_tree(cfg, seed):
    """A flax param tree of ``cfg``'s shapes from numpy, biases and
    layer-norm parameters nonzero."""
    shapes = jax.eval_shape(lambda: J.GPT(cfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32),
        train=False))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        std = 0.05 if "bias" in name else 0.02
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _port_cfg(cfg, **over):
    return T.GPTConfig(**{**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(T.GPTConfig)},
                          **over})


@pytest.fixture(scope="module")
def gpt():
    cfg = J.GPTConfig(**MOE)
    trees = [_numpy_tree(cfg, s) for s in range(K)]
    rng = np.random.default_rng(7)
    x = rng.integers(0, 48, (K, 2, 32)).astype(np.int32)
    y = rng.integers(0, 48, (K, 2, 32)).astype(np.int32)
    y[:, 0, :3] = -1
    tparams = {n: torch.cat([params_from_jax(t)[n] for t in trees])
               for n in params_from_jax(trees[0])}
    return cfg, trees, tparams, x, y


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_gpt_loss_and_grads_match_jax(gpt, train):
    """The training loss carries the weighted router losses and the
    evaluation loss does not; every leaf's gradient (K=2 nodes, each its
    own weights and batch) against ``jax.grad``."""
    cfg, trees, tparams, x, y = gpt
    tmodel = T.GPT(_port_cfg(cfg, moe_impl="ragged"))
    leaves = {n: p.clone().requires_grad_(True) for n, p in tparams.items()}
    loss, _ = TLossModel(tmodel).loss(
        leaves, {}, (torch.tensor(x), torch.tensor(y)), None, train)
    grads = dict(zip(leaves, torch.autograd.grad(loss.sum(),
                                                 list(leaves.values()))))
    jlm = JLossModel(J.GPT(dataclasses.replace(cfg, moe_impl="ragged")))

    @jax.jit
    def f(p, xb, yb):
        return jlm.loss(p, {}, (xb, yb), jax.random.PRNGKey(0), train)[0]

    for node in range(K):
        jl, jg = jax.value_and_grad(jax.jit(f))(trees[node], x[node],
                                                y[node])
        np.testing.assert_allclose(loss[node].item(), float(jl), rtol=1e-5)
        jg = flatten_tree(jax.tree.map(np.asarray, jg))
        assert set(jg) == set(grads)
        for name, g in jg.items():
            np.testing.assert_allclose(grads[name][node].numpy(), g,
                                       rtol=2e-4, atol=2e-6,
                                       err_msg=f"node {node} {name}")
    if train:
        ev, _ = TLossModel(tmodel).loss(
            tparams, {}, (torch.tensor(x), torch.tensor(y)), None, False)
        assert torch.all(loss.detach() > ev)


def test_init_scales_names_and_active_params():
    cfg = T.GPTConfig(**MOE)
    p = T.GPT(cfg).init_params(2, seed=0, device="cpu")
    jtree = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(lambda: J.GPT(J.GPTConfig(**MOE)).init(
            jax.random.PRNGKey(0), np.zeros((1, 4), np.int32),
            train=False))["params"])
    jp = flatten_tree(jtree)
    assert set(p) == set(jp)
    for name, w in p.items():
        assert tuple(w.shape) == (2,) + jp[name].shape, name
    resid = 0.02 / np.sqrt(2 * MOE["n_layer"])
    assert abs(p["h_1.moe.fc_kernel"].std().item() - 0.02) < 2e-3
    assert abs(p["h_1.moe.proj_kernel"].std().item() - resid) < 1e-3
    assert abs(p["h_1.moe.router.kernel"].std().item() - 0.02) < 5e-3
    assert torch.all(p["h_1.moe.fc_bias"] == 0)
    assert torch.all(p["h_1.moe.proj_bias"] == 0)
    assert "h_0.mlp.c_fc.kernel" in p and "h_1.mlp.c_fc.kernel" not in p
    one = {n: w[0] for n, w in p.items()}
    assert TM.moe_active_params(one, 2, 4) == jactive(jtree, 2, 4)
    jmfu = J.node_mfu(J.GPTConfig(**MOE), jax.tree.map(
        lambda a: np.zeros((2,) + a.shape, a.dtype), jtree), 8.0, 0.05,
        peak_flops=989e12)
    np.testing.assert_allclose(T.node_mfu(cfg, p, 8.0, 0.05, 989e12), jmfu,
                               rtol=1e-12)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_diloco_fit_matches_jax(tmp_path):
    """A K=2 DiLoCo fit (AdamW, H=2) of the MoE GPT through both trainers
    from the same weights and tokens, 4 steps: the train losses (with the
    router losses) and the evals step by step (rtol 5e-5, the fits'
    tolerance in tests/test_torch_trainer.py)."""
    from gym_tpu import Trainer as JTrainer
    from gym_tpu.data import ContiguousGPTTrainDataset as JDataset
    from gym_tpu.strategy import DiLoCoStrategy as JDiLoCo
    from gym_tpu.strategy import OptimSpec as JSpec
    from gym_tpu_torch import Trainer as TTrainer
    from gym_tpu_torch.data import ContiguousGPTTrainDataset as TDataset
    from gym_tpu_torch.strategy import DiLoCoStrategy as TDiLoCo
    from gym_tpu_torch.strategy import OptimSpec as TSpec
    cfg = J.GPTConfig(**MOE)
    tree = _numpy_tree(cfg, 3)
    toks = np.random.default_rng(0).integers(0, 48, 3000).astype(np.int32)
    fit = dict(num_nodes=2, max_steps=4, batch_size=2, device="cpu",
               val_size=2, val_interval=2, seed=3, show_progress=False,
               log_dir=str(tmp_path))
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": 2})
    JTrainer(J.GPT(cfg), JDataset(toks[:2500], 32),
             JDataset(toks[2500:], 32)).fit(
        strategy=JDiLoCo(JSpec("adamw", lr=1e-2), H=2, **sched),
        run_name="jax", init_params=tree, **fit)
    res = TTrainer(T.GPT(_port_cfg(cfg)), TDataset(toks[:2500], 32),
                   TDataset(toks[2500:], 32)).fit(
        strategy=TDiLoCo(TSpec("adamw", lr=1e-2), H=2, **sched),
        run_name="torch", init_params=params_from_jax(tree, 2), **fit)
    assert res.steps == 4
    for name in ("train.csv", "validation.csv"):
        jr = _rows(os.path.join(tmp_path, "jax", name))
        tr = _rows(os.path.join(tmp_path, "torch", name))
        assert len(jr) == len(tr) > 0
        for a, b in zip(jr, tr):
            np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                       rtol=5e-5, err_msg=f"{name} {a}")
    with open(os.path.join(tmp_path, "torch", "config.json")) as f:
        assert '"moe_impl": "ragged"' in f.read()


@pytest.fixture(scope="module")
def served():
    cfg = J.GPTConfig(**MOE)
    params = _numpy_tree(cfg, 11)
    return cfg, params, serving_params_from_jax(params, "cpu")


def test_cached_decode_matches_full_forward(served):
    """A prefill of 5 tokens, then one token a step, through the MoE
    blocks on B8's f32 path and the router on R1: the JAX full forward's
    logits at every position."""
    cfg, params, tp = served
    idx = np.random.default_rng(3).integers(0, 48, (2, 10)).astype(np.int32)
    full = np.asarray(jax.jit(J.GPT(cfg).apply, static_argnames="train")(
        {"params": params}, jnp.asarray(idx), train=False))
    model = T.GPT(T.decode_config(_port_cfg(cfg)))
    cache = model.init_cache(2, "cpu")
    lg = model.decode(tp, torch.from_numpy(idx[:, :5]), cache)
    np.testing.assert_allclose(lg.numpy(), full[:, :5], rtol=1e-4,
                               atol=1e-5)
    for j in range(5, 10):
        lg = model.decode(tp, torch.from_numpy(idx[:, j:j + 1]), cache)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, j], rtol=1e-4,
                                   atol=1e-5)


def test_generate_fast_matches_jax(served):
    cfg, params, tp = served
    idx = np.random.default_rng(5).integers(0, 48, (2, 6)).astype(np.int32)
    want = J.generate_fast(params, cfg, idx, 8, top_k=3, seed=1)
    got = T.generate_fast(tp, _port_cfg(cfg), idx, 8, top_k=3, seed=1)
    np.testing.assert_array_equal(got, want)


def test_engine_serves_an_einsum_pinned_config(served):
    """A training config pinned to the capacity-limited einsum dispatch
    serves drop-free: ``decode_config`` resets the dispatch, and the
    engine's stream is ``gym_tpu``'s ``generate_fast``'s."""
    from gym_tpu_torch.serve import InferenceEngine, SamplingParams
    cfg, params, tp = served
    cfg = dataclasses.replace(cfg, moe_impl="einsum")
    prompt = np.random.default_rng(6).integers(0, 48, 6).astype(np.int32)
    want = J.generate_fast(params, cfg, prompt[None], 5, top_k=4,
                           seed=1)[0, 6:].tolist()
    eng = InferenceEngine(tp, _port_cfg(cfg), num_slots=2, device="cpu")
    assert eng.config.moe_impl == "auto"
    _, ev = eng.admit(prompt, SamplingParams(max_new_tokens=5, top_k=4,
                                             seed=1))
    toks = [ev.token]
    while not ev.finished:
        ev = eng.step()[0]
        toks.append(ev.token)
    assert toks == want


@pytest.mark.parametrize("wd", ["int8", "int4"])
def test_quantized_moe_is_refused(served, wd):
    from gym_tpu_torch.serve.load import quantize_params
    cfg, _, tp = served
    msg = "quantized serving does not support MoE configs yet"
    with pytest.raises(ValueError, match=msg):
        T.GPT(_port_cfg(cfg, weights_dtype=wd))
    with pytest.raises(ValueError, match=msg):
        quantize_params(tp, _port_cfg(cfg, weights_dtype=wd))
