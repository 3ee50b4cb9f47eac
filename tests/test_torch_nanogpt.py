"""Port parity: GPT loss and every parameter gradient of
``gym_tpu_torch.models.nanogpt`` against ``jax.grad`` of
``gym_tpu.models.base.LossModel(GPT)``, from the same weights
(``gym_tpu_torch.convert.params_from_jax``) and the same numpy batches.

K = 2 nodes with different weights and batches check that each node's
gradient is its own. Tolerances: f32 loss rtol 1e-5, gradients atol 2e-6 /
rtol 2e-4 (summation order only). bf16 (every param and input cast, as the
JAX LossModel does): the two frameworks round the same ops to bf16 but
accumulate their matmuls in different orders, so a value near a rounding
boundary can land one bf16 step apart and the difference propagates — loss
rtol 5e-4, and each gradient within 4% (about ten bf16 steps of 2^-8) of
the JAX gradient's norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.models.base import LossModel as JLossModel
from gym_tpu.models.nanogpt import GPT as JGPT, GPTConfig as JConfig
from gym_tpu_torch.convert import flatten_tree, params_from_jax
from gym_tpu_torch.models.base import LossModel as TLossModel
from gym_tpu_torch.models.nanogpt import GPT as TGPT, GPTConfig as TConfig

K, BATCH, T, V = 2, 2, 64, 65
SMALL = dict(block_size=T, vocab_size=V, n_layer=2, n_head=2, n_embd=32)


def _setup(attn_impl, bias=True, seed=0, batch=BATCH, **over):
    cfg = {**SMALL, **over, "attn_impl": attn_impl, "bias": bias}
    t = cfg["block_size"]
    jmodel = JGPT(JConfig(**cfg))
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (K, batch, t)).astype(np.int32)
    y = rng.integers(0, V, (K, batch, t)).astype(np.int32)
    y[:, 0, :5] = -1  # ignored targets
    trees = []
    for node in range(K):
        p = jmodel.init(jax.random.PRNGKey(seed + node),
                        (jnp.asarray(x[0]), jnp.asarray(y[0])),
                        train=False)["params"]
        trees.append(jax.tree.map(np.asarray, p))
    tparams = {n: torch.cat([params_from_jax(t)[n] for t in trees])
               for n in params_from_jax(trees[0])}
    tmodel = TGPT(TConfig(**cfg))
    return jmodel, tmodel, trees, tparams, x, y


def _jax_loss_grads(jmodel, tree, x, y, dtype):
    lm = JLossModel(jmodel, dtype)

    def f(p):
        return lm.loss(p, {}, (jnp.asarray(x), jnp.asarray(y)),
                       jax.random.PRNGKey(0), True)[0]

    loss, g = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, tree))
    return float(loss), flatten_tree(jax.tree.map(np.asarray, g))


def _torch_loss_grads(tmodel, params, x, y, dtype):
    lm = TLossModel(tmodel, dtype)
    leaves = {n: p.clone().requires_grad_(True) for n, p in params.items()}
    loss, _ = lm.loss(leaves, {}, (torch.tensor(x), torch.tensor(y)), None,
                      True)
    grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
    return loss.detach().numpy(), dict(zip(leaves, grads))


def _assert_f32_parity(jmodel, tmodel, trees, tparams, x, y):
    tloss, tgrads = _torch_loss_grads(tmodel, tparams, x, y, None)
    assert set(tgrads) == set(flatten_tree(trees[0]))
    for node in range(K):
        jloss, jgrads = _jax_loss_grads(jmodel, trees[node], x[node],
                                        y[node], None)
        np.testing.assert_allclose(tloss[node], jloss, rtol=1e-5)
        for name, jg in jgrads.items():
            np.testing.assert_allclose(
                tgrads[name][node].numpy(), jg, atol=2e-6, rtol=2e-4,
                err_msg=f"node {node} grad {name}")


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("bias", [True, False])
def test_loss_and_grads_f32(attn_impl, bias):
    _assert_f32_parity(*_setup(attn_impl, bias))


@pytest.mark.parametrize("remat,loss_chunk", [(True, 0), (False, 48),
                                              (True, 48)])
def test_memory_levers_match_jax(remat, loss_chunk):
    """``remat`` and ``loss_chunk`` (48 rows, which do not divide the 128
    rows of a node, so the last chunk is padded) against ``jax.grad`` of the
    same config: loss and every gradient, f32."""
    _assert_f32_parity(*_setup("flash", seed=8, remat=remat,
                               loss_chunk=loss_chunk))


def test_long_context_loss_and_grads_match_jax():
    """block_size 2048 with the flash dispatch, 2L/2H/128d (head dim 64),
    remat and loss_chunk on: off the card both packages run dense
    attention, as JAX itself does off the TPU."""
    _assert_f32_parity(*_setup("flash", seed=9, batch=1, block_size=2048,
                               n_embd=128, remat=True, loss_chunk=1024))


def test_remat_dropout_draws_the_forward_masks():
    """With dropout, the recomputation of a rematerialized block draws the
    same masks as its forward: loss and gradients equal those of remat=False
    from the same node keys, exactly."""
    from gym_tpu_torch.ops import threefry
    out = []
    for remat in (False, True):
        tmodel = TGPT(TConfig(**SMALL, dropout=0.1, remat=remat))
        params = tmodel.init_params(K, seed=0, device="cpu")
        leaves = {n: p.requires_grad_(True) for n, p in params.items()}
        keys = threefry.node_keys(5, K)
        rng = np.random.default_rng(4)
        batch = tuple(torch.tensor(rng.integers(0, V, (K, BATCH, T)))
                      for _ in range(2))
        loss = tmodel(leaves, batch, train=True, rng=keys)
        grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        out.append((loss.detach(), grads))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_mfu_helpers_match_jax():
    from gym_tpu.models.nanogpt import (estimate_mfu as jmfu,
                                        num_params as jnum)
    from gym_tpu_torch.models.nanogpt import (estimate_mfu, node_mfu,
                                              num_params)
    jmodel, tmodel, trees, tparams, _, _ = _setup("dense")
    one = {n: p[0] for n, p in tparams.items()}
    assert num_params(one) == jnum(trees[0])
    assert num_params(one, False) == jnum(trees[0], False)
    cfg = JConfig(**SMALL)
    want = jmfu(cfg, trees[0], 8.0, 0.05, peak_flops=989e12)
    np.testing.assert_allclose(
        estimate_mfu(tmodel.config, one, 8.0, 0.05, 989e12), want, rtol=1e-12)
    np.testing.assert_allclose(
        node_mfu(tmodel.config, tparams, 8.0, 0.05, 989e12), want,
        rtol=1e-12)


def test_loss_and_grads_bf16():
    jmodel, tmodel, trees, tparams, x, y = _setup("flash", seed=3)
    tloss, tgrads = _torch_loss_grads(tmodel, tparams, x, y, torch.bfloat16)
    for node in range(K):
        jloss, jgrads = _jax_loss_grads(jmodel, trees[node], x[node],
                                        y[node], jnp.bfloat16)
        np.testing.assert_allclose(tloss[node], jloss, rtol=5e-4)
        for name, jg in jgrads.items():
            tg = tgrads[name][node].float().numpy()
            assert tgrads[name].dtype == torch.float32
            err = np.linalg.norm(tg - jg) / (np.linalg.norm(jg) + 1e-12)
            assert err < 0.04, f"node {node} grad {name}: rel err {err}"


def test_logits_match():
    jmodel, tmodel, trees, tparams, x, _ = _setup("dense", seed=5)
    tl = tmodel(tparams, torch.tensor(x), train=False).numpy()
    for node in range(K):
        jl = jmodel.apply({"params": trees[node]}, jnp.asarray(x[node]),
                          train=False)
        np.testing.assert_allclose(tl[node], np.asarray(jl), atol=2e-5,
                                   rtol=1e-4)


def test_init_scales_and_names():
    tmodel = TGPT(TConfig(**SMALL))
    p = tmodel.init_params(3, seed=0, device="cpu")
    jp = flatten_tree(JGPT(JConfig(**SMALL)).init(
        jax.random.PRNGKey(0),
        (jnp.zeros((1, T), jnp.int32), jnp.zeros((1, T), jnp.int32)),
        train=False)["params"])
    assert set(p) == set(jp)
    for name, w in p.items():
        assert tuple(w.shape) == (3,) + jp[name].shape
        assert torch.equal(w[0], w[2])  # replicas start identical
    resid = 0.02 / np.sqrt(2 * SMALL["n_layer"])
    assert abs(p["h_0.attn.c_proj.kernel"].std().item() - resid) < 2e-3
    assert abs(p["h_0.mlp.c_fc.kernel"].std().item() - 0.02) < 2e-3
    assert torch.all(p["ln_f.scale"] == 1) and torch.all(p["ln_f.bias"] == 0)


@pytest.mark.parametrize("field,value", [
    ("decode", True), ("n_experts", 4), ("weights_dtype", "int8"),
    ("seq_axis", "seq"), ("kv_dtype", "int8"), ("attn_impl", "ring")])
def test_later_slice_features_raise(field, value):
    if field == "decode":
        # KV-cache decode is ported (GPT.decode): a decode config builds,
        # and its training forward refuses, naming the decode entry point
        model = TGPT(TConfig(**SMALL, decode=True))
        params = model.init_params(1, 0, "cpu")
        idx = torch.zeros(1, 1, 8, dtype=torch.int64)
        with pytest.raises(ValueError, match="GPT.decode"):
            model(params, idx, train=False)
        return
    with pytest.raises(NotImplementedError):
        TGPT(TConfig(**SMALL, **{field: value}))
