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


def _setup(attn_impl, bias=True, seed=0):
    jcfg = JConfig(**SMALL, attn_impl=attn_impl, bias=bias)
    jmodel = JGPT(jcfg)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (K, BATCH, T)).astype(np.int32)
    y = rng.integers(0, V, (K, BATCH, T)).astype(np.int32)
    y[:, 0, :5] = -1  # ignored targets
    trees = []
    for node in range(K):
        p = jmodel.init(jax.random.PRNGKey(seed + node),
                        (jnp.asarray(x[0]), jnp.asarray(y[0])),
                        train=False)["params"]
        trees.append(jax.tree.map(np.asarray, p))
    tparams = {n: torch.cat([params_from_jax(t)[n] for t in trees])
               for n in params_from_jax(trees[0])}
    tmodel = TGPT(TConfig(**SMALL, attn_impl=attn_impl, bias=bias))
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


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
@pytest.mark.parametrize("bias", [True, False])
def test_loss_and_grads_f32(attn_impl, bias):
    jmodel, tmodel, trees, tparams, x, y = _setup(attn_impl, bias)
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
    ("seq_axis", "seq"), ("loss_chunk", 128), ("attn_impl", "ring")])
def test_later_slice_features_raise(field, value):
    with pytest.raises(NotImplementedError):
        TGPT(TConfig(**SMALL, **{field: value}))
