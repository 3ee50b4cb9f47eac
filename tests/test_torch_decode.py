"""The port's KV-cache decode against ``gym_tpu``'s on the CPU
(counterpart of ``tests/test_decode.py``): both packages get the same
numpy-seeded weights (``convert.serving_params_from_jax``) and prompts.

- logits of the cached decode (a prefill, then one token a step), unpaged
  and paged, against the JAX full forward and ``GPT(decode_config(cfg))``
  at every step: |a − b| <= 2e-5 + 1e-5·|b|;
- ``generate_fast`` and ``generate`` give the JAX functions' tokens for
  the same seeds, greedy, top-k and top-p, and agree with each other when
  greedy;
- overflow raises (``generate_fast``) or poisons the row (unpaged) or the
  position (paged) with NaN, leaving its neighbours clean;
- ``sample_logits`` gives ``gym_tpu``'s tokens over temperature, top-k and
  top-p, with the "disabled" encodings (top_k >= V, top_p >= 1) equal to
  the ``None`` paths, one key for all rows or a key a row;
- ``threefry.categorical``'s bits are ``jax.random``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.models import nanogpt as J
from gym_tpu_torch.convert import serving_params_from_jax
from gym_tpu_torch.models import nanogpt as T
from gym_tpu_torch.ops import threefry as tf

V = 65


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=2e-5)


def numpy_params(cfg, seed):
    """A flax param tree of ``cfg``'s shapes filled from numpy: normal
    kernels and embeddings, and nonzero biases and layer-norm parameters."""
    shapes = jax.eval_shape(lambda: J.GPT(cfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 4), np.int32),
        train=False))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        std = 0.02 if ("kernel" in name or "embedding" in name) else 0.05
        return (std * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_config(cfg):
    return T.GPTConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(T.GPTConfig)})


@pytest.fixture(scope="module")
def setup():
    cfg = J.GPTConfig(block_size=64, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    params = numpy_params(cfg, 0)
    idx = np.random.default_rng(1).integers(0, V, (2, 12)).astype(np.int32)
    return cfg, params, serving_params_from_jax(params, "cpu"), \
        port_config(cfg), idx


def full_forward(cfg, params, idx):
    """The JAX training forward's logits, jitted as the package runs it."""
    apply = jax.jit(J.GPT(cfg).apply, static_argnames="train")
    return np.asarray(apply({"params": params}, idx, train=False))


def test_cached_decode_logits_match_full_forward(setup):
    cfg, params, tp, tcfg, idx = setup
    full = full_forward(cfg, params, idx)
    model = T.GPT(T.decode_config(tcfg))
    cache = model.init_cache(2, "cpu")
    _close(model.decode(tp, torch.from_numpy(idx[:, :8]), cache),
           full[:, :8])
    for j in range(8, 12):
        lg = model.decode(tp, torch.from_numpy(idx[:, j:j + 1]), cache)
        _close(lg[:, 0], full[:, j])
    assert cache["pos"].tolist() == [12, 12]


@pytest.mark.parametrize("paged", [False, True])
def test_decode_logits_match_jax_decode(setup, paged):
    """Prefill and three steps of GPT(decode_config(cfg)), unpaged or
    through a shuffled block table of pages of 8, every step's logits."""
    cfg, params, tp, tcfg, idx = setup
    jcfg = J.decode_config(cfg)
    tcfg_d = T.decode_config(tcfg)
    kw, tkw = {}, {}
    if paged:
        jcfg = dataclasses.replace(jcfg, page_size=8, kv_pages=20)
        tcfg_d = dataclasses.replace(tcfg_d, page_size=8, kv_pages=20)
        bt = (1 + np.random.default_rng(2).permutation(19)[:16]).reshape(
            2, 8).astype(np.int32)
        kw = dict(block_table=bt)
        tkw = dict(block_table=torch.from_numpy(bt))
    jm, tm = J.GPT(jcfg), T.GPT(tcfg_d)
    japply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    tcache = tm.init_cache(2, "cpu")
    if paged:
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32), train=False,
            block_table=bt, cache_pos=jnp.zeros(2, jnp.int32)))
        jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                              shapes["cache"])
        variables = {"params": params, "cache": jcache}
    else:
        variables = {"params": params}
    pos = np.zeros(2, np.int32)
    chunks = [idx[:, :9], idx[:, 9:10], idx[:, 10:11], idx[:, 11:12]]
    for chunk in chunks:
        if paged:
            kw["cache_pos"] = pos
            tkw["cache_pos"] = torch.from_numpy(pos)
        lg, vc = japply(variables, chunk, train=False, mutable=("cache",),
                        **kw)
        variables = {"params": params, "cache": vc["cache"]}
        got = tm.decode(tp, torch.from_numpy(chunk), tcache, **tkw)
        _close(got, lg)
        pos = pos + chunk.shape[1]


@pytest.mark.parametrize("kw", [
    dict(top_k=1), dict(temperature=0.8, top_k=5),
    dict(top_p=0.9), dict(temperature=0.9, top_p=0.7)],
    ids=["greedy", "top_k", "top_p", "temp_top_p"])
def test_generate_fast_matches_jax(setup, kw):
    cfg, params, tp, tcfg, idx = setup
    ref = J.generate_fast(params, cfg, idx, 10, seed=3, **kw)
    got = T.generate_fast(tp, tcfg, idx, 10, seed=3, **kw)
    np.testing.assert_array_equal(got, ref)


def test_generate_matches_jax(setup):
    cfg, params, tp, tcfg, idx = setup
    ref = J.generate(params, cfg, idx[:, :4], 6, top_k=5, seed=2)
    got = T.generate(tp, tcfg, idx[:, :4], 6, top_k=5, seed=2)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_p=1e-9)],
                         ids=["greedy", "top_p"])
def test_generate_fast_matches_generate(setup, kw):
    """With one token kept both samplers are argmax decoders: the cached
    and the full-context trajectories agree."""
    cfg, params, tp, tcfg, idx = setup
    slow = T.generate(tp, tcfg, idx, 8, seed=5, **kw)
    fast = T.generate_fast(tp, tcfg, idx, 8, seed=5, **kw)
    np.testing.assert_array_equal(slow, fast)


def test_generate_fast_overflow_raises(setup):
    cfg, params, tp, tcfg, idx = setup
    with pytest.raises(ValueError, match="exceeds the KV cache"):
        T.generate_fast(tp, tcfg, idx, cfg.block_size)
    # `generate` crops the context and keeps going
    out = T.generate(tp, tcfg, idx[:, :4], cfg.block_size + 2, top_k=1)
    assert out.shape == (2, 4 + cfg.block_size + 2)


def test_overflow_poisons_only_its_row_or_position(setup):
    cfg, params, tp, tcfg, idx = setup
    model = T.GPT(T.decode_config(tcfg))
    cache = model.init_cache(2, "cpu")
    cache["pos"] = torch.tensor([cfg.block_size - 8, 0], dtype=torch.int32)
    lg = model.decode(tp, torch.from_numpy(idx[:, :8]), cache)
    assert torch.isfinite(lg).all()
    lg = model.decode(tp, torch.zeros(2, 1, dtype=torch.int32), cache)
    assert torch.isnan(lg[0]).all() and torch.isfinite(lg[1]).all()
    # paged: only the positions past the window
    pcfg = dataclasses.replace(T.decode_config(tcfg), page_size=8,
                               kv_pages=18)
    pm = T.GPT(pcfg)
    pc = pm.init_cache(2, "cpu")
    bt = torch.arange(1, 17, dtype=torch.int32).view(2, 8)
    lg = pm.decode(tp, torch.from_numpy(idx[:, :5]), pc, block_table=bt,
                   cache_pos=torch.tensor([cfg.block_size - 3, 4],
                                          dtype=torch.int32))
    assert torch.isfinite(lg[0, :3]).all() and torch.isnan(lg[0, 3:]).all()
    assert torch.isfinite(lg[1]).all()


@pytest.mark.parametrize("kw", [
    dict(), dict(temperature=0.7), dict(top_k=3), dict(top_k=V + 10),
    dict(top_p=0.8), dict(top_p=1.0), dict(temperature=1.3, top_k=7,
                                           top_p=0.6)],
    ids=["plain", "temp", "top_k", "top_k_over_V", "top_p", "top_p_1",
         "all"])
def test_sample_logits_matches_jax(kw):
    """One key for all rows (generate_fast's draw) and a key a row (the
    engine's vmapped draw), 12 seeds each."""
    rng = np.random.default_rng(9)
    logits = (2 * rng.normal(size=(4, V))).astype(np.float32)
    one = jax.jit(lambda lg, k: J.sample_logits(lg, k, **kw))
    per_row = jax.jit(jax.vmap(lambda lg, k: J.sample_logits(lg, k, **kw)))
    for seed in range(12):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        ref = np.asarray(one(jnp.asarray(logits), key))
        got = T.sample_logits(
            torch.from_numpy(logits),
            tf.key_tensor([tf.PRNGKey(seed)], "cpu"), key_data=torch.tensor(
                [3], dtype=torch.int32), **kw)
        np.testing.assert_array_equal(got.numpy(), ref)
        keys = jnp.stack([jax.random.PRNGKey(seed + r) for r in range(4)])
        ref = np.asarray(per_row(jnp.asarray(logits), keys))
        got = T.sample_logits(
            torch.from_numpy(logits),
            tf.key_tensor([tf.PRNGKey(seed + r) for r in range(4)], "cpu"),
            **kw)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_disabled_encodings_equal_the_none_paths():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy((3 * rng.normal(size=(6, V))).astype(
        np.float32))
    keys = tf.key_tensor([tf.PRNGKey(i) for i in range(6)], "cpu")
    for seed in range(8):
        data = torch.full((6,), seed, dtype=torch.int32)
        a = T.sample_logits(logits, keys, 0.9, None, None, data)
        b = T.sample_logits(logits, keys, torch.full((6,), 0.9),
                            torch.full((6,), V, dtype=torch.int32),
                            torch.ones(6), data)
        assert torch.equal(a, b)


def test_categorical_bits_match_jax():
    keys = [jax.random.fold_in(jax.random.PRNGKey(i), 7) for i in range(3)]
    ref = np.stack([np.asarray(jax.random.bits(k, (V,))) for k in keys])
    got = tf.random_bits_rows(
        tf.key_tensor([tf.PRNGKey(i) for i in range(3)], "cpu"),
        torch.full((3,), 7, dtype=torch.int32), V)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    u = np.asarray(jax.random.uniform(keys[0], (V,),
                                      minval=np.finfo(np.float32).tiny))
    tu = torch.clamp(tf.bits_to_uniform(got[0]), min=tf.F32_TINY)
    np.testing.assert_array_equal(tu.numpy(), u)
    g = np.asarray(jax.random.gumbel(keys[1], (V,)))
    np.testing.assert_allclose(tf.gumbel_from_bits(got[1]).numpy(), g,
                               rtol=1e-6, atol=1e-6)
    lg = np.random.default_rng(0).normal(size=(3, V)).astype(np.float32)
    ref = np.asarray(jax.vmap(jax.random.categorical)(jnp.stack(keys), lg))
    tok = tf.categorical(torch.from_numpy(lg), tf.key_tensor(
        [tf.PRNGKey(i) for i in range(3)], "cpu"),
        torch.full((3,), 7, dtype=torch.int32))
    np.testing.assert_array_equal(tok.numpy(), ref)
