"""Port parity: ``gym_tpu_torch.ops.threefry`` against ``jax.random`` (jax
0.9.0, threefry, partitionable), bit for bit on the CPU, where the device
functions run their plain twin (threefry in int64 tensors masked to 32
bits). Also the leaf order the strategies key their draws by, and the flat
shards of ZeRO and DiLoCo's sharded outer state, against the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.models.nanogpt import GPT as JGPT, GPTConfig as JConfig
from gym_tpu.strategy.sharding import take_shard as j_take_shard
from gym_tpu_torch.convert import flatten_tree, jax_leaf_order
from gym_tpu_torch.ops import threefry as tf
from gym_tpu_torch.strategy import faults as tfaults
from gym_tpu_torch.strategy import sharding as tsharding

SEEDS = [0, 7, 2 ** 31 + 5]


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_algebra_matches_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = tf.PRNGKey(seed)
    assert _key(jk) == tk
    for d in (0, 1, 146, 2 ** 32 - 1):
        assert _key(jax.random.fold_in(jk, d)) == tf.fold_in(tk, d)
    for num in (2, 5):
        assert [_key(k) for k in jax.random.split(jk, num)] == \
            tf.split(tk, num)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_tables_match_jax(seed):
    """``node_keys`` is the JAX trainer's per-node ``fold_in(PRNGKey(seed),
    node + 1)``; ``fold_in_rows`` folds each row (one datum or one a row),
    and ``micro_keys`` is the step's then the microbatch's fold."""
    from gym_tpu_torch.train_node import micro_keys
    table = tf.node_keys(seed, 5)
    base = jax.random.PRNGKey(seed)
    nodes = [jax.random.fold_in(base, i + 1) for i in range(5)]
    assert [tuple(int(v) for v in r) for r in table] == \
        [_key(k) for k in nodes]
    data = np.array([0, 1, 146, 2 ** 32 - 1, 2 ** 31])
    got = tf.fold_in_rows(table, data)
    assert [tuple(int(v) for v in r) for r in got] == \
        [_key(jax.random.fold_in(k, int(d))) for k, d in zip(nodes, data)]
    mk = micro_keys(table, 9, 3)
    for i in range(3):
        assert [tuple(int(v) for v in r) for r in mk[i]] == [
            _key(jax.random.fold_in(jax.random.fold_in(k, 9), i))
            for k in nodes]


@pytest.mark.parametrize("parts", [("CNN_0", "Dropout_0", 1),
                                   ("Dropout_0", 1), ("h_11", "attn", 1),
                                   ("h_3", "mlp", "Dropout_0", 1),
                                   ("a", 0, 255, 256, 2 ** 40)])
def test_fold_in_static_matches_flax(parts):
    """flax's SHA-1 fold of a module path and call counter, on a key and on
    every row of a key table."""
    from flax.core.scope import _fold_in_static
    base = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    want = _key(jax.random.key_data(_fold_in_static(base, parts)))
    assert tf.fold_in_static(_key(base), *parts) == want
    table = tf.key_table([_key(base)] * 3)
    rows = tf.fold_in_static(table, *parts)
    assert [tuple(int(v) for v in r) for r in rows] == [want] * 3
    assert tf.fold_in_paths(table, [parts, parts[:1]])[0].tolist() == \
        rows.tolist()


@pytest.mark.parametrize("n", [0, 1, 5, 4097])
def test_bernoulli_rows_match_jax(n):
    """Row r of ``bernoulli_rows`` is ``jax.random.bernoulli(keys[r], p,
    (n,))``, bit for bit."""
    table = tf.fold_in_rows(tf.node_keys(7, 4), 33)
    for p in (0.5, 0.75, 0.9):
        got = tf.bernoulli_rows(table, p, n, "cpu")
        assert got.shape == (4, n) and got.dtype == torch.bool
        for r, (k0, k1) in enumerate(table):
            jk = jax.random.wrap_key_data(np.array([k0, k1], np.uint32))
            np.testing.assert_array_equal(
                got[r].numpy(), np.asarray(jax.random.bernoulli(jk, p, (n,))))


SEGMENT_SIZES = [0, 1, 3, 4, 5, 1023, 4097]


@pytest.mark.parametrize("p", [0.005, 0.5])
def test_bernoulli_segments_match_jax(p):
    """Segment s of ``bernoulli_segments`` is ``jax.random.bernoulli(keys[s],
    p, (sizes[s],))``, bit for bit, on sizes that are empty, shorter than a
    4-element group, one group, and end inside a group; each segment's view
    starts 16-byte aligned in the one flat buffer."""
    keys = tf.fold_in_rows(tf.node_keys(7, len(SEGMENT_SIZES)), 5)
    buf, views = tf.bernoulli_segments(keys, p, SEGMENT_SIZES, "cpu")
    assert buf.dtype == torch.bool and len(views) == len(SEGMENT_SIZES)
    for (k0, k1), n, got in zip(keys, SEGMENT_SIZES, views):
        assert got.shape == (n,)
        assert (got.data_ptr() - buf.data_ptr()) % 16 == 0
        jk = jax.random.wrap_key_data(np.array([k0, k1], np.uint32))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.bernoulli(jk, p, (n,))))


def test_sparta_masks_in_one_draw_match_per_leaf_and_jax():
    """``RandomIndexSelector.masks`` draws every leaf of the GPT's tree in
    one ``bernoulli_segments`` call; its masks equal the per-leaf
    ``mask()`` draws and ``gym_tpu``'s ``masks`` leaf for leaf, bit for
    bit, at several iterations, on a dict whose order differs from JAX's
    leaf order (the keys follow the JAX leaf index)."""
    from gym_tpu.strategy.sparta import RandomIndexSelector as JSelector
    from gym_tpu_torch.strategy.sparta import RandomIndexSelector
    tree = _gpt_tree()
    flat = flatten_tree(tree)
    params = {n: torch.tensor(np.asarray(flat[n])) for n in reversed(flat)}
    order = jax_leaf_order(params)
    sel, jsel = RandomIndexSelector(0.3), JSelector(0.3)
    for it in (0, 1, 17):
        got = sel.masks(params, it)
        assert list(got) == list(params)
        jm = flatten_tree(jsel.masks(tree, it))
        for n, x in params.items():
            assert got[n].shape == x.shape and got[n].dtype == torch.bool
            assert torch.equal(got[n], sel.mask(x, order[n], it))
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(jm[n]))


@pytest.mark.parametrize("n", [0, 1, 3, 4097, 100_003])
def test_bits_uniform_bernoulli_match_jax_bit_for_bit(n):
    for seed in SEEDS:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        tk = tf.fold_in(tf.PRNGKey(seed), 11)
        bits = np.asarray(jax.random.bits(jk, (n,))).view(np.int32)
        np.testing.assert_array_equal(tf.random_bits(tk, n, "cpu").numpy(),
                                      bits)
        u = np.asarray(jax.random.uniform(jk, (n,)))
        np.testing.assert_array_equal(
            tf.uniform(tk, n, "cpu").numpy().view(np.int32), u.view(np.int32))
        for p in (0.005, 0.3, 0.5):
            m = np.asarray(jax.random.bernoulli(jk, p, (n,)))
            np.testing.assert_array_equal(
                tf.bernoulli(tk, p, n, "cpu").numpy(), m)


@pytest.mark.parametrize("n", [1, 2, 1000, 70_000])
def test_permutation_matches_jax(n):
    """Rounds: 0 at n=1, 1 at 2 and 1000, 2 at 70,000 (each a stable sort
    by fresh bits)."""
    assert tf.sort_rounds(n) == {1: 0, 2: 1, 1000: 1, 70_000: 2}[n]
    for seed in SEEDS:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        tk = tf.fold_in(tf.PRNGKey(seed), 3)
        perm = tf.permutation(tk, n, "cpu")
        np.testing.assert_array_equal(
            perm.numpy(), np.asarray(jax.random.permutation(jk, n)))
        np.testing.assert_array_equal(
            tf.inverse_permutation(perm).numpy(),
            np.asarray(jnp.argsort(jax.random.permutation(jk, n))))


@pytest.mark.parametrize("rate", [0.25, 0.5, 0.75])
def test_fault_draws_match_jax(rate):
    from gym_tpu.strategy import faults as jfaults
    for k in (1, 4, 16):
        for step in range(6):
            alive = np.asarray(jfaults.alive_mask(5678, step, k, rate))
            assert tfaults.alive_mask(5678, step, k, rate) == \
                tuple(alive.tolist())
            assert tfaults.host_participation(5678, step, k, rate) == \
                jfaults.host_participation(5678, step, k, rate)


def _gpt_tree():
    cfg = JConfig(block_size=32, vocab_size=65, n_layer=12, n_head=2,
                  n_embd=16)
    x = jnp.zeros((1, 32), jnp.int32)
    return JGPT(cfg).init(jax.random.PRNGKey(0), (x, x),
                          train=False)["params"]


def test_jax_leaf_order_is_tree_flatten_order():
    """The index each flat name gets equals its leaf's position in
    ``jax.tree.flatten`` of the flax tree (12 layers, so h_10 sorts before
    h_2)."""
    tree = _gpt_tree()
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    want = [".".join(str(p.key) for p in path) for path, _ in leaves]
    order = jax_leaf_order(flatten_tree(tree))
    assert sorted(order, key=order.__getitem__) == want
    assert want.index("h_10.attn.c_attn.kernel") < want.index(
        "h_2.attn.c_attn.kernel")


def test_take_shard_matches_jax():
    """Node i's slice i of its raveled tree, for K = 3 nodes with different
    params (the last shard zero-padded), against the JAX package's
    ``take_shard`` on each node; ``unshard`` reassembles the tree."""
    nested = _gpt_tree()
    rng = np.random.default_rng(0)
    k = 3
    per_node = [jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape), jnp.float32), nested) for _ in range(k)]
    flat = [flatten_tree(t) for t in per_node]
    stacked = {n: torch.tensor(np.stack([f[n] for f in flat]))
               for n in flat[0]}
    shards, n = tsharding.take_shard(stacked, k)
    for i in range(k):
        mine, _, jn = j_take_shard(per_node[i], k, i)
        assert jn == n
        np.testing.assert_array_equal(shards[i].numpy(), np.asarray(mine))
    same = {name: v[:1].expand_as(v) for name, v in stacked.items()}
    back = tsharding.unshard(tsharding.take_shard(same, k)[0], n, same)
    assert list(back) == list(stacked)
    for name, v in back.items():
        np.testing.assert_array_equal(v.numpy(), stacked[name][0].numpy())
