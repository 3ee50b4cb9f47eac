"""``gym_tpu_torch.ops.quantize_tiles`` (T1 bits on its main path: the
codec's quantize with threefry stochastic rounding in one kernel) on the
CPU: its plain version against ``jax.jit`` of ``gym_tpu``'s
``QuantizeCodec.compress``, bit for bit (q and scale), at R = 1, 3 and 16
rows with a key a row and with one key shared by every row, int8 and
int4; the dispatch (the CPU runs the plain version and counts no launch);
the key table's checks.

The JAX references are compiled once a module (one jitted compress a
codec, vmapped over the rows' keys) to keep the file to seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.strategy import compress as J
from gym_tpu_torch.ops import quantize_tiles as qt
from gym_tpu_torch.ops import threefry as tf


@pytest.fixture(scope="module")
def jit_compress():
    """{(bits, tile, stochastic): jitted compress of [R, n] rows under [R]
    keys}."""
    cache = {}

    def get(bits, tile, stochastic):
        k = (bits, tile, stochastic)
        if k not in cache:
            jc = J.QuantizeCodec(bits=bits, tile=tile, stochastic=stochastic)
            cache[k] = jax.jit(jax.vmap(jc.compress))
        return cache[k]
    return get


def _tkey(jkey):
    k = np.asarray(jax.random.key_data(jkey)) if hasattr(
        jax.random, "key_data") else np.asarray(jkey)
    return (int(k[0]), int(k[1]))


def _rows(rng, rows, n):
    x = (rng.standard_normal((rows, n))
         * rng.uniform(0.01, 50, (rows, 1))).astype(np.float32)
    x[0, :300] = 0.0                  # a whole zero tile at the start
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", [1, 3, 16])
@pytest.mark.parametrize("shared", [False, True])
def test_plain_quantize_tiles_is_jitted_jax(jit_compress, bits, rows,
                                           shared):
    rng = np.random.default_rng(100 * bits + rows + shared)
    n = 2000
    x = _rows(rng, rows, n)
    base = jax.random.PRNGKey(2602)
    jkeys = ([jax.random.fold_in(base, 9)] * rows if shared else
             [jax.random.fold_in(base, i) for i in range(rows)])
    jq, js = jit_compress(bits, 256, True)(jnp.asarray(x), jnp.stack(jkeys))
    keys = _tkey(jkeys[0]) if shared else [_tkey(k) for k in jkeys]
    qmax = (1 << (bits - 1)) - 1
    tq, ts = qt.plain_quantize_tiles(torch.tensor(x), keys, qmax, 256)
    assert tq.shape == (rows, 8, 256) and ts.shape == (rows, 8, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()


@pytest.mark.parametrize("tile,n", [(7, 50), (32, 300), (64, 4097),
                                    (4097, 5000)])
def test_plain_quantize_tiles_any_tile(jit_compress, tile, n):
    rng = np.random.default_rng(tile)
    x = _rows(rng, 3, n)
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(1), i) for i in range(3)]
    for stochastic in (True, False):
        jq, js = jit_compress(8, tile, stochastic)(jnp.asarray(x),
                                                   jnp.stack(jkeys))
        tq, ts = qt.plain_quantize_tiles(torch.tensor(x),
                                         [_tkey(k) for k in jkeys], 127,
                                         tile, stochastic)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()


def test_cpu_dispatch_runs_the_plain_version():
    rng = np.random.default_rng(0)
    x = torch.tensor(_rows(rng, 4, 700))
    keys = [tf.fold_in(tf.PRNGKey(3), i) for i in range(4)]
    before = (qt.quantize_tiles.launches, tf.random_bits.launches)
    for k in (keys, keys[1]):
        q, s = qt.quantize_tiles(x, k, 7, 256)
        pq, ps = qt.plain_quantize_tiles(x, k, 7, 256)
        assert torch.equal(q, pq) and torch.equal(s, ps)
    assert (qt.quantize_tiles.launches, tf.random_bits.launches) == before


def test_shared_key_rows_round_with_one_draw():
    """A shared key gives every row the same noise: each row equals its
    own quantize under that key."""
    rng = np.random.default_rng(1)
    x = torch.tensor(_rows(rng, 4, 900))
    key = tf.fold_in(tf.PRNGKey(5), 2)
    q, s = qt.quantize_tiles(x, key, 127, 64)
    for r in range(4):
        qr, sr = qt.quantize_tiles(x[r:r + 1], [key], 127, 64)
        assert torch.equal(q[r], qr[0]) and torch.equal(s[r], sr[0])


def test_key_rows_and_argument_checks():
    assert qt.key_rows((1, 2), 5).tolist() == [[1, 2]]
    assert qt.key_rows([(1, 2), (3, 4)], 2).tolist() == [[1, 2], [3, 4]]
    with pytest.raises(ValueError, match="needs a key"):
        qt.key_rows(None, 2)
    with pytest.raises(ValueError, match="3 keys for 2 rows"):
        qt.key_rows([(1, 2)] * 3, 2)
    x = torch.zeros(2, 10)
    with pytest.raises(ValueError):
        qt.quantize_tiles(x, (1, 2), 15, 256)
    with pytest.raises(ValueError):
        qt.quantize_tiles(torch.zeros(10), (1, 2), 127, 256)
    assert qt.inv_qmax(7) == float(np.float32(1) / np.float32(7))
    # not stochastic: keys are not read
    q, s = qt.quantize_tiles(torch.zeros(2, 10), None, 127, 4, False)
    assert q.shape == (2, 3, 4) and bool((s == 1.0).all())
