"""Port parity: ``gym_tpu_torch.strategy.compress`` (the codecs and
``CompressedLink``), ``threefry.randint`` and NoLoCo's partner cycle against
``gym_tpu`` on the same numpy inputs and keys.

Tolerances: the quantized payloads (int8 values and f32 scales) and the
top-k payloads bit for bit under the same key; decompressions, the link's
delivered payload and its error-feedback residual bit for bit (the same
elementwise f32 arithmetic); wire bytes and keys exactly; ``randint`` and
σ exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.strategy import compress as J
from gym_tpu.strategy.noloco import NoLoCoCommunicator as JNoLoCo
from gym_tpu_torch.ops import threefry as tf
from gym_tpu_torch.strategy import compress as T
from gym_tpu_torch.strategy.noloco import NoLoCoCommunicator as TNoLoCo


def _tkey(jkey):
    k = np.asarray(jax.random.key_data(jkey)) if hasattr(
        jax.random, "key_data") else np.asarray(jkey)
    return (int(k[0]), int(k[1]))


def _x(rng, rows, n):
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[0, :5] = 0.0                  # a tile start of zeros
    x[-1, -1] = 40.0                # one large value in the last tile
    return x


@pytest.mark.parametrize("bits,tile,n,stochastic", [
    (8, 256, 1000, True), (4, 256, 1000, True), (8, 64, 4097, True),
    (4, 7, 50, True), (8, 256, 1000, False), (4, 32, 300, False)])
def test_quantize_codec_payload_bit_for_bit(bits, tile, n, stochastic):
    rng = np.random.default_rng(bits * 7 + tile)
    x = _x(rng, 3, n)
    jc = J.QuantizeCodec(bits=bits, tile=tile, stochastic=stochastic)
    tc = T.QuantizeCodec(bits=bits, tile=tile, stochastic=stochastic)
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(11), i) for i in range(3)]
    tq, ts = tc.compress(torch.tensor(x), [_tkey(k) for k in jkeys])
    for r in range(3):
        jq, js = jc.compress(jnp.asarray(x[r]), jkeys[r])
        np.testing.assert_array_equal(tq[r].numpy(), np.asarray(jq))
        assert ts[r].numpy().tobytes() == np.asarray(js).tobytes()
        jd = np.asarray(jc.decompress((jq, js), n))
        assert tc.decompress((tq, ts), n)[r].numpy().tobytes() == \
            jd.tobytes()
    assert tq.dtype == torch.int8 and int(tq.abs().max()) <= tc.qmax
    assert tc.wire_bytes(n) == jc.wire_bytes(n)
    assert tc.config() == jc.config()


def test_quantize_shared_key_is_one_draw_for_every_row():
    """A key shared by the rows (DynamiQ's hop keys) rounds every row with
    the same noise: each row equals its own compression under that key."""
    rng = np.random.default_rng(1)
    x = torch.tensor(_x(rng, 4, 700))
    tc = T.QuantizeCodec(bits=4)
    key = tf.fold_in(tf.PRNGKey(3), 9)
    before = tf.random_bits.launches
    q, s = tc.compress(x, key)
    for r in range(4):
        qr, sr = tc.compress(x[r:r + 1], key)
        assert torch.equal(q[r], qr[0]) and torch.equal(s[r], sr[0])
    assert tf.random_bits.launches == before   # the CPU runs the twin


@pytest.mark.parametrize("frac,n", [(0.01, 5000), (0.3, 40), (1.0, 17),
                                    (0.001, 70_000)])
def test_topk_codec_matches_jax(frac, n):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, n)).astype(np.float32)
    x[1, [3, 9]] = [2.5, -2.5]      # an exact |tie|
    jc, tc = J.TopKCodec(frac=frac), T.TopKCodec(frac=frac)
    ti, tv = tc.compress(torch.tensor(x), None)
    for r in range(2):
        ji, jv = jc.compress(jnp.asarray(x[r]), None)
        np.testing.assert_array_equal(ti[r].numpy(), np.asarray(ji))
        assert tv[r].numpy().tobytes() == np.asarray(jv).tobytes()
        jd = np.asarray(jc.decompress((ji, jv), n))
        assert tc.decompress((ti, tv), n)[r].numpy().tobytes() == \
            jd.tobytes()
    assert tc.wire_bytes(n) == jc.wire_bytes(n) == tc.k_of(n) * 8.0
    if frac >= 1.0:   # lossless
        assert torch.equal(tc.roundtrip(torch.tensor(x), None),
                           torch.tensor(x))


def test_topk_of_zeros_decodes_the_same():
    """Zeros (and denormals) pack into keys that XLA's CPU comparison
    flushes to 0.0, so they tie there and XLA's sort orders them its own
    way; the port orders them by index. Such picks carry the value 0: the
    picked indices may differ, the decompressed vector does not."""
    x = np.zeros((1, 40), np.float32)
    x[0, [7, 30]] = [1.5, -2.0]
    jc, tc = J.TopKCodec(frac=0.25), T.TopKCodec(frac=0.25)
    ji, jv = jc.compress(jnp.asarray(x[0]), None)
    ti, tv = tc.compress(torch.tensor(x), None)
    assert ti[0, :2].tolist() == np.asarray(ji)[:2].tolist() == [30, 7]
    assert tc.decompress((ti, tv), 40)[0].numpy().tobytes() == \
        np.asarray(jc.decompress((ji, jv), 40)).tobytes()


@pytest.mark.parametrize("codec", ["int8", "int4", "topk", None])
def test_link_error_feedback_matches_jax(codec):
    """Four rounds through the link with its residual: the delivered
    payloads and the residual bit for bit, per-node keys folded from the
    node index."""
    rng = np.random.default_rng(3)
    n, k = 600, 3
    kw = {"frac": 0.05} if codec == "topk" else {}
    jl = J.CompressedLink(codec, seed=1206, **kw)
    tl = T.CompressedLink(codec, seed=1206, **kw)
    assert tl.error_feedback == jl.error_feedback == (codec is not None)
    jstate = [jl.init(n) for _ in range(k)]
    tstate = tl.init(n, k, "cpu")
    for step in range(4):
        x = rng.standard_normal((k, n)).astype(np.float32)
        t_hat, tstate = tl.send(torch.tensor(x), tstate,
                                tl.node_keys(step, k))
        for i in range(k):
            j_hat, jstate[i] = jl.send(jnp.asarray(x[i]), jstate[i],
                                       jl.key(step, 0, i))
            assert t_hat[i].numpy().tobytes() == \
                np.asarray(j_hat).tobytes()
            if codec is not None:
                assert tstate["ef_residual"][i].numpy().tobytes() == \
                    np.asarray(jstate[i]["ef_residual"]).tobytes()
    assert tl.wire_bytes(n) == jl.wire_bytes(n)
    assert tl.config() == jl.config()


def test_keys_match_jax():
    for seed, step, hop, node in [(0, 0, 0, None), (1206, 5, 0, 3),
                                  (2602, 17, 1, None), (7, 2 ** 20, 2, 63)]:
        assert T.link_key(seed, step, hop, node) == _tkey(
            J.link_key(seed, step, hop, node))
    for seed, step in [(2602, 0), (2602, 9), (1, 123)]:
        assert T.hop_keys(seed, step) == [_tkey(k) for k in
                                          J.hop_keys(seed, step)]


def test_make_codec_and_dense_link():
    assert isinstance(T.make_codec(None), T.QuantizeCodec)
    assert T.make_codec("int4").bits == 4
    assert isinstance(T.make_codec("topk", frac=0.1), T.TopKCodec)
    with pytest.raises(ValueError):
        T.make_codec("int2")
    with pytest.raises(ValueError):
        T.CompressedLink("dense", frac=0.1)
    dense = T.CompressedLink("dense")
    x = torch.ones(2, 5)
    assert dense.encode(x, None, None)[0] is x and dense.init(5, 2,
                                                              "cpu") == {}
    assert dense.wire_bytes(5) == 20.0


def test_randint_matches_jax():
    for seed in range(12):
        for step in range(4):
            jkey = jax.random.fold_in(jax.random.PRNGKey(seed), step)
            tkey = tf.fold_in(tf.PRNGKey(seed), step)
            for lo, hi in [(1, 2), (1, 3), (1, 64), (0, 1000), (-5, 7),
                           (1, 1 << 20), (4, 4), (9, 2), (0, 2 ** 31 - 1)]:
                assert tf.randint(tkey, lo, hi) == int(
                    jax.random.randint(jkey, (), lo, hi)), (seed, step, lo,
                                                            hi)


@pytest.mark.parametrize("k", [2, 3, 4, 5, 8, 16, 33, 64])
def test_noloco_partner_cycle_matches_jax(k):
    """σ is JAX's draw, bit for bit, over several steps, with no fixed
    point: π conjugates a rotation by r ≠ 0, which splits into gcd(r, K)
    cycles."""
    j, t = JNoLoCo(H=2), TNoLoCo(H=2)
    for step in (1, 2, 4, 10, 99):
        sigma = t.partner_permutation(step, k)
        np.testing.assert_array_equal(
            sigma, np.asarray(j._perm_jax(jnp.asarray(step, jnp.int32), k)))
        assert sorted(sigma) == list(range(k))
        assert all(sigma[i] != i for i in range(k))
