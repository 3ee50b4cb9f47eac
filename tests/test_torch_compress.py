"""Port parity: ``gym_tpu_torch.strategy.compress`` (the codecs and
``CompressedLink``), ``threefry.randint`` and NoLoCo's partner cycle against
``gym_tpu`` on the same numpy inputs and keys.

Tolerances: the quantized payloads (int8 values and f32 scales) and the
top-k payloads bit for bit under the same key; decompressions, the link's
delivered payload and its error-feedback residual bit for bit (the same
elementwise f32 arithmetic); wire bytes and keys exactly; ``randint`` and
σ exactly.

The quantize codec and the link are held to ``jax.jit`` of the JAX
functions, as ``strategy.step`` runs them inside the compiled step: XLA
compiles the codec's ``amax / qmax`` into ``amax * f32(1 / qmax)``, which
gives other scales than the eager division (the serving loader's form,
held by ``tests/test_torch_quant.py::test_quantize_params_bit_exact``).
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


def _jit_compress(jc, x_rows, jkeys):
    """``jax.jit(jc.compress)`` of each row under its key → (q, scale,
    decompressed) numpy lists."""
    f = jax.jit(jc.compress)
    out = []
    for row, key in zip(x_rows, jkeys):
        jq, js = f(jnp.asarray(row), key)
        jd = jax.jit(jc.decompress, static_argnums=1)((jq, js), row.size)
        out.append((np.asarray(jq), np.asarray(js), np.asarray(jd)))
    return out


def _same_as_jit(tc, jc, x, tkeys, jkeys):
    n = x.shape[1]
    tq, ts = tc.compress(torch.tensor(x), tkeys)
    td = tc.decompress((tq, ts), n)
    for r, (jq, js, jd) in enumerate(_jit_compress(jc, x, jkeys)):
        np.testing.assert_array_equal(tq[r].numpy(), jq)
        assert ts[r].numpy().tobytes() == js.tobytes(), r
        assert td[r].numpy().tobytes() == jd.tobytes(), r
    assert tq.dtype == torch.int8 and int(tq.abs().max()) <= tc.qmax
    return tq, ts


@pytest.mark.parametrize("bits,tile,n,stochastic", [
    (8, 256, 1000, True), (4, 256, 1000, True), (8, 64, 4097, True),
    (4, 7, 50, True), (8, 256, 1000, False), (4, 32, 300, False)])
def test_quantize_codec_payload_bit_for_bit(bits, tile, n, stochastic):
    rng = np.random.default_rng(bits * 7 + tile)
    x = _x(rng, 3, n)
    jc = J.QuantizeCodec(bits=bits, tile=tile, stochastic=stochastic)
    tc = T.QuantizeCodec(bits=bits, tile=tile, stochastic=stochastic)
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(11), i) for i in range(3)]
    _same_as_jit(tc, jc, x, [_tkey(k) for k in jkeys], jkeys)
    assert tc.wire_bytes(n) == jc.wire_bytes(n)
    assert tc.config() == jc.config()


def _special_tiles(rng, rows, n, tile, tiny=1e-30):
    """Rows of normal values with whole tiles of zeros, a NaN, ±inf, huge
    and ``tiny``-scaled values, and a -0.0 tile."""
    x = (rng.standard_normal((rows, n)) * 3).astype(np.float32)
    t = -(-n // tile)
    for r in range(rows):
        kinds = rng.permutation(t)[:min(t, 6)]
        for k, tt in enumerate(kinds):
            a, b = tt * tile, min(n, (tt + 1) * tile)
            if k == 0:
                x[r, a:b] = 0.0
            elif k == 1:
                x[r, a + (b - a) // 2] = np.nan
            elif k == 2:
                x[r, a] = np.inf
                x[r, b - 1] = -np.inf
            elif k == 3:
                x[r, a:b] *= np.float32(1e37)
            elif k == 4:
                x[r, a:b] *= np.float32(tiny)
            else:
                x[r, a:b] = -0.0
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("tile,n,stochastic", [
    (256, 4096, True), (7, 300, True), (64, 4097, True), (256, 1000, False),
    (32, 500, False)])
def test_quantize_codec_special_tiles_match_jit(bits, tile, n, stochastic):
    """Zero, NaN, ±inf, huge, tiny and -0.0 tiles: the scale 1 where amax >
    0 fails (a NaN amax too), a NaN element to 0, x / inf to 0."""
    rng = np.random.default_rng(bits + tile + n)
    x = _special_tiles(rng, 3, n, tile)
    jc = J.QuantizeCodec(bits=bits, tile=tile, stochastic=stochastic)
    tc = T.QuantizeCodec(bits=bits, tile=tile, stochastic=stochastic)
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(5), i) for i in range(3)]
    tq, ts = _same_as_jit(tc, jc, x, [_tkey(k) for k in jkeys], jkeys)
    assert bool(torch.isinf(ts).any()) and bool((ts == 1.0).any())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_shared_key_matches_jit(bits):
    """One key for 4 rows (DynamiQ's hop keys): each row is ``jax.jit``'s
    compression of that row under the key."""
    rng = np.random.default_rng(40 + bits)
    x = _x(rng, 4, 3000)
    jc, tc = J.QuantizeCodec(bits=bits), T.QuantizeCodec(bits=bits)
    jkey = jax.random.fold_in(jax.random.PRNGKey(2602), 7)
    _same_as_jit(tc, jc, x, _tkey(jkey), [jkey] * 4)


def test_codec_scale_is_the_jitted_multiply_not_the_division():
    """int4's 1/7 and int8's 1/127: the port's scale is ``amax *
    f32(1/qmax)`` (jit's), which differs from eager JAX's ``amax / qmax``
    on many tiles; the test above would miss a division only by chance."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((1, 256 * 400))
         * rng.uniform(0.01, 100, (1, 256 * 400))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    for bits in (4, 8):
        jc, tc = J.QuantizeCodec(bits=bits), T.QuantizeCodec(bits=bits)
        _, ts = tc.compress(torch.tensor(x), _tkey(key))
        _, eager = jc.compress(jnp.asarray(x[0]), key)
        _, jitted = jax.jit(jc.compress)(jnp.asarray(x[0]), key)
        assert ts[0].numpy().tobytes() == np.asarray(jitted).tobytes()
        assert (ts[0].numpy() != np.asarray(eager)).mean() > 0.01, bits


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
    jsend = jax.jit(jl.send)     # as strategy.step runs it, compiled
    for step in range(4):
        x = rng.standard_normal((k, n)).astype(np.float32)
        t_hat, tstate = tl.send(torch.tensor(x), tstate,
                                tl.node_keys(step, k))
        for i in range(k):
            j_hat, jstate[i] = jsend(jnp.asarray(x[i]), jstate[i],
                                     jl.key(step, 0, i))
            assert t_hat[i].numpy().tobytes() == \
                np.asarray(j_hat).tobytes()
            if codec is not None:
                assert tstate["ef_residual"][i].numpy().tobytes() == \
                    np.asarray(jstate[i]["ef_residual"]).tobytes()
    assert tl.wire_bytes(n) == jl.wire_bytes(n)
    assert tl.config() == jl.config()


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_link_residual_of_special_tiles_matches_jit(codec):
    """The residual ``send − q·scale``, which the jitted link rounds once
    (a fused multiply-add), over zero, NaN, ±inf, huge, tiny and -0.0
    tiles, two rounds with the residual carried. The tiny tiles are 1e-20
    times normal values: XLA's CPU flushes subnormal results to zero and
    the port keeps them (so does the card), and a residual of 1e-30-scaled
    values carried into a -0.0 tile reaches subnormals; the test below
    holds that case to this one difference (PERF.md §7)."""
    rng = np.random.default_rng(17)
    n, k = 2000, 3
    jl = J.CompressedLink(codec, seed=4)
    tl = T.CompressedLink(codec, seed=4)
    jsend = jax.jit(jl.send)
    jstate = [jl.init(n) for _ in range(k)]
    tstate = tl.init(n, k, "cpu")
    for step in range(2):
        x = _special_tiles(rng, k, n, 256, tiny=1e-20)
        t_hat, tstate = tl.send(torch.tensor(x), tstate,
                                tl.node_keys(step, k))
        for i in range(k):
            j_hat, jstate[i] = jsend(jnp.asarray(x[i]), jstate[i],
                                     jl.key(step, 0, i))
            assert t_hat[i].numpy().tobytes() == np.asarray(j_hat).tobytes()
            assert tstate["ef_residual"][i].numpy().tobytes() == \
                np.asarray(jstate[i]["ef_residual"]).tobytes(), (step, i)


@pytest.mark.parametrize("bits,stochastic", [(8, True), (4, True),
                                           (8, False)])
def test_codec_error_is_the_jitted_fused_residual(bits, stochastic):
    """``QuantizeCodec.error`` against XLA's compiled ``send − q·scale``
    (one fused multiply-add), over tiles whose magnitudes span 1e-20 to
    1e30 and values spread over 8 binades inside a tile, where a separate
    multiply and subtract differ on many elements. (From 1e-30 on some
    results are subnormal, which XLA's CPU flushes to zero and the port
    keeps: PERF.md §7; ``test_codec_error_differs_from_jit_only_by_flush``
    holds that range to this one difference.)"""
    rng = np.random.default_rng(bits + stochastic)
    rows, n, tile = 4, 256 * 300 - 17, 256
    mag = 10.0 ** rng.uniform(-20, 30, (rows, 300, 1))
    x = (rng.standard_normal((rows, 300, tile))
         * 2.0 ** rng.integers(-8, 1, (rows, 300, tile)) * mag)
    x = x.reshape(rows, -1)[:, :n].astype(np.float32)
    tc = T.QuantizeCodec(bits=bits, stochastic=stochastic)
    send = torch.tensor(x)
    keys = [tf.fold_in(tf.PRNGKey(8), i) for i in range(rows)]
    q, scale = tc.compress(send, keys)
    x_hat = tc.decompress((q, scale), n)

    def fused(s, q, sc):
        return s - (q.astype(jnp.float32) * sc).reshape(rows, -1)[:, :n]

    ref = np.asarray(jax.jit(fused)(jnp.asarray(x), jnp.asarray(q.numpy()),
                                    jnp.asarray(scale.numpy())))
    got = tc.error(send, (q, scale), x_hat).numpy()
    assert got.tobytes() == ref.tobytes()
    assert ((send - x_hat).numpy() != ref).mean() > 0.01


def _equal_but_flushed(got, ref):
    """``got`` equals ``ref`` bit for bit except where XLA's CPU flushed a
    subnormal result to zero: there ``ref`` is a zero and ``got`` a
    subnormal of the same sign. Returns the number of such elements."""
    differ = got.view(np.uint32) != ref.view(np.uint32)
    flushed = ((ref == 0) & (got != 0)
               & (np.abs(got) < np.finfo(np.float32).tiny)
               & (np.signbit(got) == np.signbit(ref)))
    assert not (differ & ~flushed).any(), np.flatnonzero(differ & ~flushed)
    return int(differ.sum())


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_link_residual_of_tiny_tiles_differs_only_by_flush(codec):
    """The special tiles with the tiny ones at 1e-30 (subnormal residuals
    carried into the -0.0 tiles), two rounds: the delivered payloads and
    the residuals are ``jax.jit``'s bit for bit but where XLA's CPU
    flushed a subnormal result to zero and the port kept it."""
    rng = np.random.default_rng(17)
    n, k = 2000, 3
    jl = J.CompressedLink(codec, seed=4)
    tl = T.CompressedLink(codec, seed=4)
    jsend = jax.jit(jl.send)
    jstate = [jl.init(n) for _ in range(k)]
    tstate = tl.init(n, k, "cpu")
    for step in range(2):
        x = _special_tiles(rng, k, n, 256, tiny=1e-30)
        t_hat, tstate = tl.send(torch.tensor(x), tstate,
                                tl.node_keys(step, k))
        for i in range(k):
            j_hat, jstate[i] = jsend(jnp.asarray(x[i]), jstate[i],
                                     jl.key(step, 0, i))
            assert t_hat[i].numpy().tobytes() == np.asarray(j_hat).tobytes()
            _equal_but_flushed(tstate["ef_residual"][i].numpy(),
                               np.asarray(jstate[i]["ef_residual"]))


@pytest.mark.parametrize("bits,stochastic", [(8, True), (4, True),
                                           (8, False)])
def test_codec_error_differs_from_jit_only_by_flush(bits, stochastic):
    """``QuantizeCodec.error`` against XLA's compiled residual over tiles
    whose magnitudes span 1e-30 to 1e30: bit for bit but where XLA's CPU
    flushed a subnormal result to zero and the port kept it."""
    rng = np.random.default_rng(bits + stochastic)
    rows, n, tile = 4, 256 * 300 - 17, 256
    mag = 10.0 ** rng.uniform(-30, 30, (rows, 300, 1))
    x = (rng.standard_normal((rows, 300, tile))
         * 2.0 ** rng.integers(-8, 1, (rows, 300, tile)) * mag)
    x = x.reshape(rows, -1)[:, :n].astype(np.float32)
    tc = T.QuantizeCodec(bits=bits, stochastic=stochastic)
    send = torch.tensor(x)
    keys = [tf.fold_in(tf.PRNGKey(8), i) for i in range(rows)]
    q, scale = tc.compress(send, keys)
    x_hat = tc.decompress((q, scale), n)

    def fused(s, q, sc):
        return s - (q.astype(jnp.float32) * sc).reshape(rows, -1)[:, :n]

    ref = np.asarray(jax.jit(fused)(jnp.asarray(x), jnp.asarray(q.numpy()),
                                    jnp.asarray(scale.numpy())))
    _equal_but_flushed(tc.error(send, (q, scale), x_hat).numpy(), ref)


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
