"""Port parity: ``gym_tpu_torch.ops.dct`` and ``ops.topk_compress`` (with D1's
plain twin, ``ops.scatter_mean``) against ``gym_tpu.ops`` on the same numpy
inputs made from a seed.

Tolerances: the DCT bases byte-equal and the tilings equal; encode, decode,
``mean_weights`` and the sparse decode rtol 1e-6 with an atol of 1e-6 of
the largest |value| (f32 sums of up to 64 products, run in another order:
an element near zero carries the rounding of its large terms);
``topk_compress``'s indices and values bit for bit,
on both paths, in JAX's order; the scatter-mean twin bit for bit (it adds
in XLA's serial order), an exact v/−v cancellation giving 0.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.ops import dct as jdct
from gym_tpu.ops import topk_compress as jtk
from gym_tpu_torch.ops import dct as tdct
from gym_tpu_torch.ops import scatter_mean as tsm
from gym_tpu_torch.ops import topk_compress as ttk


def close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("n", [1, 2, 3, 8, 33, 64, 100, 128])
def test_dct_matrix_byte_equal(n):
    a, b = tdct.dct_matrix(n), jdct.dct_matrix(n)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


SHAPES = [(), (5,), (64,), (66, 128), (256, 128), (128, 384), (3, 3, 8, 16),
          (7, 13), (1, 4096)]


def test_chunk_shapes_and_tilings_match():
    for chunk in (8, 32, 64):
        for shape in SHAPES:
            assert tdct.chunk_shape_for(shape, chunk) == \
                jdct.chunk_shape_for(shape, chunk), (shape, chunk)
            t, j = tdct.codec_for(shape, chunk), jdct.codec_for(shape, chunk)
            assert (t.a, t.b, t.n_chunks, t.chunk_elems) == \
                (j.a, j.b, j.n_chunks, j.chunk_elems)
    assert tdct.largest_divisor_at_most(66, 64) == 33


@pytest.mark.parametrize("shape", [(5,), (66, 128), (3, 3, 8, 16), (7, 13)])
def test_to_chunks_from_chunks_round_trip(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4,) + shape).astype(np.float32)
    c = tdct.codec_for(shape, 8)
    chunks = c.to_chunks(torch.tensor(x))
    assert chunks.shape == (4, c.n_chunks, c.a, c.b)
    assert torch.equal(c.from_chunks(chunks), torch.tensor(x))
    # node 0's tiles are the JAX package's tiles
    jc = jdct.codec_for(shape, 8)
    np.testing.assert_array_equal(chunks[0].numpy(),
                                  np.asarray(jc.to_chunks(jnp.asarray(x[0]))))


@pytest.mark.parametrize("shape", [(66, 128), (64,), (3, 3, 8, 16)])
def test_encode_decode_match_jax(shape):
    """The per-tensor DCT of the JAX package and the pooled one both
    ports: the tiles' coefficients and their inverse."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    t, j = tdct.codec_for(shape, 64), jdct.codec_for(shape, 64)
    tiles = t.to_chunks(torch.tensor(x))
    d_a, d_b = tdct.basis(t.a, "cpu"), tdct.basis(t.b, "cpu")
    enc = tdct.encode_chunks(tiles, d_a, d_b)
    close(enc.numpy(), j.encode(jnp.asarray(x)))
    jenc = jdct.encode_chunks(j.to_chunks(jnp.asarray(x)), j.d_a, j.d_b)
    close(enc.numpy(), jenc)
    dec = tdct.decode_chunks(enc, d_a, d_b)
    close(dec.numpy(), jdct.decode_chunks(jenc, j.d_a, j.d_b))
    np.testing.assert_allclose(t.from_chunks(dec).numpy(), x, rtol=1e-5,
                               atol=1e-5)


def _coeffs(rng, g, n):
    """[g, n] f32 with planted edge cases: ±Inf, NaN, near-ties that agree
    above the packed key's low bits, exact ties and negative zero."""
    c = rng.standard_normal((g, n)).astype(np.float32)
    c[0, 3], c[0, 7], c[1, 5] = np.inf, -np.inf, np.nan
    c[2, 1] = c[2, 2] * (1 + 2.0 ** -20)            # near tie
    c[2, 4] = -c[2, 2]                              # exact |tie|
    c[3, :8] = 5.0                                  # a run of exact ties
    c[3, 9] = -0.0
    return c


@pytest.mark.parametrize("g,n,k", [(6, 4096, 32), (6, 64, 32), (6, 64, 64),
                                   (5, 12, 20), (4, 2112, 32)])
def test_topk_packed_path_bit_for_bit(g, n, k):
    c = _coeffs(np.random.default_rng(2), g, n)
    ji, jv = jtk.topk_compress(jnp.asarray(c), k)
    ti, tv = ttk.topk_compress(torch.tensor(c), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()


def test_topk_paired_path_lower_index_wins_ties():
    """Chunks of more than 2¹⁶ elements (``TopKCodec`` over a flat model)
    take ``lax.top_k(|c|)``: among equal magnitudes the lower index is
    picked and listed first."""
    rng = np.random.default_rng(3)
    n = 70_000
    c = rng.standard_normal((2, n)).astype(np.float32)
    c[0, [5, 900, 40_000, 69_999]] = [7.0, -7.0, 7.0, 7.0]
    c[1, [11, 12]] = [-3.5, 3.5]
    c[1, 60_000] = 9.0
    for k in (1, 2, 3, 700):
        _, ji = jax.lax.top_k(jnp.abs(jnp.asarray(c)), k)
        ti, tv = ttk.topk_compress(torch.tensor(c), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        jtv = np.take_along_axis(c, np.asarray(ji), axis=-1)
        assert tv.numpy().tobytes() == jtv.tobytes()
        jpi, _ = jtk.topk_compress(jnp.asarray(c), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(jpi))
    assert ttk.topk_compress(torch.tensor(c), 3)[0][0].tolist() == [5, 900,
                                                                     40_000]


def test_topk_paired_path_non_f32():
    rng = np.random.default_rng(4)
    c = rng.standard_normal((3, 256)).astype(np.float32)
    c[0, 1] = c[0, 2] = 4.0
    cb = jnp.asarray(c, jnp.bfloat16)
    ji, jv = jtk.topk_compress(cb, 16)
    ti, tv = ttk.topk_compress(torch.tensor(c).to(torch.bfloat16), 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))


def _picks(rng, g, m, e, dup_slots=8):
    """[g, m] picks into e slots, many duplicates."""
    idx = rng.integers(0, min(e, dup_slots * 4), (g, m)).astype(np.int32)
    val = rng.standard_normal((g, m)).astype(np.float32)
    return idx, val


@pytest.mark.parametrize("g,m,e", [(5, 16, 64), (3, 64, 12), (2, 128, 4096)])
def test_mean_weights_and_sparse_decode_match_jax(g, m, e):
    rng = np.random.default_rng(5)
    idx, val = _picks(rng, g, m, e)
    jw = jtk.mean_weights(jnp.asarray(idx), jnp.asarray(val))
    tw = ttk.mean_weights(torch.tensor(idx), torch.tensor(val))
    close(tw.numpy(), jw)
    a = b = int(np.sqrt(e)) if int(np.sqrt(e)) ** 2 == e else 1
    if a * b != e:
        a, b = 1, e
    da, db = jdct.dct_matrix(a), jdct.dct_matrix(b)
    jdec = jdct.sparse_decode_chunks(jnp.asarray(idx), jw, da, db)
    tdec = tdct.sparse_decode_chunks(torch.tensor(idx), tw,
                                     torch.tensor(da), torch.tensor(db))
    close(tdec.numpy(), jdec)


def test_mean_weights_keep_an_exact_cancellation_zero():
    idx = torch.tensor([[3, 3, 5, 7]], dtype=torch.int32)
    val = torch.tensor([[0.3, -0.3, 1.0, 2.0]])
    w = ttk.mean_weights(idx, val)
    assert w[0, 0].item() == 0.0 and w[0, 1].item() == 0.0


@pytest.mark.parametrize("g,m,e", [(200, 2048, 4096), (108, 2048, 64),
                                   (4, 2048, 2112), (7, 64, 4096),
                                   (3, 5, 1)])
def test_scatter_mean_twin_matches_jax_bit_for_bit(g, m, e):
    """The twin against the JAX package's scatter-add at config 5's three
    shapes, the K = 2 sparse-route size and a one-slot row; duplicates
    everywhere, a planted v/−v cancellation and untouched slots."""
    rng = np.random.default_rng(6)
    idx = rng.integers(0, e, (g, m)).astype(np.int32)
    val = rng.standard_normal((g, m)).astype(np.float32)
    # a slot that receives v and −v only: its mean is exactly 0.0
    if e > 1:
        idx[0] = np.where(idx[0] == 0, 1, idx[0])
        idx[0, [0, m - 1]] = 0
        val[0, m - 1] = -val[0, 0]
    out = tsm.plain_scatter_mean_decode(torch.tensor(idx), torch.tensor(val),
                                        e)
    ref = np.asarray(jtk.scatter_mean_decode(jnp.asarray(idx),
                                             jnp.asarray(val), e))
    assert out.shape == (g, e)
    assert out.numpy().tobytes() == ref.tobytes()
    if e > 1:
        assert out[0, 0].item() == 0.0
    # the dispatching wrapper runs the twin for a CPU tensor, no launch
    before = tsm.scatter_mean_decode.launches
    same = ttk.scatter_mean_decode(torch.tensor(idx), torch.tensor(val), e)
    assert torch.equal(same, out)
    assert tsm.scatter_mean_decode.launches == before


def test_scatter_mean_untouched_slots_are_zero_and_order_matters():
    """Untouched slots decode to +0.0; three values in one slot are summed
    in pick order (a reversed order gives another f32 sum)."""
    idx = torch.tensor([[2, 2, 2, 0]], dtype=torch.int32)
    val = torch.tensor([[1.0, 1e8, -1e8, 4.0]])
    out = tsm.plain_scatter_mean_decode(idx, val, 4)
    assert out[0].tolist() == [4.0, 0.0, 0.0, 0.0]   # (1 + 1e8) − 1e8 = 0
    rev = tsm.plain_scatter_mean_decode(idx.flip(1), val.flip(1), 4)
    assert rev[0, 2].item() == np.float32(1.0) / 3   # (−1e8 + 1e8) + 1
    assert torch.signbit(out[0, 1]).item() is False


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_scatter_mean_wrapper_refuses_bad_inputs(bad):
    idx = torch.zeros(2, 4, dtype=torch.int32)
    val = torch.zeros(2, 4)
    if bad == "dtype":
        idx = idx.long()
    elif bad == "shape":
        val = torch.zeros(2, 5)
    else:
        idx = idx.to("meta")
    with pytest.raises(ValueError):
        tsm.scatter_mean_decode(idx, val, 8)
