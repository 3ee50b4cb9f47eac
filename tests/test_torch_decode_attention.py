"""The serving path's kernel twins on the CPU: B7's (decode attention) and
R1's (the row-invariant linear layer) against the JAX package's decode
attends and ``x @ W``, and their row invariance bit for bit, with L1's (the
row layer norm) and the row-invariant scan of the sampler.

The JAX reference is the einsum-mask-softmax-einsum of
``gym_tpu/models/nanogpt.py``'s ``_decode_attend`` (unpaged) and
``_decode_attend_paged`` (through the block table), over each row's whole
window, on the same numpy inputs. Tolerance, the f32 band: |a − b| <=
2e-5 + 1e-5·|b|. Bit for bit: a query alone against the same query in a
batch, a verify chunk or a prefill, at any page size; a row of R1 or L1
alone against the same row among 16, 80 and 1024.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu_torch.ops import decode_attention as tdec
from gym_tpu_torch.ops import row_linear as trow

H, HD, S = 2, 16, 64


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def _bits(a):
    return a.detach().contiguous().view(torch.int32)


def jax_attend(q, k_win, v_win, cursor):
    """``_decode_attend``'s math on gathered windows: q [b, t, H, hd],
    windows [b, S, H, hd], the chunk at ``cursor`` [b]."""
    b, t, _, hd = q.shape
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k_win) / math.sqrt(hd)
    wpos = cursor[:, None] + jnp.arange(t)[None, :]
    mask = jnp.arange(k_win.shape[1])[None, None, :] <= wpos[:, :, None]
    att = jnp.where(mask[:, None], att.astype(jnp.float32), -jnp.inf)
    att = jax.nn.softmax(att, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", att, v_win)


def _case(seed, b, t, page):
    """Random windows on shuffled pages of a pool, cursors that keep every
    query inside the window, and q."""
    rng = np.random.default_rng(seed)
    nblk = S // page
    k_win = rng.normal(size=(b, S, H, HD)).astype(np.float32)
    v_win = rng.normal(size=(b, S, H, HD)).astype(np.float32)
    pages = 1 + b * nblk
    table = (1 + rng.permutation(pages - 1)).reshape(b, nblk)
    k_pool = rng.normal(size=(pages, page, H, HD)).astype(np.float32)
    v_pool = rng.normal(size=(pages, page, H, HD)).astype(np.float32)
    k_pool[table] = k_win.reshape(b, nblk, page, H, HD)
    v_pool[table] = v_win.reshape(b, nblk, page, H, HD)
    cursor = rng.integers(0, S - t + 1, b)
    cursor[0] = 0
    q = rng.normal(size=(b, t, H, HD)).astype(np.float32)
    return q, k_win, v_win, k_pool, v_pool, table.astype(np.int32), \
        cursor.astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("t", [1, 5, 32])
def test_b7_twin_matches_jax_attend_paged_and_unpaged(page, t):
    q, kw, vw, kp, vp, table, cur = _case(page * 100 + t, 3, t, page)
    ref = jax_attend(q, kw, vw, cur)
    paged = tdec.decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(cur))
    _close(paged, ref)
    unpaged = tdec.decode_attention(_t(q), _t(kw), _t(vw),
                                    tdec.unpaged_table(3, "cpu"), _t(cur))
    _close(unpaged, ref)
    assert torch.equal(_bits(paged), _bits(unpaged))


def test_b7_twin_query_alone_equals_query_in_chunk_batch_and_pages():
    """A query's bits depend only on its q, its position and its K/V: the
    same query alone, in a 5-token verify chunk, among 3 rows, and through
    pages of 4 or 16."""
    q, kw, vw, kp, vp, table, cur = _case(7, 3, 5, 4)
    _, _, _, kp16, vp16, table16, _ = _case(7, 3, 5, 16)
    kp16[table16] = kw.reshape(3, S // 16, 16, H, HD)
    vp16[table16] = vw.reshape(3, S // 16, 16, H, HD)
    full = tdec.decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(cur))
    pages16 = tdec.decode_attention(_t(q), _t(kp16), _t(vp16), _t(table16),
                                    _t(cur))
    assert torch.equal(_bits(full), _bits(pages16))
    for r in range(3):
        for j in range(5):
            one = tdec.decode_attention(
                _t(q[r:r + 1, j:j + 1]), _t(kp), _t(vp), _t(table[r:r + 1]),
                _t(cur[r:r + 1] + j))
            assert torch.equal(_bits(one[0, 0]), _bits(full[r, j]))


def test_b7_twin_clamps_past_the_window():
    """Queries past the window attend to positions 0..S-1, as the JAX
    attend's mask does (the model poisons those positions after)."""
    q, kw, vw, kp, vp, table, _ = _case(3, 2, 5, 8)
    cur = np.array([S - 2, S - 5], np.int32)
    got = tdec.decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(cur))
    _close(got, jax_attend(q, kw, vw, cur))


def test_b7_wrapper_refuses_bad_inputs():
    q, _, _, kp, vp, table, cur = _case(1, 2, 1, 8)
    with pytest.raises(ValueError, match="int32"):
        tdec.decode_attention(_t(q), _t(kp), _t(vp), _t(table).long(),
                              _t(cur))
    with pytest.raises(ValueError, match="float32"):
        tdec.decode_attention(_t(q).double(), _t(kp), _t(vp), _t(table),
                              _t(cur))
    with pytest.raises(ValueError, match="heads"):
        tdec.decode_attention(_t(q)[:, :, :1], _t(kp), _t(vp), _t(table),
                              _t(cur))


@pytest.mark.parametrize("w_nk", [False, True])
@pytest.mark.parametrize("k,n", [(32, 96), (128, 32), (32, 65)])
def test_r1_twin_matches_x_at_w(w_nk, k, n):
    rng = np.random.default_rng(k + n)
    x = rng.normal(size=(2, 9, k)).astype(np.float32)
    w = (rng.normal(size=(n, k) if w_nk else (k, n)) * 0.1).astype(
        np.float32)
    b = None if w_nk else rng.normal(size=n).astype(np.float32)
    ref = np.asarray(jnp.asarray(x) @ (jnp.asarray(w).T if w_nk
                                       else jnp.asarray(w)))
    if b is not None:
        ref = ref + b
    got = trow.row_linear(_t(x), _t(w), None if b is None else _t(b), w_nk)
    assert got.shape == (2, 9, n)
    _close(got, ref)


@pytest.mark.parametrize("w_nk", [False, True])
def test_r1_and_l1_twins_rows_bit_for_bit(w_nk):
    """A row alone against the same row among 16, 80 and 1024."""
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(1024, 64)).astype(np.float32))
    w = _t((rng.normal(size=(48, 64) if w_nk else (64, 48)) * 0.1).astype(
        np.float32))
    b = None if w_nk else _t(rng.normal(size=48).astype(np.float32))
    sc = _t(rng.normal(size=64).astype(np.float32))
    bi = _t(rng.normal(size=64).astype(np.float32))
    for fn in (lambda z: trow.row_linear(z, w, b, w_nk),
               lambda z: trow.row_layer_norm(z, sc, bi)):
        full = {m: fn(x[:m]) for m in (16, 80, 1024)}
        for r in (0, 5, 15):
            one = fn(x[r:r + 1])[0]
            for y in full.values():
                assert torch.equal(_bits(one), _bits(y[r]))


def test_l1_twin_matches_flax_layer_norm():
    import flax.linen as nn
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(5, 32)) * 3 + 1).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-5)
    p = ln.init(jax.random.PRNGKey(0), x)
    p = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), p)
    ref = ln.apply(p, x)
    got = trow.row_layer_norm(_t(x), _t(np.asarray(p["params"]["scale"])),
                              _t(np.asarray(p["params"]["bias"])))
    _close(got, ref)


def test_row_cumsum_matches_cumsum_and_is_row_invariant():
    rng = np.random.default_rng(3)
    x = _t(rng.random((80, 1000)).astype(np.float32))
    got = trow.row_cumsum(x)
    np.testing.assert_allclose(got.numpy(), np.cumsum(
        x.double().numpy(), axis=-1), rtol=1e-5)
    for r in (0, 7, 79):
        assert torch.equal(_bits(trow.row_cumsum(x[r:r + 1])[0]),
                           _bits(got[r]))
    short = _t(rng.random((3, 5)).astype(np.float32))
    np.testing.assert_allclose(trow.row_cumsum(short).numpy(),
                               np.cumsum(short.numpy(), axis=-1), rtol=1e-6)


@pytest.mark.parametrize("m,c,bias", [(1, 768, True), (16, 768, True),
                                      (5, 100, True), (3, 64, False)])
def test_add_layer_norm_matches_jax_add_then_flax_layer_norm(m, c, bias):
    """L1 with the residual add: s bit for bit the add (torch's and
    JAX's), y within the f32 band of flax's layer norm of JAX's sum; and
    ``want_sum=False`` gives the same y and no s."""
    import flax.linen as nn
    rng = np.random.default_rng(m * 1000 + c)
    x = (rng.normal(size=(m, c)) * 3 + 1).astype(np.float32)
    d = rng.normal(size=(m, c)).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-5, use_bias=bias)
    p = ln.init(jax.random.PRNGKey(0), x)
    p = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), p)
    jsum = jnp.asarray(x) + jnp.asarray(d)
    ref = ln.apply(p, jsum)
    b = _t(np.asarray(p["params"]["bias"])) if bias else None
    sc = _t(np.asarray(p["params"]["scale"]))
    s, y = trow.row_add_layer_norm(_t(x), _t(d), sc, b)
    assert torch.equal(_bits(s), _bits(_t(x) + _t(d)))
    assert torch.equal(_bits(s), _bits(_t(np.asarray(jsum))))
    _close(y, ref)
    none, y2 = trow.row_add_layer_norm(_t(x), _t(d), sc, b, want_sum=False)
    assert none is None and torch.equal(_bits(y2), _bits(y))
    assert torch.equal(_bits(y), _bits(trow.row_layer_norm(s, sc, b)))


def test_add_layer_norm_refuses_bad_inputs():
    x = torch.randn(2, 8)
    with pytest.raises(ValueError, match="differ"):
        trow.row_add_layer_norm(x, torch.randn(2, 9), torch.ones(8))
    with pytest.raises(ValueError, match="float32"):
        trow.row_add_layer_norm(x, x.double(), torch.ones(8))
    with pytest.raises(ValueError, match=r"\[8\]"):
        trow.row_add_layer_norm(x, x, torch.ones(7))
