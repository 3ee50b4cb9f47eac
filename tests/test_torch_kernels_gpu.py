"""The CUDA kernels of ``gym_tpu_torch.ops.fused_attention``,
``gym_tpu_torch.ops.flash_attention``, ``gym_tpu_torch.ops.threefry`` and
``gym_tpu_torch.ops.scatter_mean`` against their plain versions on the
card. Marked ``gpu``: they skip without a card. This
file imports neither JAX nor ``gym_tpu``, so it runs on the machine with the
card, where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

One case for each head dim (16, 32, 64, 128), dtype (bf16 runs the bf16
wgmma kernels, f32 the split-precision TF32 wgmma kernels) and layout: the
packed pair (B1/B2) on
strided column slices of a ``[N, T, 3C]`` projection, the per-head pair
(B3/B4) on per-head views of one, causal and full-block with a random lse
cotangent, at T=128 and T=384; and the long-context pair (B5) at T=1152
and T=2048 (where the plain version runs the tuned 1024/2048 blocks and the
bf16 forward its 128-row query blocks against 64-key tiles).

Tolerance, elementwise on o, dq, dk and dv, as ``chip_smoke.py`` states it:
|kernel − plain| <= atol + rms_frac·rms(plain) + rtol·|plain|, bf16 atol 0,
rms_frac 5e-2, rtol 2e-2; f32 atol 5e-5, rtol 1e-4; lse within 1e-4. The
backward kernels have no atomics, so two runs on the same inputs agree bit
for bit in both dtypes, and so do two runs of the f32 forward and of the
bf16 long-context forward. The bf16 kernels copy rows with 16-byte
``cp.async`` or TMA and refuse views that are not 16-byte aligned; the f32
kernels take them, through 4-byte copies. The long-context pair refuses
T % 128 != 0 on the card as on the CPU. The threefry kernels (random bits
and the fused Bernoulli mask) equal their plain twin bit for bit, at
lengths that end inside and on a 4-element group; so does the per-row mask
(one launch for a table of keys, as dropout draws it), at row lengths that
leave a row's start aligned and not. D1, DeMo's scatter-mean decode, equals
its twin bit for bit (both add a slot's picks in pick order) at DeMo's
shapes, gives the same bits on two runs, and keeps a v/−v slot at exactly
0.0 and an untouched slot at +0.0.

The serving path's kernels: B7 (decode attention) against its twin in the
f32 band at page sizes 4/8/16 and 1, 5 and 64 queries a row, paged against
unpaged bit for bit, a query alone against the same query in its batch and
chunk bit for bit; R1 (the row-invariant linear layer) against its twin and
``torch.matmul`` in the f32 band, in both weight layouts, its rows bit for
bit at M = 1, 16, 80 and 1024; L1 (the row layer norm) likewise; T1's bits
rows bit for bit against the twin.

The checkpoint layer on the card: a save and restore of CUDA tensors (f32,
bf16, int64, a host uint32 key table) is bit-equal with device and dtype
kept, through the synchronous and the async writer (whose copy waits on the
snapshot's event while the live tensors change), and the C ``crc32c`` the
library builds equals the Python one; a small fit resumed at 3 ends
byte-identical to a straight run; the prefetcher's batches on the card
equal the synchronous path's.
"""

import pytest
import torch

import gym_tpu_torch.ops.decode_attention as tdec
import gym_tpu_torch.ops.flash_attention as tflash
import gym_tpu_torch.ops.fused_attention as tfa
import gym_tpu_torch.ops.row_linear as trow
import gym_tpu_torch.ops.scatter_mean as tsm
import gym_tpu_torch.ops.threefry as tf

HEAD_DIMS = (16, 32, 64, 128)
# (atol, rms_frac, rtol) of each dtype, as in chip_smoke.py's TOL
DTYPES = {"bf16": (torch.bfloat16, (0.0, 5e-2, 2e-2)),
          "f32": (torch.float32, (5e-5, 0.0, 1e-4))}
LAYOUTS = (
    [("packed", t) for t in (128, 384)]
    + [(f"heads_{m}", t) for m in ("causal", "full_dlse") for t in (128, 384)]
    + [("long", 1152), ("long", 2048)])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m gpu)")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(g, layout, t, d, dt, skew=0):
    """(q, k, v), do, dlse and the head count, as the model passes them:
    views of one projection, packed [N, T, C] slices or per-head
    [N, H, T, D] views; ``skew`` starts the projection that many elements
    in (0 on the main path)."""
    n, h = (3, 4) if layout == "packed" else (2, 3)
    qkv = torch.randn(n, t, 3 * h * d + skew, device="cuda",
                      generator=g).to(dt)[..., skew:]
    q, k, v = qkv.split(h * d, dim=-1)
    if layout == "packed":
        do = torch.randn(n, t, h * d, device="cuda", generator=g).to(dt)
        return (q, k, v), do, None, h
    q, k, v = (z.view(n, t, h, d).transpose(1, 2) for z in (q, k, v))
    do = torch.randn(n, h, t, d, device="cuda", generator=g).to(dt)
    dlse = (torch.randn(n, h, t, 1, device="cuda", generator=g)
            if layout == "heads_full_dlse" else None)
    return (q, k, v), do, dlse, h


def _fwd(layout, qkv, h, plain):
    """(o, lse) of the kernel, or of its plain version."""
    if layout == "packed":
        fwd = tfa.plain_fwd_packed if plain else tfa._fwd_packed
        return fwd(*qkv, (qkv[0].shape[-1] // h) ** -0.5, h)
    scale = qkv[0].shape[-1] ** -0.5
    if layout == "long":
        fwd = tflash.plain_flash_fwd if plain else tflash._flash_fwd
        return fwd(*qkv, scale)
    fwd = tfa.plain_fwd if plain else tfa._blk_fwd
    return fwd(*qkv, scale, layout != "heads_full_dlse")


def _close(got, ref, tol, what):
    """Elementwise |got − ref| <= atol + rms_frac·rms(ref) + rtol·|ref|."""
    atol, frac, rtol = tol
    a, b = got.float(), ref.float()
    limit = atol + frac * b.square().mean().sqrt() + rtol * b.abs()
    over = ((a - b).abs() > limit).sum().item()
    assert over == 0 and a.isfinite().all(), (
        f"{what}: {over} elements outside, max abs err "
        f"{(a - b).abs().max().item():.3e}")


def _bwd(layout, qkv, o, do, lse, dlse, h, plain):
    """(dq, dk, dv) of the kernel, or of its plain version, given o and
    lse."""
    if layout == "packed":
        bwd = tfa.plain_bwd_packed if plain else tfa._bwd_packed
        return bwd(*qkv, o, do, lse, (qkv[0].shape[-1] // h) ** -0.5, h)
    scale = qkv[0].shape[-1] ** -0.5
    if layout == "long":
        bwd = tflash.plain_flash_bwd if plain else tflash._flash_bwd
        return bwd(*qkv, o, do, lse, scale)
    bwd = tfa.plain_bwd if plain else tfa._blk_bwd
    return bwd(*qkv, o, do, lse, dlse, scale, layout != "heads_full_dlse")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("layout,t", LAYOUTS)
def test_kernels_match_plain_on_card(layout, t, d, dtype):
    _match_plain(layout, t, d, dtype)


def _match_plain(layout, t, d, dtype, skew=0):
    """Each kernel against its plain version on the same inputs; both
    backwards are given the kernel's o and lse."""
    g = _card()
    dt, tol = DTYPES[dtype]
    qkv, do, dlse, h = _inputs(g, layout, t, d, dt, skew)
    o, lse = _fwd(layout, qkv, h, plain=False)
    ro, rl = _fwd(layout, qkv, h, plain=True)
    got = _bwd(layout, qkv, o, do, lse, dlse, h, plain=False)
    ref = _bwd(layout, qkv, o, do, lse, dlse, h, plain=True)
    torch.cuda.synchronize()
    _close(o, ro, tol, "o")
    assert (lse - rl).abs().max() <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _close(a, b, tol, name)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,t", [("packed", 384), ("heads_causal", 384),
                                      ("heads_full_dlse", 384),
                                      ("long", 1152)])
def test_bf16_backward_is_bit_reproducible(layout, t):
    """Two runs of the bf16 backward on the same inputs give identical dq,
    dk and dv: each output row has one owner block, no atomics."""
    g = _card()
    qkv, do, dlse, h = _inputs(g, layout, t, 64, torch.bfloat16)
    o, lse = _fwd(layout, qkv, h, plain=False)
    first = _bwd(layout, qkv, o, do, lse, dlse, h, plain=False)
    second = _bwd(layout, qkv, o, do, lse, dlse, h, plain=False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("layout,t", [("packed", 384), ("heads_causal", 384),
                                      ("heads_full_dlse", 384),
                                      ("long", 1152)])
def test_f32_forward_and_backward_are_bit_reproducible(layout, t):
    """Two runs of the f32 forward and backward on the same inputs give
    identical o, lse, dq, dk and dv: each output row has one owner block,
    summed in a fixed order, no atomics."""
    g = _card()
    qkv, do, dlse, h = _inputs(g, layout, t, 64, torch.float32)
    o, lse = _fwd(layout, qkv, h, plain=False)
    again = _fwd(layout, qkv, h, plain=False)
    first = _bwd(layout, qkv, o, do, lse, dlse, h, plain=False)
    second = _bwd(layout, qkv, o, do, lse, dlse, h, plain=False)
    for a, b in zip((o, lse, *first), (*again, *second)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1152, 2048])
def test_bf16_long_forward_is_bit_reproducible(t):
    """Two runs of the bf16 long-context forward give identical o and lse:
    each output row has one owner warpgroup, summed in a fixed order."""
    g = _card()
    qkv, _, _, h = _inputs(g, "long", t, 64, torch.bfloat16)
    first = _fwd("long", qkv, h, plain=False)
    second = _fwd("long", qkv, h, plain=False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_f32_long_on_unaligned_views_on_card(d):
    """The long-context pair in f32 on per-head views of a projection
    started one element in (not 16-byte aligned): the pre-pass and the
    forward take 4-byte copies, and match their plain versions at the f32
    tolerance, as do the backward kernels."""
    _match_plain("long", 1152, d, "f32", skew=1)


@pytest.mark.gpu
def test_long_pair_refuses_t_not_multiple_of_128_on_card():
    """T = 1088 (a multiple of 64, not of 128): both B5 wrappers raise on
    the card, as on the CPU, before any launch."""
    qkv, do, _, h = _inputs(_card(), "long", 1088, 64, torch.bfloat16)
    lse = torch.zeros(*do.shape[:-1], 1, device="cuda")
    with pytest.raises(ValueError, match="multiple of 128"):
        _fwd("long", qkv, h, plain=False)
    with pytest.raises(ValueError, match="multiple of 128"):
        _bwd("long", qkv, do, do, lse, None, h, plain=False)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_unaligned_views_on_card(d, dtype):
    """Per-head views of a projection started one element in: the bf16
    wrappers refuse them (their kernels copy 16-byte rows), the f32 kernels
    match their plain versions on them."""
    if dtype == "f32":
        _match_plain("heads_causal", 128, d, dtype, skew=1)
        return
    qkv, do, _, h = _inputs(_card(), "heads_causal", 128, d, torch.bfloat16,
                            skew=1)
    o, lse = _fwd("heads_causal", [x.contiguous() for x in qkv], h,
                  plain=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _fwd("heads_causal", qkv, h, plain=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _fwd("long", qkv, h, plain=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _bwd("heads_causal", qkv, o, do, lse, None, h, plain=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        _bwd("long", qkv, o, do, lse, None, h, plain=False)


@pytest.mark.gpu
def test_unsupported_head_dim_raises_on_card():
    """A head dim the kernels do not take raises on the card: no quiet
    fallback to dense attention or to the plain version."""
    g = _card()
    x = torch.randn(1, 1, 2048, 256, device="cuda", generator=g)
    with pytest.raises(ValueError):
        tflash.flash_causal_attention(x, x, x)


THREEFRY_N = (0, 1, 3, 4, 5, 4097, 786_432, (1 << 20) + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("n", THREEFRY_N)
def test_threefry_kernels_match_twin_bit_for_bit(n):
    _card()
    for leaf, step in ((0, 0), (146, 3), (37, 1000)):
        key = tf.fold_in(tf.fold_in(tf.fold_in(tf.PRNGKey(7), leaf), 0),
                         step)
        before = tf.bernoulli.launches
        assert torch.equal(tf.random_bits(key, n, "cuda"),
                           tf.plain_random_bits(key, n, "cuda"))
        for p in (0.005, 0.3, 0.5):
            got = tf.bernoulli(key, p, n, "cuda")
            assert got.dtype == torch.bool and got.is_cuda
            assert torch.equal(got, tf.plain_bernoulli(key, p, n, "cuda"))
        assert tf.bernoulli.launches == before + (3 if n else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 1000, 70_000])
def test_permutation_on_card_matches_twin(n):
    _card()
    key = tf.fold_in(tf.PRNGKey(7), 3)
    got = tf.permutation(key, n, "cuda").cpu()
    assert torch.equal(got, tf.permutation(key, n, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("p", [0.005, 0.5])
def test_bernoulli_segments_match_twin_bit_for_bit(p):
    """One launch for a table of segments (sizes 0, 1, 3, 5, 1023, 4097 and
    70,001: not multiples of 4, each start 16-byte aligned) equals the
    twin's mask of each segment's key alone."""
    _card()
    sizes = [0, 1, 3, 5, 1023, 4097, 70_001]
    keys = tf.fold_in_rows(tf.node_keys(7, len(sizes)), 9)
    before = tf.bernoulli_segments.launches
    buf, views = tf.bernoulli_segments(keys, p, sizes, "cuda")
    assert tf.bernoulli_segments.launches == before + 1
    for got, ref in zip(views, tf.plain_bernoulli_segments(keys, p, sizes,
                                                           "cuda")):
        assert (got.data_ptr() - buf.data_ptr()) % 16 == 0
        assert torch.equal(got, ref)


@pytest.mark.gpu
def test_sparta_masks_are_one_launch_on_card():
    """``RandomIndexSelector.masks`` draws every leaf's mask in one launch,
    and each equals the leaf's own draw (one launch a leaf)."""
    from gym_tpu_torch.convert import jax_leaf_order
    from gym_tpu_torch.strategy.sparta import RandomIndexSelector
    _card()
    shapes = {"wte": (65, 48), "h_0.attn.bias": (144,), "ln_f.scale": (48,),
              "h_0.mlp.w": (48, 192), "lm_head": (3,)}
    params = {n: torch.zeros(s, device="cuda") for n, s in shapes.items()}
    order = jax_leaf_order(params)
    sel = RandomIndexSelector(0.3)
    before = tf.bernoulli_segments.launches
    masks = sel.masks(params, 4)
    assert tf.bernoulli_segments.launches == before + 1
    for n, x in params.items():
        assert masks[n].shape == x.shape
        assert torch.equal(masks[n], sel.mask(x, order[n], 4))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(1, 1), (8, 64 * 64), (32, 4096),
                                    (32, 64 * 3 - 1), (16, 64 * 256),
                                    (3, 5)])
def test_bernoulli_rows_match_twin_bit_for_bit(rows, n):
    _card()
    table = tf.fold_in_rows(tf.node_keys(7, rows), 12)
    for p in (0.5, 0.75):
        before = tf.bernoulli_rows.launches
        got = tf.bernoulli_rows(table, p, n, "cuda")
        assert tf.bernoulli_rows.launches == before + 1
        assert got.shape == (rows, n) and got.dtype == torch.bool
        assert torch.equal(got, tf.plain_bernoulli_rows(table, p, n, "cuda"))
    assert tf.bernoulli_rows(table, 0.5, 0, "cuda").shape == (rows, 0)


def _picks(g, rows, m, e):
    idx = torch.randint(0, e, (rows, m), device="cuda", generator=g,
                        dtype=torch.int32)
    val = torch.randn(rows, m, device="cuda", generator=g)
    return idx, val


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m,e", [(200, 2048, 4096), (108, 2048, 64),
                                      (4, 2048, 2112), (50, 64, 4096),
                                      (3, 5000, 9000), (1, 1, 1)])
def test_scatter_mean_matches_twin_bit_for_bit(rows, m, e):
    """DeMo's signatures at 64 nodes (and K = 2's 64 picks); a row of more
    picks than one staged chunk and more slots than one tile; one slot."""
    g = _card()
    idx, val = _picks(g, rows, m, e)
    before = tsm.scatter_mean_decode.launches
    got = tsm.scatter_mean_decode(idx, val, e)
    assert tsm.scatter_mean_decode.launches == before + 1
    ref = tsm.plain_scatter_mean_decode(idx, val, e)
    assert torch.equal(_bits(got), _bits(ref))


@pytest.mark.gpu
def test_scatter_mean_is_bit_reproducible():
    g = _card()
    idx, val = _picks(g, 200, 2048, 64)
    a = tsm.scatter_mean_decode(idx, val, 64)
    b = tsm.scatter_mean_decode(idx, val, 64)
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_scatter_mean_cancellation_and_untouched_slots():
    """v and −v at one slot (with picks between them) decode to exactly
    0.0; a slot no pick names to +0.0; three picks in one slot in pick
    order ((1 + 1e8) − 1e8 = 0, not 1/3)."""
    _card()
    idx = torch.tensor([[5, 2, 7, 5, 9, 9, 9]], dtype=torch.int32,
                       device="cuda")
    val = torch.tensor([[0.37, 1.0, 2.0, -0.37, 1.0, 1e8, -1e8]],
                       device="cuda")
    out = tsm.scatter_mean_decode(idx, val, 12)[0].cpu()
    assert out[5].item() == 0.0 and out[9].item() == 0.0
    assert out[2].item() == 1.0 and out[7].item() == 2.0
    untouched = [0, 1, 3, 4, 6, 8, 10, 11]
    assert all(_bits(out[s:s + 1]).item() == 0 for s in untouched)


@pytest.mark.gpu
def test_scatter_mean_refuses_non_contiguous_on_card():
    g = _card()
    idx, val = _picks(g, 4, 64, 64)
    with pytest.raises(ValueError):
        tsm.scatter_mean_decode(idx.t().contiguous().t(), val, 64)


# -- the serving path: B7, R1, L1, T1's bits rows ----------------------------


def _f32_close(got, ref):
    err = (got - ref).abs()
    bad = err > 5e-5 + 1e-4 * ref.abs()
    assert not bad.any(), f"{int(bad.sum())} elements outside, max {err.max()}"


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _pool(g, b, s, page, h, hd):
    """b rows' windows on shuffled pages of a pool, and the same windows as
    an unpaged [b, S, H, hd] cache."""
    nblk = s // page
    rows_k = torch.randn(b, s, h, hd, device="cuda", generator=g)
    rows_v = torch.randn(b, s, h, hd, device="cuda", generator=g)
    pages = 2 + b * nblk
    perm = 1 + torch.randperm(pages - 1, device="cuda", generator=g)
    table = perm[:b * nblk].view(b, nblk).to(torch.int32)
    kp = torch.randn(pages, page, h, hd, device="cuda", generator=g)
    vp = torch.randn(pages, page, h, hd, device="cuda", generator=g)
    kp[table.long()] = rows_k.view(b, nblk, page, h, hd)
    vp[table.long()] = rows_v.view(b, nblk, page, h, hd)
    return rows_k, rows_v, kp, vp, table


@pytest.mark.gpu
@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("t", [1, 5, 64])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_decode_attention_matches_twin_and_unpaged(page, t, hd):
    g = _card()
    b, h, s = 4, 3, 128
    rows_k, rows_v, kp, vp, table = _pool(g, b, s, page, h, hd)
    cur = torch.tensor([0, 17, s - t, s - 2], dtype=torch.int32,
                       device="cuda")
    qkv = torch.randn(b, t, 3 * h * hd, device="cuda", generator=g)
    q = qkv[..., :h * hd].unflatten(-1, (h, hd))      # a strided view
    got = tdec.decode_attention(q, kp, vp, table, cur)
    _f32_close(got, tdec.plain_decode_attention(q, kp, vp, table, cur))
    unp = tdec.decode_attention(q, rows_k, rows_v,
                                tdec.unpaged_table(b, "cuda"), cur)
    assert _same_bits(got, unp)
    for r, j in ((1, 0), (2, t - 1)):
        one = tdec.decode_attention(q[r:r + 1, j:j + 1].contiguous(), kp,
                                    vp, table[r:r + 1], cur[r:r + 1] + j)
        assert _same_bits(one[0, 0], got[r, j])


@pytest.mark.gpu
@pytest.mark.parametrize("w_nk", [False, True])
@pytest.mark.parametrize("k,n", [(96, 200), (768, 64), (33, 7)])
def test_row_linear_matches_twin_and_rows_bit_for_bit(w_nk, k, n):
    g = _card()
    x = torch.randn(1024, k, device="cuda", generator=g)
    w = torch.randn(*((n, k) if w_nk else (k, n)), device="cuda",
                    generator=g) * 0.1
    bias = None if w_nk else torch.randn(n, device="cuda", generator=g)
    full = {m: trow.row_linear(x[:m], w, bias, w_nk) for m in (16, 80, 1024)}
    for m, y in full.items():
        _f32_close(y, trow.plain_row_linear(x[:m], w, bias, w_nk))
        ref = x[:m] @ (w.t() if w_nk else w)
        _f32_close(y, ref if bias is None else ref + bias)
    for r in (0, 7, 15):
        one = trow.row_linear(x[r:r + 1], w, bias, w_nk)[0]
        assert all(_same_bits(one, y[r]) for y in full.values())


@pytest.mark.gpu
def test_row_layer_norm_matches_twin_and_rows_bit_for_bit():
    g = _card()
    x = torch.randn(1024, 768, device="cuda", generator=g) * 2 + 1
    sc, bi = (torch.randn(768, device="cuda", generator=g) for _ in "ab")
    full = {m: trow.row_layer_norm(x[:m], sc, bi) for m in (16, 80, 1024)}
    for m, y in full.items():
        _f32_close(y, trow.plain_row_layer_norm(x[:m], sc, bi))
    for r in (0, 9):
        one = trow.row_layer_norm(x[r:r + 1], sc, bi)[0]
        assert all(_same_bits(one, y[r]) for y in full.values())


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(1, 3), (16, 50304), (80, 65)])
@pytest.mark.parametrize("fold", [False, True])
def test_bits_rows_match_twin_bit_for_bit(rows, n, fold):
    g = _card()
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 2), device="cuda",
                         generator=g, dtype=torch.int32)
    data = (torch.randint(0, 10 ** 6, (rows,), device="cuda", generator=g,
                          dtype=torch.int32) if fold else None)
    assert torch.equal(tf.random_bits_rows(keys, data, n),
                       tf.plain_random_bits_rows(keys, data, n))


# -- the checkpoint layer on the card ---------------------------------------


def _tiny_fit(base, steps, tag, **kw):
    import os

    import numpy as np

    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import ContiguousGPTTrainDataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.strategy import DiLoCoStrategy, OptimSpec
    toks = np.random.default_rng(0).integers(0, 65, 20_000).astype(np.int32)
    return Trainer(GPT(GPTConfig(block_size=128, vocab_size=65, n_layer=2,
                                 n_head=2, n_embd=64, attn_impl="flash")),
                   ContiguousGPTTrainDataset(toks, 128)).fit(
        strategy=DiLoCoStrategy(OptimSpec("adamw", lr=3e-4), H=2),
        num_nodes=2, max_steps=steps, batch_size=4, val_size=0, seed=0,
        show_progress=False, autocast=True, checkpoint_interval=3,
        save_dir=os.path.join(str(base), "ckpt"), run_name=tag,
        log_dir=os.path.join(str(base), "logs"), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_of_card_tensors_is_bit_equal(tmp_path, async_save):
    import numpy as np

    from gym_tpu_torch.utils.checkpoint import CheckpointManager
    g = _card()
    state = {"w": torch.randn(2, 300, 70, device="cuda", generator=g),
             "h": torch.randn(2, 64, device="cuda",
                              generator=g).bfloat16(),
             "n": torch.arange(10, device="cuda"),
             "rng": np.array([[1, 2 ** 32 - 1]], dtype=np.uint32),
             "count": 4, "trace": None}
    want = {k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in state.items()}
    mgr = CheckpointManager(str(tmp_path), "card", async_save=async_save)
    mgr.save_async(3, state, {"pos": [1, 2]})
    state["w"].mul_(2.0)  # the live tensor changes behind the writer
    mgr.wait()
    step, got, data, _ = mgr.restore(want)
    mgr.close()
    assert step == 3 and data == {"pos": [1, 2]}
    for k in ("w", "h", "n"):
        assert got[k].device == want[k].device
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert got["rng"].dtype == np.uint32
    assert np.array_equal(got["rng"], want["rng"])
    assert got["count"] == 4 and got["trace"] is None
    # the params-only read straight onto the card, numpy leaves to the host
    from gym_tpu_torch.utils.checkpoint import restore_params
    mgr = CheckpointManager(str(tmp_path), "p", async_save=False)
    mgr.save(1, {"params": {"w": want["w"]}, "rng": want["rng"]}, {})
    mgr.close()
    step, params, _ = restore_params(mgr.directory, device="cuda")
    assert step == 1 and params["w"].is_cuda
    assert torch.equal(params["w"], want["w"])


@pytest.mark.gpu
def test_native_crc32c_equals_the_python_one():
    import os

    from gym_tpu_torch.utils import integrity
    _card()
    for n in (0, 1, 7, 8, 9, 4097, 1 << 20):
        data = os.urandom(n)
        for crc in (0, 0xDEADBEEF):
            assert integrity.crc32c(data, crc) == \
                integrity._crc32c_python(data, crc)
    assert integrity.crc32c(b"123456789") == 0xE3069283


@pytest.mark.gpu
def test_resumed_fit_is_byte_identical_on_card(tmp_path):
    _card()
    straight = _tiny_fit(tmp_path / "s", 6, "run")
    _tiny_fit(tmp_path / "r", 3, "run")
    resumed = _tiny_fit(tmp_path / "r", 6, "run")
    assert [s for s, _ in resumed.history["train_loss"]] == [3, 4, 5]
    read = lambda b: (b / "logs" / "run" / "train.csv").read_bytes()
    assert read(tmp_path / "r") == read(tmp_path / "s")
    for n, p in straight.node_state.params.items():
        assert torch.equal(p, resumed.node_state.params[n]), n


@pytest.mark.gpu
@pytest.mark.parametrize("spc,steps", [(1, 4), (3, 7)])
def test_prefetched_batches_equal_the_sync_path_on_card(spc, steps):
    import numpy as np

    from gym_tpu_torch.data import ContiguousGPTTrainDataset
    from gym_tpu_torch.data.prefetch import HostPrefetcher, dispatch_schedule
    from gym_tpu_torch.data.sampler import (NodeBatchIterator,
                                            resolve_node_datasets)
    _card()

    def it():
        toks = np.random.default_rng(1).integers(0, 65, 9000)
        d, sh = resolve_node_datasets(
            ContiguousGPTTrainDataset(toks.astype(np.int32), 64), 4, False)
        return NodeBatchIterator(d, 4, sharded=sh, shuffle=True, seed=2)

    sched = dispatch_schedule(0, steps, spc, True)
    pf = HostPrefetcher(it(), "cuda", sched, n_micro=2, micro_bs=3).start()
    sync = it()
    try:
        for s in sched:
            got = pf.get()
            draws = [sync.next_batch(2, 3) for _ in range(s)]
            for f, g in enumerate(got):
                want = (np.stack([d[f] for d in draws], axis=1) if s > 1
                        else draws[0][f])
                assert g.is_cuda
                assert np.array_equal(g.cpu().numpy(), want)
            assert pf.consumed_state() == sync.state()
    finally:
        pf.close()
