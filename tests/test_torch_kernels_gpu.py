"""The CUDA kernels of ``gym_tpu_torch.ops.fused_attention``,
``gym_tpu_torch.ops.flash_attention`` and ``gym_tpu_torch.ops.threefry``
against their plain versions on the card. Marked ``gpu``: they skip without a card. This
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
leave a row's start aligned and not.
"""

import pytest
import torch

import gym_tpu_torch.ops.flash_attention as tflash
import gym_tpu_torch.ops.fused_attention as tfa
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
