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
bit at M = 1, 16, 80 and 1024, and bit for bit its oracle (the first
kernel, ``row_linear_ref``) at the dispatch's M-boundaries (1, 16, 32, 33,
64, 65, 80, 512) on a GPT-2 base layer, a ragged shape and the scan's
32 x 32, both layouts, with and without a bias, and at the scan's 16 and
80 rows of 50,304; L1 (the row layer norm) likewise; T1's bits rows bit
for bit against the twin. B7 and B7 int8 bit for bit their oracles (the
first kernel, ``decode_attention_ref``) on every path at t = 1, 5, 16, 64
and 512, every head dim, pages of 16 and 32 and unpaged, cursors 0, S - 1
and random; NaN past each row's last position and in unmapped pages
changing no output bit; a NaN scale reaching its query on every path. L1
with the residual add (``row_add_layer_norm``) bit for bit a torch add and
the oracle L1, at M = 1-1024 and widths 768, 100, 1600 and 2100.

Quantized serving's kernels: B6 (``row_qlinear``) bit for bit R1 on the
dequantized weights, int8 and int4, in both layouts at tiles that the
widths clamp, at M = 1, 16, 80 and 1024 (so row-invariant as R1 is), and
bit for bit R1 and its own oracle at R1's M-boundaries; B7
int8 bit for bit B7 on the dequantized pools, paged and unpaged, decode and
prefill, a NaN scale reaching its own row only; ``kv_quantize`` on the card
bit for bit the CPU's.

The checkpoint layer on the card: a save and restore of CUDA tensors (f32,
bf16, int64, a host uint32 key table) is bit-equal with device and dtype
kept, through the synchronous and the async writer (whose copy waits on the
snapshot's event while the live tensors change), and the C ``crc32c`` the
library builds equals the Python one; a small fit resumed at 3 ends
byte-identical to a straight run; the prefetcher's batches on the card
equal the synchronous path's.

The serving engine's CUDA graphs (``gym_tpu_torch.programs``): an engine
whose programs replay as graphs and one that runs the same staged programs
eagerly, driven through the same calls (every prefill bucket used, the
decode and spec chunks, copy-on-write, the chunk-1 twin; unpaged, the
admit), give the same tokens, last logits and caches bit for bit, every
program of the graphed engine is a captured graph, and the kernels' launch
counters read the same after both; a capture on one engine while another
engine's driver thread dispatches (and a warmup capturing on an engine
whose own requests arrive meanwhile) neither errors nor changes a stream;
a quantized engine's (int8 weights and embedding, int8 KV) graph replays
equal its eager calls likewise, B6 and B7 int8 launched as often.

D1's and T1 bits rows' second kernels bit for bit their oracles (the first
kernels, ``scatter_mean_decode_ref``, ``random_bits_rows_ref``) and their
twins, two runs bit-identical, at DeMo's signatures and the sampler's row
shapes, at every launch plan a sweep may pick, with a row's picks in one
slot, the orders that decide a sum, picks outside the row (the oracle only)
and an output buffer that held 0xFF bytes before.

T1 bits on its main path (``quantize_tiles``, ``QuantizeCodec``'s quantize
in one kernel), twice, bit for bit its plain version and the first bits
kernel's uniform followed by the plain quantize (``quantize_tiles_ref``), at
phase 8d's shapes (a key a row and one shared key), tiles 7, 64 and 256 (n % 4 != 0 and an unaligned x take the
any-tile path), int4, rounding to nearest, and zero, NaN, ±inf, huge and
-0.0 tiles; one launch a call; the codec and the link's residual on the
card equal to the CPU's (``-k quantize_tiles or codec``).

B8, the MoE layers' grouped matmuls (``-k b8 or moe_layer``): grouped_dot,
with w as it lies and read transposed, and grouped_outer against their plain
versions in both dtypes' bands, empty groups and rows past sum(gs) zero on
poisoned outputs, f32 grouped_dot bit for bit R1 a group and a row's bits
the same alone, in its group and with K=2 problems flattened; the f32 ring
kernels bit for bit their oracle (the first f32 kernels) and R1 a group, the
forward at every tiling, at a small shape and a served decode step; bf16 at an
MoE width on the TMA kernels and, for a view TMA does not take (C = 100),
on the first kernels, each path's launches counted apart; the gradients
against the plain versions' autograd; the ragged MoE layer of K=2 nodes on
the card against the CPU, its decode form's rows the same alone and in a
batch.
"""

import pytest
import torch

import gym_tpu_torch.ops.decode_attention as tdec
import gym_tpu_torch.ops.flash_attention as tflash
import gym_tpu_torch.ops.fused_attention as tfa
import gym_tpu_torch.ops.grouped_matmul as tgm
import gym_tpu_torch.ops.quantize_tiles as tqt
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


# D1's second kernel against its oracle (the first kernel) and its twin,
# bit for bit, each case run twice: config 5's signatures and K = 2's 64
# picks, a row of more picks than a warp's chunk and more slots than a
# block's run, one slot, no picks; a row's picks all in one slot; the
# orders that decide a sum (1, 1e8, −1e8 and v, 0, −v in one slot). Its
# output buffer first held 0xFF bytes (freed just before), so a slot it
# never wrote cannot pass as the oracle's.
D1_CASES = ((200, 2048, 4096), (108, 2048, 64), (4, 2048, 2112),
            (200, 64, 4096), (3, 5000, 9000), (1, 1, 1), (5, 0, 64))


def _poison_bytes(nbytes):
    torch.full((nbytes,), 0xFF, dtype=torch.uint8, device="cuda")


def _d1_all_three(idx, val, e, plan=None):
    """The kernel (at ``plan`` = (slots, warps), else its own), twice, its
    oracle and its twin: each pair bit for bit."""
    outs = []
    for _ in range(2):
        _poison_bytes(idx.shape[0] * e * 4)
        outs.append(tsm.scatter_mean_decode(idx, val, e) if plan is None
                    else tsm.scatter_mean_decode_tuned(idx, val, e, *plan))
    ref = tsm.scatter_mean_decode_ref(idx, val, e)
    twin = tsm.plain_scatter_mean_decode(idx, val, e)
    assert _same_bits(outs[0], outs[1]), "two runs differ"
    assert _same_bits(outs[0], ref), "differs from the oracle"
    assert _same_bits(outs[0], twin), "differs from the twin"
    return outs[0]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,m,e", D1_CASES)
def test_scatter_mean_is_its_oracle_and_twin_bit_for_bit(rows, m, e):
    g = _card()
    idx, val = _picks(g, rows, m, e)
    before = tsm.scatter_mean_decode.launches
    _d1_all_three(idx, val, e)
    assert tsm.scatter_mean_decode.launches == before + 2 * (rows > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("slots,warps", [(4, 4), (16, 1), (32, 2), (64, 8),
                                         (256, 2), (512, 4), (2048, 4),
                                         (4096, 1)])
@pytest.mark.parametrize("rows,m,e", [(108, 2048, 64), (4, 2048, 2112),
                                      (3, 5000, 9000)])
def test_scatter_mean_plans_are_the_oracle_bit_for_bit(slots, warps, rows, m,
                                                        e):
    """Launch plans across the sweep's range: the same bits."""
    g = _card()
    idx, val = _picks(g, rows, m, e)
    _d1_all_three(idx, val, e, (slots, warps))


@pytest.mark.gpu
@pytest.mark.parametrize("e", [1, 64, 4096])
def test_scatter_mean_all_picks_in_one_slot(e):
    g = _card()
    _, val = _picks(g, 3, 2048, e)
    idx = torch.full((3, 2048), e - 1, dtype=torch.int32, device="cuda")
    idx[1] = 0
    _d1_all_three(idx, val, e)


@pytest.mark.gpu
def test_scatter_mean_order_decides_the_sum():
    """1, 1e8, −1e8 in u order sum to 0 (−1e8 + 1e8 + 1 would give 1), and
    v, 0, −v to exactly 0.0, with picks of other slots between them, in
    one batch of 32 and across batches and chunks."""
    g = _card()
    idx, val = _picks(g, 2, 4096, 64)
    idx = torch.where(idx < 2, 2, idx)
    for row, (a, b, c) in enumerate(((0, 1, 2), (5, 700, 4000))):
        idx[row, [a, b, c]] = 0
        val[row, [a, b, c]] = torch.tensor([1.0, 1e8, -1e8], device="cuda")
        idx[row, [a + 3, b + 3, c + 3]] = 1
        val[row, [a + 3, b + 3, c + 3]] = torch.tensor([0.37, 0.0, -0.37],
                                                       device="cuda")
    out = _d1_all_three(idx, val, 64).cpu()
    assert (out[:, 0] == 0.0).all() and (out[:, 1] == 0.0).all()


@pytest.mark.gpu
def test_scatter_mean_picks_outside_the_row_count_nowhere():
    """Picks at −1, −2³¹, e and 2³¹ − 1 count in no slot, as the oracle's.
    The twin never sees them (its ``scatter_add_`` would trip a device-side
    assert): it takes them sent to one slot past the row's, cut off."""
    g = _card()
    idx, val = _picks(g, 4, 2048, 2112)
    bad = torch.tensor([-1, -2 ** 31, 2112, 2 ** 31 - 1], dtype=torch.int32,
                       device="cuda")
    idx[:, ::7] = bad.repeat(2048 // 7 // 4 + 1)[:idx[:, ::7].shape[1]]
    ref = tsm.scatter_mean_decode_ref(idx, val, 2112)
    for plan in (None, (4, 8), (64, 8), (4096, 1)):
        _poison_bytes(4 * 2112 * 4)
        got = (tsm.scatter_mean_decode(idx, val, 2112) if plan is None
               else tsm.scatter_mean_decode_tuned(idx, val, 2112, *plan))
        assert _same_bits(got, ref), plan
    # the twin with the outside picks sent to a slot past the row's
    keep = (idx >= 0) & (idx < 2112)
    twin = tsm.plain_scatter_mean_decode(torch.where(keep, idx, 2112), val,
                                         2113)[:, :2112]
    assert _same_bits(twin, ref)


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


# the dispatch's M-boundaries (few rows up to 32, the many-row tilings from
# 33) and the shapes of its regimes: a GPT-2 base layer, a ragged one (K a
# multiple of no BK, N of no tile) and the scan's 32 x 32
ORACLE_M = (1, 16, 32, 33, 64, 65, 80, 512)
ORACLE_SHAPES = {"dense": (768, 2304), "ragged": (100, 50), "scan": (32, 32)}


def _oracle_weight(g, shape, w_nk):
    k, n = ORACLE_SHAPES[shape]
    if shape == "scan":
        return torch.triu(torch.ones(32, 32, device="cuda"))
    return torch.randn(*((n, k) if w_nk else (k, n)), device="cuda",
                       generator=g) * 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(ORACLE_SHAPES))
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("w_nk", [False, True])
@pytest.mark.parametrize("m", ORACLE_M)
def test_row_linear_is_its_oracle_bit_for_bit(m, w_nk, with_bias, shape):
    g = _card()
    k, n = ORACLE_SHAPES[shape]
    x = torch.randn(m, k, device="cuda", generator=g)
    w = _oracle_weight(g, shape, w_nk)
    bias = torch.randn(n, device="cuda", generator=g) if with_bias else None
    assert _same_bits(trow.row_linear(x, w, bias, w_nk),
                      trow.row_linear_ref(x, w, bias, w_nk))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [16 * 1572, 80 * 1572])
def test_row_linear_scan_is_its_oracle_bit_for_bit(m):
    """The sampler's scan at a decode step's and a gamma-4 verify's rows
    of 50,304."""
    g = _card()
    x = torch.rand(m, 32, device="cuda", generator=g)
    tri = torch.triu(torch.ones(32, 32, device="cuda"))
    assert _same_bits(trow.row_linear(x, tri), trow.row_linear_ref(x, tri))


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


# T1 bits rows' second kernel against its oracle (the first kernel) and its
# twin, bit for bit, each case run twice, with and without data: a decode
# step's 16 and a verify's 80 rows of 50,304, rows that start unaligned
# (65, 3), the one-key path's single row of R·V, the most rows a launch
# takes; the output buffer first held 0xFF bytes
BITS_ROWS = ((1, 3), (16, 50304), (80, 65), (80, 50304), (1, 804864),
             (65535, 4))


def _bits_rows_case(g, rows, n, fold):
    keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 2), device="cuda",
                         generator=g, dtype=torch.int32)
    data = (torch.randint(0, 10 ** 6, (rows,), device="cuda", generator=g,
                          dtype=torch.int32) if fold else None)
    return keys, data


def _bits_rows_all_three(keys, data, n, plan=None):
    outs = []
    for _ in range(2):
        _poison_bytes(keys.shape[0] * n * 4)
        outs.append(tf.random_bits_rows(keys, data, n) if plan is None
                    else tf.random_bits_rows_tuned(keys, data, n, *plan))
    assert torch.equal(outs[0], outs[1]), "two runs differ"
    assert torch.equal(outs[0], tf.random_bits_rows_ref(keys, data, n)), \
        "differs from the oracle"
    assert torch.equal(outs[0], tf.plain_random_bits_rows(keys, data, n)), \
        "differs from the twin"


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", BITS_ROWS)
@pytest.mark.parametrize("fold", [False, True])
def test_bits_rows_are_their_oracle_and_twin_bit_for_bit(rows, n, fold):
    g = _card()
    keys, data = _bits_rows_case(g, rows, n, fold)
    before = tf.random_bits_rows.launches
    _bits_rows_all_three(keys, data, n)
    assert tf.random_bits_rows.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("per_thread", [1, 2, 4, 8])
@pytest.mark.parametrize("warps_per_sm,warps_a_block", [(8, 8), (64, 2),
                                                         (1, 1)])
@pytest.mark.parametrize("rows,n", [(80, 65), (16, 50304), (3, 4097),
                                    (1, 804864)])
def test_bits_rows_plans_are_the_oracle_bit_for_bit(per_thread, warps_per_sm,
                                                     warps_a_block, rows, n):
    """Launch plans across the sweep's range: the same bits."""
    g = _card()
    keys, data = _bits_rows_case(g, rows, n, True)
    _bits_rows_all_three(keys, data, n, (per_thread, warps_per_sm,
                                         warps_a_block))


# B7 and B7 int8 against their oracles (the first kernel): every query count
# of the paths' regimes (a decode step, a verify chunk, a prefill tile and
# its edge, a 512-token prompt), every head dim, pages of 16 and 32 and the
# unpaged cache; rows at cursor 0, S - 1 (the queries past it clamp) and a
# random one
B7_T = (1, 5, 16, 64, 512)
B7_PAGES = (16, 32, 0)        # 0: unpaged


def _b7_case(g, t, hd, page, int8, b=3, h=2, s=1024):
    """q (a strided view), the pools (int8 with their scales when
    ``int8``), the block table and the cursors."""
    rows_k, rows_v, kp, vp, table = _pool(g, b, s, page or 16, h, hd)
    if not page:
        kp, vp, table = rows_k, rows_v, tdec.unpaged_table(b, "cuda")
    cur = torch.randint(1, s - 1, (b,), device="cuda", generator=g,
                        dtype=torch.int32)
    cur[0], cur[1] = 0, s - 1
    qkv = torch.randn(b, t, 3 * h * hd, device="cuda", generator=g)
    q = qkv[..., :h * hd].unflatten(-1, (h, hd))
    scales = ()
    if int8:
        (kp, ks), (vp, vs) = tfa.kv_quantize(kp), tfa.kv_quantize(vp)
        scales = (ks, vs)
    return q, kp, vp, scales, table, cur


def _b7(q, kp, vp, scales, table, cur, ref=False):
    if scales:
        fn = tdec.decode_attention_int8_ref if ref else \
            tdec.decode_attention_int8
        return fn(q, kp, vp, *scales, table, cur)
    fn = tdec.decode_attention_ref if ref else tdec.decode_attention
    return fn(q, kp, vp, table, cur)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page", B7_PAGES)
@pytest.mark.parametrize("t", B7_T)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_decode_attention_is_its_oracle_bit_for_bit(int8, page, t, hd):
    """The dispatch's path and every other path, bit for bit the oracle."""
    g = _card()
    case = _b7_case(g, t, hd, page, int8)
    ref = _b7(*case, ref=True)
    assert _same_bits(_b7(*case), ref)
    q, kp, vp, scales, table, cur = case
    for path in range(len(tdec.PATHS)):
        got = tdec.decode_attention_on_path(q, kp, vp, table, cur, path,
                                            scales)
        assert _same_bits(got, ref), tdec.PATHS[path]


def _poison(pool, table, cur, t, s, page, paged):
    """NaN at every position past each row's last query's and, paged, in
    every page no row maps: what B7 must never read."""
    pool = pool.clone()
    flat = pool.view(-1, *pool.shape[2:])
    for r in range(table.shape[0]):
        last = min(int(cur[r]) + t - 1, s - 1)
        p = torch.arange(last + 1, s, device="cuda")
        if paged:
            flat[table[r, p // page].long() * page + p % page] = float("nan")
        else:
            pool[r, last + 1:] = float("nan")
    if paged:
        mapped = torch.zeros(pool.shape[0], dtype=torch.bool, device="cuda")
        mapped[table.long().flatten()] = True
        pool[~mapped] = float("nan")
    return pool


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page", [16, 0])
@pytest.mark.parametrize("t", [1, 5, 64])
@pytest.mark.parametrize("hd", [16, 128])
def test_decode_attention_never_reads_past_a_query(int8, page, t, hd):
    """Poison past each row's last position and in unmapped pages (the K
    and V pools, or the int8 pools' scales) changes no output bit, on any
    path; the oracle agrees."""
    g = _card()
    case = _b7_case(g, t, hd, page, int8)
    clean = _b7(*case)
    q, kp, vp, scales, table, cur = case
    s, pg = 1024, kp.shape[1]
    if int8:
        scales = tuple(_poison(x, table, cur, t, s, pg, bool(page))
                       for x in scales)
    else:
        kp, vp = (_poison(x, table, cur, t, s, pg, bool(page))
                  for x in (kp, vp))
    bad = (q, kp, vp, scales, table, cur)
    assert clean.isfinite().all()
    assert _same_bits(_b7(*bad), clean)
    assert _same_bits(_b7(*bad, ref=True), clean)
    for path in range(len(tdec.PATHS)):
        assert _same_bits(tdec.decode_attention_on_path(
            q, kp, vp, table, cur, path, scales), clean), tdec.PATHS[path]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 64])
def test_decode_attention_int8_nan_scale_reaches_its_query(t):
    """A NaN scale at a position a query reads makes that query's output
    NaN on every path, as in the oracle, and nowhere else."""
    g = _card()
    q, kp, vp, (ks, vs), table, cur = _b7_case(g, t, 64, 16, True)
    ks = ks.clone()
    ks[table[2, 0].long(), 0, 1] = float("nan")     # row 2, position 0, head 1
    ref = tdec.decode_attention_int8_ref(q, kp, vp, ks, vs, table, cur)
    want = torch.zeros_like(ref, dtype=torch.bool)
    want[2, :, 1] = True                             # every query reads it
    assert torch.equal(torch.isnan(ref), want)
    for path in range(len(tdec.PATHS)):
        got = tdec.decode_attention_on_path(q, kp, vp, table, cur, path,
                                            (ks, vs))
        assert torch.equal(torch.isnan(got), want), tdec.PATHS[path]
        assert torch.equal(got[~want], ref[~want])


@pytest.mark.gpu
@pytest.mark.parametrize("c", [768, 100, 1600, 2100])
def test_row_add_layer_norm_is_add_then_oracle_bit_for_bit(c):
    """s bit for bit a torch add, y bit for bit the oracle L1 on it, at M =
    1, 16, 80, 512 and 1024 and widths held in registers (768, 100: not a
    multiple of 32, 1600) or re-read (2100); every row alone as in any M."""
    g = _card()
    x = torch.randn(1024, c, device="cuda", generator=g) * 2 + 1
    d = torch.randn(1024, c, device="cuda", generator=g)
    sc, bi = (torch.randn(c, device="cuda", generator=g) for _ in "ab")
    full = {}
    for m in (1, 16, 80, 512, 1024):
        s, y = trow.row_add_layer_norm(x[:m], d[:m], sc, bi)
        add = x[:m] + d[:m]
        assert _same_bits(s, add)
        assert _same_bits(y, trow.row_layer_norm(add, sc, bi))
        none, y2 = trow.row_add_layer_norm(x[:m], d[:m], sc, bi,
                                           want_sum=False)
        assert none is None and _same_bits(y2, y)
        full[m] = y
    for r in (0, 9):
        one = trow.row_add_layer_norm(x[r:r + 1], d[r:r + 1], sc, bi)[1][0]
        assert all(_same_bits(one, y[r]) for m, y in full.items() if m > r)
    _, y = trow.row_add_layer_norm(x[:16], d[:16], sc)
    assert _same_bits(y, trow.row_layer_norm(x[:16] + d[:16], sc))


# -- quantized serving's kernels ---------------------------------------------


def _quantized(g, shape, bits, tile):
    """int8 values in ±qmax and one f32 scale per ``t`` elements, ``t`` the
    largest divisor of the trailing axis up to ``tile``."""
    from gym_tpu_torch.ops.grouped_matmul import quant_tile_for
    qmax = 127 if bits == 8 else 7
    t = quant_tile_for(shape, tile)
    n = shape[0] * shape[1]
    q = torch.randint(-qmax, qmax + 1, shape, device="cuda", generator=g,
                      dtype=torch.int64).to(torch.int8)
    scale = torch.rand(n // t, device="cuda", generator=g) * 0.01 + 1e-4
    return q, scale


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("w_nk", [False, True])
@pytest.mark.parametrize("k,n,tile", [(96, 200, 256), (768, 2304, 256),
                                      (48, 144, 40), (33, 7, 256)])
def test_row_qlinear_is_r1_on_dequantized_weights(bits, w_nk, k, n, tile):
    from gym_tpu_torch.ops.grouped_matmul import dequantize_tiles
    g = _card()
    x = torch.randn(1024, k, device="cuda", generator=g)
    q, scale = _quantized(g, (n, k) if w_nk else (k, n), bits, tile)
    w = dequantize_tiles(q, scale)
    bias = None if w_nk else torch.randn(n, device="cuda", generator=g)
    full = {}
    for m in (1, 16, 80, 1024):
        full[m] = trow.row_qlinear(x[:m], q, scale, bias, w_nk)
        assert _same_bits(full[m], trow.row_linear(x[:m], w, bias, w_nk))
        _f32_close(full[m], trow.plain_row_qlinear(x[:m], q, scale, bias,
                                                   w_nk))
    for r in (0, 7, 15):
        one = trow.row_qlinear(x[r:r + 1], q, scale, bias, w_nk)[0]
        assert all(_same_bits(one, y[r]) for m, y in full.items() if m > r)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["dense", "ragged"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("w_nk", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", ORACLE_M)
def test_row_qlinear_is_new_r1_on_dequantized_weights(m, bits, w_nk,
                                                      with_bias, shape):
    """B6 bit for bit R1 on the dequantized weights and B6's oracle, at
    the dispatch's M-boundaries (the ragged shape's tiles, 50 and 100
    elements, copy its int8 rows 4 bytes at a time or not at all, and
    dequantize an element at a time)."""
    from gym_tpu_torch.ops.grouped_matmul import dequantize_tiles
    g = _card()
    k, n = ORACLE_SHAPES[shape]
    x = torch.randn(m, k, device="cuda", generator=g)
    q, scale = _quantized(g, (n, k) if w_nk else (k, n), bits, 256)
    bias = torch.randn(n, device="cuda", generator=g) if with_bias else None
    got = trow.row_qlinear(x, q, scale, bias, w_nk)
    assert _same_bits(got, trow.row_linear(x, dequantize_tiles(q, scale),
                                           bias, w_nk))
    assert _same_bits(got, trow.row_qlinear_ref(x, q, scale, bias, w_nk))


@pytest.mark.gpu
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("t", [1, 5, 64])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_decode_attention_int8_is_b7_on_dequantized_pools(page, t, hd):
    g = _card()
    b, h, s = 4, 3, 128
    rows_k, rows_v, kp, vp, table = _pool(g, b, s, page, h, hd)
    (kq, ks), (vq, vs) = tfa.kv_quantize(kp), tfa.kv_quantize(vp)
    cur = torch.tensor([0, 17, s - t, s - 2], dtype=torch.int32,
                       device="cuda")
    qkv = torch.randn(b, t, 3 * h * hd, device="cuda", generator=g)
    q = qkv[..., :h * hd].unflatten(-1, (h, hd))      # a strided view
    got = tdec.decode_attention_int8(q, kq, vq, ks, vs, table, cur)
    kd, vd = tfa.kv_dequantize(kq, ks), tfa.kv_dequantize(vq, vs)
    assert _same_bits(got, tdec.decode_attention(q, kd, vd, table, cur))
    _f32_close(got, tdec.plain_decode_attention_int8(q, kq, vq, ks, vs,
                                                     table, cur))
    # unpaged: the rows' windows as per-row caches
    rk, rv = kq[table.long()].flatten(1, 2), vq[table.long()].flatten(1, 2)
    rks, rvs = ks[table.long()].flatten(1, 2), vs[table.long()].flatten(1, 2)
    unp = tdec.decode_attention_int8(q, rk, rv, rks, rvs,
                                     tdec.unpaged_table(b, "cuda"), cur)
    assert _same_bits(got, unp)
    # a NaN scale at row 1's position 3 (read by all its queries) reaches
    # row 1's head 0 only
    ks = ks.clone()
    ks[table[1, 3 // page].long(), 3 % page, 0] = float("nan")
    bad = tdec.decode_attention_int8(q, kq, vq, ks, vs, table, cur)
    assert torch.isnan(bad[1, :, 0]).all()
    keep = torch.ones_like(bad, dtype=torch.bool)
    keep[1, :, 0] = False
    assert torch.equal(bad[keep], got[keep])


@pytest.mark.gpu
def test_kv_quantize_on_card_equals_cpu():
    g = _card()
    x = torch.randn(64, 16, 12, 64, device="cuda", generator=g) * 3
    x[0, 0, 0] = 0.0
    x[0, 1, 1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                   126.5])
    x[0, 1, 1, 8:] = 0.0
    x[1, 2, 0, 3] = float("nan")
    x[1, 3, 2, 5] = float("inf")
    q, scale = tfa.kv_quantize(x)
    cq, cscale = tfa.kv_quantize(x.cpu())
    assert torch.equal(q.cpu(), cq) and _same_bits(scale.cpu(), cscale)
    assert q[0, 1, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


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


# -- the serving engine's CUDA graphs ---------------------------------------


def _serving_kernels():
    return (tdec.decode_attention, trow.row_linear, trow.row_add_layer_norm,
            tf.random_bits_rows)


def _tiny_engine(paged, graphs, seed=0, **quant):
    import numpy as np

    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.serve import InferenceEngine
    cfg = GPTConfig(block_size=64, vocab_size=96, n_layer=2, n_head=2,
                    n_embd=64)
    params = GPT(cfg).init_params(1, seed, "cuda")
    params = {n: p[0] for n, p in params.items()}
    cfg = GPTConfig(**{**cfg.__dict__, **quant})
    kw = (dict(paged=True, page_size=8, spec_tokens=2) if paged else {})
    return InferenceEngine(params, cfg, num_slots=4, decode_chunk=4,
                           device="cuda", cuda_graphs=graphs, **kw), np


def _drive(eng, np):
    """Every program of the family: prompts in buckets 4, 16 and 32 (one
    repeated whole, a full-block match: copy-on-write), sampled and
    greedy, a teacher-forced step (the chunk-1 twin), then decode to the
    end. Returns the events and the last logits of every step."""
    from gym_tpu_torch.serve import SamplingParams
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 96, 16).astype(np.int32)
    work = [(rng.integers(0, 96, 3).astype(np.int32),
             SamplingParams(max_new_tokens=9, temperature=0.8, top_k=7,
                            seed=1)),
            (shared, SamplingParams(max_new_tokens=12, top_k=1, seed=2)),
            (rng.integers(0, 96, 20).astype(np.int32),
             SamplingParams(max_new_tokens=10, top_p=0.9, seed=3))]
    out, logits = [], []

    def step(**kw):
        before = eng._active.copy()
        out.extend(eng.step(**kw))
        # the rows active through the whole chunk: a finished row reads
        # the null page, whose bytes are whichever inactive row's write
        # landed last (paged), on either path
        logits.append(eng.last_logits[before & eng._active])

    for p, sp in work:
        out.append(eng.admit(p, sp)[1])
    step(override_tokens={int(np.nonzero(eng._active)[0][0]): 5})
    if eng.paged:                      # the full-block match: CoW
        out.append(eng.admit(shared, SamplingParams(max_new_tokens=4,
                                                    top_k=1))[1])
    for _ in range(40):
        if not eng._active.any():
            break
        step()
    return [(e.slot, e.token, e.finished) for e in out], logits


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_graph_replays_equal_eager_calls_bit_for_bit(paged):
    _card()
    import numpy as np
    runs = {}
    for graphs in (False, True):
        for w in _serving_kernels():
            w.launches = 0
        eng, _ = _tiny_engine(paged, graphs)
        events, logits = _drive(eng, np)
        torch.cuda.synchronize()
        runs[graphs] = (events, logits, {k: v.clone() for k, v in
                                         eng._cache.items()},
                        [w.launches for w in _serving_kernels()], eng)
    (ev0, lg0, c0, n0, eager), (ev1, lg1, c1, n1, graphed) = \
        runs[False], runs[True]
    assert ev1 == ev0
    assert len(lg1) == len(lg0) and all(
        np.array_equal(a, b, equal_nan=True) for a, b in zip(lg1, lg0))
    # the caches past the null page (page 0, the paged engine's
    # write-redirect target for inactive rows)
    first = 1 if paged else 0
    assert all(torch.equal(c1[k][first:], c0[k][first:]) for k in c0)
    assert n1 == n0 and all(n > 0 for n in n1)
    progs = [h._fn for h in graphed._handles.values()]
    kinds = {k for k, _ in graphed._handles}
    assert kinds == ({"decode", "spec", "cow", "prefill"} if paged
                     else {"decode", "admit", "prefill"})
    assert progs and all(p.captured for p in progs)
    assert not any(h._fn.captured for h in eager._handles.values())
    graphed.close()
    eager.close()


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_quantized_graph_replays_equal_eager_calls(paged):
    """int8 weights and embedding, int8 KV: graphs against eager bit for
    bit, B6 and B7 int8 launched as often on both paths."""
    _card()
    import numpy as np
    kernels = (tdec.decode_attention_int8, trow.row_qlinear,
               trow.row_add_layer_norm, tf.random_bits_rows)
    quant = dict(weights_dtype="int8", kv_dtype="int8", quant_embed=True)
    runs = {}
    for graphs in (False, True):
        for w in kernels + (tdec.decode_attention, trow.row_linear):
            w.launches = 0
        eng, _ = _tiny_engine(paged, graphs, **quant)
        events, logits = _drive(eng, np)
        torch.cuda.synchronize()
        runs[graphs] = (events, logits, {k: v.clone() for k, v in
                                         eng._cache.items()},
                        [w.launches for w in kernels], eng)
        assert tdec.decode_attention.launches == 0   # the f32 B7: never
    (ev0, lg0, c0, n0, eager), (ev1, lg1, c1, n1, graphed) = \
        runs[False], runs[True]
    assert ev1 == ev0
    assert len(lg1) == len(lg0) and all(
        np.array_equal(a, b, equal_nan=True) for a, b in zip(lg1, lg0))
    first = 1 if paged else 0
    assert all(torch.equal(c1[k][first:], c0[k][first:]) for k in c0)
    assert c0["h_0.attn.k"].dtype == torch.int8
    assert n1 == n0 and all(n > 0 for n in n1)
    assert all(h._fn.captured for h in graphed._handles.values())
    assert all(",w=int8+emb,kv=int8]" in h.name
               for h in graphed._handles.values())
    graphed.close()
    eager.close()


@pytest.mark.gpu
def test_capture_beside_a_dispatch_on_another_thread():
    """Engine A serves on its driver thread while the warmup captures
    engine B's family and then A's own (under A's dispatch lock): no
    error, and A's streams equal an eager engine's."""
    _card()
    import threading

    import numpy as np

    from gym_tpu_torch.programs import (graphs_captured_counter,
                                        warm_engine_programs)
    from gym_tpu_torch.serve import RequestStatus, SamplingParams, Scheduler
    rng = np.random.default_rng(9)
    work = [(rng.integers(0, 96, int(n)).astype(np.int32),
             SamplingParams(max_new_tokens=12, temperature=0.9, top_k=9,
                            seed=i))
            for i, n in enumerate(rng.integers(2, 40, 12))]

    def serve(eng):
        sched = Scheduler(eng, max_queue=64)
        hs = [sched.submit(p, sp) for p, sp in work]
        for _ in range(10_000):
            if all(h.status in (RequestStatus.DONE, RequestStatus.FAILED)
                   for h in hs):
                break
            sched.step()
        return [h.result(timeout=5) for h in hs]

    ref_eng, _ = _tiny_engine(True, False)
    ref = serve(ref_eng)
    a, _ = _tiny_engine(True, True)
    b, _ = _tiny_engine(True, True, seed=1)
    got = {}
    graphs0 = graphs_captured_counter()
    t = threading.Thread(target=lambda: got.update(a=serve(a)))
    warm = warm_engine_programs([b, a])
    t.start()
    t.join(timeout=300)
    assert warm.wait(timeout=300) and not t.is_alive()
    assert warm.stats()["warmed"] == warm.stats()["total"]
    assert got["a"] == ref
    # B's family captured whole; A's programs were captured by the
    # warmup or by its own first use, never twice
    assert graphs_captured_counter() - graphs0 == warm.stats()["total"]
    for e in (a, b, ref_eng):
        e.close()


# T1 bits on its main path (QuantizeCodec's quantize in one kernel):
# (rows, n, tile, qmax, keys, stochastic, special). "rows": a key a row (the
# links' per-node keys), "shared": one key for every row (DynamiQ's hops).
# DiLoCo's and NoLoCo's sync on the flagship, DynamiQ's hop 1 and hop 2 at
# K=16, the any-tile path at 7, 64 and a tile of 256 over n % 4 != 0, int4,
# rounding to nearest, and zero, NaN, ±inf, huge and -0.0 tiles.
QT_CASES = (
    (16, 834_432, 256, 127, "rows", True, False),
    (16, 834_432, 256, 127, "shared", True, False),
    (16, 52_152, 256, 127, "shared", True, False),
    (3, 4097, 7, 7, "rows", True, True),
    (3, 4097, 64, 127, "shared", True, True),
    (4, 4096, 256, 127, "rows", True, True),
    (4, 4096, 256, 7, "shared", True, True),
    (5, 1000, 256, 7, "rows", False, True),
    (2, 4097, 256, 127, "rows", True, False),
    (1, 300, 256, 127, "rows", True, False),
)


def _qt_rows(g, rows, n, tile, special):
    x = (torch.randn(rows, n, device="cuda", generator=g)
         * torch.rand(rows, 1, device="cuda", generator=g) * 50)
    if special:
        t = -(-n // tile)
        for r in range(rows):
            for k, tt in enumerate(torch.randperm(t, generator=torch.Generator(
                    ).manual_seed(r))[:6].tolist()):
                a, b = tt * tile, min(n, (tt + 1) * tile)
                if k == 0:
                    x[r, a:b] = 0.0
                elif k == 1:
                    x[r, (a + b) // 2] = float("nan")
                elif k == 2:
                    x[r, a], x[r, b - 1] = float("inf"), float("-inf")
                elif k == 3:
                    x[r, a:b] *= 1e37
                elif k == 4:
                    x[r, a:b] = -0.0
                else:
                    x[r, a:b] *= 1e-30
    return x


def _qt_keys(rows, keys):
    base = tf.fold_in(tf.PRNGKey(2602), 3)
    return base if keys == "shared" else [tf.fold_in(base, i)
                                          for i in range(rows)]


def _qt_same(a, b):
    return torch.equal(a[0], b[0]) and _same_bits(a[1], b[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", QT_CASES)
def test_quantize_tiles_is_plain_and_first_kernel_composition(case):
    """The kernel, twice, bit for bit its plain version (the twin's bits)
    and the first bits kernel's uniform followed by the plain quantize."""
    rows, n, tile, qmax, which, stochastic, special = case
    x = _qt_rows(_card(), rows, n, tile, special)
    keys = _qt_keys(rows, which)
    runs = [tqt.quantize_tiles(x, keys, qmax, tile, stochastic)
            for _ in range(2)]
    plain = tqt.plain_quantize_tiles(x, keys, qmax, tile, stochastic)
    ref = tqt.quantize_tiles_ref(x, keys, qmax, tile, stochastic)
    t = -(-n // tile)
    assert runs[0][0].shape == (rows, t, tile)
    assert runs[0][1].shape == (rows, t, 1)
    assert _qt_same(plain, ref)
    for i, run in enumerate(runs):
        assert _qt_same(run, plain), i


@pytest.mark.gpu
def test_quantize_tiles_unaligned_rows_take_the_any_path():
    """x starting 4 bytes past a 16-byte boundary: the same bits."""
    g = _card()
    buf = torch.randn(3 * 1024 + 1, device="cuda", generator=g)
    x = buf[1:].view(3, 1024)
    keys = _qt_keys(3, "rows")
    assert _qt_same(tqt.quantize_tiles(x, keys, 127, 256),
                    tqt.plain_quantize_tiles(x, keys, 127, 256))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["rows", "shared"])
def test_quantize_tiles_launch_counts(which):
    """One kernel launch a call whatever the rows; no bits launch for keys
    a row, one for a key shared by the rows (the kernel reads its bits)."""
    x = _qt_rows(_card(), 16, 5000, 256, False)
    keys = _qt_keys(16, which)
    before = (tqt.quantize_tiles.launches, tf.random_bits.launches)
    tqt.quantize_tiles(x, keys, 127, 256)
    bits = int(which == "shared")
    assert (tqt.quantize_tiles.launches, tf.random_bits.launches) == (
        before[0] + 1, before[1] + bits)
    before = (tqt.quantize_tiles.launches, tf.random_bits.launches)
    tqt.plain_quantize_tiles(x, keys, 127, 256)
    tqt.quantize_tiles_ref(x, keys, 127, 256)
    assert (tqt.quantize_tiles.launches, tf.random_bits.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_codec_and_link_on_card_equal_the_cpu(codec):
    """``QuantizeCodec`` and ``CompressedLink`` (its residual too) on the
    card give the CPU's bits, which the CPU tests hold to ``jax.jit``; a
    NaN is a NaN (the card's and the CPU's NaN bit patterns differ)."""
    from gym_tpu_torch.strategy.compress import CompressedLink
    x = _qt_rows(_card(), 4, 3000, 256, True)
    for keys in (_qt_keys(4, "rows"), _qt_keys(4, "shared")):
        link = CompressedLink(codec, seed=3)
        for dev in ("cuda", "cpu"):
            got = link.codec.compress(x.to(dev), keys)
            if dev == "cuda":
                card = [t.cpu() for t in got]
            else:
                assert _qt_same(card, got)
        res = torch.randn(4, 3000, generator=torch.Generator().manual_seed(1))
        card = link.encode(x, res.cuda() * 0.01, keys)
        cpu = link.encode(x.cpu(), res * 0.01, keys)
        for a, b in zip(card, cpu):
            a, nan = a.cpu(), torch.isnan(b)
            assert torch.equal(torch.isnan(a), nan)
            assert _same_bits(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0))


# -- B8: the MoE layers' grouped matmuls --------------------------------------


def _b8_operands(g, dt, r=700, c=96, h=160, sizes=(0, 301, 99, 0, 250, 50)):
    """x [r, c], w [G, c, h], ct [r, h] and gs: empty groups, a group
    larger than half the rows, sizes that are no multiple of a tile."""
    x = torch.randn(r, c, device="cuda", generator=g).to(dt)
    w = (torch.randn(len(sizes), c, h, device="cuda", generator=g)
         * 0.05).to(dt)
    ct = (torch.randn(r, h, device="cuda", generator=g) * 0.05).to(dt)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    return x, w, ct, gs


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("sizes", [(0, 301, 99, 0, 250, 50),
                                   (0, 301, 99, 0, 250, 17)],
                         ids=["all_rows", "rows_past_sum"])
def test_b8_matches_its_plain_version(dt, sizes):
    """grouped_dot (w as it lies and read transposed) and grouped_outer
    against the plain versions; rows past sum(gs) and empty groups zero,
    each output poisoned first; f32 grouped_dot bit for bit R1's chains a
    group."""
    dtype, tol = DTYPES[dt]
    x, w, ct, gs = _b8_operands(_card(), dtype, sizes=sizes)
    used = int(sum(sizes))
    for a, b in ((x, w), (ct, w.transpose(1, 2))):
        torch.full((a.shape[0] * b.shape[-1] * 4,), 0xFF, dtype=torch.uint8,
                   device="cuda")
        got = tgm.grouped_dot(a, b, gs)
        _close(got, tgm.plain_grouped_dot(a, b, gs), tol, "grouped_dot")
        assert torch.all(got[used:] == 0)
        if dt == "f32":
            start = 0
            for e, n in enumerate(sizes):
                if n:
                    wt = b[e].t().contiguous() if b.stride(2) != 1 else b[e]
                    want = trow.row_linear(a[start:start + n], wt.contiguous(),
                                           w_nk=b.stride(2) != 1)
                    assert torch.equal(got[start:start + n], want)
                start += n
    torch.full((w.numel() * 4,), 0xFF, dtype=torch.uint8, device="cuda")
    out = tgm.grouped_outer(x, ct, gs)
    _close(out, tgm.plain_grouped_outer(x, ct, gs), tol, "grouped_outer")
    assert torch.all(out[0] == 0) and torch.all(out[3] == 0)


def _r1_groups(op, a, b, sizes):
    """B8's f32 products computed by R1 (``row_linear``) a group at a time:
    each element one in-order FMA chain from 0.0f; rows past sum(gs) and
    empty groups zero."""
    start = 0
    if op == "dot":
        out = torch.zeros(a.shape[0], b.shape[-1], device="cuda")
    else:
        out = torch.zeros(len(sizes), a.shape[1], b.shape[1], device="cuda")
    for e, n in enumerate(sizes):
        n = max(0, min(n, a.shape[0] - start))
        if n and op == "dot":
            w_nk = b.stride(2) != 1
            wt = b[e].t() if w_nk else b[e]
            out[start:start + n] = trow.row_linear(
                a[start:start + n], wt.contiguous(), w_nk=w_nk)
        elif n:
            out[e] = trow.row_linear(a[start:start + n].t().contiguous(),
                                     b[start:start + n])
        start += n
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c,h,sizes", [
    (700, 96, 160, (0, 301, 99, 0, 250, 50)),
    (700, 96, 160, (0, 301, 99, 0, 250, 17)),
    (32, 768, 3072, (5, 0, 7, 1, 0, 3, 9, 4))],
    ids=["all_rows", "rows_past_sum", "served_decode"])
def test_b8_f32_ring_kernels_match_the_oracle_and_r1(rows, c, h, sizes):
    """f32 on the ring kernels: grouped_dot (w as it lies and read
    transposed, at the tiling the host picks and at every other) and
    grouped_outer, each output poisoned first, bit for bit the oracle (the
    first f32 kernels, ``grouped_*_ref``) and R1's chains a group; rows past
    sum(gs) and empty groups zero; one f32 launch a call."""
    x, w, ct, gs = _b8_operands(_card(), torch.float32, r=rows, c=c, h=h,
                                sizes=sizes)
    for a, b in ((x, w), (ct, w.transpose(1, 2))):
        before = tgm.grouped_dot.launches_f32
        torch.full((a.shape[0] * b.shape[-1] * 4,), 0xFF, dtype=torch.uint8,
                   device="cuda")
        got = tgm.grouped_dot(a, b, gs)
        assert tgm.grouped_dot.launches_f32 == before + 1
        assert torch.equal(got, tgm.grouped_dot_ref(a, b, gs))
        assert torch.equal(got, _r1_groups("dot", a, b, sizes))
        assert torch.all(got[sum(sizes):] == 0)
        for tiling in tgm.F32_TILE_ROWS:
            torch.full((a.shape[0] * b.shape[-1] * 4,), 0xFF,
                       dtype=torch.uint8, device="cuda")
            y, path = tgm._launch_dot(a, b, gs, tiling=tiling)
            assert path == "f32" and torch.equal(y, got), tiling
    torch.full((w.numel() * 4,), 0xFF, dtype=torch.uint8, device="cuda")
    out = tgm.grouped_outer(x, ct, gs)
    assert torch.equal(out, tgm.grouped_outer_ref(x, ct, gs))
    assert torch.equal(out, _r1_groups("outer", x, ct, sizes))
    assert all(torch.all(out[e] == 0) for e, n in enumerate(sizes) if n == 0)


def _b8_path_run(c, h, sizes, path):
    """bf16 grouped_dot (w as it lies and read transposed) and
    grouped_outer at [sum + 40 rows, c] x [G, c, h]: each one launch on
    ``path``'s count ("tma": ``launches``, "ref": ``launches_ref``) and
    none on the other's, in the bf16 band of the plain version and of the
    first kernels; rows past sum(gs) and empty groups zero on poisoned
    outputs."""
    dtype, tol = DTYPES["bf16"]
    x, w, ct, gs = _b8_operands(_card(), dtype, r=sum(sizes) + 40, c=c,
                                h=h, sizes=sizes)
    runs = ((tgm.grouped_dot, tgm.plain_grouped_dot, tgm.grouped_dot_ref,
             x, w),
            (tgm.grouped_dot, tgm.plain_grouped_dot, tgm.grouped_dot_ref,
             ct, w.transpose(1, 2)),
            (tgm.grouped_outer, tgm.plain_grouped_outer,
             tgm.grouped_outer_ref, x, ct))
    for fn, plain, first, a, b in runs:
        before = (fn.launches, fn.launches_ref)
        out = (a.shape[0] * b.shape[-1] if fn is tgm.grouped_dot
               else len(sizes) * a.shape[1] * b.shape[1])
        torch.full((2 * out,), 0xFF, dtype=torch.uint8, device="cuda")
        got = fn(a, b, gs)
        one = (1, 0) if path == "tma" else (0, 1)
        assert (fn.launches - before[0], fn.launches_ref - before[1]) == one
        _close(got, plain(a, b, gs), tol, fn.__name__)
        _close(got, first(a, b, gs), tol, fn.__name__ + " (first kernel)")
        if fn is tgm.grouped_dot:
            assert torch.all(got[sum(sizes):] == 0)
        else:
            assert all(torch.all(got[e] == 0) for e, n in enumerate(sizes)
                       if n == 0)


@pytest.mark.gpu
def test_b8_moe_width_takes_the_tma_path():
    """The MoE layer's widths (C 768, H 3072), 8 experts, one empty and one
    of 60% of the rows: the TMA kernels."""
    _b8_path_run(768, 3072, (1229, 0, 2458, 200, 77, 0, 100, 33), "tma")


@pytest.mark.gpu
def test_b8_unaligned_view_takes_the_first_kernels():
    """C = 100 (rows of 200 bytes, which TMA does not take): the first
    kernels, counted in ``launches_ref``."""
    _b8_path_run(100, 160, (0, 301, 99, 0, 250, 50), "ref")


@pytest.mark.gpu
def test_b8_rows_do_not_depend_on_their_neighbours():
    """f32: a row's output is the same bits alone in its group, among its
    group's rows and among K=2 problems flattened into one call."""
    x, w, _, gs = _b8_operands(_card(), torch.float32)
    full = tgm.grouped_dot(x, w, gs)
    # row 400 is group 4's first (sizes 0, 301, 99, 0, 250, 50)
    one = tgm.grouped_dot(x[400:401], w[4:5],
                          torch.tensor([1], dtype=torch.int32,
                                       device="cuda"))
    assert torch.equal(one[0], full[400])
    two = tgm.grouped_dot(torch.cat([x, x]), torch.cat([w, w]),
                          torch.cat([gs, gs]))
    assert torch.equal(two[:700], full) and torch.equal(two[700:], full)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_b8_gradients_match_the_plain_version(dt):
    """The autograd Functions on the card (ct_x on B8 reading w transposed,
    ct_w on the outer kernel) against the plain versions' autograd."""
    dtype, tol = DTYPES[dt]
    x, w, ct, gs = _b8_operands(_card(), dtype)
    grads = []
    for fn in (tgm.grouped_dot, lambda a, b, s: _plain_dot(a, b, s)):
        a = x.clone().requires_grad_()
        b = w.clone().requires_grad_()
        fn(a, b, gs).backward(ct)
        grads.append((a.grad, b.grad))
    (gx, gw), (px, pw) = grads
    _close(gx, px, tol, "ct_x")
    _close(gw, pw, tol, "ct_w")


def _plain_dot(a, b, gs):
    """The plain version under torch's own autograd."""
    out, start = [], 0
    for e, n in enumerate(gs.tolist()):
        out.append(a[start:start + n] @ b[e])
        start += n
    return torch.cat(out)


@pytest.mark.gpu
def test_moe_layer_on_card_matches_the_cpu():
    """The ragged MoE layer of K=2 nodes (B8 on the card, the plain
    versions on the CPU), f32: output, aux and gradients in the f32 band;
    the decode form's rows equal alone and in a batch."""
    import gym_tpu_torch.models.moe as tmoe
    _card()
    g = torch.Generator().manual_seed(3)
    k, e, c = 2, 4, 64
    params = {"m.router.kernel": torch.randn(k, c, e, generator=g),
              "m.fc_kernel": torch.randn(k, e, c, 4 * c, generator=g) * .05,
              "m.proj_kernel": torch.randn(k, e, 4 * c, c, generator=g) * .05,
              "m.fc_bias": torch.randn(k, e, 4 * c, generator=g) * .05,
              "m.proj_bias": torch.randn(k, e, c, generator=g) * .05}
    x = torch.randn(k, 3, 40, c, generator=g)
    out = {}
    for dev in ("cuda", "cpu"):
        p = {n: t.to(dev).requires_grad_() for n, t in params.items()}
        y, aux = tmoe.moe_mlp(p, "m", x.to(dev), topk=2)
        (y.square().sum() + aux.sum()).backward()
        out[dev] = [y.detach().cpu(), aux.detach().cpu()] + [
            t.grad.cpu() for t in p.values()]
    for a, b in zip(out["cuda"], out["cpu"]):
        _close(a, b, DTYPES["f32"][1], "moe layer")
    one = {n: t[0].cuda() for n, t in params.items()}
    rows = tmoe.moe_mlp(one, "m", x[0].cuda(), rows=True)[0]
    alone = tmoe.moe_mlp(one, "m", x[0, 1:2, 7:8].cuda(), rows=True)[0]
    assert torch.equal(alone[0, 0], rows[1, 7])
