"""Quantized serving's pieces in the port against ``gym_tpu`` on the CPU:
the same numpy-seeded weights and inputs through both packages.

- ``quantize_params``: the port's flat tree equals the JAX tree carried
  across by ``convert.serving_params_from_jax`` bit for bit (int8 values,
  f32 scales), int8 and int4, with and without ``quant_embed``, at widths
  where ``quant_tile_for`` clamps the tile; ``params_are_quantized`` on
  both trees; ``serving_params_from_jax`` keeps the int8 leaves int8;
- the int8 KV codec (``kv_quantize``/``kv_dequantize``) bit for bit
  against JAX's jitted, on all-zero head vectors, exact half-way ties, NaN
  and inf;
- ``dequantize_tiles`` bit for bit; ``quantized_dot``/``quantized_attend``
  (B6's plain version) within the decode tests' tolerance of JAX's, in both
  layouts at a clamped tile, and bit for bit R1's plain version on the
  dequantized weight (B6's contract); B7 int8's plain version bit for bit
  B7's on the dequantized pools, a NaN scale reaching only its row;
- the evaluation loss of a quantized tree against
  ``GPT(qcfg).apply(..., train=False)`` (f32, rtol 5e-5); training one
  raises; decode logits under int8 weights and int8 KV against JAX's
  decode, unpaged and paged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_tpu.ops import fused_attention as jfa
from gym_tpu.ops import grouped_matmul as jgm
from gym_tpu.serve.load import params_are_quantized as j_are_quantized
from gym_tpu.serve.load import quantize_params as j_quantize
from gym_tpu_torch.convert import params_from_jax, serving_params_from_jax
from gym_tpu_torch.models import nanogpt as T
from gym_tpu_torch.ops import decode_attention as tdec
from gym_tpu_torch.ops import fused_attention as tfa
from gym_tpu_torch.ops import grouped_matmul as tgm
from gym_tpu_torch.ops.row_linear import plain_row_linear, row_qlinear
from gym_tpu_torch.serve.load import params_are_quantized, quantize_params
from test_torch_decode import J, numpy_params, port_config

V = 48


def _bits_equal(got: torch.Tensor, ref) -> bool:
    ref = torch.as_tensor(np.array(ref))
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False
    if got.is_floating_point():
        return torch.equal(got.view(torch.int32), ref.view(torch.int32))
    return torch.equal(got, ref)


@pytest.fixture(scope="module")
def trees():
    """Flax trees of two widths: n_embd 48 at quant_tile 40 (the tiles
    clamp to 24, 36 and 32 of rows of 48, 144 and 192) and n_embd 100 at
    the default 256 (150 of rows of 300, 100 of 100)."""
    out = {}
    for width, tile in ((48, 40), (100, 256)):
        cfg = J.GPTConfig(block_size=32, vocab_size=V, n_layer=2, n_head=2,
                          n_embd=width, quant_tile=tile)
        out[width] = (cfg, numpy_params(cfg, width))
    return out


@pytest.mark.parametrize("embed", [False, True], ids=["blocks", "embed"])
@pytest.mark.parametrize("bits", ["int8", "int4"])
@pytest.mark.parametrize("width", [48, 100])
def test_quantize_params_bit_exact(trees, width, bits, embed):
    cfg, params = trees[width]
    qcfg = dataclasses.replace(cfg, weights_dtype=bits, quant_embed=embed)
    ref = serving_params_from_jax(j_quantize(params, qcfg), "cpu")
    got = quantize_params(serving_params_from_jax(params, "cpu"),
                          port_config(qcfg))
    assert set(got) == set(ref)
    for name, r in ref.items():
        assert _bits_equal(got[name], r), name
    qmax = 127 if bits == "int8" else 7
    q = got["h_0.mlp.c_fc.qkernel"]
    assert q.dtype == torch.int8 and int(q.abs().max()) == qmax
    t = tgm.quant_tile_for(q.shape, cfg.quant_tile)
    assert got["h_0.mlp.c_fc.qscale"].numel() * t == q.numel()
    assert ("wte.qembedding" in got) == embed
    assert got["wpe.embedding"].dtype == torch.float32
    assert params_are_quantized(got) and j_are_quantized(
        j_quantize(params, qcfg))
    assert not params_are_quantized(serving_params_from_jax(params, "cpu"))
    assert quantize_params(got, port_config(cfg)) is got     # f32: a no-op


def test_serving_params_from_jax_keeps_integer_leaves(trees):
    cfg, params = trees[48]
    qtree = j_quantize(params, dataclasses.replace(cfg, weights_dtype="int8",
                                                   quant_embed=True))
    flat = serving_params_from_jax(qtree, "cpu")
    assert flat["wte.qembedding"].dtype == torch.int8
    assert flat["h_1.attn.c_proj.qkernel"].dtype == torch.int8
    assert flat["h_1.attn.c_proj.qscale"].dtype == torch.float32
    assert flat["h_1.attn.c_proj.bias"].dtype == torch.float32
    assert flat["wpe.embedding"].dtype == torch.float32
    assert _bits_equal(flat["h_1.attn.c_proj.qkernel"],
                       qtree["h_1"]["attn"]["c_proj"]["qkernel"])


def test_quant_tile_for_matches():
    for shape in ((48, 144), (100, 300), (768, 2304), (50304, 768),
                  (3072, 768), (7, 13)):
        for tile in (1, 40, 256, 10_000):
            assert tgm.quant_tile_for(shape, tile) == \
                jgm.quant_tile_for(shape, tile)


def _kv_inputs():
    """[2, 5, 3, 8] K/V chunks: random head vectors, an all-zero one,
    exact half-way ties (amax 127 gives scale 1.0: 0.5, 1.5, 2.5, -2.5
    round half to even), one NaN, one inf."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[1, 2, 0, 3] = np.nan
    x[1, 3, 2, 5] = np.inf
    x[1, 4, 1] = -x[1, 4, 1] * 1e-30
    return x


def test_kv_quantize_bit_exact():
    """Against ``kv_quantize`` jitted, as the JAX decode programs run it
    (XLA turns its division by 127 into a multiply by the reciprocal)."""
    x = _kv_inputs()
    jq, js = jax.jit(jfa.kv_quantize)(jnp.asarray(x))
    tq, ts = tfa.kv_quantize(torch.from_numpy(x))
    assert _bits_equal(tq, jq) and _bits_equal(ts, js)
    assert tq[0, 1, 1].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    assert tq[0, 0, 0].abs().sum() == 0 and ts[0, 0, 0] == 1.0
    assert tq[1, 2, 0, 3] == 0 and ts[1, 2, 0] == 1.0     # NaN: as XLA
    assert _bits_equal(tfa.kv_dequantize(tq, ts),
                       jfa.kv_dequantize(jq, js))
    assert tfa.KV_QMAX == jfa.KV_QMAX == 127


def test_dequantize_tiles_bit_exact(trees):
    cfg, params = trees[48]
    qtree = j_quantize(params, dataclasses.replace(cfg, weights_dtype="int4",
                                                   quant_embed=True))
    for leaf in (qtree["h_0"]["mlp"]["c_proj"], qtree["wte"]):
        q = leaf.get("qkernel", leaf.get("qembedding"))
        ref = jgm.dequantize_tiles(q, leaf["qscale"])
        got = tgm.dequantize_tiles(torch.from_numpy(np.array(q)),
                                   torch.from_numpy(np.array(
                                       leaf["qscale"])))
        assert _bits_equal(got, ref)


@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_quantized_dot_and_attend_match_jax(trees, layout):
    """B6's plain version in both layouts at clamped tiles: within the
    decode tests' tolerance of JAX's dot (|a − b| <= 2e-5 + 1e-5·|b|), and
    bit for bit R1's plain version on the dequantized weight."""
    cfg, params = trees[48]
    qcfg = dataclasses.replace(cfg, weights_dtype="int8", quant_embed=True)
    qtree = j_quantize(params, qcfg)
    leaf = qtree["h_1"]["attn"]["c_attn"] if layout == "kn" else qtree["wte"]
    q = leaf.get("qkernel", leaf.get("qembedding"))
    x = np.random.default_rng(5).normal(size=(3, 5, 48)).astype(np.float32)
    tq = torch.from_numpy(np.array(q))
    ts = torch.from_numpy(np.array(leaf["qscale"]))
    if layout == "kn":
        ref = jgm.quantized_dot(jnp.asarray(x), q, leaf["qscale"])
        bias = torch.from_numpy(np.array(leaf["bias"]))
        got = tgm.quantized_dot(torch.from_numpy(x), tq, ts)
        with_bias = tgm.quantized_dot(torch.from_numpy(x), tq, ts, bias)
        assert torch.equal(with_bias, got + bias)
    else:
        ref = jgm.quantized_attend(jnp.asarray(x), q, leaf["qscale"])
        got = tgm.quantized_attend(torch.from_numpy(x), tq, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-5)
    w = tgm.dequantize_tiles(tq, ts)
    r1 = plain_row_linear(torch.from_numpy(x).reshape(-1, 48), w,
                          w_nk=layout == "nk").view(got.shape)
    assert torch.equal(got, r1)


def test_row_qlinear_and_b7_int8_check_their_inputs():
    x = torch.zeros(2, 8)
    q = torch.zeros(8, 6, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        row_qlinear(x, q.float(), torch.ones(8))
    with pytest.raises(ValueError, match="tile"):
        row_qlinear(x, q, torch.ones(5))                  # 48 / 5
    with pytest.raises(ValueError, match="divide"):
        row_qlinear(x, q, torch.ones(12))                 # t 4 on rows of 6
    with pytest.raises(ValueError, match="float32"):
        row_qlinear(x.double(), q, torch.ones(8))
    pool = torch.zeros(3, 4, 2, 16, dtype=torch.int8)
    sc = torch.ones(3, 4, 2)
    qq = torch.zeros(1, 1, 2, 16)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    cur = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        tdec.decode_attention(qq, pool, pool, bt, cur)
    with pytest.raises(ValueError, match="int8"):
        tdec.decode_attention_int8(qq, pool.float(), pool.float(), sc, sc,
                                   bt, cur)
    with pytest.raises(ValueError, match="scale pools"):
        tdec.decode_attention_int8(qq, pool, pool, sc[..., :1], sc, bt, cur)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "unpaged"])
def test_b7_int8_plain_is_b7_on_dequantized_pools(paged):
    rng = np.random.default_rng(9)
    h, hd, page = 2, 16, 4
    kv = torch.from_numpy(rng.normal(size=(2, 6, page, h, hd)).astype(
        np.float32))
    (kq, ks), (vq, vs) = tfa.kv_quantize(kv[0]), tfa.kv_quantize(kv[1])
    q = torch.from_numpy(rng.normal(size=(2, 3, h, hd)).astype(np.float32))
    if paged:
        bt = torch.tensor([[3, 1, 5], [2, 4, 0]], dtype=torch.int32)
    else:
        kq, vq = kq[:2].reshape(2, -1, h, hd), vq[:2].reshape(2, -1, h, hd)
        ks, vs = ks[:2].reshape(2, -1, h), vs[:2].reshape(2, -1, h)
        bt = tdec.unpaged_table(2, "cpu")
    cur = torch.tensor([5, 2], dtype=torch.int32)
    got = tdec.decode_attention_int8(q, kq, vq, ks, vs, bt, cur)
    ref = tdec.decode_attention(q, tfa.kv_dequantize(kq, ks),
                                tfa.kv_dequantize(vq, vs), bt, cur)
    assert torch.equal(got, ref)
    # a NaN scale at row 1's position 1 reaches row 1 only
    ks = ks.clone()
    if paged:
        ks[2, 1, 0] = float("nan")
    else:
        ks[1, 1, 0] = float("nan")
    got = tdec.decode_attention_int8(q, kq, vq, ks, vs, bt, cur)
    assert torch.isnan(got[1, :, 0]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1, :, 1]).all()


@pytest.fixture(scope="module")
def small():
    cfg = J.GPTConfig(block_size=32, vocab_size=V, n_layer=2, n_head=2,
                      n_embd=32)
    params = numpy_params(cfg, 21)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, V, (2, 3, 16)).astype(np.int32)
    tgt = rng.integers(-1, V, (2, 3, 16)).astype(np.int32)
    return cfg, params, idx, tgt


@pytest.mark.parametrize("bits,embed", [("int8", False), ("int4", True)])
def test_eval_loss_on_quantized_tree(small, bits, embed):
    cfg, params, idx, tgt = small
    qcfg = dataclasses.replace(cfg, weights_dtype=bits, quant_embed=embed)
    qtree = j_quantize(params, qcfg)
    apply = jax.jit(J.GPT(qcfg).apply, static_argnames="train")
    model = T.GPT(port_config(qcfg))
    stacked = params_from_jax(qtree, num_nodes=2)      # int8 leaves as f32
    stacked = {n: (p.to(torch.int8) if n.endswith(("qkernel", "qembedding"))
                   else p) for n, p in stacked.items()}
    with torch.no_grad():
        got = model(stacked, (torch.from_numpy(idx).long(),
                              torch.from_numpy(tgt).long()), train=False)
    for k in range(2):
        ref = float(apply({"params": qtree}, (idx[k], tgt[k]), train=False))
        np.testing.assert_allclose(float(got[k]), ref, rtol=5e-5)
    with pytest.raises(ValueError, match="inference-only"):
        model(stacked, (torch.from_numpy(idx).long(),
                        torch.from_numpy(tgt).long()), train=True)


@pytest.mark.parametrize("paged", [False, True], ids=["unpaged", "paged"])
def test_decode_logits_int8_weights_and_kv_match_jax(small, paged):
    """A prefill then two single-token steps under int8 weights, int8
    embedding and int8 KV: the port's decode logits against the JAX decode
    model's, |a − b| <= 2e-5 + 1e-5·|b|."""
    cfg, params, idx, _ = small
    qcfg = dataclasses.replace(J.decode_config(cfg), weights_dtype="int8",
                               kv_dtype="int8", quant_embed=True)
    kw, tkw = {}, {}
    if paged:
        qcfg = dataclasses.replace(qcfg, page_size=8, kv_pages=10)
        bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
        kw = dict(block_table=bt)
        tkw = dict(block_table=torch.from_numpy(bt))
    qtree = j_quantize(params, qcfg)
    tp = serving_params_from_jax(qtree, "cpu")
    jm, tm = J.GPT(qcfg), T.GPT(port_config(qcfg))
    japply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    tcache = tm.init_cache(2, "cpu")
    variables = {"params": qtree}
    if paged:
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((2, 1), jnp.int32), train=False,
            block_table=bt, cache_pos=jnp.zeros(2, jnp.int32)))
        variables["cache"] = jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes["cache"])
    toks = idx[0, :2]
    pos = np.zeros(2, np.int32)
    for chunk in (toks[:, :9], toks[:, 9:10], toks[:, 10:11]):
        if paged:
            kw["cache_pos"] = pos
            tkw["cache_pos"] = torch.from_numpy(pos)
        ref, vc = japply(variables, chunk, train=False, mutable=("cache",),
                         **kw)
        variables = {"params": qtree, "cache": vc["cache"]}
        got = tm.decode(tp, torch.from_numpy(chunk), tcache, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=2e-5)
        pos = pos + chunk.shape[1]
    assert tcache["h_0.attn.k"].dtype == torch.int8
    assert tcache["h_0.attn.k_scale"].dtype == torch.float32
    if not paged:
        # the written positions' scales (K itself agrees to the projection's
        # rounding, not bit for bit)
        np.testing.assert_allclose(
            tcache["h_0.attn.k_scale"][:, :11].numpy(),
            np.asarray(variables["cache"]["h_0"]["attn"]["k_scale"])[:, :11],
            rtol=1e-5)
