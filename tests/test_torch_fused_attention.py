"""Port parity: the plain versions of the four fused attention kernels in
``gym_tpu_torch.ops.fused_attention`` against the Pallas kernels of
``gym_tpu.ops.fused_attention`` run in the Pallas interpreter.

Inputs come from a numpy seed and go to both packages as numpy. Tolerances:
f32 forward atol 2e-5 / rtol 1e-4, f32 gradients atol 5e-4 / rtol 1e-3 (only
the summation order differs). In bf16 both sides round p and ds at the same
points, but a value that sits on a rounding boundary in one package can
round the other way in the other (the f32 sums differ in order), so bf16 is
held to a band of two bf16 steps: atol 2e-2 / rtol 2e-2 on o, dq, dk, dv
and atol 1e-4 on the f32 lse.

The card's kernels are compared with the same plain versions on the card
by ``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_tpu.ops.fused_attention as jfa
import gym_tpu_torch.ops.fused_attention as tfa

B, H, T, D = 2, 3, 128, 16
F32_FWD = dict(atol=2e-5, rtol=1e-4)
F32_GRAD = dict(atol=5e-4, rtol=1e-3)
BF16 = dict(atol=2e-2, rtol=2e-2)
BF16_LSE = dict(atol=1e-4, rtol=0)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _arrays(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _both(arrs, dt):
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.tensor(a).to(tdt) for a in arrs])


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(jnp.asarray(a, jnp.float32)),
                               b.float().numpy(), err_msg=what, **tol)


def _tols(dt):
    if dt == "f32":
        return F32_FWD, F32_FWD, F32_GRAD
    return BF16, BF16_LSE, BF16


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_packed_pair_matches_pallas(dt):
    """B1 and B2 (`_fwd_packed`, `_bwd_packed`) on the packed layout."""
    scale = 1.0 / np.sqrt(D)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(
        _arrays(0, (B, T, H * D), 4), dt)
    jo, jl = jfa._fwd_packed(jq, jk, jv, scale, H)
    to, tl = tfa._fwd_packed(tq, tk, tv, scale, H)
    fwd, lse_tol, grad = _tols(dt)
    _close(jo, to, fwd, "o")
    _close(jl, tl, lse_tol, "lse")
    jg = jfa._bwd_packed(jq, jk, jv, jo, jdo, jl, scale, H)
    tg = tfa._bwd_packed(tq, tk, tv, to, tdo, tl, scale, H)
    for a, b, name in zip(jg, tg, ("dq", "dk", "dv")):
        _close(a, b, grad, name)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_dlse", [False, True])
def test_block_pair_matches_pallas(dt, causal, with_dlse):
    """B3 and B4 (`_blk_fwd`, `_blk_bwd`) on [B, H, T, D], causal or the full
    block, with and without an lse cotangent."""
    scale = 1.0 / np.sqrt(D)
    arrs = _arrays(1, (B, H, T, D), 4)
    dlse_np = np.random.default_rng(2).standard_normal((B, H, T, 1)).astype(
        np.float32)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrs, dt)
    jo, jl = jfa._blk_fwd(jq, jk, jv, scale, causal)
    to, tl = tfa._blk_fwd(tq, tk, tv, scale, causal)
    fwd, lse_tol, grad = _tols(dt)
    _close(jo, to, fwd, "o")
    _close(jl, tl, lse_tol, "lse")
    jd = jnp.asarray(dlse_np if with_dlse else np.zeros_like(dlse_np))
    td = torch.tensor(dlse_np) if with_dlse else None
    jg = jfa._blk_bwd(jq, jk, jv, jo, jdo, jl, jd, scale, causal)
    tg = tfa._blk_bwd(tq, tk, tv, to, tdo, tl, td, scale, causal)
    for a, b, name in zip(jg, tg, ("dq", "dk", "dv")):
        _close(a, b, grad, name)


def _jax_grads(fn, args, cot):
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(cot)


def _torch_grads(fn, args, cot):
    args = [a.clone().requires_grad_(True) for a in args]
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    grads = torch.autograd.grad(outs, args, cots)
    return out, grads


def test_public_autograd_functions_match_custom_vjp():
    """The three public names, forward and backward, through autograd
    against JAX's custom_vjp (f32)."""
    arrs = _arrays(3, (B, H, T, D), 4)
    dlse = np.random.default_rng(4).standard_normal((B, H, T, 1)).astype(
        np.float32)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both(arrs, "f32")

    jo, jg = _jax_grads(jfa.fused_causal_attention, (jq, jk, jv), jdo)
    to, tg = _torch_grads(tfa.fused_causal_attention, (tq, tk, tv), tdo)
    _close(jo, to.detach(), F32_FWD, "fused_causal_attention o")
    for a, b in zip(jg, tg):
        _close(a, b, F32_GRAD, "fused_causal_attention grads")

    jo, jg = _jax_grads(lambda q, k, v: jfa.fused_block_attention(
        q, k, v, False), (jq, jk, jv), (jdo, jnp.asarray(dlse)))
    to, tg = _torch_grads(lambda q, k, v: tfa.fused_block_attention(
        q, k, v, False), (tq, tk, tv), (tdo, torch.tensor(dlse)))
    _close(jo[0], to[0].detach(), F32_FWD, "fused_block_attention o")
    _close(jo[1], to[1].detach(), F32_FWD, "fused_block_attention lse")
    for a, b in zip(jg, tg):
        _close(a, b, F32_GRAD, "fused_block_attention grads")

    pq, pk, pv, pdo = _arrays(5, (B, T, H * D), 4)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both([pq, pk, pv, pdo], "f32")
    jo, jg = _jax_grads(lambda q, k, v: jfa.fused_causal_attention_packed(
        q, k, v, H), (jq, jk, jv), jdo)
    to, tg = _torch_grads(lambda q, k, v: tfa.fused_causal_attention_packed(
        q, k, v, H), (tq, tk, tv), tdo)
    _close(jo, to.detach(), F32_FWD, "packed o")
    for a, b in zip(jg, tg):
        _close(a, b, F32_GRAD, "packed grads")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("t", [64, 128, 256, 384, 1024, 2048])
def test_gates_agree_with_jax(dt, t):
    """The copied gates route every shape to the same pair as JAX."""
    jdt, tdt = DTYPES[dt]
    for b in (1, 2, 4, 6, 16, 64):
        assert tfa._batch_chunk(b, t) == jfa._batch_chunk(b, t)
        assert tfa._packed_chunk(b, t) == jfa._packed_chunk(b, t)
        for c, nh in ((48, 3), (128, 4), (768, 12), (100, 3)):
            jq = jax.ShapeDtypeStruct((b, t, c), jdt)
            tq = torch.empty((b, t, c), dtype=tdt, device="meta")
            assert tfa.fused_supported(tq) == jfa.fused_supported(jq)
            assert (tfa.packed_supported(tq, nh)
                    == jfa.packed_supported(jq, nh)), (b, t, c, nh)


def test_gates_route_the_slice_shapes():
    """Flagship (per-node 16×256×128 bf16) takes the packed pair; GPT-2
    base (4×1024×768) is refused by the packed gate and takes the per-head
    pair."""
    flag = torch.empty((16, 256, 128), dtype=torch.bfloat16, device="meta")
    base = torch.empty((4, 1024, 768), dtype=torch.bfloat16, device="meta")
    assert tfa.packed_supported(flag, 4)
    assert not tfa.packed_supported(base, 12)
    assert tfa.fused_supported(base)


def test_wrappers_count_only_card_launches():
    """On the CPU the wrappers run the plain versions and count nothing."""
    tfa.reset_launch_counts()
    q, k, v = (torch.tensor(a) for a in _arrays(6, (B, T, H * D), 3))
    o, lse = tfa._fwd_packed(q, k, v, 0.25, H)
    tfa._bwd_packed(q, k, v, o, o, lse, 0.25, H)
    assert (tfa._fwd_packed.launches, tfa._bwd_packed.launches,
            tfa._blk_fwd.launches, tfa._blk_bwd.launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dense_attention_and_cpu_dispatch_match_jax(dt):
    """``dense_causal_attention`` (f32 softmax, finfo.min mask) against the
    JAX package's, with a leading node dimension; off the card the flash
    dispatch is dense too, and the packed path declines."""
    from gym_tpu.ops.attention import dense_causal_attention as jdense
    from gym_tpu_torch.ops.attention import causal_attention
    from gym_tpu_torch.ops.flash_attention import (
        packed_flash_attention_or_none)
    arrs = _arrays(7, (2, B, H, T, D), 3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrs, dt)
    want = jax.vmap(jdense)(jq, jk, jv)
    tol = F32_FWD if dt == "f32" else BF16
    for impl in ("dense", "flash"):
        _close(want, causal_attention(tq, tk, tv, impl=impl), tol, impl)
    packed = tq.transpose(2, 3).reshape(2, B, T, H * D)
    assert packed_flash_attention_or_none(packed, packed, packed, H) is None


def _projection_views(dt, skew=0, extra=0):
    """q as the model passes it: a per-head [N, H, T, D] view of a
    projection with a 16-byte-multiple token stride, here started ``skew``
    elements in or with ``extra`` columns more (both 0 on the main path)."""
    qkv = torch.zeros(2, T, 3 * H * D + 8 + extra, dtype=dt)[..., skew:]
    return qkv[..., :H * D].unflatten(-1, (H, D)).transpose(1, 2)


@pytest.mark.parametrize("case,dt,refused", [
    ("main path", torch.bfloat16, False),
    ("main path", torch.float32, False),
    ("base one element in", torch.bfloat16, True),
    ("base one element in", torch.float32, False),
    ("token stride not 16 bytes", torch.bfloat16, True),
])
def test_check_refuses_unaligned_bf16_views(case, dt, refused):
    """The bf16 kernels copy rows with 16-byte cp.async: ``_check`` refuses
    a bf16 view whose base or strides are not 16-byte aligned; f32 takes
    any such view (its kernels then copy 4 bytes at a time)."""
    skew = 1 if case == "base one element in" else 0
    extra = 2 if case == "token stride not 16 bytes" else 0
    q = _projection_views(dt, skew, extra)
    if refused:
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa._check((q, q, q), 2, H, T, D, "attention forward")
    else:
        tfa._check((q, q, q), 2, H, T, D, "attention forward")
