"""Port parity for the long-context attention (TPU kernel B5): the plain
versions ``plain_flash_fwd`` / ``plain_flash_bwd`` of
``gym_tpu_torch.ops.flash_attention``, and its autograd entry, against JAX's
bundled Pallas TPU ``flash_attention`` as ``gym_tpu.ops.flash_attention``
calls it for T > 1024, run on the CPU in the Pallas TPU interpreter.

Two block-size branches: T=2048 takes the tuned blocks (one key block spans
T, so the TPU kernel's single-step body runs: p normalised, then rounded);
T=1152 is not a multiple of 1024 and takes the default 128 blocks
(multi-step body: online softmax, p rounded unnormalised).

Inputs come from a numpy seed, with a node and a batch axis folded into N,
and go to both packages as numpy. Tolerances: f32 o atol 2e-5 / rtol 1e-4
and gradients atol 5e-4 / rtol 1e-3 (only the order of f32 sums differs,
and lse = m + log l against the TPU kernel's separate m and l). In bf16
both sides round p and ds at the same points, but a value on a rounding
boundary can round the other way when the f32 sums differ in order, so
bf16 is held to two bf16 steps: atol 2e-2 / rtol 2e-2. lse is checked
against the f32 logsumexp of the masked scores, atol 1e-4.

The CUDA kernels are compared with the same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gym_tpu.ops.flash_attention as jflash
import gym_tpu_torch.ops.flash_attention as tflash

D = 64
# (K nodes, B rows, H heads) by T: the interpreter's time grows with the
# grid, which the default blocks make 9 x 9 at T=1152
NODES_ROWS_HEADS = {2048: (1, 2, 2), 1152: (2, 1, 1)}
F32_FWD = dict(atol=2e-5, rtol=1e-4)
F32_GRAD = dict(atol=5e-4, rtol=1e-3)
BF16 = dict(atol=2e-2, rtol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(t, dt, seed):
    k, b, h = NODES_ROWS_HEADS[t]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((k, b, h, t, D)).astype(np.float32)
            for _ in range(4)]
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a.reshape(k * b, h, t, D), jdt) for a in arrs],
            [torch.tensor(a).to(tdt).reshape(k * b, h, t, D) for a in arrs])


def _jax_b5(jq, jk, jv, jdo, monkeypatch):
    """o and (dq, dk, dv) of the JAX package's flash attention at T > 1024,
    which is the bundled Pallas TPU kernel, interpreted on the CPU."""
    monkeypatch.setattr(jflash, "_on_tpu", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(jflash.flash_causal_attention, jq, jk, jv)
        grads = vjp(jdo)
    return o, grads


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(jnp.asarray(a, jnp.float32)),
                               b.detach().float().numpy(), err_msg=what,
                               **tol)


def _lse_ref(q, k, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    t = s.shape[-1]
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -np.inf)
    return torch.logsumexp(s, dim=-1, keepdim=True)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("t", [2048, 1152])
def test_plain_pair_matches_bundled_pallas(dt, t, monkeypatch):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(t, dt, seed=t)
    scale = 1.0 / np.sqrt(D)
    jo, jg = _jax_b5(jq, jk, jv, jdo, monkeypatch)
    to, tl = tflash.plain_flash_fwd(tq, tk, tv, scale)
    fwd, grad = (F32_FWD, F32_GRAD) if dt == "f32" else (BF16, BF16)
    assert to.dtype == tq.dtype and tl.dtype == torch.float32
    _close(jo, to, fwd, "o")
    np.testing.assert_allclose(tl.numpy(), _lse_ref(tq, tk, scale).numpy(),
                               atol=1e-4, rtol=0, err_msg="lse")
    tg = tflash.plain_flash_bwd(tq, tk, tv, to, tdo, tl, scale)
    for a, b, name in zip(jg, tg, ("dq", "dk", "dv")):
        assert b.dtype == tq.dtype
        _close(a, b, grad, name)


def test_autograd_entry_matches_bundled_pallas(monkeypatch):
    """``long_causal_attention`` forward and backward through autograd on CPU
    tensors (which run the plain versions) against ``jax.vjp`` (f32)."""
    t = 1152
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(t, "f32", seed=7)
    jo, jg = _jax_b5(jq, jk, jv, jdo, monkeypatch)
    args = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    to = tflash.long_causal_attention(*args)
    tg = torch.autograd.grad(to, args, tdo)
    _close(jo, to, F32_FWD, "o")
    for a, b, name in zip(jg, tg, ("dq", "dk", "dv")):
        _close(a, b, F32_GRAD, name)


@pytest.mark.parametrize("t,d,want", [
    (2048, 64, (1024, 2048, 512, 1024)), (8192, 64, (1024, 2048, 512, 1024)),
    (1152, 64, (128,) * 4), (2048, 128, (128,) * 4),
    (3072, 32, (128,) * 4)])
def test_block_sizes_follow_the_jax_package(t, d, want):
    assert tflash._block_sizes(t, d) == want


def test_wrappers_count_only_card_launches():
    """On the CPU the wrappers run the plain versions and count nothing; the
    dispatch stays dense off the card, as in the JAX package."""
    tflash.reset_launch_counts()
    _, (q, k, v, do) = _inputs(1152, "f32", seed=3)
    o, lse = tflash._flash_fwd(q, k, v, 0.125)
    tflash._flash_bwd(q, k, v, o, do, lse, 0.125)
    y = tflash.flash_causal_attention(q[None], k[None], v[None])
    assert y.shape == (1, *q.shape)
    assert (tflash._flash_fwd.launches, tflash._flash_bwd.launches) == (0, 0)


def test_plain_forward_never_holds_a_full_score_matrix():
    """At T=8192 the plain forward works on [1024, 2048] score blocks and
    skips the blocks above the diagonal: 20 of the 32 (query, key) block
    pairs run, as in the TPU kernel's grid."""
    bq, bk, bqb, bkb = tflash._block_sizes(8192, 64)
    fwd = sum(tflash._runs(i, bq, j, bk) for i in range(8192 // bq)
              for j in range(8192 // bk))
    bwd = sum(tflash._runs(i, bqb, j, bkb) for i in range(8192 // bqb)
              for j in range(8192 // bkb))
    assert (fwd, bwd) == (20, 72)


@pytest.mark.parametrize("call", ["long_causal_attention", "_flash_fwd",
                                  "_flash_bwd"])
def test_b5_wrappers_refuse_t_not_multiple_of_128(call):
    """T = 1088 is a multiple of 64 but not of 128: the plain versions step
    over whole 128-row blocks and would leave the last 64 rows unwritten
    (forward) or without their contributions (backward). The wrappers
    refuse it on CPU tensors, as the bundled kernel refuses blocks that do
    not divide T."""
    x = torch.zeros(1, 1, 1088, D)
    lse = torch.zeros(1, 1, 1088, 1)
    fn = {"long_causal_attention": lambda: tflash.long_causal_attention(
              x, x, x),
          "_flash_fwd": lambda: tflash._flash_fwd(x, x, x, 0.125),
          "_flash_bwd": lambda: tflash._flash_bwd(x, x, x, x, x, lse, 0.125)}
    with pytest.raises(ValueError, match="multiple of 128"):
        fn[call]()


def _kernel_rounding_fwd(q, k, v, scale, bk=64):
    """The bf16 card forward's rounding order in torch, 64 query rows a
    warpgroup against ``bk``-key tiles: scores in f32, a running row max
    per key tile, p = exp(s − m) unnormalised and rounded to bf16 for the
    PV product, l from the unrounded p, the accumulator rescaled at each
    tile and divided by l at the end. Vectorised over the query tiles: key
    tile j updates every row at or after it."""
    n, h, t, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((n, h, t, 1), -np.inf)
    l = torch.zeros((n, h, t, 1))
    acc = torch.zeros((n, h, t, d))
    for j in range(t // bk):
        rows, cols = slice(j * bk, t), slice(j * bk, (j + 1) * bk)
        s = torch.matmul(qf[:, :, rows], kf[:, :, cols].transpose(-1, -2))
        s = s * scale
        diag = torch.ones(bk, bk, dtype=torch.bool).triu(1)
        s[:, :, :bk] = s[:, :, :bk].masked_fill(diag, -np.inf)
        m_new = torch.maximum(m[:, :, rows], s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m[:, :, rows] - m_new)
        p = torch.exp(s - m_new)
        l[:, :, rows] = l[:, :, rows] * alpha + p.sum(dim=-1, keepdim=True)
        acc[:, :, rows] = acc[:, :, rows] * alpha + torch.matmul(
            p.to(torch.bfloat16).float(), vf[:, :, cols])
        m[:, :, rows] = m_new
    return (acc / l).to(q.dtype), m + torch.log(l)


def _within_phase3(a, b, what):
    """chip_smoke.py phase 3's bf16 tolerance, elementwise:
    |a − b| ≤ 0.05·rms(b) + 0.02·|b|."""
    a, b = a.float(), b.float()
    limit = 0.05 * b.square().mean().sqrt() + 0.02 * b.abs()
    over = ((a - b).abs() > limit).sum().item()
    assert over == 0, (f"{what}: {over} elements outside, max abs err "
                       f"{(a - b).abs().max().item():.3e}")


@pytest.mark.parametrize("t", [2048, 1152])
def test_kernel_rounding_order_fits_phase3_tolerance(t, monkeypatch):
    """The card forward rounds p unnormalised at each 64-key tile, where
    the bundled kernel at T = 2048 (one key block) normalises first: held
    to the bundled Pallas kernel (interpreted) and to ``plain_flash_fwd``
    under phase 3's bf16 tolerance, lse within phase 3's 1e-4 + 1e-5·|b|."""
    (jq, jk, jv, jdo), (tq, tk, tv, _) = _inputs(t, "bf16", seed=t + 1)
    scale = 1.0 / np.sqrt(D)
    jo, _ = _jax_b5(jq, jk, jv, jdo, monkeypatch)
    eo, el = _kernel_rounding_fwd(tq, tk, tv, scale)
    po, pl = tflash.plain_flash_fwd(tq, tk, tv, scale)
    _within_phase3(eo, torch.from_numpy(np.asarray(jo, np.float32)),
                   "o against the bundled kernel")
    _within_phase3(eo, po, "o against plain_flash_fwd")
    assert ((el - pl).abs() <= 1e-4 + 1e-5 * pl.abs()).all()
