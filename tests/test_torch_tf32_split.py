"""The precision design of the f32 attention kernels, on the CPU.

The card's f32 kernels (``csrc/fused_attention.cu``, namespace ``x3``) run
split-precision TF32: each operand x is held as hi = tf32(x) and lo =
tf32(x − hi), with tf32 the PTX conversion ``cvt.rna.tf32.f32`` (round to
nearest, ties away from zero, to 10 stored mantissa bits), and each product
is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi on the tensor cores. This file

- holds a bit-level emulation of ``cvt.rna.tf32.f32`` (on the int32 view)
  to an independent float64 reference, on ties, subnormals, ±0, ±inf, NaN
  and values that round up into the next binade;
- runs the forward and backward with every product emulated that way
  (operands split as the kernels split them, products summed in float64)
  at the packed and per-head layouts, D ∈ {16, 32, 64, 128}, T = 128, and
  holds them to ``chip_smoke.py``'s phase-3 f32 tolerance against the
  port's plain versions and against ``gym_tpu``'s Pallas kernels in the
  Pallas interpreter;
- shows that single-pass TF32 (each operand rounded once, one product)
  fails that tolerance on lse on the same inputs: the tolerance tells the
  two designs apart.

Tolerances (phase 3's, unchanged), elementwise |a − b| <= atol + rtol·|b|:
o, dq, dk, dv atol 5e-5, rtol 1e-4 — f32 summation order alone moves them
by about 1e-6 at these sizes, and 3xTF32's error (about 2^-21 relative a
product) is of that order; lse atol 1e-5, rtol 1e-6 — lse is a log of a
sum of exponentials of the scores, so a score error of ε moves it by at
most ε, and single-pass TF32's score error (2^-11 relative to |q|·|k|, a
few 1e-4 here) is far outside it. The emulation sums in float64 where the
card sums in f32, so its margin is larger than the card's: the card's own
errors are printed by ``chip_smoke.py`` (phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_tpu.ops.fused_attention as jfa
import gym_tpu_torch.ops.fused_attention as tfa

N, H, T = 2, 4, 128
HEAD_DIMS = (16, 32, 64, 128)
LAYOUTS = ("packed", "heads_causal", "heads_full_dlse")
OUT_TOL = dict(atol=5e-5, rtol=1e-4)
LSE_TOL = dict(atol=1e-5, rtol=1e-6)


@pytest.fixture(autouse=True)
def interpret_mode():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


# -- the conversion --------------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on the int32 view of f32 ``x``: add half the
    unit of the 13 dropped bits to the sign-magnitude pattern (ties round
    away from zero; a carry runs into the exponent, and past the largest
    finite value to inf) and clear them; NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(x.isnan(), x, out)


def tf32_reference(x: np.ndarray) -> np.ndarray:
    """The same rounding in float64 arithmetic: 11 significant bits (the
    quantum 2^(e−11) of a value in [2^(e−1), 2^e)), and below the smallest
    normal f32 the fixed quantum 2^-136 (f32's subnormal quantum 2^-149
    times the 2^13 dropped); ties away from zero."""
    out = np.empty_like(x)
    with np.errstate(invalid="ignore"):  # signalling NaNs
        wide = x.astype(np.float64)
    for i, v in enumerate(wide):
        if not np.isfinite(v) or v == 0.0:
            out[i] = v
            continue
        e = np.frexp(abs(v))[1]
        quantum = 2.0 ** max(e - 11, -136)
        r = np.floor(abs(v) / quantum + 0.5) * quantum
        out[i] = np.copysign(np.inf if r >= 2.0 ** 128 else r, v)
    return out.astype(np.float32)


def _from_bits(*patterns):
    return np.array(patterns, dtype=np.uint32).view(np.float32)


CASES = {
    # exactly half a unit above 1, ±, and either side of it
    "ties": _from_bits(0x3F801000, 0xBF801000, 0x3F803000, 0x3F800FFF,
                       0x3F801001, 0x40A01000, 0x3E7FF000),
    # the smallest subnormal, a subnormal tie, the largest subnormal (which
    # rounds up to the smallest normal) and the smallest normal
    "subnormals": _from_bits(0x00000001, 0x00001000, 0x00003000, 0x00000FFF,
                             0x007FFFFF, 0x80001000, 0x00800000, 0x00801000),
    "zeros_infs_nan": _from_bits(0x00000000, 0x80000000, 0x7F800000,
                                 0xFF800000, 0x7FC00000, 0x7F800001,
                                 0xFFFFFFFF),
    # all 13 low bits set below a binade's end: the carry reaches the
    # exponent; the largest finite f32 rounds to inf
    "next_binade": _from_bits(0x3FFFFFFF, 0xBFFFFFFF, 0x3F7FF000, 0x7F7FFFFF,
                              0x7F7FEFFF, 0x00FFF000, 0x4B7FFFFF),
    "random": np.random.default_rng(0).integers(
        0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32).view(
            np.float32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32_emulation_matches_float64_reference(case):
    x = CASES[case]
    got = tf32(torch.tensor(x)).numpy()
    want = tf32_reference(x)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32),
                          want[~nan].view(np.uint32))
    finite = np.isfinite(x)
    hi = tf32(torch.tensor(x[finite]))
    lo = tf32(torch.tensor(x[finite]) - hi)
    for part in (hi, lo):  # both halves are TF32 values: low 13 bits zero
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()


# -- attention with emulated products --------------------------------------


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernels compute it: the three split products, each
    summed in float64 here."""
    (ah, al), (bh, bl) = split(a), split(b)
    f64 = lambda u, v: torch.matmul(u.double(), v.double())  # noqa: E731
    return (f64(al, bh) + f64(ah, bl) + f64(ah, bh)).float()


def mm_tf32(a, b):
    """a @ b in single-pass TF32: each operand rounded once."""
    return torch.matmul(tf32(a).double(), tf32(b).double()).float()


def emulated_fwd(mm, q, k, v, scale, causal):
    """[N, H, T, D] → (o, lse [N, H, T, 1]) with every product through
    ``mm``; the softmax in f32 (the kernels' one-pass softmax differs by
    f32 reordering only)."""
    s = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        s = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), s,
                        -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, m + torch.log(l)


def emulated_bwd(mm, q, k, v, o, do, lse, dlse, scale, causal):
    s = mm(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - lse)
    if causal:
        p = torch.where(torch.ones(T, T, dtype=torch.bool).tril(), p, 0.0)
    dv = mm(p.transpose(-1, -2), do)
    dp = mm(do, v.transpose(-1, -2))
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (dp - delta + (0.0 if dlse is None else dlse)) * scale
    return mm(ds, k), mm(ds.transpose(-1, -2), q), dv


def _inputs(layout, d):
    rng = np.random.default_rng(d + 7 * LAYOUTS.index(layout))
    shape = (N, T, H * d) if layout == "packed" else (N, H, T, d)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    dlse = (rng.standard_normal((N, H, T, 1)).astype(np.float32)
            if layout == "heads_full_dlse" else None)
    return arrs, dlse


def _reference_fwd(layout, arrs, scale):
    """(o, lse) of the port's plain version and of the Pallas kernel, both
    per-head [N, H, T, ...] CPU tensors."""
    q, k, v = arrs[:3]
    if layout == "packed":
        to, tl = tfa.plain_fwd_packed(*map(torch.tensor, (q, k, v)), scale,
                                      H)
        jo, jl = jfa._fwd_packed(*map(jnp.asarray, (q, k, v)), scale, H)
        return ((tfa._heads(to, H), tl.transpose(1, 2)[..., None]),
                (tfa._heads(torch.tensor(np.asarray(jo)), H),
                 torch.tensor(np.asarray(jl)).transpose(1, 2)[..., None]))
    causal = layout == "heads_causal"
    plain = tfa.plain_fwd(*map(torch.tensor, (q, k, v)), scale, causal)
    jo, jl = jfa._blk_fwd(*map(jnp.asarray, (q, k, v)), scale, causal)
    return plain, (torch.tensor(np.asarray(jo)), torch.tensor(np.asarray(jl)))


def _reference_bwd(layout, arrs, o, lse, dlse, scale):
    """(dq, dk, dv) of the plain version and of the Pallas kernel, given
    the same o and lse (per-head), per-head."""
    q, k, v, do = arrs
    if layout == "packed":  # o and lse in the packed entries' layout
        po, pl = tfa._packed(o), lse[..., 0].transpose(1, 2).contiguous()
        plain = tfa.plain_bwd_packed(*map(torch.tensor, (q, k, v)), po,
                                     torch.tensor(do), pl, scale, H)
        pallas = jfa._bwd_packed(*map(jnp.asarray, (q, k, v)),
                                 jnp.asarray(po.numpy()), jnp.asarray(do),
                                 jnp.asarray(pl.numpy()), scale, H)
        return ([tfa._heads(g, H) for g in plain],
                [tfa._heads(torch.tensor(np.asarray(g)), H) for g in pallas])
    causal = layout == "heads_causal"
    plain = tfa.plain_bwd(*map(torch.tensor, (q, k, v)), o, torch.tensor(do),
                          lse, None if dlse is None else torch.tensor(dlse),
                          scale, causal)
    zero = np.zeros((N, H, T, 1), np.float32)
    pallas = jfa._blk_bwd(*map(jnp.asarray, (q, k, v)),
                          jnp.asarray(o.numpy()), jnp.asarray(do),
                          jnp.asarray(lse.numpy()),
                          jnp.asarray(zero if dlse is None else dlse), scale,
                          causal)
    return plain, [torch.tensor(np.asarray(g)) for g in pallas]


def _heads_of(layout, arrs):
    ts = [torch.tensor(a) for a in arrs]
    return [tfa._heads(x, H) for x in ts] if layout == "packed" else ts


def _outside(got, want, tol):
    a, b = got.numpy(), want.numpy()
    return int((np.abs(a - b) > tol["atol"] + tol["rtol"] * np.abs(b)).sum())


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_3xtf32_attention_within_f32_tolerance(layout, d):
    """The 3xTF32-emulated forward and backward against the plain versions
    and the interpreted Pallas kernels, at phase 3's f32 tolerance."""
    arrs, dlse = _inputs(layout, d)
    scale = 1.0 / np.sqrt(d)
    causal = layout != "heads_full_dlse"
    q, k, v, do = _heads_of(layout, arrs)
    o, lse = emulated_fwd(mm_3xtf32, q, k, v, scale, causal)
    for ref_o, ref_lse in _reference_fwd(layout, arrs, scale):
        assert _outside(o, ref_o, OUT_TOL) == 0
        assert _outside(lse, ref_lse, LSE_TOL) == 0
    tdlse = None if dlse is None else torch.tensor(dlse)
    grads = emulated_bwd(mm_3xtf32, q, k, v, o, do, lse, tdlse, scale,
                         causal)
    for refs in _reference_bwd(layout, arrs, o, lse, dlse, scale):
        for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
            assert _outside(got, want, OUT_TOL) == 0, name


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("layout", ("packed", "heads_causal"))
def test_single_pass_tf32_fails_the_lse_tolerance(layout, d):
    """Single-pass TF32 on the same inputs: lse falls outside phase 3's
    tolerance, against the plain version and the Pallas kernel alike,
    where 3xTF32 (above) falls inside it."""
    arrs, _ = _inputs(layout, d)
    scale = 1.0 / np.sqrt(d)
    q, k, v, _ = _heads_of(layout, arrs)
    _, lse = emulated_fwd(mm_tf32, q, k, v, scale, True)
    _, lse3 = emulated_fwd(mm_3xtf32, q, k, v, scale, True)
    for _, ref_lse in _reference_fwd(layout, arrs, scale):
        assert _outside(lse, ref_lse, LSE_TOL) > N * H * T // 4
        assert _outside(lse3, ref_lse, LSE_TOL) == 0
