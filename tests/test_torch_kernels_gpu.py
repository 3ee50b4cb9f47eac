"""The CUDA kernels of ``gym_tpu_torch.ops.fused_attention`` and
``gym_tpu_torch.ops.flash_attention`` against their plain versions on the
card. Marked ``gpu``: they skip without a card. This
file imports neither JAX nor ``gym_tpu``, so it runs on the machine with the
card, where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance |kernel − plain| (max abs): f32 4e-4 on o and 8e-4 on gradients,
bf16 8e-2 on o and 0.16 on gradients (two bf16 steps at the magnitudes
these inputs reach), lse 1e-4.
"""

import pytest
import torch

import gym_tpu_torch.ops.flash_attention as tflash
import gym_tpu_torch.ops.fused_attention as tfa


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """The CUDA kernels against their plain versions on the card, bf16 and
    f32, strided packed views and the per-head layout with dlse."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m gpu)")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qkv = torch.randn(8, 256, 3 * 128, device=dev, generator=g).to(dt)
        q, k, v = qkv.split(128, dim=-1)
        do = torch.randn(8, 256, 128, device=dev, generator=g).to(dt)
        o, lse = tfa._fwd_packed(q, k, v, 0.25, 4)
        ro, rl = tfa._fwd_packed(q.cpu(), k.cpu(), v.cpu(), 0.25, 4)
        assert (o.cpu().float() - ro.float()).abs().max() <= tol * 4
        assert (lse.cpu() - rl).abs().max() <= 1e-4
        got = tfa._bwd_packed(q, k, v, o, do, lse, 0.25, 4)
        ref = tfa._bwd_packed(*(x.cpu() for x in (q, k, v, o, do, lse)),
                              0.25, 4)
        for a, b in zip(got, ref):
            assert (a.cpu().float() - b.float()).abs().max() <= tol * 8
        for causal in (True, False):
            x = [torch.randn(2, 3, 256, 64, device=dev, generator=g).to(dt)
                 for _ in range(4)]
            dlse = torch.randn(2, 3, 256, 1, device=dev, generator=g)
            o, lse = tfa._blk_fwd(*x[:3], 0.125, causal)
            got = tfa._blk_bwd(*x[:3], o, x[3], lse, dlse, 0.125, causal)
            ref = tfa._blk_bwd(*(y.cpu() for y in (*x[:3], o, x[3], lse,
                                                   dlse)), 0.125, causal)
            for a, b in zip(got, ref):
                assert (a.cpu().float() - b.float()).abs().max() <= tol * 8


@pytest.mark.gpu
def test_long_context_pair_matches_plain_on_card():
    """The B5 pair (``_flash_fwd``, ``_flash_bwd``) against its plain
    versions on the card at T=2048, bf16 and f32, on per-head views of a
    packed projection (token stride 3C, as the model passes them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m gpu)")
    g = torch.Generator(device="cuda").manual_seed(1)
    n, h, t, d = 2, 2, 2048, 64
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qkv = torch.randn(n, t, 3 * h * d, device="cuda", generator=g).to(dt)
        q, k, v = (z.view(n, t, h, d).transpose(1, 2)
                   for z in qkv.split(h * d, dim=-1))
        do = torch.randn(n, h, t, d, device="cuda", generator=g).to(dt)
        o, lse = tflash._flash_fwd(q, k, v, 0.125)
        ro, rl = tflash.plain_flash_fwd(q, k, v, 0.125)
        assert (o.float() - ro.float()).abs().max() <= tol * 4
        assert (lse - rl).abs().max() <= 1e-4
        got = tflash._flash_bwd(q, k, v, o, do, lse, 0.125)
        ref = tflash.plain_flash_bwd(q, k, v, o, do, lse, 0.125)
        for a, b in zip(got, ref):
            assert (a.float() - b.float()).abs().max() <= tol * 8
    # a head dim the kernels do not take raises on the card: no quiet
    # fallback to dense attention or to the plain version
    x = torch.randn(1, 1, 2048, 256, device="cuda", generator=g)
    with pytest.raises(ValueError):
        tflash.flash_causal_attention(x, x, x)
