#!/usr/bin/env python3
"""Smoke run of gym_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. device: the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from this checkout (``nvcc``), print the build
   time, the ``-Xptxas -v`` report (registers, shared memory, spills) and,
   from ``cuobjdump -sass``, each kernel's count of ``HGMMA`` (wgmma),
   ``HMMA``, ``FFMA`` and ``ATOM``/``RED`` instructions; fails if a bf16
   forward, dk/dv or dq kernel has no ``HGMMA`` or any kernel an atomic;
3. every kernel against its plain PyTorch version on the card, bf16 and f32:
   the packed pair (B1/B2) at the flagship shape with q, k and v as strided
   views of the ``[N, T, 3C]`` projection, the per-head pair (B3/B4) at the
   GPT-2-base shape, causal and full-block with a random lse cotangent, the
   long-context pair (B5) at N=2 H=12 T=8192 D=64 on per-head views of the
   projection, and at T=1152 (the default-block rule); the bf16 backward
   run twice at the B5 shape must agree bit for bit;
4. flagship training through ``Trainer.fit``: GPT 4L/4H/128d, vocab 65,
   T=256, K=64 nodes × 16 rows, bf16, DiLoCo (H=2) with the lambda_cosine
   warmup, 6 steps on random tokens; the packed kernels must have launched;
5. GPT-2 base (12L/12H/768, vocab 50304, T=1024, K=2 × 4 rows, 3 steps,
   DiLoCo H=2); the per-head kernels must have launched;
5b. long context: GPT-2 base at T=8192 with ``remat`` and ``loss_chunk=2048``,
   K=2 × 1 row, 4 steps (the steady rate counts the last two); the B5 pair must have launched exactly as often as
   the steps and evals need (the forward twice a layer a step under remat);
   then one step without ``remat`` and ``loss_chunk``, whose peak memory
   must be higher;
6. card against CPU: tiny GPTs through ``Trainer.fit`` on ``cuda`` and on
   ``cpu`` from the same weights and batches, in bf16 and in f32, at T=128
   and at T=2048 (where the card runs B5 and the CPU dense attention);
7. timing with CUDA events (median of 5 runs of back-to-back launches,
   queued behind a device sleep so that the events bracket device work
   only): each kernel, its plain version, the library call
   (``scaled_dot_product_attention``, timed only as a yardstick), the bound
   at 3.35 TB/s and 989 TFLOP/s and the TFLOP/s of the tiles the kernel
   computes;
8. the ``kernels`` JSON line, then the result line.

The launch counts in the ``kernels`` line are those of the training runs of
phases 4 (B1/B2), 5 (B3/B4) and 5b (B5), each counted from zero.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
FUSED_CU = "gym_tpu_torch/ops/csrc/fused_attention.cu"
FLASH_CU = "gym_tpu_torch/ops/csrc/flash_attention.cu"
# JAX's bundled Pallas TPU kernel, which gym_tpu/ops/flash_attention.py:77,84
# calls for T > 1024
BUNDLED = "jax/experimental/pallas/ops/tpu/flash_attention.py"
KERNELS = {  # name: (module, wrapper, source, TPU kernel it replaces)
    "B1_fwd_packed": ("fused", "_fwd_packed", FUSED_CU,
                      "gym_tpu/ops/fused_attention.py:246"),
    "B2_bwd_packed": ("fused", "_bwd_packed", FUSED_CU,
                      "gym_tpu/ops/fused_attention.py:267"),
    "B3_blk_fwd": ("fused", "_blk_fwd", FUSED_CU,
                   "gym_tpu/ops/fused_attention.py:137"),
    "B4_blk_bwd": ("fused", "_blk_bwd", FUSED_CU,
                   "gym_tpu/ops/fused_attention.py:153"),
    "B5f_flash_fwd": ("flash", "_flash_fwd", FLASH_CU, f"{BUNDLED}:758"),
    "B5b_flash_bwd": ("flash", "_flash_bwd", FUSED_CU,
                      f"{BUNDLED}:1121 and :1456"),
}
# stated tolerances, kernel against plain version on the same inputs:
# |a − b| <= atol + rms_frac·rms(b) + rtol·|b| elementwise, rms(b) the root
# mean square of the plain version's tensor (o and the gradients shrink as T
# grows: at T=8192 a typical element is about 0.02-0.05). bf16: p and ds are
# rounded to bf16 at the same points in both, but a value on a rounding
# boundary can go either way when the f32 sums differ in order: rtol covers
# two bf16 steps of an element, the rms part such a flip on an element near
# zero (the kernels need at most 0.019 rms at phase 3's shapes; PERF.md has
# the measurement and the planted faults this tolerance fails).
TOL = {"bfloat16": {"out": (0.0, 5e-2, 2e-2),
                    "lse": (1e-4, 0.0, 1e-5)},
       "float32": {"out": (5e-5, 0.0, 1e-4), "lse": (1e-5, 0.0, 1e-6)}}
# card against CPU, per-step train loss: bf16 compute rounds differently
# in cuBLAS and the CPU kernels; f32 differs by summation order only
LOSS_RTOL = {"bf16": 1e-2, "f32": 1e-4}


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# -- phase 2: what the compiler made ----------------------------------------

SASS_OPS = ("HGMMA", "HMMA", "FFMA", "ATOM/RED")
_SASS_INSN = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9]*)")


def sass_counts(nvcc, lib_path):
    """{kernel: {op: count}} from ``cuobjdump -sass`` of the library."""
    bindir = os.path.dirname(nvcc)
    out = subprocess.run([os.path.join(bindir, "cuobjdump"), "-sass",
                          lib_path], capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        m = _SASS_INSN.match(line)
        if name is None or not m:
            continue
        op = m.group(1)
        if op in ("ATOM", "ATOMS", "ATOMG", "RED", "REDG"):
            op = "ATOM/RED"
        if op in counts[name]:
            counts[name][op] += 1
    check(counts, "cuobjdump listed no kernels")
    names = list(counts)
    for tool in (os.path.join(bindir, "cu++filt"), "c++filt"):
        try:
            dem = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        if dem.returncode == 0 and len(dem.stdout.splitlines()) == len(names):
            return dict(zip(dem.stdout.splitlines(), counts.values()))
    return counts


def check_sass(counts):
    """Every bf16 wgmma kernel uses the tensor cores; no kernel has an
    atomic."""
    wgmma = [k for k in counts if "wgmma" in k]
    check(len(wgmma) == 12, f"expected 12 bf16 wgmma kernels (forward, dq, "
          f"dk/dv at 4 head dims), found {len(wgmma)}: {wgmma}")
    for k in sorted(counts):
        c = counts[k]
        log("  " + k + ": " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
        check(c["ATOM/RED"] == 0, f"{k}: {c['ATOM/RED']} atomic instructions")
        if k in wgmma:
            check(c["HGMMA"] > 0, f"{k}: no HGMMA (wgmma) instruction")


# -- phase 3: kernels against plain versions --------------------------------


def compare(name, got, ref, kind, dtype):
    atol, frac, rtol = TOL[str(dtype).replace("torch.", "")][kind]
    a, b = got.float(), ref.float()
    err = (a - b).abs()
    rms = b.square().mean().sqrt().item()
    over = err - rtol * b.abs()  # what atol has to cover
    bad = (over > atol + frac * rms).sum().item()
    mx = err.max().item()
    log(f"  {name}: max_abs_err {mx:.3e}, rms {rms:.3e}, largest |a-b| - "
        f"rtol|b| {over.max().item() / rms:.2e} rms (atol {atol} + "
        f"{frac} rms, rtol {rtol}) "
        f"{'ok' if bad == 0 else f'{bad} elements outside'}")
    check(bad == 0 and math.isfinite(mx), f"{name} disagrees with its "
          f"plain version")
    return mx


def per_head_views(torch, g, n, h, t, d, dtype):
    """q, k, v as [N, H, T, D] views of one [N, T, 3·H·D] projection (token
    stride 3C, as the model passes them) and a random cotangent."""
    qkv = torch.randn(n, t, 3 * h * d, device="cuda", generator=g).to(dtype)
    heads = [z.view(n, t, h, d).transpose(1, 2)
             for z in qkv.split(h * d, dim=-1)]
    do = torch.randn(n, h, t, d, device="cuda", generator=g).to(dtype)
    return heads, do


def check_long_context(torch, tflash, shapes, g, dtype):
    """B5 forward and backward against their plain versions; the largest
    error of each at the slice's shape (the first in ``shapes``)."""
    dn = str(dtype).replace("torch.", "")
    errs = []
    for n, h, t, d in shapes:
        heads, do = per_head_views(torch, g, n, h, t, d, dtype)
        scale = 1.0 / math.sqrt(d)
        log(f"B5 long-context {dn} N={n} H={h} T={t} D={d} "
            f"(per-head views, blocks {tflash._block_sizes(t, d)}):")
        o, lse = tflash._flash_fwd(*heads, scale)
        ro, rl = tflash.plain_flash_fwd(*heads, scale)
        ef = max(compare("B5f o", o, ro, "out", dtype),
                 compare("B5f lse", lse, rl, "lse", dtype))
        got = tflash._flash_bwd(*heads, o, do, lse, scale)
        ref = tflash.plain_flash_bwd(*heads, o, do, lse, scale)
        eb = max(compare(f"B5b {nm}", a, b, "out", dtype)
                 for nm, a, b in zip(("dq", "dk", "dv"), got, ref))
        if dtype == torch.bfloat16 and not errs:
            again = tflash._flash_bwd(*heads, o, do, lse, scale)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"  B5b bf16 run twice: dq, dk, dv "
                f"{'bit-identical' if same else 'DIFFER'}")
            check(same, "B5b: two runs of the bf16 backward differ")
            del again
        errs.append((ef, eb))
        del heads, do, o, lse, ro, rl, got, ref
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs[0]


def check_kernels(torch, tfa, tflash, shapes):
    errs = {}
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).replace("torch.", "")
        n, t, c, h = shapes["flagship"]
        scale = 1.0 / math.sqrt(c // h)
        qkv = torch.randn(n, t, 3 * c, device="cuda", generator=g).to(dtype)
        q, k, v = qkv.split(c, dim=-1)
        do = torch.randn(n, t, c, device="cuda", generator=g).to(dtype)
        log(f"B1/B2 packed {dn} N={n} T={t} C={c} H={h} (strided views):")
        o, lse = tfa._fwd_packed(q, k, v, scale, h)
        ro, rl = tfa.plain_fwd_packed(q, k, v, scale, h)
        e1 = max(compare("B1 o", o, ro, "out", dtype),
                 compare("B1 lse", lse, rl, "lse", dtype))
        got = tfa._bwd_packed(q, k, v, o, do, lse, scale, h)
        ref = tfa.plain_bwd_packed(q, k, v, o, do, lse, scale, h)
        e2 = max(compare(f"B2 {nm}", a, b, "out", dtype)
                 for nm, a, b in zip(("dq", "dk", "dv"), got, ref))
        del qkv, q, k, v, do, o, lse, ro, rl, got, ref
        torch.cuda.empty_cache()

        n, h, t, d = shapes["base"]
        e3 = e4 = 0.0
        for causal in (True, False):
            qkv = torch.randn(n, t, 3 * h * d, device="cuda",
                              generator=g).to(dtype)
            heads = [z.reshape(n, t, h, d).transpose(1, 2)
                     for z in qkv.split(h * d, dim=-1)]
            do = torch.randn(n, h, t, d, device="cuda", generator=g).to(dtype)
            dlse = (None if causal else
                    torch.randn(n, h, t, 1, device="cuda", generator=g))
            log(f"B3/B4 per-head {dn} N={n} H={h} T={t} D={d} "
                f"causal={causal} dlse={'random' if dlse is not None else 0}:")
            o, lse = tfa._blk_fwd(*heads, 0.125, causal)
            ro, rl = tfa.plain_fwd(*heads, 0.125, causal)
            ef = max(compare("B3 o", o, ro, "out", dtype),
                     compare("B3 lse", lse, rl, "lse", dtype))
            got = tfa._blk_bwd(*heads, o, do, lse, dlse, 0.125, causal)
            ref = tfa.plain_bwd(*heads, o, do, lse, dlse, 0.125, causal)
            eb = max(compare(f"B4 {nm}", a, b, "out", dtype)
                     for nm, a, b in zip(("dq", "dk", "dv"), got, ref))
            if causal:
                e3, e4 = ef, eb
            del qkv, heads, do, dlse, o, lse, ro, rl, got, ref
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        e5f, e5b = check_long_context(
            torch, tflash, (shapes["long"], shapes["long_default_blocks"]), g,
            dtype)
        if dtype == torch.bfloat16:  # the training runs' dtype
            errs.update(B1_fwd_packed=e1, B2_bwd_packed=e2, B3_blk_fwd=e3,
                        B4_blk_bwd=e4, B5f_flash_fwd=e5f, B5b_flash_bwd=e5b)
    return errs


# -- phases 4-6: training through Trainer.fit --------------------------------


def gpt_fit(torch, cfg_kw, nodes, batch, steps, device, autocast, seed,
            run_name, init_params=None, tokens=200_000):
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import ContiguousGPTTrainDataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.strategy import DiLoCoStrategy, OptimSpec
    import numpy as np

    cfg = GPTConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, tokens).astype(np.int32)
    cut = tokens * 9 // 10
    ds = ContiguousGPTTrainDataset(toks[:cut], cfg.block_size)
    val = ContiguousGPTTrainDataset(toks[cut:], cfg.block_size)
    strategy = DiLoCoStrategy(
        optim_spec=OptimSpec("adamw", lr=3e-4), H=2,
        lr_scheduler="lambda_cosine", lr_scheduler_kwargs={"warmup_steps": 2})
    return Trainer(GPT(cfg), ds, val).fit(
        strategy=strategy, num_nodes=nodes, max_steps=steps,
        batch_size=batch, device=device, autocast=autocast, seed=seed,
        val_size=batch, val_interval=100,
        init_params=init_params, show_progress=False,
        log_dir=os.path.join(HERE, "build", "chip_smoke_logs"),
        run_name=run_name)


def reset_counts(mods):
    for m in mods.values():
        m.reset_launch_counts()


def read_counts(mods):
    return {k: getattr(mods[m], w).launches
            for k, (m, w, _, _) in KERNELS.items()}


def train_phase(torch, mods, title, cfg_kw, nodes, batch, steps, want,
                tokens=200_000):
    log(f"{title}: K={nodes} x {batch} rows, {steps} steps, bf16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts(mods)
    t0 = time.perf_counter()
    res = gpt_fit(torch, cfg_kw, nodes, batch, steps, "cuda", True, 0, title,
                  tokens=tokens)
    wall = time.perf_counter() - t0
    counts = read_counts(mods)
    losses = [l for _, l in res.history["train_loss"]]
    for step, loss in res.history["train_loss"]:
        log(f"  step {step}: loss {loss:.6f}")
    for (step, lo), (_, gl) in zip(res.history["local_loss"],
                                   res.history["global_loss"]):
        log(f"  eval at step {step}: local {lo:.6f} global {gl:.6f}")
    log(f"  steps/s {res.steps_per_second:.4f} (steady "
        f"{res.steps_per_second_steady}) on {torch.cuda.get_device_name(0)}, "
        f"wall {wall:.1f} s incl. init, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ("
        f"{held / 2**30:.2f} GiB held before the fit)")
    log(f"  launches: {counts}")
    check(len(losses) == steps and all(math.isfinite(l) for l in losses),
          f"{title}: non-finite or missing losses {losses}")
    ln_v = math.log(cfg_kw["vocab_size"])
    check(abs(losses[0] - ln_v) < 0.5,
          f"{title}: first loss {losses[0]} far from ln(V) = {ln_v:.3f}")
    for name in want:
        check(counts[name] > 0, f"{title}: {name} never launched")
    return counts, res


def long_context_phase(torch, mods, cfg_kw, nodes, steps):
    """GPT-2 base at T=8192 under remat and loss_chunk: losses, the exact
    B5 launch counts, steps/s, peak memory and MFU; then one step without
    the memory levers, which must peak higher."""
    from gym_tpu_torch.models.nanogpt import GPTConfig, node_mfu
    title = "phase 5b long-context"
    counts, res = train_phase(torch, mods, title, cfg_kw, nodes, 1, steps,
                              ("B5f_flash_fwd", "B5b_flash_bwd"),
                              tokens=400_000)
    peak = torch.cuda.max_memory_allocated()
    layers = cfg_kw["n_layer"]
    # every eval runs the f32 forward twice (local and global params), one
    # validation microbatch each
    evals = 2 * len(res.history["global_loss"])
    want_f = layers * (2 * steps + evals)
    want_b = layers * steps
    check(counts["B5f_flash_fwd"] == want_f and
          counts["B5b_flash_bwd"] == want_b,
          f"{title}: B5 launches {counts['B5f_flash_fwd']}/"
          f"{counts['B5b_flash_bwd']}, expected {want_f}/{want_b} "
          f"({layers} layers, {steps} steps under remat, {evals} evals)")
    sps = res.steps_per_second_steady or res.steps_per_second
    mfu = node_mfu(GPTConfig(**cfg_kw), res.node_state.params, nodes,
                   1.0 / sps, peak_flops=BF16_FLOPS)
    log(f"  B5 launches as expected: forward {want_f} = {layers} x (2 x "
        f"{steps} steps + {evals} evals), backward {want_b}")
    log(f"  MFU {mfu:.4%} at {BF16_FLOPS / 1e12:.0f} TFLOP/s (steady "
        f"{sps:.4f} steps/s); peak memory with remat and loss_chunk "
        f"{peak / 2**30:.2f} GiB")
    del res  # its node state would count in the next run's peak
    plain_kw = dict(cfg_kw, remat=False, loss_chunk=0)
    train_phase(torch, mods, f"{title} without remat", plain_kw, nodes, 1,
                1, ("B5f_flash_fwd", "B5b_flash_bwd"), tokens=400_000)
    peak1 = torch.cuda.max_memory_allocated()
    log(f"  peak memory without remat and loss_chunk {peak1 / 2**30:.2f} GiB "
        f"(with: {peak / 2**30:.2f} GiB)")
    check(peak < peak1, f"{title}: remat and loss_chunk did not lower the "
          f"peak memory ({peak} >= {peak1} bytes)")
    return counts


def card_vs_cpu(torch, mods, cfg_kw, nodes, batch, steps, tokens, want=()):
    """Train losses and global evals of the same fit on the card and on the
    CPU; ``want`` names kernels the card run must have launched."""
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    t = cfg_kw["block_size"]
    init = {n: p[0] for n, p in GPT(GPTConfig(**cfg_kw)).init_params(
        1, seed=11, device="cpu").items()}
    for mode, autocast in (("bf16", True), ("f32", False)):
        out = {}
        for device in ("cuda", "cpu"):
            reset_counts(mods)
            res = gpt_fit(torch, cfg_kw, nodes, batch, steps, device,
                          autocast, 5, f"card_vs_cpu_T{t}_{mode}_{device}",
                          init_params=init, tokens=tokens)
            out[device] = [l for _, l in res.history["train_loss"]] + [
                l for _, l in res.history["global_loss"]]
            if device == "cuda":
                counts = read_counts(mods)
                for name in want:
                    check(counts[name] > 0, f"card vs CPU T={t}: {name} "
                          f"never launched on the card")
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"],
                                                      out["cpu"]))
        log(f"card vs CPU T={t} {mode}: cuda "
            f"{['%.6f' % x for x in out['cuda']]}")
        log(f"                  cpu  {['%.6f' % x for x in out['cpu']]}")
        log(f"  max rel diff {rel:.3e} (band {LOSS_RTOL[mode]})")
        check(rel <= LOSS_RTOL[mode], f"card vs CPU {mode}: losses differ "
              f"by {rel:.3e} > {LOSS_RTOL[mode]}")


# -- phase 7: timing --------------------------------------------------------


# above the H100's highest SM clock (1.98 GHz), so torch.cuda._sleep of
# s * SLEEP_HZ cycles lasts at least s seconds
SLEEP_HZ = 2.0e9


def timed(torch, fn, reps=5, inner=10):
    """Median ms of one call over ``reps`` runs of ``inner`` back-to-back
    calls. Each run is queued behind a device sleep longer than the host
    takes to queue it, so the events bracket device work only, not the
    host's launch cost."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_cycles = int(min(2 * host_s + 1e-3, 1.0) * SLEEP_HZ)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def bound(n, h, t, d, itemsize, backward, causal=True):
    """Least time (ms) for the work at 3.35 TB/s and 989 TFLOP/s (bf16):
    each input read once, each output written once; causal pairs only."""
    elems = n * h * t * d
    stats = n * h * t * 4
    if backward:   # read q k v o do lse, write dq dk dv
        nbytes = 8 * elems * itemsize + stats
        matmuls = 5
    else:          # read q k v, write o lse
        nbytes = 4 * elems * itemsize + stats
        matmuls = 2
    pairs = n * h * (t * (t + 1) // 2 if causal else t * t)
    flops = 2 * d * pairs * matmuls
    peak = BF16_FLOPS if itemsize == 2 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tile_tflops(n, h, t, d, products, ms, causal=True):
    """TFLOP/s of the 64 x 64 tiles a kernel computes (whole diagonal tiles
    included), ``products`` matrix products of 2·D flops a pair each."""
    nt = t // 64
    tiles = nt * (nt + 1) // 2 if causal else nt * nt
    return n * h * tiles * 64 * 64 * 2 * d * products / (ms * 1e-3) / 1e12


def time_kernels(torch, tfa, tflash, shapes):
    import torch.nn.functional as F
    out = {}
    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    n, t, c, h = shapes["flagship"]
    d = c // h
    scale = 1.0 / math.sqrt(d)
    qkv = torch.randn(n, t, 3 * c, device="cuda", generator=g).to(bf)
    q, k, v = qkv.split(c, dim=-1)
    do = torch.randn(n, t, c, device="cuda", generator=g).to(bf)
    o, lse = tfa._fwd_packed(q, k, v, scale, h)
    lib = [x.view(n, t, h, d).transpose(1, 2).detach().requires_grad_(True)
           for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=scale)
    ldo = do.view(n, t, h, d).transpose(1, 2)
    out["B1_fwd_packed"] = dict(
        ms=timed(torch, lambda: tfa._fwd_packed(q, k, v, scale, h)),
        plain_ms=timed(torch, lambda: tfa.plain_fwd_packed(q, k, v, scale, h),
                       inner=3),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *[x.detach() for x in lib], is_causal=True, scale=scale)),
        shape=f"N={n} T={t} C={c} H={h} bf16 packed views",
        bound=bound(n, h, t, d, 2, False), work=(n, h, t, d, 3))
    out["B2_bwd_packed"] = dict(
        ms=timed(torch, lambda: tfa._bwd_packed(q, k, v, o, do, lse, scale,
                                                h)),
        plain_ms=timed(torch, lambda: tfa.plain_bwd_packed(
            q, k, v, o, do, lse, scale, h), inner=3),
        library_ms=timed(torch, lambda: torch.autograd.grad(
            lo, lib, ldo, retain_graph=True)),
        shape=f"N={n} T={t} C={c} H={h} bf16 packed views",
        bound=bound(n, h, t, d, 2, True), work=(n, h, t, d, 7))
    del qkv, q, k, v, do, o, lse, lib, lo, ldo
    torch.cuda.empty_cache()

    n, h, t, d = shapes["base"]
    qkv = torch.randn(n, t, 3 * h * d, device="cuda", generator=g).to(bf)
    heads = [z.reshape(n, t, h, d).transpose(1, 2)
             for z in qkv.split(h * d, dim=-1)]
    do = torch.randn(n, h, t, d, device="cuda", generator=g).to(bf)
    o, lse = tfa._blk_fwd(*heads, 0.125, True)
    lib = [x.detach().requires_grad_(True) for x in heads]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=0.125)
    out["B3_blk_fwd"] = dict(
        ms=timed(torch, lambda: tfa._blk_fwd(*heads, 0.125, True)),
        plain_ms=timed(torch, lambda: tfa.plain_fwd(*heads, 0.125, True),
                       inner=3),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *heads, is_causal=True, scale=0.125)),
        shape=f"N={n} H={h} T={t} D={d} bf16 per-head views",
        bound=bound(n, h, t, d, 2, False), work=(n, h, t, d, 3))
    out["B4_blk_bwd"] = dict(
        ms=timed(torch, lambda: tfa._blk_bwd(*heads, o, do, lse, None, 0.125,
                                             True)),
        plain_ms=timed(torch, lambda: tfa.plain_bwd(
            *heads, o, do, lse, None, 0.125, True), inner=3),
        library_ms=timed(torch, lambda: torch.autograd.grad(
            lo, lib, do, retain_graph=True)),
        shape=f"N={n} H={h} T={t} D={d} bf16 per-head views",
        bound=bound(n, h, t, d, 2, True), work=(n, h, t, d, 7))
    del qkv, heads, do, o, lse, lib, lo
    torch.cuda.empty_cache()

    n, h, t, d = shapes["long"]
    scale = 1.0 / math.sqrt(d)
    heads, do = per_head_views(torch, g, n, h, t, d, bf)
    o, lse = tflash._flash_fwd(*heads, scale)
    lib = [x.detach().requires_grad_(True) for x in heads]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=scale)
    shape = f"N={n} H={h} T={t} D={d} bf16 per-head views"
    out["B5f_flash_fwd"] = dict(
        ms=timed(torch, lambda: tflash._flash_fwd(*heads, scale), inner=3),
        plain_ms=timed(torch, lambda: tflash.plain_flash_fwd(*heads, scale),
                       inner=3),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *heads, is_causal=True, scale=scale)),
        shape=shape, bound=bound(n, h, t, d, 2, False),
        work=(n, h, t, d, 2))
    out["B5b_flash_bwd"] = dict(
        ms=timed(torch, lambda: tflash._flash_bwd(*heads, o, do, lse, scale),
                 inner=3),
        plain_ms=timed(torch, lambda: tflash.plain_flash_bwd(
            *heads, o, do, lse, scale), inner=3),
        library_ms=timed(torch, lambda: torch.autograd.grad(
            lo, lib, do, retain_graph=True)),
        shape=shape, bound=bound(n, h, t, d, 2, True),
        work=(n, h, t, d, 7))
    del heads, do, o, lse, lib, lo
    torch.cuda.empty_cache()
    for name, r in out.items():
        b, by = r["bound"]
        log(f"{name} [{r['shape']}]: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {b:.4f} ({by}) -> {b / r['ms']:.1%} of bound, "
            f"{tile_tflops(*r['work'], r['ms']):.1f} TFLOP/s of computed "
            f"tiles ({r['work'][-1]} products)")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import gym_tpu_torch.ops.flash_attention as tflash
        import gym_tpu_torch.ops.fused_attention as tfa
        from gym_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: gym_tpu_torch not found beside chip_smoke.py "
              f"({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    shapes = {"flagship": (64 * 16, 256, 128, 4),
              "base": (2 * 4, 12, 1024, 64),
              "long": (2 * 1, 12, 8192, 64),
              "long_default_blocks": (2, 12, 1152, 64)}
    mods = {"fused": tfa, "flash": tflash}
    t_all = time.perf_counter()
    try:
        card = card_line()
        log(f"phase 1: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")

        t0 = time.perf_counter()
        path = _build.build()
        lib = _build.load()
        log(f"phase 2: built {os.path.relpath(path, HERE)} in "
            f"{time.perf_counter() - t0:.1f} s; ptxas:")
        for line in _build.build_log.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log("  " + line.strip())
        for d in (32, 64):
            log(f"  dynamic shared memory per block at D={d}: " + ", ".join(
                f"{name} {lib.gym_attn_smem_bytes(i, d)} B" for i, name in
                enumerate(("attn_fwd f32", "attn_dkdv f32", "attn_dq f32",
                           "flash_fwd", "attn_fwd_wgmma bf16",
                           "attn_dkdv_wgmma bf16", "attn_dq_wgmma bf16"))))
        log("  SASS instructions per kernel (cuobjdump -sass):")
        check_sass(sass_counts(_build._nvcc(), path))

        log("phase 3: kernels against plain versions on the card")
        errs = check_kernels(torch, tfa, tflash, shapes)

        flagship = dict(block_size=256, vocab_size=65, n_layer=4, n_head=4,
                        n_embd=128, attn_impl="flash")
        base = dict(block_size=1024, vocab_size=50304, n_layer=12, n_head=12,
                    n_embd=768, attn_impl="flash")
        long_ctx = dict(base, block_size=8192, remat=True, loss_chunk=2048)
        c4 = train_phase(torch, mods, "phase 4 flagship", flagship, 64, 16,
                         6, ("B1_fwd_packed", "B2_bwd_packed"))[0]
        c5 = train_phase(torch, mods, "phase 5 gpt2-base", base, 2, 4, 3,
                         ("B3_blk_fwd", "B4_blk_bwd"))[0]
        c5b = long_context_phase(torch, mods, long_ctx, 2, 4)
        torch.cuda.empty_cache()
        launches = {"B1_fwd_packed": c4["B1_fwd_packed"],
                    "B2_bwd_packed": c4["B2_bwd_packed"],
                    "B3_blk_fwd": c5["B3_blk_fwd"],
                    "B4_blk_bwd": c5["B4_blk_bwd"],
                    "B5f_flash_fwd": c5b["B5f_flash_fwd"],
                    "B5b_flash_bwd": c5b["B5b_flash_bwd"]}

        log("phase 6: card against CPU")
        card_vs_cpu(torch, mods, dict(block_size=128, vocab_size=65,
                                      n_layer=2, n_head=2, n_embd=64,
                                      attn_impl="flash"), 4, 4, 3, 20_000)
        card_vs_cpu(torch, mods, dict(block_size=2048, vocab_size=65,
                                      n_layer=2, n_head=2, n_embd=128,
                                      attn_impl="flash"), 2, 1, 2, 100_000,
                    want=("B5f_flash_fwd", "B5b_flash_bwd"))

        log("phase 7: timing (CUDA events, median of 5)")
        times = time_kernels(torch, tfa, tflash, shapes)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_all:.1f} s")
    log(card)
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        r = times[name]
        b, by = r["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
