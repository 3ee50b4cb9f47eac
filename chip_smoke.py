#!/usr/bin/env python3
"""Smoke run of gym_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines are printed):

1. device: the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from this checkout (``nvcc``), print the build
   time, the ``-Xptxas -v`` report (registers, shared memory, spills), the
   f32 kernels' registers, spills and shared memory per head dim and, from
   ``cuobjdump -sass``, each kernel's count of ``HGMMA`` (wgmma), ``HMMA``,
   ``FFMA`` and ``ATOM``/``RED`` instructions; fails if a bf16 forward,
   dk/dv, dq or long-context forward kernel, or an f32 (3xTF32) forward,
   dq, dk/dv or long-context forward kernel at any head dim and copy width,
   has no ``HGMMA``, if any kernel has an atomic, or if a kernel that the
   long-context f32 forward and T1's segments replaced is still built; the
   long-context forwards' register split and blocks per SM;
3. every kernel against its plain PyTorch version on the card, bf16 and f32:
   the packed pair (B1/B2) at the flagship shape with q, k and v as strided
   views of the ``[N, T, 3C]`` projection, the per-head pair (B3/B4) at the
   GPT-2-base shape, causal and full-block with a random lse cotangent, the
   long-context pair (B5) at N=2 H=12 T=8192 D=64 on per-head views of the
   projection, at T=2048 (the tuned blocks) and at T=1152 (the default-block
   rule); the bf16 forward and backward and the f32 forward, each run
   twice at the B5 shape, and the f32 forward and backward, each run twice
   at the packed and per-head shapes, must agree bit for bit;
4. flagship training through ``Trainer.fit``: GPT 4L/4H/128d, vocab 65,
   T=256, K=64 nodes × 16 rows, bf16, DiLoCo (H=2) with the lambda_cosine
   warmup, 6 steps on random tokens; the packed kernels must have launched;
5. GPT-2 base (12L/12H/768, vocab 50304, T=1024, K=2 × 4 rows, 3 steps,
   DiLoCo H=2); the per-head kernels must have launched;
5b. long context: GPT-2 base at T=8192 with ``remat`` and ``loss_chunk=2048``,
   K=2 × 1 row, 4 steps (the steady rate counts the last two); the B5 pair
   must have launched exactly as often as the steps and evals need (the
   bf16 forward twice a layer a step under remat, the f32 forward twice a
   layer an eval), and one f32 eval is timed; then one step without
   ``remat`` and ``loss_chunk``, whose peak memory must be higher;
6. card against CPU: tiny GPTs through ``Trainer.fit`` on ``cuda`` and on
   ``cpu`` from the same weights and batches, in bf16 and in f32, at T=128
   and at T=2048 (where the card runs B5 and the CPU dense attention); at
   T=128 also under SPARTA-DiLoCo (p 0.3, H 2, participation 0.75), whose
   masks come from the threefry kernel on the card and its twin on the CPU;
7. timing with CUDA events (median of 5 runs of back-to-back launches,
   queued behind a device sleep so that the events bracket device work
   only): each kernel, its plain version, the library call
   (``scaled_dot_product_attention``, timed only as a yardstick), the bound
   at 3.35 TB/s and 989 TFLOP/s and the TFLOP/s of the tiles the kernel
   computes; the f32 long-context forward's time beside f32 SDPA's and its
   bound, with its pre-pass timed alone, and beside the whole-context f32
   forward (``attn_fwd_tf32x3``) at the same shape; T1, the threefry
   Bernoulli masks of every GPT-2 base leaf (one SPARTA step, one launch),
   against its twin and its bound (bytes, or the least integer instructions
   at the dispatch limit of 128 lanes a clock an SM at the card's highest SM
   clock);
8. the stochastic strategies through ``Trainer.fit`` (random tokens, bf16),
   each with its steady steps/s, exact launch counts of B1-B4 and T1 and
   peak memory: 8a GPT-2 base, K=4 × 4 rows, SPARTA-DiLoCo (p 0.005, H 2,
   participation 0.75), 4 steps, whose step-0 ``comm_bytes`` must equal
   the prediction from the twin's mask counts, and T1 launched once a step; 8b the flagship, K=64 × 16,
   FedAvg (H 2, islands of 16), 6 steps; 8c GPT-2 base, K=4 × 4, ZeRO-1
   then SimpleReduce (AdamW), 3 steps each, where ZeRO must peak lower;
9. the BASELINE configs through ``Trainer.fit`` at
   ``benchmarks/run_baselines.py``'s settings, cut in steps, f32, each with
   its steady steps/s, peak memory, final loss and exact launch counts:
   9a-9c the MNIST CNN on the bundled digits (batch 256 in microbatches of
   64, Adam 1e-3, lambda_cosine warmup 100, 8 steps): 9a K=2 SimpleReduce,
   9b K=8 DiLoCo (H cut from 100 to 2 so that outer steps fire), 9c K=8
   SPARTA (p 0.005), the dropout masks from the per-row T1 (3 launches a
   microbatch) and SPARTA's from T1 (one launch a step), evals at step 0
   and after the last step (the configs eval 5 times in 300 steps, so the
   steady window holds none); 9d nanoGPT "small" 4L/4H/128d, vocab 66,
   T=256, K=16 × 16 rows, FedAvg AdamW 3e-4 (H cut to 2), 6 steps on the
   ``docs`` stream of the checkout's ``gym_tpu/`` (its length and crc32
   checked), the packed pair B1/B2 in f32, evals likewise; 9e the CNN on the card against the CPU, K=2 × 8 images in
   microbatches of 4, 3 steps from the same weights, f32 and bf16 (plain
   SGD: under Adam the conv biases ahead of BatchNorm get gradients of
   pure rounding noise, which Adam scales to steps of ±lr, so two
   summation orders part after a step; PERF.md);
10. the ``kernels`` JSON line, then the result line.

Phase 3 also holds the threefry kernels (random bits and the fused
Bernoulli mask, T1) to their plain twin bit for bit at 1, 4097, 786,432
(``wpe``) and 38,633,472 (``wte``) elements and, at 2³² + 4097 elements,
where the counter's high word is 1, on the last 8192; and the card's
permutation to the twin's at 38,633,472; T1's segments (one launch for a
table of keys, sizes and places) on a mixed table (sizes 0, 1, 3, 4, 5,
1023, 4097 and GPT-2 base's 148 leaves), at the CNN's 20 leaves under
SPARTA's keys of phase 9c's 8 steps, and as dropout draws them (a row a
node) at phase 9's dropouts (K = 8 and 2 rows of 64 × 64, 128 and 256
elements, the keys of two steps) and at 32 rows of 4096 and of 191
elements. Phase 7 also times the f32
packed pair at config 4's shape (N=256) and the f32 per-head pair at B3/B4's
shape, each beside f32 SDPA, its plain version, its bound (bytes, or three
times the products at TF32's 495 TFLOP/s: the kernels run split-precision
TF32) and the products at the 67 TFLOP/s of f32 FMAs, for comparison only;
the per-row mask at config 2's dropout shapes and the host's key algebra a
step. The launch counts in the
``kernels`` line are those of the training runs of phases 4 (B1/B2), 5
(B3/B4), 5b (B5, its f32 forward in the evals), 8a (T1), 9b (T1's per-row
entry) and 9d (the f32 B1/B2), each counted from zero; the packed pair and
B5's forward count their bf16 and f32 kernels apart (every eval runs in
f32).
"""

from __future__ import annotations

import ctypes
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
# f32 products on the tensor cores in split-precision TF32: three TF32
# products each (hopper.cuh); f32 FMAs (67 TFLOP/s) are printed for
# comparison only
TF32_FLOPS = 495e12
TF32_SPLIT = 3
F32_FLOPS = 67e12
# the least time of integer work: an SM dispatches at most one warp instruction
# (32 lanes) a clock from each of its 4 schedulers, 128 lanes a clock, which
# the integer pipe (64 INT32 lanes) and the FMA pipe (which runs IMAD and
# VIADD) share; times the SM count and the card's highest SM clock, both read
# from the card (phase 1). 64 lanes is no ceiling: T1 beat it (PERF.md).
DISPATCH_LANES_PER_SM = 128
# the least int32 work of one Bernoulli mask element: threefry2x32's 20
# rounds of add, rotate and xor, six key injections of two adds and the
# final xor (73), then the mask as an integer test, (bits >> 9) <
# ceil(p·2^23): a shift and a compare
THREEFRY_LEAST_OPS = 73 + 2
FUSED_CU = "gym_tpu_torch/ops/csrc/fused_attention.cu"
FLASH_CU = "gym_tpu_torch/ops/csrc/flash_attention.cu"
THREEFRY_CU = "gym_tpu_torch/ops/csrc/threefry.cu"
# JAX's bundled Pallas TPU kernel, which gym_tpu/ops/flash_attention.py:77,84
# calls for T > 1024
BUNDLED = "jax/experimental/pallas/ops/tpu/flash_attention.py"
# name: (module, wrapper, its launch count, source, TPU kernel it replaces);
# the packed pair counts its bf16 and f32 kernels apart
KERNELS = {
    "B1_fwd_packed": ("fused", "_fwd_packed", "launches_bf16", FUSED_CU,
                      "gym_tpu/ops/fused_attention.py:246"),
    "B2_bwd_packed": ("fused", "_bwd_packed", "launches_bf16", FUSED_CU,
                      "gym_tpu/ops/fused_attention.py:267"),
    "B3_blk_fwd": ("fused", "_blk_fwd", "launches", FUSED_CU,
                   "gym_tpu/ops/fused_attention.py:137"),
    "B4_blk_bwd": ("fused", "_blk_bwd", "launches", FUSED_CU,
                   "gym_tpu/ops/fused_attention.py:153"),
    "B5f_flash_fwd": ("flash", "_flash_fwd", "launches_bf16", FLASH_CU,
                      f"{BUNDLED}:758"),
    "B5b_flash_bwd": ("flash", "_flash_bwd", "launches", FUSED_CU,
                      f"{BUNDLED}:1121 and :1456"),
    # no pallas_call: XLA's threefry2x32 lowering of jax.random.bernoulli,
    # which SPARTA's masks reach, all of a step's in one launch
    "T1_threefry_bernoulli": ("threefry", "bernoulli_segments", "launches",
                              THREEFRY_CU, "gym_tpu/strategy/sparta.py:60"),
    # the f32 instantiations of the packed pair: the path of config 4,
    # which trains without autocast, and of every eval
    "B1_fwd_packed_f32": ("fused", "_fwd_packed", "launches_f32", FUSED_CU,
                          "gym_tpu/ops/fused_attention.py:246"),
    "B2_bwd_packed_f32": ("fused", "_bwd_packed", "launches_f32", FUSED_CU,
                          "gym_tpu/ops/fused_attention.py:267"),
    # the f32 long-context forward: every eval of the long-context config
    "B5f_flash_fwd_f32": ("flash", "_flash_fwd", "launches_f32", FLASH_CU,
                          f"{BUNDLED}:758"),
    # T1 with a key per row: flax nn.Dropout's jax.random.bernoulli, one
    # mask a node, drawn for all the nodes in one launch
    "T1_threefry_bernoulli_rows": ("threefry", "bernoulli_rows", "launches",
                                   THREEFRY_CU,
                                   "gym_tpu/models/mnist_cnn.py:36,45"),
}
# GPT-2 base (12L/12H/768, vocab 50304, T=1024), phases 5 and 8
GPT2_BASE = dict(block_size=1024, vocab_size=50304, n_layer=12, n_head=12,
                 n_embd=768, attn_impl="flash")
# the bits of the (fold_in(fold_in(PRNGKey(7), leaf), 0), step) keys
# SPARTA's masks use; three leaves and steps for phase 3
THREEFRY_KEYS = ((0, 0), (146, 3), (37, 1000))
THREEFRY_N = (1, 4097, 786_432, 38_633_472)  # 38,633,472: GPT-2 base wte
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
# the docs stream of the checkout's gym_tpu/: tokens and crc32 of its bytes
DOCS_TOKENS, DOCS_CRC = 279_562, 1349009140


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


def int32_rate(torch) -> float:
    """int32 instructions a second at the dispatch limit: 128 lanes a clock
    on each SM at the card's highest SM clock (``nvidia-smi``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = DISPATCH_LANES_PER_SM * sms * mhz * 1e6
    log(f"  {sms} SMs, highest SM clock {mhz:.0f} MHz: int32 instructions "
        f"at the dispatch limit {rate / 1e12:.2f} TOP/s")
    return rate


# -- phase 2: what the compiler made ----------------------------------------

SASS_OPS = ("HGMMA", "HMMA", "FFMA", "ATOM/RED", "ALU")
# per-thread integer and float-compare ALU instructions (the uniform
# datapath's U* instructions run once a warp and are not counted)
ALU_OPS = {"IADD3", "IADD", "VIADD", "IMAD", "IMUL", "LOP3", "LOP", "SHF",
           "SHL", "SHR", "ISETP", "LEA", "PRMT", "SEL", "IMNMX", "VIMNMX",
           "IABS", "FADD", "FSETP", "FSEL", "FMUL"}
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
            counts[name] = dict.fromkeys(SASS_OPS + ("ROT",), 0)
            continue
        m = _SASS_INSN.match(line)
        if name is None or not m:
            continue
        op = m.group(1)
        if op in ("ATOM", "ATOMS", "ATOMG", "RED", "REDG"):
            op = "ATOM/RED"
        if op in ALU_OPS:
            counts[name]["ALU"] += 1
        if "SHF.L.W" in line:  # a 32-bit rotate: a funnel shift that wraps
            counts[name]["ROT"] += 1
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


# kernels the f32 long-context forward and T1's segments replaced
GONE = ("flash_fwd_kernel", "threefry_rows_kernel", "threefry_kernel<true>",
        "threefry_kernel<(bool)1>")


def check_sass(counts):
    """Every bf16 wgmma kernel and every f32 3xTF32 kernel uses the tensor
    cores; no kernel has an atomic; the replaced kernels are gone."""
    wgmma = [k for k in counts if "wgmma" in k]
    check(len(wgmma) == 16, f"expected 16 bf16 wgmma kernels (forward, dq, "
          f"dk/dv and the long-context forward at 4 head dims), found "
          f"{len(wgmma)}: {wgmma}")
    flash = [k for k in wgmma if "flash_fwd_wgmma" in k]
    check(len(flash) == 4, f"expected flash_fwd_wgmma at 4 head dims, found "
          f"{flash}")
    # the products of the f32 kernels; the long-context forward's pre-pass
    # (split_kv_tf32x3) only splits k and v
    tf32 = [k for k in counts if "tf32x3" in k and "split_kv" not in k]
    check(len(tf32) == 32, f"expected 32 f32 3xTF32 kernels (forward, dq, "
          f"dk/dv and the long-context forward at 4 head dims and 2 copy "
          f"widths), found {len(tf32)}: {tf32}")
    # the head dim: the first template argument, demangled or not
    long_f32 = {re.search(r"flash_fwd_tf32x3(?:<\D*|ILi)(\d+)", k).group(1)
                for k in tf32 if "flash_fwd_tf32x3" in k}
    check(long_f32 == {"16", "32", "64", "128"}, f"expected "
          f"flash_fwd_tf32x3 at D = 16, 32, 64, 128, found {long_f32}")
    gone = [k for k in counts if any(g in k for g in GONE)]
    check(not gone, f"replaced kernels still built: {gone}")
    for k in sorted(counts):
        c = counts[k]
        log("  " + k + ": " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS))
        check(c["ATOM/RED"] == 0, f"{k}: {c['ATOM/RED']} atomic instructions")
        if k in wgmma or k in tf32:
            check(c["HGMMA"] > 0, f"{k}: no HGMMA (wgmma) instruction")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores")
_TF32_KERNEL = re.compile(
    r"(attn_fwd|attn_dq|attn_dkdv|flash_fwd|split_kv)_tf32x3ILi(\d+)ELi(\d+)E")


def f32_kernel_report(build_log, lib):
    """The f32 (3xTF32) kernels' registers and spill stores from the
    ``ptxas`` report, and their dynamic shared memory, a line per head
    dim."""
    found, name = {}, None
    for line in build_log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name, spill = _TF32_KERNEL.search(m.group(1)), 0
            continue
        m = _PTXAS_SPILL.search(line)
        if m and name:
            spill = int(m.group(1))
        m = _PTXAS_USED.search(line)
        if m and name:
            kind, d, vec = name.groups()
            found[(kind, int(d), int(vec))] = (int(m.group(1)), spill)
            name = None
    # dynamic shared memory (gym_attn_smem_bytes); the pre-pass has static
    # shared memory only (the ptxas report)
    smem_id = {"attn_fwd": 0, "attn_dkdv": 1, "attn_dq": 2, "flash_fwd": 3}

    def copies(kind, d, vec):
        regs, spill = found.get((kind, d, vec), ("?", "?"))
        return (f"{16 if vec == 4 else 4}-byte copies {regs} registers "
                f"{spill} B spilled")

    for d in (16, 32, 64, 128):
        log(f"  f32 3xTF32 kernels at D={d}: " + "; ".join(
            f"{kind}"
            + (f" {lib.gym_attn_smem_bytes(smem_id[kind], d)} B smem"
               if kind in smem_id else "")
            + f", {copies(kind, d, 4)}, {copies(kind, d, 1)}"
            for kind in ("attn_fwd", "attn_dq", "attn_dkdv", "split_kv",
                         "flash_fwd")))


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
        if not errs:
            o2, lse2 = tflash._flash_fwd(*heads, scale)
            same = torch.equal(o, o2) and torch.equal(lse, lse2)
            log(f"  B5f {dn} run twice: o, lse "
                f"{'bit-identical' if same else 'DIFFER'}")
            check(same, f"B5f: two runs of the {dn} forward differ")
            del o2, lse2
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


def same_twice(torch, name, first, again):
    """Two runs of a kernel on the same inputs: identical outputs."""
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    log(f"  {name} run twice: {'bit-identical' if same else 'DIFFER'}")
    check(same, f"{name}: two runs on the same inputs differ")


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
        if dtype == torch.float32:
            same_twice(torch, "B1 f32 o, lse", (o, lse),
                       tfa._fwd_packed(q, k, v, scale, h))
            same_twice(torch, "B2 f32 dq, dk, dv", got,
                       tfa._bwd_packed(q, k, v, o, do, lse, scale, h))
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
            if dtype == torch.float32:
                same_twice(torch, "B3 f32 o, lse", (o, lse),
                           tfa._blk_fwd(*heads, 0.125, causal))
                same_twice(torch, "B4 f32 dq, dk, dv", got, tfa._blk_bwd(
                    *heads, o, do, lse, dlse, 0.125, causal))
            if causal:
                e3, e4 = ef, eb
            del qkv, heads, do, dlse, o, lse, ro, rl, got, ref
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        e5f, e5b = check_long_context(
            torch, tflash, (shapes["long"], shapes["long_tuned_blocks"],
                            shapes["long_default_blocks"]), g, dtype)
        if dtype == torch.bfloat16:  # the training runs' dtype
            errs.update(B1_fwd_packed=e1, B2_bwd_packed=e2, B3_blk_fwd=e3,
                        B4_blk_bwd=e4, B5f_flash_fwd=e5f, B5b_flash_bwd=e5b)
        else:  # the evals' long-context forward
            errs["B5f_flash_fwd_f32"] = e5f
    return errs


def threefry_ops_per_element(counts):
    """ALU instructions of the Bernoulli mask kernel per element, counted
    from its SASS, a diagnostic beside the bound's THREEFRY_LEAST_OPS: every
    threefry evaluation has exactly 20 rotations (``SHF.L.W``), so the
    kernel's ALU count over its rotations / 20 is the work of one element,
    the loop's and the last group's instructions shared out among the
    evaluations."""
    name = [k for k in counts if "threefry_segments_kernel" in k]
    check(len(name) == 1, f"expected one Bernoulli mask kernel in the "
          f"SASS, found {name}")
    c = counts[name[0]]
    check(c["ROT"] >= 20 and c["ROT"] % 20 == 0, f"T1: {c['ROT']} "
          f"rotations are not whole threefry evaluations")
    evals = c["ROT"] // 20
    ops = c["ALU"] / evals
    log(f"  T1 {name[0]}: {c['ALU']} ALU instructions, {c['ROT']} rotations "
        f"= {evals} threefry evaluations in the code (4 a group), {ops:.2f} "
        f"an element (the least, which the bound counts: "
        f"{THREEFRY_LEAST_OPS})")
    check(THREEFRY_LEAST_OPS <= ops <= 160, f"T1: {ops} ALU instructions an element is "
          f"outside 73-160")
    return ops


def threefry_key(tf, leaf, step, seed=7):
    return tf.fold_in(tf.fold_in(tf.fold_in(tf.PRNGKey(seed), leaf), 0),
                      step)


# the mixed table's own segment sizes: empty, shorter than a group, one
# group, a group and one, and lengths that end inside a group
SEGMENT_SIZES = [0, 1, 3, 4, 5, 1023, 4097]


def hold_segments(torch, tf, keys, p, sizes, what):
    """One ``bernoulli_segments`` launch against the twin's masks, segment
    by segment; every segment 16-byte aligned. Returns the elements that
    differ (0)."""
    before = tf.bernoulli_segments.launches
    buf, views = tf.bernoulli_segments(keys, p, sizes, "cuda")
    check(tf.bernoulli_segments.launches == before + 1,
          f"T1 segments {what}: not one launch")
    refs = tf.plain_bernoulli_segments(keys, p, sizes, "cuda")
    diff = 0
    for i, (got, ref) in enumerate(zip(views, refs)):
        check((got.data_ptr() - buf.data_ptr()) % 16 == 0,
              f"T1 segments {what}: segment {i} not 16-byte aligned")
        diff += int((got != ref).sum())
    check(diff == 0, f"T1 segments {what}: {diff} elements differ from the "
          f"twin")
    return diff


def check_threefry(torch, tf):
    """The bits and mask kernels against the plain twin, bit for bit, and
    the card's permutation against the twin's (the twin runs on the card
    here too, for speed). Returns the largest |kernel − twin| (0)."""
    worst = 0
    for n in THREEFRY_N:
        for leaf, step in THREEFRY_KEYS:
            key = threefry_key(tf, leaf, step)
            got = tf.random_bits(key, n, "cuda")
            ref = tf.plain_random_bits(key, n, "cuda")
            diff = int((got != ref).sum())
            worst = max(worst, diff)
            check(diff == 0, f"T1 bits n={n} key {key}: {diff} elements "
                  f"differ from the twin")
            for p in (0.005, 0.5):
                got = tf.bernoulli(key, p, n, "cuda")
                ref = tf.plain_bernoulli(key, p, n, "cuda")
                diff = int((got != ref).sum())
                worst = max(worst, diff)
                check(diff == 0, f"T1 mask n={n} p={p} key {key}: {diff} "
                      f"elements differ from the twin")
            del got, ref
        log(f"  T1 threefry n={n}: bits and masks (p 0.005, 0.5) of "
            f"{len(THREEFRY_KEYS)} keys bit-identical to the twin")
    # past 2^32 elements the counter's hi word is 1: the mask kernel's last
    # elements against the twin at those indices (4 GiB of mask)
    n = 2 ** 32 + 4097
    key = threefry_key(tf, 146, 3)
    tail = tf.bernoulli(key, 0.5, n, "cuda")[-8192:]
    idx = torch.arange(n - 8192, n, dtype=torch.int64, device="cuda")
    ref = tf.bits_to_uniform(tf.plain_bits_at(key, idx)) < 0.5
    diff = int((tail != ref).sum())
    worst = max(worst, diff)
    log(f"  T1 threefry n={n}: the last 8192 elements "
        f"{'bit-identical to' if diff == 0 else 'DIFFER FROM'} the twin")
    check(diff == 0, f"T1 mask past 2^32: {diff} elements differ")
    del tail, idx, ref
    # T1's segments: a mixed table, then SPARTA's masks of the CNN's leaves
    # over phase 9c's 8 steps, each step one launch as SPARTA draws them
    sizes = SEGMENT_SIZES + [n for _, n in gpt_leaves(GPT2_BASE)]
    keys = [threefry_key(tf, i, 3) for i in range(len(sizes))]
    for p in (0.005, 0.5):
        worst = max(worst, hold_segments(torch, tf, keys, p, sizes,
                                         f"mixed table p={p}"))
    log(f"  T1 segments: one launch for {len(sizes)} segments (sizes "
        f"{SEGMENT_SIZES} and GPT-2 base's {len(sizes) - len(SEGMENT_SIZES)}"
        f" leaves), p 0.005 and 0.5: bit-identical to the twin, each "
        f"segment 16-byte aligned")
    leaves = cnn_leaves()
    for step in range(8):
        keys = [threefry_key(tf, leaf, step) for leaf, _ in leaves]
        worst = max(worst, hold_segments(
            torch, tf, keys, 0.005, [n for _, n in leaves],
            f"CNN leaves step {step}"))
    log(f"  T1 segments at the CNN's {len(leaves)} SPARTA leaves "
        f"({min(n for _, n in leaves)}-{max(n for _, n in leaves)} "
        f"elements), p 0.005, steps 0-7, one launch a step: bit-identical "
        f"to the twin")
    torch.cuda.empty_cache()
    n = THREEFRY_N[-1]
    key = threefry_key(tf, 0, 0)
    perm = tf.permutation(key, n, "cuda")
    twin = torch.arange(n, dtype=torch.int64, device="cuda")
    for _ in range(tf.sort_rounds(n)):
        key, sub = tf.split(key)
        bits = tf.plain_random_bits(sub, n, "cuda") ^ -0x80000000
        twin = twin[torch.sort(bits, stable=True).indices]
    same = torch.equal(perm, twin)
    log(f"  permutation n={n} ({tf.sort_rounds(n)} sort rounds): card "
        f"{'equals' if same else 'DIFFERS FROM'} the twin")
    check(same, "permutation on the card differs from the twin")
    del perm, twin
    torch.cuda.empty_cache()
    return float(worst)


def dropout_tables(tf, nodes, step, n_micro=4, seed=0):
    """A step's dropout key tables as the training step derives them from
    the K node keys: [microbatch][dropout] of [K, 2]."""
    from gym_tpu_torch.train_node import micro_keys
    mk = micro_keys(tf.node_keys(seed, nodes), step, n_micro)
    return [tf.fold_in_paths(mk[i], cnn_dropout_paths())
            for i in range(n_micro)]


def check_threefry_rows(torch, tf):
    """The per-row mask kernel against its twin, bit for bit: at phase 9's
    dropouts (a step's 3 × 4 launches at a microbatch of 64, K = 8 and
    K = 2, two steps), and at 32 rows of 4096 elements (aligned rows) and
    of 191 (rows that start unaligned)."""
    import numpy as np
    worst = 0

    def hold(keys, p, n, what):
        nonlocal worst
        got = tf.bernoulli_rows(keys, p, n, "cuda")
        ref = tf.plain_bernoulli_rows(keys, p, n, "cuda")
        diff = int((got != ref).sum())
        worst = max(worst, diff)
        check(diff == 0, f"T1 rows {what} n={n} p={p}: {diff} elements "
              f"differ from the twin")

    for nodes in (8, 2):
        for step in (0, 3):
            for sites in dropout_tables(tf, nodes, step):
                for keys, (width, keep) in zip(sites, CNN_DROPOUTS):
                    hold(keys, keep, MNIST_MICRO * width,
                         f"K={nodes} step {step}")
        log(f"  T1 per-row masks at phase 9's dropouts, K={nodes} rows x "
            f"{[MNIST_MICRO * w for w, _ in CNN_DROPOUTS]}, steps 0 and 3: "
            f"bit-identical to the twin")
    # the first dropout's keys over 4 microbatches of 8 nodes
    table = np.concatenate([sites[0] for sites in dropout_tables(tf, 8, 3)])
    for n in (4096, 64 * 3 - 1):
        for p in (0.75, 0.5):
            hold(table, p, n, f"{table.shape[0]} rows")
        log(f"  T1 per-row masks, {table.shape[0]} rows x {n}: bit-identical "
            f"to the twin (p 0.75, 0.5)")
    return float(worst)


# -- phases 4-6: training through Trainer.fit --------------------------------


SCHED = dict(lr_scheduler="lambda_cosine",
             lr_scheduler_kwargs={"warmup_steps": 2})


def diloco():
    from gym_tpu_torch.strategy import DiLoCoStrategy, OptimSpec
    return DiLoCoStrategy(optim_spec=OptimSpec("adamw", lr=3e-4), H=2,
                          **SCHED)


def gpt_fit(torch, cfg_kw, nodes, batch, steps, device, autocast, seed,
            run_name, init_params=None, tokens=200_000, strategy=None):
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import ContiguousGPTTrainDataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    import numpy as np

    cfg = GPTConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, tokens).astype(np.int32)
    cut = tokens * 9 // 10
    ds = ContiguousGPTTrainDataset(toks[:cut], cfg.block_size)
    val = ContiguousGPTTrainDataset(toks[cut:], cfg.block_size)
    strategy = strategy if strategy is not None else diloco()
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
    return {k: getattr(getattr(mods[m], w), c)
            for k, (m, w, c, _, _) in KERNELS.items()}


def train_phase(torch, mods, title, cfg_kw, nodes, batch, steps, want,
                tokens=200_000, strategy=None):
    log(f"{title}: K={nodes} x {batch} rows, {steps} steps, bf16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts(mods)
    t0 = time.perf_counter()
    res = gpt_fit(torch, cfg_kw, nodes, batch, steps, "cuda", True, 0, title,
                  tokens=tokens, strategy=strategy)
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
    want = {"B5f_flash_fwd": layers * 2 * steps,
            "B5f_flash_fwd_f32": layers * evals,
            "B5b_flash_bwd": layers * steps}
    got = {k: counts[k] for k in want}
    check(got == want, f"{title}: B5 launches {got}, expected {want} "
          f"({layers} layers, {steps} steps under remat, {evals} eval "
          f"forwards)")
    sps = res.steps_per_second_steady or res.steps_per_second
    mfu = node_mfu(GPTConfig(**cfg_kw), res.node_state.params, nodes,
                   1.0 / sps, peak_flops=BF16_FLOPS)
    log(f"  B5 launches as expected: bf16 forward {want['B5f_flash_fwd']} = "
        f"{layers} x 2 x {steps} steps, f32 forward "
        f"{want['B5f_flash_fwd_f32']} = {layers} x {evals} eval forwards, "
        f"backward {want['B5b_flash_bwd']}")
    log(f"  one f32 eval (K={nodes} x 1 row, node 0's and the mean params): "
        f"{time_eval(torch, cfg_kw, nodes):.1f} ms (median of 3; "
        f"scripts/eval_time.py compares checkouts)")
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


def time_eval(torch, cfg_kw, nodes, reps=3):
    """ms of one f32 eval of the GPT at ``cfg_kw`` as ``Trainer.fit`` runs
    it (``make_eval_step``: node 0's params and the node mean, one
    validation row a node), on random weights (seed 0) and tokens; the host
    clock around a synchronise, median of ``reps`` after one warm-up."""
    import types
    from gym_tpu_torch.models.base import LossModel
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.parallel.axis import AxisCtx
    from gym_tpu_torch.train_node import make_eval_step
    cfg = GPTConfig(**cfg_kw)
    model = LossModel(GPT(cfg))
    params, model_state = model.init(nodes, 0, "cuda")
    state = types.SimpleNamespace(params=params, model_state=model_state)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = tuple(torch.randint(0, cfg.vocab_size,
                                (nodes, 1, 1, cfg.block_size), device="cuda",
                                generator=g) for _ in range(2))
    step = make_eval_step(model, AxisCtx(nodes))
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    del params, state, batch
    torch.cuda.empty_cache()
    return sorted(times[1:])[reps // 2]


def card_vs_cpu(torch, mods, cfg_kw, nodes, batch, steps, tokens, want=(),
                strategy_fn=diloco, label=""):
    """Train losses and global evals of the same fit on the card and on the
    CPU; ``want`` names kernels the card run must have launched, in both
    modes or ({mode: names}) in each."""
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    t = f"{cfg_kw['block_size']}{label}"
    init = {n: p[0] for n, p in GPT(GPTConfig(**cfg_kw)).init_params(
        1, seed=11, device="cpu").items()}
    for mode, autocast in (("bf16", True), ("f32", False)):
        out = {}
        for device in ("cuda", "cpu"):
            reset_counts(mods)
            res = gpt_fit(torch, cfg_kw, nodes, batch, steps, device,
                          autocast, 5, f"card_vs_cpu_T{t}_{mode}_{device}",
                          init_params=init, tokens=tokens,
                          strategy=strategy_fn())
            out[device] = [l for _, l in res.history["train_loss"]] + [
                l for _, l in res.history["global_loss"]]
            if device == "cuda":
                counts = read_counts(mods)
                for name in (want[mode] if isinstance(want, dict) else want):
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


def attn_flops(n, h, t, d, backward, causal=True):
    """The products of attention: 2 (forward) or 5 (backward) of 2·D flops
    a pair; causal pairs only."""
    pairs = n * h * (t * (t + 1) // 2 if causal else t * t)
    return 2 * d * pairs * (5 if backward else 2)


def bound_parts(n, h, t, d, itemsize, backward, causal=True):
    """(bytes ms, operations ms): each input read once and each output
    written once at 3.35 TB/s; the products on the tensor cores, at 989
    TFLOP/s (bf16) or as three TF32 products each at 495 TFLOP/s (f32, in
    split-precision TF32, which meets the f32 tolerance)."""
    elems = n * h * t * d
    stats = n * h * t * 4
    # backward: read q k v o do lse, write dq dk dv; forward: read q k v,
    # write o lse
    nbytes = (8 if backward else 4) * elems * itemsize + stats
    flops = attn_flops(n, h, t, d, backward, causal)
    t_ops = (flops / BF16_FLOPS if itemsize == 2
             else TF32_SPLIT * flops / TF32_FLOPS)
    return nbytes / HBM_BYTES_PER_S * 1e3, t_ops * 1e3


def bound(n, h, t, d, itemsize, backward, causal=True):
    """Least time (ms) for the work, the larger of ``bound_parts``."""
    t_bytes, t_ops = bound_parts(n, h, t, d, itemsize, backward, causal)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ffma_ms(n, h, t, d, backward, causal=True):
    """The products at the 67 TFLOP/s of f32 FMAs (ms): printed beside an
    f32 bound for comparison, not a bound."""
    return attn_flops(n, h, t, d, backward, causal) / F32_FLOPS * 1e3


def tile_tflops(n, h, t, d, products, ms, causal=True):
    """TFLOP/s of the 64 x 64 tiles a kernel computes: causal, the tiles on
    or below the diagonal, diagonal tiles whole (B5f's 128-row blocks
    compute the same tiles: warpgroup 0 skips its block's last key tile),
    ``products`` matrix products of 2·D flops a pair each."""
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
    f32 = time_long_f32(torch, tfa, tflash, g, n, h, t, d)
    for name, r in out.items():
        b, by = r["bound"]
        log(f"{name} [{r['shape']}]: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"bound_ms {b:.4f} ({by}) -> {b / r['ms']:.1%} of bound, "
            f"{tile_tflops(*r['work'], r['ms']):.1f} TFLOP/s of computed "
            f"64 x 64 tiles on or below the diagonal ({r['work'][-1]} "
            f"products)")
    out["B5f_flash_fwd_f32"] = f32
    return out


def time_long_f32(torch, tfa, tflash, g, n, h, t, d):
    """The f32 long-context forward (pre-pass and forward) on per-head
    views at B5f's shape, its pre-pass alone, its plain version, f32 SDPA,
    the bound, and the whole-context f32 forward (``attn_fwd_tf32x3``, which
    computes the same function: launched directly, since ``_blk_fwd``'s gate
    is for T <= 1024)."""
    import torch.nn.functional as F
    from gym_tpu_torch.ops import _build
    scale = 1.0 / math.sqrt(d)
    heads, _ = per_head_views(torch, g, n, h, t, d, torch.float32)
    o = torch.empty(n, h, t, d, device="cuda")
    lse = torch.empty(n, h, t, 1, device="cuda")
    strides = [int(v) for x in (*heads, o, lse)
               for v in tfa._strides(x, "blk")]
    work = torch.empty(16 * n * h * t * d, dtype=torch.uint8, device="cuda")
    lib = _build.load()
    st = (ctypes.c_longlong * 15)(*strides)

    def split():
        code = lib.gym_flash_split_kv(*(x.data_ptr() for x in (*heads, o)),
                                      work.data_ptr(), st, n, h, t, d,
                                      tfa._stream(o))
        _build.check(lib, code, "gym_flash_split_kv")

    r = dict(ms=timed(torch, lambda: tflash._flash_fwd(*heads, scale),
                      inner=3),
             plain_ms=timed(torch, lambda: tflash.plain_flash_fwd(
                 *heads, scale), reps=3, inner=1),
             library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
                 *heads, is_causal=True, scale=scale), inner=3),
             shape=f"N={n} H={h} T={t} D={d} f32 per-head views",
             bound=bound(n, h, t, d, 4, False), work=(n, h, t, d, 2),
             backward=False)
    split_ms = timed(torch, split, inner=3)
    whole_ms = timed(torch, lambda: tfa._launch_fwd(
        *heads, o, lse, strides, n, h, t, d, True, scale), inner=3)
    log_f32("B5f_flash_fwd_f32 (pre-pass and flash_fwd_tf32x3)", r)
    # the pre-pass reads k and v and writes four split copies of them
    split_bytes = 6 * n * h * t * d * 4
    log(f"  B5f f32 pre-pass split_kv_tf32x3 alone: {split_ms:.4f} ms "
        f"({split_bytes / 1e6:.0f} MB, bound "
        f"{split_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s), "
        f"{split_ms / r['ms']:.1%} of the forward; the whole-context "
        f"attn_fwd_tf32x3 at this shape {whole_ms:.4f} ms, "
        f"{whole_ms / r['ms']:.2f}x the long-context forward's time")
    check(r["ms"] < whole_ms and r["ms"] < r["library_ms"],
          f"B5f f32: {r['ms']:.4f} ms is not faster than attn_fwd_tf32x3 "
          f"({whole_ms:.4f}) and f32 SDPA ({r['library_ms']:.4f})")
    del heads, o, lse, work
    torch.cuda.empty_cache()
    return r


def gpt_leaves(cfg_kw):
    """(JAX leaf index, per-node element count) of every leaf of the GPT,
    in the port's dict order, from the parameter shapes alone."""
    from gym_tpu_torch.convert import jax_leaf_order
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    specs = GPT(GPTConfig(**cfg_kw))._param_specs()
    order = jax_leaf_order(specs)
    return [(order[n], math.prod(shape)) for n, (shape, _) in specs.items()]


def time_threefry(torch, tf, leaves, sass_ops, int32_ops_per_s, p=0.005):
    """T1 at phase 8a's shapes: the masks of every leaf for one SPARTA
    step, in one launch (``bernoulli_segments``, the segment table's upload
    included); its twin on the card; the bound, from the least operations
    an element (the compiled kernel's ``sass_ops`` is printed beside it);
    and the largest leaf alone."""
    keys = [threefry_key(tf, i, 0) for i, _ in leaves]
    sizes = [n for _, n in leaves]
    total = sum(sizes)
    t_bytes = total / HBM_BYTES_PER_S  # one byte written an element
    t_ops = total * THREEFRY_LEAST_OPS / int32_ops_per_s
    r = dict(ms=timed(torch, lambda: tf.bernoulli_segments(
                 keys, p, sizes, "cuda")),
             plain_ms=timed(torch, lambda: tf.plain_bernoulli_segments(
                 keys, p, sizes, "cuda"), reps=3, inner=1),
             library_ms=None,
             bound=(max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations"))
    n = max(sizes)
    key = keys[sizes.index(n)]
    one = timed(torch, lambda: tf.bernoulli(key, p, n, "cuda"))
    log(f"T1 the largest leaf alone ({n} elements): {one:.4f} ms, bound "
        f"{n * THREEFRY_LEAST_OPS / int32_ops_per_s * 1e3:.4f} ms")
    log(f"T1_threefry_bernoulli [{len(leaves)} leaves, {total} elements, "
        f"p {p}, one launch]: kernel_ms {r['ms']:.4f} plain_ms "
        f"{r['plain_ms']:.4f} (twin, int64) library_ms none (no PyTorch "
        f"call computes threefry2x32) bound_ms {r['bound'][0]:.4f} "
        f"({r['bound'][1]}: {THREEFRY_LEAST_OPS} ops an element at "
        f"{int32_ops_per_s / 1e12:.2f} TOP/s int32; bytes "
        f"{t_bytes * 1e3:.4f} ms; at the compiled kernel's {sass_ops:.2f} "
        f"ops an element {total * sass_ops / int32_ops_per_s * 1e3:.4f} ms) "
        f"-> {r['bound'][0] / r['ms']:.1%} of bound")
    torch.cuda.empty_cache()
    return r


def log_f32(name, r):
    """One f32 timing line: the kernel beside its plain version, f32 SDPA
    and its bound (bytes, or three TF32 products each), and the products at
    the 67 TFLOP/s of f32 FMAs for comparison."""
    n, h, t, d, _ = r["work"]
    t_bytes, t_ops = bound_parts(n, h, t, d, 4, r["backward"])
    b = max(t_bytes, t_ops)
    plain = "" if r["plain_ms"] is None else f"plain_ms {r['plain_ms']:.4f} "
    log(f"{name} [{r['shape']}]: kernel_ms {r['ms']:.4f} {plain}library_ms "
        f"{r['library_ms']:.4f} (f32 SDPA) bound_ms {b:.4f} (bytes "
        f"{t_bytes:.4f} at 3.35 TB/s; 3 x the products at "
        f"{TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 {t_ops:.4f}) -> "
        f"{b / r['ms']:.1%} of bound; the products at "
        f"{F32_FLOPS / 1e12:.0f} TFLOP/s of f32 FMAs "
        f"{ffma_ms(n, h, t, d, r['backward']):.4f} ms (comparison only); "
        f"{tile_tflops(*r['work'], r['ms']):.1f} TFLOP/s of computed 64 x 64 "
        f"tiles ({r['work'][-1]} f32 products)")


def time_packed_f32(torch, tfa, shape):
    """The f32 packed pair (3xTF32 wgmma) at config 4's shape: held to the
    plain version there (phase 3's f32 tolerance), then timed beside it, f32
    ``scaled_dot_product_attention`` and the bound."""
    import torch.nn.functional as F
    n, t, c, h = shape
    d = c // h
    scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(n, t, 3 * c, device="cuda", generator=g)
    q, k, v = qkv.split(c, dim=-1)
    do = torch.randn(n, t, c, device="cuda", generator=g)
    log(f"B1/B2 packed float32 N={n} T={t} C={c} H={h} (config 4, strided "
        f"views):")
    o, lse = tfa._fwd_packed(q, k, v, scale, h)
    ro, rl = tfa.plain_fwd_packed(q, k, v, scale, h)
    errs = {"B1_fwd_packed_f32": max(compare("B1 o", o, ro, "out", f32),
                                     compare("B1 lse", lse, rl, "lse", f32))}
    got = tfa._bwd_packed(q, k, v, o, do, lse, scale, h)
    ref = tfa.plain_bwd_packed(q, k, v, o, do, lse, scale, h)
    errs["B2_bwd_packed_f32"] = max(
        compare(f"B2 {nm}", a, b, "out", f32)
        for nm, a, b in zip(("dq", "dk", "dv"), got, ref))
    lib = [x.view(n, t, h, d).transpose(1, 2).detach().requires_grad_(True)
           for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=scale)
    ldo = do.view(n, t, h, d).transpose(1, 2)
    desc = f"N={n} T={t} C={c} H={h} f32 packed views"
    out = {
        "B1_fwd_packed_f32": dict(
            ms=timed(torch, lambda: tfa._fwd_packed(q, k, v, scale, h)),
            plain_ms=timed(torch, lambda: tfa.plain_fwd_packed(
                q, k, v, scale, h), inner=3),
            library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
                *[x.detach() for x in lib], is_causal=True, scale=scale)),
            shape=desc, bound=bound(n, h, t, d, 4, False),
            work=(n, h, t, d, 2), backward=False),
        "B2_bwd_packed_f32": dict(
            ms=timed(torch, lambda: tfa._bwd_packed(q, k, v, o, do, lse,
                                                    scale, h)),
            plain_ms=timed(torch, lambda: tfa.plain_bwd_packed(
                q, k, v, o, do, lse, scale, h), inner=3),
            library_ms=timed(torch, lambda: torch.autograd.grad(
                lo, lib, ldo, retain_graph=True)),
            shape=desc, bound=bound(n, h, t, d, 4, True),
            work=(n, h, t, d, 7), backward=True)}
    for name, r in out.items():
        log_f32(name, r)
    del qkv, q, k, v, do, o, lse, ro, rl, got, ref, lib, lo, ldo
    torch.cuda.empty_cache()
    return out, errs


def time_heads_f32(torch, tfa, shape):
    """The same f32 kernels on per-head views at B3/B4's shape (GPT-2
    base's f32 evals run this forward), timed as ``time_packed_f32``."""
    import torch.nn.functional as F
    n, h, t, d = shape
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(n, t, 3 * h * d, device="cuda", generator=g)
    heads = [z.reshape(n, t, h, d).transpose(1, 2)
             for z in qkv.split(h * d, dim=-1)]
    do = torch.randn(n, h, t, d, device="cuda", generator=g)
    o, lse = tfa._blk_fwd(*heads, 0.125, True)
    lib = [x.detach().requires_grad_(True) for x in heads]
    lo = F.scaled_dot_product_attention(*lib, is_causal=True, scale=0.125)
    desc = f"N={n} H={h} T={t} D={d} f32 per-head views"
    log_f32("B3 f32 (per-head forward)", dict(
        ms=timed(torch, lambda: tfa._blk_fwd(*heads, 0.125, True)),
        plain_ms=timed(torch, lambda: tfa.plain_fwd(*heads, 0.125, True),
                       inner=3),
        library_ms=timed(torch, lambda: F.scaled_dot_product_attention(
            *heads, is_causal=True, scale=0.125)),
        shape=desc, work=(n, h, t, d, 2), backward=False))
    log_f32("B4 f32 (per-head backward)", dict(
        ms=timed(torch, lambda: tfa._blk_bwd(*heads, o, do, lse, None, 0.125,
                                             True)),
        plain_ms=timed(torch, lambda: tfa.plain_bwd(
            *heads, o, do, lse, None, 0.125, True), inner=3),
        library_ms=timed(torch, lambda: torch.autograd.grad(
            lo, lib, do, retain_graph=True)),
        shape=desc, work=(n, h, t, d, 7), backward=True))
    del qkv, heads, do, o, lse, lib, lo
    torch.cuda.empty_cache()


# the CNN's three dropouts at a microbatch of 64: masks of [64, 1, 1, 64],
# [64, 1, 1, 128] and [64, 256] a node, keep 0.75, 0.75 and 0.5
CNN_DROPOUTS = ((64, 0.75), (128, 0.75), (256, 0.5))


def time_threefry_rows(torch, tf, int32_ops_per_s, nodes=8, micro=64,
                       n_micro=4):
    """T1's per-row entry at config 2's dropout shapes: a step's 12
    launches (3 dropouts × 4 microbatches, each over the 8 nodes' keys),
    its twin, the bound; and the host's key algebra a step (the step and
    microbatch folds, then each dropout's path)."""
    from gym_tpu_torch.train_node import micro_keys
    paths = cnn_dropout_paths()
    node = tf.node_keys(0, nodes)
    t0 = time.perf_counter()
    for step in range(50):
        mk = micro_keys(node, step, n_micro)
        for i in range(n_micro):
            tf.fold_in_paths(mk[i], paths)
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    tables = dropout_tables(tf, nodes, 3, n_micro)

    def run(draw):
        for sites in tables:
            for keys, (width, keep) in zip(sites, CNN_DROPOUTS):
                draw(keys, keep, micro * width, "cuda")

    total = nodes * n_micro * micro * sum(w for w, _ in CNN_DROPOUTS)
    t_bytes = total / HBM_BYTES_PER_S
    t_ops = total * THREEFRY_LEAST_OPS / int32_ops_per_s
    r = dict(ms=timed(torch, lambda: run(tf.bernoulli_rows), inner=2),
             plain_ms=timed(torch, lambda: run(tf.plain_bernoulli_rows),
                            reps=3, inner=1),
             library_ms=None,
             bound=(max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations"))
    launches = n_micro * len(CNN_DROPOUTS)
    log(f"T1_threefry_bernoulli_rows [config 2's dropouts: {launches} "
        f"launches a step, {nodes} rows each, {total} elements]: kernel_ms "
        f"{r['ms']:.4f} ({r['ms'] / launches * 1e3:.2f} us a launch, key "
        f"table upload included) plain_ms {r['plain_ms']:.4f} (twin) "
        f"library_ms none bound_ms {r['bound'][0]:.6f} ({r['bound'][1]}) -> "
        f"{r['bound'][0] / r['ms']:.2%} of bound; host key algebra "
        f"{host_ms:.3f} ms a step")
    torch.cuda.empty_cache()
    return r, host_ms


# -- phase 8: the stochastic strategies --------------------------------------


def expected_launches(res, cfg_kw, steps, packed, t1_per_step=0):
    """Exact launches of a bf16 fit: the attention pair's forward and
    backward once a layer a step in bf16, the forward twice a layer an eval
    in f32 (local and global params, one validation microbatch; evals run
    in f32 whatever autocast says); T1 once a SPARTA step."""
    layers = cfg_kw["n_layer"]
    train = layers * steps
    evals = 2 * layers * len(res.history["global_loss"])
    want = dict.fromkeys(KERNELS, 0)
    if packed:
        want.update(B1_fwd_packed=train, B2_bwd_packed=train,
                    B1_fwd_packed_f32=evals)
    else:
        want.update(B3_blk_fwd=train + evals, B4_blk_bwd=train)
    want["T1_threefry_bernoulli"] = t1_per_step * steps
    return want


def stochastic_phase(torch, mods, tf, card, base, flagship):
    """8a SPARTA-DiLoCo at GPT-2 base, 8b FedAvg islands at the flagship,
    8c ZeRO-1 against SimpleReduce at GPT-2 base; returns 8a's counts."""
    from gym_tpu_torch.convert import jax_leaf_order
    from gym_tpu_torch.strategy import (FedAvgStrategy, OptimSpec,
                                        SimpleReduceStrategy,
                                        SPARTADiLoCoStrategy,
                                        ZeroReduceStrategy)
    from gym_tpu_torch.strategy.faults import host_participation, ring_bytes
    adamw = OptimSpec("adamw", lr=3e-4)

    def run(title, cfg_kw, nodes, batch, steps, strategy, packed, t1=0):
        counts, res = train_phase(torch, mods, title, cfg_kw, nodes, batch,
                                  steps, (), strategy=strategy)
        want = expected_launches(res, cfg_kw, steps, packed, t1)
        log(f"  {title} on {card}: steady steps/s "
            f"{res.steps_per_second_steady}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(counts == want, f"{title}: launches {counts}, expected {want}")
        log(f"  launches exactly as expected: {want}")
        return counts, res

    # 8a: every leaf's mask each step, on the card through T1
    strat = SPARTADiLoCoStrategy(adamw, p_sparta=0.005, H=2,
                                 participation=0.75, **SCHED)
    c8a, res = run("phase 8a gpt2-base SPARTA-DiLoCo", base, 4, 4, 4, strat,
                   False, t1=1)
    # step 0's comm_bytes: the twin's realized mask count over every leaf
    order = jax_leaf_order(res.node_state.params)
    count = 0
    for name, p in res.node_state.params.items():
        key = threefry_key(tf, order[name], 0)
        count += int(tf.plain_bernoulli(key, 0.005, p[0].numel(),
                                        "cuda").sum())
    group, frac = host_participation(5678, 0, 4, 0.75)
    predicted = frac * ring_bytes(group, 4.0 * count)
    got = res.history["comm_bytes"][0][1]
    log(f"  step 0 comm_bytes {got:.1f}, predicted {predicted:.1f} from the "
        f"twin's {count} masked elements, {group} of 4 nodes alive")
    check(abs(got - predicted) <= 1e-6 * predicted,
          f"8a: step 0 comm_bytes {got} != predicted {predicted}")
    del res
    # 8b: FedAvg with 16-node islands among 64 nodes
    strat = FedAvgStrategy(adamw, H=2, island_size=16, **SCHED)
    run("phase 8b flagship FedAvg islands", flagship, 64, 16, 6, strat, True)
    # 8c: ZeRO-1 against SimpleReduce, both AdamW
    peaks = {}
    for title, cls in (("ZeRO-1", ZeroReduceStrategy),
                       ("SimpleReduce", SimpleReduceStrategy)):
        run(f"phase 8c gpt2-base {title}", base, 4, 4, 3,
            cls(adamw, **SCHED), False)
        peaks[title] = torch.cuda.max_memory_allocated()
    log(f"  8c peak memory on {card}: ZeRO-1 "
        f"{peaks['ZeRO-1'] / 2**30:.2f} GiB, SimpleReduce "
        f"{peaks['SimpleReduce'] / 2**30:.2f} GiB")
    check(peaks["ZeRO-1"] < peaks["SimpleReduce"],
          "8c: ZeRO-1 did not lower the peak memory")
    return c8a


# -- phase 9: the BASELINE configs ------------------------------------------

LOGS = os.path.join(HERE, "build", "chip_smoke_logs")
DATA = os.path.join(HERE, "build", "chip_smoke_data")
# run_baselines.py's MNIST settings
MNIST_BATCH, MNIST_MICRO = 256, 64


def mnist_strategy(which, optim=None, warmup=100):
    """The MNIST example's strategies: Adam 1e-3 with the lambda_cosine
    warmup of 100 steps; DiLoCo's H cut from 100 to 2 so that outer steps
    fire in a short run; SPARTA p 0.005."""
    from gym_tpu_torch.strategy import (DiLoCoStrategy, OptimSpec,
                                        SimpleReduceStrategy, SPARTAStrategy)
    optim = optim or OptimSpec("adam", lr=1e-3)
    sched = dict(lr_scheduler="lambda_cosine",
                 lr_scheduler_kwargs={"warmup_steps": warmup})
    if which == "diloco":
        return DiLoCoStrategy(optim, H=2, **sched)
    if which == "sparta":
        return SPARTAStrategy(optim, p_sparta=0.005, **sched)
    return SimpleReduceStrategy(optim, **sched)


def mnist_fit(strategy, nodes, steps, device, batch, micro, run_name,
              autocast=False, init_params=None, val_size=256, seed=0,
              val_interval=None):
    """The MNIST CNN on the digits. Evals by default at step 0 and after
    the last step only: configs 1-3 eval 5 times in 300 steps, so a steady
    window of a few steps holds none."""
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import load_digits_mnist
    from gym_tpu_torch.models import MnistLossModel
    return Trainer(MnistLossModel(), load_digits_mnist(True),
                   load_digits_mnist(False)).fit(
        strategy=strategy, num_nodes=nodes, max_steps=steps,
        batch_size=batch, minibatch_size=micro, device=device,
        autocast=autocast, seed=seed, val_size=val_size,
        val_interval=val_interval or steps, init_params=init_params,
        show_progress=False, log_dir=LOGS, run_name=run_name)


def baseline_run(torch, mods, card, title, fit, steps, want, ln_first):
    """One BASELINE config: losses, steady steps/s, peak memory and the
    exact launch counts ``want`` (every kernel not named: 0)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(mods)
    t0 = time.perf_counter()
    res = fit()
    wall = time.perf_counter() - t0
    counts = read_counts(mods)
    peak = torch.cuda.max_memory_allocated()
    losses = [l for _, l in res.history["train_loss"]]
    log(f"{title}: train losses {['%.5f' % l for l in losses]}")
    for (step, lo), (_, gl) in zip(res.history["local_loss"],
                                   res.history["global_loss"]):
        log(f"  eval at step {step}: local {lo:.6f} global {gl:.6f}")
    log(f"  {title} on {card}: steady steps/s "
        f"{res.steps_per_second_steady} (all {res.steps_per_second:.4f}), "
        f"wall {wall:.1f} s incl. init, peak memory {peak / 2**30:.3f} GiB, "
        f"final loss {res.final_train_loss:.6f}")
    log(f"  launches: {counts}")
    check(len(losses) == steps and all(math.isfinite(l) for l in losses),
          f"{title}: non-finite or missing losses {losses}")
    check(abs(losses[0] - ln_first) < 0.7, f"{title}: first loss "
          f"{losses[0]} far from ln(classes) = {ln_first:.3f}")
    full = {k: 0 for k in KERNELS}
    full.update(want)
    for name, n in full.items():
        check(counts[name] == n, f"{title}: {name} launched {counts[name]} "
              f"times, expected {n}")
    log(f"  launches exactly as expected: { {k: n for k, n in want.items()} }")
    return counts, res


# BASELINE config 4 at run_baselines.py's settings, H cut from 100 to 2
CONFIG4 = dict(block=256, nodes=16, batch=16, n_layer=4)


def config4_fit(steps, val_size=256, run_name="9d_fedavg"):
    """nanoGPT "small" on the docs stream, FedAvg (AdamW 3e-4, H 2), f32,
    the packed kernels (``attn_impl="flash"``). Evals at step 0 and after
    the last step only: config 4 evals 5 times in 300 steps, so a steady
    window of a few steps holds none."""
    from gym_tpu_torch import Trainer
    from gym_tpu_torch.data import get_dataset
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig
    from gym_tpu_torch.strategy import FedAvgStrategy, OptimSpec
    block, batch = CONFIG4["block"], CONFIG4["batch"]
    train, vocab = get_dataset("docs", block, end_pc=0.9, data_root=DATA)
    val, _ = get_dataset("docs", block, start_pc=0.9, data_root=DATA)
    cfg = GPTConfig.gpt2_size_map("small")
    cfg.vocab_size, cfg.block_size, cfg.attn_impl = int(vocab), block, \
        "flash"
    sched = dict(lr_scheduler="lambda_cosine", lr_scheduler_kwargs={
        "warmup_steps": min(100, steps // 5)})
    strategy = FedAvgStrategy(inner_optim=OptimSpec("adamw", lr=3e-4), H=2,
                              **sched)
    return Trainer(GPT(cfg), train, val).fit(
        strategy=strategy, num_nodes=CONFIG4["nodes"], max_steps=steps,
        batch_size=batch, minibatch_size=batch, device="cuda",
        val_size=val_size, val_interval=steps,
        show_progress=False, log_dir=LOGS, run_name=run_name)


def cnn_leaves():
    """(JAX leaf index, per-node element count) of every leaf of the CNN,
    as SPARTA keys its masks."""
    from gym_tpu_torch.convert import jax_leaf_order
    from gym_tpu_torch.models.mnist_cnn import MnistLossModel
    specs = MnistLossModel().cnn.param_specs()
    order = jax_leaf_order(specs)
    return [(order[n], math.prod(shape)) for n, (shape, _) in specs.items()]


def cnn_dropout_paths():
    from gym_tpu_torch.models.mnist_cnn import MnistLossModel
    return MnistLossModel().cnn.dropout_paths()


def baseline_phase(torch, mods, card):
    """9a-9d; returns the counts of 9b (T1's per-row entry) and 9d (the f32
    packed pair)."""
    import numpy as np
    import zlib
    from gym_tpu_torch.data import build_docs_corpus

    steps = 8
    rows = len(CNN_DROPOUTS) * (MNIST_BATCH // MNIST_MICRO) * steps
    counts = {}
    for tag, which, nodes in (("9a", "simple_reduce", 2),
                              ("9b", "diloco", 8), ("9c", "sparta", 8)):
        want = {"T1_threefry_bernoulli_rows": rows}
        if which == "sparta":
            want["T1_threefry_bernoulli"] = steps  # every leaf in one
        counts[tag], _ = baseline_run(
            torch, mods, card,
            f"phase {tag} MNIST K={nodes} {which} (batch {MNIST_BATCH}, "
            f"microbatch {MNIST_MICRO}, {steps} steps, f32)",
            lambda: mnist_fit(mnist_strategy(which), nodes, steps, "cuda",
                              MNIST_BATCH, MNIST_MICRO, f"9_{which}"),
            steps, want, math.log(10))

    # 9d: config 4 on the docs stream of the checkout's gym_tpu/
    stream = build_docs_corpus(DATA)
    crc = zlib.crc32(np.ascontiguousarray(stream).tobytes())
    log(f"phase 9d docs stream: {len(stream)} tokens, crc32 {crc} (expected "
        f"{DOCS_TOKENS}, {DOCS_CRC})")
    check(len(stream) == DOCS_TOKENS and crc == DOCS_CRC,
          "9d: the docs stream differs from the checkout's gym_tpu/ stream")
    steps, layers, batch = 6, CONFIG4["n_layer"], CONFIG4["batch"]
    val_size = 256
    # all in f32: the forward once a layer a step and, each eval, twice a
    # layer a validation microbatch (local and global params); evals at
    # step 0 and after the last step
    evals = 2
    fwd = layers * (steps + 2 * evals * (val_size // batch))
    want = {"B1_fwd_packed_f32": fwd, "B2_bwd_packed_f32": layers * steps}
    counts["9d"], res = baseline_run(
        torch, mods, card,
        f"phase 9d nanoGPT small K={CONFIG4['nodes']} x {batch} rows "
        f"T={CONFIG4['block']} vocab 66 FedAvg (H 2, {steps} steps, f32)",
        lambda: config4_fit(steps, val_size), steps, want, math.log(66))
    check(len(res.history["global_loss"]) == evals,
          f"9d: {len(res.history['global_loss'])} evals, expected {evals}")
    return counts


def cnn_card_vs_cpu(torch, mods):
    """9e: the CNN's train losses and global evals on the card and on the
    CPU from the same weights, batches and dropout masks (T1 on the card,
    the twin on the CPU), f32 and bf16."""
    from gym_tpu_torch.models import MnistLossModel
    from gym_tpu_torch.strategy import OptimSpec
    init = {n: p[0] for n, p in MnistLossModel().init_params(
        1, seed=11, device="cpu").items()}
    nodes, batch, micro, steps = 2, 8, 4, 3
    for mode, autocast in (("bf16", True), ("f32", False)):
        out = {}
        for device in ("cuda", "cpu"):
            reset_counts(mods)
            res = mnist_fit(mnist_strategy("simple_reduce",
                                           OptimSpec("sgd", lr=1e-3), 1),
                            nodes, steps, device, batch, micro,
                            f"9e_{mode}_{device}", autocast=autocast,
                            init_params=init, val_size=micro, seed=5,
                            val_interval=1)
            out[device] = [l for _, l in res.history["train_loss"]] + [
                l for _, l in res.history["global_loss"]]
            if device == "cuda":
                n = read_counts(mods)["T1_threefry_bernoulli_rows"]
                want = len(CNN_DROPOUTS) * (batch // micro) * steps
                check(n == want, f"9e: the card drew {n} per-row masks, "
                      f"expected {want}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(out["cuda"],
                                                      out["cpu"]))
        log(f"phase 9e CNN card vs CPU {mode}: cuda "
            f"{['%.6f' % x for x in out['cuda']]}")
        log(f"                              cpu  "
            f"{['%.6f' % x for x in out['cpu']]}")
        log(f"  max rel diff {rel:.3e} (band {LOSS_RTOL[mode]})")
        check(rel <= LOSS_RTOL[mode], f"9e CNN card vs CPU {mode}: losses "
              f"differ by {rel:.3e} > {LOSS_RTOL[mode]}")


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
        import gym_tpu_torch.ops.threefry as tf
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
              "long_tuned_blocks": (2, 12, 2048, 64),
              "long_default_blocks": (2, 12, 1152, 64),
              "config4": (16 * 16, 256, 128, 4)}
    mods = {"fused": tfa, "flash": tflash, "threefry": tf}
    t_all = time.perf_counter()
    try:
        card = card_line()
        log(f"phase 1: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
        int32_ops_per_s = int32_rate(torch)

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
                enumerate(("attn_fwd_tf32x3 f32", "attn_dkdv_tf32x3 f32",
                           "attn_dq_tf32x3 f32", "flash_fwd_tf32x3 f32",
                           "attn_fwd_wgmma bf16", "attn_dkdv_wgmma bf16",
                           "attn_dq_wgmma bf16", "flash_fwd_wgmma bf16"))))
        f32_kernel_report(_build.build_log, lib)
        for d in (16, 32, 64, 128):
            for bf16, kern in ((1, "flash_fwd_wgmma"), (0, "flash_fwd_tf32x3")):
                regs = (ctypes.c_int * 3)()
                per_sm = lib.gym_flash_occupancy(d, bf16, regs)
                check(per_sm >= 1, f"{kern}<{d}> cannot be resident "
                      f"({per_sm})")
                log(f"  {kern}<{d}>: 384 threads at {regs[2]} registers a "
                    f"thread at launch, setmaxnreg to {regs[0]} (producer "
                    f"warpgroup) and {regs[1]} (two consumer warpgroups); "
                    f"{per_sm} block(s) per SM")
        log("  SASS instructions per kernel (cuobjdump -sass):")
        sass = sass_counts(_build._nvcc(), path)
        check_sass(sass)
        t1_ops = threefry_ops_per_element(sass)

        log("phase 3: kernels against plain versions on the card")
        errs = check_kernels(torch, tfa, tflash, shapes)
        errs["T1_threefry_bernoulli"] = check_threefry(torch, tf)
        errs["T1_threefry_bernoulli_rows"] = check_threefry_rows(torch, tf)

        flagship = dict(block_size=256, vocab_size=65, n_layer=4, n_head=4,
                        n_embd=128, attn_impl="flash")
        base = GPT2_BASE
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
                    "B5f_flash_fwd_f32": c5b["B5f_flash_fwd_f32"],
                    "B5b_flash_bwd": c5b["B5b_flash_bwd"]}

        log("phase 6: card against CPU")
        card_vs_cpu(torch, mods, dict(block_size=128, vocab_size=65,
                                      n_layer=2, n_head=2, n_embd=64,
                                      attn_impl="flash"), 4, 4, 3, 20_000)
        card_vs_cpu(torch, mods, dict(block_size=2048, vocab_size=65,
                                      n_layer=2, n_head=2, n_embd=128,
                                      attn_impl="flash"), 2, 1, 2, 100_000,
                    want={"bf16": ("B5f_flash_fwd", "B5f_flash_fwd_f32",
                                   "B5b_flash_bwd"),
                          "f32": ("B5f_flash_fwd_f32", "B5b_flash_bwd")})

        def sparta_diloco():
            from gym_tpu_torch.strategy import (OptimSpec,
                                                SPARTADiLoCoStrategy)
            return SPARTADiLoCoStrategy(OptimSpec("adamw", lr=3e-4),
                                        p_sparta=0.3, H=2,
                                        participation=0.75, **SCHED)
        card_vs_cpu(torch, mods, dict(block_size=128, vocab_size=65,
                                      n_layer=2, n_head=2, n_embd=64,
                                      attn_impl="flash"), 4, 4, 3, 20_000,
                    want=("T1_threefry_bernoulli",),
                    strategy_fn=sparta_diloco, label="_sparta_diloco")

        log("phase 7: timing (CUDA events, median of 5)")
        times = time_kernels(torch, tfa, tflash, shapes)
        times["T1_threefry_bernoulli"] = time_threefry(
            torch, tf, gpt_leaves(base), t1_ops, int32_ops_per_s)
        f32_times, f32_errs = time_packed_f32(torch, tfa, shapes["config4"])
        times.update(f32_times)
        errs.update(f32_errs)
        time_heads_f32(torch, tfa, shapes["base"])
        times["T1_threefry_bernoulli_rows"], _ = time_threefry_rows(
            torch, tf, int32_ops_per_s)

        log("phase 8: the stochastic strategies through Trainer.fit")
        c8a = stochastic_phase(torch, mods, tf, card, base, flagship)
        launches["T1_threefry_bernoulli"] = c8a["T1_threefry_bernoulli"]

        log("phase 9: the BASELINE configs through Trainer.fit")
        c9 = baseline_phase(torch, mods, card)
        cnn_card_vs_cpu(torch, mods)
        launches["T1_threefry_bernoulli_rows"] = \
            c9["9b"]["T1_threefry_bernoulli_rows"]
        launches["B1_fwd_packed_f32"] = c9["9d"]["B1_fwd_packed_f32"]
        launches["B2_bwd_packed_f32"] = c9["9d"]["B2_bwd_packed_f32"]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_all:.1f} s")
    log(card)
    kernels = []
    for name, (_, _, _, source, replaces) in KERNELS.items():
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
