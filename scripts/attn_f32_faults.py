#!/usr/bin/env python3
"""Plant faults in the f32 whole-context attention kernels (split-precision
TF32, namespace ``x3`` of ``gym_tpu_torch/ops/csrc/fused_attention.cu`` and
the 3xTF32 products of ``hopper.cuh``) and show that the checks catch each
one, on a machine with a CUDA card:

    python3 scripts/attn_f32_faults.py [FAULT ...]

For each fault (all by default) the checkout is copied to a temporary
directory, the fault is written into the copy's source, and the copy's
``chip_smoke.py`` and f32 card tests (``tests/test_torch_kernels_gpu.py -k
f32``) run there. Prints, a fault, both exit codes, the first f32
comparison line that failed (its largest |a − b| − rtol·|b| in units of
the reference's rms, beside the limit atol), the failure message and the
card tests' summary. Exits non-zero if a fault passes both checks.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "gym_tpu_torch/ops/csrc/"
FAULTS = {  # name: (file, text in the kernel, its faulty replacement)
    # lo = 0: every product is a_hi b_hi, single-pass TF32
    "single_pass_tf32": (
        "hopper.cuh", "  lo = tf32_round(x - hi);", "  lo = 0.f;"),
    # the scores lose their a_lo b_hi term
    "lo_hi_term_dropped": (
        "hopper.cuh",
        "    wgmma_tf32_ss<N>(s, desc_k<LA>(al, ks), desc_k<LB>(bh, ks), 1);\n",
        ""),
    # transposed tiles (v^T, k^T, q^T, do^T) in key order, not key_order's
    "wrong_key_permutation": (
        "fused_attention.cu", "g[hop::key_order(4 * (c & 1) + i) * D]",
        "g[(4 * (c & 1) + i) * D]"),
    # the forward's diagonal tiles unmasked
    "diagonal_unmasked": (
        "fused_attention.cu",
        "s[i] = (diag && k0 + c > q0 + r) ? -INFINITY : s[i] * c2;",
        "s[i] = s[i] * c2;"),
    # dk/dv reads the other stage of its (lse, delta, dlse) ring
    "reads_other_stage": (
        "fused_attention.cu", "const float* Ls = stats + buf * 3 * S;",
        "const float* Ls = stats + (buf ^ 1) * 3 * S;"),
}


def plant(name: str, dst: str) -> None:
    for sub in ("gym_tpu_torch", "tests"):
        shutil.copytree(os.path.join(ROOT, sub), os.path.join(dst, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    src, old, new = FAULTS[name]
    path = os.path.join(dst, CSRC, src)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: {text.count(old)} matches of {old!r}")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def first_f32_failure(stdout: str) -> list:
    """The first comparison line outside its limit after the f32 checks
    began (phase 3 runs bf16 first)."""
    lines = stdout.splitlines()
    start = next((i for i, l in enumerate(lines) if "float32" in l), 0)
    bad = [l.strip() for l in lines[start:] if "elements outside" in l]
    return bad[:1]


def main() -> int:
    caught = True
    for name in sys.argv[1:] or FAULTS:
        with tempfile.TemporaryDirectory() as dst:
            plant(name, dst)
            smoke = subprocess.run(
                ["timeout", "600", sys.executable, "chip_smoke.py"], cwd=dst,
                capture_output=True, text=True)
            tests = subprocess.run(
                ["timeout", "600", sys.executable, "-m", "pytest",
                 "--noconftest", "-m", "gpu", "tests/test_torch_kernels_gpu.py",
                 "-q", "-k", "f32", "-p", "no:cacheprovider"],
                cwd=dst, capture_output=True, text=True)
        failed = [l for l in smoke.stderr.splitlines() if "FAILED" in l]
        summary = tests.stdout.strip().splitlines()[-1:]
        print(f"== {name}: chip_smoke rc={smoke.returncode}",
              *first_f32_failure(smoke.stdout), *failed,
              f"card tests rc={tests.returncode}:", *summary, sep="\n  ",
              flush=True)
        caught &= smoke.returncode != 0 or tests.returncode != 0
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
