#!/usr/bin/env python3
"""Plant faults in the f32 long-context forward (``x3`` of
``gym_tpu_torch/ops/csrc/flash_attention.cu``: the pre-pass
``split_kv_tf32x3`` and ``flash_fwd_tf32x3``) and in T1's segmented mask
kernel (``threefry_segments_kernel``, ``csrc/threefry.cu``), and show that
the checks catch each one, on a machine with a CUDA card:

    python3 scripts/flash_f32_faults.py [FAULT ...]

For each fault (all by default) the checkout is copied to a temporary
directory, the fault is written into the copy's source, and the copy's
``chip_smoke.py`` and the card tests that run the faulty kernel
(``tests/test_torch_kernels_gpu.py -k`` the fault's selection) run there.
Prints, a fault, both exit codes, the first comparison line that failed
(its largest |a − b| − rtol·|b| in units of the reference's rms, beside
the limit atol), the failure message and the card tests' summary. Exits
non-zero if a fault passes either check.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = "gym_tpu_torch/ops/csrc/"
LONG_F32 = "f32 and long"
T1 = "bernoulli or sparta or threefry"
# name: (card tests' -k selection, [(file, text in the kernel, its faulty
# replacement), ...])
FAULTS = {
    # the pre-pass writes lo = 0: k and v^T single-pass TF32
    "prepass_single_pass_tf32": (LONG_F32, [(
        "flash_attention.cu",
        "*reinterpret_cast<float4*>(lo + off) = make_float4(l[0], l[1], l[2], "
        "l[3]);",
        "*reinterpret_cast<float4*>(lo + off) = make_float4(0.f, 0.f, 0.f, "
        "0.f);")]),
    # v^T written in key order, not key_order's
    "vt_without_key_order": (LONG_F32, [(
        "flash_attention.cu", "g[hop::key_order(4 * (c & 1) + i) * D]",
        "g[(4 * (c & 1) + i) * D]")]),
    # the diagonal steps unmasked
    "diagonal_unmasked": (LONG_F32, [(
        "flash_attention.cu",
        "s[i] = (diag && c - r > off) ? -INFINITY : s[i] * c2;",
        "s[i] = s[i] * c2;")]),
    # a consumer releases a stage as soon as it has landed, before its
    # products (p v's included) have been waited for
    "empty_before_products": (LONG_F32, [
        ("flash_attention.cu",
         "    const uint32_t tiles = ring + st * C::STEP;\n"
         "    hop::mbar_wait(full(st), (kb / STAGES) & 1);\n",
         "    const uint32_t tiles = ring + st * C::STEP;\n"
         "    hop::mbar_wait(full(st), (kb / STAGES) & 1);\n"
         "    hop::mbar_arrive(empty(st));\n"),
        ("flash_attention.cu",
         "tiles + C::VL);\n    }\n    hop::mbar_arrive(empty(st));\n",
         "tiles + C::VL);\n    }\n")]),
    # the segment search takes a group one further on: a segment's last
    # group goes to the next segment
    "segment_search_off_by_one": (T1, [(
        "threefry.cu", "if (first[mid] <= g) lo = mid;",
        "if (first[mid] <= g + 1) lo = mid;")]),
}


def plant(name: str, dst: str) -> None:
    for sub in ("gym_tpu_torch", "tests"):
        shutil.copytree(os.path.join(ROOT, sub), os.path.join(dst, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    for src, old, new in FAULTS[name][1]:
        path = os.path.join(dst, CSRC, src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {text.count(old)} matches of {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))


def first_failure(stdout: str) -> list:
    """The first comparison line outside its limit."""
    return [l.strip() for l in stdout.splitlines()
            if "elements outside" in l][:1]


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
                 "-q", "-k", FAULTS[name][0], "-p", "no:cacheprovider"],
                cwd=dst, capture_output=True, text=True)
        failed = [l for l in smoke.stderr.splitlines()
                  if "FAILED" in l or "Error" in l][:2]
        summary = tests.stdout.strip().splitlines()[-1:]
        print(f"== {name}: chip_smoke rc={smoke.returncode}",
              *first_failure(smoke.stdout), *failed,
              f"card tests rc={tests.returncode}:", *summary, sep="\n  ",
              flush=True)
        caught &= smoke.returncode != 0 and tests.returncode != 0
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
