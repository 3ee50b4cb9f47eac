#!/usr/bin/env python3
"""Plant faults in the bf16 long-context forward (``flash_fwd_wgmma``) and
show that the checks catch each one, on a machine with a CUDA card:

    python3 scripts/flash_fwd_faults.py [FAULT ...]

For each fault (all by default) the checkout is copied to a temporary
directory, the fault is written into the copy's
``gym_tpu_torch/ops/csrc/flash_attention.cu``, and the copy's
``chip_smoke.py`` and card tests of the long-context pair
(``tests/test_torch_kernels_gpu.py -k long``) run there. Prints, a fault,
both exit codes, the first B5f comparison line (its largest |a − b| −
rtol·|b| in units of rms against the limit 0.05), the failure message and
the card tests' summary. Exits non-zero if a fault passes either check.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "gym_tpu_torch/ops/csrc/flash_attention.cu"
FAULTS = {  # name: (text in the kernel, its faulty replacement)
    "mask_admits_next_key": (
        "> ln.row + 8 * ((i >> 1) & 1);",
        "> ln.row + 8 * ((i >> 1) & 1) + 1;"),
    "rescale_dropped": ("      rescale<D>(acc, alpha);\n", ""),
    "wg1_skips_last_tile": ("    if (kb <= diag) {",
                            "    if (kb <= diag - w) {"),
    "reads_other_stage": (
        "hop::mma_pb<D>(acc, p, Vs + st * L::BYTES);",
        "hop::mma_pb<D>(acc, p, Vs + (st ^ 1) * L::BYTES);"),
}


def plant(name: str, dst: str) -> None:
    for sub in ("gym_tpu_torch", "tests"):
        shutil.copytree(os.path.join(ROOT, sub), os.path.join(dst, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    old, new = FAULTS[name]
    path = os.path.join(dst, SRC)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: {text.count(old)} matches of {old!r}")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


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
                 "-q", "-k", "long", "-p", "no:cacheprovider"],
                cwd=dst, capture_output=True, text=True)
        first = [l for l in smoke.stdout.splitlines() if "B5f o" in l][:1]
        failed = [l for l in smoke.stderr.splitlines() if "FAILED" in l]
        summary = tests.stdout.strip().splitlines()[-1:]
        print(f"== {name}: chip_smoke rc={smoke.returncode}", *first, *failed,
              f"card tests rc={tests.returncode}:", *summary, sep="\n  ",
              flush=True)
        caught &= smoke.returncode != 0 and tests.returncode != 0
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
