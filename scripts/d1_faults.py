#!/usr/bin/env python3
"""Plant faults in D1, DeMo's scatter-mean decode
(``gym_tpu_torch/ops/csrc/scatter_mean.cu``), and show that the checks
catch each one, on a machine with a CUDA card:

    python3 scripts/d1_faults.py [FAULT ...]

For each fault (all by default) the checkout is copied to a temporary
directory, the fault is written into the copy's kernel, and the copy's
``chip_smoke.py`` and D1's card tests (``tests/test_torch_kernels_gpu.py
-k scatter``) run there. Prints, a fault, both exit codes, the failure
message and the card tests' summary. Exits non-zero if a fault passes
either check.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "gym_tpu_torch/ops/csrc/scatter_mean.cu"
# name: (text in the kernel, its faulty replacement)
FAULTS = {
    # the staged picks scanned from the last to the first
    "picks_summed_in_reverse": ("for (int u = 0; u < n; ++u) {",
                                "for (int u = n - 1; u >= 0; --u) {"),
    # the sum written without dividing by the count
    "count_dropped": ("c > 0 ? s_sum[s] / (float)c : 0.0f",
                      "c > 0 ? s_sum[s] : 0.0f"),
    # an untouched slot divides 0 by 0 instead of writing 0
    "untouched_slot_not_zeroed": ("c > 0 ? s_sum[s] / (float)c : 0.0f",
                                  "s_sum[s] / (float)c"),
}


def plant(name: str, dst: str) -> None:
    for sub in ("gym_tpu_torch", "tests"):
        shutil.copytree(os.path.join(ROOT, sub), os.path.join(dst, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    old, new = FAULTS[name]
    path = os.path.join(dst, KERNEL)
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
                ["timeout", "900", sys.executable, "chip_smoke.py"], cwd=dst,
                capture_output=True, text=True)
            tests = subprocess.run(
                ["timeout", "600", sys.executable, "-m", "pytest",
                 "--noconftest", "-m", "gpu", "tests/test_torch_kernels_gpu.py",
                 "-q", "-k", "scatter", "-p", "no:cacheprovider"],
                cwd=dst, capture_output=True, text=True)
        failed = [l for l in smoke.stderr.splitlines()
                  if "FAILED" in l or "Error" in l][:2]
        summary = tests.stdout.strip().splitlines()[-1:]
        print(f"== {name}: chip_smoke rc={smoke.returncode}", *failed,
              f"card tests rc={tests.returncode}:", *summary, sep="\n  ",
              flush=True)
        caught &= smoke.returncode != 0 and tests.returncode != 0
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
