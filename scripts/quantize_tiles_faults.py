#!/usr/bin/env python3
"""Plant faults in T1 bits' codec kernel
(``gym_tpu_torch/ops/csrc/quantize_tiles.cu``: ``quantize_tiles_kernel``,
the path of the strategies' 256-element tiles), and show that the checks
catch each one, on a machine with a CUDA card:

    python3 scripts/quantize_tiles_faults.py [FAULT ...]

For each fault (all by default) the checkout is copied to a temporary
directory, the fault is written into the copy's kernel, and the copy's
``chip_smoke.py`` (which stops at phase 3's check of the kernel against its
plain version and the first bits kernel's composition) and the kernel's
card tests (``tests/test_torch_kernels_gpu.py -k quantize_tiles``) run
there. Prints, a fault, both exit codes, the failure message and the card
tests' summary. Exits non-zero if a fault passes either check.
``tests/test_torch_quantize_tiles_source.py`` holds each fault's text to
exactly one place, inside the kernel's body.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "gym_tpu_torch/ops/csrc/quantize_tiles.cu"
# name: (text in the kernel, its faulty replacement)
FAULTS = {
    # every element's threefry counter one tile further on
    "counter_off_by_one_tile": (
        "const uint32_t hi = (uint32_t)(at >> 32), lo = (uint32_t)at;",
        "const uint32_t hi = (uint32_t)(at >> 32), "
        "lo = (uint32_t)at + kFastTile;"),
    # the tile's max across lanes with fmaxf, which drops a NaN
    "nan_dropped_by_fmaxf": (
        "for (int off = 8; off > 0; off >>= 1)\n"
        "      m = nan_max(m, __shfl_xor_sync(kFull, m, off));",
        "for (int off = 8; off > 0; off >>= 1)\n"
        "      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));"),
    # amax / qmax divided, not multiplied by XLA's f32(1 / qmax)
    "scale_divided_by_qmax": (
        "const float s = tile_scale(m, inv_qmax);\n"
        "    uint32_t w[kPerLane / 4]",
        "const float s = m > 0.0f ? __fdiv_rn(m, qmax) : 1.0f;\n"
        "    uint32_t w[kPerLane / 4]"),
    # a shared key's bits read a tile further on in each row (wrapped)
    "shared_key_read_with_row_stride": (
        "const uint4 w = *reinterpret_cast<const uint4*>(bits + at + 4 * g);",
        "const uint4 w = *reinterpret_cast<const uint4*>(\n"
        "            bits + (at + row * kFastTile) % (tiles_per_row * "
        "kFastTile) + 4 * g);"),
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
                 "-q", "-k", "quantize_tiles", "-p", "no:cacheprovider"],
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
