#!/usr/bin/env python3
"""Plant faults in B7, the serving path's decode attention
(``gym_tpu_torch/ops/csrc/decode_attention.cu``), and R1, its row-invariant
linear layer (``gym_tpu_torch/ops/csrc/row_gemm.cu``), and show that the
checks catch each one, on a machine with a CUDA card:

    python3 scripts/b7_r1_faults.py [FAULT ...]

For each fault (all by default) the checkout is copied to a temporary
directory, the fault is written into the copy's kernel, and the copy's
``chip_smoke.py`` and the serving kernels' card tests
(``tests/test_torch_kernels_gpu.py -k "decode_attention or row_"``) run
there. Prints, a fault, both exit codes, the lines where the checks saw it
(the largest error against the twin, or the bits that differ) and the card
tests' summary. Exits non-zero if a fault passes either check.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B7 = "gym_tpu_torch/ops/csrc/decode_attention.cu"
R1 = "gym_tpu_torch/ops/csrc/row_gemm.cu"
# name: (kernel, [(text in it, its faulty replacement), ...])
FAULTS = {
    # V read in the reverse order of the keys whose probabilities weigh it
    "reversed_key_order": (B7, [(
        "acc = fmaf(ps[warp][key], vp[offs[warp][key] + d], acc);",
        "acc = fmaf(ps[warp][key], vp[offs[warp][nk - 1 - key] + d], acc);")]),
    # a query attends one position past its own (the cursor off by one)
    "cursor_off_by_one": (B7, [(
        "const int last = min(cursor[r] + j, S - 1);",
        "const int last = min(cursor[r] + j + 1, S - 1);")]),
    # the few-row tiling splits K in two halves summed apart and added: a
    # row's bits then depend on M (16 rows one order, 80 another)
    "split_k_r1": (R1, [
        ("  float acc[TM][TN];\n",
         "  float acc[TM][TN], acc2[TM][TN];\n"),
        ("    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;\n",
         "    for (int j = 0; j < TN; ++j) acc[i][j] = acc2[i][j] = 0.f;\n"),
        ("        for (int j = 0; j < TN; ++j) acc[i][j] = "
         "fmaf(a[i], b[j], acc[i][j]);\n",
         "        for (int j = 0; j < TN; ++j) {\n"
         "          if (BM == 16 && 2 * (k0 + kk) >= K)\n"
         "            acc2[i][j] = fmaf(a[i], b[j], acc2[i][j]);\n"
         "          else\n"
         "            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);\n"
         "        }\n"),
        ("        y[(long long)gm * N + gn] = bias ? acc[i][j] + bias[gn] : "
         "acc[i][j];",
         "        y[(long long)gm * N + gn] = bias ? (acc[i][j] + acc2[i][j]) "
         "+ bias[gn] : acc[i][j] + acc2[i][j];")]),
}


def plant(name: str, dst: str) -> None:
    for sub in ("gym_tpu_torch", "tests"):
        shutil.copytree(os.path.join(ROOT, sub), os.path.join(dst, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    kernel, edits = FAULTS[name]
    path = os.path.join(dst, kernel)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {text.count(old)} matches of {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


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
                 "-q", "-k", "decode_attention or row_", "-p",
                 "no:cacheprovider"],
                cwd=dst, capture_output=True, text=True)
        seen = [l.strip() for l in smoke.stdout.splitlines()
                if "outside" in l or "DIFFER" in l][:3]
        failed = [l for l in smoke.stderr.splitlines()
                  if "FAILED" in l or "Error" in l][:2]
        summary = tests.stdout.strip().splitlines()[-1:]
        print(f"== {name}: chip_smoke rc={smoke.returncode}", *seen, *failed,
              f"card tests rc={tests.returncode}:", *summary, sep="\n  ",
              flush=True)
        caught &= smoke.returncode != 0 and tests.returncode != 0
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
