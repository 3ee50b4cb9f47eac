#!/usr/bin/env python3
"""Plant faults in B7, the serving path's decode attention
(``gym_tpu_torch/ops/csrc/decode_attention.cu``'s kernel, not its oracle:
V read in the reverse order of the keys, a query attending one position
past its own), in R1, its row-invariant linear layer
(``gym_tpu_torch/ops/csrc/row_gemm.cu``: a split of K in the few-row
tiling, the ring's stage index off by one), and in L1 with the residual
add (the same file: a lane summing its columns in the reverse order), and
show that the checks catch each one, on a machine with a CUDA card:

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
        "v[i] = lane + 32 * i < HD ? vt[key * KP + lane + 32 * i] : 0.f;",
        "v[i] = lane + 32 * i < HD ? vt[(nk_all - 1 - key) * KP + lane + "
        "32 * i] : 0.f;")]),
    # a query attends one position past its own (the cursor off by one;
    # the tile stages it)
    "cursor_off_by_one": (B7, [
        ("const int last_max = min(cur + min(j0 + QT, t) - 1, S - 1);",
         "const int last_max = min(cur + min(j0 + QT, t), S - 1);"),
        ("const int last = min(cur + j, S - 1);",
         "const int last = min(cur + j + 1, S - 1);")]),
    # the few-row tiling (FewTile: decode's rows) chains the second half of
    # K's tiles into another accumulator and adds the two at the end: its
    # rows' bits then differ from the oracle's and depend on M (16 rows
    # one order, 80 another)
    "split_k_r1": (R1, [
        ("  float acc[T::TM][T::TN];\n",
         "  float acc[T::TM][T::TN], acc2[T::TM][T::TN];\n"),
        ("    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;\n",
         "    for (int j = 0; j < T::TN; ++j) acc[i][j] = acc2[i][j] = 0.f;\n"),
        ("    chain_tile<T, KN>(acc, xs + slot * T::BM * T::XP, ws, tx, ty,\n",
         "    float (&into)[T::TM][T::TN] =\n"
         "        std::is_same<T, FewTile>::value && 2 * kt >= KT ? acc2 : acc;\n"
         "    chain_tile<T, KN>(into, xs + slot * T::BM * T::XP, ws, tx, ty,\n"),
        ("  cp_async_wait<0>();\n",
         "  cp_async_wait<0>();\n"
         "  if (std::is_same<T, FewTile>::value)\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < T::TM; ++i)\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < T::TN; ++j)\n"
         "        acc[i][j] = acc[i][j] + acc2[i][j];\n")]),
    # the ring's stage index off by one: each k tile chains over the slot
    # of the tile after it (landed or not, or a stale one)
    "stage_off_by_one": (R1, [
        ("    const int slot = kt % S;\n",
         "    const int slot = (kt + 1) % S;\n")]),
    # L1 with the add: a lane sums its columns from the last to the first,
    # so a row's statistics (and y) leave the oracle's bits
    "l1_sum_order": (R1, [(
        "    for (int i = 0; i < NC; ++i) {\n"
        "      const int c = lane + 32 * i;\n"
        "      v[i] = __fadd_rn(v[i], dv[i]);",
        "    for (int i = NC - 1; i >= 0; --i) {\n"
        "      const int c = lane + 32 * i;\n"
        "      v[i] = __fadd_rn(v[i], dv[i]);")]),
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
