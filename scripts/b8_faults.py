#!/usr/bin/env python3
"""Plant faults in B8, the MoE layers' grouped matmuls
(``gym_tpu_torch/ops/csrc/grouped_gemm.cu``), and show that phase 16a of
``chip_smoke.py`` catches each one, on a machine with a CUDA card:

    python3 scripts/b8_faults.py [FAULT ...]

First the checkout as it is (16a must pass), then, for each fault (all by
default), the checkout copied to a temporary directory, the fault written
into the copy's kernel source and ``chip_smoke.py --b8-check`` (the build,
B8's SASS and 16a: the kernels at the MoE path's shapes, bf16 and f32,
each output poisoned first, bf16 against the plain version and the first
kernels kept as the oracle) run there. Prints, a fault, the exit code and
the first failure message. Exits non-zero if the clean copy fails or a fault passes.
``tests/test_torch_grouped_gemm_source.py`` holds each fault's text to
exactly one place in the source.
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL = "gym_tpu_torch/ops/csrc/grouped_gemm.cu"
# name: (text in the kernel source, its faulty replacement); each breaks
# the path the MoE shapes take (the TMA kernels, the f32 ring kernels, and
# find_row_tile, which every forward shares)
FAULTS = {
    # each group after the first starts a row late
    "group_offset_off_by_one": ("    start += n;\n", "    start += n + 1;\n"),
    # a group's last tile runs on past the group's end, its rows of the
    # next group through this group's expert
    "tile_straddles_into_the_next_expert": (
        "return {g, row0, min(start + n, row0 + BM)};",
        "return {g, row0, min(R, row0 + BM)};"),
    # an empty group's w-cotangent left unwritten
    "empty_group_not_written": (
        "zero_out(o, N, M - m0, N - n0);  // an empty group's tile",
        "// an empty group's tile left unwritten"),
    # the rows past sum(gs) left unwritten
    "rows_past_sum_not_zeroed": (
        "zero_out(o, N, t.row1 - t.row0, N - n0);  // rows past the groups",
        "continue;  // rows past the groups left unwritten"),
    # w's k and n extents exchanged in its tensor map, so the forward reads
    # w as if it lay [G, N, K] and the transposed read as [G, K, N]
    "weight_axes_swapped": (
        "  const cuuint64_t w_dims[3] = {(cuuint64_t)(kKMajorB ? K : N),\n"
        "                                (cuuint64_t)(kKMajorB ? N : K),",
        "  const cuuint64_t w_dims[3] = {(cuuint64_t)(kKMajorB ? N : K),\n"
        "                                (cuuint64_t)(kKMajorB ? K : N),"),
    # a forward tile stores all its rows: the next group's, multiplied by
    # this group's expert, over the next tile's (or the zeroed tail's)
    "tile_stores_the_next_groups_rows": (
        "store_staged(acc, base + C::STAGED, o, N, t.row1 - t.row0, N - n0);",
        "store_staged(acc, base + C::STAGED, o, N, min(BM, R - t.row0), "
        "N - n0);"),
    # the outer's last stage keeps the rows past its group's end: the next
    # group's rows enter the sums
    "outer_boundary_rows_not_zeroed": (
        "consume<C, 1, 1>(base, it, nk, s.count - (nk - 1) * BK, acc);",
        "consume<C, 1, 1>(base, it, nk, BK, acc);"),
    # the outer's x (an MN-major A) read as K-major: the transpose bit off
    "mn_major_transpose_bit_flipped": (
        "consume<C, 1, 1>(base, it, nk, s.count - (nk - 1) * BK, acc);",
        "consume<C, 0, 1>(base, it, nk, s.count - (nk - 1) * BK, acc);"),
    # equal row counts share a rank: one such group's tiles run twice, the
    # other's never
    "schedule_repeats_a_group": (
        "r += h < G && (nh > count || (nh == count && h < g));",
        "r += h < G && nh > count;"),
    # f32: each chain in two halves of the depth, summed at the end
    "f32_chain_split_in_two": (
        "  ring<T::STAGES>(0, KT, load,\n"
        "                  [&](int slot, int kt) "
        "{ chain(acc, slot, kt); });\n",
        "  float hi[T::TM][T::TN] = {};\n"
        "  ring<T::STAGES>(0, KT / 2, load,\n"
        "                  [&](int slot, int kt) { chain(acc, slot, kt); });\n"
        "  ring<T::STAGES>(KT / 2, KT, load,\n"
        "                  [&](int slot, int kt) { chain(hi, slot, kt); });\n"
        "  for (int i = 0; i < T::TM; ++i)\n"
        "    for (int j = 0; j < T::TN; ++j) acc[i][j] += hi[i][j];\n"),
    # f32: the second depth tile's quads of four k's chained last first
    "f32_k_order_reversed_in_a_tile": (
        "    chain_tile<T, KN>(a, xs + slot * T::BM * T::XP, "
        "ws + slot * WS::FLOATS,\n"
        "                      tx, ty, min(T::BK, K - kt * T::BK));\n",
        "    if (kt == 1 && K >= 2 * T::BK) {\n"
        "      for (int kk = T::BK - 4; kk >= 0; kk -= 4)\n"
        "        chain_quad<T, KN, true>(a, xs + slot * T::BM * T::XP,\n"
        "                                ws + slot * WS::FLOATS, tx, ty, kk,\n"
        "                                T::BK);\n"
        "    } else {\n"
        "      chain_tile<T, KN>(a, xs + slot * T::BM * T::XP,\n"
        "                        ws + slot * WS::FLOATS, tx, ty,\n"
        "                        min(T::BK, K - kt * T::BK));\n"
        "    }\n"),
    # f32: the outer's last stage chains the next group's first row too
    "f32_outer_takes_a_row_of_the_next_group": (
        "const int depth = s.count;  // the chains' steps: the group's rows",
        "const int depth = min(s.count + 1, R - s.start);"),
    # f32: the forward's tail tiles (the rows past sum(gs)) left unwritten
    "f32_tail_rows_not_zeroed": (
        "zero_rows<T::THREADS>(o, N, rows, cols);  // the f32 rows past "
        "sum(gs)",
        "// the f32 rows past sum(gs) left unwritten"),
    # f32: the ring's next tile copied into the stage the chains are on,
    # before the barrier that frees it
    "f32_ring_stage_reused_before_its_barrier": (
        "if (next < kt1) load((next - kt0) % S, next);",
        "if (next < kt1) load((kt - kt0) % S, next);"),
}


def plant(name: str, dst: str) -> None:
    shutil.copytree(os.path.join(ROOT, "gym_tpu_torch"),
                    os.path.join(dst, "gym_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    if name is None:
        return
    old, new = FAULTS[name]
    path = os.path.join(dst, KERNEL)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: {text.count(old)} matches of {old!r}")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def run(name):
    """(exit code, first failure line) of 16a on a copy with ``name``
    planted (None: the checkout as it is)."""
    with tempfile.TemporaryDirectory() as dst:
        plant(name, dst)
        proc = subprocess.run(
            ["timeout", "600", sys.executable, "chip_smoke.py",
             "--b8-check"], cwd=dst, capture_output=True, text=True)
    lines = (proc.stderr + proc.stdout).splitlines()
    failed = [l for l in lines if "FAILED" in l or "Error" in l
              or "error" in l][:1]
    return proc.returncode, failed, lines


def main() -> int:
    rc, failed, lines = run(None)
    print(f"== clean: 16a rc={rc}", *(failed or lines[-1:]), sep="\n  ",
          flush=True)
    ok = rc == 0
    for name in sys.argv[1:] or FAULTS:
        rc, failed, _ = run(name)
        print(f"== {name}: 16a rc={rc}", *failed, sep="\n  ", flush=True)
        ok &= rc != 0
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
