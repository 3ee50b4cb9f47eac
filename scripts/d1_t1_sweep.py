#!/usr/bin/env python3
"""D1's and T1 bits rows' launch plans, each against its oracle, at the
main path's shapes, on a machine with a CUDA card:

    python3 scripts/d1_t1_sweep.py [--d1] [--t1]

D1 (``scatter_mean_decode_tuned``) at config 5's three signatures and K =
2's 64 picks, (G, m, E) = (200, 2048, 4096), (108, 2048, 64), (4, 2048,
2112), (200, 64, 4096), at every slots a warp of 4-2048 and warps a block
of 1-8; T1 bits rows
(``random_bits_rows_tuned``) at a decode step's 16 and a verify's 80 rows
of 50,304 (each key folded with a step index) and the one-key path's row
of 16 x 50,304 (with a step index and, as ``generate`` draws it, without),
at every groups a lane
of 1, 2, 4, 8, warps an SM of 8-64 and warps a block of 2-8, and at one
row of 4 (a launch's floor). Each plan's
output is first held bit for bit to the oracle (the first kernel), then
timed with ``chip_smoke.py``'s ``timed`` (CUDA events, median of 5), the
oracle in the same turn; the plan the kernel picks by itself is starred.
Prints a line a shape, led by the card's name and power limit, and exits
non-zero if any plan differs from the oracle in a bit.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

D1_SHAPES = ((200, 2048, 4096), (108, 2048, 64), (4, 2048, 2112),
             (200, 64, 4096))
D1_SLOTS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
D1_WARPS = (1, 2, 4, 8)
T1_SHAPES = ((16, 50304, True), (80, 50304, True), (1, 16 * 50304, True),
             (1, 16 * 50304, False))
T1_GROUPS = (1, 2, 4, 8)
T1_WARPS_SM = (8, 12, 16, 24, 32, 64)
T1_WARPS_BLOCK = (2, 4, 8)


def sweep_d1(torch, cs, tsm, g) -> int:
    differ = 0
    for rows, m, e in D1_SHAPES:
        idx = torch.randint(0, e, (rows, m), device="cuda", generator=g,
                            dtype=torch.int32)
        val = torch.randn(rows, m, device="cuda", generator=g)
        want = tsm.scatter_mean_decode_ref(idx, val, e).view(torch.int32)
        own = tsm.launch_plan(rows, e)
        times, seen = {}, set()
        for slots in D1_SLOTS:
            for warps in D1_WARPS:
                plan = tsm.launch_plan(rows, e, slots, warps)
                key = (plan["run"], plan["warps"])
                if key in seen:   # the same launch as an earlier setting
                    continue
                seen.add(key)

                def run(s=slots, w=warps):
                    return tsm.scatter_mean_decode_tuned(idx, val, e, s, w)
                if not torch.equal(run().view(torch.int32), want):
                    differ += 1
                    times[key] = None
                    continue
                times[key] = cs.timed(torch, run)
        ref_ms = cs.timed(torch, lambda: tsm.scatter_mean_decode_ref(
            idx, val, e))
        best = min((v, k) for k, v in times.items() if v is not None)
        mine = (own["run"], own["warps"])
        print(f"D1 (G, m, E) = ({rows}, {m}, {e}): oracle {ref_ms:.4f} ms; "
              f"best {best[1][0]} slots x {best[1][1]} warps {best[0]:.4f}; "
              f"own *{mine} {times.get(mine) or float('nan'):.4f}; all (run "
              f"x warps): " + ", ".join(
                  f"{'*' if k == mine else ''}{k[0]}x{k[1]} "
                  + ("DIFFERS" if v is None else f"{v:.4f}")
                  for k, v in sorted(times.items())), flush=True)
        del idx, val, want
    return differ


def sweep_t1(torch, cs, tf, g) -> int:
    differ = 0
    for rows, n, fold in T1_SHAPES:
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (rows, 2), device="cuda",
                             generator=g, dtype=torch.int32)
        data = (torch.arange(rows, dtype=torch.int32, device="cuda") if fold
                else None)
        want = tf.random_bits_rows_ref(keys, data, n)
        times = {}
        for per in T1_GROUPS:
            for wps in T1_WARPS_SM:
                for wpb in T1_WARPS_BLOCK:
                    def run(p=per, w=wps, b=wpb):
                        return tf.random_bits_rows_tuned(keys, data, n, p, w,
                                                         b)
                    key = (per, wps, wpb)
                    if not torch.equal(run(), want):
                        differ += 1
                        times[key] = None
                        continue
                    times[key] = cs.timed(torch, run, reps=7, inner=20)
        ref_ms = cs.timed(torch, lambda: tf.random_bits_rows_ref(keys, data,
                                                                 n),
                          reps=7, inner=20)
        own_ms = cs.timed(torch, lambda: tf.random_bits_rows(keys, data, n),
                          reps=7, inner=20)
        best = min((v, k) for k, v in times.items() if v is not None)
        print(f"T1 bits rows [{rows}, {n}]{'' if fold else ' no fold'}: "
              f"oracle {ref_ms:.4f} ms; own "
              f"{own_ms:.4f}; best {best[1][0]} groups a lane, {best[1][1]} "
              f"warps an SM, {best[1][2]} a block {best[0]:.4f}; all (groups, "
              f"warps an SM, warps a block): "
              + ", ".join(f"{k[0]},{k[1]},{k[2]} "
                          + ("DIFFERS" if v is None else f"{v:.4f}")
                          for k, v in sorted(times.items())), flush=True)
    keys = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
    print(f"T1 bits rows [1, 4], a launch's floor: own "
          f"{cs.timed(torch, lambda: tf.random_bits_rows(keys, None, 4)):.4f}"
          f" ms, oracle "
          f"{cs.timed(torch, lambda: tf.random_bits_rows_ref(keys, None, 4)):.4f}"
          f" ms", flush=True)
    return differ


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--d1", action="store_true", help="D1 only")
    p.add_argument("--t1", action="store_true", help="T1 bits rows only")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("d1_t1_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gym_tpu_torch.ops import scatter_mean as tsm
    from gym_tpu_torch.ops import threefry as tf
    print(cs.card_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    both = not (args.d1 or args.t1)
    differ = 0
    if args.d1 or both:
        differ += sweep_d1(torch, cs, tsm, g)
    if args.t1 or both:
        differ += sweep_t1(torch, cs, tf, g)
    print(f"d1_t1_sweep: {differ} plans differ from the oracle", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
