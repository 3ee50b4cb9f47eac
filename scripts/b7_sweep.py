#!/usr/bin/env python3
"""B7's paths (and, with ``--int8``, B7 int8's), each against the oracle, at
the serving path's shapes, on a machine with a CUDA card:

    python3 scripts/b7_sweep.py [--int8]

For every shape (GPT-2 base's 12 heads of 64 on a paged pool of 16: decode
steps and verify chunks of 16 rows at cursors 16-576, t = 1-8; prefills of
one row from position 0 at t = 4-1024, the prefill buckets of
``chip_smoke.py`` phase 10's prompts and a 1024-token one, and one from
position 256, a prefix hit) and every path (``decode_attention.cu``'s ``enum
Path``: a block a query, or a tile of 16 queries), the output is
first held bit for bit to the oracle (``decode_attention_ref``) and then
timed with ``chip_smoke.py``'s ``timed`` (CUDA events, median of 5), the
oracle in the same turn; the path the dispatch picks is starred. The
dispatch's threshold on t (``kDecodeMaxT``) is read from this table.
Prints a line a shape, led by the card's name and power limit, and exits
non-zero if any path differs from the oracle in a bit.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def shapes():
    """(rows, t, lowest cursor, highest cursor)"""
    out = [(16, t, 16, 576) for t in (1, 2, 3, 4, 5, 8)]
    out += [(1, t, 0, 0) for t in (4, 8, 16, 32, 64, 128, 256, 512, 1024)]
    out += [(1, 256, 256, 256)]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--int8", action="store_true", help="B7 int8 on int8 "
                   "pools")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("b7_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gym_tpu_torch.ops import decode_attention as tdec
    from gym_tpu_torch.ops import fused_attention as tfa
    print(cs.card_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    _, _, kp, vp, table = cs.paged_window(torch, g, 16)
    scales = ()
    if args.int8:
        (kp, ks), (vp, vs) = tfa.kv_quantize(kp), tfa.kv_quantize(vp)
        scales = (ks, vs)
    differ = 0
    for b, t, lo, hi in shapes():
        cur = torch.randint(lo, hi + 1, (b,), device="cuda", generator=g,
                            dtype=torch.int32)
        q = torch.randn(b, t, cs.SERVE_H, cs.SERVE_HD, device="cuda",
                        generator=g)
        case = (q, kp, vp, scales, table[:b], cur)
        want = cs.b7_call(tdec, case, ref=True)
        times = {}
        for path in range(len(tdec.PATHS)):
            if not cs.same_bits(torch, cs.b7_call(tdec, case, path=path),
                                want):
                differ += 1
                times[path] = None
                continue
            times[path] = cs.timed(torch, lambda path=path: cs.b7_call(
                tdec, case, path=path))
        ref_ms = cs.timed(torch, lambda: cs.b7_call(tdec, case, ref=True))
        pick = tdec.path_of(t)
        print(f"{'B7 int8' if args.int8 else 'B7'} b={b} t={t} cursors "
              f"{lo}-{hi}: oracle {ref_ms:.4f} ms; " + ", ".join(
                  f"{'*' if p == pick else ''}{tdec.PATHS[p]} "
                  + ("DIFFERS" if v is None else f"{v:.4f}")
                  for p, v in times.items()), flush=True)
    print(f"b7_sweep: {differ} paths differ from the oracle", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
