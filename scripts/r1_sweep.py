#!/usr/bin/env python3
"""R1's and B6's tilings, each against the oracle, at the serving path's
shapes, on a machine with a CUDA card:

    python3 scripts/r1_sweep.py [--b6]

For every shape (GPT-2 base's four dense layers and its lm head at decode's
M = 1, 16 and 32, the dense layers at M = 33-1024: prefill buckets, a
gamma-4 verify of 16 slots, a 1024-row prefill; the sampler's scan at 16 and
80 rows) and every tiling that fits its layout (``row_gemm.cu``'s ``enum
Tiling``), the output is first held bit for bit to the oracle
(``row_linear_ref``) and then timed with ``chip_smoke.py``'s ``timed`` (CUDA
events, median of 5), the oracle in the same turn; the tiling the dispatch
picks is starred. ``--b6`` does the same for B6 on int8 weights against its
oracle. Prints a line a shape, led by the card's name and power limit, and
exits non-zero if any tiling differs from the oracle in a bit.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DENSE = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
LM_HEAD = (768, 50304)


def shapes():
    """(M, K, N, W read as [N, K])"""
    out = [(m, k, n, False) for m in (1, 16, 32) for k, n in DENSE]
    out += [(m, *LM_HEAD, True) for m in (1, 16, 80)]
    out += [(m, k, n, False) for m in (33, 64, 80, 128, 256, 512, 1024)
            for k, n in DENSE]
    out += [(m, 32, 32, False) for m in (16 * 1572, 80 * 1572)]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--b6", action="store_true", help="B6 on int8 weights")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("r1_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from gym_tpu_torch.ops import row_linear as trow
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    differ = 0
    kn_tilings = [i for i, t in enumerate(trow.TILINGS)
                  if not t.startswith("nk")]
    for m, k, n, nk in shapes():
        if args.b6 and k == n == 32:
            continue
        shape = (n, k) if nk else (k, n)
        x = torch.randn(m, k, device="cuda", generator=g)
        if args.b6:
            q, s = cs.quantized_weight(torch, g, shape, 8)

            def run(t, q=q, s=s, x=x, nk=nk):
                return trow.row_gemm_tiled(x, q, nk, t, scale=s)

            def ref(q=q, s=s, x=x, nk=nk):
                return trow.row_qlinear_ref(x, q, s, None, nk)
        else:
            w = (torch.triu(torch.ones(32, 32, device="cuda")) if k == 32
                 else torch.randn(*shape, device="cuda", generator=g) * 0.02)

            def run(t, w=w, x=x, nk=nk):
                return trow.row_gemm_tiled(x, w, nk, t)

            def ref(w=w, x=x, nk=nk):
                return trow.row_linear_ref(x, w, None, nk)
        pick = trow.tiling_of(m, k, n, nk)
        tilings = ([len(trow.TILINGS) - 1] if nk else
                   [t for t in kn_tilings
                    if trow.TILINGS[t].startswith("scan") == (n <= 32)])
        want = ref()
        times = {}
        for t in tilings:
            if not torch.equal(run(t).view(torch.int32),
                               want.view(torch.int32)):
                differ += 1
                times[t] = None
                continue
            times[t] = cs.timed(torch, lambda t=t: run(t))
        ref_ms = cs.timed(torch, ref)
        print(f"{'B6 int8' if args.b6 else 'R1'} [{m}, {k}] x [{k}, {n}]"
              f"{' nk' if nk else ''}: oracle {ref_ms:.4f} ms; " + ", ".join(
                  f"{'*' if t == pick else ''}{trow.TILINGS[t]} "
                  + ("DIFFERS" if v is None else f"{v:.4f}")
                  for t, v in times.items()), flush=True)
    print(f"r1_sweep: {differ} tilings differ from the oracle", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
