#!/usr/bin/env python3
"""Time B8's f32 forward (``grouped_gemm.cu``'s ring kernels) at each of
its tilings on a CUDA card, at the MoE path's shapes: the training
products (16,384 rows, C 768, H 3072, 8 experts, one of 60% of the rows,
w as it lies and read transposed) and the served steps of
``chip_smoke.py``'s routing (tokens routed top-2, fc and proj):

    python3 scripts/b8_f32_sweep.py

Each tiling's output is held bit for bit to the oracle (the first kernel,
``grouped_dot_ref``); prints, a shape, each tiling's time (CUDA events,
``chip_smoke.timed``), the oracle's, the per-expert ``torch.matmul``
loop's and the tiling ``f32_tiling`` picks, then the card. Exits non-zero
if a tiling's bits differ.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = (1, 4, 16, 32, 64, 128, 256, 414, 512, 2048)


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    import gym_tpu_torch.ops.grouped_matmul as tgm

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    g = torch.Generator(device="cuda").manual_seed(16)

    def randn(*shape, std=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * std

    r, c, h, e = cs.B8_ROWS, cs.B8_C, cs.B8_H, cs.B8_E
    w_fc, w_pr = randn(e, c, h, std=0.02), randn(e, h, c, std=0.02)
    gs8 = torch.tensor(cs.b8_skewed(r, e), dtype=torch.int32, device="cuda")
    x, hid = randn(r, c), randn(r, h)
    cases = [("fc", x, w_fc, gs8), ("proj", hid, w_pr, gs8),
             ("ct_x fc", randn(r, h, std=0.02), w_fc.transpose(1, 2), gs8),
             ("ct_x proj", randn(r, c, std=0.02), w_pr.transpose(1, 2), gs8)]
    for tokens in TOKENS:
        xs, hs, gs = cs.b8_routed(torch, randn, tokens)
        cases += [(f"served fc, {tokens} tokens", xs, w_fc, gs),
                  (f"served proj, {tokens} tokens", hs, w_pr, gs)]
    ok = True
    for name, a, w, gs in cases:
        oracle = tgm.grouped_dot_ref(a, w, gs)
        line = f"{name} [{a.shape[0]}, {a.shape[1]}] x {list(w.shape)}:"
        for t, rows in tgm.F32_TILE_ROWS.items():
            def run():
                return tgm._launch_dot(a, w, gs, tiling=t)[0]
            same = torch.equal(run(), oracle)
            ok &= same
            line += (f" {rows}-row tiles {cs.timed(torch, run):.4f} ms"
                     f"{'' if same else ' (BITS DIFFER)'};")
        loop, _ = cs.b8_library(torch, "dot", a, w, gs)
        ref_ms = cs.timed(torch, lambda: tgm.grouped_dot_ref(a, w, gs))
        line += (f" oracle {ref_ms:.4f} ms; per-expert loop "
                 f"{cs.timed(torch, loop):.4f} ms; picked "
                 f"{tgm.F32_TILE_ROWS[tgm.f32_tiling(a.shape[0])]}-row tiles")
        print(line, flush=True)
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
