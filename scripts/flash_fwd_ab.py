#!/usr/bin/env python3
"""Time the long-context forward (B5f, bf16 or with --f32 f32) of one or
more checkouts of the port on one CUDA card, each run in its own process,
in the order given:

    python3 scripts/flash_fwd_ab.py [--f32] TREE_A TREE_B TREE_B TREE_A

Each run builds TREE's kernels (into TREE/build/), checks ``_flash_fwd``
against ``plain_flash_fwd`` with ``chip_smoke.py``'s tolerance of the dtype
and prints one JSON line: for N=2, T=8192 and D=64 (H=12), 128 (H=6) and 32
(H=24) the median ms (``chip_smoke.timed``, 9 runs of 10 launches), the
TFLOP/s of the computed tiles (products of the dtype) and a digest of o
and lse, so that two versions with the same arithmetic show the same
digest.
"""

import hashlib
import json
import math
import subprocess
import sys

SHAPES = ((2, 12, 8192, 64), (2, 6, 8192, 128), (2, 24, 8192, 32))


def run_one(tree: str, dtype_name: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import gym_tpu_torch.ops.flash_attention as tflash
    from gym_tpu_torch.ops import _build

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    out = {"tree": tree, "card": cs.card_line(), "dtype": dtype_name}
    for n, h, t, d in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        heads, _ = cs.per_head_views(torch, g, n, h, t, d, dtype)
        scale = 1 / math.sqrt(d)
        o, lse = tflash._flash_fwd(*heads, scale)
        ro, rl = tflash.plain_flash_fwd(*heads, scale)
        cs.compare(f"D={d} o", o, ro, "out", dtype)
        cs.compare(f"D={d} lse", lse, rl, "lse", dtype)
        digest = hashlib.sha256(o.view(bits).cpu().numpy().tobytes()
                                + lse.cpu().numpy().tobytes()).hexdigest()
        ms = cs.timed(torch, lambda: tflash._flash_fwd(*heads, scale),
                      reps=9, inner=10)
        out[f"D{d}"] = {"ms": ms, "digest": digest[:16],
                        "tflops": cs.tile_tflops(n, h, t, d, 2, ms)}
        del heads, o, lse, ro, rl
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        run_one(sys.argv[2], sys.argv[3])
        return 0
    args = sys.argv[1:]
    dtype = "float32" if args[:1] == ["--f32"] else "bfloat16"
    trees = args[1:] if dtype == "float32" else args
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in trees:
        rc |= subprocess.run([sys.executable, __file__, "--one", tree,
                              dtype]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
