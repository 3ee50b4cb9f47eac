#!/usr/bin/env python3
"""Time T1, the threefry Bernoulli masks, in checkouts of the port on one
CUDA card, each run in its own process, in the order given:

    python3 scripts/t1_ab.py TREE_A TREE_B TREE_B TREE_A

Each run builds TREE's kernels (into TREE/build/) and times, with TREE's
own ``chip_smoke.py`` phase-7 functions, SPARTA's masks of a GPT-2 base
step (148 leaves, phase 8a's shapes) and the per-row masks of a config 2
step (12 launches of 8 rows), and prints one JSON line: the tree, the card
and both times in ms (the device's time, ``chip_smoke.timed``).
"""

import json
import subprocess
import sys


def run_one(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import gym_tpu_torch.ops.threefry as tf
    from gym_tpu_torch.ops import _build

    _build.build()
    rate = cs.int32_rate(torch)
    leaves = cs.gpt_leaves(dict(block_size=1024, vocab_size=50304,
                                n_layer=12, n_head=12, n_embd=768,
                                attn_impl="flash"))
    masks = cs.time_threefry(torch, tf, leaves, cs.THREEFRY_LEAST_OPS, rate)
    rows, _ = cs.time_threefry_rows(torch, tf, rate)
    print(json.dumps({"tree": tree, "card": cs.card_line(),
                      "sparta_step_ms": masks["ms"],
                      "dropout_rows_step_ms": rows["ms"]}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
