#!/usr/bin/env python3
"""Steady training rate of a BASELINE config, or of the flagship, in
checkouts of the port, on one CUDA card, each run in its own process, in
the order given:

    python3 scripts/fit_ab.py 9d TREE_A TREE_B TREE_B TREE_A [--steps 20]

Each run builds TREE's kernels (into TREE/build/), runs a warm fit of two
steps and then a fit of ``--steps`` steps at ``chip_smoke.py``'s settings
(a phase-9 config without evals, TREE's ``scripts/profile_fit.py``
``fit_of``; the flagship as phase 4 trains it, TREE's
``chip_smoke.gpt_fit``: GPT 4L/4H/128d, T=256, K=64 × 16 rows, bf16,
DiLoCo), and prints one JSON line: the tree, the card, the steady steps/s
and the ms a step. Alternate the trees (A B B A ...) so that a
drift of the host favours neither; the spread of one tree's runs says how
far apart two medians must be to differ.
"""

import argparse
import json
import os
import subprocess
import sys

FLAGSHIP = dict(block_size=256, vocab_size=65, n_layer=4, n_head=4,
                n_embd=128, attn_impl="flash")


def run_one(config: str, steps: int, tree: str) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(tree, "scripts"))
    import torch

    import chip_smoke as cs
    from profile_fit import fit_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def fit(n):
        if config != "flagship":
            return fit_of(cs, config, n)()
        return cs.gpt_fit(torch, FLAGSHIP, 64, 16, n, "cuda", True, 0,
                          "ab_flagship")

    fit(2)
    res = fit(steps)
    sps = res.steps_per_second_steady
    print(json.dumps({"tree": tree, "card": cs.card_line(), "config": config,
                      "steps": steps, "steady_steps_per_s": sps,
                      "ms_a_step": 1e3 / sps if sps else None}), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--one":
        run_one(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        return 0
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", choices=["9a", "9b", "9c", "9d", "flagship"])
    p.add_argument("trees", nargs="+")
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args()
    rc = 0
    for tree in args.trees:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", args.config, str(args.steps),
                              os.path.abspath(tree)])
        rc |= run.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
