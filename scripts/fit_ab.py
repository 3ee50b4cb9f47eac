#!/usr/bin/env python3
"""Steady training rate of a BASELINE config, of the flagship or of a
compressed strategy's fit, in checkouts of the port, on one CUDA card, each
run in its own process, in the order given:

    python3 scripts/fit_ab.py 9d TREE_A TREE_B TREE_B TREE_A [--steps 20]

Each run builds TREE's kernels (into TREE/build/), runs a warm fit of two
steps and then a fit of ``--steps`` steps at ``chip_smoke.py``'s settings
(a phase-9 config without evals, TREE's ``scripts/profile_fit.py``
``fit_of``; the flagship as phase 4 trains it, TREE's
``chip_smoke.gpt_fit``: GPT 4L/4H/128d, T=256, K=64 × 16 rows, bf16,
DiLoCo; ``8e``, DiLoCo with the int8 codec at GPT-2 base, K=4 × 4 rows, H
2, as phase 8e trains it; ``8d_dynamiq``, DynamiQ int8 at the flagship,
K=16 × 16 rows, as phase 8d does; ``16b``, the MoE GPT-2 base (every
second block 8 experts, top-2) at K=2 × 4 rows, bf16, DiLoCo, as phase
16b trains it), and prints one JSON line: the tree, the
card, the steady steps/s, the ms a step and the measured fit's peak device
memory. Alternate the trees (A B B A ...) so that a drift of the host
favours neither; the spread of one tree's runs says how far apart two
medians must be to differ.
"""

import argparse
import json
import os
import subprocess
import sys

FLAGSHIP = dict(block_size=256, vocab_size=65, n_layer=4, n_head=4,
                n_embd=128, attn_impl="flash")
# the compressed strategies' fits: (GPT-2 base or the flagship, nodes, rows)
CODEC_FITS = {"8e": ("base", 4, 4), "8d_dynamiq": ("flagship", 16, 16)}


def run_one(config: str, steps: int, tree: str) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(tree, "scripts"))
    import torch

    import chip_smoke as cs
    from profile_fit import fit_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def fit(n):
        if config == "flagship":
            return cs.gpt_fit(torch, FLAGSHIP, 64, 16, n, "cuda", True, 0,
                              "ab_flagship")
        if config == "16b":
            return cs.gpt_fit(torch, cs.MOE_BASE, 2, 4, n, "cuda", True, 0,
                              "ab_16b")
        if config in CODEC_FITS:
            from gym_tpu_torch import strategy
            adamw = strategy.OptimSpec("adamw", lr=3e-4)
            if config == "8e":
                strat = strategy.DiLoCoStrategy(adamw, H=2, codec="int8",
                                                **cs.SCHED)
            else:
                strat = strategy.DynamiQStrategy(adamw, codec="int8",
                                                 **cs.SCHED)
            cfg, nodes, batch = CODEC_FITS[config]
            return cs.gpt_fit(torch, cs.GPT2_BASE if cfg == "base" else
                              FLAGSHIP, nodes, batch, n, "cuda", True, 0,
                              f"ab_{config}", strategy=strat)
        return fit_of(cs, config, n)()

    fit(2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = fit(steps)
    sps = res.steps_per_second_steady
    print(json.dumps({"tree": tree, "card": cs.card_line(), "config": config,
                      "steps": steps, "steady_steps_per_s": sps,
                      "ms_a_step": 1e3 / sps if sps else None,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}),
          flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--one":
        run_one(sys.argv[2], int(sys.argv[3]), sys.argv[4])
        return 0
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", choices=["9a", "9b", "9c", "9d", "flagship",
                                       "16b", *CODEC_FITS])
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
