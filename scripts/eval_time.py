#!/usr/bin/env python3
"""Time one f32 eval of the long-context config (GPT-2 base at T=8192,
``remat``, ``loss_chunk=2048``, K=2 nodes × 1 row) in checkouts of the port,
on one CUDA card, each run in its own process, in the order given:

    python3 scripts/eval_time.py TREE_A TREE_B TREE_B TREE_A

Each run imports TREE's ``gym_tpu_torch`` (its kernels built into
TREE/build/) and times its eval step with this checkout's
``chip_smoke.time_eval`` (the host clock around a synchronise, median of
3 after a warm-up), and prints one JSON line: the tree, the card and the
ms of one eval. Every eval of that config runs the f32 long-context
forward 24 times (12 layers, node 0's and the mean params).
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(tree: str) -> None:
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    import gym_tpu_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(cs.GPT2_BASE, block_size=8192, remat=True, loss_chunk=2048)
    ms = cs.time_eval(torch, cfg, 2)
    print(json.dumps({"tree": tree, "package": gym_tpu_torch.__file__,
                      "card": cs.card_line(), "eval_ms": ms}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", os.path.abspath(tree)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
