#!/usr/bin/env python3
"""The digest of phase 16c's tokens in checkouts of the port, on one CUDA
card, each run in its own process:

    python3 scripts/moe_serve_digest.py TREE_A TREE_B ...

Each run serves, with TREE's code (its ``chip_smoke.py`` helpers and its
``gym_tpu_torch``), what phase 16c serves eagerly: the MoE GPT-2 base in f32
(random weights from seed 0), 8 of phase 10's requests through the paged
engine (page 16, 16 slots, ``decode_chunk`` 8), and prints one JSON line:
the tree, the card, the tokens and their digest as this checkout's
``chip_smoke.tokens_digest`` takes it. Two checkouts whose kernels give
the same bits give the same digest.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    cs = _module("tree_chip_smoke", os.path.join(tree, "chip_smoke.py"))
    here = _module("here_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    from gym_tpu_torch.convert import serving_params
    from gym_tpu_torch.models.nanogpt import GPT, GPTConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(**{k: v for k, v in cs.MOE_BASE.items()
                       if k != "attn_impl"})
    params = serving_params(GPT(cfg).init_params(1, 0, "cuda"), node=0)
    got, _, _, wall, _ = cs.serve_run(
        torch, params, cfg, cs.serve_workload()[:8], "digest",
        cuda_graphs=False, num_slots=16, paged=True, page_size=16,
        decode_chunk=8)
    print(json.dumps({"tree": tree, "card": cs.card_line(),
                      "tokens": sum(len(t) for t in got),
                      "digest": here.tokens_digest(got),
                      "wall_s": wall}), flush=True)


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
