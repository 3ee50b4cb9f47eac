#!/usr/bin/env python3
"""A/B of two checkouts on the serving path, on one card, one process a
run, in the order given (e.g. OLD NEW NEW OLD):

    python3 scripts/serve_ab.py TREE_A TREE_B TREE_B TREE_A

Each run builds the tree's kernels and times, with ``chip_smoke.py``'s
``timed`` (CUDA events, median of 5), R1 at phase 10's decode shapes (16
rows of the four dense layers and the lm head) and at a 1024-row prefill,
and B7 at the decode shape and a 512-token prefill; then serves phase 10's workload (a) through
``Scheduler`` twice, and prints the second run's output tokens/s. One
line a run, led by the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

RUN = r'''
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from gym_tpu_torch.ops import row_linear as trow
torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device="cuda").manual_seed(0)
out = {}
for m, k, n, lm in ((16, 768, 2304, False), (16, 768, 768, False),
                    (16, 768, 3072, False), (16, 3072, 768, False),
                    (16, 768, 50304, True), (1024, 768, 3072, False)):
    w = torch.randn(*((n, k) if lm else (k, n)), device="cuda",
                    generator=g) * 0.02
    x = torch.randn(m, k, device="cuda", generator=g)
    out[f"R1 {m}x{k}x{n}"] = cs.timed(torch, lambda: trow.row_linear(
        x, w, None, lm))
from gym_tpu_torch.ops import decode_attention as tdec
_, _, kp, vp, table = cs.paged_window(torch, g, 16)
cur = torch.randint(16, 577, (16,), device="cuda", generator=g,
                    dtype=torch.int32)
for tag, q, tb, c in (
        ("B7 decode", torch.randn(16, 1, 12, 64, device="cuda", generator=g),
         table, cur),
        ("B7 prefill512", torch.randn(1, 512, 12, 64, device="cuda",
                                      generator=g), table[:1],
         torch.zeros(1, dtype=torch.int32, device="cuda"))):
    out[tag] = cs.timed(torch, lambda: tdec.decode_attention(q, kp, vp, tb,
                                                             c))
del kp, vp
cfg, params, work = cs.serve_model_cfg(), cs.serve_params(), \
    cs.serve_workload()
kw = dict(num_slots=16, paged=True, page_size=16, decode_chunk=8)
for _ in range(2):
    toks, eng, _, wall, _ = cs.serve_run(torch, params, cfg, work, "ab",
                                         **kw)
out["tokens/s"] = sum(len(t) for t in toks) / wall
out["decode_steps"] = eng.stats.decode_steps
print(json.dumps(out))
'''


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{card} {os.path.basename(os.path.abspath(tree))}: " +
              ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
