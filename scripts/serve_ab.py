#!/usr/bin/env python3
"""A/B of two checkouts on the serving path, on one card, one process a
run, in the order given (e.g. OLD NEW NEW OLD):

    python3 scripts/serve_ab.py TREE_A TREE_B TREE_B TREE_A

Each run builds the tree's kernels and times, with ``chip_smoke.py``'s
``timed`` (CUDA events, median of 5), R1 at phase 10's decode shapes (16
rows of the four dense layers and the lm head), at the prefill buckets
64-512 of the 768-to-3072 and 3072-to-768 layers, at a 1024-row prefill
and at the sampler's scan ([16 or 80 rows x 1572, 32] x [32, 32]), B7
at the decode shape, a 5-token verify and a 512-token prefill, and a
residual add with its layer norm at [16, 768] (one launch where the tree
has ``row_add_layer_norm``, else a torch add and L1); then serves phase 10's workload (a) through
``Scheduler`` twice, and prints the second run's output tokens/s. Where
the tree has quantized serving, B6 (``row_qlinear``, int8) at the same
shapes but the scan and B7 int8 at B7's shapes, and the workload's output tokens/s
under int8 weights and int8 KV. One line a run, led by the card's name
and power limit.
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
shapes = [(16, 768, 2304, False), (16, 768, 768, False),
          (16, 768, 3072, False), (16, 3072, 768, False),
          (16, 768, 50304, True), (1024, 768, 3072, False)]
shapes += [(m, k, n, False) for m in (64, 128, 256, 512)
           for k, n in ((768, 3072), (3072, 768))]
shapes += [(m, 32, 32, False) for m in (16 * 1572, 80 * 1572)]
for m, k, n, lm in shapes:
    w = (torch.triu(torch.ones(32, 32, device="cuda")) if k == 32 else
         torch.randn(*((n, k) if lm else (k, n)), device="cuda",
                     generator=g) * 0.02)
    x = torch.randn(m, k, device="cuda", generator=g)
    out[f"R1 {m}x{k}x{n}"] = cs.timed(torch, lambda: trow.row_linear(
        x, w, None, lm))
    if hasattr(trow, "row_qlinear") and k != 32:
        q, s = cs.quantized_weight(torch, g, (n, k) if lm else (k, n), 8)
        out[f"B6 {m}x{k}x{n}"] = cs.timed(torch, lambda: trow.row_qlinear(
            x, q, s, None, lm))
from gym_tpu_torch.ops import decode_attention as tdec
_, _, kp, vp, table = cs.paged_window(torch, g, 16)
cur = torch.randint(16, 577, (16,), device="cuda", generator=g,
                    dtype=torch.int32)
for tag, q, tb, c in (
        ("B7 decode", torch.randn(16, 1, 12, 64, device="cuda", generator=g),
         table, cur),
        ("B7 verify5", torch.randn(16, 5, 12, 64, device="cuda", generator=g),
         table, cur),
        ("B7 prefill512", torch.randn(1, 512, 12, 64, device="cuda",
                                      generator=g), table[:1],
         torch.zeros(1, dtype=torch.int32, device="cuda"))):
    out[tag] = cs.timed(torch, lambda: tdec.decode_attention(q, kp, vp, tb,
                                                             c))
    if hasattr(tdec, "decode_attention_int8"):
        from gym_tpu_torch.ops.fused_attention import kv_quantize
        (kq, ks), (vq, vs) = kv_quantize(kp), kv_quantize(vp)
        out[tag + " int8"] = cs.timed(
            torch, lambda: tdec.decode_attention_int8(q, kq, vq, ks, vs, tb,
                                                      c))
        del kq, vq, ks, vs
del kp, vp
x, d = (torch.randn(16, 768, device="cuda", generator=g) for _ in "xd")
sc, bi = (torch.randn(768, device="cuda", generator=g) for _ in "sb")
if hasattr(trow, "row_add_layer_norm"):
    out["L1 add 16x768"] = cs.timed(torch, lambda: trow.row_add_layer_norm(
        x, d, sc, bi))
else:
    out["L1 add 16x768"] = cs.timed(torch, lambda: trow.row_layer_norm(
        x + d, sc, bi))
cfg, params, work = cs.serve_model_cfg(), cs.serve_params(), \
    cs.serve_workload()
kw = dict(num_slots=16, paged=True, page_size=16, decode_chunk=8)
for _ in range(2):
    toks, eng, _, wall, _ = cs.serve_run(torch, params, cfg, work, "ab",
                                         **kw)
out["tokens/s"] = sum(len(t) for t in toks) / wall
out["decode_steps"] = eng.stats.decode_steps
del eng
if hasattr(trow, "row_qlinear"):
    from gym_tpu_torch.serve.load import quantize_params
    qcfg = cs.quant_cfg()
    q8 = quantize_params(params, qcfg)
    for _ in range(2):
        toks, eng, _, wall, _ = cs.serve_run(torch, q8, qcfg, work, "ab",
                                             **kw)
        del eng
    out["int8 tokens/s"] = sum(len(t) for t in toks) / wall
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
