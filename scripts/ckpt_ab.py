#!/usr/bin/env python3
"""The checkpoint writer's cost to a fit on the card: ``chip_smoke.py``
phase 11a's fit (GPT-2 base, K=2 × 4 rows, bf16, DiLoCo H=2) for 6 steps
without checkpoints, with ``checkpoint_interval=3`` through the async
writer, and with synchronous saves, in turns (none, async, sync, sync,
async, none); each run's steady steps/s, wall time, and the host's time
between the steps, each step synchronised (the save at step 3 lands in the
gap after the third).

    python3 scripts/ckpt_ab.py
"""

import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gym_tpu_torch.utils import logger
    if not torch.cuda.is_available():
        print("ckpt_ab: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    cs.CKPT_ROOT = os.path.join(ROOT, "build", "ckpt_ab")
    marks = []
    increment = logger.CSVLogger.increment_step

    def timed_increment(self):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        increment(self)

    logger.CSVLogger.increment_step = timed_increment
    arms = {"none": dict(checkpoint_interval=None, save_dir=None),
            "async": {}, "sync": dict(async_checkpoint=False)}
    try:
        cs.ckpt_fit(torch, cs.GPT2_BASE, 2, "warm", **arms["none"])
        for arm in ("none", "async", "sync", "sync", "async", "none"):
            shutil.rmtree(cs.CKPT_ROOT, ignore_errors=True)
            marks.clear()
            t0 = time.perf_counter()
            res = cs.ckpt_fit(torch, cs.GPT2_BASE, cs.CKPT_STEPS, arm,
                              **arms[arm])
            wall = time.perf_counter() - t0
            gaps = [f"{b - a:.3f}" for a, b in zip(marks, marks[1:])]
            print(f"{arm}: steady {res.steps_per_second_steady:.4f} steps/s"
                  f", wall {wall:.2f} s (the writer's close included), "
                  f"gaps between steps (s) {gaps}", flush=True)
            del res
            torch.cuda.empty_cache()
    finally:
        logger.CSVLogger.increment_step = increment
        shutil.rmtree(cs.CKPT_ROOT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
