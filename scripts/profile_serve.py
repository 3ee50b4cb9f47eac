#!/usr/bin/env python3
"""Where phase 10's serving run goes on the card: ``torch.profiler`` over
``chip_smoke.py``'s phase-10 workload (GPT-2 base, random f32 weights,
32 requests through ``Scheduler`` over the paged engine: page 16, 16
slots, ``decode_chunk`` 8), after a warm run of the same workload.

    python3 scripts/profile_serve.py [--spec 4] [--unpaged]

Prints the run's wall time and output tokens/s, the device busy share (the
device time of every kernel and copy over the profiled run's wall time),
the host's time in kernel launches and copies, and the kernels by their
device time. Needs a CUDA card; the profiler's full table goes to
``build/profile_serve.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spec", type=int, default=0, help="spec_tokens")
    p.add_argument("--unpaged", action="store_true")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from profile_fit import device_us
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cfg, params, work = cs.serve_model_cfg(), cs.serve_params(), \
        cs.serve_workload()
    kw = (dict(num_slots=16, decode_chunk=8) if args.unpaged else
          dict(num_slots=16, paged=True, page_size=16, decode_chunk=8,
               spec_tokens=args.spec))
    cs.serve_run(torch, params, cfg, work, "warm", **kw)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        toks, eng, _, _, _ = cs.serve_run(torch, params, cfg, work, "run",
                                          **kw)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and device_us(e) > 0), key=device_us, reverse=True)
    total = sum(device_us(e) for e in dev)
    launch = sum(e.self_cpu_time_total for e in events
                 if "LaunchKernel" in e.key or "Memcpy" in e.key)
    ntok = sum(len(t) for t in toks)
    lines = [f"serve {kw}: {ntok} tokens, wall {wall * 1e3:.1f} ms "
             f"({ntok / wall:.1f} tokens/s under the profiler), "
             f"{eng.stats.decode_steps} decode steps, {eng.stats.prefills} "
             f"prefills; device busy {total / 1e3:.1f} ms = "
             f"{total / (wall * 1e6):.1%} of the wall; host time in kernel "
             f"launches and copies {launch / 1e3:.1f} ms",
             f"  {'device ms':>10} {'share':>6} {'calls':>6}  name"]
    for e in dev[:25]:
        lines.append(f"  {device_us(e) / 1e3:10.3f} "
                     f"{device_us(e) / total:6.1%} {e.count:6d}  "
                     f"{e.key[:100]}")
    text = "\n".join(lines)
    print(text, flush=True)
    out = os.path.join(HERE, "build")
    os.makedirs(out, exist_ok=True)
    key = ("self_device_time_total"
           if hasattr(dev[0], "self_device_time_total")
           else "self_cuda_time_total")
    with open(os.path.join(out, "profile_serve.txt"), "w") as f:
        f.write(text + "\n\n" + events.table(sort_by=key, row_limit=60)
                + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
