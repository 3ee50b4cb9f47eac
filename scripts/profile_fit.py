#!/usr/bin/env python3
"""Where a training step of a BASELINE config goes on the card:
``torch.profiler`` over a fit of ``--steps`` steps (no evals), after a warm
fit of two, at ``chip_smoke.py``'s phase-9 settings; ``16b`` is phase
16b's MoE fit (GPT-2 base, every second block 8 experts top-2, K=2 × 4
rows, bf16, DiLoCo), with its eval at the start and at the end.

    python3 scripts/profile_fit.py 9b 9d 9f [--steps 8] [--kernel NAME ...]

Prints, a config, the fit's wall time, the device busy share (the sum of
the device time of every kernel and copy over the wall time of the
profiled fit, init included; one stream, so they do not overlap), the
host's time in kernel launches and copies, and the kernels by their device
time; ``--kernel NAME`` also prints the device time, share and launches
of the kernels whose names hold NAME (e.g. ``scatter_mean_kernel`` for
D1). Needs a CUDA card; the profiler's full table goes to
``build/profile_<config>.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fit_of(cs, config, steps):
    if config == "16b":  # phase 16b's MoE fit (its two evals included)
        import torch
        return lambda: cs.gpt_fit(torch, cs.MOE_BASE, 2, 4, steps, "cuda",
                                  True, 0, "prof_16b")
    if config == "9d":
        return lambda: cs.config4_fit(steps, val_size=0, run_name="prof_9d")
    if config == "9f":
        return lambda: cs.config5_fit(steps, val_size=0, run_name="prof_9f")
    which, nodes = {"9a": ("simple_reduce", 2), "9b": ("diloco", 8),
                    "9c": ("sparta", 8)}[config]
    return lambda: cs.mnist_fit(cs.mnist_strategy(which), nodes, steps,
                                "cuda", cs.MNIST_BATCH, cs.MNIST_MICRO,
                                f"prof_{config}", val_size=0)


def device_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)


def kernel_lines(dev, total, names):
    """A line for each of ``names``: the device time, share of ``total``
    and launches of the kernels whose names hold it."""
    lines = []
    for name in names:
        hit = [e for e in dev if name in e.key]
        us = sum(device_us(e) for e in hit)
        lines.append(f"  {name}: {us / 1e3:.3f} device ms, "
                     f"{us / total:.2%} of the device time, "
                     f"{sum(e.count for e in hit)} launches")
    return lines


def profile(cs, torch, config, steps, kernels=()):
    from torch.profiler import ProfilerActivity, profile as tprofile
    fit_of(cs, config, 2)()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fit_of(cs, config, steps)()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the kernels and copies themselves: an operator's own device time
    # repeats that of the kernels it launched
    dev = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and device_us(e) > 0), key=device_us, reverse=True)
    total = sum(device_us(e) for e in dev)
    launch = sum(e.self_cpu_time_total for e in events
                 if "LaunchKernel" in e.key or "Memcpy" in e.key)
    lines = [f"{config}: {steps} steps, wall {wall * 1e3:.1f} ms "
             f"({wall / steps * 1e3:.2f} ms a step incl. init; steady "
             f"{res.steps_per_second_steady} steps/s); device busy "
             f"{total / 1e3:.1f} ms = {total / (wall * 1e6):.1%} of the wall; "
             f"host time in kernel launches and copies {launch / 1e3:.1f} ms",
             f"  {'device ms':>10} {'share':>6} {'calls':>6}  name"]
    for e in dev[:25]:
        lines.append(f"  {device_us(e) / 1e3:10.3f} "
                     f"{device_us(e) / total:6.1%} {e.count:6d}  "
                     f"{e.key[:100]}")
    lines += kernel_lines(dev, total, kernels)
    text = "\n".join(lines)
    print(text, flush=True)
    out = os.path.join(HERE, "build")
    os.makedirs(out, exist_ok=True)
    key = ("self_device_time_total"
           if hasattr(dev[0], "self_device_time_total")
           else "self_cuda_time_total")
    with open(os.path.join(out, f"profile_{config}.txt"), "w") as f:
        f.write(text + "\n\n" + events.table(sort_by=key, row_limit=60)
                + "\n")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("configs", nargs="+",
                   choices=["9a", "9b", "9c", "9d", "9f", "16b"])
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--kernel", action="append", default=[],
                   help="also report the kernels whose names hold this")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    for config in args.configs:
        profile(cs, torch, config, args.steps, args.kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
