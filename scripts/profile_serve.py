#!/usr/bin/env python3
"""Where phase 10's serving run goes on the card: ``torch.profiler`` over
``chip_smoke.py``'s phase-10 workload (GPT-2 base, random f32 weights,
32 requests through ``Scheduler`` over the paged engine: page 16, 16
slots, ``decode_chunk`` 8), after a warm run of the same workload on
another engine; the profiled engine's program family is built before the
profiler starts (on the card its CUDA graphs, captured; ``--eager`` runs
the same staged programs without graphs).

    python3 scripts/profile_serve.py [--spec 4] [--unpaged] [--eager]
        [--quant int8] [--by-shape] [--kv-write] [--kernel NAME ...]

Prints the run's wall time and output tokens/s, the device busy share (the
device time of every kernel and copy over the profiled run's wall time),
the host's time in kernel launches, graph launches and copies, the host's
launch calls, and the kernels by their device time. Needs a CUDA card;
the profiler's full table goes to ``build/profile_serve.txt``.
``chip_smoke.py`` phase 12a calls ``profile_workload`` for both modes.
``--kernel NAME`` also prints the device time, share and launches of the
kernels whose names hold NAME (e.g. ``threefry_rows_bits`` for the
sampler's bits).
``--quant int8`` serves phase 13b's int8 weights and int8 KV instead.

``--by-shape`` breaks R1's and B6's device time down by shape: the
wrappers tally the run's launches by (M, K, N, W's layout)
(``row_linear.shape_counts``; a CUDA graph replay adds the launches its
capture recorded), each shape is then timed alone with ``chip_smoke.py``'s
``timed`` (CUDA events, random inputs of that shape), and launches × time
is its estimated device time, printed beside the profiler's own total of
the ``row_gemm`` kernels' device time in the run. The shapes fall in three
groups: the scan (``row_cumsum``'s K = N = 32), decode rows (M <= 32) and
many rows (prefill buckets and verify chunks, M >= 33).

``--kv-write`` estimates the KV write path's device time (``GPT.write_kv``:
under ``--quant int8`` ``kv_quantize`` of K and V and the scatters of the
int8 values and their scales into the pools; in f32 the two scatters):
one layer's call at decode's shape (16 rows, one token, cursors 16-576,
paged) is timed alone (CUDA events) and its device kernels counted
(``torch.profiler``), and the run's calls are counted as its B7 (or B7
int8) launches (one a layer a decode call, each right after its write):
calls × time alone, beside the profiler's device total.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))

# the host-side calls that put work on the card's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cudaGraphLaunch", "cudaMemcpyAsync")


def shape_group(m, k, n):
    """Which of R1's three regimes a launch of [M, K] x [K, N] is in."""
    if k == n == 32:
        return "scan"
    return "decode rows" if m <= 32 else "many rows"


def by_shape(torch, cs, counts, profiled_ms):
    """Lines of R1's and B6's estimated device time by shape: each shape's
    launches in the run times its time alone (CUDA events), largest first,
    with each group's sum, beside the profiler's total."""
    from gym_tpu_torch.ops import row_linear as trow
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (kern, m, k, n, lay), launches in counts.items():
        nk = lay == "nk"
        shape = (n, k) if nk else (k, n)
        x = torch.randn(m, k, device="cuda", generator=g)
        if kern == "B6":
            q, s = cs.quantized_weight(torch, g, shape, 8)
            ms = cs.timed(torch, lambda: trow.row_qlinear(x, q, s, None, nk))
        else:
            w = torch.randn(*shape, device="cuda", generator=g) * 0.02
            ms = cs.timed(torch, lambda: trow.row_linear(x, w, None, nk))
        rows.append((launches * ms, kern, m, k, n, lay, launches, ms))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    groups = {}
    for r in rows:
        grp = shape_group(*r[2:5])
        groups[grp] = groups.get(grp, 0.0) + r[0]
    lines = [f"R1 and B6 by shape: {sum(counts.values())} launches, "
             f"estimated {total:.3f} ms (launches x time alone) against "
             f"the profiler's {profiled_ms:.3f} ms of row_gemm kernels; "
             + ", ".join(f"{grp} {v:.3f} ms ({v / total:.1%})"
                         for grp, v in sorted(groups.items(),
                                              key=lambda kv: -kv[1])),
             f"  {'est ms':>9} {'share':>6} {'launches':>8} {'ms each':>8}"
             f"  kernel [M, K] x [K, N] layout  group"]
    for est, kern, m, k, n, lay, launches, ms in rows:
        lines.append(f"  {est:9.3f} {est / total:6.1%} {launches:8d} "
                     f"{ms:8.4f}  {kern} [{m}, {k}] x [{k}, {n}] {lay}  "
                     f"{shape_group(m, k, n)}")
    return lines


def kv_write_alone(torch, cs, cfg):
    """(ms, device kernels) of one layer's ``GPT.write_kv`` at decode's
    shape: 16 rows, one token each, cursors 16-576, a paged pool of 16."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile as tprofile

    from gym_tpu_torch.models.nanogpt import GPT, decode_config
    g = torch.Generator(device="cuda").manual_seed(0)
    nblk = cfg.block_size // 16
    model = GPT(dataclasses.replace(decode_config(cfg), page_size=16,
                                    kv_pages=1 + 16 * nblk, n_layer=1))
    cache = model.init_cache(16, "cuda")
    table = (1 + torch.randperm(16 * nblk, device="cuda", generator=g)).view(
        16, nblk).to(torch.int32)
    cur = torch.randint(16, 577, (16,), device="cuda", generator=g,
                        dtype=torch.int32)
    h = cfg.n_head
    k, v = (torch.randn(16, 1, h, cfg.n_embd // h, device="cuda",
                        generator=g) for _ in "kv")

    def write():
        return model.write_kv(cache, "h_0.attn", k, v, cur, table)

    ms = cs.timed(torch, write)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        write()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return ms, kernels


def profile_workload(torch, cs, kw, graphs=True, warm_pass=True,
                     quant=None, shapes=False, kv_write=False, kernels=()):
    """Profile one pass of phase 10's workload through a fresh engine of
    ``kw`` whose family was built first, after a pass on another engine
    (``warm_pass``; a caller that served on the card already may skip
    it); ``quant="int8"`` serves phase 13b's int8 weights and KV, and
    ``shapes`` adds R1's and B6's device time by shape, ``kv_write`` the
    KV write path's estimated device time. Returns ``(text,
    summary)``: the report and ``{"wall_s", "tokens_per_s", "busy",
    "launch_ms", "launch_calls", "decode_steps"}``."""
    from collections import Counter

    from profile_fit import device_us
    from torch.profiler import ProfilerActivity, profile as tprofile

    from gym_tpu_torch.ops import decode_attention as tdec
    from gym_tpu_torch.ops import row_linear as trow
    from gym_tpu_torch.programs import warm_engine_programs
    from gym_tpu_torch.serve import InferenceEngine
    work = cs.serve_workload()
    if quant:
        from gym_tpu_torch.serve.load import quantize_params
        cfg = cs.quant_cfg(weights_dtype=quant, kv_dtype=quant)
        params = quantize_params(cs.serve_params(device="cpu"), cfg)
    else:
        cfg, params = cs.serve_model_cfg(), cs.serve_params()
    kw = dict(kw, cuda_graphs=graphs)
    if warm_pass:
        cs.serve_run(torch, params, cfg, work, "warm", **kw)
    eng = InferenceEngine(params, cfg, device="cuda", **kw)
    warm_engine_programs(eng, start=False).run()
    torch.cuda.synchronize()
    trow.shape_counts = Counter() if shapes else None
    tdec.reset_launch_counts()
    try:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            toks, _, _, _ = cs.serve_loop(torch, eng, work, "profiled")
            wall = time.perf_counter() - t0
    finally:
        counts, trow.shape_counts = trow.shape_counts, None
    attends = (tdec.decode_attention.launches
               + tdec.decode_attention_int8.launches)
    events = prof.key_averages()
    dev = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and device_us(e) > 0), key=device_us, reverse=True)
    total = sum(device_us(e) for e in dev)
    launch = sum(e.self_cpu_time_total for e in events
                 if "LaunchKernel" in e.key or "Memcpy" in e.key
                 or "GraphLaunch" in e.key)
    calls = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    ntok = sum(len(t) for t in toks)
    summary = {"wall_s": wall, "tokens_per_s": ntok / wall,
               "busy": total / (wall * 1e6), "launch_ms": launch / 1e3,
               "launch_calls": calls,
               "decode_steps": eng.stats.decode_steps}
    lines = [f"serve {kw}{' ' + quant if quant else ''}: {ntok} tokens, "
             f"wall {wall * 1e3:.1f} ms "
             f"({ntok / wall:.1f} tokens/s under the profiler), "
             f"{eng.stats.decode_steps} decode steps, {eng.stats.prefills} "
             f"prefills; device busy {total / 1e3:.1f} ms = "
             f"{total / (wall * 1e6):.1%} of the wall; host time in kernel "
             f"and graph launches and copies {launch / 1e3:.1f} ms, "
             f"{calls} launch calls",
             f"  {'device ms':>10} {'share':>6} {'calls':>6}  name"]
    for e in dev[:25]:
        lines.append(f"  {device_us(e) / 1e3:10.3f} "
                     f"{device_us(e) / total:6.1%} {e.count:6d}  "
                     f"{e.key[:100]}")
    for name in kernels:
        hit = [e for e in dev if name in e.key]
        us = sum(device_us(e) for e in hit)
        lines.append(f"  {name}: {us / 1e3:.3f} device ms, "
                     f"{us / total:.2%} of the device time, "
                     f"{sum(e.count for e in hit)} launches")
    eng.close()
    if shapes:
        gemm_ms = sum(device_us(e) for e in dev if "row_gemm" in e.key) / 1e3
        lines += by_shape(torch, cs, counts, gemm_ms)
    if kv_write:
        ms, kernels = kv_write_alone(torch, cs, cfg)
        est = attends * ms
        lines.append(
            f"KV write path (GPT.write_kv{', int8' if quant else ''}): "
            f"{attends} calls (the run's B7 launches) x {ms:.4f} ms alone at "
            f"decode's shape = {est:.3f} ms estimated, "
            f"{est / (total / 1e3):.1%} of the device total "
            f"{total / 1e3:.3f} ms; {kernels} device kernels a call, "
            f"{attends * kernels} in the run")
    text = "\n".join(lines)
    out = os.path.join(HERE, "build")
    os.makedirs(out, exist_ok=True)
    key = ("self_device_time_total"
           if hasattr(dev[0], "self_device_time_total")
           else "self_cuda_time_total")
    name = ("profile_serve" + ("" if graphs else "_eager")
            + (f"_{quant}" if quant else "") + ".txt")
    with open(os.path.join(out, name), "w") as f:
        f.write(text + "\n\n" + events.table(sort_by=key, row_limit=60)
                + "\n")
    return text, summary


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spec", type=int, default=0, help="spec_tokens")
    p.add_argument("--unpaged", action="store_true")
    p.add_argument("--eager", action="store_true",
                   help="the staged programs without CUDA graphs")
    p.add_argument("--quant", choices=("int8",), default=None,
                   help="int8 weights and int8 KV (phase 13b)")
    p.add_argument("--by-shape", action="store_true",
                   help="R1's and B6's device time by shape")
    p.add_argument("--kv-write", action="store_true",
                   help="the KV write path's estimated device time")
    p.add_argument("--kernel", action="append", default=[],
                   help="also report the kernels whose names hold this")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    kw = (dict(num_slots=16, decode_chunk=8) if args.unpaged else
          dict(num_slots=16, paged=True, page_size=16, decode_chunk=8,
               spec_tokens=args.spec))
    text, _ = profile_workload(torch, cs, kw, graphs=not args.eager,
                               quant=args.quant, shapes=args.by_shape,
                               kv_write=args.kv_write,
                               kernels=args.kernel)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
