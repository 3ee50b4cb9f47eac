"""Synthetic serving-workload traces.

A trace is a seeded, reproducible list of ``RequestEvent``s — the
arrival process plus each request's shape — with a stable on-disk CSV
format, so the SAME trace drives both arms of the serving simulator:

- ``replay.py`` fires it open-loop at true (scaled) timestamps against
  a real fleet;
- ``cost_model.py`` runs it through the discrete-event queueing twin in
  milliseconds.

Families (all nonhomogeneous-Poisson arrivals via thinning, so the
rate shape is exact and the draw is one ``numpy`` Generator seeded from
``seed`` — same seed, same trace, bit-for-bit):

- ``diurnal``     — sinusoidal rate (the day/night cycle compressed to
  ``duration_s``), starting at the trough.
- ``bursty``      — 2-state MMPP (Markov-modulated Poisson): calm rate
  / burst rate with exponential dwell times — the flappy-traffic shape
  hysteresis and cooldown exist for.
- ``flash_crowd`` — constant base rate with one step to
  ``flash_mult ×`` for ``flash_len_s`` — the scale-up-latency probe.
- ``replay:<serve.csv>`` — exact arrivals reconstructed from a live
  run's ``t_submit`` column (the schema satellite; durations
  alone cannot reconstruct an arrival process).

``prefix_group`` marks requests that share a prompt prefix
(``prompt_tokens`` materializes group members from one seeded stream,
so shared-prefix traffic exercises the paged cache + prefix-affine
dispatch); ``seed`` makes each request's sampling deterministic.

A copy of ``gym_tpu/servesim/traces.py``, which imports no JAX; ``tests/test_torch_servesim.py``
pins the copy to its original.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import math
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

#: stable on-disk column order (``save_trace``/``load_trace``); loading
#: refuses a file whose header disagrees — a trace is an artifact, not
#: a guess
TRACE_HEADER = ["arrival_s", "prompt_len", "max_new", "deadline_s",
                "prefix_group", "seed"]

#: Multi-tenant traces append ``tenant``/``slo_class``.
#: ``save_trace`` only writes this header when some event actually
#: carries tenant fields (single-tenant traces stay byte-identical to
#: the v1 format); ``load_trace`` accepts both headers.
TRACE_HEADER_TENANT = TRACE_HEADER + ["tenant", "slo_class"]

TRACE_FAMILIES = ("diurnal", "bursty", "flash_crowd",
                  "noisy_neighbor", "tenant_flash", "mixed_slo")


@dataclasses.dataclass(frozen=True)
class RequestEvent:
    """One request in a trace: when it arrives and what it asks for."""

    arrival_s: float
    prompt_len: int
    max_new: int
    deadline_s: Optional[float] = None
    #: requests with the same non-negative group share a prompt prefix
    prefix_group: Optional[int] = None
    #: per-request sampling seed (determinism across replay arms)
    seed: int = 0
    #: multi-tenant attribution; None = the single-tenant
    #: default, indistinguishable from a pre-tenant trace
    tenant: Optional[str] = None
    slo_class: Optional[str] = None


def save_trace(path: str, events: List[RequestEvent]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tenanted = any(e.tenant is not None or e.slo_class is not None
                   for e in events)
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(TRACE_HEADER_TENANT if tenanted else TRACE_HEADER)
        for e in events:
            # repr floats: load_trace(save_trace(...)) is EXACT — a
            # trace is an artifact both simulator arms must agree on
            row = [
                repr(float(e.arrival_s)), e.prompt_len, e.max_new,
                "" if e.deadline_s is None else repr(float(e.deadline_s)),
                "" if e.prefix_group is None else e.prefix_group,
                e.seed]
            if tenanted:
                row += [e.tenant or "", e.slo_class or ""]
            w.writerow(row)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_trace(path: str) -> List[RequestEvent]:
    with open(path, newline="") as f:
        r = csv.reader(f)
        header = next(r, None)
        if header not in (TRACE_HEADER, TRACE_HEADER_TENANT):
            raise ValueError(
                f"{path} is not a gym_tpu trace (header {header!r}, "
                f"want {TRACE_HEADER!r} or {TRACE_HEADER_TENANT!r})")
        tenanted = header == TRACE_HEADER_TENANT
        events = []
        for row in r:
            events.append(RequestEvent(
                arrival_s=float(row[0]), prompt_len=int(row[1]),
                max_new=int(row[2]),
                deadline_s=float(row[3]) if row[3] else None,
                prefix_group=int(row[4]) if row[4] else None,
                seed=int(row[5]),
                tenant=(row[6] or None) if tenanted else None,
                slo_class=(row[7] or None) if tenanted else None))
    return events


# -- prompt materialization ------------------------------------------------


def prompt_tokens(ev: RequestEvent, vocab_size: int,
                  prefix_frac: float = 0.5) -> np.ndarray:
    """The request's actual prompt, derived deterministically from the
    event alone: members of one ``prefix_group`` share the leading
    ``prefix_frac`` of their prompt (one seeded stream per group, so
    any two members agree on their common prefix — the paged cache and
    prefix-affine dispatch see real shared-prefix traffic); the tail
    (and ungrouped prompts entirely) comes from the per-request
    ``seed`` stream."""
    plen = int(ev.prompt_len)
    tail_rng = np.random.default_rng([4217, int(ev.seed), plen])
    if ev.prefix_group is None or ev.prefix_group < 0:
        return tail_rng.integers(0, vocab_size, plen).astype(np.int32)
    npfx = max(1, int(plen * prefix_frac))
    pfx_rng = np.random.default_rng([9173, int(ev.prefix_group)])
    pfx = pfx_rng.integers(0, vocab_size, npfx)
    tail = tail_rng.integers(0, vocab_size, plen - npfx)
    return np.concatenate([pfx, tail]).astype(np.int32)


# -- arrival processes -----------------------------------------------------


def _thinned_poisson(rng: np.random.Generator,
                     rate_fn: Callable[[float], float],
                     duration_s: float, max_rate: float) -> List[float]:
    """Nonhomogeneous Poisson arrivals on [0, duration) by thinning:
    draw a homogeneous process at ``max_rate``, keep each point with
    probability ``rate_fn(t) / max_rate``."""
    if max_rate <= 0:
        return []
    t, out = 0.0, []
    while True:
        t += float(rng.exponential(1.0 / max_rate))
        if t >= duration_s:
            return out
        if rng.random() < rate_fn(t) / max_rate:
            out.append(t)


def _shape_events(rng: np.random.Generator, arrivals: List[float], *,
                  prompt_lens=(8, 48), max_news=(8, 32),
                  deadline_s: Optional[float] = None,
                  deadline_frac: float = 0.0,
                  prefix_groups: int = 0,
                  prefix_frac_of_requests: float = 0.5,
                  tenant: Optional[str] = None,
                  slo_class: Optional[str] = None
                  ) -> List[RequestEvent]:
    """Attach request shapes to an arrival list. ``deadline_frac`` of
    requests carry ``deadline_s``; ``prefix_frac_of_requests`` of them
    are spread across ``prefix_groups`` shared-prefix groups;
    ``tenant``/``slo_class`` stamp every event (multi-tenant families
    merge several shaped populations via ``_merge_populations``)."""
    events = []
    for i, t in enumerate(arrivals):
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1]))
        mnew = int(rng.integers(max_news[0], max_news[1]))
        dl = (float(deadline_s)
              if deadline_s is not None and rng.random() < deadline_frac
              else None)
        grp = (int(rng.integers(0, prefix_groups))
               if prefix_groups > 0
               and rng.random() < prefix_frac_of_requests else None)
        events.append(RequestEvent(
            arrival_s=float(t), prompt_len=plen, max_new=mnew,
            deadline_s=dl, prefix_group=grp, seed=i,
            tenant=tenant, slo_class=slo_class))
    return events


def _merge_populations(*pops: List[RequestEvent]) -> List[RequestEvent]:
    """Interleave per-tenant populations by arrival time and re-seed
    sequentially so every request's sampling seed is unique across the
    merged trace (``Outcome.index`` — and the replay arms' per-request
    determinism — key off the seed)."""
    merged = sorted((e for pop in pops for e in pop),
                    key=lambda e: (e.arrival_s, e.tenant or "", e.seed))
    return [dataclasses.replace(e, seed=i)
            for i, e in enumerate(merged)]


def diurnal_trace(duration_s: float = 60.0, base_rps: float = 2.0,
                  amplitude: float = 0.8,
                  period_s: Optional[float] = None, seed: int = 0,
                  **shape_kw) -> List[RequestEvent]:
    """Sinusoidal rate ``base·(1 + A·sin)``, one full period over
    ``period_s`` (default: the whole trace), starting at the trough —
    the compressed day/night cycle the scale-down half of a policy is
    priced against."""
    period = float(period_s or duration_s)
    amplitude = min(max(float(amplitude), 0.0), 1.0)

    def rate(t):
        return base_rps * (1.0 + amplitude
                           * math.sin(2 * math.pi * t / period
                                      - math.pi / 2))

    rng = np.random.default_rng([101, seed])
    arr = _thinned_poisson(rng, rate, duration_s,
                           base_rps * (1.0 + amplitude))
    return _shape_events(rng, arr, **shape_kw)


def bursty_trace(duration_s: float = 60.0, calm_rps: float = 0.5,
                 burst_rps: float = 8.0, mean_calm_s: float = 8.0,
                 mean_burst_s: float = 2.0, seed: int = 0,
                 **shape_kw) -> List[RequestEvent]:
    """2-state MMPP: exponential dwell in a calm state at ``calm_rps``
    and a burst state at ``burst_rps`` — the flappy shape that punishes
    a policy with no hysteresis/cooldown."""
    rng = np.random.default_rng([202, seed])
    edges: List[float] = []     # state-change times; starts calm
    t = 0.0
    burst = False
    while t < duration_s:
        dwell = float(rng.exponential(
            mean_burst_s if burst else mean_calm_s))
        t += dwell
        edges.append(min(t, duration_s))
        burst = not burst

    def rate(t):
        # state flips at each edge; even intervals (before edges[0],
        # after edges[1], ...) are calm
        import bisect
        return burst_rps if bisect.bisect_right(edges, t) % 2 else calm_rps

    arr = _thinned_poisson(rng, rate, duration_s,
                           max(calm_rps, burst_rps))
    return _shape_events(rng, arr, **shape_kw)


def flash_crowd_trace(duration_s: float = 60.0, base_rps: float = 1.0,
                      flash_at_s: float = 20.0,
                      flash_mult: float = 8.0,
                      flash_len_s: float = 10.0, seed: int = 0,
                      **shape_kw) -> List[RequestEvent]:
    """Constant base rate with one step to ``flash_mult × base_rps``
    for ``flash_len_s`` — the scale-up-latency probe (how long does the
    backlog take to drain after the policy reacts?)."""

    def rate(t):
        if flash_at_s <= t < flash_at_s + flash_len_s:
            return base_rps * flash_mult
        return base_rps

    rng = np.random.default_rng([303, seed])
    arr = _thinned_poisson(rng, rate, duration_s, base_rps * flash_mult)
    return _shape_events(rng, arr, **shape_kw)


# -- multi-tenant families --------------------------------------


def noisy_neighbor_trace(duration_s: float = 60.0,
                         victim_rps: float = 2.0,
                         flood_rps: float = 12.0,
                         flood_at_s: float = 15.0,
                         flood_len_s: float = 30.0,
                         victim_deadline_s: float = 4.0,
                         seed: int = 0) -> List[RequestEvent]:
    """The headline isolation drill as a trace: tenant A runs a steady
    interactive stream (short prompts, short generations, tight
    deadlines) while tenant B floods batch work (long generations, no
    deadline) for ``flood_len_s`` in the middle — the workload a
    quota/preemption policy must keep A's TTFT flat under."""
    rng = np.random.default_rng([404, seed])
    victim = _shape_events(
        rng, _thinned_poisson(rng, lambda t: victim_rps, duration_s,
                              victim_rps),
        prompt_lens=(8, 24), max_news=(4, 12),
        deadline_s=victim_deadline_s, deadline_frac=1.0,
        tenant="tenant_a", slo_class="interactive")

    def flood_rate(t):
        return (flood_rps
                if flood_at_s <= t < flood_at_s + flood_len_s else 0.0)

    flood = _shape_events(
        rng, _thinned_poisson(rng, flood_rate, duration_s, flood_rps),
        prompt_lens=(16, 64), max_news=(24, 64),
        tenant="tenant_b", slo_class="batch")
    return _merge_populations(victim, flood)


def tenant_flash_trace(duration_s: float = 60.0, tenants: int = 3,
                       base_rps: float = 1.0, flash_tenant: int = 0,
                       flash_mult: float = 8.0,
                       flash_at_s: float = 20.0,
                       flash_len_s: float = 12.0,
                       deadline_s: float = 6.0,
                       seed: int = 0) -> List[RequestEvent]:
    """Per-tenant flash crowd: ``tenants`` standard-class streams at
    ``base_rps`` each, one of which (``flash_tenant``) steps to
    ``flash_mult ×`` for ``flash_len_s`` — does one tenant's surge eat
    its SIBLINGS' SLO, or only its own quota?"""
    pops = []
    for k in range(int(tenants)):
        rng = np.random.default_rng([505, seed, k])
        if k == flash_tenant:
            def rate(t):
                if flash_at_s <= t < flash_at_s + flash_len_s:
                    return base_rps * flash_mult
                return base_rps
            peak = base_rps * flash_mult
        else:
            def rate(t):
                return base_rps
            peak = base_rps
        pops.append(_shape_events(
            rng, _thinned_poisson(rng, rate, duration_s, peak),
            prompt_lens=(8, 32), max_news=(8, 24),
            deadline_s=deadline_s, deadline_frac=1.0,
            tenant=f"tenant_{k}", slo_class="standard"))
    return _merge_populations(*pops)


def mixed_slo_trace(duration_s: float = 60.0, total_rps: float = 4.0,
                    interactive_frac: float = 0.5,
                    batch_frac: float = 0.25,
                    interactive_deadline_s: float = 4.0,
                    standard_deadline_s: float = 8.0,
                    seed: int = 0) -> List[RequestEvent]:
    """A mixed batch+interactive population from one org: class mix is
    the knob (``interactive_frac`` + ``batch_frac`` ≤ 1, remainder is
    ``standard``) — the sweep's class-mix axis. Interactive requests
    are small and deadline'd, batch requests large and patient."""
    batch_frac = min(float(batch_frac), 1.0 - float(interactive_frac))
    rng = np.random.default_rng([606, seed])
    inter = _shape_events(
        rng, _thinned_poisson(
            rng, lambda t: total_rps * interactive_frac, duration_s,
            total_rps * interactive_frac),
        prompt_lens=(8, 24), max_news=(4, 12),
        deadline_s=interactive_deadline_s, deadline_frac=1.0,
        tenant="org_inter", slo_class="interactive")
    std_rps = total_rps * max(0.0, 1.0 - interactive_frac - batch_frac)
    std = _shape_events(
        rng, _thinned_poisson(rng, lambda t: std_rps, duration_s,
                              std_rps),
        prompt_lens=(8, 48), max_news=(8, 32),
        deadline_s=standard_deadline_s, deadline_frac=1.0,
        tenant="org_std", slo_class="standard")
    batch = _shape_events(
        rng, _thinned_poisson(
            rng, lambda t: total_rps * batch_frac, duration_s,
            total_rps * batch_frac),
        prompt_lens=(16, 64), max_news=(24, 64),
        tenant="org_batch", slo_class="batch")
    return _merge_populations(inter, std, batch)


def replay_from_serve_csv(path: str, default_max_new: int = 16,
                          deadline_s: Optional[float] = None
                          ) -> List[RequestEvent]:
    """Reconstruct a trace from a live run's ``serve.csv`` — EXACT
    arrivals via the ``t_submit`` column (request rows; the
    schema satellite), normalized so the first arrival is t=0. Rows
    predating the column (or rejected rows with no token counts) fall
    back to ``default_max_new``; deadlines are not recorded in
    serve.csv, so ``deadline_s`` (if given) applies uniformly."""
    rows = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            if row.get("kind") != "request":
                continue
            t_sub = row.get("t_submit")
            if not t_sub:
                # pre-servesim CSV: fall back to the completion stamp —
                # the best available anchor (documented inexact)
                t_sub = row.get("ts_s")
            if not t_sub:
                continue
            plen = int(float(row.get("prompt_tokens") or 0))
            mnew = int(float(row.get("new_tokens") or 0))
            rows.append((float(t_sub), max(1, plen),
                         mnew if mnew > 0 else int(default_max_new)))
    if not rows:
        raise ValueError(f"{path} holds no replayable request rows")
    rows.sort()
    t0 = rows[0][0]
    return [RequestEvent(arrival_s=t - t0, prompt_len=p, max_new=m,
                         deadline_s=deadline_s, prefix_group=None,
                         seed=i)
            for i, (t, p, m) in enumerate(rows)]


def make_trace(family: str, seed: int = 0,
               **kw: Any) -> List[RequestEvent]:
    """Family-name dispatch (the sweep's and CLI's entry point).
    ``replay:<path>`` replays a ``serve.csv``."""
    if family.startswith("replay:"):
        return replay_from_serve_csv(family[len("replay:"):], **kw)
    fns = {"diurnal": diurnal_trace, "bursty": bursty_trace,
           "flash_crowd": flash_crowd_trace,
           "noisy_neighbor": noisy_neighbor_trace,
           "tenant_flash": tenant_flash_trace,
           "mixed_slo": mixed_slo_trace}
    if family not in fns:
        raise ValueError(f"unknown trace family {family!r}; known: "
                         f"{TRACE_FAMILIES} or replay:<serve.csv>")
    return fns[family](seed=seed, **kw)


def trace_stats(events: List[RequestEvent]) -> Dict[str, Any]:
    """Headline shape of a trace (sanity surface for reports/CLI)."""
    if not events:
        return {"requests": 0}
    arr = np.asarray([e.arrival_s for e in events])
    dur = float(arr.max()) if arr.size else 0.0
    bins = np.bincount(arr.astype(int),
                       minlength=int(dur) + 1) if dur else np.array([0])
    stats: Dict[str, Any] = {
        "requests": len(events),
        "duration_s": round(dur, 3),
        "mean_rps": round(len(events) / dur, 3) if dur else None,
        "peak_rps_1s": int(bins.max()),
        "total_max_new": int(sum(e.max_new for e in events)),
        "with_deadline": sum(1 for e in events
                             if e.deadline_s is not None),
        "prefix_grouped": sum(1 for e in events
                              if e.prefix_group is not None),
    }
    tenants: Dict[str, int] = {}
    classes: Dict[str, int] = {}
    for e in events:
        if e.tenant is not None:
            tenants[e.tenant] = tenants.get(e.tenant, 0) + 1
        if e.slo_class is not None:
            classes[e.slo_class] = classes.get(e.slo_class, 0) + 1
    if tenants:
        stats["tenants"] = dict(sorted(tenants.items()))
    if classes:
        stats["by_class"] = dict(sorted(classes.items()))
    return stats


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Generate a seeded synthetic serving trace "
                    "(diurnal / bursty / flash_crowd, or "
                    "replay:<serve.csv>) in the stable on-disk format")
    p.add_argument("--family", default="diurnal",
                   help=f"one of {TRACE_FAMILIES} or replay:<serve.csv>")
    p.add_argument("--duration", type=float, default=60.0)
    p.add_argument("--rps", type=float, default=2.0,
                   help="base requests/s (burst family: calm rate)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deadline", type=float, default=None,
                   help="deadline_s applied to --deadline-frac of "
                        "requests")
    p.add_argument("--deadline-frac", type=float, default=1.0)
    p.add_argument("--prefix-groups", type=int, default=0)
    p.add_argument("--prompt-lens", default="8-48", metavar="LO-HI",
                   help="prompt-length range (prompt + max_new must "
                        "fit the served model's block_size)")
    p.add_argument("--max-new", default="8-32", metavar="LO-HI",
                   help="max_new_tokens range")
    p.add_argument("--out", required=True, metavar="TRACE_CSV")
    args = p.parse_args(argv)

    def _range(s: str):
        lo, hi = s.split("-")
        return (int(lo), int(hi))

    if args.family.startswith("replay:"):
        # a replayed serve.csv fixes the arrivals and shapes; only the
        # knobs replay_from_serve_csv understands apply (everything
        # else would be silently ignored — refuse the footgun instead)
        kw: Dict[str, Any] = dict(
            deadline_s=args.deadline,
            default_max_new=_range(args.max_new)[1])
    else:
        kw = dict(duration_s=args.duration,
                  deadline_s=args.deadline,
                  deadline_frac=args.deadline_frac,
                  prefix_groups=args.prefix_groups,
                  prompt_lens=_range(args.prompt_lens),
                  max_news=_range(args.max_new))
        if args.family == "bursty":
            kw["calm_rps"] = args.rps
        else:
            kw["base_rps"] = args.rps
    events = make_trace(args.family, seed=args.seed, **kw)
    save_trace(args.out, events)
    print(json.dumps({"trace": args.out, "family": args.family,
                      **trace_stats(events)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
