"""Open-loop trace replayer + SLO report.

Fires a trace at its TRUE (optionally ``--time-scale``d) arrival
timestamps against a real serving target — an in-process
``Router``/``ProcessRouter`` object or a live HTTP server — and folds
per-request outcomes into one SLO report.

Open-loop means NON-COORDINATED-OMISSION: every request launches at its
trace timestamp on its own thread regardless of whether earlier
requests finished. A closed-loop client (fire the next request when
the previous answers) silently slows its own arrival process exactly
when the server is slow, hiding the tail it claims to measure; the
open-loop replayer keeps the offered load honest, so queueing delay
lands in TTFT where it belongs.

Outcome statuses mirror ``serve.csv``'s request-row statuses:
``done`` / ``rejected`` (admission or queue-full shed before enqueue) /
``shed`` (deadline elapsed) / ``failed`` (typed server failure) /
``disconnected``. ``slo_report`` aggregates counts, shed rate, TTFT /
latency percentiles, SLO attainment and — when a replica-seconds probe
ran — the cost side of the cost-vs-SLO frontier.

A copy of ``gym_tpu/servesim/replay.py``, which imports no JAX; ``tests/test_torch_servesim.py``
pins the copy to its original.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .traces import RequestEvent, load_trace, prompt_tokens


@dataclasses.dataclass
class Outcome:
    """One request's replay result — the shared schema both the live
    replayer and the cost model emit, so their reports compare
    field-for-field."""

    index: int
    arrival_s: float            # scheduled arrival (post time-scale)
    t_submit: float             # actual submit offset from replay t0
    status: str                 # done/rejected/shed/failed/disconnected
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None
    tokens: int = 0
    max_new: int = 0
    deadline_s: Optional[float] = None
    replica: Optional[int] = None
    failovers: int = 0
    error: Optional[str] = None


def _pct(vals: List[float], q: float) -> Optional[float]:
    return (round(float(np.percentile(np.asarray(vals), q)), 5)
            if vals else None)


def slo_report(outcomes: List[Outcome], *,
               slo_ttft_s: Optional[float] = None,
               replica_seconds: Optional[float] = None,
               wall_s: Optional[float] = None) -> Dict[str, Any]:
    """Fold outcomes into the one-line SLO surface: counts by status,
    shed rate (rejected + shed over offered), TTFT/latency tails, SLO
    attainment (fraction of OFFERED requests answered with TTFT inside
    ``slo_ttft_s`` — a shed request is an SLO miss, not a statistics
    dropout), and replica-seconds when the cost probe ran."""
    n = len(outcomes)
    by: Dict[str, int] = {}
    for o in outcomes:
        by[o.status] = by.get(o.status, 0) + 1
    done = by.get("done", 0)
    shed = by.get("shed", 0) + by.get("rejected", 0)
    ttfts = [o.ttft_s for o in outcomes
             if o.status == "done" and o.ttft_s is not None]
    lats = [o.latency_s for o in outcomes
            if o.status == "done" and o.latency_s is not None]
    rep: Dict[str, Any] = {
        "requests": n,
        "done": done,
        "rejected": by.get("rejected", 0),
        "shed": by.get("shed", 0),
        "failed": by.get("failed", 0),
        "disconnected": by.get("disconnected", 0),
        "shed_rate": round(shed / n, 4) if n else None,
        "tokens_out": sum(o.tokens for o in outcomes),
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p95_s": _pct(ttfts, 95),
        "ttft_p99_s": _pct(ttfts, 99),
        "latency_p99_s": _pct(lats, 99),
        "failovers": sum(o.failovers for o in outcomes),
    }
    if wall_s is not None:
        rep["wall_s"] = round(wall_s, 3)
        if wall_s > 0:
            rep["tokens_per_s"] = round(rep["tokens_out"] / wall_s, 2)
    if slo_ttft_s is not None:
        ok = sum(1 for o in outcomes
                 if o.status == "done" and o.ttft_s is not None
                 and o.ttft_s <= slo_ttft_s)
        rep["slo_ttft_s"] = slo_ttft_s
        rep["slo_attainment"] = round(ok / n, 4) if n else None
    if replica_seconds is not None:
        rep["replica_seconds"] = round(replica_seconds, 3)
    return rep


# -- clients ---------------------------------------------------------------


class RouterClient:
    """Drive an in-process fleet object (``Router`` or
    ``ProcessRouter``) — the test/bench arm. ``stream=True`` consumes
    the streaming surface (chunk iterator); otherwise ``result``."""

    def __init__(self, router: Any, vocab_size: int,
                 stream: bool = False, timeout_s: float = 300.0):
        self.router = router
        self.vocab_size = int(vocab_size)
        self.stream = bool(stream)
        self.timeout_s = float(timeout_s)

    def __call__(self, ev: RequestEvent, t0: float) -> Outcome:
        from ..serve.engine import SamplingParams
        from ..serve.router import NoHealthyReplicaError
        from ..serve.scheduler import (AdmissionRejectedError,
                                       DeadlineExceededError,
                                       QueueFullError,
                                       RequestCancelledError)
        prompt = prompt_tokens(ev, self.vocab_size)
        sp = SamplingParams(max_new_tokens=ev.max_new, temperature=0.9,
                            top_k=16, seed=ev.seed)
        out = Outcome(index=ev.seed, arrival_s=ev.arrival_s,
                      t_submit=time.perf_counter() - t0, status="failed",
                      max_new=ev.max_new, deadline_s=ev.deadline_s)
        kw = ({"stream": self.stream}
              if getattr(self.router, "kind", "") == "process" else {})
        try:
            req = self.router.submit(prompt, sp, timeout=self.timeout_s,
                                     deadline_s=ev.deadline_s, **kw)
        except (AdmissionRejectedError, QueueFullError) as e:
            out.status, out.error = "rejected", type(e).__name__
            return out
        except (NoHealthyReplicaError, RuntimeError, ValueError) as e:
            out.error = f"{type(e).__name__}: {e}"[:200]
            return out
        try:
            if self.stream:
                got = 0
                for chunk in req.stream(timeout=self.timeout_s):
                    got += len(chunk)
                out.tokens = got
            else:
                out.tokens = len(req.result(timeout=self.timeout_s))
            out.status = "done"
        except DeadlineExceededError as e:
            out.status, out.error = "shed", str(e)[:200]
        except RequestCancelledError as e:
            out.status, out.error = "disconnected", str(e)[:200]
        except (RuntimeError, OSError, TimeoutError) as e:
            out.error = f"{type(e).__name__}: {e}"[:200]
        out.ttft_s = req.ttft_s
        if req.done_t is not None:
            out.latency_s = req.done_t - req.submit_t
        out.replica = getattr(req, "replica_id", None)
        out.failovers = getattr(req, "failovers", 0)
        return out


class HttpClient:
    """Drive a live ``python -m gym_tpu_torch.serve`` endpoint — the CI /
    production arm. Streamed requests consume chunked SSE and take
    TTFT from the terminal summary event (the engine-side number;
    client-side TTFB would fold in local thread-scheduling noise)."""

    def __init__(self, url: str, vocab_size: int, stream: bool = False,
                 timeout_s: float = 300.0):
        self.url = url.rstrip("/")
        self.vocab_size = int(vocab_size)
        self.stream = bool(stream)
        self.timeout_s = float(timeout_s)

    def __call__(self, ev: RequestEvent, t0: float) -> Outcome:
        import urllib.error
        import urllib.request
        prompt = prompt_tokens(ev, self.vocab_size)
        body: Dict[str, Any] = {
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": ev.max_new, "temperature": 0.9,
            "top_k": 16, "seed": ev.seed}
        if ev.deadline_s is not None:
            body["deadline_s"] = ev.deadline_s
        if self.stream:
            body["stream"] = True
        out = Outcome(index=ev.seed, arrival_s=ev.arrival_s,
                      t_submit=time.perf_counter() - t0, status="failed",
                      max_new=ev.max_new, deadline_s=ev.deadline_s)
        req = urllib.request.Request(
            self.url + "/generate", json.dumps(body).encode(),
            {"Content-Type": "application/json"})
        t_req = time.perf_counter()
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as r:
                if self.stream:
                    toks = 0
                    fin: Dict[str, Any] = {}
                    for line in r:
                        if not line.strip().startswith(b"data: "):
                            continue
                        evt = json.loads(line[6:])
                        if evt.get("error"):
                            out.error = (f"{evt.get('error_type')}: "
                                         f"{evt['error']}"[:200])
                            if evt.get("error_type") == \
                                    "DeadlineExceededError":
                                out.status = "shed"
                            return out
                        toks += len(evt.get("tokens", []))
                        if evt.get("done"):
                            fin = evt
                    out.tokens = fin.get("tokens_total", toks)
                    out.ttft_s = fin.get("ttft_s")
                    out.latency_s = fin.get("latency_s")
                    out.replica = fin.get("replica")
                    out.failovers = fin.get("failovers", 0)
                else:
                    payload = json.loads(r.read())
                    out.tokens = len(payload.get("tokens", []))
                    out.ttft_s = payload.get("ttft_s")
                    out.latency_s = payload.get("latency_s")
                    out.replica = payload.get("replica")
                    out.failovers = payload.get("failovers", 0)
                out.status = "done"
        except urllib.error.HTTPError as e:
            code = e.code
            out.status = ("rejected" if code == 429
                          else "shed" if code == 504 else "failed")
            out.error = f"http_{code}"
            out.latency_s = time.perf_counter() - t_req
        except OSError as e:
            out.error = f"{type(e).__name__}: {e}"[:200]
        return out


# -- the open-loop engine --------------------------------------------------


class ReplicaSecondsProbe:
    """Integrate the live replica count (healthy + starting — you pay
    for a spawning process) over the replay window: the COST axis of
    the cost-vs-SLO frontier, measured the same way the cost model
    computes it."""

    def __init__(self, count_fn: Callable[[], float],
                 poll_s: float = 0.25):
        self._count = count_fn
        self.poll_s = float(poll_s)
        self.total = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gym-tpu-replica-seconds")

    def _loop(self) -> None:
        last = time.perf_counter()
        while True:
            stopped = self._stop.wait(self.poll_s)
            now = time.perf_counter()
            try:
                # the final partial interval counts too — stop() mid-
                # poll must not shave up to poll_s × N off the bill
                self.total += self._count() * (now - last)
            except Exception:  # noqa: BLE001 — probe must not die
                pass
            last = now
            if stopped:
                return

    def start(self) -> "ReplicaSecondsProbe":
        self._thread.start()
        return self

    def stop(self) -> float:
        self._stop.set()
        self._thread.join(timeout=5.0)
        return self.total


def router_replica_count(router: Any) -> float:
    """Live replica count for the probe, across both fleet kinds."""
    if hasattr(router, "autoscale_snapshot"):
        snap = router.autoscale_snapshot()
        return float(snap.get("healthy", 0) + snap.get("starting", 0))
    return float(sum(1 for r in router.replicas if not r.dead))


def replay(events: List[RequestEvent],
           client: Callable[[RequestEvent, float], Outcome], *,
           time_scale: float = 1.0,
           join_timeout_s: float = 600.0) -> List[Outcome]:
    """Fire ``events`` open-loop: each request launches on its own
    thread at ``arrival_s / time_scale`` after t0, regardless of what
    earlier requests are doing (no coordinated omission). Returns
    outcomes in trace order."""
    if time_scale <= 0:
        raise ValueError(f"time_scale must be > 0, got {time_scale}")
    events = sorted(events, key=lambda e: e.arrival_s)
    results: List[Optional[Outcome]] = [None] * len(events)
    threads: List[threading.Thread] = []
    t0 = time.perf_counter()

    def fire(i: int, ev: RequestEvent) -> None:
        results[i] = client(ev, t0)

    for i, ev in enumerate(events):
        delay = ev.arrival_s / time_scale - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=fire, args=(i, ev), daemon=True,
                              name=f"gym-tpu-replay-{i}")
        th.start()
        threads.append(th)
    deadline = time.perf_counter() + join_timeout_s
    for th in threads:
        th.join(timeout=max(0.1, deadline - time.perf_counter()))
    for i, (r, ev) in enumerate(zip(results, events)):
        if r is None:     # client thread still wedged past the join
            results[i] = Outcome(
                index=ev.seed, arrival_s=ev.arrival_s, t_submit=-1.0,
                status="failed", max_new=ev.max_new,
                deadline_s=ev.deadline_s, error="replay_join_timeout")
    return [r for r in results if r is not None]


def replay_router(router: Any, events: List[RequestEvent], *,
                  vocab_size: int, time_scale: float = 1.0,
                  stream: bool = False,
                  slo_ttft_s: Optional[float] = None,
                  request_timeout_s: float = 300.0
                  ) -> Dict[str, Any]:
    """One-call live arm: open-loop replay against an in-process fleet
    with the replica-seconds probe running. Returns ``{"report",
    "outcomes"}``."""
    probe = ReplicaSecondsProbe(
        lambda: router_replica_count(router)).start()
    t0 = time.perf_counter()
    outs = replay(events,
                  RouterClient(router, vocab_size, stream=stream,
                               timeout_s=request_timeout_s),
                  time_scale=time_scale)
    wall = time.perf_counter() - t0
    rs = probe.stop()
    return {"report": slo_report(outs, slo_ttft_s=slo_ttft_s,
                                 replica_seconds=rs, wall_s=wall),
            "outcomes": outs}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Open-loop trace replay against a live gym_tpu_torch "
                    "server: fire each request at its trace timestamp "
                    "(non-coordinated-omission), report SLO attainment")
    p.add_argument("--trace", required=True, metavar="TRACE_CSV")
    p.add_argument("--url", required=True,
                   help="server base url, e.g. http://127.0.0.1:8000")
    p.add_argument("--vocab", type=int, default=48,
                   help="model vocab size (prompt materialization)")
    p.add_argument("--time-scale", type=float, default=1.0,
                   help="replay N× faster than the trace clock")
    p.add_argument("--stream", action="store_true",
                   help="streamed (SSE) requests")
    p.add_argument("--slo-ttft", type=float, default=None)
    p.add_argument("--request-timeout", type=float, default=300.0)
    p.add_argument("--out", default=None,
                   help="write per-request outcomes JSON here")
    p.add_argument("--assert-all-done", action="store_true",
                   help="exit 1 unless every request completed "
                        "(the closed-loop drill's zero-dropped gate)")
    args = p.parse_args(argv)

    events = load_trace(args.trace)
    client = HttpClient(args.url, args.vocab, stream=args.stream,
                        timeout_s=args.request_timeout)
    t0 = time.perf_counter()
    outs = replay(events, client, time_scale=args.time_scale)
    wall = time.perf_counter() - t0
    report = slo_report(outs, slo_ttft_s=args.slo_ttft, wall_s=wall)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([dataclasses.asdict(o) for o in outs], f,
                      indent=2)
    print(json.dumps({"replay": report}))
    if args.assert_all_done and report["done"] != report["requests"]:
        bad = [dataclasses.asdict(o) for o in outs
               if o.status != "done"][:5]
        print(json.dumps({"dropped": report["requests"]
                          - report["done"], "first_failures": bad}))
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
