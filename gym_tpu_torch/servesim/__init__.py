"""gym_tpu_torch.servesim — trace-driven serving simulation (a copy of
``gym_tpu/servesim``, which imports no JAX; ``drill`` is ported, since it
trains and serves): the serving twin of ``gym_tpu/sim``.

``gym_tpu/sim`` prices TRAINING strategies on modeled networks; this
package prices SERVING policies (autoscaling watermarks, admission
control, replica bounds) against SLO attainment under realistic
traffic, with two arms that share one trace format and one report
schema:

- ``traces``     — seeded synthetic workload generators (diurnal
  sinusoid, bursty MMPP, flash-crowd step, replay-from-``serve.csv``)
  emitting ``RequestEvent`` streams with a stable on-disk CSV format.
- ``replay``     — the open-loop (non-coordinated-omission) replayer:
  fire a trace at true timestamps against the real fleet (in-process
  or HTTP, streamed or not) and fold outcomes into an SLO report plus
  replica-seconds (the cost axis).
- ``cost_model`` — the analytic twin: a discrete-event queueing model
  over measured per-replica tokens/s with the ACTUAL
  ``AutoscaleController.tick`` and admission pricing applied to the
  modeled backlog — a policy point evaluates in milliseconds.
- ``sweep``      — the resumable grid runner (policy watermarks ×
  replica bounds × trace family) on the cost-model fast path, emitting
  the cost-vs-SLO ``frontier.csv`` + ``report.md`` through the same
  crash-safe cell machinery as ``sim/sweep.py`` (``sim/gridlib``).
- ``frontier_gate`` — the deterministic regression gate over the
  committed frontier (as ``sim/frontier_gate.py`` does for training).
- ``drill``      — the closed train→deploy loop: a live trainer
  streams checkpoints into a ``--reload-watch`` fleet WHILE a trace
  replays; gated on zero dropped requests, zero recompiles and
  post-swap streams byte-exact (``scripts/ci_deploy.sh``).
"""

from .cost_model import (CostModelResult, FleetCostModel,
                         ServiceProfile, calibrate_router)
from .replay import (HttpClient, Outcome, ReplicaSecondsProbe,
                     RouterClient, replay, replay_router, slo_report)
from .traces import (TRACE_FAMILIES, RequestEvent, bursty_trace,
                     diurnal_trace, flash_crowd_trace, load_trace,
                     make_trace, prompt_tokens, replay_from_serve_csv,
                     save_trace, trace_stats)

__all__ = [
    "RequestEvent", "TRACE_FAMILIES", "diurnal_trace", "bursty_trace",
    "flash_crowd_trace", "replay_from_serve_csv", "make_trace",
    "save_trace", "load_trace", "prompt_tokens", "trace_stats",
    "Outcome", "slo_report", "replay", "replay_router", "RouterClient",
    "HttpClient", "ReplicaSecondsProbe",
    "ServiceProfile", "FleetCostModel", "CostModelResult",
    "calibrate_router",
]
