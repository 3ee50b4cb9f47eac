"""gym_tpu_torch.serve — continuous-batching inference over the port's
KV-cache decode path (counterpart of ``gym_tpu.serve``).

- ``engine``: a fixed-capacity slot batch with per-slot KV caches or a
  shared page pool (prefix sharing, copy-on-write), one decode program a
  chunk shared by every request, bucketed prefill, speculative decoding and
  park/resume, on the port's kernels (B7, R1, L1, T1's bits rows; B6 and
  B7's int8 form under quantized weights and KV); each
  program staged through one pinned buffer and, on the card, a CUDA graph
  owned by the program registry (``gym_tpu_torch.programs``).
- ``scheduler``: the JAX package's request layer, copied: FCFS queue with
  backpressure, deadlines, admission control, prefix-aware ordering and
  preemption.
- ``programs``: the engine's device programs as plain PyTorch functions.
- ``load``: a fit's run dir → node-averaged params and its ``GPTConfig``
  (``load_for_serving``), quantize-at-load (``quantize_params``), and the
  checkpoint-dir watcher.
- ``supervisor``: the driver loop under a watchdog, rebuilding a failed or
  wedged engine.
- ``router``: N in-process replicas behind one health-aware router
  (least-loaded, prefix-affine dispatch, failover, rolling hot swap).
- ``metrics``: ``serve.csv`` and the headline (the JAX module's columns).
- ``wire``: the length-prefixed frame codec (a copy of the JAX module's).
- ``__main__``: ``python -m gym_tpu_torch.serve --ckpt RUN_DIR``, the HTTP
  server.

The out-of-process fleet (worker processes, the process router, the
autoscaler) is ROADMAP item 15.
"""

from .engine import (BlockAllocator, EngineStats, InferenceEngine,
                     NoFreeBlocksError, NoFreeSlotError, ParkedSlot,
                     SamplingParams, TokenEvent, max_prefill_buckets,
                     prompt_bucket)
from .load import (CheckpointWatcher, gpt_config_from_run,
                   latest_checkpoint_step, load_for_serving,
                   params_are_quantized, quantize_params, read_run_config)
from .metrics import ServeMetrics, read_headline
from .router import (FleetReloadError, FleetRequest, NoHealthyReplicaError,
                     Replica, Router, build_fleet)
from .scheduler import (AdmissionRejectedError, DeadlineExceededError,
                        EngineFailedError, QueueFullError, Request,
                        RequestCancelledError, RequestStatus, Scheduler,
                        SchedulerClosedError, SlotQuarantinedError)
from .supervisor import Supervisor

__all__ = [
    "InferenceEngine", "SamplingParams", "EngineStats", "TokenEvent",
    "ParkedSlot", "BlockAllocator", "NoFreeBlocksError", "NoFreeSlotError",
    "prompt_bucket", "max_prefill_buckets",
    "Scheduler", "Request", "RequestStatus", "QueueFullError",
    "SchedulerClosedError", "DeadlineExceededError",
    "AdmissionRejectedError", "EngineFailedError",
    "SlotQuarantinedError", "RequestCancelledError",
    "load_for_serving", "read_run_config", "gpt_config_from_run",
    "latest_checkpoint_step", "CheckpointWatcher", "quantize_params",
    "params_are_quantized",
    "ServeMetrics", "read_headline", "Supervisor", "Router", "Replica",
    "FleetRequest", "build_fleet", "NoHealthyReplicaError",
    "FleetReloadError",
]
