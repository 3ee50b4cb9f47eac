"""gym_tpu_torch.serve — continuous-batching inference over the port's
KV-cache decode path (counterpart of ``gym_tpu.serve``).

- ``engine``: a fixed-capacity slot batch with per-slot KV caches or a
  shared page pool (prefix sharing, copy-on-write), one decode program a
  chunk shared by every request, bucketed prefill, speculative decoding and
  park/resume, on the port's kernels (B7, R1, L1, T1's bits rows).
- ``scheduler``: the JAX package's request layer, copied: FCFS queue with
  backpressure, deadlines, admission control, prefix-aware ordering and
  preemption.
- ``programs``: the engine's device programs as plain PyTorch callables.
- ``load``: a fit's run dir → node-averaged params and its ``GPTConfig``
  (``load_for_serving``), and the checkpoint-dir watcher.

The fleet and HTTP tier (metrics, supervisor, router, worker, wire,
autoscale, ``__main__``) and quantized serving belong to later slices of
the port.
"""

from .engine import (BlockAllocator, EngineStats, InferenceEngine,
                     NoFreeBlocksError, NoFreeSlotError, ParkedSlot,
                     SamplingParams, TokenEvent, max_prefill_buckets,
                     prompt_bucket)
from .load import (CheckpointWatcher, gpt_config_from_run,
                   latest_checkpoint_step, load_for_serving, read_run_config)
from .scheduler import (AdmissionRejectedError, DeadlineExceededError,
                        EngineFailedError, QueueFullError, Request,
                        RequestCancelledError, RequestStatus, Scheduler,
                        SchedulerClosedError, SlotQuarantinedError)

__all__ = [
    "InferenceEngine", "SamplingParams", "EngineStats", "TokenEvent",
    "ParkedSlot", "BlockAllocator", "NoFreeBlocksError", "NoFreeSlotError",
    "prompt_bucket", "max_prefill_buckets",
    "Scheduler", "Request", "RequestStatus", "QueueFullError",
    "SchedulerClosedError", "DeadlineExceededError",
    "AdmissionRejectedError", "EngineFailedError",
    "SlotQuarantinedError", "RequestCancelledError",
    "load_for_serving", "read_run_config", "gpt_config_from_run",
    "latest_checkpoint_step", "CheckpointWatcher",
]
