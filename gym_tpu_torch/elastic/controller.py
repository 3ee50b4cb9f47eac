"""Close the loop: the serving fleet's ``AutoscaleController`` drives the
TRAINING node set (a copy of ``gym_tpu/elastic/controller.py`` over the
port's copy of ``serve/autoscale.py``; ``tests/test_torch_elastic.py`` pins
the copy to its original).

The controller is reused as-is — same watermarks, hysteresis, cooldown
and audit-trail reasons that scale the serving fleet — with the training
signals mapped onto its inputs: "backlog" is the remaining work priced
in tokens (steps left × tokens per step), "rate" is the measured
training throughput. ``ElasticTrainController.tick`` turns a ±1/0
decision into a bounded target node count; ``elastic_fit`` runs training
in segments and resumes elastically (``fit(resume="auto",
num_nodes=K')``) whenever the controller moves the membership — every
membership change goes through the checkpoint + reshard path, exactly
like a real preemption/join would.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from ..serve.autoscale import AutoscaleController, AutoscalePolicy


class ElasticTrainController:
    """``AutoscaleController`` wrapped for training membership: ticks
    map (nodes, backlog-in-tokens, tokens/s) to a target node count in
    ``[min_replicas, max_replicas]``."""

    def __init__(self, k_min: int = 1, k_max: int = 4,
                 policy: Optional[AutoscalePolicy] = None):
        self.policy = policy or AutoscalePolicy(
            min_replicas=k_min, max_replicas=k_max)
        self.controller = AutoscaleController(self.policy)

    @property
    def last_reason(self) -> str:
        return self.controller.last_reason

    @property
    def decisions(self) -> int:
        return self.controller.decisions

    def tick(self, *, num_nodes: int, backlog_tokens: float,
             tokens_per_s: Optional[float]) -> int:
        """One control interval: returns the TARGET node count (the
        current one when the controller holds)."""
        d = self.controller.tick(
            healthy=int(num_nodes), starting=0,
            backlog_tokens=float(backlog_tokens),
            tokens_per_s=tokens_per_s)
        p = self.policy
        return max(p.min_replicas, min(p.max_replicas, int(num_nodes) + d))


def elastic_fit(trainer: Any, *, controller: ElasticTrainController,
                num_nodes: int, max_steps: int, segment_steps: int,
                tokens_per_step: float,
                **fit_kwargs) -> Tuple[List[Dict[str, Any]], Any]:
    """Train to ``max_steps`` in controller-paced segments.

    Each segment is a real ``trainer.fit(..., resume="auto",
    num_nodes=k)`` — the end-of-segment checkpoint is the durable state
    the next segment resumes from, so a membership move between segments
    exercises the full elastic reshard path. Returns ``(history,
    last_fit_result)`` where history records each segment's node count,
    the controller's target and its reason string.

    ``fit_kwargs`` must include ``save_dir`` (segments communicate
    through the checkpoint) and must NOT pin ``resume``/``num_nodes``/
    ``max_steps`` — those belong to the loop.
    """
    if "save_dir" not in fit_kwargs:
        raise ValueError("elastic_fit needs save_dir: segments resume "
                         "from the checkpoint")
    history: List[Dict[str, Any]] = []
    k = int(num_nodes)
    step, res = 0, None
    while step < max_steps:
        seg_end = min(step + int(segment_steps), max_steps)
        t0 = time.monotonic()
        res = trainer.fit(num_nodes=k, max_steps=seg_end, resume="auto",
                          **fit_kwargs)
        dt = max(time.monotonic() - t0, 1e-9)
        done = res.steps - step
        step = res.steps
        rate = (done * tokens_per_step) / dt
        backlog = (max_steps - step) * tokens_per_step
        k_new = controller.tick(num_nodes=k, backlog_tokens=backlog,
                                tokens_per_s=rate)
        history.append({"step": step, "nodes": k, "target": k_new,
                        "reason": controller.last_reason})
        if getattr(res, "preempted", False):
            break
        k = k_new
    return history, res
