"""Learning-rate scale schedules: the numpy half of
``gym_tpu/strategy/schedule.py``, copied so that the port never imports the
JAX package.

Reference semantics (``exogym/strategy/strategy.py:65-95``): an LR *lambda*
multiplying the optimizer's base lr — linear warmup over ``warmup_steps``,
then either constant 1.0 or cosine anneal to a 0.1 floor over ``max_steps``.
The scale is evaluated on the host in float32, from the explicit step
counter: at step 0 it is 0, so the first inner update is zero.
"""

from __future__ import annotations

import numpy as np


def warmup_cosine_scale(
    max_steps: int,
    warmup_steps: int = 1,
    cosine_anneal: bool = False,
    min_lr_factor: float = 0.1,
    xp=np,
):
    """Return ``scale(step) -> multiplier in [0, 1]``: warmup factor
    ``step / max(warmup_steps, 1)``, then 1.0 or the cosine term decaying to
    ``min_lr_factor``."""
    warmup_steps = int(warmup_steps)
    max_steps = int(max_steps)

    def scale(step):
        step = xp.asarray(step, xp.float32)
        warm = step / xp.maximum(warmup_steps, 1)
        if cosine_anneal:
            progress = (step - warmup_steps) / max(
                1, max_steps - warmup_steps
            )
            progress = xp.clip(progress, 0.0, 1.0)
            cosine = 0.5 * (1.0 + xp.cos(xp.pi * progress))
            post = (1 - min_lr_factor) * cosine + min_lr_factor
        else:
            post = xp.asarray(1.0, xp.float32)
        return xp.where(step < warmup_steps, warm, post)

    return scale


def build_lr_scale(lr_scheduler, lr_scheduler_kwargs, max_steps: int, xp=np):
    """Resolve the strategy's scheduler config into a scale fn (or None):
    ``'lambda_cosine'`` with kwargs ``warmup_steps``, ``cosine_anneal`` and
    an optional ``max_steps`` cap."""
    if lr_scheduler is None:
        return None
    if lr_scheduler != "lambda_cosine":
        raise ValueError(
            f"Unknown lr_scheduler {lr_scheduler!r}; expected 'lambda_cosine'"
        )
    kw = dict(lr_scheduler_kwargs or {})
    capped = min(int(kw.get("max_steps", max_steps)), int(max_steps))
    return warmup_cosine_scale(
        max_steps=capped,
        warmup_steps=int(kw.get("warmup_steps", 1)),
        cosine_anneal=bool(kw.get("cosine_anneal", False)),
        xp=xp,
    )
