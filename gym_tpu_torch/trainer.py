"""Trainer: the user-facing orchestration layer (counterpart of
``gym_tpu/trainer.py``, the core of ``Trainer.fit``).

``Trainer(model, train_dataset, val_dataset).fit(strategy=..., num_nodes=K)``
trains K simulated data-parallel nodes on one card: every parameter and
optimizer tensor carries the node dimension first, the model returns the K
per-node losses, and the strategy's collectives are reductions over that
dimension. The loop keeps the JAX trainer's observable behaviour: the same
batches from the same seed, the same eval cadence (local eval of node 0,
global eval of the node-mean params, in f32 whatever ``autocast`` says),
the same ``train.csv``/``validation.csv`` rows, and the loss of a step read
back one step late so the host never waits on the card in between.

The fit kwargs of later slices (checkpointing, guard, network simulation,
cp/tp/ep/pp, ...) keep their names and raise when set.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .data.sampler import NodeBatchIterator, resolve_node_datasets
from .models.base import LossModel, as_loss_model
from .parallel.mesh import NodeRuntime
from .strategy.base import Strategy, tree_num_params
from .train_node import (default_device, make_eval_step, make_init_fn,
                         make_multi_train_step, make_train_step)
from .utils.logger import CSVLogger


@dataclasses.dataclass
class FitResult:
    """What ``fit`` returns: node-averaged weights (host numpy, by parameter
    name) and non-parameter state (``{collection: {name: array}}``, e.g.
    BatchNorm's running stats), plus the final per-node state on the
    device."""

    params: Dict[str, np.ndarray]
    model_state: Any
    node_state: Any
    steps: int
    steps_per_second: float
    final_train_loss: float
    history: Dict[str, List]
    steps_per_second_steady: Optional[float] = None


def _model_config(module) -> Dict[str, Any]:
    cfg = getattr(module, "config", None)
    if not dataclasses.is_dataclass(cfg):
        return {}
    return {"config": {f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(cfg)
                       if isinstance(getattr(cfg, f.name),
                                     (int, float, str, bool, type(None)))}}


def _due(interval, step_idx: int, s: int) -> bool:
    """Does a per-``interval`` firing fall inside the next ``s``-step call
    starting at ``step_idx``?"""
    return bool(interval) and (
        step_idx % interval == 0
        or (s > 1 and (step_idx % interval) + s > interval)
    )


def dispatch_schedule(start_step: int, max_steps: int, steps_per_call: int,
                      has_multi: bool) -> List[int]:
    """Steps taken by each call of the fit loop, in order: full calls run
    ``steps_per_call`` steps, any remainder single steps."""
    sched = []
    i = start_step
    while i < max_steps:
        s = min(steps_per_call, max_steps - i)
        if s < steps_per_call or not has_multi:
            s = 1
        sched.append(s)
        i += s
    return sched


# fit kwargs of later slices: name -> value that means "off"
_LATER = {
    "devices": None, "cp": 1, "tp": 1, "ep": 1, "pp": 1,
    "correlation_interval": None, "compilation_cache_dir": None,
    "profile_dir": None, "checkpoint_interval": None, "save_dir": None,
    "watchdog_timeout": None, "network": None, "network_overlap": False,
    "wandb_project": None, "guard": None,
}


class Trainer:
    def __init__(self, model, train_dataset, val_dataset=None, **kwargs):
        self.model = model
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.kwargs = kwargs

    def fit(
        self,
        num_epochs: int = 1,
        strategy: Strategy = None,
        num_nodes: int = 1,
        max_steps: Optional[int] = None,
        device: Optional[str] = None,
        devices: Optional[List[int]] = None,
        batch_size: int = 16,
        minibatch_size: Optional[int] = None,
        shuffle: bool = True,
        val_size: int = 64,
        val_interval: int = 100,
        autocast: bool = False,
        cp: int = 1,
        tp: int = 1,
        ep: int = 1,
        pp: int = 1,
        skip_nonfinite: bool = False,
        correlation_interval: Optional[int] = None,
        steps_per_call: int = 1,
        prefetch: bool = True,
        async_checkpoint: bool = True,
        compilation_cache_dir: Optional[str] = None,
        profile_dir: Optional[str] = None,
        checkpoint_interval: Optional[int] = None,
        save_dir: Optional[str] = None,
        resume: Union[str, bool, int] = "auto",
        watchdog_timeout: Optional[float] = None,
        network: Optional[Any] = None,
        network_overlap: bool = False,
        init_params: Optional[Any] = None,
        seed: int = 42,
        wandb_project: Optional[str] = None,
        run_name: Optional[str] = None,
        log_dir: str = "logs",
        show_progress: bool = True,
        guard: Optional[Any] = None,
        **extra,
    ) -> FitResult:
        """Train K = ``num_nodes`` simulated nodes; see the module docstring.
        ``device`` defaults to the card and raises where there is none;
        ``prefetch`` and ``async_checkpoint`` are accepted for signature
        parity (the loop assembles batches synchronously, with identical
        contents)."""
        if strategy is None:
            raise ValueError("fit requires a strategy")
        if extra:
            raise TypeError(f"Unknown fit() kwargs: {sorted(extra)}")
        given = dict(locals())
        for name, off in _LATER.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"fit({name}=...) is ported in a later slice of "
                    f"gym_tpu_torch")
        if resume not in ("auto", "never", True, False):
            raise NotImplementedError(
                "fit(resume=<step>) needs checkpointing, which is ported in "
                "a later slice of gym_tpu_torch")
        dev = default_device(device)
        minibatch_size = minibatch_size or batch_size
        if batch_size % minibatch_size != 0:
            raise ValueError(
                f"batch_size {batch_size} must be a multiple of "
                f"minibatch_size {minibatch_size}")
        n_micro = batch_size // minibatch_size

        loss_model = as_loss_model(self.model)
        if autocast and loss_model.compute_dtype is None:
            loss_model = LossModel(loss_model.module, torch.bfloat16)
        runtime = NodeRuntime.create(num_nodes, dev)

        def feed(host_tree):
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in host_tree)

        train_dsets, train_sharded = resolve_node_datasets(
            self.train_dataset, num_nodes, is_val=False)
        train_iter = NodeBatchIterator(
            train_dsets, num_nodes, sharded=train_sharded, shuffle=shuffle,
            seed=seed)
        val_iter = None
        if self.val_dataset is not None and val_size > 0:
            val_dsets, val_sharded = resolve_node_datasets(
                self.val_dataset, num_nodes, is_val=True)
            val_iter = NodeBatchIterator(
                val_dsets, num_nodes, sharded=val_sharded, shuffle=False,
                seed=seed)

        # the JAX package takes one example microbatch from node 0's train
        # set for its shape-driven init (gym_tpu/trainer.py:450); a
        # stateful set (the crop augmentation's call counter) advances by
        # that take, so the port takes it too and draws the same batches
        train_dsets[0].take(np.zeros(minibatch_size, dtype=np.int64))

        steps_per_epoch = max(1, train_iter.samples_per_node() // batch_size)
        if max_steps is None:
            max_steps = num_epochs * steps_per_epoch
        strategy.finalize(max_steps)

        init_fn = make_init_fn(loss_model, strategy, seed,
                               init_params=init_params, device=dev,
                               ctx=runtime.ctx)
        state = runtime.init_state(init_fn)
        train_step = make_train_step(loss_model, strategy, runtime.ctx,
                                     skip_nonfinite)
        multi_step = (make_multi_train_step(loss_model, strategy, runtime.ctx,
                                            skip_nonfinite)
                      if steps_per_call > 1 else None)
        # eval in f32 regardless of autocast: a bf16 eval of a converged
        # model measures rounding noise
        eval_model = (LossModel(loss_model.module, None)
                      if loss_model.compute_dtype is not None else loss_model)
        eval_step = make_eval_step(eval_model, runtime.ctx)

        per_node_params = tree_num_params(state.params) // num_nodes
        config = {
            "num_nodes": num_nodes, "batch_size": batch_size,
            "minibatch_size": minibatch_size, "max_steps": max_steps,
            "num_epochs": num_epochs, "seed": seed, "autocast": autocast,
            "model": type(loss_model.module).__name__,
            "num_params": per_node_params,
            "model_config": _model_config(loss_model.module),
            "device": str(dev),
            **strategy.config(),
        }
        logger = CSVLogger(max_steps, run_name, log_dir, config,
                           show_progress)
        history: Dict[str, List] = {
            "train_loss": [], "local_loss": [], "global_loss": [],
            "comm_bytes": [], "comm_recv_bytes": [], "nonfinite": [],
        }
        pending_host: List = []

        def drain_host():
            while pending_host:
                pending_host.pop(0)()

        def run_eval(defer: bool = False):
            if val_iter is None:
                return
            n_val_micro = max(1, val_size // minibatch_size)
            vb = feed(val_iter.next_batch(n_val_micro, minibatch_size))
            local, glob = eval_step(state, vb)
            step_at = logger.step

            def fetch(local=local, glob=glob, step_at=step_at):
                # "local" is node 0's own replica, "global" the averaged
                # model on node 1's stream (train_node.py:191-244)
                lo = float(local[0])
                gl = float(glob[min(1, num_nodes - 1)])
                logger.log_loss(lo, "local", step=step_at)
                logger.log_loss(gl, "global", step=step_at)
                history["local_loss"].append((step_at, lo))
                history["global_loss"].append((step_at, gl))

            pending_host.append(fetch) if defer else fetch()

        last_loss = float("nan")

        def drain(p):
            nonlocal last_loss
            first_idx, m, count = p
            loss_a = m["loss"][0].reshape(count).cpu().numpy()
            # the node mean; a count of random masks is still on the device
            # and is read here, one step late, as the loss is
            comm_a = np.array([float(c) for c in m["comm_bytes"]],
                              np.float64)
            # bytes a node receives, where a strategy's link is asymmetric:
            # the node mean, kept beside comm_bytes (gym_tpu/trainer.py:963)
            recv_a = (m["comm_recv_bytes"].float().mean(dim=0).reshape(
                count).cpu().numpy() if "comm_recv_bytes" in m else None)
            nf_a = (m["nonfinite"].sum(dim=0).reshape(count).cpu().numpy()
                    if "nonfinite" in m else None)
            for j in range(count):
                step_j = first_idx + j
                loss = float(loss_a[j])
                comm = float(comm_a[j])
                last_loss = loss
                logger.log_train(loss, strategy.lr_at(step_j), comm,
                                 step=step_j)
                history["train_loss"].append((step_j, loss))
                history["comm_bytes"].append((step_j, comm))
                if recv_a is not None:
                    history["comm_recv_bytes"].append(
                        (step_j, float(recv_a[j])))
                if nf_a is not None and nf_a[j] > 0:
                    history["nonfinite"].append((step_j, float(nf_a[j])))
                    logger.log_event(f"quarantined {int(nf_a[j])} node(s) "
                                     f"with non-finite gradients")

        sched = dispatch_schedule(0, max_steps, steps_per_call,
                                  multi_step is not None)
        pending = None
        t_start = time.perf_counter()
        t_steady, steady_from = None, 0
        step_idx = 0
        try:
            for s in sched:
                if _due(val_interval, step_idx, s):
                    run_eval(defer=True)
                if s > 1:
                    stacked = [train_iter.next_batch(n_micro, minibatch_size)
                               for _ in range(s)]
                    batch = feed(tuple(np.stack(xs, axis=1)
                                       for xs in zip(*stacked)))
                    state, metrics = multi_step(state, batch)
                else:
                    batch = feed(train_iter.next_batch(n_micro,
                                                       minibatch_size))
                    state, metrics = train_step(state, batch)
                    metrics = {k: ([v] if k == "comm_bytes" else v[:, None])
                               for k, v in metrics.items()}
                if pending is not None:
                    # the previous call's loss; reading it waits for all the
                    # work queued on the device, this call's included, so
                    # the steady clock counts from the next call on
                    drain(pending)
                    if t_steady is None:
                        t_steady = time.perf_counter()
                        steady_from = step_idx + s
                drain_host()
                pending = (step_idx, metrics, s)
                for _ in range(s):
                    logger.increment_step()
                step_idx += s
            if pending is not None:
                drain(pending)
            drain_host()
        except BaseException:
            logger.close()
            raise
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_end = time.perf_counter()
        elapsed = t_end - t_start
        sps_steady = None
        if t_steady is not None and step_idx > steady_from \
                and t_end > t_steady:
            sps_steady = (step_idx - steady_from) / (t_end - t_steady)
        logger.log_summary({
            "steps_per_second": step_idx / elapsed if elapsed else 0.0,
            "steps_per_second_steady": sps_steady,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "cum_comm_bytes": logger.cum_comm_bytes,
            "final_train_loss": last_loss,
        })
        run_eval()
        logger.close()
        return FitResult(
            params=runtime.average_over_nodes(state.params),
            model_state=runtime.average_over_nodes(state.model_state),
            node_state=state,
            steps=step_idx,
            steps_per_second=step_idx / elapsed if elapsed > 0 else 0.0,
            final_train_loss=last_loss,
            history=history,
            steps_per_second_steady=sps_steady,
        )


LocalTrainer = Trainer
