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

Checkpoints, resume, preemption, the watchdog, the SDC guard with
rollback-and-replay and the batch prefetcher are the JAX trainer's
(``gym_tpu/trainer.py``): a fit checkpointed every ``checkpoint_interval``
steps into ``save_dir`` can be killed, preempted (SIGTERM/SIGINT take one
emergency checkpoint at the next dispatch boundary and return
``preempted=True``), corrupted and resumed (``resume="auto"``), and each
time its ``train.csv`` ends byte-identical to an uninterrupted run's.

Elastic membership is the JAX trainer's too: every checkpoint records its
(K, layout, n) in its meta, a strategy with ``shard_checkpoint`` (ZeRO-1)
writes the ZeRO-2 layout, and ``fit(resume=..., num_nodes=K')`` on a
checkpoint written at K peeks that record first, restores the step as
saved (host tensors: a restore in the live shapes would quarantine a valid
step) and reshards it onto K' nodes (``gym_tpu_torch.elastic``).

``network=`` prices the strategy's collective trace on a topology preset
(``gym_tpu_torch.sim``): a simulated step clock in every ``train.csv``
row, and ``FitResult.sim`` with the whole run re-priced at the final
steady compute rate.

The fit kwargs of later slices (cp/tp/ep/pp, ...) keep their names and
raise when set.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .data.prefetch import HostPrefetcher, dispatch_schedule
from .data.sampler import NodeBatchIterator, resolve_node_datasets
from .models.base import LossModel, as_loss_model
from .parallel.mesh import NodeRuntime
from .strategy.base import Strategy, tree_num_params
from .train_node import (TrainState, default_device, make_eval_step,
                         make_init_fn, make_multi_train_step, make_train_step)
from .utils.checkpoint import (STACKED_LAYOUT, CheckpointManager,
                               CheckpointNotFoundError, _like)
from .utils.integrity import (Guard, GuardRuntime, GuardTrippedError,
                              _InnerGuard, corrupt_state_tree,
                              tree_fingerprint)
from .utils.logger import CSVLogger, _jsonable
from .utils.resilience import (Watchdog, WatchdogTimeoutError, fault_point,
                               faults, watch_or_null)

# the dense bf16 peak of one H100 (SXM, NVIDIA's data sheet) that MFU is
# stated against; gym_tpu's default of 197e12 is a TPU's
H100_BF16_PEAK_FLOPS = 989e12


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
    # model-FLOPs utilization (GPT models) against H100_BF16_PEAK_FLOPS
    mfu: Optional[float] = None
    steps_per_second_steady: Optional[float] = None
    # True when SIGTERM/SIGINT cut the run short: an emergency checkpoint
    # was taken (when checkpointing is configured), `steps` reads the step
    # reached, and a later fit(resume="auto") continues from exactly there
    preempted: bool = False
    # fit(network=...): the whole run priced on the topology (sim_total_s,
    # sim_comm_s, sim_compute_s, trace_tx_bytes, ...); None without one
    sim: Optional[Dict[str, Any]] = None


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


# fit kwargs of later slices: name -> value that means "off"
_LATER = {
    "devices": None, "cp": 1, "tp": 1, "ep": 1, "pp": 1,
    "correlation_interval": None, "compilation_cache_dir": None,
    "profile_dir": None, "wandb_project": None,
}


def _state_tree(state: TrainState) -> Dict[str, Any]:
    """The checkpointed form of a ``TrainState``: a plain dict."""
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(TrainState)}


def _on_device(tree, dev):
    """``tree`` with its tensors moved to ``dev`` (the rest as it is)."""
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _on_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, dev) for v in tree)
    return tree


def _restore_elastic(restored, saved, live, num_nodes, from_canon, layout):
    """A step restored as saved (``saved``: its ``extra["elastic"]``) in
    the layout of ``live``, the fresh state tree of this fit: the ZeRO-2
    codec's decode at an unchanged membership, else the reshard (which
    also takes a stacked step at this K, one the newest-first walk fell
    back to); on the live state's device."""
    from .elastic import reshard_state
    saved = saved or {}
    dev = next(iter(live["params"].values())).device
    restored = _on_device(restored, dev)
    if (from_canon is not None
            and int(saved.get("num_nodes", num_nodes)) == num_nodes
            and saved.get("layout", STACKED_LAYOUT) == layout):
        tree = from_canon(restored)
    else:
        tree = reshard_state(restored, saved, live)
    return _like(tree, live)


class Trainer:
    def __init__(self, model, train_dataset, val_dataset=None, **kwargs):
        self.model = model
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.kwargs = kwargs

    @staticmethod
    def _guard_shutdown(ckpt, logger, wd) -> None:
        """Release run resources after a guard trip: the checkpoint
        writer (letting any in-flight PRE-corruption write complete —
        that is the state the replay resumes from), the log handles
        (the replay fit reopens them with resume truncation), and the
        watchdog. No save happens here: corrupt state must never be
        committed. Best-effort closes — the GuardTrippedError in flight
        is the error that matters."""
        if ckpt is not None:
            try:
                ckpt.close()
            except Exception:
                pass
        try:
            logger.log_event("training guard tripped: rolling back")
            logger.close()
        except Exception:
            pass
        if wd is not None:
            wd.close()

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
        ``device`` defaults to the card and raises where there is none.
        ``prefetch`` runs the batch prefetcher (``data/prefetch.py``);
        ``checkpoint_interval`` with ``save_dir`` checkpoints into
        ``<save_dir>/<run_name>`` (``async_checkpoint``: on the writer
        thread), ``resume`` is ``"auto"`` (the newest valid checkpoint),
        ``"never"``/``False`` (purge and start over) or a step;
        ``watchdog_timeout`` (or ``GYM_TPU_WATCHDOG_S``) deadline-protects
        the blocking regions; ``guard`` (a ``Guard``, ``GuardRuntime`` or
        True) runs the fit under the SDC guard with rollback-and-replay."""
        # captured BEFORE any parameter is normalized: the rollback-and-
        # replay wrapper below re-invokes fit with these exact arguments
        _fit_kwargs = {k: v for k, v in locals().items()
                       if k not in ("self", "extra", "guard")}
        # The SDC guard: this OUTER call owns the replay loop; the
        # recursive call carries an _InnerGuard marker so the inner fit
        # only observes (and the monitor state survives attempts). The
        # loop is bit-deterministic and CSVLogger resume truncates rows >=
        # the restored step, so a replayed train.csv is byte-identical to
        # an uninterrupted run.
        if guard is not None and guard is not False \
                and not isinstance(guard, _InnerGuard):
            if isinstance(guard, GuardRuntime):
                _rt = guard
            elif isinstance(guard, Guard):
                _rt = GuardRuntime(guard)
            elif guard is True:
                _rt = GuardRuntime()
            else:
                raise ValueError(
                    f"guard must be a Guard, GuardRuntime, or True; "
                    f"got {guard!r}")
            while True:
                try:
                    return self.fit(guard=_InnerGuard(_rt), **_fit_kwargs)
                except GuardTrippedError as e:
                    if _rt.rollbacks >= _rt.cfg.max_rollbacks:
                        raise
                    _rt.note_rollback()
                    sys.stderr.write(
                        f"gym_tpu_torch: {e} — rolling back to the last "
                        f"verified checkpoint and replaying (attempt "
                        f"{_rt.rollbacks}/{_rt.cfg.max_rollbacks})\n")
                    sys.stderr.flush()
                    # the replay resumes from the newest CHECKSUM-VERIFIED
                    # checkpoint; without checkpointing it replays from
                    # scratch
                    _fit_kwargs["resume"] = "auto"
        guard_rt: Optional[GuardRuntime] = (
            guard.runtime if isinstance(guard, _InnerGuard) else None)
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
        # int (and not bool) FIRST: resume=0 means "checkpoint step 0",
        # not the `0 == False` membership below
        resume_step_pin = (resume if isinstance(resume, int)
                           and not isinstance(resume, bool) else None)
        if resume_step_pin is None and resume not in ("auto", "never",
                                                      True, False):
            raise ValueError(
                f"resume must be 'auto', 'never'/False, or a checkpoint "
                f"step int; got {resume!r}")
        if resume_step_pin is not None and not (
                save_dir is not None and checkpoint_interval):
            # a pinned step with no checkpoint store would silently train
            # from scratch
            raise ValueError(
                f"resume={resume} requires save_dir and "
                f"checkpoint_interval to locate the checkpoint")
        if network is not None:
            # an unknown preset fails here, before anything is built
            from .sim import resolve_topology
            resolve_topology(network, num_nodes)
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

        # Watchdog: deadline-protects the host operations that can hang
        # (a dispatch drain, a prefetch get, a checkpoint write); off
        # unless asked for through the kwarg or GYM_TPU_WATCHDOG_S
        wd = None
        wd_timeout = watchdog_timeout
        if wd_timeout is None:
            env_wd = os.environ.get("GYM_TPU_WATCHDOG_S")
            wd_timeout = float(env_wd) if env_wd else None
        if wd_timeout:
            wd = Watchdog(wd_timeout).start()

        ckpt = None
        start_step = 0
        restored_extra: Dict[str, Any] = {}
        to_canon = None
        if save_dir is not None and checkpoint_interval:
            from .elastic import (ZERO2_LAYOUT, elastic_meta,
                                  make_zero2_codec, param_leaf_specs)
            # checkpointed runs pin the run name: the manager and the
            # logger must agree on it, or a resume would find the
            # checkpoint while the logger opens a fresh run dir
            run_name = run_name or "default"
            ckpt = CheckpointManager(save_dir, run_name,
                                     async_save=async_checkpoint, watchdog=wd)
            live = _state_tree(state)
            # every checkpoint records its membership (K, layout, n) so a
            # resume at K' routes through the reshard; ZeRO writes ZeRO-2
            # shards of O(model) bytes through the codec
            zero2 = bool(getattr(strategy, "shard_checkpoint", False))
            from_canon = None
            if zero2:
                to_canon, from_canon = make_zero2_codec(live, num_nodes)
            layout = elastic_meta(
                num_nodes, ZERO2_LAYOUT if zero2 else STACKED_LAYOUT,
                param_leaf_specs(state.params)[1])
            if resume_step_pin is None and resume in (False, "never"):
                if ckpt.latest_step() is not None:
                    ckpt.purge()
            else:
                want_step = resume_step_pin
                peek = (ckpt.peek_meta(step=want_step)
                        if ckpt.latest_step() is not None else None)
                saved = ((peek or {}).get("extra") or {}).get("elastic")
                # peeked BEFORE the restore: a restore in the live shapes
                # of a step saved at another K or layout would quarantine
                # a valid step; such a step is restored as saved (host
                # tensors in the saved shapes) and resharded after
                use_raw = zero2 or (saved is not None and (
                    int(saved["num_nodes"]) != num_nodes
                    or saved.get("layout") != layout["layout"]))
                try:
                    start_step, restored, data_state, restored_extra = \
                        ckpt.restore(None if use_raw else live,
                                     step=want_step)
                    if use_raw:
                        # the record of the step actually restored (the
                        # walk may have fallen back past a corrupt one)
                        saved = restored_extra.get("elastic") or saved
                        restored = _restore_elastic(
                            restored, saved, live, num_nodes, from_canon,
                            layout["layout"])
                        if int((saved or {}).get("num_nodes", num_nodes)) \
                                != num_nodes:
                            # per-node cursors mean nothing across a
                            # membership change: keep the epoch, restart
                            # the positions inside it
                            data_state = {
                                "epoch": int(data_state.get("epoch", 0)),
                                "pos": [0] * num_nodes}
                except CheckpointNotFoundError:
                    if want_step is not None:
                        ckpt.close()
                        if wd is not None:
                            wd.close()
                        raise
                    # fresh run: nothing (valid) to resume from
                except BaseException:
                    ckpt.close()
                    if wd is not None:
                        wd.close()
                    raise
                else:
                    state = TrainState(**restored)
                    train_iter.load_state(data_state)
                del live
            if async_checkpoint and dev.type == "cuda":
                # the pinned buffers saves copy into, pinned before the
                # loop: a second or so of page-locking, once
                tree = _state_tree(state)
                ckpt.reserve(to_canon(tree) if to_canon else tree)
                del tree

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

        # the network simulation: the strategy's collective trace priced on
        # a topology, host-side; the dispatch is untouched
        net_sim = None
        if network is not None:
            from .sim import make_simulator, node_template
            net_sim = make_simulator(
                network, strategy, node_template(state.params, stacked=True),
                num_nodes, overlap=network_overlap)

        per_node_params = tree_num_params(state.params) // num_nodes
        config = {
            "num_nodes": num_nodes, "batch_size": batch_size,
            "minibatch_size": minibatch_size, "max_steps": max_steps,
            "num_epochs": num_epochs, "seed": seed, "autocast": autocast,
            "model": type(loss_model.module).__name__,
            "num_params": per_node_params,
            "model_config": _model_config(loss_model.module),
            "device": str(dev),
            # namespaced: the topology's num_nodes is the network's size
            **({"network": dict(net_sim.topology.config(),
                                overlap=network_overlap)}
               if net_sim is not None else {}),
            **strategy.config(),
        }
        if ckpt is not None:
            # the run config NEXT TO the step dirs: serve.load's
            # params-only restore rebuilds the model from it
            with open(os.path.join(ckpt.directory, "config.json"), "w") as f:
                json.dump(_jsonable(config), f, indent=2, default=str)
        logger = CSVLogger(max_steps, run_name, log_dir, config,
                           show_progress, resume_step=start_step,
                           resume_cum_comm=restored_extra.get(
                               "cum_comm_bytes"),
                           sim=net_sim is not None)
        history: Dict[str, List] = {
            "train_loss": [], "local_loss": [], "global_loss": [],
            "comm_bytes": [], "comm_recv_bytes": [], "nonfinite": [],
            "sim_step_s": [],
        }
        # deferred host reads (evals, the guard's fingerprints): dispatched
        # at once, read after the next dispatch is queued
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
        logger.step = start_step
        if getattr(logger, "pbar", None) is not None and start_step:
            logger.pbar.update(start_step)

        def drain(p):
            nonlocal last_loss
            first_idx, m, count = p
            loss_all = m["loss"].float().cpu()
            loss_a = loss_all[0].reshape(count).numpy()
            # the worst loss over the nodes is the guard's trip channel
            # (max propagates NaN: one non-finite replica is seen too)
            worst_a = (loss_all.max(dim=0).values.reshape(count).numpy()
                       if guard_rt is not None else None)
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
            # the running compute estimate of the per-row simulated step
            # clock: the steady window once it exists (it excludes the
            # first call's builds), the whole run's rate before; the
            # summary re-prices every step at the final steady rate
            comp_est = None
            if net_sim is not None:
                now = time.perf_counter()
                retired = first_idx + count
                if t_steady is not None and retired > steady_from:
                    comp_est = (now - t_steady) / (retired - steady_from)
                else:
                    comp_est = ((now - t_start)
                                / max(1, retired - start_step))
            for j in range(count):
                step_j = first_idx + j
                loss = float(loss_a[j])
                comm = float(comm_a[j])
                # observe BEFORE the row is logged: a tripped step's
                # corrupt loss must never land in train.csv
                if guard_rt is not None:
                    guard_rt.observe_loss(step_j, loss,
                                          worst=float(worst_a[j]))
                last_loss = loss
                sim_j = (net_sim.step_time(step_j, comp_est)
                         if net_sim is not None else None)
                logger.log_train(loss, strategy.lr_at(step_j), comm,
                                 step=step_j, sim_step_s=sim_j)
                history["train_loss"].append((step_j, loss))
                history["comm_bytes"].append((step_j, comm))
                if sim_j is not None:
                    history["sim_step_s"].append((step_j, sim_j))
                if recv_a is not None:
                    history["comm_recv_bytes"].append(
                        (step_j, float(recv_a[j])))
                if nf_a is not None and nf_a[j] > 0:
                    history["nonfinite"].append((step_j, float(nf_a[j])))
                    logger.log_event(f"quarantined {int(nf_a[j])} node(s) "
                                     f"with non-finite gradients")

        first_retired = False
        t_steady, steady_from = None, start_step
        # the dispatch schedule is fixed by (start_step, max_steps,
        # steps_per_call): the prefetch worker walks it on its own
        sched = dispatch_schedule(start_step, max_steps, steps_per_call,
                                  multi_step is not None)
        prefetcher = None
        if prefetch and sched:
            prefetcher = HostPrefetcher(
                train_iter, dev, sched, n_micro=n_micro,
                micro_bs=minibatch_size).start()
        pending = None

        def save_checkpoint(at_step: int, sync: bool = False) -> None:
            nonlocal pending, first_retired, t_steady, steady_from
            # A checkpoint at step N must durably cover every logged row
            # with step < N: the rows of the dispatch ending at N are
            # normally drained one dispatch LATER, so drain them now (a
            # small host bubble at checkpoint boundaries), then fsync the
            # log streams.
            if pending is not None:
                with watch_or_null(wd, "dispatch.drain"):
                    drain(pending)
                pending = None
                if not first_retired:
                    first_retired = True
                    t_steady = time.perf_counter()
                    steady_from = at_step
            drain_host()
            # with prefetch the worker has drawn AHEAD of the consumed
            # position: consumed_state() is the synchronous loop's state
            data_state = (prefetcher.consumed_state()
                          if prefetcher is not None else train_iter.state())
            logger.sync()
            # the EXACT comm accumulator rides in the meta so a resume
            # continues it bit-exactly
            extra_meta = {"cum_comm_bytes": logger.cum_comm_bytes,
                          "elastic": layout}
            tree = _state_tree(state)
            if to_canon is not None:
                tree = to_canon(tree)
            if sync:
                # the preemption handler's emergency save: durable before
                # fit returns (ckpt.save waits out any async write first)
                ckpt.save(at_step, tree, data_state, extra_meta)
            else:
                ckpt.save_async(at_step, tree, data_state, extra_meta)

        # Preemption (SIGTERM from a scheduler, SIGINT from a keyboard):
        # the handler only RECORDS the signal; the loop notices at the next
        # dispatch boundary, takes one emergency synchronous checkpoint,
        # closes the writer and the prefetcher, and returns with
        # preempted=True. The handler re-installs the previous one on first
        # delivery, so a second signal takes the default path.
        preempt_signum: List[int] = []
        prev_handlers: Dict[int, Any] = {}

        def _request_preempt(signum, frame):
            preempt_signum.append(signum)
            try:
                signal.signal(signum,
                              prev_handlers.get(signum, signal.SIG_DFL))
            except (ValueError, OSError):
                pass

        if threading.current_thread() is threading.main_thread():
            for _sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev_handlers[_sig] = signal.signal(_sig,
                                                        _request_preempt)
                except (ValueError, OSError):
                    pass

        fp_due = (guard_rt.cfg.fingerprint_interval
                  if guard_rt is not None else 0)
        t_start = time.perf_counter()
        step_idx = start_step
        preempted = False
        try:
            for s in sched:
                fault_point("dispatch.boundary")
                if faults.active:
                    # the dispatch.state site: an armed bitflip flips
                    # exponent bits in the live state — the SDC the guard
                    # (not any crc) must catch
                    state = corrupt_state_tree(state)
                if _due(val_interval, step_idx, s):
                    run_eval(defer=True)
                if prefetcher is not None:
                    with watch_or_null(wd, "prefetch.get"):
                        batch = prefetcher.get()
                elif s > 1:
                    stacked = [train_iter.next_batch(n_micro, minibatch_size)
                               for _ in range(s)]
                    batch = feed(tuple(np.stack(xs, axis=1)
                                       for xs in zip(*stacked)))
                else:
                    batch = feed(train_iter.next_batch(n_micro,
                                                       minibatch_size))
                if s > 1:
                    state, metrics = multi_step(state, batch)
                else:
                    state, metrics = train_step(state, batch)
                    metrics = {k: ([v] if k == "comm_bytes" else v[:, None])
                               for k, v in metrics.items()}
                if pending is not None:
                    # the previous call's loss; reading it waits for all the
                    # work queued on the device, this call's included, so
                    # the steady clock counts from the next call on
                    with watch_or_null(wd, "dispatch.drain"):
                        drain(pending)
                    if not first_retired:
                        first_retired = True
                        t_steady = time.perf_counter()
                        steady_from = step_idx + s
                drain_host()
                pending = (step_idx, metrics, s)
                if fp_due and _due(fp_due, step_idx, s):
                    # the probe stays on the card; its read is deferred
                    # past the next dispatch, as the evals' are
                    fp_dev = tree_fingerprint(_state_tree(state))

                    def _check_fp(fp=fp_dev, st=step_idx + s):
                        guard_rt.observe_fingerprint(st, float(fp))

                    pending_host.append(_check_fp)
                for _ in range(s):
                    logger.increment_step()
                prev_idx, step_idx = step_idx, step_idx + s
                if ckpt is not None and (
                        step_idx // checkpoint_interval
                        > prev_idx // checkpoint_interval):
                    save_checkpoint(step_idx)
                if preempt_signum:
                    if wd is not None and wd.fired:
                        # the "signal" was the watchdog's interrupt_main
                        # through our SIGINT handler: a hang, not a
                        # preemption; abort loudly (stacks already dumped)
                        raise WatchdogTimeoutError(
                            f"watchdog timeout in '{wd.fired}' — aborting")
                    preempted = True
                    break
        except GuardTrippedError:
            # close everything WITHOUT saving: corrupt state must never be
            # committed (save_checkpoint drains the pending losses BEFORE
            # it saves, so a trip always aborts ahead of the write)
            self._guard_shutdown(ckpt, logger, wd)
            raise
        except BaseException:
            if ckpt is not None:
                try:
                    ckpt.close()
                except Exception:
                    pass
            logger.close()
            if wd is not None:
                wd.close()
            raise
        finally:
            if prefetcher is not None:
                prefetcher.close()
            for _sig, _h in prev_handlers.items():
                try:
                    signal.signal(_sig, _h)
                except (ValueError, OSError):
                    pass

        try:
            if pending is not None:
                with watch_or_null(wd, "dispatch.drain"):
                    drain(pending)
                pending = None
            drain_host()
        except GuardTrippedError:
            # the final drain can still observe a corrupt step
            self._guard_shutdown(ckpt, logger, wd)
            raise
        if preempted:
            sig_name = signal.Signals(preempt_signum[0]).name
            logger.log_event(
                f"preempted by {sig_name}: emergency checkpoint at step "
                f"{step_idx}, then clean shutdown")
            if ckpt is not None and step_idx > start_step:
                try:
                    save_checkpoint(step_idx, sync=True)
                except BaseException:
                    # an unwritable disk must not leak the writer, the CSV
                    # handles or the watchdog on top of losing the
                    # checkpoint
                    for closer in (ckpt.close, logger.close):
                        try:
                            closer()
                        except Exception:
                            pass
                    if wd is not None:
                        wd.close()
                    raise
        if dev.type == "cuda":
            with watch_or_null(wd, "final.synchronize"):
                torch.cuda.synchronize(dev)
        end_step = step_idx
        t_end = time.perf_counter()
        elapsed = t_end - t_start
        sps_steady = None
        if t_steady is not None and end_step > steady_from \
                and t_end > t_steady:
            sps_steady = (end_step - steady_from) / (t_end - t_steady)
        # after a resume both rates count only the steps this fit ran
        steps_done = end_step - start_step
        mfu, tokens_per_second = None, None
        gpt_cfg = getattr(loss_model.module, "config", None)
        block = getattr(gpt_cfg, "block_size", 0)
        if elapsed > 0 and block:
            tokens_per_second = (batch_size * num_nodes * block * steps_done
                                 / elapsed)
        from .models.nanogpt import GPT, node_mfu
        if isinstance(loss_model.module, GPT) and steps_done > 0 \
                and elapsed > 0:
            # over the whole fit loop, evals and logging included, as the
            # JAX trainer measures it
            mfu = node_mfu(gpt_cfg, state.params, batch_size * num_nodes,
                           elapsed / steps_done,
                           peak_flops=H100_BF16_PEAK_FLOPS)
        sim_summary = None
        if net_sim is not None:
            # every step from 0 re-priced at the final steady compute rate:
            # deterministic given the rate, and a resumed fit prices the
            # steps before its start as the first fit did
            comp_final = (1.0 / sps_steady if sps_steady
                          else (elapsed / steps_done if steps_done else 0.0))
            sim_summary = net_sim.simulate(end_step, comp_final).summary()
        logger.log_summary({
            "steps_per_second": steps_done / elapsed if elapsed else 0.0,
            "steps_per_second_steady": sps_steady,
            "mfu": mfu,
            "mfu_peak_flops": H100_BF16_PEAK_FLOPS,
            "tokens_per_second": tokens_per_second,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "cum_comm_bytes": logger.cum_comm_bytes,
            "final_train_loss": last_loss,
            **(sim_summary or {}),
        })
        try:
            if not preempted:
                run_eval()
            if ckpt is not None:
                if (not preempted and end_step % checkpoint_interval != 0
                        and end_step > start_step):
                    save_checkpoint(end_step)
                ckpt.close()
        finally:
            logger.close()
            if wd is not None:
                wd.close()
        return FitResult(
            params=runtime.average_over_nodes(state.params),
            model_state=runtime.average_over_nodes(state.model_state),
            node_state=state,
            steps=end_step,
            steps_per_second=steps_done / elapsed if elapsed > 0 else 0.0,
            final_train_loss=last_loss,
            history=history,
            mfu=mfu,
            steps_per_second_steady=sps_steady,
            preempted=preempted,
            sim=sim_summary,
        )


LocalTrainer = Trainer
