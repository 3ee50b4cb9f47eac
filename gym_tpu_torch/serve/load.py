"""A fit's run dir → servable ``(params, GPTConfig)`` (counterpart of
``gym_tpu/serve/load.py``: its params-only restore, quantize-at-load and
checkpoint watching).

A run dir (``fit(save_dir=..., checkpoint_interval=...)``) holds the
step-numbered checkpoints of the FULL train state and a ``config.json``
beside them. Serving needs none of the training machinery:

1. ``utils.checkpoint.restore_params`` reads the newest valid step with no
   template and hands back the node-stacked ``params``;
2. the [K] node dimension is averaged away exactly as
   ``convert.serving_params`` averages ``FitResult.node_state.params``, on
   the device asked for, so a run dir serves the same tokens as the
   in-process weights;
3. ``GPTConfig`` is rebuilt from ``config.json``'s ``model_config``; the
   engine makes it fit for decode (``models.nanogpt.decode_config``);
4. ``weights_dtype`` ("int8"/"int4") quantizes the averaged weights
   (``quantize_params``) and ``kv_dtype`` ("int8") stamps the config: the
   KV cache quantizes as it is written.

The process fleet loads once in the parent and hands its workers a numpy
snapshot of the (quantized) weights and the config as JSON
(``dump_params_snapshot``/``load_params_snapshot``, ``config_to_json``/
``config_from_json``): every worker serves the parent's bits.

``CheckpointNotFoundError`` propagates typed (the CLI turns it into a
one-line message).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import sys
import threading
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import serving_params
from ..models.nanogpt import GPTConfig, refuse_quantized_moe
from ..ops.grouped_matmul import quant_tile_for
from ..train_node import default_device
from ..utils.checkpoint import CheckpointNotFoundError, restore_params


# -- quantize-at-load ---------------------------------------------------------


def params_are_quantized(params: Dict[str, torch.Tensor]) -> bool:
    """True when the flat tree already carries quantized leaves
    (``qkernel``/``qembedding``): every construction path (the engine, a
    replica rebuild, a hot swap) takes an f32 tree or a quantized one and
    never quantizes twice."""
    return any(n.rpartition(".")[2] in ("qkernel", "qembedding")
               for n in params)


def _quantize_eagerly(w: torch.Tensor, bits: int, tile: int):
    """``QuantizeCodec(bits, tile, stochastic=False).compress`` of the
    flat weight as ``gym_tpu/serve/load.py`` runs it, eagerly: ``scale =
    amax / qmax`` is a true division there (the jitted step's codec,
    ``ops/quantize_tiles``, multiplies by ``f32(1/qmax)``). On the CPU,
    where the division by the host scalar is one (the card would multiply
    by its reciprocal); ``tile`` divides the weight's size. → (q int8 [T,
    tile], scale f32 [T, 1])."""
    qmax = (1 << (bits - 1)) - 1
    xt = w.float().cpu().reshape(-1, tile)
    amax = xt.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(xt / scale), -qmax, qmax)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


def quantize_params(params: Dict[str, torch.Tensor],
                    config) -> Dict[str, torch.Tensor]:
    """An f32 flat tree quantized for serving under ``config``
    (``weights_dtype`` "int8"/"int4", optional ``quant_embed``): every 2-D
    ``kernel``, and ``wte.embedding`` under ``quant_embed``, becomes
    ``qkernel``/``qembedding`` (int8, its own shape) and ``qscale`` (f32,
    one a tile) through ``_quantize_eagerly``, the tile ``quant_tile_for``
    clamps to divide the trailing axis (so the codec's tiles are the JAX
    package's flat ones). Biases, layer norms and ``wpe`` stay f32. A no-op
    at ``weights_dtype="f32"``. The served weights are the JAX package's
    bits wherever they are quantized."""
    wd = getattr(config, "weights_dtype", "f32")
    if wd == "f32":
        return params
    refuse_quantized_moe(config)
    if wd not in ("int8", "int4"):
        raise ValueError(
            f"weights_dtype must be 'f32', 'int8' or 'int4', got {wd!r}")
    bits = {"int8": 8, "int4": 4}[wd]
    tile = int(getattr(config, "quant_tile", 256))
    embed = bool(getattr(config, "quant_embed", False))
    out = {}
    for name, w in params.items():
        base, _, leaf = name.rpartition(".")
        if (leaf == "kernel" and w.dim() == 2) or (
                embed and name == "wte.embedding"):
            q, scale = _quantize_eagerly(w, bits,
                                         quant_tile_for(w.shape, tile))
            qname = "qkernel" if leaf == "kernel" else "qembedding"
            out[f"{base}.{qname}"] = q.reshape(w.shape).to(w.device)
            out[f"{base}.qscale"] = scale.reshape(-1).to(w.device)
        else:
            out[name] = w
    return out


def read_run_config(run_dir: str,
                    config_path: Optional[str] = None) -> Dict[str, Any]:
    """Load the run's captured ``config.json``. Looked up in the run dir
    itself (where the trainer writes it next to the step dirs); an
    explicit ``config_path`` overrides — e.g. the CSVLogger copy under
    ``logs/<run_name>/config.json``."""
    path = config_path or os.path.join(run_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no config.json at {path} — pass config_path= (the CSVLogger "
            f"copy under logs/<run_name>/ works) or an explicit GPTConfig")
    with open(path) as f:
        return json.load(f)


def gpt_config_from_run(config: Dict[str, Any]) -> GPTConfig:
    """Rebuild the ``GPTConfig`` from a captured run config (the trainer
    records the model's config dataclass as ``model_config.config``).
    Unknown keys are ignored, so an older reader takes a newer run's
    snapshot; the JAX package's run dirs carry the same keys."""
    model_cfg = (config.get("model_config") or {}).get("config")
    if not isinstance(model_cfg, dict):
        raise ValueError(
            "config.json carries no model_config.config — was this run's "
            "model a GPT? (serving supports the GPT family)")
    fields = {f.name for f in dataclasses.fields(GPTConfig)}
    return GPTConfig(**{k: v for k, v in model_cfg.items() if k in fields})


def load_for_serving(run_dir: str, step: Optional[int] = None,
                     config: Optional[GPTConfig] = None,
                     config_path: Optional[str] = None,
                     weights_dtype: Optional[str] = None,
                     kv_dtype: Optional[str] = None,
                     quant_embed: bool = False,
                     device: Optional[str] = None
                     ) -> Tuple[Dict[str, torch.Tensor], GPTConfig,
                                Dict[str, Any]]:
    """Restore a ``fit()`` run dir for inference.

    Returns ``(params, config, info)``: the node-AVERAGED f32 parameters
    by name on ``device`` (the card unless ``device="cpu"``), averaged
    there as ``convert.serving_params`` does; the run's ``GPTConfig``;
    and ``info`` (``step``, ``num_nodes``, the raw run config).
    ``config=`` skips the ``config.json`` lookup.

    ``weights_dtype`` ("int8"/"int4") quantizes the averaged parameters
    (``quantize_params``; ``quant_embed`` the tied embedding too) and the
    returned config carries the dtypes; ``kv_dtype`` ("int8") only stamps
    the config: the KV cache quantizes as it is written."""
    dev = default_device(device)
    if not os.path.isdir(run_dir):
        raise CheckpointNotFoundError(
            f"checkpoint run dir {run_dir} does not exist")
    raw: Dict[str, Any] = {}
    if config is None:
        raw = read_run_config(run_dir, config_path)
        config = gpt_config_from_run(raw)
    at_step, node_params, _extra = restore_params(run_dir, step=step,
                                                  device=dev)
    if not node_params:
        raise CheckpointNotFoundError(
            f"checkpoint step {at_step} under {run_dir} restored an "
            f"empty params tree")
    k = int(next(iter(node_params.values())).shape[0])
    want_k = raw.get("num_nodes")
    if want_k is not None and int(want_k) != k:
        raise ValueError(
            f"checkpoint params carry a [{k}]-node axis but config.json "
            f"says num_nodes={want_k} — wrong run dir / config pairing?")
    info = {"step": at_step, "num_nodes": k, "run_config": raw}
    params = serving_params(node_params)
    if weights_dtype or kv_dtype or quant_embed:
        config = dataclasses.replace(
            config, weights_dtype=weights_dtype or config.weights_dtype,
            kv_dtype=kv_dtype or config.kv_dtype,
            quant_embed=bool(quant_embed) or config.quant_embed)
        params = quantize_params(params, config)
    return params, config, info


# -- the process fleet's params snapshot ----------------------------------


def dump_params_snapshot(params: Dict[str, torch.Tensor], path: str) -> str:
    """Write one model's flat parameters (f32 or already quantized) as a
    pickled ``{name: numpy array}``, atomically (a worker must never read
    a torn file): the snapshot the fleet's parent writes once and every
    worker process loads (``load_params_snapshot``)."""
    host = {name: t.detach().cpu().numpy() for name, t in params.items()}
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(host, f, protocol=4)
    os.replace(tmp, path)
    return path


def load_params_snapshot(path: str, device: Optional[str] = None
                         ) -> Dict[str, torch.Tensor]:
    """A ``dump_params_snapshot`` file as tensors on ``device`` (the card
    unless ``device="cpu"``), each leaf's dtype and bits kept."""
    dev = default_device(device)
    with open(path, "rb") as f:
        host = pickle.load(f)
    return {name: torch.as_tensor(np.asarray(a)).to(dev)
            for name, a in host.items()}


def config_to_json(config: GPTConfig, path: str) -> str:
    """``config``'s fields as JSON, atomically (``config_from_json``)."""
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(config), f)
    os.replace(tmp, path)
    return path


def config_from_json(path: str) -> GPTConfig:
    """The ``GPTConfig`` a ``config_to_json`` file holds (unknown keys
    ignored)."""
    with open(path) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(GPTConfig)}
    return GPTConfig(**{k: v for k, v in raw.items() if k in fields})


# -- checkpoint-dir watching ----------------------------------------------


def latest_checkpoint_step(run_dir: str) -> Optional[int]:
    """Newest COMMITTED checkpoint step in a run dir, from directory names
    alone — cheap enough to poll. A step is written into a dotted
    temporary dir and renamed on commit, and quarantined dirs carry a
    ``.corrupt-k`` suffix, so "committed" is exactly "the name is a bare
    integer". None when the dir is missing or empty."""
    try:
        names = os.listdir(run_dir)
    except OSError:
        return None
    steps = [int(n) for n in names if n.isdigit()]
    return max(steps) if steps else None


class CheckpointWatcher:
    """Poll a trainer's run dir and fire ``on_new_step(step)`` whenever a
    NEWER committed checkpoint appears (the push half of a weight
    hot-swap). Callback failures are logged, not fatal: a single
    unreadable checkpoint must not kill the watcher — the trainer's NEXT
    checkpoint gets its own attempt."""

    def __init__(self, run_dir: str,
                 on_new_step: Callable[[int], None],
                 poll_s: float = 10.0,
                 initial_step: Optional[int] = None):
        """``initial_step``: the step already being served — only strictly
        newer checkpoints fire (None = the first committed one fires)."""
        self.run_dir = run_dir
        self.on_new_step = on_new_step
        self.poll_s = float(poll_s)
        self.last_step = initial_step
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="gym-tpu-torch-ckpt-watcher",
            daemon=True)

    def start(self) -> "CheckpointWatcher":
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout=join_timeout_s)

    def poll_once(self) -> Optional[int]:
        """One poll (also the testable unit): fire the callback iff a
        newer step committed; returns the step fired, else None."""
        step = latest_checkpoint_step(self.run_dir)
        if step is None or (self.last_step is not None
                            and step <= self.last_step):
            return None
        self.last_step = step
        try:
            self.on_new_step(step)
        except Exception:  # noqa: BLE001 — the next checkpoint retries
            sys.stderr.write(
                f"gym_tpu_torch.serve: checkpoint watcher — on_new_step"
                f"({step}) raised:\n{traceback.format_exc()}")
        return step

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self.poll_once()
