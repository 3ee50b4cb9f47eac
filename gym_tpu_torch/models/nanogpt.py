"""nanoGPT, training path (counterpart of ``gym_tpu/models/nanogpt.py``).

The reference family: pre-norm residual blocks, causal self-attention, tanh
GELU MLP, tied ``wte``/lm head, 0.02 init with the 0.02/√(2L) residual
projections, ``GPTConfig`` and its size map. Parameters are a flat dict named
as the flax tree flattened with ``"."`` (``h_0.attn.c_attn.kernel``), each
with a leading node dimension ``[K, ...]``; kernels keep flax's ``[in, out]``
layout, so a linear layer is one ``bmm`` over the node dimension. The module
holds no parameters of its own: ``forward(params, batch)`` returns the K
per-node losses.

``remat`` runs each block under ``torch.utils.checkpoint`` (the JAX
package's ``nn.remat(Block)``), and ``loss_chunk`` computes the tied lm head
and cross-entropy over row chunks, each recomputed in the backward: the two
memory levers of long-context training.

Dropout draws flax's masks: each dropout site's key is the microbatch's
node keys folded with the site's flax path (``_dropout_paths``), so a
recomputed block draws its forward's masks again. Decode (KV caches, paging,
sampling), MoE, quantized weights and sequence sharding belong to later
slices of the port and raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import threefry
from ..ops.attention import causal_attention
from .base import dropout as _dropout


@dataclasses.dataclass
class GPTConfig:
    block_size: int = 1024
    vocab_size: int = 50304  # GPT-2 50257 padded to a multiple of 64
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    dropout: float = 0.0
    bias: bool = True
    # 'dense' (reference behaviour) or 'flash' (the fused kernels on the
    # card, ops/flash_attention.py); 'ring' is a later slice
    attn_impl: str = "dense"
    seq_axis: Optional[str] = None
    seq_layout: str = "zigzag"
    remat: bool = False
    n_experts: int = 0
    expert_topk: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2
    moe_aux_weight: float = 1e-2
    moe_z_weight: float = 1e-3
    expert_axis: Optional[str] = None
    moe_impl: str = "auto"
    moe_chunk_rows: int = 16384
    loss_chunk: int = 0
    decode: bool = False
    page_size: int = 0
    kv_pages: int = 0
    weights_dtype: str = "f32"
    kv_dtype: str = "f32"
    quant_tile: int = 256
    quant_embed: bool = False

    @classmethod
    def gpt2_size_map(cls, size: str) -> "GPTConfig":
        return {
            "small": cls.gpt2_small,
            "base": cls.gpt2_base,
            "medium": cls.gpt2_medium,
            "large": cls.gpt2_large,
            "xl": cls.gpt2_xl,
        }[size]()

    @classmethod
    def gpt2_small(cls):
        # the reference's nonstandard "small": 4 layers / 4 heads / 128 dim
        return cls(n_layer=4, n_head=4, n_embd=128)

    @classmethod
    def gpt2_base(cls):
        return cls(n_layer=12, n_head=12, n_embd=768)

    @classmethod
    def gpt2_medium(cls):
        return cls(n_layer=24, n_head=16, n_embd=1024)

    @classmethod
    def gpt2_large(cls):
        return cls(n_layer=36, n_head=20, n_embd=1280)

    @classmethod
    def gpt2_xl(cls):
        return cls(n_layer=48, n_head=25, n_embd=1600)


def _unsupported(cfg: GPTConfig) -> Optional[str]:
    """The config fields of later slices, named if set."""
    checks = (
        (cfg.decode or cfg.page_size > 0, "KV-cache decode"),
        (cfg.n_experts > 0, "mixture-of-experts layers"),
        (cfg.weights_dtype != "f32" or cfg.kv_dtype != "f32"
         or cfg.quant_embed, "quantized weights and KV caches"),
        (cfg.seq_axis is not None or cfg.attn_impl == "ring",
         "sequence sharding (ring attention)"),
    )
    for bad, what in checks:
        if bad:
            return what
    return None


# -- per-node layers: every weight carries a leading node dimension ---------


def _dense(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense`` for K nodes: x [K, ..., in] @ kernel [K, in, out]
    (+ bias [K, out]), the product rounded before the bias add as in flax."""
    w = params[f"{name}.kernel"]
    k = x.shape[0]
    y = torch.bmm(x.reshape(k, -1, x.shape[-1]), w)
    y = y.reshape(*x.shape[:-1], w.shape[-1])
    b = params.get(f"{name}.bias")
    if b is not None:
        y = y + b.view(k, *([1] * (x.dim() - 2)), -1)
    return y


def _layer_norm(params, name: str, x: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """flax ``nn.LayerNorm``: mean and variance in f32 (E[x²] − E[x]², the
    fast-variance form) even for bf16 inputs, normalisation in f32, result in
    the input's dtype."""
    k = x.shape[0]
    shape = (k, *([1] * (x.dim() - 2)), -1)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mu2 - mu * mu, min=0.0)
    y = xf - mu
    mul = torch.rsqrt(var + eps)
    scale = params[f"{name}.scale"]
    mul = mul * scale.view(shape).float()
    y = y * mul
    bias = params.get(f"{name}.bias")
    if bias is not None:
        y = y + bias.view(shape).float()
    return y.to(torch.promote_types(x.dtype, scale.dtype))


def _embed(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-node row gather: table [K, V, C], idx [K, ...] → [K, ..., C]."""
    k, v = table.shape[0], table.shape[1]
    offs = (torch.arange(k, device=idx.device) * v).view(
        k, *([1] * (idx.dim() - 1)))
    return F.embedding(idx.long() + offs, table.reshape(k * v, -1))


def _ce_rows(x, targets, embedding) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node (Σ masked CE, Σ valid) of rows x [K, S, C] (already in the
    embedding's dtype) and targets [K, S]."""
    k, v = x.shape[0], embedding.shape[1]
    logits = torch.bmm(x, embedding.transpose(1, 2)).float()
    tgt = targets.long()
    losses = F.cross_entropy(logits.reshape(-1, v),
                             tgt.clamp(min=0).reshape(-1),
                             reduction="none").view(k, -1)
    valid = (tgt >= 0).float()
    return (losses * valid).sum(dim=1), valid.sum(dim=1)


def ce_sum_count(x, targets, embedding,
                 loss_chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node (Σ masked CE, Σ valid) through the tied lm head: the head
    matmul in the embedding's dtype, f32 cross-entropy, ``targets == -1``
    masked. x [K, B, T, C], targets [K, B, T], embedding [K, V, C]."""
    k, c = x.shape[0], x.shape[-1]
    xf = x.reshape(k, -1, c).to(embedding.dtype)
    tf = targets.reshape(k, -1)
    if loss_chunk > 0:
        return _chunked_ce(xf, tf, embedding, loss_chunk)
    return _ce_rows(xf, tf, embedding)


def _chunked_ce(xf, tf, embedding, chunk: int):
    """(Σ masked CE, Σ valid) per node over ``chunk``-row blocks, never
    holding more than [K, chunk, V] logits: each block runs head matmul →
    f32 CE under ``checkpoint``, so the backward recomputes a block's logits
    instead of storing them (the JAX package's ``jax.checkpoint`` inside a
    ``lax.scan``). Rows are padded to a multiple of ``chunk`` with target −1,
    and the sums accumulate in f32 in block order."""
    s = xf.shape[1]
    n_blocks = -(-s // chunk)
    pad = n_blocks * chunk - s
    xf = F.pad(xf, (0, 0, 0, pad))
    tf = F.pad(tf, (0, pad), value=-1)
    loss_sum = torch.zeros(xf.shape[0], device=xf.device)
    count = torch.zeros_like(loss_sum)
    for i in range(n_blocks):
        rows = slice(i * chunk, (i + 1) * chunk)
        ls, n = _maybe_checkpoint(_ce_rows, xf[:, rows], tf[:, rows],
                                  embedding)
        loss_sum = loss_sum + ls
        count = count + n
    return loss_sum, count


def _maybe_checkpoint(fn, *args):
    """``fn(*args)``, with its activations recomputed in the backward when
    a backward will run; a plain call under ``no_grad`` (evaluation)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


class GPT(torch.nn.Module):
    """``forward(params, (idx, targets))`` → per-node losses [K] (targets ==
    -1 are ignored); ``forward(params, idx)`` → logits [K, B, T, V]. idx and
    targets are [K, B, T]."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        what = _unsupported(config)
        if what is not None:
            raise NotImplementedError(
                f"{what} is ported in a later slice of gym_tpu_torch")
        if config.n_embd % config.n_head:
            raise ValueError(f"n_embd {config.n_embd} not divisible by "
                             f"n_head {config.n_head}")
        self.config = config

    def _param_specs(self):
        """{name: (per-node shape, init)} for every parameter, named by the
        flax tree path joined with '.'; init is a normal std, 0.0 for
        zeros or 1.0 for ones (layer-norm scales)."""
        cfg = self.config
        c = cfg.n_embd
        resid = 0.02 / math.sqrt(2 * cfg.n_layer)
        specs = {"wte.embedding": ((cfg.vocab_size, c), 0.02),
                 "wpe.embedding": ((cfg.block_size, c), 0.02)}

        def dense(name, fan_in, fan_out, std):
            specs[f"{name}.kernel"] = ((fan_in, fan_out), std)
            if cfg.bias:
                specs[f"{name}.bias"] = ((fan_out,), 0.0)

        def ln(name):
            specs[f"{name}.scale"] = ((c,), 1.0)
            if cfg.bias:
                specs[f"{name}.bias"] = ((c,), 0.0)

        for i in range(cfg.n_layer):
            p = f"h_{i}"
            ln(f"{p}.ln_1")
            dense(f"{p}.attn.c_attn", c, 3 * c, 0.02)
            dense(f"{p}.attn.c_proj", c, c, resid)
            ln(f"{p}.ln_2")
            dense(f"{p}.mlp.c_fc", c, 4 * c, 0.02)
            dense(f"{p}.mlp.c_proj", 4 * c, c, resid)
        ln("ln_f")
        return specs

    def init_params(self, num_nodes: int, seed: int,
                    device) -> Dict[str, torch.Tensor]:
        """f32 parameters from ``seed``, identical on every node (replicas
        start from the same weights, as in the JAX package); stacked
        ``[K, ...]``. Normal(0.02) kernels and embeddings, 0.02/√(2L) for the
        residual projections, zero biases, unit layer-norm scales."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, (shape, init) in self._param_specs().items():
            if name.endswith((".bias", ".scale")):
                w = torch.full(shape, init)
            else:
                w = torch.randn(shape, generator=gen) * init
            out[name] = w.to(device).unsqueeze(0).repeat(
                num_nodes, *([1] * len(shape)))
        return out

    def _dropout_paths(self):
        """flax's path and call counter of every dropout draw: the
        embedding's ``Dropout_0``, then in each block the attention
        probabilities (``make_rng`` in ``attn``), the attention output's
        and the MLP's ``Dropout_0``."""
        paths = {"drop": ("Dropout_0", 1)}
        for i in range(self.config.n_layer):
            p = f"h_{i}"
            paths[f"{p}.attn"] = (p, "attn", 1)
            paths[f"{p}.attn.drop"] = (p, "attn", "Dropout_0", 1)
            paths[f"{p}.mlp.drop"] = (p, "mlp", "Dropout_0", 1)
        return paths

    def _attention(self, params, p, x, train, keys):
        cfg = self.config
        k, b, t, c = x.shape
        hd = c // cfg.n_head
        qkv = _dense(params, f"{p}.c_attn", x)
        q, kk, v = qkv.split(c, dim=-1)
        drop_active = train and cfg.dropout > 0
        y = None
        if cfg.attn_impl == "flash" and not drop_active:
            # packed kernels on [K, B, T, C] views of qkv: no head
            # transposes; None → the per-head path below
            from ..ops.flash_attention import packed_flash_attention_or_none
            y = packed_flash_attention_or_none(q, kk, v, cfg.n_head)
        if y is None:
            def heads(z):
                return z.reshape(k, b, t, cfg.n_head, hd).transpose(2, 3)

            y = causal_attention(
                heads(q), heads(kk), heads(v), impl=cfg.attn_impl,
                dropout_rate=cfg.dropout,
                dropout_rng=keys[p] if drop_active else None,
                deterministic=not train)
            y = y.transpose(2, 3).reshape(k, b, t, c)
        y = _dense(params, f"{p}.c_proj", y)
        return _dropout(y, cfg.dropout, keys.get(f"{p}.drop"), train)

    def _mlp(self, params, p, x, train, keys):
        x = _dense(params, f"{p}.c_fc", x)
        x = F.gelu(x, approximate="tanh")  # flax nn.gelu defaults to tanh
        x = _dense(params, f"{p}.c_proj", x)
        return _dropout(x, self.config.dropout, keys.get(f"{p}.drop"), train)

    def forward(self, params, batch, train: bool = True,
                rng: Optional[np.ndarray] = None):
        cfg = self.config
        if isinstance(batch, (tuple, list)):
            idx, targets = batch
        else:
            idx, targets = batch, None
        k, b, t = idx.shape
        if t > cfg.block_size:
            raise ValueError(
                f"sequence length {t} > block_size {cfg.block_size}")
        wte = params["wte.embedding"]
        wpe = params["wpe.embedding"][:, :t]
        keys = {}
        if train and cfg.dropout > 0:
            if rng is None:
                raise ValueError("dropout in train mode needs the nodes' "
                                 "keys (rng)")
            paths = self._dropout_paths()
            keys = dict(zip(paths, threefry.fold_in_paths(
                rng, paths.values())))
        x = _embed(wte, idx) + wpe[:, None]
        x = _dropout(x, cfg.dropout, keys.get("drop"), train)
        for i in range(cfg.n_layer):
            if cfg.remat:
                # the recomputation folds the same keys: the same masks
                x = _maybe_checkpoint(self._block, params, f"h_{i}", x,
                                      train, keys)
            else:
                x = self._block(params, f"h_{i}", x, train, keys)
        x = _layer_norm(params, "ln_f", x)
        if targets is None:
            # weight tying: lm_head = wteᵀ
            return torch.matmul(x.to(wte.dtype), wte.transpose(1, 2)[:, None])
        loss_sum, count = ce_sum_count(x, targets, wte, cfg.loss_chunk)
        return loss_sum / torch.clamp(count, min=1.0)

    def _block(self, params, p, x, train, keys):
        x = x + self._attention(params, f"{p}.attn",
                                _layer_norm(params, f"{p}.ln_1", x),
                                train, keys)
        return x + self._mlp(params, f"{p}.mlp",
                             _layer_norm(params, f"{p}.ln_2", x),
                             train, keys)


# -- model utilities (reference parity helpers) ----------------------------


def num_params(params: Dict[str, torch.Tensor],
               non_embedding: bool = True) -> int:
    """Parameter count of one node's params (no node dimension); positional
    embeddings subtracted by default (token embeddings stay: they serve as
    the lm head through tying)."""
    total = sum(p.numel() for p in params.values())
    if non_embedding:
        total -= params["wpe.embedding"].numel()
    return total


def estimate_mfu(config: GPTConfig, params: Dict[str, torch.Tensor],
                 fwdbwd_per_iter: float, dt: float, peak_flops: float,
                 n_params: Optional[int] = None) -> float:
    """Model FLOPs utilization against ``peak_flops``, which the caller
    states for its device (989e12 for an H100's bf16 tensor cores): 6·N
    flops a token for the matmuls plus 12·L·H·Q·T for attention, the
    reference's convention. ``n_params`` overrides the count."""
    n = n_params if n_params is not None else num_params(params)
    cfg = config
    l, h, q, t = cfg.n_layer, cfg.n_head, cfg.n_embd // cfg.n_head, \
        cfg.block_size
    flops_per_token = 6 * n + 12 * l * h * q * t
    flops_per_iter = flops_per_token * t * fwdbwd_per_iter
    return (flops_per_iter / dt) / peak_flops


def node_mfu(config: GPTConfig, node_params: Dict[str, torch.Tensor],
             seqs_per_iter: float, dt: float, peak_flops: float) -> float:
    """MFU from node-stacked params (leading [K] dimension, as the trainer
    holds them): counts one node's parameters and delegates to
    ``estimate_mfu``."""
    one = {n: p[0] for n, p in node_params.items()}
    return estimate_mfu(config, one, seqs_per_iter, dt, peak_flops)
