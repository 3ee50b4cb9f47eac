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
recomputed block draws its forward's masks again.

KV-cache decode (``decode_config``, ``GPT.decode``): one model's parameters,
no node dimension, and a cache of per-layer K and V, either per row
(``[b, S, H, hd]`` with a cursor a row) or a pool of pages shared by the
rows (``[P, page, H, hd]``, addressed through a block table passed in). The
attends run on B7 (``ops/decode_attention.py``), the dense layers and the
tied lm head on R1 and the layer norms on L1 (``ops/row_linear.py``), so a
row's logits never depend on the other rows, the number of tokens in the
call or the paging. ``sample_logits``, ``generate`` and ``generate_fast``
are the JAX package's, with its threefry key schedule. MoE, quantized
weights and KV caches, and sequence sharding belong to later slices of the
port and raise.
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
from ..ops.decode_attention import decode_attention, unpaged_table
from ..ops.row_linear import row_cumsum, row_layer_norm, row_linear
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
        if cfg.decode:
            raise ValueError("a decode config runs through GPT.decode")
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

    # -- KV-cache decode: one model, no node dimension ----------------------

    def init_cache(self, batch: int, device) -> Dict[str, torch.Tensor]:
        """Zeroed decode cache. Unpaged: per layer ``{p}.k``/``{p}.v``
        ``[batch, S, H, hd]`` and one cursor a row, ``pos`` ``[batch]``
        int32 (the JAX cache's per-layer ``i`` and the model's ``pos``
        always agree, so one tensor holds them). Paged (``page_size >
        0``): per layer a pool ``[kv_pages, page_size, H, hd]``, shared
        by every row whatever ``batch`` is; the cursors are arguments."""
        cfg = self.config
        if not cfg.decode:
            raise ValueError("init_cache needs a decode config "
                             "(decode_config)")
        h = cfg.n_head
        hd = cfg.n_embd // h
        if cfg.page_size > 0:
            shape = (cfg.kv_pages, cfg.page_size, h, hd)
        else:
            shape = (batch, cfg.block_size, h, hd)
        cache = {}
        for i in range(cfg.n_layer):
            for kv in ("k", "v"):
                cache[f"h_{i}.attn.{kv}"] = torch.zeros(
                    shape, dtype=torch.float32, device=device)
        if cfg.page_size == 0:
            cache["pos"] = torch.zeros(batch, dtype=torch.int32,
                                       device=device)
        return cache

    def decode(self, params, idx: torch.Tensor, cache: Dict[str, torch.Tensor],
               block_table: Optional[torch.Tensor] = None,
               cache_pos: Optional[torch.Tensor] = None,
               logits_at=None) -> torch.Tensor:
        """One decode call: ``idx`` [b, t] new tokens at each row's cursor,
        their K and V written into ``cache`` in place, logits [b, t, V]
        (or [b, 1, V] at the positions ``logits_at`` picks: an int or one
        index a row, for a prefill that needs only its last token's).

        Unpaged, the cursor is ``cache["pos"]``, advanced by t; writes past
        the window are clamped into it and the row's output is NaN. Paged,
        ``block_table`` [b, S // page] and ``cache_pos`` [b] (int32) are
        arguments; writes past the window go to the null page 0 and those
        positions' outputs are NaN."""
        cfg = self.config
        if not cfg.decode:
            raise ValueError("GPT.decode needs a decode config "
                             "(decode_config)")
        b, t = idx.shape
        s = cfg.block_size
        if t > s:
            raise ValueError(f"sequence length {t} > block_size {s}")
        steps = torch.arange(t, dtype=torch.int32, device=idx.device)
        if cfg.page_size > 0:
            if block_table is None or cache_pos is None:
                raise ValueError("paged decode (page_size > 0) needs "
                                 "block_table and cache_pos")
            cursor = cache_pos.to(torch.int32)
        else:
            cursor = cache["pos"]
            cache["pos"] = cursor + t
        # XLA's gather clamps a position past the window; those outputs
        # are NaN below either way
        pos = torch.clamp(cursor[:, None] + steps, max=s - 1)
        x = (F.embedding(idx.long(), params["wte.embedding"])
             + F.embedding(pos.long(), params["wpe.embedding"]))
        for i in range(cfg.n_layer):
            p = f"h_{i}"
            h = self._row_ln(params, f"{p}.ln_1", x)
            x = x + self._decode_attend(params, f"{p}.attn", h, cache,
                                        cursor, block_table)
            h = self._row_ln(params, f"{p}.ln_2", x)
            h = F.gelu(self._row_dense(params, f"{p}.mlp.c_fc", h),
                       approximate="tanh")
            x = x + self._row_dense(params, f"{p}.mlp.c_proj", h)
        x = self._row_ln(params, "ln_f", x)
        if logits_at is not None:
            at = torch.as_tensor(logits_at, device=x.device).long()
            at = at.expand(b) if at.dim() == 0 else at
            x = x[torch.arange(b, device=x.device), at][:, None]
        # weight tying: lm_head = wteᵀ
        return row_linear(x, params["wte.embedding"], w_nk=True)

    @staticmethod
    def _row_dense(params, name, x):
        return row_linear(x, params[f"{name}.kernel"],
                          params.get(f"{name}.bias"))

    @staticmethod
    def _row_ln(params, name, x):
        return row_layer_norm(x, params[f"{name}.scale"],
                              params.get(f"{name}.bias"))

    def _decode_attend(self, params, p, x, cache, cursor, block_table):
        cfg = self.config
        b, t, c = x.shape
        h = cfg.n_head
        hd = c // h
        s = cfg.block_size
        qkv = self._row_dense(params, f"{p}.c_attn", x)
        q, k, v = (z.unflatten(-1, (h, hd)) for z in qkv.split(c, dim=-1))
        kc, vc = cache[f"{p}.k"], cache[f"{p}.v"]
        wpos = cursor[:, None] + torch.arange(t, dtype=torch.int32,
                                              device=x.device)
        if cfg.page_size > 0:
            page = cfg.page_size
            lblk = torch.clamp(torch.div(wpos, page, rounding_mode="floor"),
                               0, s // page - 1)
            phys = torch.gather(block_table, 1, lblk.long())
            phys = torch.where(wpos < s, phys, 0).long()
            off = (wpos % page).long()
            kc[phys, off] = k
            vc[phys, off] = v
            y = decode_attention(q, kc, vc, block_table, cursor)
            # per-position poison: out-of-window speculative positions
            ok = (wpos < s)[:, :, None, None]
        else:
            rows = torch.arange(b, device=x.device)[:, None].expand(b, t)
            wclamp = torch.clamp(wpos, max=s - 1).long()
            kc[rows, wclamp] = k
            vc[rows, wclamp] = v
            y = decode_attention(q, kc, vc, unpaged_table(b, x.device),
                                 cursor)
            # per-row poison: an overflowing row, never its neighbours
            ok = (cursor + t <= s)[:, None, None, None]
        y = y.masked_fill(~ok, float("nan"))
        return self._row_dense(params, f"{p}.c_proj", y.reshape(b, t, c))


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


# -- decode: config, sampling, generation -----------------------------------


def decode_config(config: GPTConfig) -> GPTConfig:
    """A training config made fit for single-model KV-cache decode (the
    JAX package's rule, shared by ``generate_fast`` and the serving
    engine): dropout off, dense attention, no sequence sharding, no remat,
    ``moe_impl`` back to 'auto' with ``expert_axis`` cleared."""
    return dataclasses.replace(config, decode=True, dropout=0.0,
                               attn_impl="dense", seq_axis=None,
                               remat=False, expert_axis=None,
                               moe_impl="auto")


def _per_row(x, rows: int, dtype, device) -> torch.Tensor:
    """A python scalar or a per-row tensor as an [rows, 1] tensor: the
    sampler divides and compares by tensors only (a CUDA division by a
    host scalar multiplies by its reciprocal, which rounds otherwise)."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t.reshape(-1, 1).expand(rows, 1)


def sample_logits(logits: torch.Tensor, keys: torch.Tensor,
                  temperature=1.0, top_k=None, top_p=None,
                  key_data=None) -> torch.Tensor:
    """Temperature → top-k → top-p (nucleus) → categorical, in f32, for
    logits [R, V] → [R] int64 tokens. ``keys`` is an [R, 2] int32 tensor of
    keys, one a row, or [1, 2], one key for all the rows (``threefry.
    categorical``); ``key_data`` [R] or [1] int32 folds into them first.
    ``temperature``/``top_k``/``top_p`` are scalars (``None`` disables a
    filter) or [R] tensors; ``top_k >= V`` and ``top_p >= 1`` are the
    tensors' "disabled" and give exactly the ``None`` paths. Every step is
    row-invariant: sorts, gathers and elementwise ops, and the nucleus mass
    scanned by ``row_cumsum``."""
    r, v = logits.shape
    dev = logits.device
    lg = logits.float() / _per_row(temperature, r, torch.float32, dev)
    k = v if top_k is None else top_k
    kidx = torch.clamp(_per_row(k, r, torch.int64, dev), 1, v) - 1
    srt = torch.sort(lg, dim=-1, descending=True).values
    lg = torch.where(lg < torch.gather(srt, 1, kidx), -torch.inf, lg)
    if top_p is not None:
        # exclusive cumulative mass of the (top-k filtered) descending
        # probabilities under top_p; the top token is always kept, and p >=
        # 1 keeps every token
        srt = torch.sort(lg, dim=-1, descending=True).values
        e = torch.exp(srt - srt[:, :1])
        probs = e / row_cumsum(e)[:, -1:]
        cum = row_cumsum(probs) - probs
        p_eff = _per_row(top_p, r, torch.float32, dev)
        keep = cum < torch.where(p_eff >= 1.0, torch.inf, p_eff)
        n_keep = torch.clamp(keep.sum(dim=-1, keepdim=True), min=1)
        thr = torch.gather(srt, 1, n_keep - 1)
        lg = torch.where(lg < thr, -torch.inf, lg)
    return threefry.categorical(lg, keys, key_data)


def generate(params, config: GPTConfig, idx: np.ndarray,
             max_new_tokens: int, temperature: float = 1.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             seed: int = 0) -> np.ndarray:
    """The reference's sampler: the full forward over the context (cropped
    to the last ``block_size`` tokens) every token, temperature, top-k and
    top-p in numpy, a categorical draw under ``split(key)`` each step. So
    it continues past ``block_size``, where ``generate_fast`` raises.
    ``params`` is one model's flat parameters (``convert.serving_params``);
    it runs where they are."""
    cfg = dataclasses.replace(config, decode=False, page_size=0,
                              kv_pages=0)
    model = GPT(cfg)
    device = params["wte.embedding"].device
    stacked = {n: p[None] for n, p in params.items()}
    key = threefry.PRNGKey(seed)
    idx = np.asarray(idx)
    for _ in range(max_new_tokens):
        ctx = torch.from_numpy(idx[:, -config.block_size:]).to(device)
        with torch.no_grad():
            logits = model(stacked, ctx[None], train=False)[0]
        logits = logits[:, -1, :].float().cpu().numpy() / temperature
        if top_k is not None:
            kth = np.sort(logits, axis=-1)[:, -min(top_k, logits.shape[-1])]
            logits = np.where(logits < kth[:, None], -np.inf, logits)
        if top_p is not None and top_p < 1.0:
            srt = np.sort(logits, axis=-1)[:, ::-1]
            e = np.exp(srt - srt[:, :1])
            probs = e / e.sum(axis=-1, keepdims=True)
            cum = np.cumsum(probs, axis=-1) - probs
            n_keep = np.maximum((cum < top_p).sum(axis=-1), 1)
            thr = np.take_along_axis(srt, (n_keep - 1)[:, None], axis=-1)
            logits = np.where(logits < thr, -np.inf, logits)
        key, sub = threefry.split(key)
        nxt = threefry.categorical(
            torch.from_numpy(logits.astype(np.float32)).to(device),
            threefry.key_tensor([sub], device))
        idx = np.concatenate([idx, nxt.cpu().numpy()[:, None]], axis=1)
    return idx


def generate_fast(params, config: GPTConfig, idx: np.ndarray,
                  max_new_tokens: int, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None,
                  seed: int = 0) -> np.ndarray:
    """KV-cache sampling: prefill the prompt, then one token a step, with
    ``generate``'s sampling and the key schedule ``fold_in(PRNGKey(seed),
    j)`` for the j-th new token, one key for all the rows (the serving
    engine reproduces it token by token). Raises ``ValueError`` when the
    prompt and the new tokens do not fit ``block_size``. ``params`` is one
    model's flat parameters; it runs where they are."""
    idx = np.asarray(idx)
    b, t0 = idx.shape
    if t0 + max_new_tokens > config.block_size:
        raise ValueError(
            f"prompt {t0} + {max_new_tokens} new tokens exceeds the KV "
            f"cache (block_size {config.block_size}); crop the prompt to "
            f"block_size - max_new_tokens, or use `generate`, whose "
            f"full-context resampling slides the context window past "
            f"block_size (the reference's crop semantics)")
    model = GPT(decode_config(config))
    device = params["wte.embedding"].device
    key = threefry.key_tensor([threefry.PRNGKey(seed)], device)
    cache = model.init_cache(b, device)

    def step(j):
        return torch.tensor([j], dtype=torch.int32, device=device)

    with torch.no_grad():
        logits = model.decode(params, torch.from_numpy(idx).to(device),
                              cache, logits_at=t0 - 1)
        tok = sample_logits(logits[:, -1], key, temperature, top_k, top_p,
                            step(0))
        toks = [tok]
        for j in range(1, max_new_tokens):
            logits = model.decode(params, tok[:, None], cache)
            tok = sample_logits(logits[:, -1], key, temperature, top_k,
                                top_p, step(j))
            toks.append(tok)
    new = torch.stack(toks, dim=1).cpu().numpy().astype(idx.dtype)
    return np.concatenate([idx, new], axis=1)
