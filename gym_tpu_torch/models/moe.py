"""Mixture-of-experts MLP (counterpart of ``gym_tpu/models/moe.py``).

``MoEMLP``'s math as functions on the port's flat parameters, each with a
leading node dimension ``[K, ...]``: under ``{name}`` the router
``router.kernel`` ``[K, C, E]``, the experts ``fc_kernel`` ``[K, E, C, 4C]``
and ``proj_kernel`` ``[K, E, 4C, C]`` and, with biases, ``fc_bias``
``[K, E, 4C]`` and ``proj_bias`` ``[K, E, C]``. ``moe_mlp`` returns the
layer's output and its weighted auxiliary loss a node; the GPT applies the
layer's dropout and adds the loss in training only.

The router runs in the compute dtype and its logits and softmax in f32 (C1's
rounding: the product rounded to the compute dtype, as the port's dense
layers round it). The top k are picked as ``lax.top_k`` picks them, a tie
going to the lower expert, by k rounds of argmax. Three dispatches, as in the
JAX package:

- ``ragged`` (what ``auto`` means: the port has no expert parallelism yet):
  rows sorted by expert with a stable sort, one B8 grouped matmul a
  projection (``ops/grouped_matmul.py``) over all K nodes at once (node n's
  rows in groups n·E … n·E+E−1), the bias gathered by expert, tanh GELU, and
  a combine that adds each token's k rows in their sorted order (ascending
  expert), without atomics. ``chunk_rows`` cuts each node's sorted rows into
  blocks of that many, the padding rows given expert E−1, one grouped
  matmul a block, as the JAX package's ``_grouped_dot``.
- ``einsum``: GShard's capacity-limited one-hot dispatch and combine,
  tokens past an expert's capacity dropped (what expert parallelism will
  take);
- ``dense``: every expert on every token, the combine masked to the top k;
  the same function as ``ragged`` at E/k times its products.

``rows=True`` is the decode path's form (one model, f32): the router on R1
(``row_linear``), the softmax and every small sum in a fixed order, so that
a row's output never depends on the other rows in the call, as R1 and B8's
f32 chains already guarantee for the products.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.grouped_matmul import grouped_dot
from ..ops.row_linear import row_linear

IMPLS = ("ragged", "einsum", "dense")
EXPERT_LEAVES = ("fc_kernel", "proj_kernel", "fc_bias", "proj_bias")


def resolve_impl(impl: str) -> str:
    """``auto`` is ``ragged``: the drop-free grouped matmul (the JAX
    package's choice without an expert axis)."""
    impl = "ragged" if impl == "auto" else impl
    if impl not in IMPLS:
        raise ValueError(f"unknown moe_impl {impl!r}")
    return impl


def _ordered_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last (small) dimension, left to right."""
    parts = t.unbind(-1)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dimension with every reduction in a fixed
    order: a row's bits do not depend on the other rows."""
    m = logits.max(dim=-1, keepdim=True).values
    e = torch.exp(logits - m)
    return e / _ordered_sum(e).unsqueeze(-1)


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dimension: the k largest values in
    descending order and their indices, a tie going to the lower index
    (argmax returns the first maximum)."""
    rem = gates
    vals, idx = [], []
    for _ in range(k):
        i = torch.argmax(rem, dim=-1, keepdim=True)
        vals.append(torch.gather(gates, -1, i))
        idx.append(i)
        rem = rem.scatter(-1, i, float("-inf"))
    return torch.cat(vals, -1), torch.cat(idx, -1)


def _topk_gates(gates: torch.Tensor, k: int):
    topg, topi = top_k(gates, k)
    if k > 1:
        topg = topg / torch.clamp(_ordered_sum(topg), min=1e-9).unsqueeze(-1)
    return topg, topi


def aux_loss(gates: torch.Tensor, logits: torch.Tensor,
             top1_mask: torch.Tensor, aux_weight: float,
             z_weight: float) -> torch.Tensor:
    """Per node ``[K]``: Switch's load balance ``E · Σ_e f_e · p_e`` (f the
    top-1 fraction, p the mean router probability) weighted by
    ``aux_weight``, plus the router z-loss weighted by ``z_weight``; f32.
    gates, logits, top1_mask ``[K, S, E]``."""
    e = gates.shape[-1]
    f = top1_mask.mean(dim=1)
    p = gates.mean(dim=1)
    balance = e * (f * p).sum(dim=-1)
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean(dim=1)
    return aux_weight * balance + z_weight * z


def _group_sizes(e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """``[K, E]`` int32 counts of each expert id in e ``[K, N]``, on the
    device (a comparison and a sum: no bincount, nothing read back)."""
    ar = torch.arange(n_experts, device=e.device)
    return (e[..., None] == ar).sum(dim=-2, dtype=torch.int32)


def grouped_dot_chunked(xs: torch.Tensor, w: torch.Tensor,
                        sorted_e: torch.Tensor,
                        chunk_rows: int) -> torch.Tensor:
    """K nodes' expert-sorted rows xs ``[K, N, C]`` times their experts w
    ``[K, E, C, H]`` (``sorted_e`` ``[K, N]``, each node's expert ids in
    ascending order) → ``[K, N, H]``: one grouped matmul over K·E groups,
    or with ``0 < chunk_rows < N`` one a block of ``chunk_rows`` rows a
    node, each node padded with rows of expert E−1 (a contiguous slice of
    sorted rows is sorted, so each block is a grouped matmul of its own)."""
    k, n, c = xs.shape
    e, h = w.shape[1], w.shape[-1]
    wf = w.reshape(k * e, c, h)

    def one(x_c, e_c):
        rows = x_c.shape[1]
        return grouped_dot(x_c.reshape(k * rows, c), wf,
                           _group_sizes(e_c, e).reshape(-1)).view(k, rows, h)

    if chunk_rows <= 0 or n <= chunk_rows:
        return one(xs, sorted_e)
    pad = (-n) % chunk_rows
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        sorted_e = torch.cat([sorted_e, sorted_e.new_full((k, pad), e - 1)],
                             dim=1)
    outs = [one(xs[:, i:i + chunk_rows], sorted_e[:, i:i + chunk_rows])
            for i in range(0, n + pad, chunk_rows)]
    return torch.cat(outs, dim=1)[:, :n]


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


def _ragged(p, xf, gates, k: int, chunk_rows: int):
    """Sort-based dispatch: ``[K, S, C]`` out and the top-1 expert."""
    kn, s, c = xf.shape
    e = gates.shape[-1]
    topg, topi = _topk_gates(gates, k)                          # [K, S, k]
    node = torch.arange(kn, device=xf.device).view(kn, 1, 1)
    gid = (topi + node * e).reshape(-1)                       # [K·S·k]
    # stable: rows of one expert keep their token order, and node n's rows
    # come before node n+1's
    order = torch.argsort(gid, stable=True)
    sorted_gid = gid[order]
    xrep = xf.reshape(kn * s, 1, c).expand(kn * s, k, c).reshape(-1, c)
    xs = xrep[order].view(kn, s * k, c)
    local_e = (sorted_gid.view(kn, s * k) - node.view(kn, 1) * e)
    h = grouped_dot_chunked(xs, p["fc_kernel"], local_e, chunk_rows)
    h = h.reshape(kn * s * k, -1)
    if "fc_bias" in p:
        h = h + p["fc_bias"].reshape(kn * e, -1)[sorted_gid]
    h = _gelu(h).view(kn, s * k, -1)
    ye = grouped_dot_chunked(h, p["proj_kernel"], local_e, chunk_rows)
    ye = ye.reshape(kn * s * k, c)
    if "proj_bias" in p:
        ye = ye + p["proj_bias"].reshape(kn * e, c)[sorted_gid]
    gate_rows = topg.reshape(-1)[order].to(ye.dtype)
    ye = ye * gate_rows[:, None]
    # each token's k rows, found through the inverse permutation and added
    # in their sorted order (ascending expert), as the JAX segment sum
    # visits them
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    pos = torch.sort(inv.view(kn * s, k), dim=-1).values
    y = ye[pos[:, 0]]
    for j in range(1, k):
        y = y + ye[pos[:, j]]
    return y.view(kn, s, c), topi[..., 0]


def _dense(p, xf, gates, k: int):
    """Every expert on every token, combined with the top-k gates."""
    e = gates.shape[-1]
    topg, topi = _topk_gates(gates, k)
    w = (F.one_hot(topi, e).float() * topg[..., None]).sum(dim=-2)
    h = torch.einsum("ksc,kech->kesh", xf, p["fc_kernel"])
    if "fc_bias" in p:
        h = h + p["fc_bias"][:, :, None, :]
    h = _gelu(h)
    ye = torch.einsum("kesh,kehm->kesm", h, p["proj_kernel"])
    if "proj_bias" in p:
        ye = ye + p["proj_bias"][:, :, None, :]
    y = torch.einsum("kse,kesm->ksm", w.to(xf.dtype), ye)
    return y, topi[..., 0]


def _einsum(p, xf, gates, k: int, capacity_factor: float):
    """GShard's capacity-limited dispatch: tokens past an expert's
    ``ceil(capacity_factor · S · k / E)`` slots (at most S) are dropped,
    earlier rounds of the top-k first."""
    kn, s, _ = xf.shape
    e = gates.shape[-1]
    cap = min(int(math.ceil(capacity_factor * s * k / e)), s)
    slots = torch.arange(cap, device=xf.device)
    remaining = gates
    offset = torch.zeros(kn, e, dtype=torch.int64, device=xf.device)
    dispatch = torch.zeros(kn, s, e, cap, device=xf.device)
    combine = torch.zeros_like(dispatch)
    gate_sum = torch.zeros(kn, s, device=xf.device)
    top1 = None
    for r in range(k):
        idx = torch.argmax(remaining, dim=-1)
        mask = F.one_hot(idx, e)                                # [K, S, E]
        if r == 0:
            top1 = idx
        gate_r = (gates * mask).sum(dim=-1)
        # a token's 0-based slot in its expert, after the earlier rounds'
        pos = torch.cumsum(mask, dim=1) - mask + offset[:, None, :]
        pos_tok = (pos * mask).sum(dim=-1)
        keep = (pos_tok < cap).long()
        disp = ((mask * keep[..., None])[..., None]
                * (pos_tok[..., None] == slots)[:, :, None, :]).float()
        dispatch = dispatch + disp
        combine = combine + disp * gate_r[..., None, None]
        gate_sum = gate_sum + gate_r * keep.float()
        offset = offset + (mask * keep[..., None]).sum(dim=1)
        remaining = remaining * (1.0 - mask.to(gates.dtype))
    if k > 1:
        combine = combine / torch.clamp(gate_sum, min=1e-9)[..., None, None]
    dt = xf.dtype
    xe = torch.einsum("ksec,ksm->kecm", dispatch.to(dt), xf)
    h = torch.einsum("kecm,kemh->kech", xe, p["fc_kernel"])
    if "fc_bias" in p:
        h = h + p["fc_bias"][:, :, None, :]
    h = _gelu(h)
    ye = torch.einsum("kech,kehm->kecm", h, p["proj_kernel"])
    if "proj_bias" in p:
        ye = ye + p["proj_bias"][:, :, None, :]
    y = torch.einsum("ksec,kecm->ksm", combine.to(dt), ye)
    return y, top1


def layer_params(params: Dict[str, torch.Tensor],
                 name: str) -> Dict[str, torch.Tensor]:
    """The MoE leaves under ``name`` (``h_1.moe``; "" for a bare layer),
    keyed ``router``, ``fc_kernel``, … ."""
    pre = f"{name}." if name else ""
    out = {"router": params[f"{pre}router.kernel"]}
    for leaf in EXPERT_LEAVES:
        if f"{pre}{leaf}" in params:
            out[leaf] = params[f"{pre}{leaf}"]
    return out


def moe_mlp(params: Dict[str, torch.Tensor], name: str, x: torch.Tensor, *,
            topk: int = 2, capacity_factor: float = 1.25,
            aux_weight: float = 1e-2, z_weight: float = 1e-3,
            impl: str = "auto", chunk_rows: int = 16384,
            rows: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE MLP of K nodes: x ``[K, ..., C]`` → ``(y, aux)``, y in x's
    shape and dtype, aux ``[K]`` the weighted auxiliary loss (f32; None
    under ``rows``, the decode form, which also takes one model's
    parameters, no node dimension, and x ``[b, t, C]`` in f32)."""
    p = layer_params(params, name)
    if rows:
        p = {n: w[None] for n, w in p.items()}
        x = x[None]
    kn, c = x.shape[0], x.shape[-1]
    e = p["router"].shape[-1]
    if not 1 <= topk <= e:
        raise ValueError(f"topk={topk} must be in [1, n_experts={e}]")
    impl = resolve_impl(impl)
    xf = x.reshape(kn, -1, c)
    if rows:
        logits = row_linear(xf[0], p["router"][0])[None]
        gates = _softmax_rows(logits)
    else:
        logits = torch.bmm(xf, p["router"]).float()
        gates = torch.softmax(logits, dim=-1)
    if impl == "ragged":
        y, top1 = _ragged(p, xf, gates, topk, chunk_rows)
    elif impl == "dense":
        y, top1 = _dense(p, xf, gates, topk)
    else:
        y, top1 = _einsum(p, xf, gates, topk, capacity_factor)
    y = y.reshape(x.shape)
    if rows:
        return y[0], None
    mask = F.one_hot(top1, e).float()
    return y, aux_loss(gates, logits, mask, aux_weight, z_weight)


def is_expert_stacked(name: str) -> bool:
    """A leaf with an expert dimension (the MoE experts' weights and
    biases; the router is not)."""
    parts = name.split(".")
    return "moe" in parts[:-1] and parts[-1] in EXPERT_LEAVES


def moe_active_params(params: Dict[str, torch.Tensor], topk: int,
                      n_experts: int) -> int:
    """One model's parameter count weighted by activation: expert-stacked
    leaves at ``topk / n_experts`` of their size, everything else whole
    (the N of an MoE config's MFU)."""
    total = 0.0
    for name, p in params.items():
        frac = topk / n_experts if is_expert_stacked(name) else 1.0
        total += frac * p.numel()
    return int(total)
