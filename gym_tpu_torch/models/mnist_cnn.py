"""MNIST CNN, the reference example's architecture (counterpart of
``gym_tpu/models/mnist_cnn.py``).

Two conv blocks, (3×3 SAME conv with bias → BatchNorm → ReLU) ×2 then 2×2
max-pool and Dropout(0.25) broadcast over H and W, at widths 64 and 128;
then Dense 256 → ReLU → Dropout(0.5) → Dense 10 and the mean softmax cross
entropy in f32. Parameters are a flat dict named as the flax tree flattened
with ``"."`` (``CNN_0.Conv_0.kernel``), each with the node dimension first;
conv kernels keep flax's HWIO layout ``[K, 3, 3, in, out]`` and dense kernels
``[K, in, out]``.

The K nodes run as one grouped convolution: activations are ``[B, K·C, H,
W]`` with node k's channels at ``k·C + c``, and each conv has ``groups=K``.
The convolutions and dense layers are XLA ops in the JAX package, not
Pallas kernels, so here they are cuDNN's and cuBLAS's; an f32 convolution
computes in full f32 on the card (TF32 off in its forward and backward)
whatever the caller's global flags. BatchNorm is flax's: per-node batch
statistics over (B, H, W) in f32 with the fast variance, running averages
``0.9·old + 0.1·batch`` of the biased variance, eps 1e-5. Dropout is flax's
(``base.dropout``): masks from the nodes' threefry keys folded with
``("CNN_0", "Dropout_i", 1)``, drawn on the card by the per-row T1 kernel.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import threefry
from .base import dropout, dropout_mask

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# (conv, batch norm, in channels, out channels); a pool and a spatial
# dropout follow every second conv
CONVS = (("Conv_0", "BatchNorm_0", 1, 64), ("Conv_1", "BatchNorm_1", 64, 64),
         ("Conv_2", "BatchNorm_2", 64, 128),
         ("Conv_3", "BatchNorm_3", 128, 128))
SPATIAL_DROPOUT = 0.25
DENSE_DROPOUT = 0.5
HIDDEN = 256
CLASSES = 10
IMG = 28
# flax's lecun_normal: a normal truncated to ±2 std, std sqrt(1/fan_in)
# divided by the std of a unit normal truncated there
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def _full_f32():
    """TF32 off for cuDNN while the block runs."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Conv3x3(torch.autograd.Function):
    """3×3 SAME grouped convolution, no bias; the forward and both backward
    products under ``_full_f32`` (the backward runs outside the forward's
    context, so it sets the flag again)."""

    @staticmethod
    def forward(ctx, x, w, groups):
        ctx.save_for_backward(x, w)
        ctx.groups = groups
        with _full_f32():
            return F.conv2d(x, w, padding=1, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _full_f32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                ctx.groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None


def _conv(params, name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """flax ``nn.Conv`` for K nodes on the grouped layout: the product, then
    the bias added to the rounded product as flax adds it."""
    w = params[f"{name}.kernel"]                       # [K, 3, 3, in, out]
    cout, cin = w.shape[-1], w.shape[-2]
    w = w.permute(0, 4, 3, 1, 2).reshape(k * cout, cin, 3, 3)
    y = _Conv3x3.apply(x, w, k)
    return y + params[f"{name}.bias"].reshape(1, k * cout, 1, 1)


def _batch_norm(params, name: str, x: torch.Tensor, stats: Dict, train: bool):
    """flax ``nn.BatchNorm(momentum=0.9)`` per node and channel on the
    grouped layout; returns (y, new running mean, new running var), the
    stats unchanged in eval. Promotions follow flax's: the statistics are
    f32, so with bf16 inputs y is normalised in f32 and returned in the
    inputs' dtype."""
    scale = params[f"{name}.scale"].reshape(1, -1, 1, 1)
    bias = params[f"{name}.bias"].reshape(1, -1, 1, 1)
    ra_mean, ra_var = stats[f"{name}.mean"], stats[f"{name}.var"]
    if train:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        k = ra_mean.shape[0]
        new_mean = (BN_MOMENTUM * ra_mean
                    + (1 - BN_MOMENTUM) * mean.detach().view(k, -1))
        new_var = (BN_MOMENTUM * ra_var
                   + (1 - BN_MOMENTUM) * var.detach().view(k, -1))
    else:
        mean, var = ra_mean.reshape(-1), ra_var.reshape(-1)
        new_mean, new_var = ra_mean, ra_var
    y = x - mean.view(1, -1, 1, 1)
    mul = torch.rsqrt(var.view(1, -1, 1, 1) + BN_EPS) * scale
    y = y * mul + bias
    out_dtype = torch.promote_types(torch.promote_types(x.dtype, scale.dtype),
                                    bias.dtype)
    return y.to(out_dtype), new_mean, new_var


def _dense(params, name: str, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense`` for K nodes: x [K, B, in] @ kernel [K, in, out],
    then the bias."""
    y = torch.bmm(x, params[f"{name}.kernel"])
    return y + params[f"{name}.bias"].unsqueeze(1)


class CNN:
    """The backbone under flax's scope ``prefix``: ``logits(params, x,
    train, keys, stats) -> (logits [K, B, 10], new stats)`` from images
    ``[K, B, 28, 28, 1]`` (NHWC)."""

    def __init__(self, prefix: str = "CNN_0"):
        self.prefix = prefix

    def param_specs(self) -> Dict[str, Tuple[Tuple[int, ...], Optional[int]]]:
        """{name: (per-node shape, fan_in of a lecun-normal kernel, or None
        for a constant)}, in flax's order."""
        p, specs = self.prefix, {}
        for conv, bn, cin, cout in CONVS:
            specs[f"{p}.{conv}.kernel"] = ((3, 3, cin, cout), 9 * cin)
            specs[f"{p}.{conv}.bias"] = ((cout,), None)
            specs[f"{p}.{bn}.scale"] = ((cout,), None)
            specs[f"{p}.{bn}.bias"] = ((cout,), None)
        flat = (IMG // 4) ** 2 * CONVS[-1][3]
        specs[f"{p}.Dense_0.kernel"] = ((flat, HIDDEN), flat)
        specs[f"{p}.Dense_0.bias"] = ((HIDDEN,), None)
        specs[f"{p}.Dense_1.kernel"] = ((HIDDEN, CLASSES), HIDDEN)
        specs[f"{p}.Dense_1.bias"] = ((CLASSES,), None)
        return specs

    def stat_names(self):
        return {f"{self.prefix}.{bn}.{s}": cout
                for _, bn, _, cout in CONVS for s in ("mean", "var")}

    def dropout_paths(self):
        return [(self.prefix, f"Dropout_{i}", 1) for i in range(3)]

    def logits(self, params, x, train: bool, keys, stats):
        k, b = x.shape[0], x.shape[1]
        p = self.prefix
        # [K, B, H, W, C] -> [B, K·C, H, W]
        h = x.permute(1, 0, 4, 2, 3).reshape(b, k * x.shape[-1], IMG, IMG)
        new_stats = {}
        for i, (conv, bn, _, cout) in enumerate(CONVS):
            h = _conv(params, f"{p}.{conv}", h, k)
            h, new_stats[f"{p}.{bn}.mean"], new_stats[f"{p}.{bn}.var"] = \
                _batch_norm(params, f"{p}.{bn}", h, stats, train)
            h = torch.relu(h)
            if i % 2:
                h = F.max_pool2d(h, 2)
                if train:
                    # Dropout2d: one draw a node, image and channel
                    keep = 1.0 - SPATIAL_DROPOUT
                    mask = dropout_mask(keys[i // 2], keep, (b, 1, 1, cout),
                                        h.device)
                    mask = mask.view(k, b, cout).transpose(0, 1).reshape(
                        b, k * cout, 1, 1)
                    h = torch.where(mask, h / keep, torch.zeros_like(h))
        # flatten each node's [B, H, W, C] as flax does
        c, s = CONVS[-1][3], h.shape[-1]
        h = h.view(b, k, c, s, s).permute(1, 0, 3, 4, 2).reshape(k, b, -1)
        h = torch.relu(_dense(params, f"{p}.Dense_0", h))
        h = dropout(h, DENSE_DROPOUT, keys[2] if train else None, train)
        return _dense(params, f"{p}.Dense_1", h), new_stats


class MnistLossModel(torch.nn.Module):
    """``forward(params, (imgs, labels), train, rng, state) -> (losses [K],
    new state)``: the mean cross entropy of each node's batch. ``imgs`` are
    ``[K, B, 28, 28, 1]`` (NHWC) or ``[K, B, 1, 28, 28]`` (NCHW), labels
    ``[K, B]``; ``state`` is ``{"batch_stats": {name: [K, C]}}``."""

    def __init__(self):
        super().__init__()
        self.cnn = CNN("CNN_0")

    def init_params(self, num_nodes: int, seed: int,
                    device) -> Dict[str, torch.Tensor]:
        """f32 parameters from ``seed``, identical on every node, with flax's
        initialisers: lecun-normal kernels, zero biases, BatchNorm scale 1
        and bias 0."""
        gen = torch.Generator().manual_seed(int(seed))
        lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2, 2))
        out = {}
        for name, (shape, fan_in) in self.cnn.param_specs().items():
            if fan_in is not None:
                # truncated normal by the inverse CDF of a uniform in range
                u = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                                dtype=torch.float64)
                z = math.sqrt(2) * torch.erfinv(2 * u - 1)
                w = (z * math.sqrt(1.0 / fan_in) / _TRUNC_STD).float()
            else:
                w = torch.full(shape, 1.0 if name.endswith(".scale") else 0.0)
            out[name] = w.to(device).unsqueeze(0).repeat(
                num_nodes, *([1] * len(shape))).contiguous()
        return out

    def init_state(self, num_nodes: int, device) -> Dict[str, Dict]:
        """flax's initial running stats: mean 0, var 1, per node."""
        return {"batch_stats": {
            n: torch.full((num_nodes, c), 1.0 if n.endswith(".var") else 0.0,
                          device=device)
            for n, c in self.cnn.stat_names().items()}}

    def forward(self, params, batch, train: bool = True,
                rng: Optional[np.ndarray] = None, state=None):
        imgs, labels = batch
        if imgs.dim() == 5 and imgs.shape[2] == 1:  # accept NCHW input
            imgs = imgs.permute(0, 1, 3, 4, 2)
        keys = None
        if train:
            if rng is None:
                raise ValueError("the CNN's dropout in train mode needs the "
                                 "nodes' keys (rng)")
            keys = threefry.fold_in_paths(rng, self.cnn.dropout_paths())
        logits, stats = self.cnn.logits(params, imgs, train, keys,
                                        state["batch_stats"])
        k, b = logits.shape[:2]
        ce = F.cross_entropy(logits.float().reshape(k * b, -1),
                             labels.reshape(-1).long(), reduction="none")
        return ce.view(k, b).mean(dim=1), {"batch_stats": stats}
