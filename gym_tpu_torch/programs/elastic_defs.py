"""Redistribution programs for elastic membership changes (counterpart of
``gym_tpu/programs/elastic_defs.py``).

Resharding a checkpointed ZeRO layout from K nodes onto K' is a handful of
small programs over the flat parameter and moment vectors. They are
``ProgramDef``s so ``gym_tpu_torch.elastic`` acquires them through the
shared program registry (``programs/registry.py``): one entry a (K→K',
shapes, dtype) signature under its canonical key, and a second resume at
the same membership builds nothing (the registry's ``builds`` counter).

A reshard runs once a resume, on tensors restored from the host, so its
programs are eager torch functions: nothing is captured as a CUDA graph
(``captured`` is False), and they are no member of the serving engine's
family or its warmup. The JAX package computes the same index copies and
pads in plain ``jit``; no kernel is involved.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import torch

from .registry import ProgramDef

#: the registry config field that tells these programs apart from the
#: serving engine's
FAMILY = "elastic.reshard"


def elastic_shard_size(n: int, k: int) -> int:
    """ceil(n / k): ``strategy.sharding.shard_size`` of a flat length."""
    return -(-n // k)


def _eager(fn: Callable) -> Callable:
    """``fn`` as a registry program: run eagerly, never captured."""
    fn.captured = False
    return fn


def reshard_flat_def(n: int, k_from: int, k_to: int,
                     dtype: torch.dtype = torch.float32) -> ProgramDef:
    """[k_from, ceil(n/k_from)] flat shards → [k_to, ceil(n/k_to)]: drop the
    old pad tail, re-pad with zeros for the new shard size. One def covers
    every flat vector of the same (n, K→K', dtype): params, AdamW's mu and
    nu all reuse it."""
    s_from = elastic_shard_size(n, k_from)
    s_to = elastic_shard_size(n, k_to)

    def _build():
        def fn(shards: torch.Tensor) -> torch.Tensor:
            flat = shards.reshape(-1)[:n]
            return torch.nn.functional.pad(
                flat, (0, k_to * s_to - n)).reshape(k_to, s_to)
        return _eager(fn)

    return ProgramDef(
        name=f"elastic.reshard_flat[{k_from}->{k_to}]",
        config={"family": FAMILY, "n": n, "k_to": k_to},
        args=(((k_from, s_from), dtype),),
        builder=_build)


def replicate_rows_def(shape: Tuple[int, ...], k_from: int, k_to: int,
                       dtype: torch.dtype = torch.float32) -> ProgramDef:
    """[k_from, *shape] node-replicated state → [k_to, *shape]: row 0
    repeated onto the new membership (the caller, ``gym_tpu_torch.elastic``,
    checks that the rows are equal first)."""
    shape = tuple(int(d) for d in shape)

    def _build():
        def fn(x: torch.Tensor) -> torch.Tensor:
            return x[:1].repeat(k_to, *([1] * len(shape))).contiguous()
        return _eager(fn)

    return ProgramDef(
        name=f"elastic.replicate_rows[{k_from}->{k_to}]",
        config={"family": FAMILY, "k_to": k_to},
        args=(((k_from,) + shape, dtype),),
        builder=_build)


def unshard_params_def(leaf_specs: Sequence[Tuple[str, Tuple[int, ...],
                                                  torch.dtype]],
                       n: int, k_from: int, k_to: int) -> ProgramDef:
    """ZeRO-2 param shards [k_from, ceil(n/k_from)] (f32) → the stacked
    parameter dict ([k_to, *shape] a leaf, leaf dtypes restored).
    ``leaf_specs`` is ``[(name, per-node shape, dtype), ...]`` in the ravel
    order (``strategy.sharding.ravel_order``, JAX's leaf order), the order
    the shards were packed in."""
    s_from = elastic_shard_size(n, k_from)
    specs = [(name, tuple(int(d) for d in shape), dt)
             for name, shape, dt in leaf_specs]
    sig = ";".join(f"{name}{shape}:{dt}" for name, shape, dt in specs)

    def _build():
        def fn(shards: torch.Tensor):
            flat = shards.reshape(-1)[:n]
            out, off = {}, 0
            for name, shape, dt in specs:
                sz = int(math.prod(shape))
                leaf = flat[off:off + sz].reshape((1,) + shape).to(dt)
                out[name] = leaf.repeat(k_to, *([1] * len(shape)))
                off += sz
            return out
        return _eager(fn)

    return ProgramDef(
        name=f"elastic.unshard_params[{k_from}->{k_to}]",
        config={"family": FAMILY, "n": n, "k_to": k_to, "tree": sig},
        args=(((k_from, s_from), torch.float32),),
        builder=_build)


def elastic_program_defs() -> List[ProgramDef]:
    """The fixed small signatures ``gym_tpu``'s set covers (uneven K' both
    ways, a grow and a shrink of the replicate path, a ZeRO-2 unshard),
    over an 11-parameter tree that pads the last shard at every K."""
    specs: List[Tuple[str, Tuple[int, ...], Any]] = [
        ("b", (5,), torch.float32), ("w", (3, 2), torch.float32)]
    n = sum(int(math.prod(s)) for _, s, _ in specs)
    return [
        reshard_flat_def(n, 4, 3),
        reshard_flat_def(n, 3, 4),
        reshard_flat_def(n, 2, 3),
        replicate_rows_def((), 4, 3, torch.int32),
        replicate_rows_def((5,), 3, 4),
        unshard_params_def(specs, n, 4, 3),
    ]
