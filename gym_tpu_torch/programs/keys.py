"""Canonical device-program keys (counterpart of ``gym_tpu/programs/
keys.py``).

A program is identified by ``(name × static config × input shapes/dtypes)``.
``program_key`` renders that descriptor as deterministic JSON plus its
sha256[:16] hash, the key the registry (``programs.registry``) stores a
program under. A CUDA graph holds device addresses, so the serving engine
puts its own identity into ``config``: two engines never share a graph.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


def _leaf_avals(tree: Any) -> List[Tuple[Tuple[int, ...], str]]:
    """``(shape, dtype)`` of every leaf of a nest of tensors, arrays or
    ``(shape, dtype)`` pairs (dicts in key order)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaf_avals(tree[k])]
    if (isinstance(tree, tuple) and len(tree) == 2
            and isinstance(tree[0], tuple)):
        return [(tuple(int(d) for d in tree[0]), str(tree[1]))]
    if isinstance(tree, (list, tuple)):
        return [a for leaf in tree for a in _leaf_avals(leaf)]
    shape = tuple(int(d) for d in getattr(tree, "shape", ()))
    dtype = getattr(tree, "dtype", np.float32)
    return [(shape, str(dtype))]


def _jsonable_config(config: Dict[str, Any]) -> Dict[str, str]:
    return {str(k): repr(v) for k, v in sorted(config.items())}


def program_key(name: str, config: Dict[str, Any],
                args: Sequence[Any]) -> Tuple[str, str]:
    """Canonical program key: ``(name × config × input shapes/dtypes)`` as
    a deterministic JSON string plus its sha256[:16] hash. Two programs
    whose keys hash equal are one registry entry."""
    desc = {
        "name": name,
        "config": _jsonable_config(config),
        "in_avals": [_leaf_avals(a) for a in args],
    }
    canon = json.dumps(desc, sort_keys=True, separators=(",", ":"))
    return canon, hashlib.sha256(canon.encode()).hexdigest()[:16]
