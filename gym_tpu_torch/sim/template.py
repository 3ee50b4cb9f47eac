"""The per-node parameter template the network simulator prices.

``Strategy.comm_events`` reads a per-node parameter tree for its shapes and
dtypes only (and SPARTA draws its masks on the template's device). The JAX
package hands it ``ShapeDtypeStruct``s; here each leaf is one element of
the leaf's dtype expanded to the per-node shape: a tensor with the shape,
``numel()``, ``element_size()`` and device of the leaf and no storage of
its size, so a GPT-2 base template costs nothing to build or keep.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _dtype_of(x) -> torch.dtype:
    if torch.is_tensor(x):
        return x.dtype
    return torch.from_numpy(np.zeros(0, np.dtype(x.dtype))).dtype


def node_template(tree, device=None,
                  stacked: bool = False) -> Dict[str, torch.Tensor]:
    """``{name: storage-free tensor of the per-node shape and dtype}`` of a
    dict of tensors or numpy arrays. ``stacked=True`` drops the leading
    node dimension (a ``TrainState``'s ``[K, ...]`` params). ``device``
    defaults to the leaf's own (the CPU for numpy)."""
    out = {}
    for name, x in tree.items():
        shape = tuple(x.shape[1:] if stacked else x.shape)
        dev: Optional[torch.device] = (
            torch.device(device) if device is not None
            else (x.device if torch.is_tensor(x) else torch.device("cpu")))
        out[name] = torch.empty((), dtype=_dtype_of(x),
                                device=dev).expand(shape)
    return out
