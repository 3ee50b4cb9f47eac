"""Token datasets for GPT training (reference ``example/nanogpt/gpt_dataset.py``).

Three shapes of token storage, each exposing the vectorized ``take`` used by
the node batch iterator (the torch versions are __getitem__-per-row):

- ``ContiguousGPTTrainDataset`` — sliding window over a 1-D token stream
  (reference ``gpt_dataset.py:134-153``);
- ``NonContiguousGPTTrainDataset`` — independent fixed-length rows
  (``gpt_dataset.py:6-25``);
- ``LazyNonContiguousGPTTrainDataset`` — numbered chunk files loaded with an
  LRU cache (``gpt_dataset.py:28-131``) for OpenWebText-scale data.

All return ``(x, y)`` with y the next-token shift of x. A copy of
``gym_tpu/data/gpt_datasets.py`` with a numpy window gather in place of the
native one; the same indices give byte-equal batches, pinned by
``tests/test_torch_isolation.py``.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np


class ContiguousGPTTrainDataset:
    def __init__(self, data: np.ndarray, block_size: int):
        data = np.ascontiguousarray(np.asarray(data))
        if data.ndim != 1:
            raise ValueError(
                f"ContiguousGPTTrainDataset needs a 1-D token stream, got "
                f"shape {data.shape}")
        self.data = data
        self.block_size = int(block_size)

    def __len__(self) -> int:
        return max(0, self.data.shape[0] - self.block_size - 1)

    def take(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(idx, np.int64)
        if len(idx) and (int(idx.min()) < 0 or int(idx.max())
                         + self.block_size + 1 > len(self.data)):
            raise IndexError(
                f"window index range [{int(idx.min())}, {int(idx.max())}] + "
                f"block {self.block_size} exceeds {len(self.data)} tokens")
        win = self.data[idx[:, None] + np.arange(self.block_size + 1)]
        return win[:, :-1].astype(np.int32), win[:, 1:].astype(np.int32)

    def __getitem__(self, i: int):
        x, y = self.take(np.array([i]))
        return x[0], y[0]


class NonContiguousGPTTrainDataset:
    def __init__(self, data: np.ndarray):
        data = np.asarray(data)
        if data.ndim != 2:
            raise ValueError(
                f"NonContiguousGPTTrainDataset needs [n, block+1] rows, "
                f"got shape {data.shape}")
        self.data = data

    def __len__(self) -> int:
        return self.data.shape[0]

    def take(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        rows = self.data[np.asarray(idx)]
        return rows[:, :-1].astype(np.int32), rows[:, 1:].astype(np.int32)

    def __getitem__(self, i: int):
        x, y = self.take(np.array([i]))
        return x[0], y[0]


class LazyNonContiguousGPTTrainDataset:
    """Rows stored as ``chunk_<id>.npy`` files; chunks load on demand into an
    LRU cache bounded by ``max_chunks_in_memory``."""

    def __init__(self, chunk_ids: Sequence[int], cache_location: str,
                 max_chunks_in_memory: Optional[int] = None):
        self.chunk_ids = list(chunk_ids)
        self.cache_location = cache_location
        self.max_chunks = max_chunks_in_memory or 8
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        # global index -> (chunk_id, local row)
        self._rows_per_chunk = {}
        self._offsets = []
        total = 0
        for cid in self.chunk_ids:
            n = self._chunk_len(cid)
            self._rows_per_chunk[cid] = n
            self._offsets.append(total)
            total += n
        self._total = total
        self._offsets = np.asarray(self._offsets)

    def _chunk_path(self, cid: int) -> str:
        return os.path.join(self.cache_location, f"chunk_{cid}.npy")

    def _chunk_len(self, cid: int) -> int:
        # mmap for cheap header-only length read
        return np.load(self._chunk_path(cid), mmap_mode="r").shape[0]

    def _load(self, cid: int) -> np.ndarray:
        if cid in self._cache:
            self._cache.move_to_end(cid)
            return self._cache[cid]
        arr = np.load(self._chunk_path(cid))
        self._cache[cid] = arr
        if len(self._cache) > self.max_chunks:
            self._cache.popitem(last=False)
        return arr

    def __len__(self) -> int:
        return self._total

    def take(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(idx)
        which = np.searchsorted(self._offsets, idx, side="right") - 1
        rows = np.empty((len(idx),), object)
        for pos, (gi, ci) in enumerate(zip(idx, which)):
            cid = self.chunk_ids[ci]
            local = gi - self._offsets[ci]
            rows[pos] = self._load(cid)[local]
        data = np.stack(list(rows))
        return data[:, :-1].astype(np.int32), data[:, 1:].astype(np.int32)

    def __getitem__(self, i: int):
        x, y = self.take(np.array([i]))
        return x[0], y[0]
