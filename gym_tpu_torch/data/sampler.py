"""Per-node data sharding and batch assembly.

Reference semantics to preserve (SURVEY §3.6):
- shared dataset → ``DistributedSampler(num_replicas=K, rank=n)``: a seeded
  permutation shared by all nodes, node n takes slice ``perm[n::K]``,
  reshuffled each epoch (``exogym/trainer.py:263-274``);
- factory convention ``f(rank, num_nodes, is_val) -> dataset`` for per-node
  shards (``exogym/train_node.py:61-70``, ``README.md:144-160``);
- infinite iterators: epoch increments on exhaustion
  (``train_node.py:132-152``).

Host side produces one array per step with leading [K, ...] node axis —
the analog of K independent DataLoaders. A copy of
``gym_tpu/data/sampler.py`` (which is free of JAX but lives in a package
whose import pulls JAX in); the same seed gives byte-equal batches, pinned
by ``tests/test_torch_isolation.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple, Union

import numpy as np


class ArrayDataset:
    """Map-style dataset over aligned numpy arrays (fast vectorized take)."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays:
            raise ValueError("ArrayDataset needs at least one array")
        n = len(arrays[0])
        if not all(len(a) == n for a in arrays):
            raise ValueError(
                f"ArrayDataset arrays must be aligned: lengths "
                f"{[len(a) for a in arrays]}")
        self.arrays = tuple(np.asarray(a) for a in arrays)

    def __len__(self) -> int:
        return len(self.arrays[0])

    def take(self, idx: np.ndarray) -> Tuple[np.ndarray, ...]:
        return tuple(a[idx] for a in self.arrays)

    def __getitem__(self, i):
        item = tuple(a[i] for a in self.arrays)
        return item if len(item) > 1 else item[0]


class IndexedDataset:
    """Adapter for generic map-style datasets (e.g. torch-style
    ``__getitem__``/``__len__``); items are stacked per batch. Slow path —
    prefer ArrayDataset."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def take(self, idx: np.ndarray):
        items = [self.dataset[int(i)] for i in idx]
        first = items[0]
        if isinstance(first, (tuple, list)):
            return tuple(
                np.stack([np.asarray(it[j]) for it in items])
                for j in range(len(first))
            )
        return (np.stack([np.asarray(it) for it in items]),)


def as_dataset(obj):
    if hasattr(obj, "take") and hasattr(obj, "__len__"):
        return obj
    if hasattr(obj, "__getitem__") and hasattr(obj, "__len__"):
        return IndexedDataset(obj)
    raise TypeError(f"cannot interpret {type(obj)} as a dataset")


DatasetOrFactory = Union[Any, Callable[[int, int, bool], Any]]


def resolve_node_datasets(
    dataset: DatasetOrFactory, num_nodes: int, is_val: bool
) -> Tuple[list, bool]:
    """Resolve dataset-or-factory into per-node datasets.

    Returns (datasets, sharded): ``sharded=False`` means all nodes share one
    dataset and DistributedSampler-style index sharding applies
    (``exogym/trainer.py:263-274``).
    """
    if callable(dataset) and not hasattr(dataset, "__len__"):
        return (
            [as_dataset(dataset(n, num_nodes, is_val)) for n in range(num_nodes)],
            True,
        )
    ds = as_dataset(dataset)
    return [ds] * num_nodes, False


class NodeBatchIterator:
    """Infinite per-node minibatch stream with epoch reshuffling.

    Yields arrays shaped [K, n_micro, micro_bs, ...] per step (one grid of
    microbatches per node), the device-feed analog of the reference's
    grad-accumulation inner loop (``train_node.py:157-171``).
    """

    def __init__(
        self,
        datasets: Sequence,
        num_nodes: int,
        *,
        sharded: bool,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.datasets = list(datasets)
        self.num_nodes = num_nodes
        self.sharded = sharded
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._order: list[np.ndarray] = []
        self._pos = [0] * num_nodes
        self._reshuffle()

    def _reshuffle(self):
        self._order = []
        if self.sharded:
            for n, ds in enumerate(self.datasets):
                idx = np.arange(len(ds))
                if self.shuffle:
                    rng = np.random.default_rng(
                        (self.seed, self.epoch, n)
                    )
                    rng.shuffle(idx)
                self._order.append(idx)
        else:
            n_total = len(self.datasets[0])
            idx = np.arange(n_total)
            if self.shuffle:
                # Shared permutation (same seed on every node), then node n
                # takes perm[n::K] — DistributedSampler semantics.
                rng = np.random.default_rng((self.seed, self.epoch))
                rng.shuffle(idx)
            for n in range(self.num_nodes):
                self._order.append(idx[n :: self.num_nodes])
        self._pos = [0] * self.num_nodes

    def samples_per_node(self) -> int:
        return min(len(o) for o in self._order)

    def _next_indices(self, node: int, count: int) -> np.ndarray:
        out = []
        need = count
        while need > 0:
            order = self._order[node]
            avail = len(order) - self._pos[node]
            if avail <= 0:
                # epoch boundary: reshuffle everything (all nodes advance
                # epochs together in the lockstep loop, so a shared epoch
                # counter is safe)
                self.epoch += 1
                self._reshuffle()
                continue
            take = min(need, avail)
            out.append(order[self._pos[node] : self._pos[node] + take])
            self._pos[node] += take
            need -= take
        return np.concatenate(out) if len(out) > 1 else out[0]

    def next_batch(self, n_micro: int, micro_bs: int, nodes=None, out=None):
        """Fetch [K, n_micro, micro_bs, ...] arrays for one step.

        ``nodes``: in a multi-process world each host passes ITS node
        subset (mesh order) and gets [len(nodes), ...] arrays — only
        those nodes' data is materialized, but every node's index cursor
        still advances so epoch boundaries and the checkpointable
        iterator state stay identical on every host (the property that
        makes per-host data loading scale — reference
        ``DistributedSampler`` semantics at host granularity).

        ``out``: optional tuple of preallocated arrays (one per field,
        shaped [len(order), n_micro, micro_bs, ...]) filled in place —
        the prefetcher's assembly path, which skips the per-field
        ``np.stack`` allocation. Values written are identical to the
        allocating path's."""
        wanted = set(range(self.num_nodes) if nodes is None else nodes)
        order = list(range(self.num_nodes)) if nodes is None else list(nodes)
        per_node = {}
        for n in range(self.num_nodes):
            idx = self._next_indices(n, n_micro * micro_bs)
            if n not in wanted:
                continue
            arrs = self.datasets[n].take(idx)
            per_node[n] = tuple(
                a.reshape((n_micro, micro_bs) + a.shape[1:]) for a in arrs
            )
        n_fields = len(next(iter(per_node.values())))
        if out is not None:
            for j in range(n_fields):
                for row, n in enumerate(order):
                    out[j][row] = per_node[n][j]
            return tuple(out)
        return tuple(
            np.stack([per_node[n][j] for n in order])
            for j in range(n_fields)
        )

    def _unique_datasets(self):
        seen, out = set(), []
        for ds in self.datasets:
            if id(ds) not in seen:
                seen.add(id(ds))
                out.append(ds)
        return out

    def state(self) -> dict:
        st = {"epoch": self.epoch, "pos": list(self._pos)}
        ds_states = [
            ds.state() if hasattr(ds, "state") else None
            for ds in self._unique_datasets()
        ]
        if any(s is not None for s in ds_states):
            st["datasets"] = ds_states
        return st

    def load_state(self, st: dict):
        self.epoch = int(st["epoch"])
        self._reshuffle()
        self._pos = list(st["pos"])
        for ds, s in zip(self._unique_datasets(), st.get("datasets", [])):
            if s is not None and hasattr(ds, "load_state"):
                ds.load_state(s)
