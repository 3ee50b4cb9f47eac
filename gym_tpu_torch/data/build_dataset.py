"""Token streams for the GPT examples (counterpart of
``gym_tpu/data/build_dataset.py``): the reference's fixed 66-token
character vocabulary and the offline ``docs`` corpus
(``offline.build_docs_corpus``), sliced by ``[start_pc, end_pc)`` and
cached as ``.npy``.

The slice cache is keyed on the corpus roots as well as the block size and
range, so slices of corpora built from different roots never mix (the JAX
package keys it without the roots). The HuggingFace corpora (shakespeare,
wikitext, code), their synthetic offline stand-ins and OpenWebText belong
to a later slice of the port and raise.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .offline import (DEFAULT_DOC_ROOTS, build_docs_corpus, roots_key,
                      save_atomic)

# The reference's fixed character vocabulary (build_dataset.py:8-21)
CHAR_VOCAB = (
    " !$&',-.3:;?ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "abcdefghijklmnopqrstuvwxyz\n"
)
DATASETS = ("shakespeare", "wikitext", "code", "docs", "owt")


def generate_char_vocab():
    char_int = {c: i for i, c in enumerate(CHAR_VOCAB)}
    eos_id = len(char_int)
    char_int["<EOS>"] = eos_id
    return char_int, eos_id


def char_vocab_size() -> int:
    return len(CHAR_VOCAB) + 1  # + <EOS> = 66


def _only_docs(dataset: str) -> None:
    if dataset not in DATASETS:
        raise ValueError(f"unknown dataset {dataset!r}; expected one of "
                         f"{'/'.join(DATASETS)}")
    if dataset != "docs":
        raise NotImplementedError(
            f"dataset {dataset!r} (a HuggingFace download or its synthetic "
            f"stand-in) is ported in a later slice of gym_tpu_torch; the "
            f"offline corpus here is 'docs'")


def build_dataset_small(
    dataset: str, block_size: int = 1024,
    start_pc: float = 0.0, end_pc: float = 1.0,
    data_root: str = "data", roots: Optional[Tuple[str, ...]] = None,
) -> Tuple[np.ndarray, int]:
    """(the ``[start_pc, end_pc)`` slice of the corpus's token stream, the
    vocabulary size)."""
    _only_docs(dataset)
    roots = tuple(DEFAULT_DOC_ROOTS if roots is None else roots)
    cache = os.path.join(
        data_root, f"{dataset}_char",
        f"data_block{block_size}_{start_pc}_{end_pc}_"
        f"{roots_key(roots):08x}.npy")
    vocab = char_vocab_size()
    if os.path.exists(cache):
        return np.load(cache), vocab
    full = build_docs_corpus(data_root, roots=roots)
    lo, hi = int(len(full) * start_pc), int(len(full) * end_pc)
    data = full[lo:hi]
    save_atomic(cache, data)
    return data, vocab


def get_dataset(
    dataset_name: str, block_size: int,
    start_pc: float = 0.0, end_pc: float = 1.0,
    max_chunks_in_memory: int = None, data_root: str = "data",
    roots: Optional[Tuple[str, ...]] = None,
):
    """(dataset, vocab_size): a ``ContiguousGPTTrainDataset`` over the
    slice."""
    from .gpt_datasets import ContiguousGPTTrainDataset

    data, vocab_size = build_dataset_small(
        dataset_name, block_size, start_pc, end_pc, data_root, roots)
    return ContiguousGPTTrainDataset(data, block_size), vocab_size
