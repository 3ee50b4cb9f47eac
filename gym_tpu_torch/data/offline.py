"""Offline datasets: real handwritten digits and English prose, with no
download (counterpart of ``gym_tpu/data/offline.py``, pinned to it byte for
byte by ``tests/test_torch_offline_data.py``).

- ``load_digits_mnist``: the 1,797 8×8 handwritten digits of the UCI
  "Optical Recognition of Handwritten Digits" test set, read from
  ``digits.csv.gz`` beside this module (the copy that ships with
  scikit-learn, BSD-3-Clause; one row a digit, 64 pixels in 0..16 then the
  label, parsed with numpy as scikit-learn's ``load_digits`` parses it),
  upscaled to the CNN's 28×28 input and normalised MNIST-style; the train
  split is random-crop augmented (``CropAugmentedDataset``).
- ``build_docs_corpus``: a character-token stream (the 66-token vocabulary
  of ``build_dataset.py``) of the ``*.md``/``*.rst`` files and Python
  docstrings under ``roots``. Its default root is the checkout's JAX
  package, ``gym_tpu/``, read as text and never imported, so every machine
  with the checkout builds the same stream.
"""

from __future__ import annotations

import ast
import glob
import gzip
import os
import sys
import zlib
from typing import Optional, Tuple

import numpy as np

from .sampler import ArrayDataset

_HERE = os.path.dirname(os.path.abspath(__file__))
DIGITS_CSV = os.path.join(_HERE, "digits.csv.gz")
# the checkout's JAX package: text present wherever the checkout is
DEFAULT_DOC_ROOTS = (os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                                  "gym_tpu"),)


def _log(msg: str):
    print(f"[gym_tpu_torch.data.offline] {msg}", file=sys.stderr)


# -- real digit images ------------------------------------------------------


def load_digits_csv(path: str = DIGITS_CSV) -> Tuple[np.ndarray, np.ndarray]:
    """(images [1797, 8, 8] float64 in 0..16, targets [1797] int): what
    ``sklearn.datasets.load_digits()`` returns as ``images`` and ``target``,
    from the same gzip-compressed CSV."""
    with gzip.open(path, mode="rt", encoding="utf-8") as f:
        data = np.loadtxt(f, delimiter=",")
    target = data[:, -1].astype(int)
    images = data[:, :-1].reshape(-1, 8, 8)
    return images, target


def _upscale(imgs: np.ndarray, size: int) -> np.ndarray:
    """Separable bilinear [N, H, H] -> [N, size, size], edge-clamped
    (align_corners=False convention)."""
    n, h, _ = imgs.shape
    src = (np.arange(size) + 0.5) * h / size - 0.5
    lo_f = np.floor(src).astype(np.int64)
    frac = (src - lo_f).astype(np.float32)
    lo = np.clip(lo_f, 0, h - 1)
    hi = np.clip(lo_f + 1, 0, h - 1)  # == lo at the edges → clamp
    rows = (imgs[:, lo, :] * (1 - frac)[None, :, None]
            + imgs[:, hi, :] * frac[None, :, None])       # [n, size, h]
    out = (rows[:, :, lo] * (1 - frac)[None, None, :]
           + rows[:, :, hi] * frac[None, None, :])        # [n, size, size]
    return out.astype(np.float32)


class CropAugmentedDataset(ArrayDataset):
    """ArrayDataset whose ``take`` random-crops a ``size``×``size`` window
    out of pre-padded images (translate augmentation). Crops are
    deterministic given (seed, call #); the call counter is carried by
    ``state``/``load_state`` so a resumed run replays the same crops."""

    def __init__(self, padded_imgs: np.ndarray, labels: np.ndarray,
                 size: int, seed: int = 0):
        super().__init__(padded_imgs, labels)
        self.size = size
        self.margin = padded_imgs.shape[1] - size
        self.seed = seed
        self._calls = 0

    def take(self, idx: np.ndarray):
        imgs, labels = super().take(idx)
        n = len(idx)
        rng = np.random.default_rng((self.seed, self._calls))
        self._calls += 1
        oy = rng.integers(0, self.margin + 1, n)
        ox = rng.integers(0, self.margin + 1, n)
        rows = oy[:, None] + np.arange(self.size)          # [n, size]
        cols = ox[:, None] + np.arange(self.size)
        out = imgs[np.arange(n)[:, None, None],
                   rows[:, :, None], cols[:, None, :]]
        return out, labels

    def state(self) -> dict:
        return {"calls": self._calls}

    def load_state(self, st: dict) -> None:
        self._calls = int(st["calls"])


def load_digits_mnist(
    train: bool, img_size: int = 28, augment: Optional[bool] = None,
    pad: int = 3, val_fraction: float = 0.2, seed: int = 0,
):
    """Real handwritten digits as an MNIST-shaped ArrayDataset
    ([N, 28, 28, 1] float32 normalised, int32 labels in [0, 10)).

    The split is a seeded shuffle; ``augment`` defaults to True for train,
    False for val."""
    images, target = load_digits_csv()
    imgs = images.astype(np.float32) / 16.0           # [N, 8, 8] in [0, 1]
    labels = target.astype(np.int32)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(imgs))
    n_val = int(len(imgs) * val_fraction)
    sel = perm[n_val:] if train else perm[:n_val]
    imgs, labels = imgs[sel], labels[sel]

    big = _upscale(imgs, img_size)
    mean, std = 0.13, 0.3                              # MNIST-style scaling
    big = (big - mean) / std

    if augment is None:
        augment = train
    if augment:
        padded = np.pad(big, ((0, 0), (pad, pad), (pad, pad)),
                        constant_values=(0.0 - mean) / std)
        return CropAugmentedDataset(padded[..., None], labels, img_size,
                                    seed=seed + 1)
    return ArrayDataset(big[..., None], labels)


# -- real English text ------------------------------------------------------


def _iter_doc_texts(roots, min_bytes):
    """Yield text units in a fixed order: ``*.md``/``*.rst`` files first,
    then the docstrings (read with ``ast``, nothing imported) of ``*.py``
    sources."""
    md = []
    for root in roots:
        for pat in ("**/*.md", "**/*.rst"):
            md.extend(glob.glob(os.path.join(root, pat), recursive=True))
    for path in sorted(set(md)):
        try:
            if os.path.getsize(path) < min_bytes:
                continue
            with open(path, "r", encoding="utf-8", errors="ignore") as f:
                yield f.read()
        except OSError:
            continue

    py = []
    for root in roots:
        py.extend(glob.glob(os.path.join(root, "**/*.py"), recursive=True))
    for path in sorted(set(py)):
        try:
            if os.path.getsize(path) < min_bytes:
                continue
            with open(path, "r", encoding="utf-8", errors="ignore") as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError, ValueError):
            continue
        parts = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                doc = ast.get_docstring(node, clean=True)
                if doc and len(doc) > 80:
                    parts.append(doc)
        if parts:
            yield "\n\n".join(parts)


def save_atomic(path: str, data: np.ndarray) -> None:
    """``np.save`` through a file renamed into place, so that a concurrent
    reader never loads a half-written cache."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npy"
    np.save(tmp, data)
    os.replace(tmp, path)


def roots_key(roots) -> int:
    """crc32 of the roots, for cache names: a stream or slice built from
    other roots must not be read back as this one's."""
    return zlib.crc32(repr(tuple(roots)).encode()) & 0xFFFFFFFF


def build_docs_corpus(
    data_root: str = "data", min_bytes: int = 2048,
    max_total_chars: int = 8_000_000,
    roots: Optional[Tuple[str, ...]] = None,
) -> np.ndarray:
    """Char-token stream (66-token vocabulary, ``<EOS>`` between source
    units) of the documentation and docstrings under ``roots`` (default
    ``DEFAULT_DOC_ROOTS``). Cached under ``data_root/docs_char/`` by a key
    of every argument that changes its content."""
    from .build_dataset import generate_char_vocab

    roots = tuple(DEFAULT_DOC_ROOTS if roots is None else roots)
    cache_dir = os.path.join(data_root, "docs_char")
    key = zlib.crc32(
        repr((roots, min_bytes, max_total_chars)).encode()) & 0xFFFFFFFF
    cache = os.path.join(cache_dir, f"stream_{key:08x}.npy")
    if os.path.exists(cache):
        return np.load(cache)

    char_int, eos = generate_char_vocab()
    stream = []
    n_units = 0
    for text in _iter_doc_texts(roots, min_bytes):
        stream.extend(char_int[c] for c in text if c in char_int)
        stream.append(eos)
        n_units += 1
        if len(stream) >= max_total_chars:
            break
    if not stream:
        raise FileNotFoundError(
            f"no documentation found under {roots}; "
            f"cannot build the offline docs corpus")
    data = np.asarray(stream[:max_total_chars], np.uint16)
    save_atomic(cache, data)
    _log(f"built docs corpus: {n_units} source units, {len(data):,} tokens")
    return data
