"""The port's offline data against the JAX package's, byte for byte.

- ``digits.csv.gz`` parses to scikit-learn's ``load_digits()`` images and
  targets (the JAX package reads the digits through scikit-learn, which the
  machine with the card does not have).
- ``load_digits_mnist`` train and val, and five calls of the crop stream,
  equal ``gym_tpu``'s; ``state``/``load_state`` replays the stream.
- ``build_docs_corpus`` over the checkout's ``gym_tpu/`` equals
  ``gym_tpu``'s over the same root: 279,562 tokens, crc32 1349009140 of the
  uint16 stream; ``get_dataset("docs")`` slices it as ``gym_tpu``'s does,
  and the slice cache is keyed on the roots.
"""

import pathlib
import zlib

import numpy as np
import pytest

import gym_tpu.data.build_dataset as jbuild
import gym_tpu.data.offline as joff
import gym_tpu_torch.data.build_dataset as tbuild
import gym_tpu_torch.data.offline as toff

ROOT = pathlib.Path(__file__).resolve().parents[1]
DOCS_TOKENS, DOCS_CRC = 279_562, 1349009140


def test_digits_csv_parses_as_sklearn():
    from sklearn.datasets import load_digits
    d = load_digits()
    images, target = toff.load_digits_csv()
    assert images.dtype == d.images.dtype and target.dtype == d.target.dtype
    np.testing.assert_array_equal(images, d.images)
    np.testing.assert_array_equal(target, d.target)
    assert images.shape == (1797, 8, 8)


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_load_digits_mnist_is_byte_equal(train):
    j, t = joff.load_digits_mnist(train), toff.load_digits_mnist(train)
    assert type(j).__name__ == type(t).__name__
    assert len(j) == len(t)
    for a, b in zip(j.arrays, t.arrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_crop_stream_is_byte_equal_and_replays():
    j, t = joff.load_digits_mnist(True), toff.load_digits_mnist(True)
    rng = np.random.default_rng(0)
    for _ in range(5):
        idx = rng.integers(0, len(j), 7)
        for a, b in zip(j.take(idx), t.take(idx)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert j.state() == t.state() == {"calls": 5}
    idx = np.arange(3)
    st = t.state()
    first = t.take(idx)
    t.load_state(st)
    assert all(a.tobytes() == b.tobytes()
               for a, b in zip(first, t.take(idx)))


def test_upscale_copy_matches():
    imgs = np.random.default_rng(1).random((3, 8, 8)).astype(np.float32)
    for size in (28, 13):
        assert joff._upscale(imgs, size).tobytes() == \
            toff._upscale(imgs, size).tobytes()


def test_docs_corpus_over_the_jax_package_is_byte_equal(tmp_path):
    roots = (str(ROOT / "gym_tpu"),)
    assert toff.DEFAULT_DOC_ROOTS == roots
    t = toff.build_docs_corpus(str(tmp_path / "t"))
    j = joff.build_docs_corpus(str(tmp_path / "j"), roots=roots)
    assert t.dtype == j.dtype == np.uint16
    assert t.tobytes() == j.tobytes()
    assert len(t) == DOCS_TOKENS
    assert zlib.crc32(t.tobytes()) == DOCS_CRC
    # read back from the cache
    assert toff.build_docs_corpus(str(tmp_path / "t")).tobytes() == \
        t.tobytes()


def test_docs_slices_match_and_cache_by_roots(tmp_path, monkeypatch):
    roots = (str(ROOT / "gym_tpu"),)
    monkeypatch.setattr(joff, "_DOC_ROOTS", roots)
    slices = {}
    for lo, hi in ((0.0, 0.9), (0.9, 1.0)):
        jd, jv = jbuild.build_dataset_small("docs", 64, lo, hi,
                                            str(tmp_path / "j"))
        ds, tv = tbuild.get_dataset("docs", 64, lo, hi,
                                    data_root=str(tmp_path / "t"))
        assert jv == tv == tbuild.char_vocab_size() == 66
        assert ds.data.tobytes() == jd.tobytes()
        slices[lo] = jd
    assert sum(len(d) for d in slices.values()) == DOCS_TOKENS
    # the same slice of another root's stream is built anew, not read
    # from the cache of the first
    other = (str(ROOT / "gym_tpu" / "strategy"),)
    d1, _ = tbuild.build_dataset_small("docs", 64, 0.0, 0.9,
                                       str(tmp_path / "t"), roots=other)
    assert 0 < len(d1) < len(slices[0.0])
    assert tbuild.CHAR_VOCAB == jbuild.CHAR_VOCAB
    assert tbuild.generate_char_vocab() == jbuild.generate_char_vocab()


@pytest.mark.parametrize("name", ["shakespeare", "wikitext", "code", "owt"])
def test_download_datasets_raise_naming_a_later_slice(name):
    with pytest.raises(NotImplementedError, match="later slice"):
        tbuild.get_dataset(name, 64)
    with pytest.raises(ValueError):
        tbuild.get_dataset("nope", 64)
