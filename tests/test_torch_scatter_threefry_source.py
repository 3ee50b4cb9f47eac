"""D1's and T1 bits rows' contracts held in their CUDA sources
(``scatter_mean.cu``, ``threefry.cu``), on the CPU: every kernel of the two
files is found and classified (the kernel of the main path, its oracle, or
a kernel left as it was); neither file's code holds an atomic or a
fast-math intrinsic, and the build passes no fast-math flag (D1's mean is
one IEEE division); D1's kernel waits at no block barrier and groups its
lanes by slot, T1 bits rows' kernel has no block barrier and no shared
memory (no lane waits for another's fold), and ``threefry_bits`` keeps its
20 rounds; both oracles have their C entries and card-only wrappers, which
refuse a CPU tensor as the sweep's wrappers do; the twins still serve the
CPU, and the tests that hold them to JAX are still there; every planted
fault (``scripts/d1_faults.py``, the rows' faults of
``scripts/flash_f32_faults.py``) plants exactly once, inside the body of
the kernel of the main path, and not into its oracle."""

import os
import re
import sys

import numpy as np
import pytest
import torch

import gym_tpu_torch.ops.scatter_mean as tsm
import gym_tpu_torch.ops.threefry as tf
from gym_tpu_torch.ops import _build

CSRC = os.path.join(os.path.dirname(tsm.__file__), "csrc")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import d1_faults  # noqa: E402
import flash_f32_faults  # noqa: E402

# file: {kernel: its class}
KERNELS = {
    "scatter_mean.cu": {"scatter_mean_kernel": "new",
                        "scatter_mean_ref_kernel": "oracle"},
    "threefry.cu": {"threefry_rows_bits_kernel": "new",
                    "threefry_rows_bits_ref_kernel": "oracle",
                    "threefry_kernel": "as it was",
                    "threefry_segments_kernel": "as it was"},
}
FORBIDDEN = ("atomic", "__fdividef", "__frcp", "__fsqrt", "__expf", "__logf",
             "__fmul_rz", "__fadd_rz", "__fdiv_r", "__powf", "__sinf",
             "__cosf", "fast_math")
ENTRIES = {"scatter_mean.cu": ("gym_scatter_mean", "gym_scatter_mean_ref",
                               "gym_scatter_mean_plan"),
           "threefry.cu": ("gym_threefry_bits_rows",
                           "gym_threefry_bits_rows_ref")}


def _raw(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _code(name: str) -> str:
    """The file without its comments: they name what the code does not."""
    text = re.sub(r"//[^\n]*", "", _raw(name))
    return re.sub(r"/\*.*?\*/", "", text, flags=re.S)


def _close(text: str, i: int, left: str, right: str) -> int:
    depth = 0
    for k in range(i, len(text)):
        depth += {left: 1, right: -1}.get(text[k], 0)
        if depth == 0:
            return k + 1
    raise AssertionError("unbalanced brackets")


def _span(text: str, name: str):
    """(start, end) of the function ``name``'s definition in ``text``."""
    for m in re.finditer(r"\b" + name + r"\s*\(", text):
        after = _close(text, m.end() - 1, "(", ")")
        if text[after:].lstrip().startswith("{"):
            brace = text.index("{", after)
            return m.start(), _close(text, brace, "{", "}")
    raise AssertionError(f"no definition of {name}")


def _body(text: str, name: str) -> str:
    a, b = _span(text, name)
    return text[a:b]


@pytest.mark.parametrize("src", sorted(KERNELS))
def test_every_kernel_of_the_file_is_classified(src):
    text = _code(src)
    found = set()
    for m in re.finditer(r"__global__", text):
        head = text[m.end():text.index("{", m.end())]
        found.add(next(n for n in re.findall(r"(\w+)\s*\(", head)
                       if not n.startswith("__")))
    assert found == set(KERNELS[src])


@pytest.mark.parametrize("src", sorted(KERNELS))
def test_no_atomic_or_fast_math_in_the_code(src):
    text = _code(src)
    for word in FORBIDDEN:
        assert word not in text, f"{src}: {word}"


def test_the_build_passes_no_fast_math_flag():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags
    assert "prec-div=false" not in flags and "ftz=true" not in flags


def test_d1_kernel_groups_lanes_by_slot_with_no_block_barrier():
    """No block barrier and no atomic in the walk; lanes grouped by slot
    and their values moved by shuffles; the mean one IEEE division of the
    sum by the count, 0 where the count is 0; each sum starts at 0.0f."""
    body = _body(_code("scatter_mean.cu"), "scatter_mean_kernel")
    assert "__syncthreads" not in body
    for word in ("__match_any_sync", "__shfl_sync", "__ballot_sync",
                 "__syncwarp"):
        assert word in body, word
    assert "s.count > 0 ? s.sum / (float)s.count : 0.0f" in body
    assert "w_slot[i] = Slot{0.0f, 0};" in body
    # a pick, or a group's values one by one, onto the running sum: one f32
    # add each
    assert "s.sum += v[b];" in body and "s.sum += x;" in body


def test_t1_rows_kernel_waits_for_no_other_lane():
    """No block barrier and no shared memory: every lane folds its row's
    key; threefry_bits keeps its 20 rounds (the bound counts them)."""
    text = _code("threefry.cu")
    body = _body(text, "threefry_rows_bits_kernel")
    assert "__syncthreads" not in body and "__shared__" not in body
    assert "threefry_pair(" in body and "uint4" in body
    rounds = _body(text, "threefry_bits").count("GYM_TF_ROUND(")
    assert rounds == 20


@pytest.mark.parametrize("src,entry", [(s, e) for s in sorted(ENTRIES)
                                       for e in ENTRIES[s]])
def test_c_entries_exist(src, entry):
    assert re.search(r"\bint " + entry + r"\(", _code(src))


def _picks():
    return (torch.tensor([[0, 3, 3, 1]], dtype=torch.int32),
            torch.tensor([[1.0, 2.0, -2.0, 0.5]]))


@pytest.mark.parametrize("which", ["scatter_mean_decode_ref",
                                   "scatter_mean_decode_tuned",
                                   "random_bits_rows_ref",
                                   "random_bits_rows_tuned"])
def test_card_only_wrappers_refuse_cpu_tensors(which):
    """The oracles and the sweep's launches run on the card only: the
    CPU's path is the twin, which the card checks hold them to."""
    idx, val = _picks()
    keys = tf.key_tensor([tf.PRNGKey(1)], "cpu")
    call = {"scatter_mean_decode_ref": lambda: tsm.scatter_mean_decode_ref(
                idx, val, 4),
            "scatter_mean_decode_tuned":
                lambda: tsm.scatter_mean_decode_tuned(idx, val, 4, 64, 4),
            "random_bits_rows_ref": lambda: tf.random_bits_rows_ref(
                keys, None, 5),
            "random_bits_rows_tuned": lambda: tf.random_bits_rows_tuned(
                keys, None, 5, 2, 64, 8)}[which]
    with pytest.raises(ValueError, match="cuda"):
        call()


def test_twins_still_serve_the_cpu():
    idx, val = _picks()
    before = tsm.scatter_mean_decode.launches
    out = tsm.scatter_mean_decode(idx, val, 4)
    assert tsm.scatter_mean_decode.launches == before
    assert torch.equal(out, tsm.plain_scatter_mean_decode(idx, val, 4))
    assert out.tolist() == [[1.0, 0.5, 0.0, 0.0]]
    keys = tf.key_tensor([tf.PRNGKey(i) for i in range(3)], "cpu")
    data = torch.tensor([0, 7, 2 ** 31 - 1], dtype=torch.int32)
    before = tf.random_bits_rows.launches
    for d in (data, None):
        got = tf.random_bits_rows(keys, d, 7)
        assert torch.equal(got, tf.plain_random_bits_rows(keys, d, 7))
        for r in range(3):
            key = tf.PRNGKey(r) if d is None else tf.fold_in(
                tf.PRNGKey(r), int(d[r]))
            assert np.array_equal(got[r].numpy(),
                                  tf.plain_random_bits(key, 7).numpy())
    assert tf.random_bits_rows.launches == before


@pytest.mark.parametrize("path,test,twin", [
    ("tests/test_torch_dct_topk.py",
     "test_scatter_mean_twin_matches_jax_bit_for_bit",
     "plain_scatter_mean_decode"),
    ("tests/test_torch_decode.py", "test_categorical_bits_match_jax",
     "random_bits_rows")])
def test_the_twins_are_still_held_to_jax(path, test, twin):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    m = re.search(r"^def " + test + r"\(.*?(?=^def |\Z)", text, re.S | re.M)
    assert m, f"{path}: no {test}"
    assert twin + "(" in m.group(0) and "jax" in m.group(0)


def _faults():
    """(name, file, kernel, old, new) of every planted fault aimed at D1's
    or T1 bits rows' kernel."""
    out = [(n, "scatter_mean.cu", "scatter_mean_kernel", o, w)
           for n, (o, w) in d1_faults.FAULTS.items()]
    for n, (_, edits) in flash_f32_faults.FAULTS.items():
        if n.startswith("rows_"):
            out += [(n, f, "threefry_rows_bits_kernel", o, w)
                    for f, o, w in edits]
    return out


def test_every_new_kernel_has_its_faults():
    kernels = [k for _, _, k, _, _ in _faults()]
    assert kernels.count("scatter_mean_kernel") == 4
    assert kernels.count("threefry_rows_bits_kernel") == 2


@pytest.mark.parametrize("name,src,kernel,old,new", _faults(),
                         ids=[f[0] for f in _faults()])
def test_each_fault_plants_once_inside_the_new_kernel(name, src, kernel, old,
                                                      new):
    text = _raw(src)
    assert text.count(old) == 1, name
    a, b = _span(text, kernel)
    at = text.index(old)
    assert a <= at < at + len(old) <= b, f"{name} plants outside {kernel}"
    oracle = {"scatter_mean_kernel": "scatter_mean_ref_kernel",
              "threefry_rows_bits_kernel": "threefry_rows_bits_ref_kernel"}
    planted = text.replace(old, new)
    assert new != old
    assert _body(planted, oracle[kernel]) == _body(text, oracle[kernel])
