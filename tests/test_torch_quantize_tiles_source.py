"""T1 bits' codec kernel (``csrc/quantize_tiles.cu``) held to its contract
in the source, on the CPU: its kernels found and classified; no atomic,
fast-math intrinsic, FMA, shared memory or block barrier; every rounding
step written as a correctly rounded IEEE intrinsic (``__fdiv_rn``,
``__fmul_rn``, ``__fadd_rn``, ``__fsub_rn``); ``threefry_bits`` with its 20
rounds; the library builds the file with no fast-math flag; the file passes
``scripts/cu_syntax.py``; ``QuantizeCodec.compress`` on a tensor off the
CPU reaches only the kernel's launch, with no fallback; the card-only
wrappers (the oracle and the first kernel's uncounted uniform) refuse a CPU
tensor; the plain version is still held to JAX; each planted fault of
``scripts/quantize_tiles_faults.py`` plants exactly once, inside the body of
``quantize_tiles_kernel``."""

import ast
import inspect
import os
import re
import subprocess
import sys

import pytest
import torch

import gym_tpu_torch.ops.quantize_tiles as qt
import gym_tpu_torch.ops.threefry as tf
from gym_tpu_torch.ops import _build
from gym_tpu_torch.strategy import compress

CSRC = os.path.join(os.path.dirname(qt.__file__), "csrc")
SRC = "quantize_tiles.cu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import quantize_tiles_faults  # noqa: E402

KERNELS = {"quantize_tiles_kernel": "the strategies' tile (256)",
           "quantize_tiles_any_kernel": "any tile, n and alignment"}
FORBIDDEN = ("atomic", "__fdividef", "__frcp", "__fsqrt", "__expf",
             "__logf", "__powf", "__sinf", "__cosf", "fast_math", "fmaf",
             "__fma", "_rz(", "_ru(", "_rd(", "__syncthreads", "__shared__",
             "__syncwarp", "bar.sync")


def _raw() -> str:
    with open(os.path.join(CSRC, SRC)) as f:
        return f.read()


def _code() -> str:
    """The file without its comments."""
    text = re.sub(r"//[^\n]*", "", _raw())
    return re.sub(r"/\*.*?\*/", "", text, flags=re.S)


def _close(text: str, i: int) -> int:
    """The index after the bracket that closes the one at ``i``."""
    left = text[i]
    right = {"(": ")", "{": "}"}[left]
    depth = 0
    for k in range(i, len(text)):
        depth += {left: 1, right: -1}.get(text[k], 0)
        if depth == 0:
            return k + 1
    raise AssertionError("unbalanced brackets")


def _span(text: str, name: str):
    """(start, end) of the function ``name``'s definition in ``text``."""
    for m in re.finditer(r"\b" + name + r"\s*\(", text):
        after = _close(text, m.end() - 1)
        if text[after:].lstrip().startswith("{"):
            return m.start(), _close(text, text.index("{", after))
    raise AssertionError(f"no definition of {name}")


def _body(text: str, name: str) -> str:
    a, b = _span(text, name)
    return text[a:b]


def test_every_kernel_of_the_file_is_classified():
    text = _code()
    found = set()
    for m in re.finditer(r"__global__", text):
        head = text[m.end():text.index("{", m.end())]
        found.add(next(n for n in re.findall(r"(\w+)\s*\(", head)
                       if not n.startswith("__")))
    assert found == set(KERNELS)


@pytest.mark.parametrize("word", FORBIDDEN)
def test_no_atomic_fast_math_fma_or_barrier(word):
    assert word not in _code(), word


@pytest.mark.parametrize("op", ["__fdiv_rn(x, scale)",
                                "__fmul_rn(amax, inv_qmax)",
                                "floorf(__fadd_rn(y, u))", "rintf(y)",
                                "__fsub_rn(__uint_as_float("])
def test_each_rounding_step_is_one_ieee_operation(op):
    assert op in _code(), op


def test_no_bare_float_arithmetic_in_the_rounding():
    """``quantize_one`` and ``tile_scale`` hold no ``*``, ``/``, ``+`` or
    ``-`` on floats outside the intrinsics (so ``nvcc`` has nothing to
    contract or reorder)."""
    text = _code()
    for fn in ("quantize_one", "tile_scale", "uniform_of"):
        body = _body(text, fn)
        body = body[body.index("{"):]
        assert not re.search(r"[^_\w](\w+)\s*[*/]\s*\w", body), fn
        assert not re.search(r"\w\s+[+]\s+\w", body), fn


def test_threefry_keeps_its_20_rounds():
    rounds = _body(_code(), "threefry_bits").count("GYM_TF_ROUND(")
    assert rounds == 20


def test_nan_propagating_max_and_nan_to_zero():
    text = _code()
    assert "(a > b || a != a) ? a : b" in _body(text, "nan_max")
    assert "if (r != r) return 0;" in _body(text, "quantize_one")
    for kernel in KERNELS:
        body = _body(text, kernel)
        assert "nan_max(" in body and "fmaxf(m" not in body, kernel


def test_the_library_builds_the_file_without_fast_math():
    assert os.path.join(CSRC, SRC) in _build.SOURCES
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags
    assert "prec-div=false" not in flags and "ftz=true" not in flags
    assert "fmad=false" not in flags    # no float a*b+c is left to contract
    assert re.search(r"\bint gym_quantize_tiles\(", _code())


def test_the_source_passes_cu_syntax():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "cu_syntax.py"),
         os.path.join(CSRC, SRC)], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_compress_off_the_cpu_reaches_only_the_kernel(monkeypatch):
    """A tensor off the CPU (a meta tensor stands in for the card's) goes
    from ``QuantizeCodec.compress`` to the kernel's launch and nowhere
    else: no plain version, no first-kernel draw a row, no fallback."""
    calls = []

    def launch(x, keys, qmax, tile, stochastic):
        calls.append((tuple(x.shape), keys, qmax, tile, stochastic))
        return "q", "scale"

    def refuse(*a, **k):
        raise AssertionError("left the kernel's path")

    monkeypatch.setattr(qt, "_launch", launch)
    monkeypatch.setattr(qt, "_check", lambda *a: None)
    for name in ("plain_quantize_tiles", "quantize_with",
                 "quantize_tiles_ref"):
        monkeypatch.setattr(qt, name, refuse)
    monkeypatch.setattr(tf, "random_bits", refuse)
    monkeypatch.setattr(tf, "uniform", refuse)
    before = qt.quantize_tiles.launches
    x = torch.empty(3, 1000, device="meta")
    key = tf.PRNGKey(1)
    for bits in (8, 4):
        codec = compress.QuantizeCodec(bits=bits)
        assert codec.compress(x, [key] * 3) == ("q", "scale")
    assert calls == [((3, 1000), [key] * 3, q, 256, True) for q in (127, 7)]
    assert qt.quantize_tiles.launches == before + 2


def test_no_fallback_in_the_card_path():
    """``quantize_tiles`` and ``_launch`` catch nothing and call no plain
    version; a failed launch raises (``_build.check``)."""
    for fn in (qt.quantize_tiles, qt._launch):
        tree = ast.parse(inspect.getsource(fn).lstrip())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    launch = inspect.getsource(qt._launch)
    assert "plain" not in launch and "_build.check(" in launch


@pytest.mark.parametrize("which", ["quantize_tiles_ref", "uniform_ref"])
def test_card_only_wrappers_refuse_cpu_tensors(which):
    x = torch.zeros(2, 300)
    call = {"quantize_tiles_ref": lambda: qt.quantize_tiles_ref(
                x, tf.PRNGKey(1), 127, 256),
            "uniform_ref": lambda: tf.uniform_ref(tf.PRNGKey(1), 5,
                                                  "cpu")}[which]
    with pytest.raises(ValueError, match="cuda"):
        call()


def test_the_plain_version_is_still_held_to_jax():
    with open(os.path.join(ROOT, "tests", "test_torch_quantize_tiles.py")) \
            as f:
        text = f.read()
    m = re.search(r"^def test_plain_quantize_tiles_is_jitted_jax\(.*?"
                  r"(?=^def |\Z)", text, re.S | re.M)
    assert m and "plain_quantize_tiles(" in m.group(0)
    assert "jit_compress(" in m.group(0) and "jax" in text


def test_every_fault_is_listed():
    assert sorted(quantize_tiles_faults.FAULTS) == sorted([
        "counter_off_by_one_tile", "nan_dropped_by_fmaxf",
        "scale_divided_by_qmax", "shared_key_read_with_row_stride"])


@pytest.mark.parametrize("name", sorted(quantize_tiles_faults.FAULTS))
def test_each_fault_plants_once_inside_the_kernel(name):
    old, new = quantize_tiles_faults.FAULTS[name]
    text = _raw()
    assert text.count(old) == 1 and new != old, name
    a, b = _span(text, "quantize_tiles_kernel")
    at = text.index(old)
    assert a <= at < at + len(old) <= b, f"{name} plants outside the kernel"
    planted = text.replace(old, new)
    assert _body(planted, "quantize_tiles_any_kernel") == _body(
        text, "quantize_tiles_any_kernel")
