"""B8's contract, held in its CUDA source (``grouped_gemm.cu``), on the CPU:
the file passes ``scripts/cu_syntax.py`` (C++ as ``g++`` reads it against
stubbed CUDA types); its two kernels are the only ones and hold no atomic
and no host read of the group sizes (a block walks ``gs`` on the device);
the f32 path chains ``fmaf`` into its accumulator in k order, with no
tensor-core instruction, and the bf16 path multiplies on ``mma.sync``; the
C entries are bound in ``_build.py``, which builds the file; and each of
``scripts/b8_faults.py``'s planted faults names exactly one place of the
source, inside the function it breaks."""

import os
import re
import subprocess
import sys

import pytest

import gym_tpu_torch.ops._build as build
import gym_tpu_torch.ops.grouped_matmul as tgm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(tgm.__file__), "csrc", "grouped_gemm.cu")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import b8_faults  # noqa: E402

# fault: the function whose body holds it
FAULT_HOMES = {
    "group_offset_off_by_one": "find_row_tile",
    "tile_straddles_into_the_next_expert": "find_row_tile",
    "empty_group_not_written": "grouped_outer_kernel",
    "rows_past_sum_not_zeroed": "grouped_gemm_kernel",
    "weight_strides_swapped": "grouped_gemm_kernel",
}


def _text(strip_comments=True) -> str:
    with open(SRC) as f:
        text = f.read()
    if strip_comments:
        text = re.sub(r"//[^\n]*", "", text)
        text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return text


def _close(text: str, i: int, left: str, right: str) -> int:
    depth = 0
    for k in range(i, len(text)):
        depth += {left: 1, right: -1}.get(text[k], 0)
        if depth == 0:
            return k + 1
    raise AssertionError("unbalanced brackets")


def _body(text: str, name: str) -> str:
    """The definition of function ``name``: its name through the brace that
    closes its body."""
    for m in re.finditer(r"\b" + name + r"\s*\(", text):
        after = _close(text, m.end() - 1, "(", ")")
        if text[after:].lstrip().startswith("{"):
            brace = text.index("{", after)
            return text[m.start():_close(text, brace, "{", "}")]
    raise AssertionError(f"no definition of {name} in grouped_gemm.cu")


def test_source_passes_the_syntax_check():
    proc = subprocess.run([sys.executable,
                           os.path.join(ROOT, "scripts", "cu_syntax.py"),
                           SRC], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "grouped_gemm.cu: ok" in proc.stdout


def test_kernels_and_entries():
    text = _text()
    kernels = set()
    for m in re.finditer(r"__global__", text):
        head = text[m.end():text.index("{", m.end())]
        kernels.add(next(n for n in re.findall(r"(\w+)\s*\(", head)
                         if not n.startswith("__")))
    assert kernels == {"grouped_gemm_kernel", "grouped_outer_kernel"}
    for word in ("atomic", "cudaMemcpy", "cudaStreamSynchronize",
                 "cudaDeviceSynchronize"):
        assert word not in text, word
    assert SRC in build.SOURCES
    with open(build.__file__) as f:
        bound = f.read()
    for entry in ("gym_grouped_gemm", "gym_grouped_outer"):
        assert f"int {entry}(" in text
        assert f"lib.{entry}.argtypes" in bound


def test_f32_chains_and_bf16_tensor_cores():
    text = _text()
    chain = _body(text, "fma_mainloop")
    assert "acc[i][j] = fmaf(fa[i], fb[j], acc[i][j])" in chain
    # a k step past K is never taken: the chain's bound is the tile's rows
    # left, never the tile's depth alone
    assert "min(kFK, K - k0)" in chain
    for word in ("mma", "wgmma", "tf32", "__shfl"):
        assert word not in chain
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in \
        _body(text, "mma_bf16")
    # one rounding to bf16, to nearest even, at the store
    assert "f32_to_bf16_bits(acc[mi][ni][h])" in _body(text, "mma_store")


@pytest.mark.parametrize("fault", sorted(b8_faults.FAULTS))
def test_each_planted_fault_names_one_place(fault):
    old, new = b8_faults.FAULTS[fault]
    raw = _text(strip_comments=False)
    assert raw.count(old) == 1 and old != new
    body = _body(raw, FAULT_HOMES[fault])
    assert old in body, f"{fault} is not in {FAULT_HOMES[fault]}"
