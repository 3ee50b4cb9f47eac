"""R1's and B6's contract, held in their CUDA source (``row_gemm.cu``), on
the CPU: every kernel of the file is found and classified; R1's and B6's
kernels (the pipelined one and its oracle) hold no atomic, no tensor-core
instruction (``wgmma``, ``mma.sync``), no TF32 and no warp shuffle (a
shuffle would sum across threads: one thread holds a chain), and chain
with ``fmaf`` into the accumulator, the only update it gets before the
bias; L1's warp butterfly is its own contract, so only the first three
hold for it and for L1 with the residual add, whose add is ``__fadd_rn``
(never contracted into a product). The dispatch's tilings match the Python names, and the
oracle's wrappers and the tiled launch refuse a CPU tensor (the twins are
the CPU's path; the card checks hold R1 to the oracle bit for bit)."""

import os
import re

import pytest
import torch

import gym_tpu_torch.ops.row_linear as trow

SRC = os.path.join(os.path.dirname(trow.__file__), "csrc", "row_gemm.cu")
# kernel: (R1 or B6's chain kernel, the helpers whose text it runs)
KERNELS = {
    "row_gemm_ref_kernel": (True, ()),
    "row_gemm_pipe_kernel": (True, ("chain_tile", "chain_quad", "stage_f32",
                                    "stage_q8", "dequant_stage", "kn_col",
                                    "f4at")),
    "row_layer_norm_kernel": (False, ("warp_sum",)),
    "row_add_layer_norm_kernel": (False, ("warp_sum", "LnStats", "out")),
}
FORBIDDEN_EVERYWHERE = ("atomic", "wgmma", "mma.sync", "tf32")
FORBIDDEN_IN_CHAINS = FORBIDDEN_EVERYWHERE + ("__shfl",)


def _source() -> str:
    with open(SRC) as f:
        text = f.read()
    # comments name what the kernels do not do; hold the code only
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"/\*.*?\*/", "", text, flags=re.S)


def _close(text: str, i: int, left: str, right: str) -> int:
    """The index after the bracket that closes the one at ``i``."""
    depth = 0
    for k in range(i, len(text)):
        depth += {left: 1, right: -1}.get(text[k], 0)
        if depth == 0:
            return k + 1
    raise AssertionError("unbalanced brackets")


def _body(text: str, name: str) -> str:
    """The text of the function ``name``'s definition: its name through the
    brace that closes its body (a call is followed by no body)."""
    for m in re.finditer(r"\b" + name + r"\s*\(", text):
        after = _close(text, m.end() - 1, "(", ")")
        if text[after:].lstrip().startswith("{"):
            brace = text.index("{", after)
            return text[m.start():_close(text, brace, "{", "}")]
    raise AssertionError(f"no definition of {name} in row_gemm.cu")


def test_every_kernel_of_the_file_is_classified():
    text = _source()
    found = set()
    for m in re.finditer(r"__global__", text):
        head = text[m.end():text.index("{", m.end())]
        found.add(next(n for n in re.findall(r"(\w+)\s*\(", head)
                       if not n.startswith("__")))
    assert found == set(KERNELS)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_text_holds_the_contract(kernel):
    text = _source()
    chains, helpers = KERNELS[kernel]
    code = "\n".join(_body(text, f) for f in (kernel,) + helpers)
    for word in FORBIDDEN_IN_CHAINS if chains else FORBIDDEN_EVERYWHERE:
        assert word not in code, f"{kernel}: {word}"
    if chains:
        # every update of the accumulator is one fmaf of itself
        updates = re.findall(r"acc\[i\]\[j\]\s*(\+?=)\s*([^;]*);", code)
        assert updates, f"{kernel}: no accumulator update"
        for op, rhs in updates:
            if rhs.strip() == "0.f":
                continue
            assert op == "=" and rhs.startswith("fmaf(") and rhs.rstrip(
                ).endswith(", acc[i][j])"), f"{kernel}: acc[i][j] {op} {rhs}"


def test_tilings_match_the_dispatch():
    text = _source()
    enum = re.search(r"enum Tiling \{([^}]*)\}", text).group(1)
    names = [n.split("=")[0].strip() for n in enum.split(",")]
    assert names[-1] == "kTilings"
    assert len(names) - 1 == len(trow.TILINGS)
    for name, label in zip(names, trow.TILINGS):
        assert name[1:].lower() == label.split()[0], (name, label)


@pytest.mark.parametrize("which", ["row_linear_ref", "row_qlinear_ref",
                                   "row_gemm_tiled"])
def test_card_only_wrappers_refuse_cpu_tensors(which):
    """The oracle and a sweep's tiled launch run on the card only: the
    CPU's path is the twin, which they are held to there."""
    x = torch.randn(3, 8)
    q = torch.randint(-7, 8, (8, 5), dtype=torch.int8)
    args = {"row_linear_ref": (x, torch.randn(8, 5)),
            "row_qlinear_ref": (x, q, torch.rand(8)),
            "row_gemm_tiled": (x, torch.randn(8, 5), False, 0)}[which]
    with pytest.raises(ValueError, match="cuda"):
        getattr(trow, which)(*args)


def test_add_layer_norm_adds_with_one_rounding():
    """The residual add is written ``__fadd_rn`` wherever the kernel adds x
    and d, and never as a plain ``+`` that the compiler could fuse."""
    code = _body(_source(), "row_add_layer_norm_kernel")
    assert code.count("__fadd_rn(") == 3
    assert not re.search(r"\bx\[[^]]*\]\s*\+", code)
