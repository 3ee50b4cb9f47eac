"""B7's contract held in its CUDA source (``decode_attention.cu``), on the
CPU: every kernel of the file is found and classified (the kernel and its
oracle, the first kernel); none holds an atomic, a tensor-core instruction
(``wgmma``, ``mma.sync``) or a fast-math intrinsic (``__expf``,
``__fdividef``: the softmax keeps ``expf`` and the IEEE divisions); the
kernel's score, PV and combining chains are ``fmaf`` chains, its
dequantizing pass ``__fmul_rn``; the dispatch's paths match the Python
names; both oracles have their C entries and wrappers, and the oracles'
and the sweep's wrappers refuse a CPU tensor (the twins are the CPU's
path; the card checks hold the kernel to the oracle bit for bit)."""

import os
import re

import pytest
import torch

import gym_tpu_torch.ops.decode_attention as tdec

SRC = os.path.join(os.path.dirname(tdec.__file__), "csrc",
                   "decode_attention.cu")
# kernel: the helpers whose text it runs
KERNELS = {
    "decode_attention_ref_kernel": ("warp_max", "warp_sum"),
    "decode_attention_kernel": ("warp_max", "warp_sum", "stage_chunk",
                                "cp_async16", "cp_async4"),
}
FORBIDDEN = ("atomic", "wgmma", "mma.sync", "__expf", "__fdividef",
             "__frcp", "__fsqrt", "tf32")


def _source() -> str:
    with open(SRC) as f:
        text = f.read()
    # comments name what the kernels do not do; hold the code only
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"/\*.*?\*/", "", text, flags=re.S)


def _close(text: str, i: int, left: str, right: str) -> int:
    depth = 0
    for k in range(i, len(text)):
        depth += {left: 1, right: -1}.get(text[k], 0)
        if depth == 0:
            return k + 1
    raise AssertionError("unbalanced brackets")


def _body(text: str, name: str) -> str:
    """The text of the function ``name``'s definition."""
    for m in re.finditer(r"\b" + name + r"\s*\(", text):
        after = _close(text, m.end() - 1, "(", ")")
        if text[after:].lstrip().startswith("{"):
            brace = text.index("{", after)
            return text[m.start():_close(text, brace, "{", "}")]
    raise AssertionError(f"no definition of {name} in decode_attention.cu")


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
    code = "\n".join(_body(text, f) for f in (kernel,) + KERNELS[kernel])
    for word in FORBIDDEN:
        assert word not in code, f"{kernel}: {word}"
    assert "expf(" in code and "fmaf(" in code


def test_no_fast_math_anywhere_in_the_file():
    text = _source()
    for word in FORBIDDEN:
        assert word not in text, word


def test_kernel_chains_are_fmaf_and_dequant_is_fmul_rn():
    """Every update of a chain's accumulator (the scores, the PV sums, the
    output's combination, the softmax's l and o rescaled) is one fmaf of
    itself; the int8 pass converts with __fmul_rn."""
    code = _body(_source(), "decode_attention_kernel")
    for name in (r"acc\[qi\]", r"pv\[qi\]\[i\]", r"o\[qi\]\[i\]", r"l\[qi\]",
                 r"lt", r"acc"):
        updates = re.findall(r"(?<![\w\]])" + name + r"\s*=\s*([^;]*);",
                             code)
        assert updates, name
        for rhs in updates:
            rhs = rhs.strip()
            assert rhs in ("0.f", "1.f") or rhs.startswith("fmaf("), (
                name, rhs)
    assert code.count("__fmul_rn(") == 4


def test_paths_match_the_dispatch():
    text = _source()
    enum = re.search(r"enum Path \{([^}]*)\}", text).group(1)
    names = [n.split("=")[0].strip() for n in enum.split(",")]
    assert names[-1] == "kPaths" and len(names) - 1 == len(tdec.PATHS)
    for name, label in zip(names, tdec.PATHS):
        assert name[1:].lower() == label.replace(" ", "")


@pytest.mark.parametrize("entry", ["gym_decode_attention_ref",
                                   "gym_decode_attention_int8_ref",
                                   "gym_decode_attention",
                                   "gym_decode_attention_int8",
                                   "gym_decode_attention_path"])
def test_c_entries_exist(entry):
    assert re.search(r"\bint " + entry + r"\(", _source())


def _inputs(int8):
    q = torch.randn(2, 1, 2, 16)
    pool = (torch.randint(-5, 5, (3, 4, 2, 16), dtype=torch.int8) if int8
            else torch.randn(3, 4, 2, 16))
    table = torch.tensor([[1], [2]], dtype=torch.int32)
    cursor = torch.tensor([0, 3], dtype=torch.int32)
    scales = (torch.rand(3, 4, 2), torch.rand(3, 4, 2)) if int8 else ()
    return q, pool, table, cursor, scales


@pytest.mark.parametrize("which", ["decode_attention_ref",
                                   "decode_attention_int8_ref",
                                   "decode_attention_on_path"])
def test_card_only_wrappers_refuse_cpu_tensors(which):
    """The oracles and a sweep's path launch run on the card only: the
    CPU's path is the twin, which they are held to there."""
    q, pool, table, cursor, scales = _inputs(which == "decode_attention_int8"
                                             "_ref")
    args = {"decode_attention_ref": (q, pool, pool, table, cursor),
            "decode_attention_int8_ref": (q, pool, pool, *scales, table,
                                          cursor),
            "decode_attention_on_path": (q, pool, pool, table, cursor, 0)}
    with pytest.raises(ValueError, match="cuda"):
        getattr(tdec, which)(*args[which])


@pytest.mark.parametrize("int8", [False, True])
def test_twins_still_serve_the_cpu(int8):
    q, pool, table, cursor, scales = _inputs(int8)
    if int8:
        out = tdec.decode_attention_int8(q, pool, pool, *scales, table,
                                         cursor)
        ref = tdec.plain_decode_attention_int8(q, pool, pool, *scales,
                                               table, cursor)
    else:
        out = tdec.decode_attention(q, pool, pool, table, cursor)
        ref = tdec.plain_decode_attention(q, pool, pool, table, cursor)
    assert torch.equal(out, ref) and out.shape == q.shape
