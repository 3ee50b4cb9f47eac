"""B8's contract, held in its CUDA source (``grouped_gemm.cu``), on the CPU:
the file passes ``scripts/cu_syntax.py`` (C++ as ``g++`` reads it against
stubbed CUDA types); its kernels are the TMA path's two, the first bf16
kernels kept as their oracle, the f32 ring kernels and the first f32
kernels kept as theirs, and hold no atomic and no host read of the group
sizes (a block walks ``gs`` on the device); the bf16 path loads through
TMA into an mbarrier ring and multiplies on ``wgmma`` with no transpose in
shared memory, the first kernels keep ``mma.sync``, and the f32 kernels
chain ``fmaf`` into their accumulators in k order, with no tensor-core
instruction, the ring kernels on a ``cp.async`` ring with one barrier a
depth tile; the C entries are bound in ``_build.py``, which builds the
file; each of ``scripts/b8_faults.py``'s planted faults names exactly one
place of the source, inside the function it breaks; the kernels'
schedules, through their plain-Python twins (``row_slots`` at every
tiling's rows, ``outer_order``), cover every output row and tile exactly
once, by its own group; and the host's f32 tiling is pinned at the MoE
path's shapes."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import gym_tpu_torch.ops._build as build
import gym_tpu_torch.ops.grouped_matmul as tgm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(tgm.__file__), "csrc")
SRC = os.path.join(CSRC, "grouped_gemm.cu")
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import b8_faults  # noqa: E402

# fault: the function whose body holds it
FAULT_HOMES = {
    "group_offset_off_by_one": "find_row_tile",
    "tile_straddles_into_the_next_expert": "find_row_tile",
    "empty_group_not_written": "grouped_outer_kernel",
    "rows_past_sum_not_zeroed": "grouped_gemm_kernel",
    "weight_axes_swapped": "launch_gemm",
    "tile_stores_the_next_groups_rows": "grouped_gemm_kernel",
    "outer_boundary_rows_not_zeroed": "grouped_outer_kernel",
    "mn_major_transpose_bit_flipped": "grouped_outer_kernel",
    "schedule_repeats_a_group": "nth_longest",
    "f32_chain_split_in_two": "grouped_gemm_f32_kernel",
    "f32_k_order_reversed_in_a_tile": "grouped_gemm_f32_kernel",
    "f32_outer_takes_a_row_of_the_next_group": "grouped_outer_f32_kernel",
    "f32_tail_rows_not_zeroed": "grouped_gemm_f32_kernel",
    "f32_ring_stage_reused_before_its_barrier": "ring",
}


def _text(path=SRC, strip_comments=True) -> str:
    with open(path) as f:
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


def _body(text: str, name: str, last=False) -> str:
    """The definition of function (or namespace) ``name``: its name
    through the brace that closes its body; the last one with ``last``."""
    found = []
    for m in re.finditer(r"\b" + name + r"\s*[({]", text):
        after = (m.end() - 1 if text[m.end() - 1] == "{"
                 else _close(text, m.end() - 1, "(", ")"))
        if text[after:].lstrip().startswith("{"):
            brace = text.index("{", after)
            found.append(text[m.start():_close(text, brace, "{", "}")])
    assert found, f"no definition of {name} in {SRC}"
    return found[-1] if last else found[0]


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
    assert kernels == {"grouped_gemm_kernel", "grouped_outer_kernel",
                       "grouped_gemm_ref_kernel", "grouped_outer_ref_kernel",
                       "grouped_gemm_f32_kernel", "grouped_outer_f32_kernel",
                       "grouped_gemm_f32_ref_kernel",
                       "grouped_outer_f32_ref_kernel"}
    for word in ("atomic", "cudaMemcpy", "cudaStreamSynchronize",
                 "cudaDeviceSynchronize"):
        assert word not in text, word
    assert "atomic" not in _text(os.path.join(CSRC, "hopper.cuh"))
    assert SRC in build.SOURCES
    with open(build.__file__) as f:
        bound = f.read()
    for entry in ("gym_grouped_gemm", "gym_grouped_gemm_ref",
                  "gym_grouped_outer", "gym_grouped_outer_ref",
                  "gym_grouped_occupancy"):
        assert f"int {entry}(" in text
        assert f"lib.{entry}.argtypes" in bound or f'"{entry[12:]}"' in bound


def test_f32_chains_and_bf16_tensor_cores():
    text = _text()
    chain = _body(text, "fma_mainloop")
    assert "acc[i][j] = fmaf(fa[i], fb[j], acc[i][j])" in chain
    # a k step past K is never taken: the chain's bound is the tile's rows
    # left, never the tile's depth alone
    assert "min(kFK, K - k0)" in chain
    for word in ("mma", "wgmma", "tf32", "__shfl"):
        assert word not in chain
    # the TMA path: a producer's TMA boxes into a ring of full and empty
    # mbarriers, wgmma on the consumers, one rounding to bf16 at the store
    tc = _body(text, "namespace tc")
    produce = _body(tc, "produce")
    assert "mbar_wait(C::empty(base, st)" in produce
    assert "mbar_expect_tx(C::full(base, st), C::STAGE)" in produce
    consume = _body(tc, "consume")
    assert "mbar_wait(C::full(base, st)" in consume
    assert "wgmma_ss_n256<TA, TB>" in consume
    assert "mbar_arrive(C::empty(base" in consume
    for k in ("grouped_gemm_kernel", "grouped_outer_kernel"):
        body = _body(tc, k)
        assert "ring_init<C>()" in body and "tma_load_" in body
    assert "tma_load_3d" in _body(tc, "grouped_gemm_kernel")
    assert "OuterRing" in _body(tc, "grouped_outer_kernel")
    assert "f32_to_bf16_bits(acc[4 * j + 2 * rr])" in _body(tc, "out_pair")
    # no transposes in shared memory: wgmma reads MN-major operands
    # through their descriptors and the transpose immediates
    for word in ("store_chunks", "mma.sync", "mma_bf16", "__syncwarp"):
        assert word not in tc, word
    assert "desc_mn<128>" in _body(tc, "desc_a")
    assert "desc_mn<128>" in _body(tc, "desc_b")
    hopper = _text(os.path.join(CSRC, "hopper.cuh"))
    n256 = _body(hopper, "wgmma_ss_n256")
    assert "m64n256k16.f32.bf16.bf16" in n256
    assert '"n"(TA), "n"(TB)' in n256 and "p, 1, 1, %131, %132" in n256
    # the first kernels, kept as the oracle, on mma.sync (bf16) and R1's
    # chains in one shared stage (f32)
    assert "gemm_rows<true>" in _body(text, "grouped_gemm_ref_kernel")
    assert "outer_tiles<true>" in _body(text, "grouped_outer_ref_kernel")
    assert "gemm_rows<false>" in _body(text, "grouped_gemm_f32_ref_kernel")
    assert "outer_tiles<false>" in _body(text, "grouped_outer_f32_ref_kernel")
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in \
        _body(text, "mma_bf16")
    assert "f32_to_bf16_bits(acc[mi][ni][h])" in _body(text, "mma_store")


def test_f32_ring_kernels_keep_r1s_chains():
    """The f32 ring kernels: the depth through a ring of zero-filling
    ``cp.async`` copies with one barrier a tile, every element one ``fmaf``
    chain in k order from 0.0f, never a step past the depth, no
    tensor-core instruction and no split of the depth."""
    text = _text()
    f32 = _body(text, "namespace f32")
    ring = _body(f32, "ring")
    assert ring.count("__syncthreads()") == 2
    assert "cp_async_wait<S - 2>()" in ring
    assert "load((next - kt0) % S, next)" in ring
    assert "chain((kt - kt0) % S, kt)" in ring
    for fn in ("cp16", "cp4"):
        assert '"r"(ok ? ' in _body(f32, fn)  # src-size 0: zero-filled
    quad = _body(f32, "chain_quad")
    assert "acc[i][j] = fmaf(a[i][q], b[j], acc[i][j])" in quad
    assert "acc[i][j] = fmaf(a[q], b[j][q], acc[i][j])" in quad
    assert "if (!FULL && kk + q >= kmax) break;" in quad
    gemm = _body(f32, "grouped_gemm_f32_kernel")
    assert "min(T::BK, K - kt * T::BK)" in gemm
    assert "find_row_tile(gs, G, R, T::BM," in gemm
    assert "acc[i][j] = 0.f" in gemm
    assert gemm.count("ring<T::STAGES>(0, KT,") == 1
    outer = _body(f32, "grouped_outer_f32_kernel")
    assert "tc::nth_longest(gs, G, R," in outer
    assert "min(T::BK, depth - kt * T::BK)" in outer
    assert "acc[i][j] = fmaf(a[i], b[j], acc[i][j])" in outer
    for word in ("mma", "wgmma", "tf32", "__shfl", "split"):
        assert word not in f32.replace("smem", ""), word
    # the tilings the host picks (f32::Tiling, ops/grouped_matmul.py)
    assert "enum Tiling { kFew = 0, kMid = 1, kWide = 2 };" in f32
    assert (tgm.F32_FEW, tgm.F32_MID, tgm.F32_WIDE) == (0, 1, 2)
    for name, t in (("Few", tgm.F32_FEW), ("Mid", tgm.F32_MID),
                    ("Wide", tgm.F32_WIDE)):
        assert f"{name}Tile = Tile<{tgm.F32_TILE_ROWS[t]}," in f32


# the MoE path's row counts: 16a's training shapes (8 x 1024 tokens, top-2)
# and chip_smoke.py's B8_SERVED steps (tokens routed top-2)
SERVED_TOKENS = (1, 4, 8, 16, 32, 414, 512)


@pytest.mark.parametrize("rows,tiling", [(16_384, 2), (8_192, 2)] + [
    (2 * n, 0 if n <= 64 else 1) for n in SERVED_TOKENS])
def test_f32_tiling_at_the_moe_shapes(rows, tiling):
    """The host's f32 tiling from the row count alone: the decode steps and
    the short prefills on the few-row tiles, the long prefills on 64 x 64
    tiles, the training shapes and the evals on 128 x 128 tiles."""
    assert tgm.f32_tiling(rows) == tiling


@pytest.mark.parametrize("fault", sorted(b8_faults.FAULTS))
def test_each_planted_fault_names_one_place(fault):
    old, new = b8_faults.FAULTS[fault]
    raw = _text(strip_comments=False)
    assert raw.count(old) == 1 and old != new
    body = _body(raw, FAULT_HOMES[fault], last=True)
    assert old in body, f"{fault} is not in {FAULT_HOMES[fault]}"


def _sizes(seed, groups, rows):
    """Group sizes: empty groups, one of 60% of the rows, and a total that
    falls short of, meets or passes ``rows``."""
    rng = np.random.default_rng(seed)
    n = int(rows * rng.choice([0.5, 0.9, 1.0, 1.3]))
    if groups == 1:
        return [n]
    sizes = rng.multinomial(n - int(0.6 * n),
                            np.ones(groups - 1) / (groups - 1)).tolist()
    sizes.insert(int(rng.integers(groups)), int(0.6 * n))
    for g in rng.choice(groups, size=min(2, groups - 1), replace=False):
        sizes[g] = 0
    return sizes


def _spans(sizes, rows):
    spans, start = [], 0
    for n in sizes:
        n = max(0, min(n, rows - start))
        spans.append((start, n))
        start += n
    return spans


# the edge cases of the schedules: all rows in one group, one row a group,
# empty groups around them, rows past sum(gs)
EDGE_SIZES = {"one_group": ([0, 0, 300, 0], 300),
              "a_row_a_group": ([1] * 40, 40),
              "all_empty": ([0] * 8, 33),
              "rows_past_sum": ([5, 0, 17, 0], 60)}


def _check_slots(sizes, rows, bm):
    slots = tgm.row_slots(sizes, rows, bm)
    assert len(slots) == -(-rows // bm) + len(sizes) + 1
    seen = np.zeros(rows, dtype=int)
    spans = _spans(sizes, rows)
    used = sum(n for _, n in spans)
    for slot in slots:
        if slot is None:
            continue
        g, r0, r1 = slot
        assert 0 < r1 - r0 <= bm
        seen[r0:r1] += 1
        if g < 0:
            assert r0 >= used
        else:
            start, n = spans[g]
            assert start <= r0 < r1 <= start + n
    assert (seen == 1).all()


# (seed, the tiling's tile rows): the TMA path's and the f32 many-row
# tiles' 128 (the first ids, as before), the f32 prefill and few-row
# tiles' 64 and 16
SLOT_CASES = [pytest.param(seed, bm, id=str(seed) if bm == 128
                           else f"{seed}-bm{bm}")
              for bm in sorted(set(tgm.F32_TILE_ROWS.values()), reverse=True)
              for seed in range(6)]


@pytest.mark.parametrize("seed,bm", SLOT_CASES)
def test_forward_row_slots_cover_each_row_once(seed, bm):
    """``find_row_tile``'s twin at the rows of every tiling's tiles (the
    TMA path's and the f32 many-row 128, the f32 few-row 16): each row
    below ``rows`` in exactly one slot, a group's slots inside its own rows
    (at most ``bm`` a slot), the rows past the groups in tail slots, no
    more slots than the grid's."""
    groups = [3, 8, 16, 40, 1, 64][seed]
    rows = [700, 16384, 8192, 5000, 129, 2048][seed]
    _check_slots(_sizes(seed, groups, rows), rows, bm)


@pytest.mark.parametrize("bm", sorted(set(tgm.F32_TILE_ROWS.values())))
@pytest.mark.parametrize("case", sorted(EDGE_SIZES))
def test_forward_row_slots_at_the_edges(case, bm):
    """The same cover with all rows in one group, one row a group, every
    group empty and rows past sum(gs)."""
    sizes, rows = EDGE_SIZES[case]
    _check_slots(sizes, rows, bm)


# (seed, output tiles a group at C 768 x H 3072): the bf16 outer's 128 x
# 256 tiles (the first ids, as before), the f32 outer's 128 x 128
ORDER_CASES = [pytest.param(seed, tiles, id=str(seed) if tiles == 6 * 12
                            else f"{seed}-tiles{tiles}")
               for tiles in (6 * 12, 6 * 24) for seed in range(6)]


@pytest.mark.parametrize("seed,tiles", ORDER_CASES)
def test_outer_order_covers_each_tile_once(seed, tiles):
    """``nth_longest``'s twin: the blocks' groups are a permutation of the
    groups, the longest first (ties by index), each with its own clamped
    rows, so every (group, tile) item is computed exactly once; and the
    kernel's clamp (a group starts at min(R, its unclamped prefix)) is the
    sequential one."""
    groups = [3, 8, 16, 40, 1, 64][seed]
    rows = [700, 16384, 8192, 5000, 129, 2048][seed]
    _check_order(_sizes(seed + 10, groups, rows), rows, tiles)


@pytest.mark.parametrize("tiles", (6 * 12, 6 * 24))
@pytest.mark.parametrize("case", sorted(EDGE_SIZES))
def test_outer_order_at_the_edges(case, tiles):
    """The same cover with all rows in one group, one row a group, every
    group empty and rows past sum(gs)."""
    sizes, rows = EDGE_SIZES[case]
    _check_order(sizes, rows, tiles)


def _check_order(sizes, rows, tiles):
    groups = len(sizes)
    order = tgm.outer_order(sizes, rows)
    assert sorted(g for g, _, _ in order) == list(range(groups))
    counts = [n for _, _, n in order]
    assert counts == sorted(counts, reverse=True)
    spans = _spans(sizes, rows)
    prefix = np.concatenate([[0], np.cumsum(np.maximum(sizes, 0))])
    for rank, (g, start, n) in enumerate(order):
        assert (start, n) == spans[g]
        lo, hi = min(rows, prefix[g]), min(rows, prefix[g + 1])
        assert (start, n) == (lo, hi - lo)
        # the kernel's rank of g: the groups longer, or as long and lower
        assert rank == sum(spans[h][1] > n or (spans[h][1] == n and h < g)
                           for h in range(groups))
    items = [(order[i // tiles][0], i % tiles)
             for i in range(groups * tiles)]
    assert len(set(items)) == groups * tiles
