// B8: the grouped matmuls of the MoE layers on Hopper.
//
// grouped_gemm_kernel computes y[r] = x[r] . w[g(r)], where the rows are
// grouped: the first gs[0] rows take w[0], the next gs[1] w[1], and so on;
// rows past sum(gs) come out as zeros and an empty group is legal (the
// semantics of lax.ragged_dot). w is read through its strides as a [G, K, N]
// array, so the cotangent ct . w^T reads w [G, C, H] transposed without a
// copy. grouped_outer_kernel computes out[g] = x_g^T . ct_g, [G, M, N]: the
// w-cotangent of the product, a grouped matmul with the ragged axis
// contracted. They replace lax.ragged_dot and its transpose inside
// gym_tpu/ops/grouped_matmul.py (grouped_dot :40-65, grouped_outer :75-102),
// the grouped matmul of the MoE fast path (gym_tpu/models/moe.py:137-140;
// XLA's lowering, no pl.pallas_call).
//
// The grouping lives on the device: gs is read by every block, and a block
// walks the group sizes to its own tile (the sizes clamped so that no group
// passes R), so the host never reads gs and a CUDA graph can hold the
// launch. Grids are sized from the static R, G, K (or M) and N alone. No
// kernel here has an atomic, and the sums of an output element are taken
// in one fixed order, so the same inputs give the same bits on every run.
//
// What bounds it on this card: at the MoE training shapes (16,384 rows, C
// 768, H 3072, 8 experts) the products, 2 R K N operations, at 989 TFLOP/s
// in bf16 (0.078 ms a projection; its bytes, about 160 MB, take 0.048 ms
// at 3.35 TB/s) and at 67 TFLOP/s of f32 FMAs in f32; at decode's few
// rows, the weights' bytes.
//
// bf16 (training), namespace tc: TMA, an mbarrier ring and wgmma. A block
// (one an SM) owns 128 x 256 tiles of output and has two consumer
// warpgroups, 64 rows each, and one producer warp. The producer's first
// thread keeps the operands' boxes (64 deep, 128-byte rows swizzled at 128
// bytes, through tensor maps encoded on the host for each call) in flight
// into a ring of stages, with an mbarrier a stage for "full" (TMA's bytes
// landed) and one for "empty" (both consumers' products on it done). The
// consumers run m64n256k16 wgmma steps on a stage from shared memory, one
// stage's products in flight while the next are issued, f32 accumulators
// in registers, and round to bf16 once at the store (to nearest even). No
// operand is transposed in shared memory: wgmma reads each as it lies,
// K-major (the depth along a box's rows) or MN-major (the depth down them;
// hopper.cuh's desc_mn and the instruction's transpose immediates): x [R,
// K] is a K-major A; w as it lies ([G, K, N], n contiguous) an MN-major B,
// and read transposed (ct . w^T: k contiguous) a K-major B; in the outer,
// x [R, M] an MN-major A and ct [R, N] an MN-major B. 128 x 128 tiles at
// two blocks an SM measured slower at every 16a shape (PERF.md).
//  - grouped_gemm_kernel: persistent, a block an SM walking items i, i +
//    gridDim.x, ...: item i is column tile i % tiles_n of row slot i /
//    tiles_n. The row slots enumerate each group's tiles of 128 rows,
//    group by group (find_row_tile), so a tile reads one expert; the slots
//    after them zero the rows past sum(gs). sum over g of ceil(gs[g] / 128)
//    plus the tail's tiles is at most R / 128 + G + 1, the row slots. The
//    ring (3 stages) runs on across a block's tiles, so the next tile's
//    loads land while the consumers store this one; a tile goes out
//    through shared memory, a 1-D bulk copy a row, so that the consumers
//    start on the next tile while the copies drain (at K = 768 a tile's
//    products take about as long as its 64 KB of output at the card's
//    write rate). A group's last tile loads rows of the next group (TMA's
//    box does not know where a group ends): they are multiplied by this
//    expert and never stored, the copies going out a row at a time for the
//    tile's own rows only (a TMA store of the whole box would race with the
//    next tile's rows). TMA fills rows past R and depth past K with zeros.
//  - grouped_outer_kernel: a ring of 4 stages; block i is output tile i %
//    tiles of the group of rank i / tiles by row count, the longest first,
//    the order computed by every block from gs (nth_longest): the long
//    group's tiles start in the first wave and the short groups' tiles
//    fill the SMs beside them, where a grid in group order leaves most SMs
//    idle behind the long group's last tiles. A tile walks its group's rows
//    from the first in stages of 64 (no second pass, no scratch); in the
//    last stage the rows past the group's end are zeroed in both operands
//    before its products (they belong to the next group; TMA zeroes rows
//    past R). An empty group's tiles write zeros.
// TMA takes 16-byte-aligned bases and row strides: K, N and M multiples of
// 8. Other bf16 views take the first kernels, kept as the oracle
// (grouped_gemm_ref_kernel, grouped_outer_ref_kernel: 128 x 128 tiles, k
// steps of 32, 8 warps each computing 64 x 32 with mma.sync m16n8k16, one
// shared stage filled through registers); the wrapper picks the path by
// that rule and counts the first kernels' launches apart.
//
// f32 (serving, evals), namespace f32: R1's rule (row_gemm.cu): each
// output element is one in-order fmaf chain over k = 0 .. K-1 started at
// 0.0f, held by one thread, and a k step past K is never taken; no split of
// K, no atomics, no tensor cores. So a row's bits do not depend on which
// other rows share its expert, on the tile or on R: what the serving
// engine's splices and park/resume need, and each element is bit for bit
// R1 on the same row and expert (chip_smoke.py phase 16a holds it to that).
// The f32 outer chains each element over its group's rows in order. Bound:
// the f32 FMAs (67 TFLOP/s) at the training shapes; at decode's few rows the
// bytes of the experts that have rows, or the chain (K dependent FMAs).
//  - grouped_gemm_f32_kernel: R1's pipelined design over the row slots of
//    find_row_tile: x and w stream through a ring of cp.async stages
//    (16-byte copies where the rows allow, zero-filled past R, K, N and the
//    group's end), one barrier a depth tile, and each thread keeps TM x TN
//    chains in registers, read from shared memory as float4s (x [BM][BK +
//    4]; w as it lies [BK][BN], or read transposed [BN][BK + 4]). Three
//    tilings, picked on the host from R alone (so graphs hold the launch):
//    16 x 16 for decode's few rows (an expert's weights read once a row
//    slot, an empty group's slots out at once), 64 x 64 for the prefill
//    buckets, 128 x 128 (8 x 8 a thread; two blocks an SM, one where w is
//    read transposed) for training and the evals.
//  - grouped_outer_f32_kernel: 128 x 128 output tiles, 8 x 8 a thread, the
//    group's rows in stages of 16 through the ring, both operands as they
//    lie ([16][128] each, float4 reads of 4 m's and 4 n's); blocks longest
//    group first (tc::nth_longest, as the bf16 outer); rows never split.
// The first f32 kernels (64 x 64 tiles, one synchronous shared stage) are
// kept as the oracle (grouped_gemm_f32_ref_kernel,
// grouped_outer_f32_ref_kernel), reached only through the _ref entries.

#include <type_traits>

#include "hopper.cuh"

namespace {

typedef uint16_t bf16_t;  // a bf16's bits

constexpr int kThreads = 256;
// bf16 tiles: kBT rows of each operand (m of x, n of w), k steps of kBK
constexpr int kBT = 128;
constexpr int kBK = 32;
constexpr int kPitch = kBK + 8;
constexpr int kChunks = kBT * kBK / 8 / kThreads;  // chunks of 8 a thread
// f32 tiles
constexpr int kFT = 64;
constexpr int kFK = 16;
constexpr int kFPitch = kFT + 1;

// find_row_tile's group for the slots that zero the rows past sum(gs), and
// for the slots past every tile
constexpr int kTailRows = -1;
constexpr int kNoTile = -2;

// round to nearest even, a NaN kept a (quiet) NaN: __float2bfloat16_rn's
// bits, PyTorch's rounding
__device__ __forceinline__ unsigned f32_to_bf16_bits(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}

// An operand tile's source: element (p, k) at base[p * sp + k * sk] for
// p < p_lim and k < k_lim, zero elsewhere; p is the tile's row (m of the
// left operand, n of the right one). k_run: chunks of 8 run along k (sk ==
// 1), else along p; vec: a chunk inside the limits is one 16-byte load (the
// host checked the alignment and strides).
struct View {
  const void* base;
  long long sp, sk;
  int p_lim, k_lim;
  int k_run, vec;
};

__device__ __forceinline__ int clamp_count(int n, int room) {
  return n < 0 ? 0 : (n > room ? room : n);
}

struct RowTile {
  int group, row0, row1;
};

// grouped_gemm_kernel's row slot `slot`: the group and rows [row0, row1) of
// one of its tiles, or rows past sum(gs) to zero (kTailRows), or nothing.
__device__ RowTile find_row_tile(const int* gs, int G, int R, int BM,
                                 int slot) {
  int start = 0, tiles = 0;
  for (int g = 0; g < G; ++g) {
    const int n = clamp_count(gs[g], R - start);
    const int t = (n + BM - 1) / BM;
    if (slot < tiles + t) {
      const int row0 = start + (slot - tiles) * BM;
      return {g, row0, min(start + n, row0 + BM)};
    }
    tiles += t;
    start += n;
  }
  const int tail0 = start + (slot - tiles) * BM;
  if (tail0 < R) return {kTailRows, tail0, min(R, tail0 + BM)};
  return {kNoTile, 0, 0};
}

struct Span {
  int start, count;
};

// group g's first row and row count
__device__ Span group_span(const int* gs, int G, int R, int g) {
  int first = 0;
  for (int i = 0; i < g; ++i) first += clamp_count(gs[i], R - first);
  return {first, g < G ? clamp_count(gs[g], R - first) : 0};
}

// rows x cols elements at o (row pitch ld) set to zero by the block
template <typename E>
__device__ void zero_tile(E* o, long long ld, int rows, int cols, int BT) {
  rows = min(rows, BT);
  cols = min(cols, BT);
  for (int e = threadIdx.x; e < rows * cols; e += kThreads)
    o[(long long)(e / cols) * ld + e % cols] = E(0);
}

// -- bf16: mma.sync tiles ----------------------------------------------------

__device__ __forceinline__ unsigned pack2(unsigned lo, unsigned hi) {
  return (lo & 0xffffu) | (hi << 16);
}

// this thread's chunk i of the tile at k0: (p, k) of its first element
__device__ __forceinline__ void chunk_origin(int k_run, int i, int& p,
                                             int& k) {
  const int c = threadIdx.x + i * kThreads;
  if (k_run) {
    p = c / (kBK / 8);
    k = (c % (kBK / 8)) * 8;
  } else {
    k = c / (kBT / 8);
    p = (c % (kBT / 8)) * 8;
  }
}

__device__ void load_chunks(const View& v, int k0, uint4* r) {
  const bf16_t* base = static_cast<const bf16_t*>(v.base);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    int p, k;
    chunk_origin(v.k_run, i, p, k);
    k += k0;
    const bool whole = v.k_run ? (p < v.p_lim && k + 8 <= v.k_lim)
                               : (k < v.k_lim && p + 8 <= v.p_lim);
    if (v.vec && whole) {
      r[i] = *reinterpret_cast<const uint4*>(base + (long long)p * v.sp +
                                             (long long)k * v.sk);
      continue;
    }
    unsigned e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pj = v.k_run ? p : p + j;
      const int kj = v.k_run ? k + j : k;
      e[j] = (pj < v.p_lim && kj < v.k_lim)
                 ? base[(long long)pj * v.sp + (long long)kj * v.sk]
                 : 0u;
    }
    r[i] = make_uint4(pack2(e[0], e[1]), pack2(e[2], e[3]),
                      pack2(e[4], e[5]), pack2(e[6], e[7]));
  }
}

__device__ void store_chunks(bf16_t (*s)[kPitch], int k_run, const uint4* r) {
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    int p, k;
    chunk_origin(k_run, i, p, k);
    if (k_run) {
      *reinterpret_cast<uint4*>(&s[p][k]) = r[i];
      continue;
    }
    const unsigned w[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[p + 2 * j][k] = (bf16_t)(w[j] & 0xffffu);
      s[p + 2 * j + 1][k] = (bf16_t)(w[j] >> 16);
    }
  }
}

__device__ __forceinline__ unsigned lds32(const bf16_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc (this thread's fragments of the 128 x 128 tile) = A . B^T over k <
// K, A and B staged [p][k]: warp w computes rows (w / 4) * 64 .. + 64 and
// columns (w % 4) * 32 .. + 32 of the tile
__device__ void mma_mainloop(const View& a, const View& b, int K,
                             bf16_t (*as)[kPitch], bf16_t (*bs)[kPitch],
                             float (*acc)[4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nk = (K + kBK - 1) / kBK;
  uint4 ra[kChunks], rb[kChunks];
  if (nk > 0) {
    load_chunks(a, 0, ra);
    load_chunks(b, 0, rb);
  }
  for (int kt = 0; kt < nk; ++kt) {
    store_chunks(as, a.k_run, ra);
    store_chunks(bs, b.k_run, rb);
    __syncthreads();
    if (kt + 1 < nk) {
      load_chunks(a, (kt + 1) * kBK, ra);
      load_chunks(b, (kt + 1) * kBK, rb);
    }
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned fa[4][4], fb[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + gid;
        fa[mi][0] = lds32(&as[r][ks + tig * 2]);
        fa[mi][1] = lds32(&as[r + 8][ks + tig * 2]);
        fa[mi][2] = lds32(&as[r][ks + tig * 2 + 8]);
        fa[mi][3] = lds32(&as[r + 8][ks + tig * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + gid;
        fb[ni][0] = lds32(&bs[n][ks + tig * 2]);
        fb[ni][1] = lds32(&bs[n][ks + tig * 2 + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], fa[mi], fb[ni]);
    }
    __syncthreads();
  }
}

// the tile's rows < rows and columns < cols of acc, rounded to bf16, at o
// (row pitch ld)
__device__ void mma_store(const float (*acc)[4][4], bf16_t* o, long long ld,
                          int rows, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = wm + mi * 16 + gid + (h >> 1) * 8;
        const int c = wn + ni * 8 + tig * 2 + (h & 1);
        if (r < rows && c < cols)
          o[(long long)r * ld + c] = (bf16_t)f32_to_bf16_bits(acc[mi][ni][h]);
      }
}

// -- f32: fmaf chains --------------------------------------------------------

__device__ void load_f32(const View& v, int k0, float (*s)[kFPitch]) {
  const float* base = static_cast<const float*>(v.base);
#pragma unroll
  for (int i = 0; i < kFT * kFK / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int p = v.k_run ? e / kFK : e % kFT;
    const int k = v.k_run ? e % kFK : e / kFT;
    const int kk = k0 + k;
    s[k][p] = (p < v.p_lim && kk < v.k_lim)
                  ? base[(long long)p * v.sp + (long long)kk * v.sk]
                  : 0.0f;
  }
}

// acc[i][j], element (ty + 16 i, tx + 16 j) of the 64 x 64 tile: one fmaf
// chain over k = 0 .. K-1 in order, started at 0.0f
__device__ void fma_mainloop(const View& a, const View& b, int K,
                             float (*as)[kFPitch], float (*bs)[kFPitch],
                             float (*acc)[4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += kFK) {
    load_f32(a, k0, as);
    load_f32(b, k0, bs);
    __syncthreads();
    const int kmax = min(kFK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float fa[4], fb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) fa[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) fb[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ void fma_store(const float (*acc)[4], float* o, long long ld,
                          int rows, int cols) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < rows && c < cols) o[(long long)r * ld + c] = acc[i][j];
    }
}

// C (rows x cols of the tile at o, pitch ld) = A . B^T over k < K, in the
// dtype's tiles
template <bool kBf16>
__device__ void tile_product(const View& a, const View& b, int K, void* o,
                             long long ld, int rows, int cols) {
  if constexpr (kBf16) {
    __shared__ __align__(16) bf16_t as[kBT][kPitch];
    __shared__ __align__(16) bf16_t bs[kBT][kPitch];
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mi][ni][h] = 0.0f;
    mma_mainloop(a, b, K, as, bs, acc);
    mma_store(acc, static_cast<bf16_t*>(o), ld, rows, cols);
  } else {
    __shared__ float as[kFK][kFPitch];
    __shared__ float bs[kFK][kFPitch];
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    fma_mainloop(a, b, K, as, bs, acc);
    fma_store(acc, static_cast<float*>(o), ld, rows, cols);
  }
}

// y [R, N] = x [R, K] . w[g(r)], w's element (g, k, n) at w + g * w_sg +
// k * w_sk + n * w_sn; gs [G] int32 on the device
template <bool kBf16>
__device__ __forceinline__ void gemm_rows(const void* x, const void* w,
                                          const int* gs, void* y, int R,
                                          int K, int N, int G, long long w_sg,
                                          long long w_sk, long long w_sn,
                                          int x_vec, int w_vec) {
  using E = typename std::conditional<kBf16, bf16_t, float>::type;
  constexpr int BT = kBf16 ? kBT : kFT;
  const RowTile t = find_row_tile(gs, G, R, BT, (int)blockIdx.x);
  const int n0 = (int)blockIdx.y * BT;
  if (t.group == kNoTile) return;
  E* o = static_cast<E*>(y) + (long long)t.row0 * N + n0;
  if (t.group == kTailRows) {
    zero_tile<E>(o, N, t.row1 - t.row0, N - n0, BT);  // rows past sum(gs)
    return;
  }
  const View a{static_cast<const E*>(x) + (long long)t.row0 * K,
               K, 1, t.row1 - t.row0, K, 1, x_vec};
  const View b{static_cast<const E*>(w) + t.group * w_sg + n0 * w_sn,
               w_sn, w_sk, N - n0, K, w_sk == 1, w_vec};
  tile_product<kBf16>(a, b, K, o, N, t.row1 - t.row0, N - n0);
}

// out [G, M, N]: out[g] = x_g^T . ct_g, x [R, M] and ct [R, N] contiguous,
// the rows of group g in order
template <bool kBf16>
__device__ __forceinline__ void outer_tiles(const void* x, const void* ct,
                                            const int* gs, void* out, int R,
                                            int M, int N, int G, int x_vec,
                                            int ct_vec) {
  using E = typename std::conditional<kBf16, bf16_t, float>::type;
  constexpr int BT = kBf16 ? kBT : kFT;
  const int tiles_n = (N + BT - 1) / BT;
  const int m0 = (int)blockIdx.x / tiles_n * BT;
  const int n0 = (int)blockIdx.x % tiles_n * BT;
  const int g = (int)blockIdx.y;
  const Span s = group_span(gs, G, R, g);
  E* o = static_cast<E*>(out) + ((long long)g * M + m0) * N + n0;
  if (s.count == 0) {
    zero_tile<E>(o, N, M - m0, N - n0, BT);  // an empty group's product
    return;
  }
  const View a{static_cast<const E*>(x) + (long long)s.start * M + m0,
               1, M, M - m0, s.count, 0, x_vec};
  const View b{static_cast<const E*>(ct) + (long long)s.start * N + n0,
               1, N, N - n0, s.count, 0, ct_vec};
  tile_product<kBf16>(a, b, s.count, o, N, M - m0, N - n0);
}

// The first kernels, kept as the oracle: in bf16 of the TMA path below and
// the path of the bf16 shapes TMA cannot take (grouped_gemm_ref_kernel,
// grouped_outer_ref_kernel); in f32 of the ring kernels further below
// (grouped_gemm_f32_ref_kernel, grouped_outer_f32_ref_kernel), off the path.
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_f32_ref_kernel(const void* x, const void* w, const int* gs,
                                void* y, int R, int K, int N, int G,
                                long long w_sg, long long w_sk,
                                long long w_sn, int x_vec, int w_vec) {
  gemm_rows<false>(x, w, gs, y, R, K, N, G, w_sg, w_sk, w_sn, x_vec, w_vec);
}

__global__ void __launch_bounds__(kThreads)
    grouped_gemm_ref_kernel(const void* x, const void* w, const int* gs,
                            void* y, int R, int K, int N, int G,
                            long long w_sg, long long w_sk, long long w_sn,
                            int x_vec, int w_vec) {
  gemm_rows<true>(x, w, gs, y, R, K, N, G, w_sg, w_sk, w_sn, x_vec, w_vec);
}

__global__ void __launch_bounds__(kThreads)
    grouped_outer_f32_ref_kernel(const void* x, const void* ct, const int* gs,
                                 void* out, int R, int M, int N, int G,
                                 int x_vec, int ct_vec) {
  outer_tiles<false>(x, ct, gs, out, R, M, N, G, x_vec, ct_vec);
}

__global__ void __launch_bounds__(kThreads)
    grouped_outer_ref_kernel(const void* x, const void* ct, const int* gs,
                             void* out, int R, int M, int N, int G,
                             int x_vec, int ct_vec) {
  outer_tiles<true>(x, ct, gs, out, R, M, N, G, x_vec, ct_vec);
}

// -- bf16: TMA, an mbarrier ring and wgmma ----------------------------------

namespace tc {

using hop::Tile;
constexpr int CONSUMERS = 256;  // two warpgroups; arrivals that empty a stage
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BM = 128;              // a tile's rows of output: 64 a consumer
constexpr int BN = 256;              // a tile's columns
constexpr int BK = 64;               // a stage's depth: 128 bytes of bf16
constexpr uint32_t PART = 64 * 128;  // a [64 rows x 128 bytes] box, swizzled
// the forward's staged output rows: BN bf16 and 16 bytes, so that the 8
// rows of a warp's 4-byte stores fall on 32 banks
constexpr uint32_t OUT_PITCH = 2 * BN + 16;

// Shared memory from a 1024-aligned base: the ring's S stages (A's 128 x
// 64, then B's BN x 64, bf16), OUT bytes of staged output rows, then the
// barriers full[S], empty[S].
template <int S, uint32_t OUT>
struct Ring {
  static constexpr int STAGES = S;
  static constexpr uint32_t A = BM * BK * 2;
  static constexpr uint32_t B = BN * BK * 2;
  static constexpr uint32_t STAGE = A + B;
  static constexpr uint32_t STAGED = S * STAGE;
  static constexpr uint32_t BARS = STAGED + OUT;
  static constexpr size_t BYTES = 1024 + BARS + 16 * S;
  __device__ static uint32_t full(uint32_t base, int st) {
    return base + BARS + 8 * st;
  }
  __device__ static uint32_t empty(uint32_t base, int st) {
    return base + BARS + 8 * (S + st);
  }
};
using GemmRing = Ring<3, BM * OUT_PITCH>;  // 211 KB
using OuterRing = Ring<4, 0>;              // 193 KB

// the ring's base, its barriers initialised (every thread)
template <class C>
__device__ __forceinline__ uint32_t ring_init() {
  extern __shared__ __align__(16) uint8_t ring_smem[];
  const uint32_t base = (hop::smem_u32(ring_smem) + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      hop::mbar_init(C::full(base, st), 1);
      hop::mbar_init(C::empty(base, st), CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
  return base;
}

// The producer thread: nk stages of a tile, each once the consumers have
// released it, its boxes issued by load(A, B, full barrier, depth k0). it
// counts the stages the block has filled, across its tiles.
template <class C, class Load>
__device__ __forceinline__ void produce(uint32_t base, int& it, int nk,
                                        Load load) {
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int st = it % C::STAGES;
    // round r of a stage waits for the release of round r - 1 (parity 1
    // of a fresh barrier passes at once)
    hop::mbar_wait(C::empty(base, st), ((it / C::STAGES) & 1) ^ 1);
    hop::mbar_expect_tx(C::full(base, st), C::STAGE);
    const uint32_t a = base + st * C::STAGE;
    load(a, a + C::A, C::full(base, st), kt * BK);
  }
}

// wgmma descriptors of consumer warpgroup w's A (its 64 rows) and of B at
// depth step ks of a stage: K-major (0) or MN-major (1, the depth down the
// rows of 64 x 128-byte parts, no transpose in shared memory)
template <int TA>
__device__ __forceinline__ uint64_t desc_a(uint32_t a, int w, int ks) {
  if constexpr (TA) return hop::desc_mn<128>(a, ks, w);
  else return hop::desc_k<Tile<128, BM>>(a + w * PART, ks);
}
template <int TB>
__device__ __forceinline__ uint64_t desc_b(uint32_t b, int ks) {
  if constexpr (TB) return hop::desc_mn<128>(b, ks, 0);
  else return hop::desc_k<Tile<128, BN>>(b, ks);
}

// rows [valid, 64) of the `parts` 64-row parts at p set to zero, by the
// consumers together: a whole 128-byte row is the same bytes under any
// swizzle
__device__ __forceinline__ void zero_part_rows(uint32_t p, int parts,
                                               int valid) {
  const int per_part = (64 - valid) * 8;  // 16-byte chunks
  for (int e = threadIdx.x; e < parts * per_part; e += CONSUMERS)
    hop::st_shared_zero16(p + (e / per_part) * PART +
                          (valid + e % per_part / 8) * 128 +
                          e % 8 * 16);
}

// Consumer warpgroup w = threadIdx.x / 128: acc (its 64 rows x BN of the
// tile) += A B over nk stages, 16-deep wgmma steps in depth order. A and
// B are K-major (0) or MN-major (1). last_rows: the depth rows of the last
// stage that belong to the product (the outer's group end), the rest zeroed
// in both operands first, so that no value of another group (not even an
// inf) reaches the sums; BK where all do. One stage's products stay in
// flight while the next stage's are issued; a stage is released once its
// products are done, the last one at the tile's end. it counts the stages
// the block has used, across its tiles.
template <class C, int TA, int TB>
__device__ __forceinline__ void consume(uint32_t base, int& it, int nk,
                                        int last_rows, float (&acc)[BN / 2]) {
  const int w = threadIdx.x >> 7;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int st = it % C::STAGES;
    const uint32_t a = base + st * C::STAGE;
    hop::mbar_wait(C::full(base, st), (it / C::STAGES) & 1);
    if (kt == nk - 1 && last_rows < BK) {
      zero_part_rows(a, C::STAGE / PART, last_rows);
      hop::fence_async_smem();
      hop::bar_sync(1, CONSUMERS);
    }
    hop::fence_regs(acc);
    hop::wg_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      hop::wgmma_ss_n256<TA, TB>(acc, desc_a<TA>(a, w, ks),
                                 desc_b<TB>(a + C::A, ks), 1);
    hop::wg_commit();
    hop::wg_wait<1>();
    hop::fence_regs(acc);
    if (kt > 0) hop::mbar_arrive(C::empty(base, (it - 1) % C::STAGES));
  }
  hop::wg_wait<0>();
  hop::fence_regs(acc);
  hop::mbar_arrive(C::empty(base, (it - 1) % C::STAGES));
}

// this thread's output pair (row ln.row + 8 rr, columns 8 j + ln.col and
// the next) of acc, rounded to bf16 (to nearest even, once)
__device__ __forceinline__ uint32_t out_pair(const float (&acc)[BN / 2],
                                             int j, int rr) {
  return f32_to_bf16_bits(acc[4 * j + 2 * rr]) |
         (f32_to_bf16_bits(acc[4 * j + 2 * rr + 1]) << 16);
}

// acc (consumer warpgroup w's 64 rows x BN) at o (row pitch ld): rows <
// rows and columns < cols only (cols a multiple of 8), a 4-byte store a
// pair of columns
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           bf16_t* o, long long ld, int rows,
                                           int cols) {
  const hop::Lane ln;
  const int w = threadIdx.x >> 7;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 64 * w + ln.row + 8 * rr;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (8 * j + ln.col < cols)
        *reinterpret_cast<uint32_t*>(o + (long long)r * ld + 8 * j + ln.col) =
            out_pair(acc, j, rr);
  }
}

// The tile through shared memory: acc into the staged rows at out (pitch
// OUT_PITCH), then row r < rows (cols values, a multiple of 8) one bulk
// copy to o + r ld, issued by consumer thread r, so that the block goes on
// to its next tile while the copies drain. The rows of the tile past rows
// (another group's) are never copied. The copies of the block's previous
// tile have read the staged rows before they are written again.
__device__ __forceinline__ void store_staged(const float (&acc)[BN / 2],
                                             uint32_t out, bf16_t* o,
                                             long long ld, int rows,
                                             int cols) {
  const hop::Lane ln;
  const int w = threadIdx.x >> 7;
  if (threadIdx.x < BM) hop::bulk_wait_read<0>();
  hop::bar_sync(1, CONSUMERS);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const uint32_t row = out + (64 * w + ln.row + 8 * rr) * OUT_PITCH;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      hop::st_shared_u32(row + 2 * (8 * j + ln.col), out_pair(acc, j, rr));
  }
  hop::fence_async_smem();
  hop::bar_sync(1, CONSUMERS);
  if ((int)threadIdx.x < rows) {
    hop::bulk_store(o + (long long)threadIdx.x * ld,
                    out + threadIdx.x * OUT_PITCH, 2 * min(cols, BN));
    hop::bulk_commit();
  }
}

// rows x cols (clamped to BM x BN; cols a multiple of 8) of bf16 zeros at
// o (row pitch ld, 16-byte aligned rows), by the consumers
__device__ __forceinline__ void zero_out(bf16_t* o, long long ld, int rows,
                                         int cols) {
  rows = min(rows, BM);
  cols = min(cols, BN) / 8;
  for (int e = threadIdx.x; e < rows * cols; e += CONSUMERS)
    *reinterpret_cast<uint4*>(o + (long long)(e / cols) * ld + e % cols * 8) =
        make_uint4(0, 0, 0, 0);
}

struct Ranked {
  int group, start, count;
};

// The group of rank `rank` when the groups are ordered by their row count,
// the longest first (equal counts: the lower index first), with its first
// row and row count (the sizes clamped so that no group passes R: group g
// starts at min(R, S_g) for S_g the sum of max(gs[h], 0) over h < g). Every
// warp computes it alike, a lane a group, 32 groups at a time.
__device__ Ranked nth_longest(const int* gs, int G, int R, int rank) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  // the clamped start and count of group 32c + lane; `before` carries
  // S_g over the chunks
  const auto span = [&](int c, long long& before, int& start, int& count) {
    const int g = 32 * c + lane;
    const long long n = g < G && gs[g] > 0 ? gs[g] : 0;
    long long incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long v = __shfl_up_sync(all, incl, d);
      if (lane >= d) incl += v;
    }
    const long long s0 = before + incl - n, s1 = before + incl;
    before += __shfl_sync(all, incl, 31);
    start = (int)(s0 < R ? s0 : R);
    count = (int)(s1 < R ? s1 : R) - start;
  };
  long long before = 0;
  for (int c = 0; 32 * c < G; ++c) {
    const int g = 32 * c + lane;
    int start, count;
    span(c, before, start, count);
    int r = 0;
    long long before2 = 0;
    for (int c2 = 0; 32 * c2 < G; ++c2) {
      int s2, n2;
      span(c2, before2, s2, n2);
      for (int j = 0; j < 32; ++j) {
        const int h = 32 * c2 + j;
        const int nh = __shfl_sync(all, n2, j);
        r += h < G && (nh > count || (nh == count && h < g));
      }
    }
    const unsigned hit = __ballot_sync(all, g < G && r == rank);
    if (hit) {
      const int src = __ffs(hit) - 1;
      return {__shfl_sync(all, g, src), __shfl_sync(all, start, src),
              __shfl_sync(all, count, src)};
    }
  }
  return {0, 0, 0};
}

// y [R, N] = x [R, K] . w[g(r)], bf16, through tensor maps: x as 2-d (K,
// R) in boxes of 64 k x 128 rows; w as 3-d, its contiguous axis innermost:
// (N, K, G) in boxes of 64 n x 64 k (MN-major B, w as it lies) or (K, N, G)
// in boxes of 64 k x BN n (kKMajorB: K-major B, w read transposed).
// Persistent: block b takes items b, b + gridDim.x, ...; item i is column
// tile i % tiles_n of row slot i / tiles_n (find_row_tile's), so the
// blocks at work at one time share a few experts' weights. The producer
// runs on into the block's next tile while the consumers finish one.
template <bool kKMajorB>
__global__ void __launch_bounds__(THREADS, 1)
    grouped_gemm_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const int* __restrict__ gs, bf16_t* __restrict__ y,
                        int R, int K, int N, int G, int items) {
  using C = GemmRing;
  const int tiles_n = (N + BN - 1) / BN;
  const int nk = (K + BK - 1) / BK;
  const uint32_t base = ring_init<C>();
  int it = 0;
  if (threadIdx.x >= CONSUMERS) {
    const void* mx = &tx;
    const void* mw = &tw;
    if (threadIdx.x == CONSUMERS)
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int n0 = i % tiles_n * BN;
        const RowTile t = find_row_tile(gs, G, R, BM, i / tiles_n);
        if (t.group < 0) continue;  // no tile, or rows past the groups
        produce<C>(base, it, nk, [=](uint32_t a, uint32_t b, uint32_t bar,
                                     int k0) {
          // a group's last tile loads rows of the next group too: their
          // products are never stored (store_staged's rows)
          hop::tma_load_2d(a, mx, bar, k0, t.row0);
          if constexpr (kKMajorB) {
            hop::tma_load_3d(b, mw, bar, k0, n0, t.group);
          } else {
#pragma unroll
            for (int p = 0; p < BN / 64; ++p)
              hop::tma_load_3d(b + p * PART, mw, bar, n0 + 64 * p, k0,
                               t.group);
          }
        });
      }
    return;
  }
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int n0 = i % tiles_n * BN;
    const RowTile t = find_row_tile(gs, G, R, BM, i / tiles_n);
    if (t.group == kNoTile) continue;
    bf16_t* o = y + (long long)t.row0 * N + n0;
    if (t.group == kTailRows) {
      zero_out(o, N, t.row1 - t.row0, N - n0);  // rows past the groups
      continue;
    }
    float acc[BN / 2];
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    consume<C, 0, kKMajorB ? 0 : 1>(base, it, nk, BK, acc);
    store_staged(acc, base + C::STAGED, o, N, t.row1 - t.row0, N - n0);
  }
  if (threadIdx.x < BM) hop::bulk_wait<0>();
}

// out [G, M, N]: out[g] = x_g^T . ct_g, bf16, x [R, M] and ct [R, N] as 2-d
// tensor maps (M, R) and (N, R) in boxes of 64 values x 64 rows: both
// operands MN-major, the depth (the group's rows, from its first) down the
// boxes' rows. Block i is output tile i % tiles of the group of rank i /
// tiles, the longest groups first, so the long group's tiles start in the
// first wave and the short ones fill the SMs beside them; a tile walks its
// group's rows in order (no atomics, no second pass); an empty group's
// tiles write zeros.
__global__ void __launch_bounds__(THREADS, 1)
    grouped_outer_kernel(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tc,
                         const int* __restrict__ gs, bf16_t* __restrict__ out,
                         int R, int M, int N, int G) {
  using C = OuterRing;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const Ranked s = nth_longest(gs, G, R, (int)blockIdx.x / tiles);
  const int tile = (int)blockIdx.x % tiles;
  const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
  bf16_t* o = out + ((long long)s.group * M + m0) * N + n0;
  if (s.count == 0) {
    if (threadIdx.x < CONSUMERS) {
      zero_out(o, N, M - m0, N - n0);  // an empty group's tile
    }
    return;
  }
  const uint32_t base = ring_init<C>();
  const int nk = (s.count + BK - 1) / BK;
  int it = 0;
  if (threadIdx.x >= CONSUMERS) {
    const void* mx = &tx;
    const void* mc = &tc;
    if (threadIdx.x == CONSUMERS)
      produce<C>(base, it, nk, [=](uint32_t a, uint32_t b, uint32_t bar,
                                   int k0) {
        const int r = s.start + k0;
#pragma unroll
        for (int p = 0; p < 2; ++p)
          hop::tma_load_2d(a + p * PART, mx, bar, m0 + 64 * p, r);
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          hop::tma_load_2d(b + p * PART, mc, bar, n0 + 64 * p, r);
      });
    return;
  }
  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
  consume<C, 1, 1>(base, it, nk, s.count - (nk - 1) * BK, acc);
  store_tile(acc, o, N, M - m0, N - n0);
}

// dynamic shared memory above 48 KB for kern, once a device: the first
// (eager) call sets it, before any capture
template <int KIND>
cudaError_t allow_smem(const void* kern, size_t bytes) {
  static bool set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dev])) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
}

// the persistent forward's grid: a block an SM, or fewer for fewer items
cudaError_t gemm_blocks(long long items, int* blocks) {
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n = dev < 64 ? sms[dev] : 0;
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) sms[dev] = n;
  }
  *blocks = (int)(items < n ? items : n);
  return cudaSuccess;
}

template <bool kKMajorB>
cudaError_t launch_gemm(const void* x, const void* w, const int* gs, void* y,
                        int R, int K, int N, int G, long long w_sg,
                        long long w_sk, long long w_sn, cudaStream_t st) {
  const long long items = ((R + BM - 1) / BM + (long long)G + 1) *
                          ((N + BN - 1) / BN);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t x_bytes[1] = {2 * (cuuint64_t)K};
  const cuuint32_t x_box[2] = {BK, BM};
  // w's contiguous axis innermost: n as it lies, k read transposed
  const cuuint64_t w_dims[3] = {(cuuint64_t)(kKMajorB ? K : N),
                                (cuuint64_t)(kKMajorB ? N : K), (cuuint64_t)G};
  const cuuint64_t w_bytes[2] = {2 * (cuuint64_t)(kKMajorB ? w_sn : w_sk),
                                 2 * (cuuint64_t)w_sg};
  const cuuint32_t w_box[3] = {64, kKMajorB ? BN : BK, 1};
  cudaError_t err;
  int blocks = 0;
  auto kern = grouped_gemm_kernel<kKMajorB>;
  if ((err = hop::bf16_map_128b(&mx, x, 2, x_dims, x_bytes, x_box)) ||
      (err = hop::bf16_map_128b(&mw, w, 3, w_dims, w_bytes, w_box)) ||
      (err = allow_smem<kKMajorB>((const void*)kern, GemmRing::BYTES)) ||
      (err = gemm_blocks(items, &blocks)))
    return err;
  kern<<<blocks, THREADS, GemmRing::BYTES, st>>>(
      mx, mw, gs, static_cast<bf16_t*>(y), R, K, N, G, (int)items);
  return cudaGetLastError();
}

cudaError_t launch_outer(const void* x, const void* ct, const int* gs,
                         void* out, int R, int M, int N, int G,
                         cudaStream_t st) {
  const long long items =
      (long long)G * ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap mx, mc;
  const cuuint64_t x_dims[2] = {(cuuint64_t)M, (cuuint64_t)R};
  const cuuint64_t x_bytes[1] = {2 * (cuuint64_t)M};
  const cuuint64_t c_dims[2] = {(cuuint64_t)N, (cuuint64_t)R};
  const cuuint64_t c_bytes[1] = {2 * (cuuint64_t)N};
  const cuuint32_t box[2] = {64, BK};
  cudaError_t err;
  if ((err = hop::bf16_map_128b(&mx, x, 2, x_dims, x_bytes, box)) ||
      (err = hop::bf16_map_128b(&mc, ct, 2, c_dims, c_bytes, box)) ||
      (err = allow_smem<2>((const void*)grouped_outer_kernel,
                           OuterRing::BYTES)))
    return err;
  grouped_outer_kernel<<<(unsigned)items, THREADS, OuterRing::BYTES, st>>>(
      mx, mc, gs, static_cast<bf16_t*>(out), R, M, N, G);
  return cudaGetLastError();
}

}  // namespace tc

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// -- f32: R1's chains on a cp.async ring -------------------------------------

namespace f32 {

// cp.async of 16 or 4 bytes; with ok false nothing is read and the
// destination is zero-filled (src-size 0)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hop::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hop::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// BM x BN outputs a block, TM x TN a thread, the depth in tiles of BK,
// STAGES tiles in the ring, MINB blocks an SM asked of the compiler (MINB_WT
// where w is read transposed)
template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_,
          int MINB_, int XV_ = 4, int MINB_WT_ = MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_, MINB = MINB_, MINB_WT = MINB_WT_;
  static constexpr int XV = XV_;  // x's reads (w as it lies): XV k's each
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  static constexpr int XP = BK + 4;  // a [p][k] stage's pitch: odd float4s
  static_assert(BK % 16 == 0 && BN % 16 == 0 && XP % 8 == 4, "tile");
};

// The forward's tilings (f32_tiling in ops/grouped_matmul.py picks one by
// R; scripts/b8_f32_sweep.py times them): few rows (the served decode
// steps), R1's few-row tile (16 x 16, 2 x 1 a thread, BK 128, a ring of
// 4): a group's row slot of at most 16 rows reads its expert's weights
// once, in narrow blocks that spread one expert over many SMs; the prefill
// buckets, R1's 64 x 64 (4 x 4 a thread, BK 32, a ring of 3), whose grid
// fills the card where 128 x 128 tiles leave N = 768 under one wave; many
// rows (training, evals), 128 x 128, 8 x 8 a thread (w as it lies: per 2
// k's 12 reads from shared memory, 8 of x and 4 of w, feed 128 FMAs), BK
// 32, a ring of 3, two blocks an SM where w lies as it is, one (no 128
// registers' cap: 4 k's of 8 columns held a step) where it is read
// transposed. The outer: 128 x 128, 8 x 8, its depth (the group's rows) in
// stages of 16, a ring of 4.
using FewTile = Tile<16, 16, 128, 2, 1, 4, 1>;
using MidTile = Tile<64, 64, 32, 4, 4, 3, 2>;
using WideTile = Tile<128, 128, 32, 8, 8, 3, 2, 2, 1>;
using OuterTile = Tile<128, 128, 16, 8, 8, 4, 2>;
enum Tiling { kFew = 0, kMid = 1, kWide = 2 };

// An operand's tile source: element (r, c) at base[r * ld + c * cs] for r
// < rows and c < cols, zero elsewhere; vec: 16-byte copies (cs 1, ld, cols
// and base 16-byte aligned, checked on the host), else 4-byte ones.
struct Src {
  const float* base;
  long long ld, cs;
  int rows, cols, vec;
};

// ROWS x COLS elements of s from (row0, col0) into dst (pitch P)
template <int ROWS, int COLS, int P, int THREADS>
__device__ __forceinline__ void stage(float* dst, const Src& s, int row0,
                                      int col0) {
  if (s.vec) {
    constexpr int CH = COLS / 4;
    for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
      const int r = c / CH, cc = c % CH * 4, gr = row0 + r, gc = col0 + cc;
      const bool ok = gr < s.rows && gc < s.cols;
      cp16(dst + r * P + cc, ok ? s.base + gr * s.ld + gc : s.base, ok);
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * COLS; c += THREADS) {
      const int r = c / COLS, cc = c % COLS, gr = row0 + r, gc = col0 + cc;
      const bool ok = gr < s.rows && gc < s.cols;
      cp4(dst + r * P + cc, ok ? s.base + gr * s.ld + gc * s.cs : s.base,
          ok);
    }
  }
}

// The ring: depth tiles kt0 .. kt1-1, each staged by load(slot, kt) into
// one of S slots and chained by chain(slot, kt) in order, one barrier a
// tile: while the threads chain over tile kt, tiles kt+1 .. kt+S-1 are in
// flight. A tile goes into the slot chained a tile ago, free once every
// thread has passed this tile's barrier. The ring ends free for another.
template <int S, class Load, class Chain>
__device__ __forceinline__ void ring(int kt0, int kt1, Load load,
                                     Chain chain) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (kt0 + s < kt1) load(s, kt0 + s);
    hop::cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    hop::cp_async_wait<S - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; slot (kt - 1) % S is free
    const int next = kt + S - 1;
    if (next < kt1) load((next - kt0) % S, next);
    hop::cp_async_commit();
    chain((kt - kt0) % S, kt);
  }
  hop::cp_async_wait<0>();
  __syncthreads();
}

// V consecutive k's of a [p][k] stage row, one 8- or 16-byte read
template <int V>
__device__ __forceinline__ void load_k(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
    static_assert(V == 2, "a read of 2 or 4 k's");
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  }
}

// w [K, N] staged as it lies: a thread's columns, where TN is a multiple of
// 4 in groups of 4 neighbours (float4 reads, a warp's 8-thread phases on
// 128 contiguous bytes), else one every TX
template <class T>
__device__ __forceinline__ int kn_col(int tx, int j) {
  if constexpr (T::TN % 4 == 0)
    return (j / 4) * (T::TX * 4) + tx * 4 + (j % 4);
  else
    return tx + j * T::TX;
}

// w's stage: [BK][BN] as it lies (KN), [BN][BK + 4] read transposed
template <class T, bool KN>
struct WStage {
  static constexpr int ROWS = KN ? T::BK : T::BN;
  static constexpr int COLS = KN ? T::BN : T::BK;
  static constexpr int PITCH = KN ? T::BN : T::XP;
  static constexpr int FLOATS = ROWS * PITCH;
};

template <class T, bool KN>
constexpr size_t gemm_smem() {
  return sizeof(float) * T::STAGES * (T::BM * T::XP + WStage<T, KN>::FLOATS);
}

constexpr size_t outer_smem() {
  using T = OuterTile;
  return sizeof(float) * T::STAGES * T::BK * (T::BM + T::BN);
}

// tc::allow_smem's kind of an f32 kernel (0-2 are the TMA kernels'): 3-8
// the forward's tilings, w read transposed then as it lies, 9 the outer
template <class T, bool KN>
constexpr int smem_kind() {
  return (std::is_same<T, FewTile>::value   ? 3
          : std::is_same<T, MidTile>::value ? 5
                                            : 7) +
         KN;
}
constexpr int kOuterSmemKind = 9;

// acc += the chains of 4 k's from kk (fewer when kmax - kk < 4, only in the
// last tile): every element's FMAs in k order, x first (R1's chain_quad). x
// is staged [BM][BK + 4] (rows ty + i TY), read XV k's at a time where w
// lies as it is (the 128-row tile reads pairs: fewer registers held), 4
// where w is read transposed; w as WStage.
template <class T, bool KN, bool FULL>
__device__ __forceinline__ void chain_quad(float (&acc)[T::TM][T::TN],
                                           const float* xs, const float* ws,
                                           int tx, int ty, int kk, int kmax) {
  if constexpr (KN) {
#pragma unroll
    for (int h = 0; h < 4; h += T::XV) {
      float a[T::TM][T::XV];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
        load_k(a[i], xs + (ty + i * T::TY) * T::XP + kk + h);
#pragma unroll
      for (int q = 0; q < T::XV; ++q) {
        if (!FULL && kk + h + q >= kmax) break;
        const float* wr = ws + (kk + h + q) * T::BN;
        float b[T::TN];
        if constexpr (T::TN % 4 == 0) {
#pragma unroll
          for (int j = 0; j < T::TN; j += 4) {
            const float4 v =
                *reinterpret_cast<const float4*>(wr + kn_col<T>(tx, j));
            b[j] = v.x;
            b[j + 1] = v.y;
            b[j + 2] = v.z;
            b[j + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < T::TN; ++j) b[j] = wr[kn_col<T>(tx, j)];
        }
#pragma unroll
        for (int i = 0; i < T::TM; ++i) {
#pragma unroll
          for (int j = 0; j < T::TN; ++j)
            acc[i][j] = fmaf(a[i][q], b[j], acc[i][j]);
        }
      }
    }
  } else {
    float b[T::TN][4];
#pragma unroll
    for (int j = 0; j < T::TN; ++j)
      load_k(b[j], ws + (tx + j * T::TX) * T::XP + kk);
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      float a[4];
      load_k(a, xs + (ty + i * T::TY) * T::XP + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!FULL && kk + q >= kmax) break;
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(a[q], b[j][q], acc[i][j]);
      }
    }
  }
}

// acc += the chains of one depth tile of kmax k's: a full tile unrolled,
// the last one's kmax < BK k's a quad at a time
template <class T, bool KN>
__device__ __forceinline__ void chain_tile(float (&acc)[T::TM][T::TN],
                                           const float* xs, const float* ws,
                                           int tx, int ty, int kmax) {
  if (kmax == T::BK) {
#pragma unroll
    for (int kk = 0; kk < T::BK; kk += 4)
      chain_quad<T, KN, true>(acc, xs, ws, tx, ty, kk, T::BK);
  } else {
#pragma unroll 1
    for (int kk = 0; kk < kmax; kk += 4)
      chain_quad<T, KN, false>(acc, xs, ws, tx, ty, kk, kmax);
  }
}

// rows x cols f32 zeros at o (row pitch ld)
template <int THREADS>
__device__ __forceinline__ void zero_rows(float* o, long long ld, int rows,
                                          int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += THREADS)
    o[(long long)(e / cols) * ld + e % cols] = 0.f;
}

// y [R, N] = x [R, K] . w[g(r)], f32, w's element (g, k, n) at w + g w_sg
// + k w_sk + n w_sn: as it lies (KN: w_sn 1, or any strides in 4-byte
// copies) or read transposed (w_sk 1). Block b is column tile b % tiles_n
// of row slot b / tiles_n (find_row_tile at BM): one group's rows, one
// expert's weights; the slots past the groups zero the rows past sum(gs).
// Each output element is one fmaf chain over k = 0 .. K-1 in order from
// 0.0f, held by one thread (R1's rule): the tile's rows past the group's
// end are zero-filled and never stored, and no k past K is chained.
template <class T, bool KN>
__global__ void __launch_bounds__(T::THREADS, KN ? T::MINB : T::MINB_WT)
    grouped_gemm_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            const int* __restrict__ gs,
                            float* __restrict__ y, int R, int K, int N, int G,
                            long long w_sg, long long w_sk, long long w_sn,
                            int x_vec, int w_vec, int y_vec) {
  using WS = WStage<T, KN>;
  const int tiles_n = (N + T::BN - 1) / T::BN;
  const RowTile t = find_row_tile(gs, G, R, T::BM, (int)blockIdx.x / tiles_n);
  if (t.group == kNoTile) return;
  const int n0 = (int)blockIdx.x % tiles_n * T::BN;
  const int rows = t.row1 - t.row0, cols = min(N - n0, T::BN);
  float* o = y + (long long)t.row0 * N + n0;
  if (t.group == kTailRows) {
    zero_rows<T::THREADS>(o, N, rows, cols);  // the f32 rows past sum(gs)
    return;
  }
  extern __shared__ __align__(16) float f32_smem[];
  float* xs = f32_smem;
  float* ws = f32_smem + T::STAGES * T::BM * T::XP;
  const Src xa{x + (long long)t.row0 * K, K, 1, rows, K, x_vec};
  const float* wg = w + t.group * w_sg + n0 * w_sn;
  const Src wb = KN ? Src{wg, w_sk, w_sn, K, N - n0, w_vec}
                    : Src{wg, w_sn, w_sk, N - n0, K, w_vec};
  const auto load = [&](int slot, int kt) {
    const int k0 = kt * T::BK;
    stage<T::BM, T::BK, T::XP, T::THREADS>(xs + slot * T::BM * T::XP, xa, 0,
                                           k0);
    stage<WS::ROWS, WS::COLS, WS::PITCH, T::THREADS>(
        ws + slot * WS::FLOATS, wb, KN ? k0 : 0, KN ? 0 : k0);
  };
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  const auto chain = [&](float(&a)[T::TM][T::TN], int slot, int kt) {
    chain_tile<T, KN>(a, xs + slot * T::BM * T::XP, ws + slot * WS::FLOATS,
                      tx, ty, min(T::BK, K - kt * T::BK));
  };
  const int KT = (K + T::BK - 1) / T::BK;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  ring<T::STAGES>(0, KT, load,
                  [&](int slot, int kt) { chain(acc, slot, kt); });
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = ty + i * T::TY;
    if (r >= rows) continue;
    float* yr = o + (long long)r * N;
    if (KN && T::TN % 4 == 0 && y_vec) {
#pragma unroll
      for (int j = 0; j < T::TN; j += 4) {
        const int c = kn_col<T>(tx, j);
        if (c < cols)
          *reinterpret_cast<float4*>(yr + c) = make_float4(
              acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const int c = KN ? kn_col<T>(tx, j) : tx + j * T::TX;
        if (c < cols) yr[c] = acc[i][j];
      }
    }
  }
}

// out [G, M, N]: out[g] = x_g^T . ct_g, f32, x [R, M] and ct [R, N]
// contiguous. Block i is output tile i % tiles of the group of rank i /
// tiles, the longest groups first (tc::nth_longest, as the bf16 outer), so
// the long group's tiles start in the first wave; an empty group's tiles
// write zeros. Both operands stream as they lie, a stage of 16 of the
// group's rows [16][128] each, read as float4s of 4 m's and 4 n's: each
// element is one fmaf chain over the group's rows in order from its first,
// from 0.0f (the rows are never split); the rows past the group's end are
// zero-filled and never chained.
template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
    grouped_outer_f32_kernel(const float* __restrict__ x,
                             const float* __restrict__ ct,
                             const int* __restrict__ gs,
                             float* __restrict__ out, int R, int M, int N,
                             int G, int x_vec, int ct_vec, int o_vec) {
  const int tiles_n = (N + T::BN - 1) / T::BN;
  const int tiles = (M + T::BM - 1) / T::BM * tiles_n;
  const tc::Ranked s = tc::nth_longest(gs, G, R, (int)blockIdx.x / tiles);
  const int tile = (int)blockIdx.x % tiles;
  const int m0 = tile / tiles_n * T::BM, n0 = tile % tiles_n * T::BN;
  const int rows = min(M - m0, T::BM), cols = min(N - n0, T::BN);
  float* o = out + ((long long)s.group * M + m0) * N + n0;
  if (s.count == 0) {
    zero_rows<T::THREADS>(o, N, rows, cols);  // an empty group's f32 tile
    return;
  }
  const int depth = s.count;  // the chains' steps: the group's rows
  extern __shared__ __align__(16) float f32_smem[];
  float* xs = f32_smem;
  float* cs = f32_smem + T::STAGES * T::BK * T::BM;
  const Src xa{x + (long long)s.start * M + m0, M, 1, depth, M - m0, x_vec};
  const Src cb{ct + (long long)s.start * N + n0, N, 1, depth, N - n0, ct_vec};
  const auto load = [&](int slot, int kt) {
    stage<T::BK, T::BM, T::BM, T::THREADS>(xs + slot * T::BK * T::BM, xa,
                                           kt * T::BK, 0);
    stage<T::BK, T::BN, T::BN, T::THREADS>(cs + slot * T::BK * T::BN, cb,
                                           kt * T::BK, 0);
  };
  // this thread's rows m = 4 TY (i / 4) + 4 ty + i % 4 and columns n = 4
  // TX (j / 4) + 4 tx + j % 4: float4s of each operand a step
  const int tx = threadIdx.x % T::TX, ty = threadIdx.x / T::TX;
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  const auto step = [&](const float* xr, const float* cr) {
    float a[T::TM], b[T::TN];
#pragma unroll
    for (int i = 0; i < T::TM; i += 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(xr + T::TY * i + 4 * ty);
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < T::TN; j += 4) {
      const float4 v =
          *reinterpret_cast<const float4*>(cr + T::TX * j + 4 * tx);
      b[j] = v.x;
      b[j + 1] = v.y;
      b[j + 2] = v.z;
      b[j + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  };
  const auto chain = [&](int slot, int kt) {
    const float* xr = xs + slot * T::BK * T::BM;
    const float* cr = cs + slot * T::BK * T::BN;
    const int kmax = min(T::BK, depth - kt * T::BK);
    if (kmax == T::BK) {
#pragma unroll
      for (int k = 0; k < T::BK; ++k) step(xr + k * T::BM, cr + k * T::BN);
    } else {
#pragma unroll 1
      for (int k = 0; k < kmax; ++k) step(xr + k * T::BM, cr + k * T::BN);
    }
  };
  ring<T::STAGES>(0, (depth + T::BK - 1) / T::BK, load, chain);
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = T::TY * (i / 4) * 4 + 4 * ty + i % 4;
    if (r >= rows) continue;
    float* orow = o + (long long)r * N;
#pragma unroll
    for (int j = 0; j < T::TN; j += 4) {
      const int c = T::TX * j + 4 * tx;
      if (o_vec && c < cols) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(
            acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < cols) orow[c + q] = acc[i][j + q];
      }
    }
  }
}

template <class T, bool KN>
cudaError_t launch_tiled(const float* x, const float* w, const int* gs,
                        float* y, int R, int K, int N, int G, long long w_sg,
                        long long w_sk, long long w_sn, int x_vec, int w_vec,
                        int y_vec, cudaStream_t st) {
  constexpr size_t smem = gemm_smem<T, KN>();
  static_assert(smem <= 232448, "shared memory");
  const long long blocks = ((R + T::BM - 1) / T::BM + (long long)G + 1) *
                           ((N + T::BN - 1) / T::BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = grouped_gemm_f32_kernel<T, KN>;
  cudaError_t err =
      tc::allow_smem<smem_kind<T, KN>()>((const void*)kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, T::THREADS, smem, st>>>(
      x, w, gs, y, R, K, N, G, w_sg, w_sk, w_sn, x_vec, w_vec, y_vec);
  return cudaGetLastError();
}

// w as it lies unless its k axis alone is contiguous (read transposed)
template <class T>
cudaError_t launch_gemm_f32(const float* x, const float* w, const int* gs,
                            float* y, int R, int K, int N, int G,
                            long long w_sg, long long w_sk, long long w_sn,
                            cudaStream_t st) {
  const bool kn = w_sn == 1 || w_sk != 1;
  // 16-byte copies: the contiguous axis's extent, the other's stride and
  // the expert stride multiples of 4 floats, from an aligned base
  const int x_vec = K % 4 == 0 && aligned16(x);
  const int w_vec = aligned16(w) && w_sg % 4 == 0 &&
                    (kn ? w_sn == 1 && N % 4 == 0 && w_sk % 4 == 0
                        : K % 4 == 0 && w_sn % 4 == 0);
  const int y_vec = N % 4 == 0 && aligned16(y);
  return kn ? launch_tiled<T, true>(x, w, gs, y, R, K, N, G, w_sg, w_sk, w_sn,
                                   x_vec, w_vec, y_vec, st)
            : launch_tiled<T, false>(x, w, gs, y, R, K, N, G, w_sg, w_sk, w_sn,
                                    x_vec, w_vec, y_vec, st);
}

cudaError_t launch_outer_f32(const float* x, const float* ct, const int* gs,
                             float* out, int R, int M, int N, int G,
                             cudaStream_t st) {
  using T = OuterTile;
  const long long blocks = (long long)G * ((M + T::BM - 1) / T::BM) *
                           ((N + T::BN - 1) / T::BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = grouped_outer_f32_kernel<T>;
  cudaError_t err =
      tc::allow_smem<kOuterSmemKind>((const void*)kern, outer_smem());
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, T::THREADS, outer_smem(), st>>>(
      x, ct, gs, out, R, M, N, G, M % 4 == 0 && aligned16(x),
      N % 4 == 0 && aligned16(ct), N % 4 == 0 && aligned16(out));
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// y [R, N] (contiguous) = x [R, K] (contiguous) . w[g(r)] with w's element
// (g, k, n) at w + g * w_sg + k * w_sk + n * w_sn (elements; [G, K, N]
// contiguous is (K N, N, 1), w [G, N, K] read transposed (K N, 1, K)), gs
// [G] int32 on the device; bf16 1 for bf16 tensors, 0 for f32. bf16 runs
// the TMA path, which takes x, w and y 16-byte aligned, K and N multiples
// of 8, w_sg a multiple of 8 and one of w's k and n axes contiguous, the
// other's stride a multiple of 8, and returns cudaErrorInvalidValue for
// any other view (gym_grouped_gemm_ref takes every bf16 view). f32 runs
// the ring kernels on any view at `tiling` (enum f32::Tiling: 0 few rows,
// 1 the prefill buckets, 2 many rows; the host's f32_tiling), which bf16
// ignores.
int gym_grouped_gemm(const void* x, const void* w, const void* gs, void* y,
                     int R, int K, int N, int G, long long w_sg,
                     long long w_sk, long long w_sn, int bf16, int tiling,
                     void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* g = static_cast<const int*>(gs);
  if (bf16) {
    const bool kmajor = w_sk == 1;
    if (!(aligned16(x) && aligned16(w) && aligned16(y) && K % 8 == 0 &&
          N % 8 == 0 && w_sg % 8 == 0 &&
          (kmajor ? w_sn % 8 == 0 : w_sn == 1 && w_sk % 8 == 0)))
      return (int)cudaErrorInvalidValue;
    return (int)(kmajor ? tc::launch_gemm<true>(x, w, g, y, R, K, N, G, w_sg,
                                                w_sk, w_sn, st)
                        : tc::launch_gemm<false>(x, w, g, y, R, K, N, G,
                                                 w_sg, w_sk, w_sn, st));
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  if (tiling == f32::kFew)
    return (int)f32::launch_gemm_f32<f32::FewTile>(xf, wf, g, yf, R, K, N, G,
                                                   w_sg, w_sk, w_sn, st);
  if (tiling == f32::kMid)
    return (int)f32::launch_gemm_f32<f32::MidTile>(xf, wf, g, yf, R, K, N, G,
                                                   w_sg, w_sk, w_sn, st);
  if (tiling == f32::kWide)
    return (int)f32::launch_gemm_f32<f32::WideTile>(xf, wf, g, yf, R, K, N,
                                                    G, w_sg, w_sk, w_sn, st);
  return (int)cudaErrorInvalidValue;
}

// The same product on the first kernels, any view: bf16 (1) on
// grouped_gemm_ref_kernel (mma.sync, one shared stage), the TMA path's
// oracle and the path of the views it does not take; f32 (0) on
// grouped_gemm_f32_ref_kernel (R1's chains, one shared stage), the ring
// kernels' oracle.
int gym_grouped_gemm_ref(const void* x, const void* w, const void* gs,
                         void* y, int R, int K, int N, int G, long long w_sg,
                         long long w_sk, long long w_sn, int bf16,
                         void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const int bt = bf16 ? kBT : kFT;
  const long long slots = (R + bt - 1) / bt + (long long)G + 1;
  if (slots > 0x7fffffffLL || (N + bt - 1) / bt > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)slots, (unsigned)((N + bt - 1) / bt));
  cudaStream_t st = (cudaStream_t)stream;
  const int* g = static_cast<const int*>(gs);
  if (!bf16) {
    grouped_gemm_f32_ref_kernel<<<grid, kThreads, 0, st>>>(
        x, w, g, y, R, K, N, G, w_sg, w_sk, w_sn, 0, 0);
    return (int)cudaGetLastError();
  }
  // 16-byte chunks: 8 bf16 along the contiguous axis, each chunk's start a
  // multiple of 8 elements from an aligned base
  const int x_vec = aligned16(x) && K % 8 == 0;
  const int w_vec = aligned16(w) && w_sg % 8 == 0 &&
                    (w_sk == 1 ? w_sn % 8 == 0 : (w_sn == 1 && w_sk % 8 == 0));
  grouped_gemm_ref_kernel<<<grid, kThreads, 0, st>>>(
      x, w, g, y, R, K, N, G, w_sg, w_sk, w_sn, x_vec, w_vec);
  return (int)cudaGetLastError();
}

// out [G, M, N] (contiguous) = x_g^T . ct_g for each group g, x [R, M] and
// ct [R, N] contiguous, gs [G] int32 on the device. bf16 runs the TMA path,
// which takes R > 0, x, ct and out 16-byte aligned and M and N multiples
// of 8 (else cudaErrorInvalidValue; gym_grouped_outer_ref takes any); f32
// the ring kernel.
int gym_grouped_outer(const void* x, const void* ct, const void* gs,
                      void* out, int R, int M, int N, int G, int bf16,
                      void* stream) {
  if (R < 0 || M <= 0 || N <= 0 || G <= 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* g = static_cast<const int*>(gs);
  if (bf16) {
    if (!(R > 0 && aligned16(x) && aligned16(ct) && aligned16(out) &&
          M % 8 == 0 && N % 8 == 0))
      return (int)cudaErrorInvalidValue;
    return (int)tc::launch_outer(x, ct, g, out, R, M, N, G, st);
  }
  return (int)f32::launch_outer_f32(static_cast<const float*>(x),
                                static_cast<const float*>(ct), g,
                                static_cast<float*>(out), R, M, N, G, st);
}

// The outer product on the first kernels, any view: bf16 (1) on
// grouped_outer_ref_kernel, f32 (0) on grouped_outer_f32_ref_kernel.
int gym_grouped_outer_ref(const void* x, const void* ct, const void* gs,
                          void* out, int R, int M, int N, int G, int bf16,
                          void* stream) {
  if (R < 0 || M <= 0 || N <= 0 || G <= 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const int bt = bf16 ? kBT : kFT;
  const long long tiles =
      (long long)((M + bt - 1) / bt) * ((N + bt - 1) / bt);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)G);
  cudaStream_t st = (cudaStream_t)stream;
  const int* g = static_cast<const int*>(gs);
  if (!bf16) {
    grouped_outer_f32_ref_kernel<<<grid, kThreads, 0, st>>>(
        x, ct, g, out, R, M, N, G, 0, 0);
    return (int)cudaGetLastError();
  }
  const int x_vec = aligned16(x) && M % 8 == 0;
  const int ct_vec = aligned16(ct) && N % 8 == 0;
  grouped_outer_ref_kernel<<<grid, kThreads, 0, st>>>(
      x, ct, g, out, R, M, N, G, x_vec, ct_vec);
  return (int)cudaGetLastError();
}

// Blocks of a B8 kernel resident on one SM (kind 0: the TMA grouped_gemm
// with w as it lies, 1: w read transposed, 2: the TMA grouped_outer; f32:
// 3 and 4 the few-row forward, w read transposed and as it lies, 5 and 6
// the prefill buckets', 7 and 8 the many-row one, 9 the outer), or a
// negative cudaError_t; threads gets its threads a block, regs its
// registers a thread and smem its dynamic shared memory.
int gym_grouped_occupancy(int kind, int* threads, int* regs,
                          long long* smem) {
  using namespace f32;
  struct Kind {
    const void* kern;
    size_t bytes;
    int threads;
    cudaError_t (*allow)(const void*, size_t);
  };
  const Kind kinds[] = {
      {(const void*)tc::grouped_gemm_kernel<false>, tc::GemmRing::BYTES,
       tc::THREADS, tc::allow_smem<0>},
      {(const void*)tc::grouped_gemm_kernel<true>, tc::GemmRing::BYTES,
       tc::THREADS, tc::allow_smem<1>},
      {(const void*)tc::grouped_outer_kernel, tc::OuterRing::BYTES,
       tc::THREADS, tc::allow_smem<2>},
      {(const void*)grouped_gemm_f32_kernel<FewTile, false>,
       gemm_smem<FewTile, false>(), FewTile::THREADS,
       tc::allow_smem<smem_kind<FewTile, false>()>},
      {(const void*)grouped_gemm_f32_kernel<FewTile, true>,
       gemm_smem<FewTile, true>(), FewTile::THREADS,
       tc::allow_smem<smem_kind<FewTile, true>()>},
      {(const void*)grouped_gemm_f32_kernel<MidTile, false>,
       gemm_smem<MidTile, false>(), MidTile::THREADS,
       tc::allow_smem<smem_kind<MidTile, false>()>},
      {(const void*)grouped_gemm_f32_kernel<MidTile, true>,
       gemm_smem<MidTile, true>(), MidTile::THREADS,
       tc::allow_smem<smem_kind<MidTile, true>()>},
      {(const void*)grouped_gemm_f32_kernel<WideTile, false>,
       gemm_smem<WideTile, false>(), WideTile::THREADS,
       tc::allow_smem<smem_kind<WideTile, false>()>},
      {(const void*)grouped_gemm_f32_kernel<WideTile, true>,
       gemm_smem<WideTile, true>(), WideTile::THREADS,
       tc::allow_smem<smem_kind<WideTile, true>()>},
      {(const void*)grouped_outer_f32_kernel<OuterTile>, outer_smem(),
       OuterTile::THREADS, tc::allow_smem<kOuterSmemKind>}};
  if (kind < 0 || kind >= (int)(sizeof(kinds) / sizeof(kinds[0])))
    return -(int)cudaErrorInvalidValue;
  const Kind& k = kinds[kind];
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err = k.allow(k.kern, k.bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k.kern);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.kern,
                                                        k.threads, k.bytes);
  if (err != cudaSuccess) return -(int)err;
  *threads = k.threads;
  *regs = attr.numRegs;
  *smem = (long long)k.bytes;
  return blocks;
}

}  // extern "C"
