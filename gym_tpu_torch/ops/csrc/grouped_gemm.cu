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
// walks the group sizes to its own tile (an exclusive cumsum of the sizes,
// each clamped so that no group passes R), so the host never reads gs and a
// CUDA graph can hold the launch. The grid is sized from the static R, G, K
// and N alone:
//  - grouped_gemm_kernel: blockIdx.x is a row slot, blockIdx.y a column
//    tile. The row slots enumerate each group's tiles of BM rows, group by
//    group, so a tile never straddles two groups and reads one expert; the
//    slots after them zero the rows past sum(gs). sum over g of
//    ceil(gs[g] / BM) plus the tail's tiles is at most R / BM + G + 1, the
//    grid's row slots; a slot past them all exits.
//  - grouped_outer_kernel: blockIdx.y is the group, blockIdx.x an (M tile,
//    N tile) of its output. The block walks its group's rows in order, so
//    there are no atomics and the sums are the same on every run; an empty
//    group writes zeros.
//
// bf16: 128 x 128 tiles, k steps of 32, 8 warps each computing 64 x 32 of
// the tile with mma.sync m16n8k16 (bf16 in, f32 accumulation), one rounding
// to bf16 (round to nearest even) at the store. Both operands are staged in
// shared memory as [128][32 + 8] (k contiguous: a fragment's two k values
// are one 32-bit load, and the pitch of 80 bytes puts the 32 lanes of a
// fragment load on 32 banks), read from device memory in chunks of 8
// elements along whichever axis is contiguous (16-byte loads where aligned,
// else 8 element loads), the next k step's chunks loaded into registers
// while the tensor cores run on this one.
//
// f32: 64 x 64 tiles, k steps of 16, each of 256 threads computing 4 x 4
// elements (rows ty + 16 i, columns tx + 16 j). R1's rule (row_gemm.cu):
// each output element is one in-order fmaf chain over k = 0 .. K-1 started
// at 0.0f, and a k step past K is never taken. So a row's bits do not
// depend on which other rows share its expert, on the tile or on R: what
// the serving engine's splices and park/resume need, and each element is
// bit for bit R1 on the same row and expert (chip_smoke.py phase 16a holds
// it to that).
//
// Bounds at the MoE training shapes (16,384 rows, C 768, H 3072, 8 experts):
// the products, 2 R K N operations at 989 TFLOP/s in bf16 (0.078 ms a
// projection) and at 67 TFLOP/s of f32 FMAs in f32; at decode's few rows,
// the weights' bytes at 3.35 TB/s. This first kernel has no TMA, no wgmma
// and one stage of shared memory: it is right first (PERF.md has its
// times beside these bounds).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_kernel(const void* x, const void* w, const int* gs, void* y,
                        int R, int K, int N, int G, long long w_sg,
                        long long w_sk, long long w_sn, int x_vec,
                        int w_vec) {
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
__global__ void __launch_bounds__(kThreads)
    grouped_outer_kernel(const void* x, const void* ct, const int* gs,
                         void* out, int R, int M, int N, int G, int x_vec,
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// y [R, N] (contiguous) = x [R, K] (contiguous) . w[g(r)] with w's element
// (g, k, n) at w + g * w_sg + k * w_sk + n * w_sn (elements; [G, K, N]
// contiguous is (K N, N, 1), w [G, N, K] read transposed (K N, 1, K)), gs
// [G] int32 on the device; bf16 1 for bf16 tensors, 0 for f32.
int gym_grouped_gemm(const void* x, const void* w, const void* gs, void* y,
                     int R, int K, int N, int G, long long w_sg,
                     long long w_sk, long long w_sn, int bf16, void* stream) {
  if (R <= 0 || K <= 0 || N <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const int bt = bf16 ? kBT : kFT;
  const long long slots = (R + bt - 1) / bt + (long long)G + 1;
  if (slots > 0x7fffffffLL || (N + bt - 1) / bt > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)slots, (unsigned)((N + bt - 1) / bt));
  // 16-byte chunks: 8 bf16 along the contiguous axis, each chunk's start a
  // multiple of 8 elements from an aligned base
  const int x_vec = aligned16(x) && K % 8 == 0;
  const int w_vec = aligned16(w) && w_sg % 8 == 0 &&
                    (w_sk == 1 ? w_sn % 8 == 0 : (w_sn == 1 && w_sk % 8 == 0));
  cudaStream_t st = (cudaStream_t)stream;
  const int* g = static_cast<const int*>(gs);
  if (bf16)
    grouped_gemm_kernel<true><<<grid, kThreads, 0, st>>>(
        x, w, g, y, R, K, N, G, w_sg, w_sk, w_sn, x_vec, w_vec);
  else
    grouped_gemm_kernel<false><<<grid, kThreads, 0, st>>>(
        x, w, g, y, R, K, N, G, w_sg, w_sk, w_sn, 0, 0);
  return (int)cudaGetLastError();
}

// out [G, M, N] (contiguous) = x_g^T . ct_g for each group g, x [R, M] and
// ct [R, N] contiguous, gs [G] int32 on the device.
int gym_grouped_outer(const void* x, const void* ct, const void* gs,
                      void* out, int R, int M, int N, int G, int bf16,
                      void* stream) {
  if (R < 0 || M <= 0 || N <= 0 || G <= 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const int bt = bf16 ? kBT : kFT;
  const long long tiles =
      (long long)((M + bt - 1) / bt) * ((N + bt - 1) / bt);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)G);
  const int x_vec = aligned16(x) && M % 8 == 0;
  const int ct_vec = aligned16(ct) && N % 8 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int* g = static_cast<const int*>(gs);
  if (bf16)
    grouped_outer_kernel<true><<<grid, kThreads, 0, st>>>(
        x, ct, g, out, R, M, N, G, x_vec, ct_vec);
  else
    grouped_outer_kernel<false><<<grid, kThreads, 0, st>>>(
        x, ct, g, out, R, M, N, G, 0, 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
