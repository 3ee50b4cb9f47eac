// R1 and L1: the serving path's row-invariant f32 ops on Hopper.
//
// R1, y[M, N] = x[M, K] . W (+ bias): every dense layer and the tied lm head
// (x . wte^T, the same code with W read transposed) of the decode forward,
// and the sampler's scan (row_cumsum: [R * V/32, 32] x [32, 32]).
// It replaces XLA's dots of nn.Dense and wte.attend under decode=True
// (gym_tpu/models/nanogpt.py: _proj's nn.Dense :253, wte.attend :662; no
// pl.pallas_call kernel). L1 is the decode forward's layer norm (flax
// nn.LayerNorm, :515,519,656: f32 mean and E[x^2] - E[x]^2, then
// (x - mean) * (rsqrt(var + eps) * scale) + bias).
//
// Why kernels: the serving engine's contracts are equalities between one
// row computed at different batch geometries (one slot alone and among 16,
// a prompt and its power-of-two bucket, one position and a verify chunk).
// cuBLAS picks its algorithm by shape (gemv at M = 1, split-K and other
// tiles elsewhere) and PyTorch's reductions pick their thread layout by the
// row count, so the same row can come out in other bits, and a last-bit
// difference at a near-tie turns into another sampled token.
//
// R1's contract: each output element is one sequential FMA chain over
// k = 0 .. K-1, held by one thread, started at 0.0f; the bias is added to
// the rounded result. No split-K, no atomics, no tensor cores (TF32 would
// round the operands), and no order that depends on M, on the row's place
// or on the tile: every tiling below computes every element the same way,
// so the dispatch may pick a tiling by shape freely and a row's bits are
// the same at M = 1, 16, 80 and 1024. A k step past K is never taken (a
// zero-padded step would turn a -0.0 sum into +0.0).
//
// The kernel (row_gemm_pipe_kernel): a block computes a BM x BN tile of y,
// each thread TM x TN elements of it (rows ty + i * TY, so that a warp's
// x reads are broadcasts or hit distinct banks), K in tiles of BK. x and W
// stream through a ring of STAGES shared-memory stages kept full by
// cp.async (16-byte copies where the rows are 16-byte aligned, else 4-byte
// ones; both zero-fill past the edges), one barrier a k tile: while the
// threads chain over tile kt, tiles kt+1 .. kt+STAGES-1 are in flight. A
// full tile's chains are unrolled. x is staged [BM][BK + 4] (rows
// contiguous in k, a pitch of an odd number of 16-byte units) and read as
// float4s of 4 k's; W is staged as it lies: [BK][BN] for W [K, N] (read a
// k row at a time, float4s of 4 columns where TN is a multiple of 4) or
// [BN][BK + 4] for W [N, K] (the lm head: float4s of 4 k's). The block
// index walks the row blocks first, so the blocks that share a W tile run
// together and read it once from memory. Tilings (choose_tiling):
//  - few rows (decode's 16; also many rows of a small output), W [K, N]:
//    16 x 16, 2 x 1 a thread, BK 128, 4 stages: few chains a thread and
//    narrow blocks, so the 768-wide layers still spread over 48 blocks;
//  - many rows (prefill buckets, verify chunks), W [K, N]: 64 x 64 (4 x 4
//    a thread) or 128 x 64 (8 x 4);
//  - the lm head and every W [N, K]: 16 x 128, 16 x 2 a thread (all 16
//    rows: each staged weight feeds 16 chains), BK 32, 4 stages;
//  - the scan (N <= 32): 32 x 32, 1 x 8 a thread, one k tile.
// Bounds: at decode's 16 rows, bytes (the weights are read once: 495 MB a
// step of GPT-2 base, ~0.148 ms at 3.35 TB/s) and, where K is large, the
// chain itself (K dependent FMAs of ~4 cycles: 6.2 us at K = 3072); at a
// 1024-row prefill, the f32 FMAs (67 TFLOP/s); the scan, bytes. The
// few-row tiling stays well above both (chip_smoke.py phase 7 prints each
// time beside its bound and chain floor): its chains advance far slower
// than once every 4 cycles, no thread tile tried (1-8 chains a thread, 1-4
// warps an SM, vector W reads) changed that rate, and its cause is not
// measured (PERF.md).
//
// B6, the same y = x . dequant(q, scale) (+ bias) over quantized weights:
// the QuantDense layers and the quantized tied lm head of a quantized
// serving config. It replaces XLA's fusion of dequantize_tiles into the
// dots of quantized_dot / quantized_attend (gym_tpu/ops/grouped_matmul.py
// :253,265, under QuantDense :190 and QuantEmbed.attend :242 of
// gym_tpu/models/nanogpt.py; no pl.pallas_call kernel). q is int8 (int4
// values are stored in int8), W's layout R1's ([K, N] or [N, K]), with one
// f32 scale per t consecutive elements of the row-major q; t divides the
// trailing axis (quant_tile_for), so a row of q holds cols / t whole tiles
// and element (row, col) takes scale[row * (cols / t) + col / t].
// B6's contract: bit for bit R1 on dequantize_tiles(q, scale), at every M.
// The int8 tiles ride the same ring (a quarter of R1's bytes); at each k
// tile one pass turns the landed int8 stage into an f32 tile, each weight
// once: ws = __fmul_rn((float)q, scale), one rounding (the conversion of an
// int8 is exact), JAX's q.astype(f32) * scale; __fmul_rn, so that -fmad
// never contracts the dequant into the product. A pass, not a dequant at
// each read: the chains then run R1's own code on R1's tile, and a weight
// that feeds TM rows of every thread of its column is converted once per
// block, not once per thread. Bound: bytes at a few rows, the f32 FMAs at
// a prefill, as R1.
//
// The oracle (row_gemm_ref_kernel): R1 and B6 as first written (x and W
// tiles in shared memory between two barriers, no pipelining), whose bits
// the served path has always had. It is not on the serving path: the card
// checks hold every new tiling to it bit for bit (gym_row_gemm_ref,
// gym_row_qgemm_ref).
//
// L1's contract: one warp a row; each lane sums its columns lane, lane+32,
// ... in order, the 32 partial sums are combined by an xor butterfly (the
// same bits on every lane), so a row's statistics are fixed by C alone.
// Bound: bytes (read x once, write y once).
//
// L1 with the residual add it follows (row_add_layer_norm_kernel, the
// decode forward's every layer norm: each reads a sum an add just wrote,
// the embeddings', the attention's residual or the MLP's): s = x + d, one
// IEEE rounding (__fadd_rn, never contracted), written out as the residual
// stream, and y = L1(s) with L1's contract and arithmetic. A lane holds its
// columns of x and d in registers (NC a lane, all loaded before the sums),
// so x and d are read once and s written once, and the sum and the sum of
// squares run in L1's order; blocks of 2 warps, so decode's 16 rows spread
// over 8 SMs. Where the oracle's compiled code fuses a product into an add
// (the variance, the scale-and-shift), the kernel writes fmaf. Bound: bytes
// (x and d read once, s and y written once). row_layer_norm_kernel, L1 as
// first written, is its oracle (a torch add, then it: the same bits).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// -- the oracle: R1 and B6 as first written ---------------------------------

// W's element at (row, col) of its row-major storage ([K, N] or [N, K],
// cols the trailing extent), read through the read-only cache: R1's f32
// weights as they are, B6's int8 weights dequantized with their tile's
// scale.
struct F32W {
  const float* w;
  __device__ __forceinline__ float operator()(int row, int col,
                                              int cols) const {
    return __ldg(w + (long long)row * cols + col);
  }
};

struct QuantW {
  const int8_t* q;
  const float* scale;
  int t;      // elements a scale; divides cols
  int shift;  // log2(t) when t is a power of two (GPT-2's 256), else -1
  int tpr;    // scales a row: cols / t
  __device__ __forceinline__ float operator()(int row, int col,
                                              int cols) const {
    const int tile = shift >= 0 ? col >> shift : col / t;
    const float s = __ldg(scale + (long long)row * tpr + tile);
    return __fmul_rn((float)__ldg(q + (long long)row * cols + col), s);
  }
};

// BM x BN outputs a block, TM x TN a thread (columns tx + j * BN / TN), K in
// tiles of BK; W's element (k, n) at (k, n) of a [K, N] storage (KN) or at
// (n, k) of an [N, K] one.
template <int BM, int BN, int BK, int TM, int TN, bool KN, class W>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    row_gemm_ref_kernel(const float* __restrict__ x, W w,
                        const float* __restrict__ bias, float* __restrict__ y,
                        int M, int N, int K) {
  constexpr int TX = BN / TN, THREADS = (BM / TM) * TX;
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int mm = i / BK, kk = i % BK, gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      int kk, nn;
      if (KN) {
        kk = i / BN;
        nn = i % BN;
      } else {
        nn = i / BK;
        kk = i % BK;
      }
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < K) v = KN ? w(gk, gn, N) : w(gn, gk, K);
      ws[kk][nn] = v;
    }
    __syncthreads();
    const int kmax = min(BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N)
        y[(long long)gm * N + gn] = bias ? acc[i][j] + bias[gn] : acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, bool KN, class W>
int launch_ref(const float* x, W w, const float* bias, float* y, int M, int N,
               int K, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  constexpr int threads = (BM / TM) * (BN / TN);
  row_gemm_ref_kernel<BM, BN, BK, TM, TN, KN, W>
      <<<grid, threads, 0, stream>>>(x, w, bias, y, M, N, K);
  return (int)cudaGetLastError();
}

// The oracle's tilings, one for each weight loader: a few rows, W [K, N]:
// 16 x 16 outputs a block, one a thread, K in tiles of 128. A few rows, W
// [N, K]: 16 x 64 a block, 4 columns a thread. Many rows: 64 x 64, 4 x 4 a
// thread.
template <class W>
int dispatch_ref(const float* x, W w, const float* bias, float* y, int M,
                 int N, int K, int w_kn, cudaStream_t s) {
  if (M <= 32) {
    if (w_kn) return launch_ref<16, 16, 128, 1, 1, true>(x, w, bias, y, M, N,
                                                         K, s);
    return launch_ref<16, 64, 32, 1, 4, false>(x, w, bias, y, M, N, K, s);
  }
  if (w_kn) return launch_ref<64, 64, 16, 4, 4, true>(x, w, bias, y, M, N, K,
                                                      s);
  return launch_ref<64, 64, 16, 4, 4, false>(x, w, bias, y, M, N, K, s);
}

// -- the pipelined kernel ----------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes; with ok false nothing is read and the
// destination is zero-filled (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the weights as the kernel reads them from memory
struct F32Src {
  const float* w;
};

struct Q8Src {
  const int8_t* q;
  const float* scale;
  int t, shift, tpr;  // as QuantW
};

// how a stage's rows are copied: 16-byte cp.async (rows 16-byte aligned),
// 4-byte cp.async, or (int8 rows not 4-byte aligned) plain loads and stores
enum CopyMode { kCopy16 = 0, kCopy4 = 1, kCopySync = 2 };

template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_,
          int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  static constexpr int XP = BK + 4;  // x's pitch: an odd number of float4s
  static_assert(BK % 16 == 0 && BN % 16 == 0 && XP % 8 == 4, "tile");
};

using FewTile = Tile<16, 16, 128, 2, 1, 4, 1>;
using MidTile = Tile<64, 64, 32, 4, 4, 3, 2>;
using WideTile = Tile<128, 64, 32, 8, 4, 3, 1>;
using ScanTile = Tile<32, 32, 32, 1, 8, 2, 1>;
using NkTile = Tile<16, 128, 32, 16, 2, 4, 1>;

// the tilings' numbers in the dispatch (gym_row_gemm's ``tiling``)
enum Tiling { kFew = 0, kMid, kWide, kScan, kNk, kTilings };

// W's stage: [BK][BN] for W [K, N], [BN][BK + 4] for W [N, K]
template <class T, bool KN>
struct WTile {
  static constexpr int ROWS = KN ? T::BK : T::BN;
  static constexpr int COLS = KN ? T::BN : T::BK;
  static constexpr int PITCH = KN ? T::BN : T::BK + 4;
};

template <class T, bool KN, class Src>
constexpr size_t pipe_smem_bytes() {
  using WT = WTile<T, KN>;
  constexpr size_t x = sizeof(float) * T::BM * T::XP;
  constexpr size_t wf = sizeof(float) * WT::ROWS * WT::PITCH;
  if constexpr (std::is_same<Src, Q8Src>::value)
    return T::STAGES * (x + WT::ROWS * WT::COLS) + wf;
  else
    return T::STAGES * (x + wf);
}

// ROWS x COLS floats of a row-major [rows, cols] source from (row0, col0)
// into dst (pitch P), zero past the edges
template <int ROWS, int COLS, int P, int THREADS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int row0, int col0, int rows,
                                          int cols, int mode, int tid) {
  if (mode == kCopy16) {
    constexpr int CH = COLS / 4;
    for (int c = tid; c < ROWS * CH; c += THREADS) {
      const int r = c / CH, cc = (c % CH) * 4, gr = row0 + r, gc = col0 + cc;
      const bool ok = gr < rows && gc < cols;
      cp_async16(dst + r * P + cc, ok ? src + (long long)gr * cols + gc : src,
                 ok);
    }
  } else {
    for (int c = tid; c < ROWS * COLS; c += THREADS) {
      const int r = c / COLS, cc = c % COLS, gr = row0 + r, gc = col0 + cc;
      const bool ok = gr < rows && gc < cols;
      cp_async4(dst + r * P + cc, ok ? src + (long long)gr * cols + gc : src,
                ok);
    }
  }
}

// the int8 counterpart, pitch COLS bytes
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage_q8(int8_t* dst, const int8_t* src,
                                         int row0, int col0, int rows,
                                         int cols, int mode, int tid) {
  const int ch = mode == kCopy16 ? 16 : mode == kCopy4 ? 4 : 1;
  for (int c = tid; c < ROWS * COLS / ch; c += THREADS) {
    const int r = c / (COLS / ch), cc = (c % (COLS / ch)) * ch;
    const int gr = row0 + r, gc = col0 + cc;
    const bool ok = gr < rows && gc < cols;
    const int8_t* g = ok ? src + (long long)gr * cols + gc : src;
    if (mode == kCopy16)
      cp_async16(dst + r * COLS + cc, g, ok);
    else if (mode == kCopy4)
      cp_async4(dst + r * COLS + cc, g, ok);
    else
      dst[r * COLS + cc] = ok ? __ldg(g) : (int8_t)0;
  }
}

// the landed int8 stage (ROWS x COLS, pitch COLS) into the f32 tile (pitch
// P): each weight once, __fmul_rn((float)q, its tile's scale); four at a
// time where four neighbours share a scale (t a multiple of 4)
template <int ROWS, int COLS, int P, int THREADS>
__device__ __forceinline__ void dequant_stage(float* wf, const int8_t* qs,
                                              const Q8Src& s, int row0,
                                              int col0, int rows, int cols,
                                              int tid) {
  auto scale_of = [&](int gr, int gc) {
    const int tile = s.shift >= 0 ? gc >> s.shift : gc / s.t;
    return __ldg(s.scale + (long long)gr * s.tpr + tile);
  };
  if ((s.t & 3) == 0) {
    constexpr int CH = COLS / 4;
    for (int c = tid; c < ROWS * CH; c += THREADS) {
      const int r = c / CH, cc = (c % CH) * 4, gr = row0 + r, gc = col0 + cc;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < rows && gc < cols) {
        const float sc = scale_of(gr, gc);
        const char4 q = *reinterpret_cast<const char4*>(qs + r * COLS + cc);
        v = make_float4(__fmul_rn((float)q.x, sc), __fmul_rn((float)q.y, sc),
                        __fmul_rn((float)q.z, sc), __fmul_rn((float)q.w, sc));
      }
      *reinterpret_cast<float4*>(wf + r * P + cc) = v;
    }
  } else {
    for (int c = tid; c < ROWS * COLS; c += THREADS) {
      const int r = c / COLS, cc = c % COLS, gr = row0 + r, gc = col0 + cc;
      float v = 0.f;
      if (gr < rows && gc < cols)
        v = __fmul_rn((float)qs[r * COLS + cc], scale_of(gr, gc));
      wf[r * P + cc] = v;
    }
  }
}

__device__ __forceinline__ float f4at(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// W [K, N]: a thread's columns. Where TN is a multiple of 4, in groups of
// 4 neighbours (float4 reads, a warp's 8-thread phases on 128 contiguous
// bytes); else one column every TX.
template <class T>
__device__ __forceinline__ int kn_col(int tx, int j) {
  if constexpr (T::TN % 4 == 0)
    return (j / 4) * (T::TX * 4) + tx * 4 + (j % 4);
  else
    return tx + j * T::TX;
}

// acc += the chains of 4 k's from kk (fewer when kmax - kk < 4, only in
// the last tile): every element's FMAs in k order, x first, as the oracle
template <class T, bool KN, bool FULL>
__device__ __forceinline__ void chain_quad(float (&acc)[T::TM][T::TN],
                                           const float* xs, const float* ws,
                                           int tx, int ty, int kk, int kmax) {
  using WT = WTile<T, KN>;
  if constexpr (KN) {
    float4 a[T::TM];
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(xs + (ty + i * T::TY) * T::XP
                                              + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!FULL && kk + q >= kmax) break;
      const float* wr = ws + (kk + q) * WT::PITCH;
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
        const float xa = f4at(a[i], q);
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(xa, b[j], acc[i][j]);
      }
    }
  } else {
    float4 b[T::TN];
#pragma unroll
    for (int j = 0; j < T::TN; ++j)
      b[j] = *reinterpret_cast<const float4*>(ws + (tx + j * T::TX)
                                              * WT::PITCH + kk);
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(
          xs + (ty + i * T::TY) * T::XP + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!FULL && kk + q >= kmax) break;
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = fmaf(f4at(a, q), f4at(b[j], q), acc[i][j]);
      }
    }
  }
}

// acc += the chains of one k tile: a full tile unrolled (the compiler
// hoists its shared-memory reads ahead of the chains), the last one's
// kmax < BK k's a quad at a time
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

template <class T, bool KN, class Src>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
    row_gemm_pipe_kernel(const float* __restrict__ x, Src src,
                         const float* __restrict__ bias, float* __restrict__ y,
                         int M, int N, int K, int x_mode, int w_mode) {
  using WT = WTile<T, KN>;
  constexpr bool kQuant = std::is_same<Src, Q8Src>::value;
  constexpr int S = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  // R1: S f32 W stages; B6: S int8 stages, then one f32 tile
  unsigned char* wbase = smem + sizeof(float) * S * T::BM * T::XP;
  float* wf = reinterpret_cast<float*>(
      wbase + (kQuant ? (size_t)S * WT::ROWS * WT::COLS : 0));

  const int tid = threadIdx.x, tx = tid % T::TX, ty = tid / T::TX;
  const int row_blocks = (M + T::BM - 1) / T::BM;
  const int m0 = (blockIdx.x % row_blocks) * T::BM;
  const int n0 = (blockIdx.x / row_blocks) * T::BN;
  const int KT = (K + T::BK - 1) / T::BK;
  // W's rows and columns as stored: [K, N] or [N, K]
  const int w_rows = KN ? K : N, w_cols = KN ? N : K;

  auto load = [&](int slot, int kt) {
    const int k0 = kt * T::BK;
    stage_f32<T::BM, T::BK, T::XP, T::THREADS>(
        xs + slot * T::BM * T::XP, x, m0, k0, M, K, x_mode, tid);
    const int r0 = KN ? k0 : n0, c0 = KN ? n0 : k0;
    if constexpr (kQuant) {
      stage_q8<WT::ROWS, WT::COLS, T::THREADS>(
          reinterpret_cast<int8_t*>(wbase) + slot * WT::ROWS * WT::COLS,
          src.q, r0, c0, w_rows, w_cols, w_mode, tid);
    } else {
      stage_f32<WT::ROWS, WT::COLS, WT::PITCH, T::THREADS>(
          reinterpret_cast<float*>(wbase) + slot * WT::ROWS * WT::PITCH,
          src.w, r0, c0, w_rows, w_cols, w_mode, tid);
    }
  };

  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();         // ... everyone's; slot (kt - 1) % S is free
    if (kt + S - 1 < KT) load((kt + S - 1) % S, kt + S - 1);
    cp_async_commit();
    const int slot = kt % S;
    const float* ws;
    if constexpr (kQuant) {
      const int k0 = kt * T::BK;
      dequant_stage<WT::ROWS, WT::COLS, WT::PITCH, T::THREADS>(
          wf, reinterpret_cast<const int8_t*>(wbase) + slot * WT::ROWS *
                  WT::COLS,
          src, KN ? k0 : n0, KN ? n0 : k0, w_rows, w_cols, tid);
      __syncthreads();
      ws = wf;
    } else {
      ws = reinterpret_cast<const float*>(wbase) + slot * WT::ROWS *
           WT::PITCH;
    }
    chain_tile<T, KN>(acc, xs + slot * T::BM * T::XP, ws, tx, ty,
                      min(T::BK, K - kt * T::BK));
  }
  cp_async_wait<0>();

  const bool vec_out = KN && T::TN % 4 == 0 && (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int gm = m0 + ty + i * T::TY;
    if (gm >= M) continue;
    float* yr = y + (long long)gm * N;
    if (vec_out) {
#pragma unroll
      for (int j = 0; j < T::TN; j += 4) {
        const int gn = n0 + kn_col<T>(tx, j);
        if (gn >= N) continue;
        float4 v = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                               acc[i][j + 3]);
        if (bias) {
          v.x += bias[gn];
          v.y += bias[gn + 1];
          v.z += bias[gn + 2];
          v.w += bias[gn + 3];
        }
        *reinterpret_cast<float4*>(yr + gn) = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const int gn = n0 + (KN ? kn_col<T>(tx, j) : tx + j * T::TX);
        if (gn < N) yr[gn] = bias ? acc[i][j] + bias[gn] : acc[i][j];
      }
    }
  }
}

template <class T, bool KN, class Src>
int launch_pipe(const float* x, Src src, const float* bias, float* y, int M,
                int N, int K, int x_mode, int w_mode, cudaStream_t stream) {
  constexpr size_t smem = pipe_smem_bytes<T, KN, Src>();
  static_assert(smem <= 232448, "shared memory");
  auto kernel = row_gemm_pipe_kernel<T, KN, Src>;
  // above 48 KB only once the attribute is set, on each device
  static bool attr_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && dev < 64 && !attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const long long blocks = (long long)((M + T::BM - 1) / T::BM) *
                           ((N + T::BN - 1) / T::BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, T::THREADS, smem, stream>>>(
      x, src, bias, y, M, N, K, x_mode, w_mode);
  return (int)cudaGetLastError();
}

// The tiling of a call. W [N, K] and the scan (N <= 32) have one each, a
// few rows of W [K, N] (M <= 32) the few-row one. Many rows: the few-row
// tiling while M * N is at most about 2304 outputs an SM (its 2 chains a
// thread spread a small output over every SM, and its chains stay short
// where K is long), else 128 x 64 where its blocks fill 55-100% of one
// wave of 132 or at least 2.2 waves, else 64 x 64 (its waves of two blocks
// an SM quantise less). Picked from scripts/r1_sweep.py on the H100: at
// every GPT-2 base shape of M = 33-1024 it is the fastest tiling or within
// 2% of it.
int choose_tiling(int M, int N, int w_kn) {
  if (!w_kn) return kNk;
  if (N <= 32) return kScan;
  if (M <= 32 || (long long)M * N <= 2304LL * 132) return kFew;
  const long long wide = (long long)((M + WideTile::BM - 1) / WideTile::BM) *
                         ((N + WideTile::BN - 1) / WideTile::BN);
  return (wide >= 72 && wide <= 132) || wide >= 288 ? kWide : kMid;
}

template <class Src>
int dispatch_pipe(const float* x, Src src, const float* bias, float* y, int M,
                  int N, int K, int w_kn, int tiling, int x_mode, int w_mode,
                  cudaStream_t s) {
  if (tiling < 0) tiling = choose_tiling(M, N, w_kn);
  if (!w_kn) {
    if (tiling != kNk) return (int)cudaErrorInvalidValue;
    return launch_pipe<NkTile, false>(x, src, bias, y, M, N, K, x_mode,
                                      w_mode, s);
  }
  switch (tiling) {
    case kFew:
      return launch_pipe<FewTile, true>(x, src, bias, y, M, N, K, x_mode,
                                        w_mode, s);
    case kMid:
      return launch_pipe<MidTile, true>(x, src, bias, y, M, N, K, x_mode,
                                        w_mode, s);
    case kWide:
      return launch_pipe<WideTile, true>(x, src, bias, y, M, N, K, x_mode,
                                         w_mode, s);
    case kScan:
      return launch_pipe<ScanTile, true>(x, src, bias, y, M, N, K, x_mode,
                                         w_mode, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

constexpr int kLnWarps = 8;

__global__ void __launch_bounds__(kLnWarps * 32)
    row_layer_norm_kernel(const float* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          float* __restrict__ y, int M, int C, float eps) {
  const int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = x + (long long)row * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = xr[c];
    s += v;
    s2 = fmaf(v, v, s2);
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / C, mean2 = s2 / C;
  const float var = fmaxf(mean2 - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  float* yr = y + (long long)row * C;
  for (int c = lane; c < C; c += 32) {
    float v = (xr[c] - mean) * (inv * scale[c]);
    if (bias) v += bias[c];
    yr[c] = v;
  }
}

constexpr int kAddLnWarps = 2;

// a row's statistics from its lanes' sums: L1's arithmetic
struct LnStats {
  float mean, inv;
  __device__ __forceinline__ LnStats(float s, float s2, int C, float eps) {
    s = warp_sum(s);
    s2 = warp_sum(s2);
    mean = s / C;
    const float mean2 = s2 / C;
    const float var = fmaxf(fmaf(-mean, mean, mean2), 0.f);
    inv = rsqrtf(var + eps);
  }
  __device__ __forceinline__ float out(float v, float scale,
                                       const float* bias, float b) {
    return bias ? fmaf(v - mean, inv * scale, b) : (v - mean) * (inv * scale);
  }
};

// NC columns a lane in registers (C <= 32 * NC); NC = 0 for wider rows:
// the same arithmetic, x and d read twice
template <int NC>
__global__ void __launch_bounds__(kAddLnWarps * 32)
    row_add_layer_norm_kernel(const float* __restrict__ x,
                              const float* __restrict__ d,
                              const float* __restrict__ scale,
                              const float* __restrict__ bias,
                              float* __restrict__ s_out,
                              float* __restrict__ y, int M, int C,
                              float eps) {
  const int row = blockIdx.x * kAddLnWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const long long base = (long long)row * C;
  float s = 0.f, s2 = 0.f;
  if constexpr (NC > 0) {
    // x, d and (up to 32 columns a lane) scale and bias, all loaded ahead
    constexpr int NP = NC <= 32 ? NC : 1;
    float v[NC], dv[NC], sc[NP], bi[NP];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < C ? x[base + c] : 0.f;
      dv[i] = c < C ? d[base + c] : 0.f;
      if (NC <= 32) {
        sc[i % NP] = c < C ? scale[c] : 0.f;
        bi[i % NP] = c < C && bias ? bias[c] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      v[i] = __fadd_rn(v[i], dv[i]);
      if (c < C) {
        if (s_out) s_out[base + c] = v[i];
        s += v[i];
        s2 = fmaf(v[i], v[i], s2);
      }
    }
    LnStats st(s, s2, C, eps);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + 32 * i;
      if (c >= C) continue;
      if (NC <= 32)
        y[base + c] = st.out(v[i], sc[i % NP], bias, bi[i % NP]);
      else
        y[base + c] = st.out(v[i], scale[c], bias, bias ? bias[c] : 0.f);
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float v = __fadd_rn(x[base + c], d[base + c]);
      if (s_out) s_out[base + c] = v;
      s += v;
      s2 = fmaf(v, v, s2);
    }
    LnStats st(s, s2, C, eps);
    for (int c = lane; c < C; c += 32)
      y[base + c] = st.out(__fadd_rn(x[base + c], d[base + c]), scale[c],
                           bias, bias ? bias[c] : 0.f);
  }
}

template <int NC>
int launch_add_ln(const float* x, const float* d, const float* scale,
                  const float* bias, float* s, float* y, int M, int C,
                  float eps, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((M + kAddLnWarps - 1) / kAddLnWarps);
  row_add_layer_norm_kernel<NC><<<blocks, kAddLnWarps * 32, 0, stream>>>(
      x, d, scale, bias, s, y, M, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y [M, N] (contiguous) = x [M, K] (contiguous) . W (+ bias [N]); W is
// [K, N] contiguous when w_kn, else [N, K] contiguous (the lm head's wte).
// tiling: -1 for the dispatch's choice, else one of enum Tiling that fits
// the layout (a sweep's).
int gym_row_gemm(const void* x, const void* w, const void* bias, void* y,
                 int M, int N, int K, int w_kn, int tiling, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int cols = w_kn ? N : K;
  const int x_mode = (K % 4 == 0 && aligned16(x)) ? kCopy16 : kCopy4;
  const int w_mode = (cols % 4 == 0 && aligned16(w)) ? kCopy16 : kCopy4;
  return dispatch_pipe(static_cast<const float*>(x),
                       F32Src{static_cast<const float*>(w)},
                       static_cast<const float*>(bias), static_cast<float*>(y),
                       M, N, K, w_kn, tiling, x_mode, w_mode,
                       (cudaStream_t)stream);
}

// B6: y [M, N] (contiguous) = x [M, K] (contiguous) . dequant(q, scale)
// (+ bias [N]); q int8, [K, N] contiguous when w_kn, else [N, K]
// contiguous; scale f32, one per t consecutive elements of q, t dividing
// q's trailing extent. tiling as gym_row_gemm's.
int gym_row_qgemm(const void* x, const void* q, const void* scale,
                  const void* bias, void* y, int M, int N, int K, int w_kn,
                  int t, int tiling, void* stream) {
  const int cols = w_kn ? N : K;
  if (M <= 0 || N <= 0 || K <= 0 || t <= 0 || cols % t)
    return (int)cudaErrorInvalidValue;
  const int shift = (t & (t - 1)) == 0 ? __builtin_ctz(t) : -1;
  const int x_mode = (K % 4 == 0 && aligned16(x)) ? kCopy16 : kCopy4;
  const uintptr_t qa = (uintptr_t)q;
  const int w_mode = (cols % 16 == 0 && (qa & 15) == 0) ? kCopy16
                     : (cols % 4 == 0 && (qa & 3) == 0) ? kCopy4
                                                        : kCopySync;
  return dispatch_pipe(static_cast<const float*>(x),
                       Q8Src{static_cast<const int8_t*>(q),
                             static_cast<const float*>(scale), t, shift,
                             cols / t},
                       static_cast<const float*>(bias), static_cast<float*>(y),
                       M, N, K, w_kn, tiling, x_mode, w_mode,
                       (cudaStream_t)stream);
}

// The tiling gym_row_gemm and gym_row_qgemm pick for a shape (enum Tiling).
int gym_row_gemm_tiling(int M, int N, int w_kn) {
  return choose_tiling(M, N, w_kn);
}

// The oracle, gym_row_gemm's and gym_row_qgemm's arguments without tiling.
int gym_row_gemm_ref(const void* x, const void* w, const void* bias, void* y,
                     int M, int N, int K, int w_kn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return dispatch_ref(static_cast<const float*>(x),
                      F32W{static_cast<const float*>(w)},
                      static_cast<const float*>(bias), static_cast<float*>(y),
                      M, N, K, w_kn, (cudaStream_t)stream);
}

int gym_row_qgemm_ref(const void* x, const void* q, const void* scale,
                      const void* bias, void* y, int M, int N, int K,
                      int w_kn, int t, void* stream) {
  const int cols = w_kn ? N : K;
  if (M <= 0 || N <= 0 || K <= 0 || t <= 0 || cols % t)
    return (int)cudaErrorInvalidValue;
  const int shift = (t & (t - 1)) == 0 ? __builtin_ctz(t) : -1;
  return dispatch_ref(static_cast<const float*>(x),
                      QuantW{static_cast<const int8_t*>(q),
                             static_cast<const float*>(scale), t, shift,
                             cols / t},
                      static_cast<const float*>(bias), static_cast<float*>(y),
                      M, N, K, w_kn, (cudaStream_t)stream);
}

// y [M, C] = layer norm of each row of x [M, C] (contiguous), scale [C],
// bias [C] or null.
int gym_row_layer_norm(const void* x, const void* scale, const void* bias,
                       void* y, int M, int C, float eps, void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + kLnWarps - 1) / kLnWarps);
  row_layer_norm_kernel<<<blocks, kLnWarps * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(y), M, C, eps);
  return (int)cudaGetLastError();
}

// s [M, C] = x + d and y [M, C] = layer norm of each row of s, all
// contiguous; scale [C], bias [C] or null; s null when only y is wanted.
int gym_row_add_layer_norm(const void* x, const void* d, const void* scale,
                           const void* bias, void* s, void* y, int M, int C,
                           float eps, void* stream) {
  if (M <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(d);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* sf = static_cast<float*>(s);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (C + 31) / 32;
  if (nc <= 4) return launch_add_ln<4>(xf, df, sc, bi, sf, yf, M, C, eps, st);
  if (nc <= 8) return launch_add_ln<8>(xf, df, sc, bi, sf, yf, M, C, eps, st);
  if (nc <= 16)
    return launch_add_ln<16>(xf, df, sc, bi, sf, yf, M, C, eps, st);
  if (nc <= 24)
    return launch_add_ln<24>(xf, df, sc, bi, sf, yf, M, C, eps, st);
  if (nc <= 32)
    return launch_add_ln<32>(xf, df, sc, bi, sf, yf, M, C, eps, st);
  if (nc <= 64)
    return launch_add_ln<64>(xf, df, sc, bi, sf, yf, M, C, eps, st);
  return launch_add_ln<0>(xf, df, sc, bi, sf, yf, M, C, eps, st);
}

}  // extern "C"
