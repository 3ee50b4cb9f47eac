// R1 and L1: the serving path's row-invariant f32 ops on Hopper.
//
// R1, y[M, N] = x[M, K] . W (+ bias): every dense layer and the tied lm head
// (x . wte^T, the same code with W read transposed) of the decode forward.
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
// the rounded result. No split-K, and no order that depends on M, on the
// row's place, or on the N tile: the two tilings below (one for a few rows,
// one for many) compute every element the same way, so a row's bits are the
// same at M = 1, 16, 80 and 1024. TF32 is not used: the path is f32.
// Bound: at decode's 16 rows, bytes (the weights are read once: 495 MB a
// step of GPT-2 base, ~0.148 ms at 3.35 TB/s); at a 1024-row prefill, the
// f32 FMAs (67 TFLOP/s). The design is the simple tiled SIMT one: x and W
// tiles in shared memory, a few outputs a thread, no pipelining, far from
// both bounds. At a few rows each block waits on its tiles' loads between
// two barriers, K / BK times: the few-row tiling of the dense layers takes
// one output a thread and 16 columns a block (48 blocks for GPT-2's
// 768-wide layers) and K in tiles of 128 (6 waits at K = 768, 24 at 3072);
// the lm head keeps 64 columns a block, where x's reloads would cost as
// much as W.
//
// L1's contract: one warp a row; each lane sums its columns lane, lane+32,
// ... in order, the 32 partial sums are combined by an xor butterfly (the
// same bits on every lane), so a row's statistics are fixed by C alone.
// Bound: bytes (read x once, write y once).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// BM x BN outputs a block, TM x TN a thread (columns tx + j * BN / TN), K in
// tiles of BK; W's element (k, n) at w[k * N + n] (KN) or w[n * K + k].
template <int BM, int BN, int BK, int TM, int TN, bool KN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    row_gemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
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
      if (gn < N && gk < K)
        v = KN ? w[(long long)gk * N + gn] : w[(long long)gn * K + gk];
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

template <int BM, int BN, int BK, int TM, int TN, bool KN>
int launch_gemm(const float* x, const float* w, const float* bias, float* y,
                int M, int N, int K, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  constexpr int threads = (BM / TM) * (BN / TN);
  row_gemm_kernel<BM, BN, BK, TM, TN, KN>
      <<<grid, threads, 0, stream>>>(x, w, bias, y, M, N, K);
  return (int)cudaGetLastError();
}

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

}  // namespace

extern "C" {

// y [M, N] (contiguous) = x [M, K] (contiguous) . W (+ bias [N]); W is
// [K, N] contiguous when w_kn, else [N, K] contiguous (the lm head's wte).
int gym_row_gemm(const void* x, const void* w, const void* bias, void* y,
                 int M, int N, int K, int w_kn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = (cudaStream_t)stream;
  // A few rows, W [K, N]: 16 x 16 outputs a block, one a thread, K in
  // tiles of 128 (N / 16 blocks, few waits between barriers). A few rows,
  // W [N, K] (the lm head, N = 50304): 16 x 64 a block, 4 columns a thread,
  // so each block's x tile serves 64 columns. Many rows: 64 x 64, 4 x 4 a
  // thread. Every tiling chains each element over k alike.
  if (M <= 32) {
    if (w_kn) return launch_gemm<16, 16, 128, 1, 1, true>(xf, wf, bf, yf, M,
                                                          N, K, s);
    return launch_gemm<16, 64, 32, 1, 4, false>(xf, wf, bf, yf, M, N, K, s);
  }
  if (w_kn) return launch_gemm<64, 64, 16, 4, 4, true>(xf, wf, bf, yf, M, N,
                                                       K, s);
  return launch_gemm<64, 64, 16, 4, 4, false>(xf, wf, bf, yf, M, N, K, s);
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

}  // extern "C"
