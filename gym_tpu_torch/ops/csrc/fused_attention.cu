// Whole-context FA2 attention for Hopper (sm_90a): forward and backward.
//
// Replaces the four Pallas kernels of gym_tpu/ops/fused_attention.py:
//   _fwd_packed_kernel (B1) / _blk_fwd_kernel (B3)  ->  forward
//   _bwd_packed_kernel (B2) / _blk_bwd_kernel (B4)  ->  dq and dk/dv kernels
// The backward kernels also serve the long-context flash attention (B5's
// backward, the bundled Pallas kernel's _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq; flash_attention.cu has its forward): their shared
// memory does not grow with T and their offsets are 64-bit, so they take any
// T % 64 == 0 (B5's wrappers take only T % 128 == 0, the bundled kernel's
// rule).
// The packed [B, T, C] and per-head [B, H, T, D] layouts differ only in
// their strides, so every kernel takes element strides (batch, head, token)
// for each tensor; the last dimension must be contiguous. In the packed
// layout q, k and v are the three column slices of the c_attn output
// [B, T, 3C] and are read in place (token stride 3C), with no copy.
//
// Rounding points follow the Pallas kernels: scores in f32 from products of
// the input dtype, times scale; p normalised by l and rounded to v's dtype
// before the PV product (forward); p recomputed as exp(s - lse), rounded to
// do's dtype for dv, delta = rowsum(do * o) in f32, ds = p (dp - delta +
// dlse) scale rounded to q's dtype before dq and dk (backward). The forward
// is two-pass over the key tiles (row max and sum first, then the normalised
// PV product), which keeps the normalise-then-round order of the whole-row
// Pallas softmax. Masked scores (NEG = -1e30 in Pallas) contribute
// exp(-1e30 - m) = 0 exactly, so causal tiles above the diagonal are skipped.
//
// Two implementations, chosen by dtype:
// - bf16 (training): wgmma kernels on the tensor cores (namespace wg). One
//   warpgroup a block owns 64 rows: query rows in the forward and in dq, key
//   rows in dk/dv. Operand tiles sit in shared memory as bf16 in wgmma's
//   swizzled layout (hopper.cuh); the other side's tiles are double-buffered
//   with 16-byte cp.async copies, so the next tile's copy overlaps this
//   tile's products. Scores s = q k^T (dk/dv: s^T = k q^T and dp^T = v do^T,
//   key-major) accumulate in f32 registers; p and ds are rounded to bf16 in
//   registers, where the accumulator layout is already wgmma's register A
//   operand, so the second products (p v, ds k, p^T do, ds^T q) read only
//   their B tile from shared memory. The rounding points above are exactly
//   the bf16 operand conversions. The delta pre-pass is folded into the dq
//   kernel's prologue (it reads o and do for its own rows and writes delta
//   for dk/dv, launched after it).
// - f32 (evals, card-against-CPU checks): the scalar kernels below, f32
//   FMAs on 64 x 64 shared-memory tiles (256 threads, 4 x 4 register
//   micro-tiles). Tensor cores in f32 would mean TF32 and move those
//   results.
//
// What bounds it on this card: each input read once and each output written
// once at 3.35 TB/s against the causal products at 989 TFLOP/s (bf16). At
// the training shapes the whole-context pair is bound by bytes (B1 forward
// N=1024 T=256 C=128 H=4: 0.081 ms; B3 N=8 H=12 T=1024 D=64: 0.015 ms) or
// just by operations (B4: 0.033 ms), and B5's backward (N=2 H=12 T=8192
// D=64, 811.6 M computed pairs) by operations: 0.52 ms. The kernels compute
// more than the bound counts: the forward computes q k^T twice (two passes,
// three products over the computed tiles), and the backward seven products
// where the bound counts five, because dk/dv and dq are separate kernels
// that each own their output rows and recompute s and dp. That keeps the
// backward free of atomics and bit-reproducible run to run, as XLA's is.
// The heaviest causal tiles are scheduled first (the tile index is the
// grid's slowest axis, counted from the last query tile in the forward and
// dq, from the first key tile in dk/dv), so the longest blocks start in the
// first wave.

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- forward

// Replaces _fwd_packed_kernel (B1) and _blk_fwd_kernel (B3): one block per
// (64-row query tile, head, batch row); o and lse for its query rows.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                Strides so, Strides sl, int T_len, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int qb = blockIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qb * BQ;
  const T* qp = q + n * sq.n + h * sq.h;
  const T* kp = k + n * sk.n + h * sk.h;
  const T* vp = v + n * sv.n + h * sv.h;

  load_tile<T, D>(Qs, qp, sq.t, q0);
  const int nkb = causal ? qb + 1 : T_len / BK;

  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  // pass 1: running row max and sum of exp over the key tiles
  for (int kb = 0; kb < nkb; ++kb) {
    __syncthreads();
    load_tile<T, D>(Ks, kp, sk.t, kb * BK);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = kb * BK + tx + 16 * c;
        s[r][c] *= scale;
        if (!causal || j <= i) tmax = fmaxf(tmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float mnew = fmaxf(m[r], tmax);
      float tsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = kb * BK + tx + 16 * c;
        if (!causal || j <= i) tsum += expf(s[r][c] - mnew);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      l[r] = l[r] * expf(m[r] - mnew) + tsum;
      m[r] = mnew;
    }
  }

  // pass 2: p = exp(s - m) / l rounded to v's dtype, then o = p @ v
  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    __syncthreads();
    load_tile<T, D>(Ks, kp, sk.t, kb * BK);
    load_tile<T, D>(Vs, vp, sv.t, kb * BK);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = kb * BK + tx + 16 * c;
        float p = 0.f;
        if (!causal || j <= i) p = expf(s[r][c] * scale - m[r]) / l[r];
        Ps[(ty + 16 * r) * LDP + tx + 16 * c] = round_to(p, v);
      }
    }
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(ty + 16 * r) * LDP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

  T* op = o + n * so.n + h * so.h;
  float* lp = lse + n * sl.n + h * sl.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_f(op + (long long)i * so.t + tx + 16 * c, acc[r][c]);
    if (tx == 0) lp[(long long)i * sl.t] = m[r] + logf(l[r]);
  }
}

// --------------------------------------------------------------- backward

// The backward replaces _bwd_packed_kernel (B2) and _blk_bwd_kernel (B4),
// which compute a whole head per program, with three kernels that each own
// their outputs: the delta pre-pass, dk/dv per key tile, dq per query tile.

// delta[n, h, t] = sum_d do * o in f32 (the FA2 pre-pass), [N, H, T] dense
template <typename T>
__global__ void attn_delta_kernel(const T* __restrict__ o,
                                  const T* __restrict__ dout,
                                  float* __restrict__ delta, Strides so,
                                  Strides sdo, int H, int T_len, int D,
                                  long long rows) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const int t = (int)(idx % T_len);
  const int h = (int)((idx / T_len) % H);
  const long long n = idx / ((long long)T_len * H);
  const T* op = o + n * so.n + h * so.h + t * so.t;
  const T* dp = dout + n * sdo.n + h * sdo.h + t * sdo.t;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(load_f(dp + d), load_f(op + d), acc);
  delta[idx] = acc;
}

// Recompute the 64 x 64 score tile s (scaled) and dp = do @ v^T for query
// rows ty + 16r, key columns tx + 16c.
template <int D>
__device__ __forceinline__ void score_and_dp(const float* Qs, const float* dOs,
                                             const float* Ks, const float* Vs,
                                             int tx, int ty, float s[4][4],
                                             float dp[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[r][c] = 0.f;
      dp[r][c] = 0.f;
    }
  for (int d = 0; d < D; ++d) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = Qs[(ty + 16 * r) * LD + d];
      dov[r] = dOs[(ty + 16 * r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = Ks[(tx + 16 * c) * LD + d];
      vv[c] = Vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(dov[r], vv[c], dp[r][c]);
      }
  }
}

// Row statistics of one query tile: lse, delta and the optional lse
// cotangent (0 where the caller passes none).
__device__ __forceinline__ void load_row_stats(float* Ls, float* Dl, float* Gl,
                                               const float* lse,
                                               const float* delta,
                                               const float* dlse, Strides sl,
                                               Strides sg, long long n, int h,
                                               int H, int T_len, int q0) {
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    const int i = q0 + r;
    Ls[r] = lse[n * sl.n + h * sl.h + (long long)i * sl.t];
    Dl[r] = delta[(n * H + h) * (long long)T_len + i];
    Gl[r] = dlse ? dlse[n * sg.n + h * sg.h + (long long)i * sg.t] : 0.f;
  }
}

struct BwdArgs {
  Strides sq, sk, sv, sdo, sdq, sdk, sdv, sl, sg;
};

// dk, dv for one key tile: loops over the query tiles that see it.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
attn_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ dlse, T* __restrict__ dk,
                 T* __restrict__ dv, BwdArgs a, int H, int T_len, int causal,
                 float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LDP;
  float* Ls = dSs + BQ * LDP;
  float* Dl = Ls + BQ;
  float* Gl = Dl + BQ;

  const int kb = blockIdx.x, h = blockIdx.y;
  const long long n = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kb * BK;
  const T* qp = q + n * a.sq.n + h * a.sq.h;
  const T* kp = k + n * a.sk.n + h * a.sk.h;
  const T* vp = v + n * a.sv.n + h * a.sv.h;
  const T* dop = dout + n * a.sdo.n + h * a.sdo.h;

  load_tile<T, D>(Ks, kp, a.sk.t, k0);
  load_tile<T, D>(Vs, vp, a.sv.t, k0);

  float dkacc[4][DC], dvacc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkacc[r][c] = 0.f;
      dvacc[r][c] = 0.f;
    }

  const int nqb = T_len / BQ;
  for (int qb = causal ? kb : 0; qb < nqb; ++qb) {
    const int q0 = qb * BQ;
    __syncthreads();
    load_tile<T, D>(Qs, qp, a.sq.t, q0);
    load_tile<T, D>(dOs, dop, a.sdo.t, q0);
    load_row_stats(Ls, Dl, Gl, lse, delta, dlse, a.sl, a.sg, n, h, H, T_len,
                   q0);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_and_dp<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ri = ty + 16 * r;
      const int i = q0 + ri;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        float p = 0.f;
        if (!causal || j <= i) p = expf(s[r][c] * scale - Ls[ri]);
        const float ds = p * (dp[r][c] - Dl[ri] + Gl[ri]) * scale;
        Ps[ri * LDP + tx + 16 * c] = round_to(p, dout);
        dSs[ri * LDP + tx + 16 * c] = round_to(ds, q);
      }
    }
    __syncthreads();
    // dv += p^T @ do and dk += ds^T @ q for key rows ty + 16r
    for (int i = 0; i < BQ; ++i) {
      float dov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = dOs[i * LD + tx + 16 * c];
        qv[c] = Qs[i * LD + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[i * LDP + ty + 16 * r];
        const float ds = dSs[i * LDP + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dvacc[r][c] = fmaf(p, dov[c], dvacc[r][c]);
          dkacc[r][c] = fmaf(ds, qv[c], dkacc[r][c]);
        }
      }
    }
  }

  T* dkp = dk + n * a.sdk.n + h * a.sdk.h;
  T* dvp = dv + n * a.sdv.n + h * a.sdv.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long j = k0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store_f(dkp + j * a.sdk.t + tx + 16 * c, dkacc[r][c]);
      store_f(dvp + j * a.sdv.t + tx + 16 * c, dvacc[r][c]);
    }
  }
}

// dq for one query tile: loops over the key tiles it sees.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const float* __restrict__ dlse, T* __restrict__ dq, BwdArgs a,
               int H, int T_len, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* Ls = dSs + BQ * LDP;
  float* Dl = Ls + BQ;
  float* Gl = Dl + BQ;

  const int qb = blockIdx.x, h = blockIdx.y;
  const long long n = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qb * BQ;
  const T* qp = q + n * a.sq.n + h * a.sq.h;
  const T* kp = k + n * a.sk.n + h * a.sk.h;
  const T* vp = v + n * a.sv.n + h * a.sv.h;
  const T* dop = dout + n * a.sdo.n + h * a.sdo.h;

  load_tile<T, D>(Qs, qp, a.sq.t, q0);
  load_tile<T, D>(dOs, dop, a.sdo.t, q0);
  load_row_stats(Ls, Dl, Gl, lse, delta, dlse, a.sl, a.sg, n, h, H, T_len,
                 q0);

  float dqacc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqacc[r][c] = 0.f;

  const int nkb = causal ? qb + 1 : T_len / BK;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();
    load_tile<T, D>(Ks, kp, a.sk.t, k0);
    load_tile<T, D>(Vs, vp, a.sv.t, k0);
    __syncthreads();
    float s[4][4], dp[4][4];
    score_and_dp<D>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ri = ty + 16 * r;
      const int i = q0 + ri;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx + 16 * c;
        float p = 0.f;
        if (!causal || j <= i) p = expf(s[r][c] * scale - Ls[ri]);
        const float ds = p * (dp[r][c] - Dl[ri] + Gl[ri]) * scale;
        dSs[ri * LDP + tx + 16 * c] = round_to(ds, q);
      }
    }
    __syncthreads();
    // dq += ds @ k for query rows ty + 16r
    for (int j = 0; j < BK; ++j) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float ds = dSs[(ty + 16 * r) * LDP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) dqacc[r][c] = fmaf(ds, kv[c], dqacc[r][c]);
      }
    }
  }

  T* dqp = dq + n * a.sdq.n + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long i = q0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_f(dqp + i * a.sdq.t + tx + 16 * c, dqacc[r][c]);
  }
}

// ------------------------------------------------------------- launchers

// dynamic shared memory of each kernel, in bytes
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * 64 * (D + 1) + BQ * LDP);
}
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * LDP + 3 * BQ);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * LDP + 3 * BQ);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const long long* st, int N, int H, int T_len,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  auto kern = attn_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(T_len / BQ, H, N);
  kern<<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), T_len, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       const void* dlse, void* dq, void* dk, void* dv,
                       void* delta, const long long* st, int N, int H,
                       int T_len, int causal, float scale,
                       cudaStream_t stream) {
  // strides: q k v o do dq dk dv lse dlse
  BwdArgs a{strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
            strides_at(st, 4), strides_at(st, 5), strides_at(st, 6),
            strides_at(st, 7), strides_at(st, 8), strides_at(st, 9)};
  const long long rows = (long long)N * H * T_len;
  const int tpb = 256;
  attn_delta_kernel<T><<<(unsigned)((rows + tpb - 1) / tpb), tpb, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)delta, strides_at(st, 3),
      strides_at(st, 4), H, T_len, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = dkdv_smem<D>();
  auto kdkdv = attn_dkdv_kernel<T, D>;
  if ((err = set_smem(kdkdv, smem_kv)) != cudaSuccess) return err;
  dim3 grid(T_len / 64, H, N);
  kdkdv<<<grid, NTHREADS, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const float*)dlse, (T*)dk,
      (T*)dv, a, H, T_len, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = dq_smem<D>();
  auto kdq = attn_dq_kernel<T, D>;
  if ((err = set_smem(kdq, smem_q)) != cudaSuccess) return err;
  kdq<<<grid, NTHREADS, smem_q, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const float*)dlse, (T*)dq, a,
      H, T_len, causal, scale);
  return cudaGetLastError();
}

// ============================================================ bf16: wgmma

namespace wg {

using bf16 = __nv_bfloat16;
using hop::Lane;
using hop::Tile;
using hop::finish;
using hop::mma_abt;
using hop::mma_pb;
using hop::row_max4;
using hop::row_sum4;
using hop::start;
constexpr int THREADS = 128;  // one warpgroup a block

// the tiles of this step have landed: every thread's copies are complete
// and visible to wgmma
__device__ __forceinline__ void tiles_ready() {
  hop::cp_async_commit();
  hop::cp_async_wait<1>();
  hop::fence_async_smem();
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_base(uint8_t* smem) {
  return (hop::smem_u32(smem) + 1023) & ~1023u;
}

template <int D>
constexpr size_t fwd_smem() {  // q, two k and two v tiles, 1024-aligned
  return 1024 + 5 * Tile<D>::BYTES;
}
template <int D>
constexpr size_t dq_smem() {  // q, do, two k and two v tiles
  return 1024 + 6 * Tile<D>::BYTES;
}
template <int D>
constexpr size_t dkdv_smem() {  // k, v, two q and two do tiles, two stats
  return 1024 + 6 * Tile<D>::BYTES + 2 * 3 * 64 * sizeof(float);
}

// Forward, B1/B3: one block per (head, batch row, query tile); o and lse
// for its 64 query rows. Steps 0 .. nkb-1 are pass 1 (k tiles: row max m
// and sum l), steps nkb .. 2nkb-1 pass 2 (k and v tiles: o += p v with
// p = exp(s - m) / l in bf16).
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 4 : 2)
attn_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
               Strides so, Strides sl, int T_len, int causal, float scale) {
  using L = Tile<D>;
  extern __shared__ __align__(16) uint8_t wsmem[];
  const uint32_t Qs = smem_base(wsmem);
  const uint32_t Ks = Qs + L::BYTES;      // two buffers
  const uint32_t Vs = Ks + 2 * L::BYTES;  // two buffers

  const int nt = T_len / 64;
  const int h = blockIdx.x;
  const long long n = blockIdx.y;
  const int qb = nt - 1 - (int)blockIdx.z;  // heaviest causal tiles first
  const int q0 = qb * 64;
  const bf16* qp = q + n * sq.n + h * sq.h;
  const bf16* kp = k + n * sk.n + h * sk.h;
  const bf16* vp = v + n * sv.n + h * sv.h;
  const Lane ln;

  const int nkb = causal ? qb + 1 : nt;
  const int steps = 2 * nkb;
  hop::load_tile<D>(Qs, qp, sq.t, q0);
  hop::load_tile<D>(Ks, kp, sk.t, 0);
  hop::cp_async_commit();

  const float c2 = scale * hop::LOG2E;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float acc[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int st = 0; st < steps; ++st) {
    const bool pass2 = st >= nkb;
    const int kb = pass2 ? st - nkb : st;
    const int buf = st & 1;
    if (st + 1 < steps) {  // the next step's tiles into the other buffers
      const int nx = st + 1 >= nkb ? st + 1 - nkb : st + 1;
      hop::load_tile<D>(Ks + (buf ^ 1) * L::BYTES, kp, sk.t, nx * 64);
      if (st + 1 >= nkb)
        hop::load_tile<D>(Vs + (buf ^ 1) * L::BYTES, vp, sv.t, nx * 64);
    }
    tiles_ready();

    start(s, acc);
    mma_abt<D>(s, Qs, Ks + buf * L::BYTES);
    finish(s, acc);

    const bool diag = causal && kb == qb;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = ln.row + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + ln.col + (i & 1);
      s[i] = (diag && c > r) ? -INFINITY : s[i] * c2;
    }
    if (!pass2) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
        // finite: every row sees column 0 of every tile it visits
        const float mnew = fmaxf(m[rr], row_max4(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += exp2f(s[4 * j + 2 * rr] - mnew) +
                 exp2f(s[4 * j + 2 * rr + 1] - mnew);
        l[rr] = l[rr] * exp2f(m[rr] - mnew) + row_sum4(sum);
        m[rr] = mnew;
        inv_l[rr] = 1.f / l[rr];
      }
    } else {
      uint32_t p[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = 8 * kk + 2 * x, rr = x & 1;
          p[kk][x] = hop::pack_bf16(exp2f(s[i] - m[rr]) * inv_l[rr],
                                    exp2f(s[i + 1] - m[rr]) * inv_l[rr]);
        }
      start(acc, s);
      mma_pb<D>(acc, p, Vs + buf * L::BYTES);
      finish(acc, s);
    }
    __syncthreads();  // the next step refills this step's buffers
  }

  bf16* op = o + n * so.n + h * so.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = q0 + ln.row + 8 * rr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      hop::store_pair(op + i * so.t + 8 * j + ln.col, acc[4 * j + 2 * rr],
                      acc[4 * j + 2 * rr + 1]);
    if ((threadIdx.x & 3) == 0)
      lse[n * sl.n + h * sl.h + i * sl.t] = m[rr] * hop::LN2 + logf(l[rr]);
  }
}

// dq, B2/B4/B5b: one block per (head, batch row, query tile), looping over
// the key tiles its rows see. Its prologue computes delta = rowsum(do * o)
// for its rows and writes it for the dk/dv kernel, launched after it.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 2)
attn_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dlse, float* __restrict__ delta,
              bf16* __restrict__ dq, BwdArgs a, Strides so, int T_len,
              int causal, float scale) {
  using L = Tile<D>;
  extern __shared__ __align__(16) uint8_t wsmem[];
  const uint32_t Qs = smem_base(wsmem);
  const uint32_t dOs = Qs + L::BYTES;
  const uint32_t Ks = dOs + L::BYTES;     // two buffers
  const uint32_t Vs = Ks + 2 * L::BYTES;  // two buffers

  const int nt = T_len / 64;
  const int h = blockIdx.x, H = gridDim.x;
  const long long n = blockIdx.y;
  const int qb = nt - 1 - (int)blockIdx.z;  // heaviest causal tiles first
  const int q0 = qb * 64;
  const bf16* qp = q + n * a.sq.n + h * a.sq.h;
  const bf16* kp = k + n * a.sk.n + h * a.sk.h;
  const bf16* vp = v + n * a.sv.n + h * a.sv.h;
  const bf16* dop = dout + n * a.sdo.n + h * a.sdo.h;
  const bf16* op = o + n * so.n + h * so.h;
  const Lane ln;

  hop::load_tile<D>(Qs, qp, a.sq.t, q0);
  hop::load_tile<D>(dOs, dop, a.sdo.t, q0);
  hop::load_tile<D>(Ks, kp, a.sk.t, 0);
  hop::load_tile<D>(Vs, vp, a.sv.t, 0);
  hop::cp_async_commit();

  // row statistics of rows ln.row + 8 rr: lse in log2 units, delta, and the
  // lse cotangent (0 without one)
  float lse2[2], dl[2], g[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = q0 + ln.row + 8 * rr;
    lse2[rr] = lse[n * a.sl.n + h * a.sl.h + i * a.sl.t] * hop::LOG2E;
    g[rr] = dlse ? dlse[n * a.sg.n + h * a.sg.h + i * a.sg.t] : 0.f;
    const bf16* orow = op + i * so.t;
    const bf16* drow = dop + i * a.sdo.t;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + ln.col + e;
        sum = fmaf(__bfloat162float(drow[c]), __bfloat162float(orow[c]), sum);
      }
    dl[rr] = row_sum4(sum);
    if ((threadIdx.x & 3) == 0)
      delta[((long long)n * H + h) * T_len + i] = dl[rr];
  }

  const float c2 = scale * hop::LOG2E;
  const int nkb = causal ? qb + 1 : nt;
  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int buf = kb & 1;
    if (kb + 1 < nkb) {
      hop::load_tile<D>(Ks + (buf ^ 1) * L::BYTES, kp, a.sk.t, (kb + 1) * 64);
      hop::load_tile<D>(Vs + (buf ^ 1) * L::BYTES, vp, a.sv.t, (kb + 1) * 64);
    }
    tiles_ready();
    const uint32_t Kt = Ks + buf * L::BYTES, Vt = Vs + buf * L::BYTES;

    start(s, dp);
    mma_abt<D>(s, Qs, Kt);    // s = q k^T
    mma_abt<D>(dp, dOs, Vt);  // dp = do v^T
    finish(s, dp);

    const bool diag = causal && kb == qb;
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 8 * kk + 2 * x, rr = x & 1;
        const int r = ln.row + 8 * rr, c = 8 * (i >> 2) + ln.col;
        float d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = (diag && c + e > r)
                              ? 0.f
                              : exp2f(fmaf(s[i + e], c2, -lse2[rr]));
          d2[e] = p * (dp[i + e] - dl[rr] + g[rr]) * scale;
        }
        ds[kk][x] = hop::pack_bf16(d2[0], d2[1]);
      }
    start(acc, s);
    mma_pb<D>(acc, ds, Kt);  // dq += ds k
    finish(acc, s);
    __syncthreads();
  }

  bf16* dqp = dq + n * a.sdq.n + h * a.sdq.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = q0 + ln.row + 8 * rr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      hop::store_pair(dqp + i * a.sdq.t + 8 * j + ln.col, acc[4 * j + 2 * rr],
                      acc[4 * j + 2 * rr + 1]);
  }
}

// dk, dv, B2/B4/B5b: one block per (head, batch row, key tile), looping
// over the query tiles that see it. Key-major: s^T = k q^T and dp^T = v do^T
// put p^T and ds^T in registers as the A operands of dv += p^T do and
// dk += ds^T q, with do and q read MN-major.
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
attn_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dlse, bf16* __restrict__ dk,
                bf16* __restrict__ dv, BwdArgs a, int T_len, int causal,
                float scale) {
  using L = Tile<D>;
  extern __shared__ __align__(16) uint8_t wsmem[];
  const uint32_t Ks = smem_base(wsmem);
  const uint32_t Vs = Ks + L::BYTES;
  const uint32_t Qs = Vs + L::BYTES;       // two buffers
  const uint32_t dOs = Qs + 2 * L::BYTES;  // two buffers
  const uint32_t Ss = dOs + 2 * L::BYTES;  // two x (lse, delta, dlse) x 64
  const float* stats = reinterpret_cast<const float*>(
      wsmem + (Ss - hop::smem_u32(wsmem)));

  const int nt = T_len / 64;
  const int h = blockIdx.x, H = gridDim.x;
  const long long n = blockIdx.y;
  const int kb = blockIdx.z;  // key tile 0 is seen by every query tile
  const int k0 = kb * 64;
  const bf16* qp = q + n * a.sq.n + h * a.sq.h;
  const bf16* dop = dout + n * a.sdo.n + h * a.sdo.h;
  const float* lp = lse + n * a.sl.n + h * a.sl.h;
  const float* dlp = delta + ((long long)n * H + h) * T_len;
  const float* gp = dlse ? dlse + n * a.sg.n + h * a.sg.h : nullptr;
  const Lane ln;

  auto load_q = [&](int qb, int buf) {
    hop::load_tile<D>(Qs + buf * L::BYTES, qp, a.sq.t, qb * 64);
    hop::load_tile<D>(dOs + buf * L::BYTES, dop, a.sdo.t, qb * 64);
    for (int e = threadIdx.x; e < 3 * 64; e += THREADS) {
      const int which = e >> 6, r = e & 63;
      const long long i = qb * 64 + r;
      const float* src = which == 0   ? lp + i * a.sl.t
                         : which == 1 ? dlp + i
                                      : gp + i * a.sg.t;
      if (which < 2 || gp)
        hop::cp_async4(Ss + 4 * ((buf * 3 + which) * 64 + r), src);
    }
  };

  hop::load_tile<D>(Ks, k + n * a.sk.n + h * a.sk.h, a.sk.t, k0);
  hop::load_tile<D>(Vs, v + n * a.sv.n + h * a.sv.h, a.sv.t, k0);
  const int qs = causal ? kb : 0;
  const int nq = nt - qs;
  load_q(qs, 0);
  hop::cp_async_commit();

  const float c2 = scale * hop::LOG2E;
  float dka[D / 2], dva[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int qb = qs + it, buf = it & 1;
    if (it + 1 < nq) load_q(qb + 1, buf ^ 1);
    tiles_ready();
    const uint32_t Qt = Qs + buf * L::BYTES, dOt = dOs + buf * L::BYTES;
    const float* Ls = stats + buf * 3 * 64;
    const float* Dl = Ls + 64;
    const float* Gl = Ls + 128;

    start(s, dp);
    mma_abt<D>(s, Ks, Qt);    // s^T = k q^T
    mma_abt<D>(dp, Vs, dOt);  // dp^T = v do^T
    finish(s, dp);

    const bool diag = causal && qb == kb;
    uint32_t pt[4][4], dst[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 8 * kk + 2 * x;
        const int r = ln.row + 8 * (x & 1);     // key row
        const int c = 8 * (i >> 2) + ln.col;    // query column (even)
        const float2 lv = *reinterpret_cast<const float2*>(Ls + c);
        const float2 dv2 = *reinterpret_cast<const float2*>(Dl + c);
        const float2 gv = gp ? *reinterpret_cast<const float2*>(Gl + c)
                             : make_float2(0.f, 0.f);
        const float l2[2] = {lv.x, lv.y}, d2[2] = {dv2.x, dv2.y},
                    g2[2] = {gv.x, gv.y};
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = (diag && r > c + e)
                     ? 0.f
                     : exp2f(fmaf(s[i + e], c2, -l2[e] * hop::LOG2E));
          ds[e] = p[e] * (dp[i + e] - d2[e] + g2[e]) * scale;
        }
        pt[kk][x] = hop::pack_bf16(p[0], p[1]);
        dst[kk][x] = hop::pack_bf16(ds[0], ds[1]);
      }
    start(dva, dka);
    mma_pb<D>(dva, pt, dOt);  // dv += p^T do
    mma_pb<D>(dka, dst, Qt);  // dk += ds^T q
    finish(dva, dka);
    __syncthreads();
  }

  bf16* dkp = dk + n * a.sdk.n + h * a.sdk.h;
  bf16* dvp = dv + n * a.sdv.n + h * a.sdv.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long j = k0 + ln.row + 8 * rr;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + ln.col;
      hop::store_pair(dkp + j * a.sdk.t + col, dka[4 * c + 2 * rr],
                      dka[4 * c + 2 * rr + 1]);
      hop::store_pair(dvp + j * a.sdv.t + col, dva[4 * c + 2 * rr],
                      dva[4 * c + 2 * rr + 1]);
    }
  }
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const long long* st, int N, int H, int T_len,
                       int causal, float scale, cudaStream_t stream) {
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), so = strides_at(st, 3);
  if (!(aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv) &&
        aligned16(o, so)))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem<D>();
  auto kern = attn_fwd_wgmma<D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, N, T_len / 64);
  kern<<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      sq, sk, sv, so, strides_at(st, 4), T_len, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       const void* dlse, void* dq, void* dk, void* dv,
                       void* delta, const long long* st, int N, int H,
                       int T_len, int causal, float scale,
                       cudaStream_t stream) {
  // strides: q k v o do dq dk dv lse dlse
  BwdArgs a{strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
            strides_at(st, 4), strides_at(st, 5), strides_at(st, 6),
            strides_at(st, 7), strides_at(st, 8), strides_at(st, 9)};
  if (!(aligned16(q, a.sq) && aligned16(k, a.sk) && aligned16(v, a.sv) &&
        aligned16(dout, a.sdo) && aligned16(dq, a.sdq) &&
        aligned16(dk, a.sdk) && aligned16(dv, a.sdv)))
    return cudaErrorInvalidValue;
  dim3 grid(H, N, T_len / 64);
  const size_t smem_q = dq_smem<D>();
  auto kdq = attn_dq_wgmma<D>;
  cudaError_t err = set_smem(kdq, smem_q);
  if (err != cudaSuccess) return err;
  kdq<<<grid, THREADS, smem_q, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
      (const bf16*)dout, (const float*)lse, (const float*)dlse,
      (float*)delta, (bf16*)dq, a, strides_at(st, 3), T_len, causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_kv = dkdv_smem<D>();
  auto kdkdv = attn_dkdv_wgmma<D>;
  if ((err = set_smem(kdkdv, smem_kv)) != cudaSuccess) return err;
  kdkdv<<<grid, THREADS, smem_kv, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (const float*)dlse, (bf16*)dk,
      (bf16*)dv, a, T_len, causal, scale);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// o = softmax(mask(q k^T * scale)) v and lse = logsumexp of the scores.
// strides: 15 element strides, (batch, head, token) for q, k, v, o, lse.
// bf16 takes T / 64 <= 65535 (query tiles are the grid's z axis), as the
// long-context forward does, and views whose base and strides are 16-byte
// aligned (both entries).
int gym_attn_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, const long long* strides, int N, int H, int T_len,
                 int D, int causal, float scale, int dtype, void* stream) {
  if (T_len % 64 != 0 || N <= 0 || H <= 0 || N > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && T_len / 64 <= 65535) {
    GYM_HEAD_DIM(D, (wg::launch_fwd<D>(q, k, v, o, lse, strides, N, H, T_len,
                                       causal, scale, s)));
  } else if (dtype == 0) {
    GYM_HEAD_DIM(D, (launch_fwd<float, D>(q, k, v, o, lse, strides, N, H,
                                          T_len, causal, scale, s)));
  }
  return (int)cudaErrorInvalidValue;
}

// dq, dk, dv of the forward above, with an optional lse cotangent
// (dlse = NULL means zero). delta is scratch of N * H * T floats.
// strides: 30 element strides, (batch, head, token) for
// q, k, v, o, do, dq, dk, dv, lse, dlse.
int gym_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, const void* dlse, void* dq,
                 void* dk, void* dv, void* delta, const long long* strides,
                 int N, int H, int T_len, int D, int causal, float scale,
                 int dtype, void* stream) {
  if (T_len % 64 != 0 || N <= 0 || H <= 0 || N > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && T_len / 64 <= 65535) {
    GYM_HEAD_DIM(D, (wg::launch_bwd<D>(q, k, v, o, dout, lse, dlse, dq, dk,
                                       dv, delta, strides, N, H, T_len,
                                       causal, scale, s)));
  } else if (dtype == 0) {
    GYM_HEAD_DIM(D, (launch_bwd<float, D>(q, k, v, o, dout, lse, dlse, dq, dk,
                                          dv, delta, strides, N, H, T_len,
                                          causal, scale, s)));
  }
  return (int)cudaErrorInvalidValue;
}

long long gym_flash_smem_bytes(int D, int wgmma);  // flash_attention.cu

// dynamic shared memory of one block: kernel 0 = forward, 1 = dk/dv,
// 2 = dq (f32, scalar), 3 = the long-context forward (f32, scalar),
// 4 = forward, 5 = dk/dv, 6 = dq (bf16, wgmma), 7 = the long-context
// forward (bf16, wgmma); -1 for an unsupported head dim or kernel
long long gym_attn_smem_bytes(int kernel, int D) {
  if (kernel == 3 || kernel == 7) return gym_flash_smem_bytes(D, kernel == 7);
  if (kernel < 0 || kernel > 6) return -1;
#define GYM_SMEM_ROW(DD)                                                     \
  case DD: {                                                                 \
    const long long b[7] = {(long long)fwd_smem<DD>(),                      \
                            (long long)dkdv_smem<DD>(),                     \
                            (long long)dq_smem<DD>(), 0,                    \
                            (long long)wg::fwd_smem<DD>(),                  \
                            (long long)wg::dkdv_smem<DD>(),                 \
                            (long long)wg::dq_smem<DD>()};                  \
    return b[kernel];                                                        \
  }
  switch (D) {
    GYM_SMEM_ROW(16)
    GYM_SMEM_ROW(32)
    GYM_SMEM_ROW(64)
    GYM_SMEM_ROW(128)
  }
#undef GYM_SMEM_ROW
  return -1;
}

const char* gym_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
