// Whole-context FA2 attention for Hopper (sm_90a): forward and backward.
//
// Replaces the four Pallas kernels of gym_tpu/ops/fused_attention.py:
//   _fwd_packed_kernel / _blk_fwd_kernel  ->  attn_fwd_kernel
//   _bwd_packed_kernel / _blk_bwd_kernel  ->  attn_delta_kernel + attn_dkdv_kernel
//                                             + attn_dq_kernel
// The backward kernels also serve the long-context flash attention (B5,
// flash_attention.cu): their shared memory does not grow with T and their
// offsets are 64-bit, so they take any T % 64 == 0.
// The packed [B, T, C] and per-head [B, H, T, D] layouts differ only in
// their strides, so every kernel takes element strides (batch, head, token)
// for each tensor; the last dimension must be contiguous. In the packed
// layout q, k and v are the three column slices of the c_attn output
// [B, T, 3C] and are read in place (token stride 3C), with no copy.
//
// Rounding points follow the Pallas kernels: scores in f32 from products of
// the input dtype, p normalised by l and rounded to v's dtype before the PV
// product (forward); p recomputed as exp(s - lse), rounded to do's dtype for
// dv, delta = rowsum(do * o) in f32, ds rounded to q's dtype before dq and dk
// (backward). The forward is two-pass over the key tiles (running max and
// sum first, then the normalised PV product), which keeps the
// normalise-then-round order of the whole-row Pallas softmax. Masked scores
// (NEG = -1e30 in Pallas) contribute exp(-1e30 - m) = 0 exactly, so causal
// tiles above the diagonal are skipped rather than computed.
//
// What bounds it on this card: at the training shapes (T <= 1024,
// head_dim 32-64) attention is memory-bound at the bf16 tensor-core rate
// (about 0.4 flop per byte of q/k/v/o against H100's ~295 flop/byte ridge).
// This first version computes the products with scalar f32 FMAs on
// shared-memory tiles (64 x 64 score tiles, 256 threads, 4 x 4 register
// micro-tiles), so it is bound by the f32 FMA rate of the SMs instead, and
// recomputes the score tile once more in the forward (two passes) and once
// per backward kernel. The design keeps the score and probability blocks in
// shared memory only: like the Pallas kernels, nothing of size T x T ever
// reaches device memory, and the backward has no atomics (dk/dv and dq are
// computed by separate kernels, each owning its output rows). Moving the
// products to wgmma with TMA-fed tiles is later work.

#include "attn_common.cuh"

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

}  // namespace

extern "C" {

// o = softmax(mask(q k^T * scale)) v and lse = logsumexp of the scores.
// strides: 15 element strides, (batch, head, token) for q, k, v, o, lse.
int gym_attn_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, const long long* strides, int N, int H, int T_len,
                 int D, int causal, float scale, int dtype, void* stream) {
  if (T_len % 64 != 0 || N <= 0 || H <= 0 || N > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  GYM_DISPATCH(dtype, D,
               (launch_fwd<T, D>(q, k, v, o, lse, strides, N, H, T_len, causal,
                                 scale, s)));
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
  GYM_DISPATCH(dtype, D,
               (launch_bwd<T, D>(q, k, v, o, dout, lse, dlse, dq, dk, dv, delta,
                                 strides, N, H, T_len, causal, scale, s)));
}

long long gym_flash_smem_bytes(int D);  // flash_attention.cu

// dynamic shared memory of one block: kernel 0 = forward, 1 = dk/dv,
// 2 = dq, 3 = the long-context forward (the same for both dtypes); -1 for
// an unsupported head dim
long long gym_attn_smem_bytes(int kernel, int D) {
  if (kernel == 3) return gym_flash_smem_bytes(D);
  switch (D) {
    case 16: return kernel == 0 ? fwd_smem<16>() : kernel == 1 ? dkdv_smem<16>() : dq_smem<16>();
    case 32: return kernel == 0 ? fwd_smem<32>() : kernel == 1 ? dkdv_smem<32>() : dq_smem<32>();
    case 64: return kernel == 0 ? fwd_smem<64>() : kernel == 1 ? dkdv_smem<64>() : dq_smem<64>();
    case 128: return kernel == 0 ? fwd_smem<128>() : kernel == 1 ? dkdv_smem<128>() : dq_smem<128>();
  }
  return -1;
}

const char* gym_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
