// Long-context causal attention for Hopper (sm_90a): a single-pass FA2
// forward with causal tile skipping.
//
// Replaces the forward of TPU kernel B5: the T > 1024 branch of
// gym_tpu/ops/flash_attention.py (flash_causal_attention, :62-85), which
// calls JAX's bundled Pallas TPU kernel
// jax/experimental/pallas/ops/tpu/flash_attention.py (_flash_attention_impl,
// pallas_call at :758, multi-step body :385-475). B5's backward
// (_flash_attention_bwd_dkv, pallas_call :1121; _flash_attention_bwd_dq,
// :1456) is the FA2 backward given lse = m + log l; the wrapper launches the
// backward kernels of fused_attention.cu for it (in bf16 the wgmma dq
// kernel, which also computes delta, then dk/dv), which take any
// T % 64 == 0.
//
// Arithmetic, as in the TPU kernel's multi-step body: scores in f32 from
// products of the input dtype, times scale; a running row max m and sum l
// over the key tiles; p = exp(s - m_running) unnormalised and rounded to v's
// dtype before the PV product, the row sum taken from the unrounded f32 p
// (the TPU kernel's p.astype(v.dtype), :447-471); the accumulator rescaled by
// exp(m_old - m_new) at each tile and divided by l once at the end; o in the
// input dtype, lse = m + log l in f32. The causal mask is applied on the
// diagonal tile only; the tiles above it are never visited.
//
// What bounds it on this card (an H100 SXM's published peaks, which assume
// its full 700 W power limit): at the slice's shape (N=2, H=12, T=8192,
// D=64, bf16) the forward is 2 products of 2*D flops over 805 M causal
// pairs, 206 GFLOP: 0.2085 ms at the bf16 tensor-core peak of 989 TFLOP/s,
// against 0.030 ms for its 101 MB of q, k, v, o and lse at 3.35 TB/s, so it
// is bound by operations. This first version does the products with scalar
// f32 FMAs on 64 x 64 shared-memory tiles (256 threads, 4 x 4 register
// micro-tiles), so its own ceiling is the SMs' f32 rate (67 TFLOP/s, 3.1 ms
// at this shape). What the design does about the work: one pass (QK^T is
// computed once per pair, where the two-pass attn_fwd_kernel computes it
// twice), key tiles above the diagonal skipped (half the pairs), nothing of
// size T x T in device memory and shared memory independent of T, and the
// heaviest query tiles scheduled first: under causal skipping the last query
// tile does T/64 times the work of the first, and a heavy tile left to the
// end of the grid would run alone on an idle card. Moving the products to
// wgmma fed by TMA is later work.

#include "attn_common.cuh"

namespace {

// One block per (query tile, batch row x head): o and lse for its 64 query
// rows. blockIdx.x = n * H + h; blockIdx.y counts query tiles from the last,
// so the grid's first wave holds the tiles that see the most keys.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 Strides so, Strides sl, int H, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int qb = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x % H;
  const long long n = blockIdx.x / H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qb * BQ;
  const T* qp = q + n * sq.n + h * sq.h;
  const T* kp = k + n * sk.n + h * sk.h;
  const T* vp = v + n * sv.n + h * sv.h;

  load_tile<T, D>(Qs, qp, sq.t, q0);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int kb = 0; kb <= qb; ++kb) {
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
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
    const bool diag = kb == qb;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;  // row and column within the tile
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] *= scale;
        if (diag && tx + 16 * c > i) s[r][c] = -INFINITY;
        tmax = fmaxf(tmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // finite: every row sees column 0 of every tile it visits
      const float mnew = fmaxf(m[r], tmax);
      const float alpha = expf(m[r] - mnew);  // 0 at the first tile
      float tsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - mnew);  // masked: exp(-inf) = 0
        tsum += p;
        Ps[i * LDP + tx + 16 * c] = round_to(p, v);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      l[r] = l[r] * alpha + tsum;
      m[r] = mnew;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    // acc += p @ v for query rows ty + 16r, head columns tx + 16c
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
    const long long i = q0 + ty + 16 * r;
    const float inv_l = 1.f / l[r];
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_f(op + i * so.t + tx + 16 * c, acc[r][c] * inv_l);
    if (tx == 0) lp[i * sl.t] = m[r] + logf(l[r]);
  }
}

template <int D>
constexpr size_t flash_fwd_smem() {
  return sizeof(float) * (3 * 64 * (D + 1) + BQ * LDP);
}

template <typename T, int D>
cudaError_t launch_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* st, int N,
                             int H, int T_len, float scale,
                             cudaStream_t stream) {
  const size_t smem = flash_fwd_smem<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(N * H), (unsigned)(T_len / BQ));
  kern<<<grid, NTHREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Causal o = softmax(mask(q k^T * scale)) v and lse = logsumexp of the
// scores, in one pass over the key tiles. strides: 15 element strides,
// (batch, head, token) for q, k, v, o, lse. Returns a cudaError_t
// (gym_attn_error_string names it).
int gym_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int N, int H, int T_len,
                  int D, float scale, int dtype, void* stream) {
  if (T_len <= 0 || T_len % 64 != 0 || T_len / 64 > 65535 || N <= 0 ||
      H <= 0 || (long long)N * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  GYM_DISPATCH(dtype, D,
               (launch_flash_fwd<T, D>(q, k, v, o, lse, strides, N, H, T_len,
                                       scale, s)));
}

// dynamic shared memory of one forward block; -1 for an unsupported head dim
long long gym_flash_smem_bytes(int D) {
  switch (D) {
    case 16: return flash_fwd_smem<16>();
    case 32: return flash_fwd_smem<32>();
    case 64: return flash_fwd_smem<64>();
    case 128: return flash_fwd_smem<128>();
  }
  return -1;
}

}  // extern "C"
