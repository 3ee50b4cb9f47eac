// Long-context causal attention for Hopper (sm_90a): a single-pass FA2
// forward with causal tile skipping.
//
// Replaces the forward of TPU kernel B5: the T > 1024 branch of
// gym_tpu/ops/flash_attention.py (flash_causal_attention, :62-85), which
// calls JAX's bundled Pallas TPU kernel
// jax/experimental/pallas/ops/tpu/flash_attention.py (_flash_attention_impl,
// pallas_call at :758, multi-step body :385-477). B5's backward
// (_flash_attention_bwd_dkv, pallas_call :1121; _flash_attention_bwd_dq,
// :1456) is the FA2 backward given lse = m + log l; the wrapper launches the
// backward kernels of fused_attention.cu for it (in bf16 the wgmma dq
// kernel, which also computes delta, then dk/dv). The bundled kernel takes
// only blocks that divide T, and the JAX package sends T % 128 != 0 to
// dense attention: the entry below refuses such T.
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
// Two implementations, chosen by dtype:
// - bf16 (training): flash_fwd_wgmma, on the tensor cores. A block owns 128
//   query rows of one head and has three warpgroups. One producer thread
//   issues TMA loads (tensor maps of the strided [N, H, T, D] views, encoded
//   on the host for each call) of the block's q tiles once and of the 64-key
//   k and v tiles into a ring of STAGES stages, with an mbarrier a stage
//   for "full" (the TMA bytes landed) and one for "empty" (both consumers
//   are done with it). Two consumer warpgroups own 64 query rows each and
//   share every k/v tile: s = q k^T on wgmma from shared memory (both
//   operands K-major), the online softmax in registers in log2 units (exp2
//   of s * scale * log2 e), p rounded to bf16 in registers (the accumulator
//   layout is wgmma's register A layout), o += p v on wgmma with v read
//   MN-major. TMA writes each box in the swizzle of the tile layout of
//   hopper.cuh, so wgmma reads what it wrote. setmaxnreg moves registers
//   from the producer warpgroup to the consumers.
// - f32 (evals, card-against-CPU checks): flash_fwd_kernel, scalar f32
//   FMAs on 64 x 64 shared-memory tiles (256 threads, 4 x 4 register
//   micro-tiles). Single-pass TF32 on the tensor cores would move those
//   results; the split-precision TF32 design of fused_attention.cu's f32
//   kernels would not, and is not applied here yet.
//
// What bounds it on this card (an H100 SXM's published peaks, which assume
// its full 700 W power limit): at the slice's shape (N=2, H=12, T=8192,
// D=64, bf16) the forward is 2 products of 2*D flops over 805 M causal
// pairs, 206 GFLOP: 0.2085 ms at the bf16 tensor-core peak of 989 TFLOP/s,
// against 0.030 ms for its 101 MB of q, k, v, o and lse at 3.35 TB/s, so it
// is bound by operations. What the design does about it: the products run
// on wgmma, fed by TMA so that no consumer thread spends instructions on
// copies and the next tiles land while this one is computed; one pass (q k^T
// once per pair); key tiles above the diagonal never visited, and warpgroup
// 0, whose rows end 64 keys earlier, skips the block's last key tile, so the
// tiles computed are the 64 x 64 tiles on or below the diagonal (811.6 M
// pairs at this shape); 128 query rows share each k/v tile brought on chip;
// the heaviest query blocks first (the grid's slowest axis counts them from
// the last): under causal skipping the last block does T/128 times the work
// of the first, and a heavy block left to the end of the grid would run
// alone on an idle card. At D = 64 a tile's 4,096 exponentials keep the
// special-function units as long as its two products keep the tensor cores,
// so the softmax is lean (the scale folds into the exponent's FMA, the
// scores are only read), and one consumer's softmax overlaps the other's
// products; issuing a tile's q k^T ahead of the previous tile's softmax
// within a warpgroup measured slower at D = 64 and is not done.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

// f32 (instantiated for float only): one block per (query tile, batch row x
// head), o and lse for its 64 query rows. blockIdx.x = n * H + h;
// blockIdx.y counts query tiles from the last, so the grid's first wave
// holds the tiles that see the most keys.
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

template <int D>
cudaError_t launch_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* st, int N,
                             int H, int T_len, float scale,
                             cudaStream_t stream) {
  const size_t smem = flash_fwd_smem<D>();
  auto kern = flash_fwd_kernel<float, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(N * H), (unsigned)(T_len / BQ));
  kern<<<grid, NTHREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), H, scale);
  return cudaGetLastError();
}

// ============================================================ bf16: wgmma

namespace wg {

using bf16 = __nv_bfloat16;
using hop::BfTile;
constexpr int STAGES = 4;       // k/v ring depth
constexpr int THREADS = 384;    // producer warpgroup, two consumers
constexpr int CONSUMERS = 256;  // arrivals that empty a stage
// 128 * 24 + 256 * 240 = 64,512 registers: one block an SM, the same as
// the 168 a thread that __launch_bounds__(384, 1) allocates at launch
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// shared memory, byte offsets from a 1024-aligned base: two q tiles (one
// per consumer), the k and v rings, then the barriers: q, full[STAGES],
// empty[STAGES]
template <int D>
struct Smem {
  static constexpr uint32_t K = 2 * BfTile<D>::BYTES;
  static constexpr uint32_t V = K + STAGES * BfTile<D>::BYTES;
  static constexpr uint32_t BARS = V + STAGES * BfTile<D>::BYTES;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (1 + 2 * STAGES);
};

// One score tile of a consumer's 64 rows (this thread's rows ln.row and
// ln.row + 8), s = q k^T unscaled: folded into the running row max m and
// sum l in log2 units, masked above the diagonal on the diagonal tile, and
// p = exp2(s * scale * log2 e - m) in f32 (l sums these, unrounded); alpha
// = exp2(m_old - m_new) rescales the accumulator. s is only read: the scale
// folds into the exponent's FMA, and the max of the unscaled scores times
// the positive scale is the max of the scaled ones.
__device__ __forceinline__ void online_softmax(const float (&s)[32],
                                               bool diag, const hop::Lane& ln,
                                               float c2, float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               float (&p)[32]) {
  const auto masked = [&](int i) {  // column > row, on the diagonal tile
    return diag &&
           8 * (i >> 2) + ln.col + (i & 1) > ln.row + 8 * ((i >> 1) & 1);
  };
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e;
        if (!masked(i)) mx = fmaxf(mx, s[i]);
      }
    // finite: every row sees column 0 of every tile it visits
    const float mnew = fmaxf(m[rr], hop::row_max4(mx) * c2);
    alpha[rr] = hop::exp2_ftz(m[rr] - mnew);  // 0 at the first tile
    m[rr] = mnew;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e;
        p[i] = masked(i) ? 0.f : hop::exp2_ftz(fmaf(s[i], c2, -mnew));
        sum[rr] += p[i];
      }
    l[rr] = l[rr] * alpha[rr] + hop::row_sum4(sum[rr]);
  }
}

// p rounded to bf16 as the register A operand of p v: the accumulator
// layout of a [64 x 64] tile is four k16 depth steps of it
__device__ __forceinline__ void round_p(const float (&p)[32],
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = hop::pack_bf16(p[8 * kk + 2 * x], p[8 * kk + 2 * x + 1]);
}

// acc [64 x D] of this thread's rows ln.row + 8 rr, times alpha[rr]
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// One block per (batch row x head, 128-row query block): o and lse of its
// rows. blockIdx.x = n * H + h; blockIdx.y counts query blocks from the
// last, so the grid's first wave holds the blocks that see the most keys.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                bf16* __restrict__ o, float* __restrict__ lse, Strides so,
                Strides sl, int H, float scale) {
  using L = BfTile<D>;
  using S = Smem<D>;
  extern __shared__ __align__(16) uint8_t wsmem[];
  const uint32_t base = (hop::smem_u32(wsmem) + 1023) & ~1023u;
  const uint32_t Ks = base + S::K, Vs = base + S::V;
  const uint32_t q_full = base + S::BARS;
  const auto full = [&](int st) { return q_full + 8 * (1 + st); };
  const auto empty = [&](int st) { return q_full + 8 * (1 + STAGES + st); };

  const int qb = gridDim.y - 1 - (int)blockIdx.y;
  const int h = blockIdx.x % H;
  const int n = blockIdx.x / H;
  const int nkb = 2 * qb + 2;  // 64-key tiles up to the block's last row
  const int role = threadIdx.x >> 7;  // 0 producer, 1 and 2 consumers

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      hop::mbar_init(full(st), 1);
      hop::mbar_init(empty(st), CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (role == 0) {
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hop::mbar_expect_tx(q_full, 2 * L::BYTES);
      hop::tma_tile<D>(base, &tq, q_full, 128 * qb, h, n);
      hop::tma_tile<D>(base + L::BYTES, &tq, q_full, 128 * qb + 64, h, n);
      for (int kb = 0; kb < nkb; ++kb) {
        const int st = kb % STAGES;
        // round r of a stage waits for the consumers' release of round
        // r - 1 (parity 1 of a fresh barrier passes at once)
        hop::mbar_wait(empty(st), ((kb / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(full(st), 2 * L::BYTES);
        hop::tma_tile<D>(Ks + st * L::BYTES, &tk, full(st), 64 * kb, h, n);
        hop::tma_tile<D>(Vs + st * L::BYTES, &tv, full(st), 64 * kb, h, n);
      }
    }
    return;
  }

  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int w = role - 1;        // rows 64w .. 64w + 63 of the block
  const int diag = 2 * qb + w;   // this warpgroup's diagonal key tile
  const uint32_t Qt = base + w * L::BYTES;
  const hop::Lane ln;
  const float c2 = scale * hop::LOG2E;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hop::mbar_wait(q_full, 0);
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb % STAGES;
    hop::mbar_wait(full(st), (kb / STAGES) & 1);
    // warpgroup 0 sees none of the last tile's keys: it only releases the
    // stage, after its round has landed (an earlier arrival would count
    // toward the stage's previous round)
    if (kb <= diag) {
      hop::start(s, acc);
      hop::mma_abt<D>(s, Qt, Ks + st * L::BYTES);
      hop::finish(s, acc);
      float pf[32], alpha[2];
      online_softmax(s, kb == diag, ln, c2, m, l, alpha, pf);
      uint32_t p[4][4];
      round_p(pf, p);
      rescale<D>(acc, alpha);
      hop::start(acc, s);
      hop::mma_pb<D>(acc, p, Vs + st * L::BYTES);
      hop::finish(acc, s);
    }
    hop::mbar_arrive(empty(st));
  }

  bf16* op = o + n * so.n + h * so.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = 128 * qb + 64 * w + ln.row + 8 * rr;
    const float inv_l = 1.f / l[rr];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      hop::store_pair(op + i * so.t + 8 * j + ln.col,
                      acc[4 * j + 2 * rr] * inv_l,
                      acc[4 * j + 2 * rr + 1] * inv_l);
    if ((threadIdx.x & 3) == 0)
      lse[n * sl.n + h * sl.h + i * sl.t] = m[rr] * hop::LN2 + logf(l[rr]);
  }
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library links without libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The [N, H, T, D] bf16 view at p with element strides s as a 4-d tensor
// map (dims innermost first: D, T, H, N) of [64 rows x ROWB bytes] boxes,
// swizzled at the box's row width as BfTile<D> is.
template <int D>
cudaError_t tensor_map(CUtensorMap* map, const void* p, Strides s, int N,
                       int H, int T_len) {
  using L = BfTile<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T_len,
                              (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t bytes[3] = {(cuuint64_t)s.t * 2, (cuuint64_t)s.h * 2,
                               (cuuint64_t)s.n * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(L::ROWB / 2), 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = L::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : L::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const long long* st, int N, int H,
                       int T_len, float scale, cudaStream_t stream) {
  const Strides sq = strides_at(st, 0), sk = strides_at(st, 1),
                sv = strides_at(st, 2), so = strides_at(st, 3);
  if (!(aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv) &&
        aligned16(o, so)))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = tensor_map<D>(&mq, q, sq, N, H, T_len)) != cudaSuccess ||
      (err = tensor_map<D>(&mk, k, sk, N, H, T_len)) != cudaSuccess ||
      (err = tensor_map<D>(&mv, v, sv, N, H, T_len)) != cudaSuccess)
    return err;
  const size_t smem = Smem<D>::BYTES;
  auto kern = flash_fwd_wgmma<D>;
  if ((err = set_smem(kern, smem)) != cudaSuccess) return err;
  dim3 grid((unsigned)(N * H), (unsigned)(T_len / 128));
  kern<<<grid, THREADS, smem, stream>>>(mq, mk, mv, (bf16*)o, (float*)lse,
                                        so, strides_at(st, 4), H, scale);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// Causal o = softmax(mask(q k^T * scale)) v and lse = logsumexp of the
// scores, in one pass over the key tiles. strides: 15 element strides,
// (batch, head, token) for q, k, v, o, lse. T % 128 == 0 (the bundled
// kernel's rule; the bf16 kernel's query blocks are 128 rows); bf16 views
// 16-byte aligned (base and strides). Returns a cudaError_t
// (gym_attn_error_string names it).
int gym_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, const long long* strides, int N, int H, int T_len,
                  int D, float scale, int dtype, void* stream) {
  if (T_len <= 0 || T_len % 128 != 0 || T_len / 64 > 65535 || N <= 0 ||
      H <= 0 || (long long)N * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    GYM_HEAD_DIM(D, (wg::launch_fwd<D>(q, k, v, o, lse, strides, N, H, T_len,
                                       scale, s)));
  } else if (dtype == 0) {
    GYM_HEAD_DIM(D, (launch_flash_fwd<D>(q, k, v, o, lse, strides, N, H,
                                         T_len, scale, s)));
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks of the bf16 forward resident on one SM at head dim D, or a
// negative cudaError_t; regs gets the registers a thread holds after
// setmaxnreg in the producer and in the consumer warpgroups, and at launch.
int gym_flash_occupancy(int D, int* regs) {
  regs[0] = wg::PRODUCER_REGS;
  regs[1] = wg::CONSUMER_REGS;
#define GYM_FLASH_OCC(DD)                                                    \
  case DD: {                                                                 \
    auto kern = wg::flash_fwd_wgmma<DD>;                                     \
    cudaFuncAttributes attr;                                                 \
    int blocks = 0;                                                          \
    cudaError_t err = set_smem(kern, wg::Smem<DD>::BYTES);                   \
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);        \
    if (err == cudaSuccess)                                                  \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
          &blocks, kern, wg::THREADS, wg::Smem<DD>::BYTES);                  \
    if (err != cudaSuccess) return -(int)err;                                \
    regs[2] = attr.numRegs;                                                  \
    return blocks;                                                           \
  }
  switch (D) {
    GYM_FLASH_OCC(16)
    GYM_FLASH_OCC(32)
    GYM_FLASH_OCC(64)
    GYM_FLASH_OCC(128)
  }
#undef GYM_FLASH_OCC
  return -(int)cudaErrorInvalidValue;
}

// dynamic shared memory of one forward block: the f32 scalar kernel
// (wgmma = 0) or the bf16 wgmma kernel (1); -1 for an unsupported head dim
long long gym_flash_smem_bytes(int D, int wgmma) {
  switch (D) {
#define GYM_FLASH_SMEM(DD) \
  case DD: return wgmma ? (long long)wg::Smem<DD>::BYTES : flash_fwd_smem<DD>();
    GYM_FLASH_SMEM(16)
    GYM_FLASH_SMEM(32)
    GYM_FLASH_SMEM(64)
    GYM_FLASH_SMEM(128)
#undef GYM_FLASH_SMEM
  }
  return -1;
}

}  // extern "C"
