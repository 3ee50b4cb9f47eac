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
// dlse) scale rounded to q's dtype before dq and dk (backward). Masked
// scores (NEG = -1e30 in Pallas) contribute exp(-1e30 - m) = 0 exactly, so
// causal tiles above the diagonal are skipped.
//
// Both dtypes run on wgmma. One warpgroup a block owns 64 rows (query rows
// in the forward and in dq, key rows in dk/dv) and streams the other side's
// rows, the next rows' copy overlapping this step's products. s = q k^T
// (dk/dv: s^T = k q^T and dp^T = v do^T, key-major) accumulates in f32
// registers; p and ds stay in the accumulator's registers and are the
// register A operand of the second products (p v, ds k, p^T do, ds^T q),
// which read only their B tile from shared memory. The delta pre-pass is
// folded into the dq kernel's prologue (it reads o and do for its own rows
// and writes delta for dk/dv, launched after it).
// - bf16 (training; namespace wg): tiles of 64 rows as bf16 in wgmma's
//   swizzled layout (hopper.cuh), double-buffered with 16-byte cp.async
//   copies; v, q and do are read MN-major by the second products, and the
//   accumulator layout is already bf16's register A layout. The rounding
//   points above are exactly the bf16 operand conversions. The forward is
//   two-pass over the key tiles (row max and sum first, then the normalised
//   PV product), which keeps the normalise-then-round order of the
//   whole-row Pallas softmax.
// - f32 (evals, config 4's training, card-against-CPU checks; namespace
//   x3): split-precision TF32 ("3xTF32", hopper.cuh). Each operand x is held
//   as hi + lo, two TF32 values, and each product is three wgmmas, a_lo b_hi
//   + a_hi b_lo + a_hi b_hi, about 2^-21 relative: the order of reordering
//   an f32 sum. Single-pass TF32 (2^-11) moves lse by about 1e-3 where the
//   f32 tolerance allows 1e-5. Rounding to f32 is the identity, so the
//   forward is one pass (FA2's online softmax: o rescaled by exp(m_old -
//   m_new) and divided by l at the end). TF32 wgmma reads shared memory only
//   K-major, so the B tiles of the second products are transposes (v^T,
//   k^T, do^T, q^T); and since the accumulator's columns are not where
//   TF32's register A fragment wants them, each group of 8 keys (queries in
//   dk/dv) of a transposed tile is stored in the order 0,2,4,6,1,3,5,7
//   (hop::frags, hop::key_order). The streamed rows, S at a time (S = 64,
//   32, 16, 16 at D = 16, 32, 64, 128: two blocks an SM or more at D <= 64,
//   under 227 KB at D = 128), are copied raw with cp.async (16-byte copies,
//   or 4-byte ones for a view that is not 16-byte aligned: a template
//   parameter the launcher picks) and split by the block's threads into
//   their hi and lo tiles and transposes. The second products sum each
//   step's terms on the tensor cores in a zeroed block of registers, added
//   to the f32 accumulator with round-to-nearest, so the long sums over a
//   context are f32 additions.
//
// What bounds it on this card: each input read once and each output written
// once at 3.35 TB/s against the causal products at 989 TFLOP/s (bf16), or
// three times the products at TF32's 495 TFLOP/s (f32). At the training
// shapes the whole-context pair is bound by bytes (bf16 B1 forward N=1024
// T=256 C=128 H=4: 0.081 ms; B3 N=8 H=12 T=1024 D=64: 0.015 ms; f32 at
// config 4's N=256 T=256 C=128 H=4: 0.0404 ms forward, 0.0804 backward) or
// by operations (bf16 B4: 0.033 ms; f32 at B3/B4's shape: 0.0782 and 0.1954
// ms), and B5's backward (N=2 H=12 T=8192 D=64, 811.6 M computed pairs) by
// operations: 0.52 ms in bf16, 3.12 ms in f32. The kernels do more than the
// bound counts: the bf16 forward computes q k^T twice (two passes, three
// products over the computed tiles), and the backward seven products where
// the bound counts five, because dk/dv and dq are separate kernels that
// each own their output rows and recompute s and dp. That keeps the
// backward free of atomics and bit-reproducible run to run, as XLA's is. In
// f32 the split passes rewrite every streamed tile twice (hi and lo) and
// again transposed, and the small streamed tiles (S rows) make the first
// products read more shared memory per operation. The heaviest causal tiles
// are scheduled first (the tile index is the grid's slowest axis, counted
// from the last query tile in the forward and dq, from the first key tile
// in dk/dv), so the longest blocks start in the first wave.

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

// Backward strides: q k v do dq dk dv lse dlse.
struct BwdArgs {
  Strides sq, sk, sv, sdo, sdq, sdk, sdv, sl, sg;
};

__device__ __forceinline__ uint32_t smem_base(uint8_t* smem) {
  return (hop::smem_u32(smem) + 1023) & ~1023u;
}

// ============================================== f32: 3xTF32 wgmma (x3)

namespace x3 {

using hop::Lane;
using hop::Tile;
using hop::finish;
using hop::row_max4;
using hop::row_sum4;
using hop::start;
constexpr int THREADS = 128;  // one warpgroup a block

// The tiles of head dim D, f32 values. A block owns 64 rows (Rows tiles)
// and streams the other side's rows S at a time: S rows of D (Strm) and
// their transpose, D rows of S values in hop::key_order (Tr), each as a hi
// and a lo tile, copied raw (RAW bytes a tensor) and split in shared
// memory. S keeps a block's shared memory at 106 KB or less for D <= 64
// (two blocks an SM or more) and under 227 KB at D = 128.
template <int D>
struct Cfg {
  static constexpr int S = D <= 16 ? 64 : D == 32 ? 32 : 16;
  using Rows = Tile<4 * D>;
  using Strm = Tile<4 * D, S>;
  using Tr = Tile<4 * S, D>;
  static constexpr uint32_t RAW = S * D * 4;
};

__device__ __forceinline__ const float* at(uint8_t* smem, uint32_t addr) {
  return reinterpret_cast<const float*>(smem + (addr - hop::smem_u32(smem)));
}

// Rows [r0, r0 + ROWS) of a [T x D] f32 view with token stride ts into a
// dense [ROWS x D] buffer: 16-byte cp.async (VEC = 4: the view's base and
// strides 16-byte aligned) or 4-byte (VEC = 1: any view).
template <int ROWS, int D, int VEC>
__device__ __forceinline__ void copy_raw(uint32_t dst, const float* src,
                                         long long ts, int r0) {
  constexpr int PER_ROW = D / VEC;
  static_assert(ROWS * PER_ROW % THREADS == 0, "whole rounds");
#pragma unroll
  for (int e0 = 0; e0 < ROWS * PER_ROW; e0 += THREADS) {
    const int e = e0 + (int)threadIdx.x;
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const float* g = src + (long long)(r0 + r) * ts + c;
    if constexpr (VEC == 4) hop::cp_async16(dst + 4 * (r * D + c), g);
    else hop::cp_async4(dst + 4 * (r * D + c), g);
  }
}

// The dense [ROWS x D] rows at raw into a hi and a lo tile, Tile<4D, ROWS>.
template <int ROWS, int D>
__device__ __forceinline__ void split_rows(uint32_t hi, uint32_t lo,
                                           const float* raw) {
  using L = Tile<4 * D, ROWS>;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  static_assert(ROWS * CPR % THREADS == 0, "whole rounds");
#pragma unroll
  for (int e0 = 0; e0 < ROWS * CPR; e0 += THREADS) {
    const int e = e0 + (int)threadIdx.x;
    const int r = e / CPR, c = e % CPR;
    hop::put4(hi, lo, L::chunk(r, c),
              *reinterpret_cast<const float4*>(raw + r * D + 4 * c));
  }
}

// The dense [ROWS x D] rows at raw into a hi and a lo tile of their
// transpose, Tile<4 ROWS, D>: row d holds column d, each group of 8 rows in
// hop::key_order. A thread writes one 16-byte chunk; neighbouring threads
// read neighbouring columns.
template <int ROWS, int D>
__device__ __forceinline__ void split_cols(uint32_t hi, uint32_t lo,
                                           const float* raw) {
  using L = Tile<4 * ROWS, D>;
  constexpr int CPR = ROWS / 4;
  static_assert(D * CPR % THREADS == 0, "whole rounds");
#pragma unroll
  for (int e0 = 0; e0 < D * CPR; e0 += THREADS) {
    const int e = e0 + (int)threadIdx.x;
    const int d = e % D, c = e / D;  // chunk c: positions 4c .. 4c+3
    const float* g = raw + 8 * (c >> 1) * D + d;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = g[hop::key_order(4 * (c & 1) + i) * D];
    hop::put4(hi, lo, L::chunk(d, c), make_float4(x[0], x[1], x[2], x[3]));
  }
}

// Rows [r0, r0 + 64) of a [T x D] f32 view into a hi and a lo tile
// (Tile<4D>), through registers: the block's own rows, loaded once.
template <int D, int VEC>
__device__ __forceinline__ void load_split(uint32_t hi, uint32_t lo,
                                           const float* src, long long ts,
                                           int r0) {
  using L = Tile<4 * D>;
  constexpr int CPR = D / 4;
  static_assert(64 * CPR % THREADS == 0, "whole rounds");
#pragma unroll
  for (int e0 = 0; e0 < 64 * CPR; e0 += THREADS) {
    const int e = e0 + (int)threadIdx.x;
    const int r = e / CPR, c = e % CPR;
    const float* g = src + (long long)(r0 + r) * ts + 4 * c;
    float4 x;
    if constexpr (VEC == 4) x = *reinterpret_cast<const float4*>(g);
    else x = make_float4(g[0], g[1], g[2], g[3]);
    hop::put4(hi, lo, L::chunk(r, c), x);
  }
}

// Store two neighbouring values of one row (column even).
template <int VEC>
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}

template <int D>
constexpr size_t fwd_smem() {  // q, k, v^T (hi, lo); raw k, v
  using C = Cfg<D>;
  return 1024 + 2 * C::Rows::BYTES + 2 * C::Strm::BYTES +
         2 * C::Tr::BYTES + 2 * C::RAW;
}
template <int D>
constexpr size_t dq_smem() {  // q, do, k, v, k^T (hi, lo); raw k, v
  using C = Cfg<D>;
  return 1024 + 4 * C::Rows::BYTES + 4 * C::Strm::BYTES +
         2 * C::Tr::BYTES + 2 * C::RAW;
}
template <int D>
constexpr size_t dkdv_smem() {  // k, v, q, do, q^T, do^T (hi, lo); raw q,
                                // do; two (lse, delta, dlse) x S
  using C = Cfg<D>;
  return 1024 + 4 * C::Rows::BYTES + 4 * C::Strm::BYTES +
         4 * C::Tr::BYTES + 2 * C::RAW + 2 * 3 * C::S * sizeof(float);
}

// Forward, B1/B3: one block per (head, batch row, query tile); o and lse
// for its 64 query rows, one pass over the key rows, S at a time.
template <int D, int VEC>
__global__ void __launch_bounds__(THREADS)
attn_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                Strides so, Strides sl, int T_len, int causal, float scale) {
  using C = Cfg<D>;
  constexpr int S = C::S;
  extern __shared__ __align__(16) uint8_t xsmem[];
  const uint32_t Qh = smem_base(xsmem), Ql = Qh + C::Rows::BYTES;
  const uint32_t Kh = Ql + C::Rows::BYTES, Kl = Kh + C::Strm::BYTES;
  const uint32_t Vh = Kl + C::Strm::BYTES, Vl = Vh + C::Tr::BYTES;  // v^T
  const uint32_t Rk = Vl + C::Tr::BYTES, Rv = Rk + C::RAW;

  const int nt = T_len / 64;
  const int h = blockIdx.x;
  const long long n = blockIdx.y;
  const int qb = nt - 1 - (int)blockIdx.z;  // heaviest causal tiles first
  const int q0 = qb * 64;
  const float* kp = k + n * sk.n + h * sk.h;
  const float* vp = v + n * sv.n + h * sv.h;
  const Lane ln;
  const int nkb = (causal ? q0 + 64 : T_len) / S;

  copy_raw<S, D, VEC>(Rk, kp, sk.t, 0);
  copy_raw<S, D, VEC>(Rv, vp, sv.t, 0);
  hop::cp_async_commit();
  load_split<D, VEC>(Qh, Ql, q + n * sq.n + h * sq.h, sq.t, q0);

  const float c2 = scale * hop::LOG2E;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[S / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * S;
    hop::cp_async_wait<0>();
    __syncthreads();  // this step's raw rows have landed, for every thread
    split_rows<S, D>(Kh, Kl, at(xsmem, Rk));
    split_cols<S, D>(Vh, Vl, at(xsmem, Rv));
    hop::fence_async_smem();
    __syncthreads();  // the tiles are written and the raw buffers free
    if (kb + 1 < nkb) {
      copy_raw<S, D, VEC>(Rk, kp, sk.t, k0 + S);
      copy_raw<S, D, VEC>(Rv, vp, sv.t, k0 + S);
    }
    hop::cp_async_commit();

    start(s, acc);
    hop::mma3_abt<S, D, typename C::Rows, typename C::Strm>(s, Qh, Ql, Kh,
                                                            Kl);
    finish(s, acc);

    const bool diag = causal && k0 + S - 1 > q0;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) {
      const int r = ln.row + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + ln.col + (i & 1);
      s[i] = (diag && k0 + c > q0 + r) ? -INFINITY : s[i] * c2;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < S / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
      // finite: every row sees key 0 on the first step
      const float mnew = fmaxf(m[rr], row_max4(mx));
      const float alpha = exp2f(m[rr] - mnew);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < S / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * rr + e;
          s[i] = exp2f(s[i] - mnew);
          sum += s[i];
        }
      l[rr] = l[rr] * alpha + row_sum4(sum);
      m[rr] = mnew;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * rr] *= alpha;
        acc[4 * j + 2 * rr + 1] *= alpha;
      }
    }
    uint32_t ph[S / 8][4], pl[S / 8][4];
    hop::frags<S>(s, ph, pl);
    hop::mma3_pb_add<D, S, typename C::Tr>(acc, ph, pl, Vh, Vl);  // o += p v
  }

  float* op = o + n * so.n + h * so.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = q0 + ln.row + 8 * rr;
    const float inv = 1.f / l[rr];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair<VEC>(op + i * so.t + 8 * j + ln.col, acc[4 * j + 2 * rr] * inv,
                      acc[4 * j + 2 * rr + 1] * inv);
    if ((threadIdx.x & 3) == 0)
      lse[n * sl.n + h * sl.h + i * sl.t] = m[rr] * hop::LN2 + logf(l[rr]);
  }
}

// dq, B2/B4/B5b: one block per (head, batch row, query tile), over the key
// rows its rows see, S at a time. Its prologue computes delta =
// rowsum(do * o) for its rows and writes it for the dk/dv kernel, launched
// after it.
template <int D, int VEC>
__global__ void __launch_bounds__(THREADS)
attn_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ dlse, float* __restrict__ delta,
               float* __restrict__ dq, BwdArgs a, Strides so, int T_len,
               int causal, float scale) {
  using C = Cfg<D>;
  constexpr int S = C::S;
  extern __shared__ __align__(16) uint8_t xsmem[];
  const uint32_t Qh = smem_base(xsmem), Ql = Qh + C::Rows::BYTES;
  const uint32_t dOh = Ql + C::Rows::BYTES, dOl = dOh + C::Rows::BYTES;
  const uint32_t Kh = dOl + C::Rows::BYTES, Kl = Kh + C::Strm::BYTES;
  const uint32_t Vh = Kl + C::Strm::BYTES, Vl = Vh + C::Strm::BYTES;
  const uint32_t KTh = Vl + C::Strm::BYTES, KTl = KTh + C::Tr::BYTES;
  const uint32_t Rk = KTl + C::Tr::BYTES, Rv = Rk + C::RAW;

  const int nt = T_len / 64;
  const int h = blockIdx.x, H = gridDim.x;
  const long long n = blockIdx.y;
  const int qb = nt - 1 - (int)blockIdx.z;  // heaviest causal tiles first
  const int q0 = qb * 64;
  const float* kp = k + n * a.sk.n + h * a.sk.h;
  const float* vp = v + n * a.sv.n + h * a.sv.h;
  const float* dop = dout + n * a.sdo.n + h * a.sdo.h;
  const float* op = o + n * so.n + h * so.h;
  const Lane ln;
  const int nkb = (causal ? q0 + 64 : T_len) / S;

  copy_raw<S, D, VEC>(Rk, kp, a.sk.t, 0);
  copy_raw<S, D, VEC>(Rv, vp, a.sv.t, 0);
  hop::cp_async_commit();
  load_split<D, VEC>(Qh, Ql, q + n * a.sq.n + h * a.sq.h, a.sq.t, q0);
  load_split<D, VEC>(dOh, dOl, dop, a.sdo.t, q0);

  // row statistics of rows ln.row + 8 rr: lse in log2 units, delta, and the
  // lse cotangent (0 without one)
  float lse2[2], dl[2], g[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = q0 + ln.row + 8 * rr;
    lse2[rr] = lse[n * a.sl.n + h * a.sl.h + i * a.sl.t] * hop::LOG2E;
    g[rr] = dlse ? dlse[n * a.sg.n + h * a.sg.h + i * a.sg.t] : 0.f;
    const float* orow = op + i * so.t;
    const float* drow = dop + i * a.sdo.t;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + ln.col + e;
        sum = fmaf(drow[c], orow[c], sum);
      }
    dl[rr] = row_sum4(sum);
    if ((threadIdx.x & 3) == 0)
      delta[((long long)n * H + h) * T_len + i] = dl[rr];
  }

  const float c2 = scale * hop::LOG2E;
  float acc[D / 2], s[S / 2], dp[S / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * S;
    hop::cp_async_wait<0>();
    __syncthreads();  // this step's raw rows have landed, for every thread
    split_rows<S, D>(Kh, Kl, at(xsmem, Rk));
    split_rows<S, D>(Vh, Vl, at(xsmem, Rv));
    split_cols<S, D>(KTh, KTl, at(xsmem, Rk));
    hop::fence_async_smem();
    __syncthreads();  // the tiles are written and the raw buffers free
    if (kb + 1 < nkb) {
      copy_raw<S, D, VEC>(Rk, kp, a.sk.t, k0 + S);
      copy_raw<S, D, VEC>(Rv, vp, a.sv.t, k0 + S);
    }
    hop::cp_async_commit();

    start(s, dp);
    hop::mma3_abt<S, D, typename C::Rows, typename C::Strm>(s, Qh, Ql, Kh,
                                                            Kl);  // q k^T
    hop::mma3_abt<S, D, typename C::Rows, typename C::Strm>(dp, dOh, dOl, Vh,
                                                            Vl);  // do v^T
    finish(s, dp);

    const bool diag = causal && k0 + S - 1 > q0;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) {  // ds, in place of s
      const int rr = (i >> 1) & 1;
      const int r = ln.row + 8 * rr, c = 8 * (i >> 2) + ln.col + (i & 1);
      const float p = (diag && k0 + c > q0 + r)
                          ? 0.f
                          : exp2f(fmaf(s[i], c2, -lse2[rr]));
      s[i] = p * (dp[i] - dl[rr] + g[rr]) * scale;
    }
    uint32_t dsh[S / 8][4], dsl[S / 8][4];
    hop::frags<S>(s, dsh, dsl);
    hop::mma3_pb_add<D, S, typename C::Tr>(acc, dsh, dsl, KTh, KTl);  // ds k
  }

  float* dqp = dq + n * a.sdq.n + h * a.sdq.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = q0 + ln.row + 8 * rr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair<VEC>(dqp + i * a.sdq.t + 8 * j + ln.col, acc[4 * j + 2 * rr],
                      acc[4 * j + 2 * rr + 1]);
  }
}

// dk, dv, B2/B4/B5b: one block per (head, batch row, key tile), over the
// query rows that see it, S at a time. Key-major: s^T = k q^T and dp^T =
// v do^T put p^T and ds^T in registers as the A operands of dv += p^T do
// and dk += ds^T q, whose B tiles are do^T and q^T.
template <int D, int VEC>
__global__ void __launch_bounds__(THREADS)
attn_dkdv_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ dlse, float* __restrict__ dk,
                 float* __restrict__ dv, BwdArgs a, int T_len, int causal,
                 float scale) {
  using C = Cfg<D>;
  constexpr int S = C::S;
  extern __shared__ __align__(16) uint8_t xsmem[];
  const uint32_t Kh = smem_base(xsmem), Kl = Kh + C::Rows::BYTES;
  const uint32_t Vh = Kl + C::Rows::BYTES, Vl = Vh + C::Rows::BYTES;
  const uint32_t Qh = Vl + C::Rows::BYTES, Ql = Qh + C::Strm::BYTES;
  const uint32_t dOh = Ql + C::Strm::BYTES, dOl = dOh + C::Strm::BYTES;
  const uint32_t QTh = dOl + C::Strm::BYTES, QTl = QTh + C::Tr::BYTES;
  const uint32_t dOTh = QTl + C::Tr::BYTES, dOTl = dOTh + C::Tr::BYTES;
  const uint32_t Rq = dOTl + C::Tr::BYTES, Rdo = Rq + C::RAW;
  const uint32_t St = Rdo + C::RAW;  // two x (lse, delta, dlse) x S
  const float* stats = at(xsmem, St);

  const int h = blockIdx.x, H = gridDim.x;
  const long long n = blockIdx.y;
  const int k0 = blockIdx.z * 64;  // key tile 0 is seen by every query
  const float* qp = q + n * a.sq.n + h * a.sq.h;
  const float* dop = dout + n * a.sdo.n + h * a.sdo.h;
  const float* lp = lse + n * a.sl.n + h * a.sl.h;
  const float* dlp = delta + ((long long)n * H + h) * T_len;
  const float* gp = dlse ? dlse + n * a.sg.n + h * a.sg.h : nullptr;
  const Lane ln;

  auto copy_q = [&](int q0, int buf) {
    copy_raw<S, D, VEC>(Rq, qp, a.sq.t, q0);
    copy_raw<S, D, VEC>(Rdo, dop, a.sdo.t, q0);
    for (int e = threadIdx.x; e < 3 * S; e += THREADS) {
      const int which = e / S, r = e % S;
      const long long i = q0 + r;
      const float* src = which == 0   ? lp + i * a.sl.t
                         : which == 1 ? dlp + i
                                      : gp + i * a.sg.t;
      if (which < 2 || gp)
        hop::cp_async4(St + 4 * ((buf * 3 + which) * S + r), src);
    }
  };

  const int qs = causal ? k0 / S : 0;  // the first query rows that see k0
  const int nq = T_len / S - qs;
  copy_q(qs * S, 0);
  hop::cp_async_commit();
  load_split<D, VEC>(Kh, Kl, k + n * a.sk.n + h * a.sk.h, a.sk.t, k0);
  load_split<D, VEC>(Vh, Vl, v + n * a.sv.n + h * a.sv.h, a.sv.t, k0);

  const float c2 = scale * hop::LOG2E;
  float dka[D / 2], dva[D / 2], s[S / 2], dp[S / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int q0 = (qs + it) * S, buf = it & 1;
    hop::cp_async_wait<0>();
    __syncthreads();  // this step's raw rows have landed, for every thread
    split_rows<S, D>(Qh, Ql, at(xsmem, Rq));
    split_rows<S, D>(dOh, dOl, at(xsmem, Rdo));
    split_cols<S, D>(QTh, QTl, at(xsmem, Rq));
    split_cols<S, D>(dOTh, dOTl, at(xsmem, Rdo));
    hop::fence_async_smem();
    __syncthreads();  // the tiles are written and the raw buffers free
    if (it + 1 < nq) copy_q(q0 + S, buf ^ 1);
    hop::cp_async_commit();
    const float* Ls = stats + buf * 3 * S;
    const float* Dl = Ls + S;
    const float* Gl = Ls + 2 * S;

    start(s, dp);
    hop::mma3_abt<S, D, typename C::Rows, typename C::Strm>(s, Kh, Kl, Qh,
                                                            Ql);  // k q^T
    hop::mma3_abt<S, D, typename C::Rows, typename C::Strm>(dp, Vh, Vl, dOh,
                                                            dOl);  // v do^T
    finish(s, dp);

    const bool diag = causal && q0 < k0 + 63;
#pragma unroll
    for (int i = 0; i < S / 2; ++i) {  // p^T and ds^T, in place of s, dp
      const int r = ln.row + 8 * ((i >> 1) & 1);     // key row
      const int c = 8 * (i >> 2) + ln.col + (i & 1);  // query column
      const float p = (diag && k0 + r > q0 + c)
                          ? 0.f
                          : exp2f(fmaf(s[i], c2, -Ls[c] * hop::LOG2E));
      s[i] = p;
      dp[i] = p * (dp[i] - Dl[c] + (gp ? Gl[c] : 0.f)) * scale;
    }
    {  // dv += p^T do
      uint32_t fh[S / 8][4], fl[S / 8][4];
      hop::frags<S>(s, fh, fl);
      hop::mma3_pb_add<D, S, typename C::Tr>(dva, fh, fl, dOTh, dOTl);
    }
    {  // dk += ds^T q
      uint32_t fh[S / 8][4], fl[S / 8][4];
      hop::frags<S>(dp, fh, fl);
      hop::mma3_pb_add<D, S, typename C::Tr>(dka, fh, fl, QTh, QTl);
    }
  }

  float* dkp = dk + n * a.sdk.n + h * a.sdk.h;
  float* dvp = dv + n * a.sdv.n + h * a.sdv.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long j = k0 + ln.row + 8 * rr;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + ln.col;
      store_pair<VEC>(dkp + j * a.sdk.t + col, dka[4 * c + 2 * rr],
                      dka[4 * c + 2 * rr + 1]);
      store_pair<VEC>(dvp + j * a.sdv.t + col, dva[4 * c + 2 * rr],
                      dva[4 * c + 2 * rr + 1]);
    }
  }
}

// f32 views that the 16-byte copies take: base and every stride 16-byte
// aligned; any other view takes the 4-byte copies
bool aligned16_f32(const void* p, Strides s) {
  return ((uintptr_t)p & 15) == 0 && s.n % 4 == 0 && s.h % 4 == 0 &&
         s.t % 4 == 0;
}

template <int D, int VEC>
cudaError_t launch_fwd_vec(const float* q, const float* k, const float* v,
                           float* o, float* lse, const long long* st, int N,
                           int H, int T_len, int causal, float scale,
                           cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  auto kern = attn_fwd_tf32x3<D, VEC>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, N, T_len / 64);
  kern<<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4), T_len, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const long long* st, int N, int H, int T_len,
                       int causal, float scale, cudaStream_t stream) {
  const bool vec = aligned16_f32(q, strides_at(st, 0)) &&
                   aligned16_f32(k, strides_at(st, 1)) &&
                   aligned16_f32(v, strides_at(st, 2)) &&
                   aligned16_f32(o, strides_at(st, 3));
  if (vec)
    return launch_fwd_vec<D, 4>((const float*)q, (const float*)k,
                                (const float*)v, (float*)o, (float*)lse, st,
                                N, H, T_len, causal, scale, stream);
  return launch_fwd_vec<D, 1>((const float*)q, (const float*)k,
                              (const float*)v, (float*)o, (float*)lse, st, N,
                              H, T_len, causal, scale, stream);
}

template <int D, int VEC>
cudaError_t launch_bwd_vec(const float* q, const float* k, const float* v,
                           const float* o, const float* dout,
                           const float* lse, const float* dlse, float* dq,
                           float* dk, float* dv, float* delta,
                           const long long* st, int N, int H, int T_len,
                           int causal, float scale, cudaStream_t stream) {
  // strides: q k v o do dq dk dv lse dlse
  BwdArgs a{strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
            strides_at(st, 4), strides_at(st, 5), strides_at(st, 6),
            strides_at(st, 7), strides_at(st, 8), strides_at(st, 9)};
  dim3 grid(H, N, T_len / 64);
  const size_t smem_q = dq_smem<D>();
  auto kdq = attn_dq_tf32x3<D, VEC>;
  cudaError_t err = set_smem(kdq, smem_q);
  if (err != cudaSuccess) return err;
  kdq<<<grid, THREADS, smem_q, stream>>>(q, k, v, o, dout, lse, dlse, delta,
                                         dq, a, strides_at(st, 3), T_len,
                                         causal, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_kv = dkdv_smem<D>();
  auto kdkdv = attn_dkdv_tf32x3<D, VEC>;
  if ((err = set_smem(kdkdv, smem_kv)) != cudaSuccess) return err;
  kdkdv<<<grid, THREADS, smem_kv, stream>>>(q, k, v, dout, lse, delta, dlse,
                                            dk, dv, a, T_len, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* lse,
                       const void* dlse, void* dq, void* dk, void* dv,
                       void* delta, const long long* st, int N, int H,
                       int T_len, int causal, float scale,
                       cudaStream_t stream) {
  const void* views[7] = {q, k, v, dout, dq, dk, dv};
  const int which[7] = {0, 1, 2, 4, 5, 6, 7};
  bool vec = true;
  for (int i = 0; i < 7; ++i)
    vec = vec && aligned16_f32(views[i], strides_at(st, which[i]));
  if (vec)
    return launch_bwd_vec<D, 4>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)o,
        (const float*)dout, (const float*)lse, (const float*)dlse, (float*)dq,
        (float*)dk, (float*)dv, (float*)delta, st, N, H, T_len, causal, scale,
        stream);
  return launch_bwd_vec<D, 1>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (const float*)dlse, (float*)dq,
      (float*)dk, (float*)dv, (float*)delta, st, N, H, T_len, causal, scale,
      stream);
}

}  // namespace x3

// ============================================================ bf16: wgmma

namespace wg {

using bf16 = __nv_bfloat16;
using hop::Lane;
using hop::BfTile;
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

template <int D>
constexpr size_t fwd_smem() {  // q, two k and two v tiles, 1024-aligned
  return 1024 + 5 * BfTile<D>::BYTES;
}
template <int D>
constexpr size_t dq_smem() {  // q, do, two k and two v tiles
  return 1024 + 6 * BfTile<D>::BYTES;
}
template <int D>
constexpr size_t dkdv_smem() {  // k, v, two q and two do tiles, two stats
  return 1024 + 6 * BfTile<D>::BYTES + 2 * 3 * 64 * sizeof(float);
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
  using L = BfTile<D>;
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
  using L = BfTile<D>;
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
  using L = BfTile<D>;
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
// Takes T / 64 <= 65535 (query tiles are the grid's z axis), as the
// long-context forward does; bf16 takes views whose base and strides are
// 16-byte aligned (both entries), f32 any view.
int gym_attn_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, const long long* strides, int N, int H, int T_len,
                 int D, int causal, float scale, int dtype, void* stream) {
  if (T_len % 64 != 0 || T_len / 64 > 65535 || N <= 0 || H <= 0 ||
      N > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    GYM_HEAD_DIM(D, (wg::launch_fwd<D>(q, k, v, o, lse, strides, N, H, T_len,
                                       causal, scale, s)));
  } else if (dtype == 0) {
    GYM_HEAD_DIM(D, (x3::launch_fwd<D>(q, k, v, o, lse, strides, N, H, T_len,
                                       causal, scale, s)));
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
  if (T_len % 64 != 0 || T_len / 64 > 65535 || N <= 0 || H <= 0 ||
      N > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    GYM_HEAD_DIM(D, (wg::launch_bwd<D>(q, k, v, o, dout, lse, dlse, dq, dk,
                                       dv, delta, strides, N, H, T_len,
                                       causal, scale, s)));
  } else if (dtype == 0) {
    GYM_HEAD_DIM(D, (x3::launch_bwd<D>(q, k, v, o, dout, lse, dlse, dq, dk,
                                       dv, delta, strides, N, H, T_len,
                                       causal, scale, s)));
  }
  return (int)cudaErrorInvalidValue;
}

long long gym_flash_smem_bytes(int D, int wgmma);  // flash_attention.cu

// dynamic shared memory of one block: kernel 0 = forward, 1 = dk/dv,
// 2 = dq (f32, 3xTF32 wgmma), 3 = the long-context forward (f32, scalar),
// 4 = forward, 5 = dk/dv, 6 = dq (bf16, wgmma), 7 = the long-context
// forward (bf16, wgmma); -1 for an unsupported head dim or kernel
long long gym_attn_smem_bytes(int kernel, int D) {
  if (kernel == 3 || kernel == 7) return gym_flash_smem_bytes(D, kernel == 7);
  if (kernel < 0 || kernel > 6) return -1;
#define GYM_SMEM_ROW(DD)                                                     \
  case DD: {                                                                 \
    const long long b[7] = {(long long)x3::fwd_smem<DD>(),                  \
                            (long long)x3::dkdv_smem<DD>(),                 \
                            (long long)x3::dq_smem<DD>(), 0,                \
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
