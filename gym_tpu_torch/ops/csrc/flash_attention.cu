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
// diagonal tiles only; the tiles above them are never visited.
//
// Both dtypes share one shape. A block owns 128 query rows of one head and
// has three warpgroups. One producer thread keeps the block's key tiles in
// flight into a ring of STAGES stages in shared memory, with an mbarrier a
// stage for "full" (the copied bytes landed) and one for "empty" (both
// consumers are done with it). Two consumer warpgroups own 64 query rows
// each and share every stage: s = q k^T on wgmma from shared memory (both
// operands K-major), the online softmax in registers in log2 units (exp2
// of s * scale * log2 e), then o += p v on wgmma with p in registers (the
// accumulator layout is wgmma's register A layout). setmaxnreg moves
// registers from the producer warpgroup to the consumers. Warpgroup 0, whose
// rows end 64 keys earlier, skips the block's last 64 keys.
// - bf16 (training): flash_fwd_wgmma. The producer issues TMA loads (tensor
//   maps of the strided [N, H, T, D] views, encoded on the host for each
//   call) of the block's q tiles once and of 64-key k and v tiles; TMA
//   writes each box in the swizzle of the tile layout of hopper.cuh, so
//   wgmma reads what it wrote; p is rounded to bf16 in registers and v read
//   MN-major.
// - f32 (evals, card-against-CPU checks): split-precision TF32 ("3xTF32",
//   hopper.cuh): each operand x is held as hi + lo, two TF32 values, and
//   each product is three wgmmas, a_lo b_hi + a_hi b_lo + a_hi b_hi, about
//   2^-21 relative, the order of reordering an f32 sum (single-pass TF32,
//   2^-11, moves lse by about 1e-3 where the f32 tolerance allows 1e-5).
//   Rounding p to f32 is the identity, so the unnormalised accumulator
//   divided by l is the TPU kernel's normalised one up to f32 reordering.
//   Two launches: split_kv_tf32x3 splits k and v once into a workspace of
//   four copies (k hi and lo, v^T hi and lo), written S keys at a time in
//   the swizzled tile layouts wgmma reads: k K-major, and v^T (TF32 wgmma
//   reads shared memory only K-major, so the B tile of p v is v's
//   transpose) with each group of 8 keys in hop::key_order, which makes the
//   accumulator layout TF32's register A fragment (hop::frags).
//   flash_fwd_tf32x3 then streams those tiles: one step's four tiles lie
//   one after the other in the workspace, so the producer loads a stage
//   with one 1-D bulk copy (cp.async.bulk, no tensor map: the tiles are
//   already swizzled and dense) that completes on the stage's full
//   barrier. Each consumer splits its q rows once: at D <= 64 into hi and
//   lo TF32 A fragments in registers, so that q k^T reads only k from
//   shared memory (an SS wgmma of N = 64 reads 4 KB a k8 step, about what
//   shared memory delivers while the tensor cores do the step: measured
//   7% slower at D = 64 by scripts/flash_fwd_ab.py --f32), at D = 128
//   into hi and lo tiles (16-byte loads, or 4-byte ones for a view that is
//   not 16-byte aligned: a template parameter the launcher picks, as for
//   the pre-pass). Each step's p v is summed on the tensor cores in zeroed
//   registers and added to the accumulator in f32 (hop::mma3_pb_add): o
//   sums 8,192 keys at T = 8192.
//   S = 64 keys a step at D <= 64 (N = 64 wgmmas) and 16 at D = 128, where
//   64 keys would not fit; the ring holds 4 stages at D <= 32, 3 at D = 64
//   and 2 at D = 128 (192 KB of shared memory at D = 64 and 128).
//
// What bounds it on this card (an H100 SXM's published peaks, which assume
// its full 700 W power limit): at the slice's shape (N=2, H=12, T=8192,
// D=64) the forward is 2 products of 2*D flops over 805 M causal pairs,
// 206 GFLOP: in bf16 0.2085 ms at the tensor-core peak of 989 TFLOP/s,
// against 0.030 ms for its 101 MB of q, k, v, o and lse at 3.35 TB/s; in
// f32 three TF32 products each at 495 TFLOP/s, 1.2496 ms, against 0.060 ms
// for 201 MB. Both are bound by operations. What the design does about
// it: the products run on wgmma, fed by a ring whose copies no consumer
// thread issues, so the next tiles land while this one is computed; one
// pass (q k^T once per pair); key tiles above the diagonal never visited,
// so the tiles computed are the 64 x 64 tiles on or below the diagonal
// (811.6 M pairs at this shape); 128 query rows share each tile brought on
// chip; the heaviest query blocks first (the grid's slowest axis counts
// them from the last): under causal skipping the last block does T/128
// times the work of the first, and a heavy block left to the end of the
// grid would run alone on an idle card. In bf16 at D = 64 a tile's 4,096
// exponentials keep the special-function units as long as its two
// products keep the tensor cores, so the softmax is lean (the scale folds
// into the exponent's FMA, the scores are only read), and one consumer's
// softmax overlaps the other's products; issuing a tile's q k^T ahead of
// the previous tile's softmax within a warpgroup measured slower at D = 64
// and is not done. In f32 the products are three times as many for the same
// exponentials. The pre-pass moves k and v once (read 101 MB, write four
// split copies, 201 MB at the slice's shape: about 0.09 ms at 3.35 TB/s)
// and leaves the main loop nothing to split but p. The alternative, a
// splitter warpgroup that splits raw TMA tiles inside the kernel, repeats
// the split for every 128-row query block that reads a tile, about 32x the
// pre-pass's work at T = 8192, and so does fused_attention.cu's
// attn_fwd_tf32x3, which takes this function too but splits and transposes
// every streamed tile (16 keys at D = 64) between two barriers of its one
// warpgroup.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

// ============================================================ f32: 3xTF32

namespace x3 {

using hop::Tile;
constexpr int THREADS = 384;    // producer warpgroup, two consumers
constexpr int CONSUMERS = 256;  // arrivals that empty a stage
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int SPLIT_THREADS = 128;

// Head dim D: S keys a step, the ring's depth and the tiles. One step's
// tiles (k hi, k lo, v^T hi, v^T lo) lie one after the other, in the
// workspace and in a ring stage.
template <int D>
struct Cfg {
  static constexpr int S = D <= 64 ? 64 : 16;
  // q in registers as TF32 A fragments (q k^T on RS wgmma, which reads only
  // k from shared memory) where they fit beside the accumulators, else in
  // hi and lo tiles in shared memory
  static constexpr bool QREG = D <= 64;
  static constexpr int STAGES = D <= 32 ? 4 : D == 64 ? 3 : 2;
  using Q = Tile<4 * D>;     // a consumer's 64 query rows, K-major
  using K = Tile<4 * D, S>;  // S keys, K-major
  using V = Tile<4 * S, D>;  // v^T: D rows of S keys in hop::key_order
  static constexpr uint32_t KL = K::BYTES;  // byte offsets in a step
  static constexpr uint32_t VH = 2 * K::BYTES;
  static constexpr uint32_t VL = VH + V::BYTES;
  static constexpr uint32_t STEP = VL + V::BYTES;
  // shared memory, byte offsets from a 1024-aligned base: the q hi and lo
  // tiles of each consumer (unless QREG), the ring, then the barriers
  // full[STAGES], empty[STAGES]
  static constexpr uint32_t RING = QREG ? 0 : 4 * Q::BYTES;
  static constexpr uint32_t BARS = RING + STAGES * STEP;
  static constexpr size_t BYTES = 1024 + BARS + 8 * 2 * STAGES;
};

// Rows [r0, r0 + ROWS) of a [T x D] f32 view with token stride ts into a
// dense [ROWS x D] buffer: 16-byte loads (VEC = 4: the view's base and
// strides 16-byte aligned) or 4-byte (VEC = 1: any view).
template <int ROWS, int D, int VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ts, int r0) {
  constexpr int PER_ROW = D / VEC;
  static_assert(ROWS * PER_ROW % SPLIT_THREADS == 0, "whole rounds");
#pragma unroll
  for (int e0 = 0; e0 < ROWS * PER_ROW; e0 += SPLIT_THREADS) {
    const int e = e0 + (int)threadIdx.x;
    const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
    const float* g = src + (long long)(r0 + r) * ts + c;
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(dst + r * D + c) =
          *reinterpret_cast<const float4*>(g);
    else dst[r * D + c] = *g;
  }
}

// the hi and lo parts of four values into the same 16-byte chunk (byte
// offset off) of a hi and a lo tile in global memory
__device__ __forceinline__ void put4(uint8_t* hi, uint8_t* lo, uint32_t off,
                                     float4 x) {
  float h[4], l[4];
  hop::split_tf32(x.x, h[0], l[0]);
  hop::split_tf32(x.y, h[1], l[1]);
  hop::split_tf32(x.z, h[2], l[2]);
  hop::split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(lo + off) = make_float4(l[0], l[1], l[2], l[3]);
}

// The pre-pass: one block per (key step, batch row x head) writes that
// step's four tiles into the workspace, step kb of head nh at ((nh * T/S +
// kb) * STEP) bytes. blockIdx.x = n * H + h, blockIdx.y = kb.
template <int D, int VEC>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kv_tf32x3(const float* __restrict__ k, const float* __restrict__ v,
                uint8_t* __restrict__ work, Strides sk, Strides sv, int H,
                int T_len) {
  using C = Cfg<D>;
  constexpr int S = C::S;
  __shared__ __align__(16) float rk[S * D], rv[S * D];
  const int nh = blockIdx.x, kb = blockIdx.y;
  const int h = nh % H;
  const long long n = nh / H;
  load_rows<S, D, VEC>(rk, k + n * sk.n + h * sk.h, sk.t, kb * S);
  load_rows<S, D, VEC>(rv, v + n * sv.n + h * sv.h, sv.t, kb * S);
  __syncthreads();
  uint8_t* step = work + ((long long)nh * (T_len / S) + kb) * C::STEP;
  // k: chunk c of row r holds values 4c .. 4c+3
  constexpr int KC = D / 4;
#pragma unroll
  for (int e0 = 0; e0 < S * KC; e0 += SPLIT_THREADS) {
    const int e = e0 + (int)threadIdx.x;
    const int r = e / KC, c = e % KC;
    put4(step, step + C::KL, C::K::chunk(r, c),
         *reinterpret_cast<const float4*>(rk + r * D + 4 * c));
  }
  // v^T: chunk c of row d holds positions 4c .. 4c+3 of its 8-key group
  // c / 2, in key order; neighbouring threads read neighbouring columns
  constexpr int VC = S / 4;
#pragma unroll
  for (int e0 = 0; e0 < D * VC; e0 += SPLIT_THREADS) {
    const int e = e0 + (int)threadIdx.x;
    const int d = e % D, c = e / D;
    const float* g = rv + 8 * (c >> 1) * D + d;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = g[hop::key_order(4 * (c & 1) + i) * D];
    put4(step + C::VH, step + C::VL, C::V::chunk(d, c),
         make_float4(x[0], x[1], x[2], x[3]));
  }
}

// The block's 128 query rows from r0 into the consumers' hi and lo tiles
// (rows 64w .. 64w + 63 into consumer w's), split by all its threads.
template <int D, int VEC>
__device__ __forceinline__ void load_split_q(uint32_t base, const float* src,
                                             long long ts, int r0) {
  using C = Cfg<D>;
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < 128 * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    const float* g = src + (long long)(r0 + r) * ts + 4 * c;
    float4 x;
    if constexpr (VEC == 4) x = *reinterpret_cast<const float4*>(g);
    else x = make_float4(g[0], g[1], g[2], g[3]);
    const uint32_t hi = base + 2 * (r >> 6) * C::Q::BYTES;
    hop::put4(hi, hi + C::Q::BYTES, C::Q::chunk(r & 63, c), x);
  }
}

// A consumer's 64 query rows from r0 as the hi and lo TF32 A fragments of
// the depth steps of q k^T (hopper.cuh: four values a thread a step, rows
// ln.row and ln.row + 8, columns l % 4 and l % 4 + 4 of the step).
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&hi)[D / 8][4],
                                             uint32_t (&lo)[D / 8][4],
                                             const float* src, long long ts,
                                             int r0) {
  const hop::Lane ln;
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h, l;
      hop::split_tf32(src[(long long)(r0 + ln.row + 8 * (i & 1)) * ts +
                          8 * ks + c + 4 * (i >> 1)],
                      h, l);
      hi[ks][i] = __float_as_uint(h);
      lo[ks][i] = __float_as_uint(l);
    }
}

// One step's scores s (this thread's rows ln.row and ln.row + 8 of its
// warpgroup, S keys), unscaled, become p = exp2(s * scale * log2 e - m) in
// place, folded into the running row max m and sum l in log2 units; the
// accumulator is rescaled by exp2(m_old - m_new). On a step that crosses
// the diagonal (diag), key column c of row r is masked where c - r > off,
// off = first row - first key.
template <int S, int D>
__device__ __forceinline__ void online_softmax(float (&s)[S / 2], bool diag,
                                               int off, const hop::Lane& ln,
                                               float c2, float (&m)[2],
                                               float (&l)[2],
                                               float (&acc)[D / 2]) {
#pragma unroll
  for (int i = 0; i < S / 2; ++i) {
    const int r = ln.row + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + ln.col + (i & 1);
    s[i] = (diag && c - r > off) ? -INFINITY : s[i] * c2;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < S / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
    // finite: every row sees key 0 on the first step
    const float mnew = fmaxf(m[rr], hop::row_max4(mx));
    const float alpha = exp2f(m[rr] - mnew);  // 0 at the first step
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < S / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e;
        s[i] = exp2f(s[i] - mnew);  // masked: exp2(-inf) = 0
        sum += s[i];
      }
    l[rr] = l[rr] * alpha + hop::row_sum4(sum);
    m[rr] = mnew;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 2 * rr] *= alpha;
      acc[4 * j + 2 * rr + 1] *= alpha;
    }
  }
}

// One block per (batch row x head, 128-row query block): o and lse of its
// rows, from the pre-pass's tiles of its head. blockIdx.x = n * H + h;
// blockIdx.y counts query blocks from the last, so the grid's first wave
// holds the blocks that see the most keys.
template <int D, int VEC>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32x3(const float* __restrict__ q,
                 const uint8_t* __restrict__ work, float* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides so, Strides sl,
                 int H, int T_len, float scale) {
  using C = Cfg<D>;
  constexpr int S = C::S, STAGES = C::STAGES;
  extern __shared__ __align__(16) uint8_t xsmem[];
  const uint32_t base = (hop::smem_u32(xsmem) + 1023) & ~1023u;
  const uint32_t ring = base + C::RING;
  const auto full = [&](int st) { return base + C::BARS + 8 * st; };
  const auto empty = [&](int st) {
    return base + C::BARS + 8 * (STAGES + st);
  };

  const int qb = gridDim.y - 1 - (int)blockIdx.y;
  const int nh = blockIdx.x, h = nh % H;
  const long long n = nh / H;
  const int nks = (128 * qb + 128) / S;  // key steps up to the last row
  const uint8_t* steps = work + (long long)nh * (T_len / S) * C::STEP;
  const int role = threadIdx.x >> 7;  // 0 producer, 1 and 2 consumers
  const auto load_step = [&](int kb) {
    const int st = kb % STAGES;
    hop::mbar_expect_tx(full(st), C::STEP);
    hop::bulk_load(ring + st * C::STEP, steps + (long long)kb * C::STEP,
                   C::STEP, full(st));
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      hop::mbar_init(full(st), 1);
      hop::mbar_init(empty(st), CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
  // the ring's first round is free: its copies go out before q is split
  if (threadIdx.x == 0)
    for (int kb = 0; kb < STAGES && kb < nks; ++kb) load_step(kb);
  const float* qp = q + n * sq.n + h * sq.h;
  if constexpr (!C::QREG) {
    load_split_q<D, VEC>(base, qp, sq.t, 128 * qb);
    hop::fence_async_smem();
    __syncthreads();
  }

  if (role == 0) {
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int kb = STAGES; kb < nks; ++kb) {
        // round r of a stage waits for the consumers' release of round
        // r - 1
        hop::mbar_wait(empty(kb % STAGES), ((kb / STAGES) & 1) ^ 1);
        load_step(kb);
      }
    }
    return;
  }

  hop::setmaxnreg_inc<CONSUMER_REGS>();
  const int w = role - 1;         // rows 64w .. 64w + 63 of the block
  const int r0 = 128 * qb + 64 * w;
  const int mine = (r0 + 64) / S;  // the key steps this warpgroup's rows see
  const uint32_t Qh = base + 2 * w * C::Q::BYTES, Ql = Qh + C::Q::BYTES;
  uint32_t qh[C::QREG ? D / 8 : 1][4], ql[C::QREG ? D / 8 : 1][4];
  if constexpr (C::QREG) load_q_frags<D>(qh, ql, qp, sq.t, r0);
  const hop::Lane ln;
  const float c2 = scale * hop::LOG2E;  // scores in log2 units
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[S / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < nks; ++kb) {
    const int st = kb % STAGES;
    const uint32_t tiles = ring + st * C::STEP;
    hop::mbar_wait(full(st), (kb / STAGES) & 1);
    // warpgroup 0 sees none of the block's last 64 keys: it only releases
    // their stages, after each round has landed (an earlier arrival would
    // count toward the stage's previous round)
    if (kb < mine) {
      hop::start(s, acc);
      if constexpr (C::QREG)
        hop::mma3_rbt<S, D, typename C::K>(s, qh, ql, tiles, tiles + C::KL);
      else
        hop::mma3_abt<S, D, typename C::Q, typename C::K>(s, Qh, Ql, tiles,
                                                          tiles + C::KL);
      hop::finish(s, acc);
      online_softmax<S, D>(s, kb * S + S - 1 > r0, r0 - kb * S, ln, c2, m,
                           l, acc);
      uint32_t ph[S / 8][4], pl[S / 8][4];
      hop::frags<S>(s, ph, pl);
      // o += p v; returns once its products are done with the stage
      hop::mma3_pb_add<D, S, typename C::V>(acc, ph, pl, tiles + C::VH,
                                            tiles + C::VL);
    }
    hop::mbar_arrive(empty(st));
  }

  float* op = o + n * so.n + h * so.h;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const long long i = r0 + ln.row + 8 * rr;
    const float inv = 1.f / l[rr];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      hop::store_pair<VEC>(op + i * so.t + 8 * j + ln.col,
                           acc[4 * j + 2 * rr] * inv,
                           acc[4 * j + 2 * rr + 1] * inv);
    if ((threadIdx.x & 3) == 0)
      lse[n * sl.n + h * sl.h + i * sl.t] = m[rr] * hop::LN2 + logf(l[rr]);
  }
}

// f32 views that the 16-byte copies take (q, k, v and o)
bool vec_views(const void* q, const void* k, const void* v, const void* o,
               const long long* st) {
  return aligned16_f32(q, strides_at(st, 0)) &&
         aligned16_f32(k, strides_at(st, 1)) &&
         aligned16_f32(v, strides_at(st, 2)) &&
         aligned16_f32(o, strides_at(st, 3));
}

template <int D, int VEC>
cudaError_t launch_split(const float* k, const float* v, uint8_t* work,
                         const long long* st, int N, int H, int T_len,
                         cudaStream_t stream) {
  using C = Cfg<D>;
  if (work == nullptr || T_len / C::S > 65535) return cudaErrorInvalidValue;
  split_kv_tf32x3<D, VEC><<<dim3(N * H, T_len / C::S), SPLIT_THREADS, 0,
                            stream>>>(k, v, work, strides_at(st, 1),
                                      strides_at(st, 2), H, T_len);
  return cudaGetLastError();
}

template <int D, int VEC>
cudaError_t launch_fwd_vec(const float* q, const float* k, const float* v,
                           float* o, float* lse, uint8_t* work,
                           const long long* st, int N, int H, int T_len,
                           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = launch_split<D, VEC>(k, v, work, st, N, H, T_len, stream);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_tf32x3<D, VEC>;
  if ((err = set_smem(kern, C::BYTES)) != cudaSuccess) return err;
  kern<<<dim3(N * H, T_len / 128), THREADS, C::BYTES, stream>>>(
      q, work, o, lse, strides_at(st, 0), strides_at(st, 3),
      strides_at(st, 4), H, T_len, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, void* work, const long long* st, int N,
                       int H, int T_len, float scale, cudaStream_t stream) {
  if (vec_views(q, k, v, o, st))
    return launch_fwd_vec<D, 4>((const float*)q, (const float*)k,
                                (const float*)v, (float*)o, (float*)lse,
                                (uint8_t*)work, st, N, H, T_len, scale,
                                stream);
  return launch_fwd_vec<D, 1>((const float*)q, (const float*)k,
                              (const float*)v, (float*)o, (float*)lse,
                              (uint8_t*)work, st, N, H, T_len, scale, stream);
}

// the pre-pass alone, with the copy width the forward would pick
template <int D>
cudaError_t launch_split_only(const void* q, const void* k, const void* v,
                              const void* o, void* work, const long long* st,
                              int N, int H, int T_len, cudaStream_t stream) {
  if (vec_views(q, k, v, o, st))
    return launch_split<D, 4>((const float*)k, (const float*)v,
                              (uint8_t*)work, st, N, H, T_len, stream);
  return launch_split<D, 1>((const float*)k, (const float*)v, (uint8_t*)work,
                            st, N, H, T_len, stream);
}

}  // namespace x3

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
// kernel's rule; the query blocks are 128 rows); bf16 views 16-byte aligned
// (base and strides), f32 any view. work: f32 only, 16 N H T D bytes,
// 16-byte aligned, for the split k and v (NULL for bf16). Returns a
// cudaError_t (gym_attn_error_string names it).
int gym_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, void* work, const long long* strides, int N,
                  int H, int T_len, int D, float scale, int dtype,
                  void* stream) {
  if (T_len <= 0 || T_len % 128 != 0 || T_len / 64 > 65535 || N <= 0 ||
      H <= 0 || (long long)N * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    GYM_HEAD_DIM(D, (wg::launch_fwd<D>(q, k, v, o, lse, strides, N, H, T_len,
                                       scale, s)));
  } else if (dtype == 0) {
    GYM_HEAD_DIM(D, (x3::launch_fwd<D>(q, k, v, o, lse, work, strides, N,
                                       H, T_len, scale, s)));
  }
  return (int)cudaErrorInvalidValue;
}

// The f32 forward's pre-pass alone (split_kv_tf32x3: k and v into work,
// as gym_flash_fwd takes them), for timing it on its own.
int gym_flash_split_kv(const void* q, const void* k, const void* v,
                       const void* o, void* work, const long long* strides,
                       int N, int H, int T_len, int D, void* stream) {
  if (T_len <= 0 || T_len % 128 != 0 || N <= 0 || H <= 0 ||
      (long long)N * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  GYM_HEAD_DIM(D, (x3::launch_split_only<D>(q, k, v, o, work, strides, N, H,
                                            T_len, (cudaStream_t)stream)));
  return (int)cudaErrorInvalidValue;
}

// Blocks of the long-context forward (bf16 = 1: flash_fwd_wgmma; 0: the
// f32 flash_fwd_tf32x3 with 16-byte copies) resident on one SM at head dim
// D, or a negative cudaError_t; regs gets the registers a thread holds
// after setmaxnreg in the producer and in the consumer warpgroups, and at
// launch.
int gym_flash_occupancy(int D, int bf16, int* regs) {
  static_assert(wg::PRODUCER_REGS == x3::PRODUCER_REGS &&
                    wg::CONSUMER_REGS == x3::CONSUMER_REGS &&
                    wg::THREADS == x3::THREADS,
                "one register split");
  regs[0] = wg::PRODUCER_REGS;
  regs[1] = wg::CONSUMER_REGS;
  const auto occupancy = [&](auto kern, size_t smem) {
    cudaFuncAttributes attr;
    int blocks = 0;
    cudaError_t err = set_smem(kern, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                          wg::THREADS, smem);
    if (err != cudaSuccess) return -(int)err;
    regs[2] = attr.numRegs;
    return blocks;
  };
#define GYM_FLASH_OCC(DD)                                                  \
  case DD:                                                                 \
    return bf16 ? occupancy(wg::flash_fwd_wgmma<DD>, wg::Smem<DD>::BYTES)  \
                : occupancy(x3::flash_fwd_tf32x3<DD, 4>, x3::Cfg<DD>::BYTES);
  switch (D) {
    GYM_FLASH_OCC(16)
    GYM_FLASH_OCC(32)
    GYM_FLASH_OCC(64)
    GYM_FLASH_OCC(128)
  }
#undef GYM_FLASH_OCC
  return -(int)cudaErrorInvalidValue;
}

// dynamic shared memory of one forward block: the f32 kernel
// (flash_fwd_tf32x3, bf16 = 0) or the bf16 one (flash_fwd_wgmma, 1); -1
// for an unsupported head dim
long long gym_flash_smem_bytes(int D, int bf16) {
  switch (D) {
#define GYM_FLASH_SMEM(DD)                                          \
  case DD:                                                          \
    return bf16 ? (long long)wg::Smem<DD>::BYTES                    \
                : (long long)x3::Cfg<DD>::BYTES;
    GYM_FLASH_SMEM(16)
    GYM_FLASH_SMEM(32)
    GYM_FLASH_SMEM(64)
    GYM_FLASH_SMEM(128)
#undef GYM_FLASH_SMEM
  }
  return -1;
}

}  // extern "C"
