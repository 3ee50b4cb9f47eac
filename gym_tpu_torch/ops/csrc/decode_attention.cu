// B7: the serving path's decode attention on Hopper, f32, paged or not.
//
// Replaces XLA's einsum-mask-softmax-einsum of the KV-cache attends in
// gym_tpu/models/nanogpt.py: _decode_attend (:370-383) and
// _decode_attend_paged (:478-492). Neither is a pl.pallas_call kernel; in
// eager PyTorch the same code would gather a whole [b, S, H, hd] window of
// the page pool for every layer and step, whatever each row's cursor is.
//
// Inputs: q [b, t, H, hd] (rows and tokens strided, heads and head dims
// contiguous, as a view of the qkv projection gives them); the K and V pools
// [P, page, H, hd]; a block table [b, nblk] of physical page ids; the cursors
// [b]. Query j of row r sits at logical position cursor[r] + j and attends to
// the logical positions 0 .. min(cursor[r] + j, S - 1), S = nblk * page:
// position p lives in page table[r][p / page] at offset p % page. The
// per-row cache of the unpaged path is the same thing: b pages of size S,
// row r's table [r].
//
// The contract that keeps the serving engine's token streams equal (one
// slot alone and among 16, a prompt and its padded bucket, one position and
// a verify chunk, paged and unpaged): a query's result depends only on its
// q, its position and the K and V at its logical positions. Its arithmetic
// is fixed by its logical positions alone: keys in chunks of 32 aligned at
// position 0, one key a lane; chunk c in logical partition c % W of W (4; 2
// at hd 128); each score a sequential FMA chain over the head dims, divided
// by scale_div; each partition's online softmax over its chunks in order,
// with an exact chunk maximum and an xor-butterfly chunk sum (every lane
// gets the same bits), and each output element a sequential FMA chain over
// a chunk's keys in position order; the W partial results combined in
// partition order. Nothing depends on t, the batch, the page size, the page
// ids or the path below, and keys past the query's last position are never
// read. No atomics.
//
// Bound: bytes. A decode step of GPT-2 base at 16 slots reads each row's K
// and V once a head (16 rows x ~300 positions x 12 heads x 64 x 4 B x 2,
// ~29.5 MB, ~8.8 us at 3.35 TB/s); a 512-token prefill, the FMAs of its
// (query, key) pairs (67 TFLOP/s of f32 FMAs).
//
// The kernel (decode_attention_kernel), one launch a call, two paths picked
// by t alone (choose_path; scripts/b7_sweep.py set the threshold and the
// tile's size):
//  - decode (t <= 2: a decode step): one block a (row, head, query), W
//    warps, warp w the partition w;
//  - tile (t > 2: a verify chunk, a prefill): one block a (row, head, tile
//    of 16 consecutive queries), 4 warps a partition, each owning 4 of the
//    tile's queries (query g + 4 * i of warp g), their (m, l, o) in its
//    registers; a chunk staged once serves every query of the tile whose
//    last position reaches it, each query's scores of a staged key one
//    lane's chains side by side, its PV chain stopping at its own key
//    count (a query's keys past its last are -inf scores and are never
//    weighed: 0 * NaN is NaN, and -0.0 + 0 * v is +0.0).
// Both run the same code: the block walks rounds of W chunks (partition w
// takes chunk k * W + w of round k) through a ring of shared-memory stages
// filled by cp.async (16-byte copies of a key's head vector where the pools
// are 16-byte aligned, else 4-byte ones): in the decode path, whose warps
// run apart (a warp barrier a round), 3 stages over f32 pools, so rounds
// k + 1 and k + 2 are in flight while round k's chains run, and 2 over
// int8 pools; 2 in a tile, whose warps share the stages (a block barrier
// a round). A round's page-table
// lookups are made as it is issued, one a lane, and shuffled to the lanes
// that copy. K and
// V rows are staged with a pitch of hd + 4 floats: a lane (a key) reads its
// K row as float4s of 4 head dims, conflict-free, and the score chain still
// runs d = 0 .. hd - 1; the PV chain reads V from shared memory. Copies
// past a round's last key are not issued. FMA contraction is written out
// (fmaf) where the oracle's compiled code fuses, and expf and the IEEE
// divisions stay, so a query's bits are the oracle's.
//
// The oracle (decode_attention_ref_kernel): B7 as first written (one block
// a query, each warp staging its chunk's K a key at a time, V read from
// global memory inside the PV chain), whose bits the served path has
// always had. It is not on the serving path: the card checks hold every
// path to it bit for bit (gym_decode_attention_ref,
// gym_decode_attention_int8_ref).

// B7 int8: the same attention over an int8 KV pool [P, page, H, hd] with one
// f32 scale per (position, head), [P, page, H] (a quantized serving
// config's kv_dtype="int8": gym_tpu/ops/fused_attention.py kv_quantize
// :390 on write and kv_dequantize :401 on the gathered window, in
// gym_tpu/models/nanogpt.py :348-362 unpaged and :445-465 paged; no
// pl.pallas_call kernel). Its contract: bit for bit B7 on the
// kv_dequantize'd pools. Each element is dequantized once as
// __fmul_rn((float)q, scale[position, head]), one rounding, JAX's
// q.astype(f32) * scale, never contracted into a chain's FMA. The kernel
// stages the raw int8 rows and their scales in its ring (a quarter of the
// bytes), then one pass a round turns them into f32 K and V tiles, and the
// chains run B7's f32 code on them; the oracle dequantizes each K element
// as it stages it and each V element where its PV chain reads it. A NaN
// scale makes its position's scores or values NaN, and so the query's
// output (the serving engine's quarantine reads it). Bound: bytes, a
// quarter of the f32 window's plus the scales.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 32;  // keys a step: one a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m; m >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

// the xor butterfly: lane i adds lane i^m's value, and a + b == b + a, so
// every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// The pools' element d of the head vector at offset o (the position's and
// head's first element, o = (position * H + head) * hd): f32 as stored, or
// int8 times the (position, head) scale at o / hd.
struct F32KV {
  const float* k;
  const float* v;
  __device__ __forceinline__ float key(long long o, int d) const {
    return k[o + d];
  }
  __device__ __forceinline__ float val(long long o, int d) const {
    return v[o + d];
  }
};

template <int HD>
struct Int8KV {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  __device__ __forceinline__ float key(long long o, int d) const {
    return __fmul_rn((float)k[o + d], ks[o / HD]);
  }
  __device__ __forceinline__ float val(long long o, int d) const {
    return __fmul_rn((float)v[o + d], vs[o / HD]);
  }
};

// -- the oracle: B7 as first written ----------------------------------------

template <int HD, int WARPS, class KV>
__global__ void __launch_bounds__(WARPS * 32)
    decode_attention_ref_kernel(const float* __restrict__ q, long long q_sb,
                                long long q_st, KV kv,
                                const int* __restrict__ table, int nblk,
                                int page, const int* __restrict__ cursor,
                                int t, int H, float scale_div,
                                float* __restrict__ out) {
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;  // head dims a lane
  __shared__ float ks[WARPS][kChunk][HD + 1];
  __shared__ float qs[HD];
  __shared__ float ps[WARPS][kChunk];
  __shared__ long long offs[WARPS][kChunk];
  __shared__ float part_m[WARPS], part_l[WARPS];
  __shared__ float part_o[WARPS][HD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int S = nblk * page;
  const int last = min(cursor[r] + j, S - 1);
  const float* qrow = q + r * q_sb + j * q_st + h * HD;
  for (int d = threadIdx.x; d < HD; d += WARPS * 32) qs[d] = qrow[d];
  const int* tab = table + (long long)r * nblk;
  const long long pos_stride = (long long)H * HD;  // floats a position
  float m = -INFINITY, l = 0.f;
  float o[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = 0.f;
  __syncthreads();
  for (int c0 = warp * kChunk; c0 <= last; c0 += WARPS * kChunk) {
    const int nk = min(kChunk, last - c0 + 1);
    if (lane < nk) {
      const int p = c0 + lane;
      offs[warp][lane] =
          ((long long)tab[p / page] * page + p % page) * pos_stride + h * HD;
    }
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < nk; ++key) {
      const long long o = offs[warp][key];
#pragma unroll
      for (int d = lane; d < HD; d += 32) ks[warp][key][d] = kv.key(o, d);
    }
    __syncwarp();
    float s = -INFINITY;
    if (lane < nk) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qs[d], ks[warp][lane][d], acc);
      s = acc / scale_div;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);  // 0 at the warp's first chunk
    const float p = lane < nk ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    ps[warp][lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        float acc = 0.f;
#pragma unroll 4
        for (int key = 0; key < nk; ++key)
          acc = fmaf(ps[warp][key], kv.val(offs[warp][key], d), acc);
        o[i] = o[i] * alpha + acc;
      }
    }
    m = m_new;
    __syncwarp();
  }
  // the warps' partial results, combined in warp order (a warp with no
  // chunk holds m = -inf, l = 0, o = 0 and weighs exp(-inf) = 0)
  if (lane == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) part_o[warp][d] = o[i];
  }
  __syncthreads();
  if (warp != 0) return;
  float mx = part_m[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, part_m[w]);
  float wt[WARPS], lt = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = expf(part_m[w] - mx);
    lt = fmaf(part_l[w], wt[w], lt);
  }
  float* orow = out + (((long long)r * t + j) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc = fmaf(part_o[w][d], wt[w], acc);
      orow[d] = acc / lt;
    }
  }
}

template <int HD, int WARPS, class KV>
int launch_ref(const float* q, long long q_sb, long long q_st, KV kv,
               const int* table, int nblk, int page, const int* cursor, int b,
               int t, int H, float scale_div, float* out,
               cudaStream_t stream) {
  const dim3 grid(t, H, b);
  decode_attention_ref_kernel<HD, WARPS, KV>
      <<<grid, WARPS * 32, 0, stream>>>(q, q_sb, q_st, kv, table, nblk, page,
                                        cursor, t, H, scale_div, out);
  return (int)cudaGetLastError();
}

// -- the kernel --------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// how the pools' rows are copied: 16-byte cp.async (the pools 16-byte
// aligned), 4-byte cp.async, or (int8 pools not 4-byte aligned) plain loads
// and stores
enum CopyMode { kCopy16 = 0, kCopy4 = 1, kCopySync = 2 };

// the pools as the kernel stages them
struct F32Pools {
  const float* k;
  const float* v;
};

struct Int8Pools {
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
};

// One chunk's nk keys into the K and V stages kd, vd (rows of PITCH
// elements): key k's head vector from position pos of lane k (shuffled to
// the lanes that copy it), in copies of CH elements spread over the
// partition's G warps; cp.async of 16 or 4 bytes, or plain loads and stores
template <int HD, int PITCH, int CH, int G, class T>
__device__ __forceinline__ void stage_chunk(T* kd, T* vd, const T* k,
                                            const T* v, long long pos, int nk,
                                            long long pos_stride,
                                            long long hoff, int g, int lane) {
  constexpr int PER_KEY = HD / CH, N = kChunk * PER_KEY;
  constexpr int BYTES = CH * (int)sizeof(T);
#pragma unroll 4
  for (int base = g * 32; base < N; base += G * 32) {
    const int i = base + lane, key = i / PER_KEY, c = (i % PER_KEY) * CH;
    const long long kp = __shfl_sync(kFull, pos, key & 31);
    if (i < N && key < nk) {
      const long long o = kp * pos_stride + hoff + c;
      if constexpr (BYTES == 16) {
        cp_async16(kd + key * PITCH + c, k + o);
        cp_async16(vd + key * PITCH + c, v + o);
      } else if constexpr (BYTES == 4) {
        cp_async4(kd + key * PITCH + c, k + o);
        cp_async4(vd + key * PITCH + c, v + o);
      } else {
        kd[key * PITCH + c] = k[o];
        vd[key * PITCH + c] = v[o];
      }
    }
  }
}

// A block's shared memory: the f32 K and V tiles (f32 pools: a ring of
// STAGES stages of K and V, W chunks each; int8 pools: one K and one V
// tile, W chunks each, behind a ring of STAGES stages of the raw int8 rows
// and their scales), the tile's queries and each warp's probabilities.
// After the last round the f32 tiles hold the partitions' partial results.
// The decode path over f32 pools (a warp a partition, nothing shared
// between warps until the combination) keeps 3 stages, two rounds in
// flight; over int8 pools 2, so that two of its blocks fit an SM (faster
// on the H100: scripts/b7_sweep.py); a tile, 2.
template <int HD, int W, int QW, int G, class P>
struct Layout {
  static constexpr bool kQ8 = std::is_same<P, Int8Pools>::value;
  static constexpr int KP = HD + 4;  // a staged row's pitch: float4s, odd
  static constexpr int QT = QW * G, WARPS = W * G, THREADS = WARPS * 32;
  static constexpr int STAGES = G == 1 && !kQ8 ? 3 : 2;
  static constexpr size_t TILE = sizeof(float) * W * kChunk * KP;
  static constexpr size_t F32 = (kQ8 ? 2 : 2 * STAGES) * TILE;
  static constexpr size_t RAW =
      kQ8 ? (size_t)STAGES * 2 * W * kChunk * HD : 0;
  static constexpr size_t SCALES =
      kQ8 ? sizeof(float) * STAGES * 2 * W * kChunk : 0;
  static constexpr size_t QS = sizeof(float) * QT * HD;
  static constexpr size_t PS = sizeof(float) * WARPS * QW * kChunk;
  static constexpr size_t BYTES = F32 + RAW + SCALES + QS + PS;
  static_assert(HD % 16 == 0 && (KP / 4) % 2 == 1, "layout");
  static_assert(sizeof(float) * W * QT * (HD + 2) <= F32, "partials");
  static_assert(BYTES <= 232448, "shared memory");
};

// One block: the queries j0 .. j0 + QT - 1 (those below t) of row
// blockIdx.z, head blockIdx.y, j0 = blockIdx.x * QT. Warp w * G + g is
// partition w's g-th warp and owns the tile's queries g, g + G, ...,
// g + (QW - 1) * G.
template <int HD, int W, int QW, int G, class P>
__global__ void __launch_bounds__(W * G * 32, 1)
    decode_attention_kernel(const float* __restrict__ q, long long q_sb,
                            long long q_st, P pools,
                            const int* __restrict__ table, int nblk,
                            int page, const int* __restrict__ cursor, int t,
                            int H, float scale_div, float* __restrict__ out,
                            int mode) {
  using L = Layout<HD, W, QW, G, P>;
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;  // head dims a lane
  constexpr int KP = L::KP, QT = L::QT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* f32s = reinterpret_cast<float*>(smem);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + L::F32);
  float* scs = reinterpret_cast<float*>(smem + L::F32 + L::RAW);
  float* qs = reinterpret_cast<float*>(smem + L::F32 + L::RAW + L::SCALES);
  float* ps = qs + QT * HD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = warp / G, g = warp % G;
  const int j0 = blockIdx.x * QT, h = blockIdx.y, r = blockIdx.z;
  const int S = nblk * page;
  const int cur = cursor[r];
  // the tile's last position, and its rounds of W chunks
  const int last_max = min(cur + min(j0 + QT, t) - 1, S - 1);
  const int rounds = (last_max / kChunk) / W + 1;
  const int* tab = table + (long long)r * nblk;
  const long long pos_stride = (long long)H * HD;  // elements a position
  const long long hoff = (long long)h * HD;

  for (int i = threadIdx.x; i < QT * HD; i += L::THREADS) {
    const int j = j0 + i / HD;
    qs[i] = j < t ? q[r * q_sb + j * q_st + h * HD + i % HD] : 0.f;
  }

  // round kr's chunk of this warp's partition into stage slot: a lane's
  // key looked up, its position shuffled to the lanes that copy its pieces
  // (each warp of the partition a share); keys past the tile's last
  // position are not copied
  auto issue = [&](int kr, int slot) {
    const int c0 = (kr * W + part) * kChunk;
    if (kr >= rounds || c0 > last_max) return;  // the partition's warps
    const int nk = min(kChunk, last_max - c0 + 1);
    long long pos = 0;
    if (lane < nk) {
      const int p = c0 + lane;
      pos = (long long)tab[p / page] * page + p % page;
    }
    if constexpr (!L::kQ8) {
      float* kd = f32s + ((size_t)(slot * 2) * W + part) * kChunk * KP;
      float* vd = kd + (size_t)W * kChunk * KP;
      if (mode == kCopy16)
        stage_chunk<HD, KP, 4, G>(kd, vd, pools.k, pools.v, pos, nk,
                                  pos_stride, hoff, g, lane);
      else
        stage_chunk<HD, KP, 1, G>(kd, vd, pools.k, pools.v, pos, nk,
                                  pos_stride, hoff, g, lane);
    } else {
      int8_t* kd = raw + ((size_t)(slot * 2) * W + part) * kChunk * HD;
      int8_t* vd = kd + (size_t)W * kChunk * HD;
      if (mode == kCopy16)
        stage_chunk<HD, HD, 16, G>(kd, vd, pools.k, pools.v, pos, nk,
                                   pos_stride, hoff, g, lane);
      else if (mode == kCopy4)
        stage_chunk<HD, HD, 4, G>(kd, vd, pools.k, pools.v, pos, nk,
                                  pos_stride, hoff, g, lane);
      else
        stage_chunk<HD, HD, 1, G>(kd, vd, pools.k, pools.v, pos, nk,
                                  pos_stride, hoff, g, lane);
      if (g == 0 && lane < nk) {
        float* ksd = scs + ((size_t)(slot * 2) * W + part) * kChunk;
        cp_async4(ksd + lane, pools.ks + pos * H + h);
        cp_async4(ksd + W * kChunk + lane, pools.vs + pos * H + h);
      }
    }
  };

  // int8: the landed stage of round kr into the f32 K and V tiles, each
  // element once, __fmul_rn((float)q, its position's scale)
  auto dequant = [&](int kr, int slot) {
    const int c0 = (kr * W + part) * kChunk;
    if (c0 > last_max) return;
    const int nk = min(kChunk, last_max - c0 + 1);
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      const int8_t* src =
          raw + ((size_t)(slot * 2 + kv) * W + part) * kChunk * HD;
      const float* sc = scs + ((size_t)(slot * 2 + kv) * W + part) * kChunk;
      float* dst = f32s + ((size_t)kv * W + part) * kChunk * KP;
      for (int i = g * 32 + lane; i < nk * (HD / 4); i += G * 32) {
        const int key = i / (HD / 4), c = (i % (HD / 4)) * 4;
        const char4 v = *reinterpret_cast<const char4*>(src + key * HD + c);
        const float s = sc[key];
        *reinterpret_cast<float4*>(dst + key * KP + c) =
            make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                        __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
      }
    }
  };

  float m[QW], l[QW], o[QW][DPL];
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    m[qi] = -INFINITY;
    l[qi] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[qi][i] = 0.f;
  }
  float* pw = ps + warp * QW * kChunk;  // this warp's probabilities

  // round kr's chains over the K and V tiles kt, vt: the oracle's
  // arithmetic, a query at a time for the softmax, side by side for the
  // score and PV chains
  auto chains = [&](int kr, const float* kt, const float* vt) {
    const int c0 = (kr * W + part) * kChunk;
    if (c0 > last_max) return;
    int nkq[QW];  // each query's keys in the chunk; 0 past its last
    int nk_all = 0;
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      const int j = j0 + g + qi * G;
      const int last = min(cur + j, S - 1);
      nkq[qi] = j < t && c0 <= last ? min(kChunk, last - c0 + 1) : 0;
      nk_all = max(nk_all, nkq[qi]);
    }
    float acc[QW];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) acc[qi] = 0.f;
    const float* krow = kt + lane * KP;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        const float4 q4 =
            *reinterpret_cast<const float4*>(qs + (g + qi * G) * HD + d);
        acc[qi] = fmaf(q4.x, k4.x, acc[qi]);
        acc[qi] = fmaf(q4.y, k4.y, acc[qi]);
        acc[qi] = fmaf(q4.z, k4.z, acc[qi]);
        acc[qi] = fmaf(q4.w, k4.w, acc[qi]);
      }
    }
    float alpha[QW];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi) {
      alpha[qi] = 1.f;
      if (nkq[qi] == 0) continue;  // the warp's: nkq is uniform
      const float s = lane < nkq[qi] ? acc[qi] / scale_div : -INFINITY;
      const float m_new = fmaxf(m[qi], warp_max(s));
      alpha[qi] = expf(m[qi] - m_new);  // 0 at the partition's first chunk
      const float p = lane < nkq[qi] ? expf(s - m_new) : 0.f;
      l[qi] = fmaf(l[qi], alpha[qi], warp_sum(p));
      pw[qi * kChunk + lane] = p;
      m[qi] = m_new;
    }
    __syncwarp();
    // each output element's chain over the keys in order; a lane's DPL
    // elements and the warp's queries side by side
    float pv[QW][DPL];
#pragma unroll
    for (int qi = 0; qi < QW; ++qi)
#pragma unroll
      for (int i = 0; i < DPL; ++i) pv[qi][i] = 0.f;
#pragma unroll 4
    for (int key = 0; key < nk_all; ++key) {
      float v[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        v[i] = lane + 32 * i < HD ? vt[key * KP + lane + 32 * i] : 0.f;
#pragma unroll
      for (int qi = 0; qi < QW; ++qi) {
        if (key < nkq[qi]) {
          const float p = pw[qi * kChunk + key];
#pragma unroll
          for (int i = 0; i < DPL; ++i) pv[qi][i] = fmaf(p, v[i], pv[qi][i]);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < QW; ++qi)
      if (nkq[qi])
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          o[qi][i] = fmaf(o[qi][i], alpha[qi], pv[qi][i]);
    __syncwarp();
  };

  // a warp's partition is its own until the combination when it is the
  // partition's only warp (decode): a warp barrier then, else the block's
  auto sync = [&]() {
    if constexpr (G == 1)
      __syncwarp();
    else
      __syncthreads();
  };
  constexpr int NS = L::STAGES;
  __syncthreads();  // the queries are staged
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    issue(st, st);
    cp_async_commit();
  }
  for (int k = 0; k < rounds; ++k) {
    cp_async_wait<NS - 2>();  // round k has landed (this thread's copies)
    sync();                  // ... everyone's; round k - 1 is read
    issue(k + NS - 1, (k + NS - 1) % NS);  // into round k - 1's stage
    cp_async_commit();
    const float* kt;
    if constexpr (L::kQ8) {
      dequant(k, k % NS);
      sync();                // the f32 tiles are whole
      kt = f32s + (size_t)part * kChunk * KP;
    } else {
      kt = f32s + ((size_t)((k % NS) * 2) * W + part) * kChunk * KP;
    }
    chains(k, kt, kt + (size_t)W * kChunk * KP);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the partitions' partial results, combined in partition order per query
  // (a partition with no chunk holds m = -inf, l = 0, o = 0 and weighs
  // exp(-inf) = 0)
  float* part_m = f32s;
  float* part_l = part_m + W * QT;
  float* part_o = part_l + W * QT;
#pragma unroll
  for (int qi = 0; qi < QW; ++qi) {
    const int ql = g + qi * G;
    if (lane == 0) {
      part_m[part * QT + ql] = m[qi];
      part_l[part * QT + ql] = l[qi];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) part_o[(part * QT + ql) * HD + d] = o[qi][i];
    }
  }
  __syncthreads();
  for (int ql = warp; ql < QT; ql += L::WARPS) {
    const int j = j0 + ql;
    if (j >= t) break;
    float mx = part_m[ql];
#pragma unroll
    for (int w = 1; w < W; ++w) mx = fmaxf(mx, part_m[w * QT + ql]);
    float wt[W], lt = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      wt[w] = expf(part_m[w * QT + ql] - mx);
      lt = fmaf(part_l[w * QT + ql], wt[w], lt);
    }
    float* orow = out + (((long long)r * t + j) * H + h) * HD;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w)
          acc = fmaf(part_o[(w * QT + ql) * HD + d], wt[w], acc);
        orow[d] = acc / lt;
      }
    }
  }
}

template <int HD, int W, int QW, int G, class P>
int launch(const float* q, long long q_sb, long long q_st, P pools,
           const int* table, int nblk, int page, const int* cursor, int b,
           int t, int H, float scale_div, float* out, int mode,
           cudaStream_t stream) {
  using L = Layout<HD, W, QW, G, P>;
  auto kernel = decode_attention_kernel<HD, W, QW, G, P>;
  // above 48 KB only once the attribute is set, on each device: the first
  // (eager) call of a program sets it, before any capture
  static bool attr_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (L::BYTES > 48 * 1024 && dev < 64 && !attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  const dim3 grid((t + L::QT - 1) / L::QT, H, b);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(q, q_sb, q_st, pools, table,
                                                 nblk, page, cursor, t, H,
                                                 scale_div, out, mode);
  return (int)cudaGetLastError();
}

// the paths (gym_decode_attention's ``path``): a block a query, or a tile
// of 16 queries, 4 warps a partition and 4 queries a warp
enum Path { kDecode = 0, kTile16, kPaths };

// The path of a call, by t alone, from scripts/b7_sweep.py on the H100: a
// block a query up to t = 2 (at decode's 16 rows and t = 1 about 1.5x
// faster than a tile of 16; about even at t = 2), a tile of 16 above
// (faster than a block a query at every verify chunk and prefill of t >= 3
// at 16 rows and t >= 16 at one). A tile of 32 queries (8 a warp), swept
// too, was slower than the tile of 16 at every t up to 512 and at most 8%
// faster above (PERF.md), so it is not built.
constexpr int kDecodeMaxT = 2;

int choose_path(int t) { return t <= kDecodeMaxT ? kDecode : kTile16; }

template <int HD, int W, class P>
int dispatch(const float* q, long long q_sb, long long q_st, P pools,
             const int* table, int nblk, int page, const int* cursor, int b,
             int t, int H, float scale_div, float* out, int mode, int path,
             cudaStream_t s) {
  if (path < 0) path = choose_path(t);
  switch (path) {
    case kDecode:
      return launch<HD, W, 1, 1>(q, q_sb, q_st, pools, table, nblk, page,
                                 cursor, b, t, H, scale_div, out, mode, s);
    case kTile16:
      return launch<HD, W, 4, 4>(q, q_sb, q_st, pools, table, nblk, page,
                                 cursor, b, t, H, scale_div, out, mode, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The pools' element type, head dim and path: one of the dispatch's
// instances (W = 4 partitions, 2 at hd 128, as the oracle's warps).
template <class P>
int dispatch_hd(const float* q, long long q_sb, long long q_st, P pools,
                const int* table, int nblk, int page, const int* cursor,
                int b, int t, int H, int hd, float scale_div, float* out,
                int mode, int path, cudaStream_t s) {
  switch (hd) {
    case 16:
      return dispatch<16, 4>(q, q_sb, q_st, pools, table, nblk, page, cursor,
                             b, t, H, scale_div, out, mode, path, s);
    case 32:
      return dispatch<32, 4>(q, q_sb, q_st, pools, table, nblk, page, cursor,
                             b, t, H, scale_div, out, mode, path, s);
    case 64:
      return dispatch<64, 4>(q, q_sb, q_st, pools, table, nblk, page, cursor,
                             b, t, H, scale_div, out, mode, path, s);
    case 128:
      return dispatch<128, 2>(q, q_sb, q_st, pools, table, nblk, page,
                              cursor, b, t, H, scale_div, out, mode, path, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int mode_of(const void* k, const void* v) {
  const uintptr_t a = (uintptr_t)k | (uintptr_t)v;
  return (a & 15) == 0 ? kCopy16 : (a & 3) == 0 ? kCopy4 : kCopySync;
}

bool bad_shape(int b, int t, int H, int nblk, int page) {
  return b <= 0 || t <= 0 || H <= 0 || nblk <= 0 || page <= 0 ||
         b > 65535 || H > 65535 || (long long)nblk * page > 2147483647LL;
}

}  // namespace

extern "C" {

// out [b, t, H, hd] contiguous = attention of q over the K and V pools
// [P, page, H, hd] (contiguous) through table [b, nblk] and cursor [b]
// (int32); q's element (r, j, h, d) at q[r * q_sb + j * q_st + h * hd + d].
// Scores are q.k / scale_div. path: -1 for the dispatch's choice, else one
// of enum Path (a sweep's); every path gives the same bits.
int gym_decode_attention(const void* q, long long q_sb, long long q_st,
                         const void* k_pool, const void* v_pool,
                         const void* table, int nblk, int page,
                         const void* cursor, int b, int t, int H, int hd,
                         float scale_div, void* out, int path, void* stream) {
  if (bad_shape(b, t, H, nblk, page)) return (int)cudaErrorInvalidValue;
  return dispatch_hd(static_cast<const float*>(q), q_sb, q_st,
                     F32Pools{static_cast<const float*>(k_pool),
                              static_cast<const float*>(v_pool)},
                     static_cast<const int*>(table), nblk, page,
                     static_cast<const int*>(cursor), b, t, H, hd, scale_div,
                     static_cast<float*>(out), mode_of(k_pool, v_pool), path,
                     (cudaStream_t)stream);
}

// B7 int8: as gym_decode_attention over int8 pools [P, page, H, hd] with
// f32 scale pools [P, page, H] (all contiguous).
int gym_decode_attention_int8(const void* q, long long q_sb, long long q_st,
                              const void* k_pool, const void* v_pool,
                              const void* k_scale, const void* v_scale,
                              const void* table, int nblk, int page,
                              const void* cursor, int b, int t, int H,
                              int hd, float scale_div, void* out, int path,
                              void* stream) {
  if (bad_shape(b, t, H, nblk, page)) return (int)cudaErrorInvalidValue;
  return dispatch_hd(static_cast<const float*>(q), q_sb, q_st,
                     Int8Pools{static_cast<const int8_t*>(k_pool),
                               static_cast<const int8_t*>(v_pool),
                               static_cast<const float*>(k_scale),
                               static_cast<const float*>(v_scale)},
                     static_cast<const int*>(table), nblk, page,
                     static_cast<const int*>(cursor), b, t, H, hd, scale_div,
                     static_cast<float*>(out), mode_of(k_pool, v_pool), path,
                     (cudaStream_t)stream);
}

// The path gym_decode_attention and its int8 form pick for t (enum Path).
int gym_decode_attention_path(int t) { return choose_path(t); }

// The oracle: gym_decode_attention's arguments without path.
int gym_decode_attention_ref(const void* q, long long q_sb, long long q_st,
                             const void* k_pool, const void* v_pool,
                             const void* table, int nblk, int page,
                             const void* cursor, int b, int t, int H, int hd,
                             float scale_div, void* out, void* stream) {
  if (bad_shape(b, t, H, nblk, page)) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const F32KV kv{static_cast<const float*>(k_pool),
                 static_cast<const float*>(v_pool)};
  const int* tb = static_cast<const int*>(table);
  const int* cu = static_cast<const int*>(cursor);
  float* of = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch_ref<16, 4>(qf, q_sb, q_st, kv, tb, nblk, page, cu, b, t,
                               H, scale_div, of, s);
    case 32:
      return launch_ref<32, 4>(qf, q_sb, q_st, kv, tb, nblk, page, cu, b, t,
                               H, scale_div, of, s);
    case 64:
      return launch_ref<64, 4>(qf, q_sb, q_st, kv, tb, nblk, page, cu, b, t,
                               H, scale_div, of, s);
    case 128:
      return launch_ref<128, 2>(qf, q_sb, q_st, kv, tb, nblk, page, cu, b,
                                t, H, scale_div, of, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The int8 oracle: gym_decode_attention_int8's arguments without path.
int gym_decode_attention_int8_ref(const void* q, long long q_sb,
                                  long long q_st, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  int nblk, int page, const void* cursor,
                                  int b, int t, int H, int hd,
                                  float scale_div, void* out, void* stream) {
  if (bad_shape(b, t, H, nblk, page)) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const int8_t* kq = static_cast<const int8_t*>(k_pool);
  const int8_t* vq = static_cast<const int8_t*>(v_pool);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* cu = static_cast<const int*>(cursor);
  float* of = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch_ref<16, 4>(qf, q_sb, q_st, Int8KV<16>{kq, vq, ks, vs},
                               tb, nblk, page, cu, b, t, H, scale_div, of, s);
    case 32:
      return launch_ref<32, 4>(qf, q_sb, q_st, Int8KV<32>{kq, vq, ks, vs},
                               tb, nblk, page, cu, b, t, H, scale_div, of, s);
    case 64:
      return launch_ref<64, 4>(qf, q_sb, q_st, Int8KV<64>{kq, vq, ks, vs},
                               tb, nblk, page, cu, b, t, H, scale_div, of, s);
    case 128:
      return launch_ref<128, 2>(qf, q_sb, q_st, Int8KV<128>{kq, vq, ks, vs},
                                tb, nblk, page, cu, b, t, H, scale_div, of,
                                s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
