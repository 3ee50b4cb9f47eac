// T1 bits on its main path: QuantizeCodec's per-tile max-abs quantize with
// threefry stochastic rounding, one launch a compress call over [R, n] rows,
// bit for bit the codec as the JAX package's compiled step runs it.
//
// Replaces XLA's fusion of jax.random.uniform's threefry2x32 into
// QuantizeCodec.compress (gym_tpu/strategy/compress.py:112-126), which
// strategy.step reaches inside the jitted train step (gym_tpu/train_node.py:
// 153,300): DiLoCo's and NoLoCo's per-node links and DynamiQ's two hops. It
// is no pl.pallas_call kernel. The port drew those bits with threefry.cu's
// threefry_kernel, one launch a row key, then ran about a dozen torch passes
// over [R, t, tile] f32 (95-100 bytes of device memory traffic an element);
// here an element costs a 4-byte read and a 1-byte write. threefry_kernel
// stays as it was, the oracle of these bits on the card, and this file keeps
// its own copy of threefry_bits, so a fault here cannot reach the oracle.
//
// Row r of x [R, n] f32 is cut into t = ceil(n / tile) tiles, zero-filled
// past n. A tile's scale is amax * f32(1 / qmax), the multiply XLA compiles
// amax / qmax into, or 1 where amax > 0 fails (a NaN amax too: the max
// propagates NaN, as XLA's reduce does and fmaxf does not); y = x / scale,
// one IEEE division; stochastic rounding floor(y + u), u the uniform of
// threefry2x32(key, c) at the element's flat index in its row, c = tile
// index * tile + j (jax.random.uniform(key, (t, tile)) with partitionable
// threefry), or y rounded half to even; clamped to +-qmax, NaN to 0 (XLA's
// convert), as int8. Each step is an integer operation or one correctly
// rounded IEEE operation (__fmul_rn, __fdiv_rn, __fadd_rn, __fsub_rn,
// floorf, rintf, fminf, fmaxf), so the bits are the compiled step's by
// construction, with no fast math.
//
// Keys: a [R, 2] uint32 table on the card, a key a row (the links' per-node
// keys); or, for a key shared by the rows (DynamiQ's hop keys), its bits
// [t * tile] drawn once by the first kernel and read here by every row.
//
// Bound: integer operations where the bits are drawn (threefry2x32's 73 an
// element against 5 bytes moved), bytes where they are read. The integer
// pipe sets the pace, so the design keeps every lane's chains independent. Fast
// path (tile 256, n % 4 == 0, x 16-byte aligned: the strategies' calls): 16
// lanes a tile, 16 contiguous elements a lane, a warp two (row, tile) items
// a step of a grid-stride loop over one wave of blocks. A lane starts its
// four 16-byte loads, draws its 16 bits while they land (the bits depend on
// no x), takes the tile's max in 4 shuffles within its half warp, and
// stores its 16 int8 as one 16-byte store (a half warp's 256 bytes
// contiguous); the tile's first lane stores the scale. No atomics, no
// shared memory, no block barrier. Any other tile, n or alignment (the
// tests' 7, 32, 64 and 4097): a warp an item, its lanes strided over the
// tile twice, for the max and then the elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFastTile = 256;  // the strategies' tile
constexpr int kPerLane = 16;    // the fast path's elements a lane
constexpr unsigned kFull = 0xFFFFFFFFu;

// how an element of a tile is rounded: half to even, or floor(y + u) with u
// drawn in the lane or read from the first kernel's bits
enum Round { kNearest, kDraw, kRead };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define GYM_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl(x1, r);     \
  x1 ^= x0;

// threefry.cu's threefry_bits: b0 ^ b1 of threefry2x32 (20 rounds) under
// (k0, k1) of the counter (hi, lo)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t hi, uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
  GYM_TF_ROUND(13) GYM_TF_ROUND(15) GYM_TF_ROUND(26) GYM_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  GYM_TF_ROUND(17) GYM_TF_ROUND(29) GYM_TF_ROUND(16) GYM_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  GYM_TF_ROUND(13) GYM_TF_ROUND(15) GYM_TF_ROUND(26) GYM_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  GYM_TF_ROUND(17) GYM_TF_ROUND(29) GYM_TF_ROUND(16) GYM_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  GYM_TF_ROUND(13) GYM_TF_ROUND(15) GYM_TF_ROUND(26) GYM_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef GYM_TF_ROUND

// jax.random.uniform's float of 32 bits: the top 23 as the mantissa of a
// float in [1, 2), minus 1 (exact)
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// the larger of a and b, NaN if either is
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float tile_scale(float amax, float inv_qmax) {
  return amax > 0.0f ? __fmul_rn(amax, inv_qmax) : 1.0f;
}

// x / scale rounded, clamped to +-qmax, NaN to 0
template <Round R>
__device__ __forceinline__ int quantize_one(float x, float scale, float u,
                                            float qmax) {
  const float y = __fdiv_rn(x, scale);
  const float r = R == kNearest ? rintf(y) : floorf(__fadd_rn(y, u));
  if (r != r) return 0;
  return (int)fminf(fmaxf(r, -qmax), qmax);
}

// The fast path: q [items, 256] int8 and scale [items] f32, item = row *
// tiles_per_row + tile; x, bits and q 16-byte aligned and n % 4 == 0, so a
// lane's four groups of 4 lie each wholly before n or wholly past it.
template <Round R>
__global__ void __launch_bounds__(kThreads)
    quantize_tiles_kernel(const float* __restrict__ x, uint64_t n,
                          uint64_t tiles_per_row, uint64_t items,
                          const uint32_t* __restrict__ keys,
                          const uint32_t* __restrict__ bits, float qmax,
                          float inv_qmax, int8_t* __restrict__ q,
                          float* __restrict__ scale) {
  const uint32_t sub = threadIdx.x & 15;  // the lane's place in its tile
  const uint64_t warps = ((uint64_t)gridDim.x * kThreads) >> 5;
  for (uint64_t pair = ((uint64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
       2 * pair < items; pair += warps) {
    // both halves run every step (the shuffles need the whole warp); a
    // half past the last item computes on zeros and stores nothing
    const uint64_t item = 2 * pair + ((threadIdx.x >> 4) & 1);
    const bool live = item < items;
    const uint64_t row = live ? item / tiles_per_row : 0;
    const uint64_t tile = live ? item - row * tiles_per_row : 0;
    // the lane's first element in its row: its x offset and its counter
    const uint64_t at = tile * kFastTile + sub * kPerLane;
    float v[kPerLane];
#pragma unroll
    for (int g = 0; g < kPerLane / 4; ++g) {
      float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (live && at + 4 * g < n)
        f = *reinterpret_cast<const float4*>(x + row * n + at + 4 * g);
      v[4 * g] = f.x;
      v[4 * g + 1] = f.y;
      v[4 * g + 2] = f.z;
      v[4 * g + 3] = f.w;
    }
    uint32_t b[kPerLane];
    if (R == kDraw) {
      const uint32_t* key = keys + 2 * row;
      const uint32_t k0 = key[0], k1 = key[1];
      // at is a multiple of 16: no carry from lo + i into hi
      const uint32_t hi = (uint32_t)(at >> 32), lo = (uint32_t)at;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        b[i] = threefry_bits(k0, k1, hi, lo + i);
    } else if (R == kRead) {
#pragma unroll
      for (int g = 0; g < kPerLane / 4; ++g) {
        const uint4 w = *reinterpret_cast<const uint4*>(bits + at + 4 * g);
        b[4 * g] = w.x;
        b[4 * g + 1] = w.y;
        b[4 * g + 2] = w.z;
        b[4 * g + 3] = w.w;
      }
    }
    float m = fabsf(v[0]);
#pragma unroll
    for (int i = 1; i < kPerLane; ++i) m = nan_max(m, fabsf(v[i]));
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, off));
    const float s = tile_scale(m, inv_qmax);
    uint32_t w[kPerLane / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      w[i >> 2] |= ((uint32_t)quantize_one<R>(
                        v[i], s, R == kNearest ? 0.0f : uniform_of(b[i]),
                        qmax) & 0xFFu)
                   << (8 * (i & 3));
    if (live) {
      *reinterpret_cast<uint4*>(q + item * kFastTile + sub * kPerLane) =
          make_uint4(w[0], w[1], w[2], w[3]);
      if (sub == 0) scale[item] = s;
    }
  }
}

// Any tile >= 1, n and alignment: a warp an item, q [items, tile].
template <Round R>
__global__ void __launch_bounds__(kThreads)
    quantize_tiles_any_kernel(const float* __restrict__ x, uint64_t n,
                              uint32_t tile, uint64_t tiles_per_row,
                              uint64_t items,
                              const uint32_t* __restrict__ keys,
                              const uint32_t* __restrict__ bits, float qmax,
                              float inv_qmax, int8_t* __restrict__ q,
                              float* __restrict__ scale) {
  const uint32_t lane = threadIdx.x & 31;
  const uint64_t warps = ((uint64_t)gridDim.x * kThreads) >> 5;
  for (uint64_t item = ((uint64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
       item < items; item += warps) {
    const uint64_t row = item / tiles_per_row;
    const uint64_t first = (item - row * tiles_per_row) * tile;
    const float* xr = x + row * n;
    float m = 0.0f;
    for (uint32_t j = lane; j < tile; j += 32) {
      const uint64_t c = first + j;
      m = nan_max(m, fabsf(c < n ? xr[c] : 0.0f));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, off));
    const float s = tile_scale(m, inv_qmax);
    uint32_t k0 = 0u, k1 = 0u;
    if (R == kDraw) {
      k0 = keys[2 * row];
      k1 = keys[2 * row + 1];
    }
    for (uint32_t j = lane; j < tile; j += 32) {
      const uint64_t c = first + j;
      float u = 0.0f;
      if (R == kDraw)
        u = uniform_of(threefry_bits(k0, k1, (uint32_t)(c >> 32),
                                     (uint32_t)c));
      else if (R == kRead)
        u = uniform_of(bits[c]);
      q[item * tile + j] =
          (int8_t)quantize_one<R>(c < n ? xr[c] : 0.0f, s, u, qmax);
    }
    if (lane == 0) scale[item] = s;
  }
}

struct Args {
  const float* x;
  uint64_t n, tiles_per_row, items;
  uint32_t tile;
  const uint32_t* keys;
  const uint32_t* bits;
  float qmax, inv_qmax;
  int8_t* q;
  float* scale;
};

// blocks of a grid-stride loop over this many warps' work: at most one
// wave, as many blocks as fit on every SM at once
template <class Kernel>
int grid_for(Kernel kernel, uint64_t warps, unsigned* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const uint64_t most = (uint64_t)sms * (uint64_t)(per_sm > 0 ? per_sm : 1);
  const uint64_t want = (warps + kThreads / 32 - 1) / (kThreads / 32);
  *blocks = (unsigned)(want < most ? want : most);
  return 0;
}

template <Round R>
int launch(const Args& a, bool fast, cudaStream_t stream) {
  unsigned blocks = 0;
  if (fast) {
    if (int err = grid_for(quantize_tiles_kernel<R>, (a.items + 1) / 2,
                           &blocks))
      return err;
    quantize_tiles_kernel<R><<<blocks, kThreads, 0, stream>>>(
        a.x, a.n, a.tiles_per_row, a.items, a.keys, a.bits, a.qmax,
        a.inv_qmax, a.q, a.scale);
  } else {
    if (int err = grid_for(quantize_tiles_any_kernel<R>, a.items, &blocks))
      return err;
    quantize_tiles_any_kernel<R><<<blocks, kThreads, 0, stream>>>(
        a.x, a.n, a.tile, a.tiles_per_row, a.items, a.keys, a.bits, a.qmax,
        a.inv_qmax, a.q, a.scale);
  }
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// q [R, t, tile] int8 and scale [R, t] f32 of x [R, n] f32 (contiguous),
// t = ceil(n / tile): stochastic with the keys table [R, 2] uint32, a key a
// row, or with bits [t * tile] uint32, a shared key's bits (keys then null),
// or rounded to nearest (stochastic 0); qmax 127 or 7 and inv_qmax =
// f32(1 / qmax).
int gym_quantize_tiles(const void* x, long long n, int rows, int tile,
                       const void* keys, const void* bits, int stochastic,
                       float qmax, float inv_qmax, void* q, void* scale,
                       void* stream) {
  if (n < 0 || rows < 0 || tile < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.n = (uint64_t)n;
  a.tile = (uint32_t)tile;
  a.tiles_per_row = (a.n + a.tile - 1) / a.tile;
  a.items = (uint64_t)rows * a.tiles_per_row;
  if (a.items == 0) return 0;
  if (x == nullptr || q == nullptr || scale == nullptr ||
      (stochastic && (keys == nullptr) == (bits == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.x = static_cast<const float*>(x);
  a.keys = static_cast<const uint32_t*>(keys);
  a.bits = static_cast<const uint32_t*>(bits);
  a.qmax = qmax;
  a.inv_qmax = inv_qmax;
  a.q = static_cast<int8_t*>(q);
  a.scale = static_cast<float*>(scale);
  const bool fast = tile == kFastTile && a.n % 4 == 0 && aligned16(x) &&
                    aligned16(q) && (bits == nullptr || aligned16(bits));
  cudaStream_t s = (cudaStream_t)stream;
  if (!stochastic) return launch<kNearest>(a, fast, s);
  if (bits != nullptr) return launch<kRead>(a, fast, s);
  return launch<kDraw>(a, fast, s);
}

}  // extern "C"
