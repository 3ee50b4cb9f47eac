// JAX's threefry2x32 PRNG on Hopper: random bits and fused Bernoulli masks,
// bit for bit equal to jax.random.bits / jax.random.bernoulli (jax 0.9.0,
// jax_threefry_partitionable on).
//
// Replaces XLA's threefry2x32 lowering, which the JAX package reaches through
// jax.random in gym_tpu/strategy/sparta.py:41-60,73,95-96 (SPARTA's masks);
// it is not a pl.pallas_call kernel. Element i is b0 ^ b1 of
// threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)) over the flat index; the mask
// is (bitcast_f32((bits >> 9) | 0x3F800000) - 1) < p.
//
// Bound: integer operations. An element costs 20 rounds of add, rotate and
// xor, six key injections and the final xor (73 int32 operations), plus a
// shift and a compare for the mask, and writes 1 byte (mask) or 4 (bits), so
// even at the dispatch limit of 128 lanes a clock an SM the instructions take
// ~7x longer than HBM. The design keeps the ALUs busy: each thread generates 4
// consecutive elements per grid-stride step (4 independent dependency
// chains) and stores them with one 4-byte (mask) or 16-byte (bits) store;
// rotations are single funnel shifts. The 64-bit flat index is split into
// hi and lo words, and a group that runs past its end stores element by
// element, so no store passes it.
//
// Masks are drawn for a table of segments in one launch
// (gym_bernoulli_segments): segment s has its own key, length and place in
// the output, and its element i is exactly element i of a mask drawn under
// its key alone. One launch serves one mask (one segment), flax nn.Dropout's
// masks of one layer for every simulated node (gym_tpu/models/
// mnist_cnn.py:36,45 and the nanoGPT dropouts: R segments of n, a dense
// [R, n]), and all of a SPARTA step's masks (one segment a leaf, keyed by
// the leaf and the iteration): most leaves are too small to fill the card
// alone, and 148 launches a step fill the card's launch queue. The blocks
// split the concatenated 4-element groups of all the segments into
// contiguous ranges; a block finds a group's segment by binary search over
// the segments' first groups, from a copy of the table in shared memory.
// A group stores one 4-byte word where it is whole and 4-byte aligned,
// byte by byte otherwise.
//
// The serving path's sampler (jax.random.categorical's gumbel noise,
// gym_tpu/models/nanogpt.py:905) draws R rows of bits in one launch
// (gym_threefry_bits_rows): row r under fold_in(keys[r], data[r]), the keys
// and the slots' step indices read on the card, so a decode chunk needs no
// host read for its keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
// segments a launch: their table fills at most 48 KB of shared memory
constexpr int kMaxSegments = 1536;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define GYM_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl(x1, r);     \
  x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)(i >> 32) + k0;
  uint32_t x1 = (uint32_t)i + k1;
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

// threefry2x32 of the counter (c0, c1): both words (a fold_in is the key
// (x0, x1) of the counter (0, data))
__device__ __forceinline__ void threefry_pair(uint32_t k0, uint32_t k1,
                                              uint32_t c0, uint32_t c1,
                                              uint32_t* y0, uint32_t* y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
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
  *y0 = x0;
  *y1 = x1;
}

#undef GYM_TF_ROUND

__device__ __forceinline__ bool bernoulli_of(uint32_t bits, float p) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return u < p;
}

// out is uint32[n] (16-byte aligned).
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(uint32_t k0, uint32_t k1, uint64_t n, void* out) {
  const uint64_t groups = (n + kPerThread - 1) / kPerThread;
  const uint64_t stride = (uint64_t)gridDim.x * kThreads;
  for (uint64_t g = (uint64_t)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const uint64_t base = g * kPerThread;
    uint32_t b[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) b[j] = threefry_bits(k0, k1, base + j);
    // the last group stores element by element from the same values, so
    // the compiled body holds one threefry evaluation per element
    uint32_t* o = static_cast<uint32_t*>(out) + base;
    if (base + kPerThread <= n) {
      *reinterpret_cast<uint4*>(o) = make_uint4(b[0], b[1], b[2], b[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (base + j < n) o[j] = b[j];
    }
  }
}

// Bits of R rows of n, one key a row, one launch: row r is the bits of the
// key fold_in(keys[r], data[r]) (keys[r] itself when data is null). The
// serving path's sampler draws every slot's gumbel noise this way, its keys
// the slots' base keys and the step indices held on the card. Grid: (blocks
// over the row's 4-element groups, R); thread 0 of a block folds the key.
__global__ void __launch_bounds__(kThreads)
    threefry_rows_bits_kernel(const uint32_t* __restrict__ keys,
                              const int* __restrict__ data, uint64_t n,
                              uint32_t* out) {
  __shared__ uint32_t key[2];
  const int r = blockIdx.y;
  if (threadIdx.x == 0) {
    uint32_t k0 = keys[2 * r], k1 = keys[2 * r + 1];
    if (data != nullptr) threefry_pair(k0, k1, 0u, (uint32_t)data[r], &k0, &k1);
    key[0] = k0;
    key[1] = k1;
  }
  __syncthreads();
  const uint32_t k0 = key[0], k1 = key[1];
  const uint64_t groups = (n + kPerThread - 1) / kPerThread;
  const uint64_t g = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= groups) return;
  const uint64_t base = g * kPerThread;
  uint32_t b[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) b[j] = threefry_bits(k0, k1, base + j);
  uint32_t* o = out + (uint64_t)r * n + base;
  if (base + kPerThread <= n && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
    *reinterpret_cast<uint4*>(o) = make_uint4(b[0], b[1], b[2], b[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      if (base + j < n) o[j] = b[j];
  }
}

// The segment table, S entries, four int64 arrays one after the other:
// first[s], the index of segment s's first 4-element group among the
// concatenated groups of all segments (nondecreasing, first[0] = 0);
// key[s] = k0 | k1 << 32; n[s], its elements; at[s], the byte offset of
// its element 0 in out.

// The segment that holds group g: the last s with first[s] <= g (an empty
// segment shares its first with the next, which holds the groups).
__device__ __forceinline__ int segment_of(const unsigned long long* first,
                                          int S, uint64_t g) {
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= g) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// A block copies the table to shared memory (one wait on global memory,
// not one for first[] and another for the entries of the segment found),
// then walks its own contiguous range of the groups of all the segments,
// kThreads groups a pass (neighbouring threads, neighbouring groups). A
// thread's groups only grow, so it searches again only when one passes the
// end of the segment it holds: once a segment its range enters, where a
// grid-wide stride would land most passes in another segment. Element i
// of segment s is element i of the mask of key s alone.
__global__ void __launch_bounds__(kThreads)
    threefry_segments_kernel(const unsigned long long* __restrict__ table,
                             int S, uint64_t groups, uint64_t per_block,
                             float p, uint8_t* out) {
  extern __shared__ unsigned long long t[];
  for (int i = threadIdx.x; i < 4 * S; i += kThreads) t[i] = table[i];
  __syncthreads();
  const unsigned long long *first = t, *keys = t + S, *ns = t + 2 * S,
                           *ats = t + 3 * S;
  uint64_t g0 = 0, g1 = 0, n = 0;  // the held segment: groups [g0, g1)
  uint32_t k0 = 0, k1 = 0;
  uint8_t* o = out;
  const uint64_t g_end = min(groups, (blockIdx.x + 1) * per_block);
  for (uint64_t g = blockIdx.x * per_block + threadIdx.x; g < g_end;
       g += kThreads) {
    if (g >= g1) {
      const int s = segment_of(first, S, g);
      g0 = first[s];
      g1 = s + 1 < S ? first[s + 1] : groups;
      k0 = (uint32_t)keys[s];
      k1 = (uint32_t)(keys[s] >> 32);
      n = ns[s];
      o = out + ats[s];
    }
    const uint64_t base = (g - g0) * kPerThread;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      word |= (uint32_t)bernoulli_of(threefry_bits(k0, k1, base + j), p)
              << (8 * j);
    uint8_t* at = o + base;
    if (base + kPerThread <= n && (reinterpret_cast<uintptr_t>(at) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(at) = word;
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (base + j < n) at[j] = (uint8_t)(word >> (8 * j));
    }
  }
}

// the grid-stride loop's block budget: at most 16 blocks of 256 threads an
// SM of the card it runs on
int block_budget(unsigned long long* most) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *most = 16ull * (unsigned long long)sms;
  return (int)err;
}

// blocks for a grid-stride loop over this many groups
int grid_for(unsigned long long groups, unsigned int* blocks) {
  unsigned long long most = 0;
  if (int err = block_budget(&most)) return err;
  const unsigned long long want = (groups + kThreads - 1) / kThreads;
  *blocks = (unsigned int)(want < most ? want : most);
  return 0;
}

}  // namespace

extern "C" {

// out[i] = bits of element i (uint32), i < n; out 16-byte aligned.
int gym_threefry_bits(unsigned int k0, unsigned int k1, long long n,
                      void* out, void* stream) {
  if (n < 0 || out == nullptr || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  unsigned int blocks = 0;
  if (int err = grid_for(((unsigned long long)n + kPerThread - 1) / kPerThread,
                         &blocks))
    return err;
  threefry_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      k0, k1, (uint64_t)n, out);
  return (int)cudaGetLastError();
}

// out[r, i] = bits of element i under fold_in(keys[r], data[r]) (uint32),
// i < n, r < R; keys [R, 2] uint32 and data [R] int32 (or null: keys[r]
// itself) on the card.
int gym_threefry_bits_rows(const void* keys, const void* data, int R,
                           long long n, void* out, void* stream) {
  if (R < 0 || R > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return 0;
  if (keys == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned long long groups =
      ((unsigned long long)n + kPerThread - 1) / kPerThread;
  const unsigned long long bx = (groups + kThreads - 1) / kThreads;
  if (bx > 2147483647ull) return (int)cudaErrorInvalidValue;
  threefry_rows_bits_kernel<<<dim3((unsigned)bx, (unsigned)R), kThreads, 0,
                              (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(keys), static_cast<const int*>(data),
      (uint64_t)n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// Bernoulli masks of S segments in one launch: out[at[s] + i] =
// uniform(element i under key[s]) < p, one byte an element, i < n[s].
// table: the segment table above on the card (4 S int64); groups = first[S-1]
// + ceil(n[S-1] / 4), the groups of all the segments.
int gym_bernoulli_segments(const void* table, int S, long long groups,
                           float p, void* out, void* stream) {
  if (S < 0 || S > kMaxSegments || groups < 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || groups == 0) return 0;
  if (table == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  unsigned int blocks = 0;
  if (int err = grid_for((unsigned long long)groups, &blocks)) return err;
  // each block's range of groups (a 64-bit division, done once here)
  const uint64_t per_block = ((uint64_t)groups + blocks - 1) / blocks;
  threefry_segments_kernel<<<blocks, kThreads,
                             4 * S * sizeof(unsigned long long),
                             (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(table), S, (uint64_t)groups,
      per_block, p, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
