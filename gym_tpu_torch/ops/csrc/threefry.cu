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
// host read for its keys. Its kernel, threefry_rows_bits_kernel, is the
// second design; the first, threefry_rows_bits_ref_kernel, is kept as its
// oracle (gym_threefry_bits_rows_ref): a block of 256 threads a 1024
// elements of a row, thread 0 folding the row's key while the other 255
// wait at a barrier, then one group of 4 a thread. In the second no thread
// waits for another's fold: each warp folds its row's key itself, in every
// lane, so one warp's fold overlaps the other warps' draws. Each lane draws
// G groups of 4 a tile (a template parameter), the lanes interleaved so
// that every store is a 16-byte uint4 and a warp's 32 stores of a group
// are 512 contiguous bytes; a warp walks a contiguous run of tiles, over
// rows in order, and folds again only where it enters the next row. The
// grid is capped at warps_per_sm warps an SM and the runs are equal to a
// tile, so the SMs draw equal shares. G, the cap and the block's warps
// come from scripts/d1_t1_sweep.py on the H100 (choose_rows_plan).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// the slots' base keys and the step indices held on the card. The oracle,
// the first kernel. Grid: (blocks over the row's 4-element groups, R);
// thread 0 of a block folds the key.
__global__ void __launch_bounds__(kThreads)
    threefry_rows_bits_ref_kernel(const uint32_t* __restrict__ keys,
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

// The same function, the kernel of the main path: warp w of the grid owns
// the tiles [w * per_warp, (w + 1) * per_warp) of the R rows' tiles (each
// row tiles_per_row tiles of 32 G groups, rows in order); lane l draws
// group tile * 32 G + 32 j + l of the tile's row for j < G. A group's 4
// counters share their high word and carry nothing into it (the group
// starts at a multiple of 4), so each element is threefry2x32 of (hi, lo +
// i) as threefry_pair computes it; a row shorter than 2^32 elements (Long
// false) keeps its offsets in 32 bits and its high word at 0.
template <int G, bool Long>
__global__ void __launch_bounds__(kThreads)
    threefry_rows_bits_kernel(const uint32_t* __restrict__ keys,
                              const int* __restrict__ data, uint64_t n,
                              uint64_t tiles_per_row, uint64_t tiles,
                              uint64_t per_warp, uint32_t* out) {
  using Index = typename std::conditional<Long, uint64_t, uint32_t>::type;
  const uint32_t lane = threadIdx.x & 31;
  uint64_t t = ((uint64_t)blockIdx.x * (blockDim.x >> 5) +
                (threadIdx.x >> 5)) * per_warp;
  const uint64_t t_end = min(tiles, t + per_warp);
  if (t >= t_end) return;
  const Index groups = (Index)((n + kPerThread - 1) / kPerThread);
  const Index whole = (Index)(n / kPerThread);  // groups of 4 in the row
  // one row (the one-key path): no division ahead of the key's load
  const uint64_t row0 = tiles == tiles_per_row ? 0 : t / tiles_per_row;
  uint64_t row = row0;
  Index tile = (Index)(t - row0 * tiles_per_row);
  uint32_t k0 = 0, k1 = 0;
  uint32_t* o = out;
  bool aligned = false;
  for (bool fold = true; t < t_end; ++t, ++tile) {
    if (tile == tiles_per_row) {  // the next row
      ++row;
      tile = 0;
      fold = true;
    }
    if (fold) {  // every lane folds the row's key: no lane waits for one
      k0 = keys[2 * row];
      k1 = keys[2 * row + 1];
      if (data != nullptr)
        threefry_pair(k0, k1, 0u, (uint32_t)data[row], &k0, &k1);
      o = out + row * n;
      aligned = (reinterpret_cast<uintptr_t>(o) & 15) == 0;
      fold = false;
    }
    const Index g0 = tile * (32 * G) + lane;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const Index g = g0 + 32 * j;
      if (g >= groups) break;
      const Index base = g * kPerThread;
      const uint32_t hi = Long ? (uint32_t)((uint64_t)base >> 32) : 0u;
      const uint32_t lo = (uint32_t)base;
      uint32_t b[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        uint32_t y0, y1;
        threefry_pair(k0, k1, hi, lo + i, &y0, &y1);
        b[i] = y0 ^ y1;
      }
      uint32_t* at = o + base;
      if (aligned && g < whole) {
        *reinterpret_cast<uint4*>(at) = make_uint4(b[0], b[1], b[2], b[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          if (base + i < n) at[i] = b[i];
      }
    }
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

// The launch of threefry_rows_bits_kernel: G groups of 4 a lane a tile (1,
// 2, 4 or 8), at most warps_per_sm warps an SM over all R rows and
// warps_a_block warps a block (0: choose_rows_plan's), each warp a run of
// tiles as equal as they can be, so every SM draws about as much as every
// other.
struct RowsPlan {
  int per_thread, warps_a_block;
  unsigned blocks;
  uint64_t tiles_per_row, tiles, per_warp;
};

// the settings scripts/d1_t1_sweep.py picked on the H100 for the sampler's
// rows (16 and 80 rows of the vocabulary, keys folded with step indices):
// 4 groups a lane, so a warp's fold is spread over 16 elements a lane, 24
// warps an SM, 4 a block
void choose_rows_plan(int* per_thread, int* warps_per_sm,
                      int* warps_a_block) {
  if (*per_thread <= 0) *per_thread = 4;
  if (*warps_per_sm <= 0) *warps_per_sm = 24;
  if (*warps_a_block <= 0) *warps_a_block = 4;
}

int make_rows_plan(int R, long long n, int per_thread, int warps_per_sm,
                   int warps_a_block, RowsPlan* plan) {
  choose_rows_plan(&per_thread, &warps_per_sm, &warps_a_block);
  if ((per_thread != 1 && per_thread != 2 && per_thread != 4 &&
       per_thread != 8) ||
      warps_a_block > kThreads / 32)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t groups = ((uint64_t)n + kPerThread - 1) / kPerThread;
  const uint64_t per_tile = 32ull * per_thread;
  plan->per_thread = per_thread;
  plan->warps_a_block = warps_a_block;
  plan->tiles_per_row = (groups + per_tile - 1) / per_tile;
  plan->tiles = (uint64_t)R * plan->tiles_per_row;
  const uint64_t most = (uint64_t)sms * warps_per_sm;
  plan->per_warp = plan->tiles ? (plan->tiles + most - 1) / most : 1;
  const uint64_t warps = (plan->tiles + plan->per_warp - 1) / plan->per_warp;
  plan->blocks =
      (unsigned)((warps + warps_a_block - 1) / (uint64_t)warps_a_block);
  return 0;
}

template <int G, bool Long>
void launch_rows(const RowsPlan& p, const uint32_t* keys, const int* data,
                 uint64_t n, uint32_t* out, cudaStream_t stream) {
  threefry_rows_bits_kernel<G, Long><<<p.blocks, 32 * p.warps_a_block, 0,
                                       stream>>>(
      keys, data, n, p.tiles_per_row, p.tiles, p.per_warp, out);
}

bool bad_rows(const void* keys, int R, long long n, void* out) {
  return R < 0 || R > 65535 || n < 0 ||
         (R > 0 && n > 0 && (keys == nullptr || out == nullptr));
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
// itself) on the card; per_thread, warps_per_sm and warps_a_block as
// make_rows_plan takes them (0: the defaults).
int gym_threefry_bits_rows(const void* keys, const void* data, int R,
                           long long n, int per_thread, int warps_per_sm,
                           int warps_a_block, void* out, void* stream) {
  if (bad_rows(keys, R, n, out)) return (int)cudaErrorInvalidValue;
  // offsets past 32 bits (rows of 16 GB and more): the 64-bit form, 2
  // groups a lane
  const uint64_t m = (uint64_t)n;
  const bool long_rows = m > 0xFFFFFFFCull;
  RowsPlan p;
  if (int err = make_rows_plan(R, n, long_rows ? 2 : per_thread,
                               warps_per_sm, warps_a_block, &p))
    return err;
  if (R == 0 || n == 0) return 0;
  const uint32_t* k = static_cast<const uint32_t*>(keys);
  const int* d = static_cast<const int*>(data);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (long_rows) {
    launch_rows<2, true>(p, k, d, m, o, s);
  } else {
    switch (p.per_thread) {
      case 1: launch_rows<1, false>(p, k, d, m, o, s); break;
      case 2: launch_rows<2, false>(p, k, d, m, o, s); break;
      case 4: launch_rows<4, false>(p, k, d, m, o, s); break;
      default: launch_rows<8, false>(p, k, d, m, o, s); break;
    }
  }
  return (int)cudaGetLastError();
}

// The oracle: the first kernel, gym_threefry_bits_rows's function without
// its settings.
int gym_threefry_bits_rows_ref(const void* keys, const void* data, int R,
                               long long n, void* out, void* stream) {
  if (bad_rows(keys, R, n, out)) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return 0;
  const unsigned long long groups =
      ((unsigned long long)n + kPerThread - 1) / kPerThread;
  const unsigned long long bx = (groups + kThreads - 1) / kThreads;
  if (bx > 2147483647ull) return (int)cudaErrorInvalidValue;
  threefry_rows_bits_ref_kernel<<<dim3((unsigned)bx, (unsigned)R), kThreads,
                                  0, (cudaStream_t)stream>>>(
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
