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
// hi and lo words, and a group that runs past n stores element by element,
// so no store passes n.
//
// gym_bernoulli_rows draws R masks of n elements in one launch, row r under
// its own key (a [R, 2] uint32 table on the card): element (r, i) is exactly
// gym_bernoulli_mask's element i under key r. It replaces the masks of
// flax's nn.Dropout (gym_tpu/models/mnist_cnn.py:36,45 and the nanoGPT
// dropouts), which draw one small mask per simulated node, microbatch and
// layer: one launch a layer instead of one a node. Row r is blockIdx.y; the
// x blocks stride over its 4-element groups. A row starts 4-byte aligned
// only when n % 4 == 0; other rows store byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

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

#undef GYM_TF_ROUND

__device__ __forceinline__ bool bernoulli_of(uint32_t bits, float p) {
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return u < p;
}

// MASK = false: out is uint32[n] (16-byte aligned); true: out is bool[n]
// (4-byte aligned), one byte an element.
template <bool MASK>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(uint32_t k0, uint32_t k1, uint64_t n, float p, void* out) {
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
    const bool whole = base + kPerThread <= n;
    if (MASK) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        word |= (uint32_t)bernoulli_of(b[j], p) << (8 * j);
      uint8_t* o = static_cast<uint8_t*>(out) + base;
      if (whole) {
        *reinterpret_cast<uint32_t*>(o) = word;
      } else {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          if (base + j < n) o[j] = (uint8_t)(word >> (8 * j));
      }
    } else {
      uint32_t* o = static_cast<uint32_t*>(out) + base;
      if (whole) {
        *reinterpret_cast<uint4*>(o) = make_uint4(b[0], b[1], b[2], b[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
          if (base + j < n) o[j] = b[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    threefry_rows_kernel(const uint32_t* __restrict__ keys, uint64_t n,
                         float p, uint8_t* out) {
  const uint32_t k0 = keys[2 * blockIdx.y];
  const uint32_t k1 = keys[2 * blockIdx.y + 1];
  uint8_t* row = out + (uint64_t)blockIdx.y * n;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 3) == 0;
  const uint64_t groups = (n + kPerThread - 1) / kPerThread;
  const uint64_t stride = (uint64_t)gridDim.x * kThreads;
  for (uint64_t g = (uint64_t)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const uint64_t base = g * kPerThread;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      word |= (uint32_t)bernoulli_of(threefry_bits(k0, k1, base + j), p)
              << (8 * j);
    if (aligned && base + kPerThread <= n) {
      *reinterpret_cast<uint32_t*>(row + base) = word;
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        if (base + j < n) row[base + j] = (uint8_t)(word >> (8 * j));
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

template <bool MASK>
int launch(uint32_t k0, uint32_t k1, long long n, float p, void* out,
           void* stream, uintptr_t align) {
  if (n < 0 || out == nullptr || reinterpret_cast<uintptr_t>(out) % align)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned long long groups = ((unsigned long long)n + kPerThread - 1)
                                    / kPerThread;
  unsigned long long most = 0;
  if (int err = block_budget(&most)) return err;
  const unsigned long long want = (groups + kThreads - 1) / kThreads;
  const unsigned int blocks = (unsigned int)(want < most ? want : most);
  threefry_kernel<MASK><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      k0, k1, (uint64_t)n, p, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[i] = bits of element i (uint32), i < n; out 16-byte aligned.
int gym_threefry_bits(unsigned int k0, unsigned int k1, long long n,
                      void* out, void* stream) {
  return launch<false>(k0, k1, n, 0.0f, out, stream, 16);
}

// out[i] = uniform(element i) < p, one byte an element; out 4-byte aligned.
int gym_bernoulli_mask(unsigned int k0, unsigned int k1, long long n,
                       float p, void* out, void* stream) {
  return launch<true>(k0, k1, n, p, out, stream, 4);
}

// out[r * n + i] = uniform(element i under key r) < p, r < rows, i < n; keys
// holds rows (k0, k1) pairs on the card.
int gym_bernoulli_rows(const void* keys, int rows, long long n, float p,
                       void* out, void* stream) {
  if (rows < 0 || rows > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return 0;
  if (keys == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  unsigned long long most = 0;
  if (int err = block_budget(&most)) return err;
  const unsigned long long groups = ((unsigned long long)n + kPerThread - 1)
                                    / kPerThread;
  const unsigned long long want = (groups + kThreads - 1) / kThreads;
  unsigned long long per_row = most / (unsigned long long)rows;
  if (per_row == 0) per_row = 1;
  const dim3 grid((unsigned int)(want < per_row ? want : per_row),
                  (unsigned int)rows);
  threefry_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(keys), (uint64_t)n, p,
      static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
