// Shared by the attention kernels of this directory: element strides, the
// head-dim dispatch of the C entries, and the tile sizes, dtype conversions
// and shared-memory tile loader of the scalar f32 long-context forward
// (flash_attention.cu).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NTHREADS = 256; // 16 x 16 threads, 4 x 4 micro-tile each
constexpr int LDP = BK + 1;   // padded row stride of score tiles in smem

struct Strides {
  long long n, h, t;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// round an f32 value to the storage dtype and back (the Pallas .astype)
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Copy rows [r0, r0 + 64) of one (batch, head) slice into a padded smem tile.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long tstride, int r0) {
  for (int e = threadIdx.x; e < 64 * D; e += NTHREADS) {
    const int r = e / D, d = e - (e / D) * D;
    dst[r * (D + 1) + d] = load_f(src + (long long)(r0 + r) * tstride + d);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// The bf16 kernels copy 16-byte rows (cp.async, TMA): base and every
// stride 16-byte aligned. The wrappers refuse other bf16 views; a view that
// reaches a launcher unaligned is refused there rather than faulting the
// context.
bool aligned16(const void* p, Strides s) {
  return ((uintptr_t)p & 15) == 0 && s.n % 8 == 0 && s.h % 8 == 0 &&
         s.t % 8 == 0;
}

}  // namespace

// head-dim dispatch: CALL sees a constexpr int D
#define GYM_HEAD_DIM(HEAD_DIM, CALL)                                         \
  switch (HEAD_DIM) {                                                        \
    case 16: { constexpr int D = 16; return (int)CALL; }                     \
    case 32: { constexpr int D = 32; return (int)CALL; }                     \
    case 64: { constexpr int D = 64; return (int)CALL; }                     \
    case 128: { constexpr int D = 128; return (int)CALL; }                   \
  }
