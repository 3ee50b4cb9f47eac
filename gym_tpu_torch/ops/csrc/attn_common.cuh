// Shared by the attention kernels of this directory: element strides, the
// head-dim dispatch of the C entries, the dynamic shared-memory opt-in and
// the views' alignment tests.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long n, h, t;
};

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

// f32 views that the 16-byte copies take: base and every stride 16-byte
// aligned; any other view takes the 4-byte copies
bool aligned16_f32(const void* p, Strides s) {
  return ((uintptr_t)p & 15) == 0 && s.n % 4 == 0 && s.h % 4 == 0 &&
         s.t % 4 == 0;
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
