#!/usr/bin/env python3
"""C++ syntax check of the port's CUDA sources on a machine without
``nvcc``: each file is compiled with ``g++ -fsyntax-only`` against a small
header that stubs CUDA's types, built-ins and intrinsics, with its
``<<<...>>>`` launch configurations cut and its inline PTX dropped.

    python3 scripts/cu_syntax.py [FILE.cu ...]

(every ``gym_tpu_torch/ops/csrc/*.cu`` that includes no header of the
port's own but ``hopper.cuh`` by default; a header of the port's own is
read from beside the file, with the same stubs). It catches C++ errors (a
redeclared name, a template that does not instantiate, a wrong argument
list), not what only ``nvcc`` and ``ptxas`` see (PTX, registers, shared
memory). Exits non-zero if any file fails.
"""

from __future__ import annotations

import glob
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = r'''#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(x)
#define __shared__
#define __grid_constant__
#define asm(...) ((void)0)
#define CUDART_VERSION 12090
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
extern uint3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorNotSupported = 801 };
struct cudaFuncAttributes { int numRegs; };
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, F) { return 0; }
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess };
enum { cudaEnableDefault = 0 };
inline cudaError_t cudaGetDriverEntryPointByVersion(
    const char*, void**, unsigned, unsigned long long,
    cudaDriverEntryPointQueryResult*) { return 0; }
// <cuda.h>: the tensor map's types and enums
typedef unsigned long long cuuint64_t;
typedef unsigned cuuint32_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };
struct CUtensorMap { alignas(64) unsigned long long opaque[16]; };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_32B,
                          CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) {
  return 0;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetDevice(int*) { return 0; }
inline cudaError_t cudaSetDevice(int) { return 0; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, F, int,
                                                          size_t) {
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { return {}; }
struct char4 { signed char x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_sync(unsigned, T v, int) { return v; }
template <class T> T __shfl_up_sync(unsigned, T v, int) { return v; }
inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
inline unsigned __match_any_sync(unsigned m, int) { return m; }
inline unsigned __reduce_max_sync(unsigned, unsigned v) { return v; }
inline int __any_sync(unsigned, int p) { return p; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline void __syncthreads() {}
inline void __syncwarp() {}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float rsqrtf(float a) { return 1 / std::sqrt(a); }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
template <class T> T __ldg(const T* p) { return *p; }
inline unsigned __funnelshift_l(unsigned lo, unsigned hi, unsigned s) {
  return (hi << (s & 31)) | (lo >> (32 - (s & 31)));
}
inline float __uint_as_float(unsigned u) {
  float f;
  __builtin_memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  __builtin_memcpy(&u, &f, 4);
  return u;
}
'''


CUDA_HEADERS = ("cuda_runtime.h", "cuda.h", "cuda_bf16.h")


def stubbed(path: str) -> str:
    """The source at ``path`` as g++ reads it: CUDA's headers the stub,
    launch configurations cut, inline PTX dropped."""
    with open(path) as f:
        text = f.read()
    for h in CUDA_HEADERS:
        text = text.replace(f"#include <{h}>", '#include "cuda_stub.h"')
    text = re.sub(r"<<<[^;]*?>>>", "", text)
    return text.replace("asm volatile(", "asm(")


def check(path: str, tmp: str) -> bool:
    text = stubbed(path)
    for h in re.findall(r'#include "([^"]+)"', text):
        if h != "cuda_stub.h":
            with open(os.path.join(tmp, h), "w") as f:
                f.write(stubbed(os.path.join(os.path.dirname(path), h)))
    src = os.path.join(tmp, os.path.basename(path) + ".cpp")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run(["g++", "-std=c++17", "-fsyntax-only", "-w",
                           "-I", tmp, src], capture_output=True, text=True)
    print(f"{os.path.relpath(path, HERE)}: "
          f"{'ok' if proc.returncode == 0 else 'FAILED'}", flush=True)
    if proc.returncode:
        print(proc.stderr[-4000:], file=sys.stderr)
    return proc.returncode == 0


def main() -> int:
    files = sys.argv[1:] or [
        f for f in sorted(glob.glob(os.path.join(
            HERE, "gym_tpu_torch", "ops", "csrc", "*.cu")))
        if set(re.findall(r'#include "([^"]+)"', open(f).read()))
        <= {"hopper.cuh"}]
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "cuda_stub.h"), "w") as f:
            f.write(STUB)
        ok = [check(os.path.abspath(f), tmp) for f in files]
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
