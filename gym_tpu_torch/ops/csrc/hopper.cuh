// Hopper (sm_90a) building blocks of the attention kernels: swizzled
// shared-memory tiles, wgmma matrix descriptors, instructions and the
// products built on them (bf16, and f32 in split-precision TF32), cp.async
// copies, TMA and bulk loads with the mbarriers that report them, and the
// fences between them.
//
// A tile is ROWS rows of RB bytes (64 rows of D bf16 values, a 64-row block
// of q, k, v or do; or rows of f32 values) in the layout wgmma reads with a
// swizzle: rows of min(RB, 128) bytes swizzled at that width (32, 64 or 128
// bytes), and for RB > 128 that many [ROWS x 128 B] column parts one after
// the other. One layout serves both uses of a tile: K-major, where the
// product's depth runs along its rows' values (q in q k^T), and MN-major,
// where the depth runs down its rows (v in p v; bf16 only: TF32 wgmma reads
// K-major operands alone).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace hop {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int RB, int ROWS = 64>
struct Tile {
  static constexpr int ROWB = RB < 128 ? RB : 128;  // bytes of a swizzled row
  static constexpr int PARTS = RB / ROWB;           // column parts
  static constexpr int PART_BYTES = ROWS * ROWB;
  static constexpr int BYTES = ROWS * RB;
  // wgmma layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  // byte offset of the 16-byte chunk c (bytes 16c .. 16c+15) of row r; the
  // swizzle XORs the chunk index with address bits 7 and up, so a tile
  // starts on a 1024-byte boundary
  __device__ static __forceinline__ uint32_t chunk(int r, int c) {
    constexpr int CPR = ROWB / 16;
    const uint32_t off = r * ROWB + (c % CPR) * 16;
    return (c / CPR) * PART_BYTES +
           (off ^ ((off >> 3) & ((ROWB / 16 - 1) << 4)));
  }
};
// a 64-row tile of D bf16 values
template <int D>
using BfTile = Tile<2 * D>;

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type; base offset 0 (1024-aligned)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// The tile as a K-major operand (its rows x a depth of 32 bytes: 16 bf16
// or 8 tf32 values), depth step ks: bytes 32ks .. 32ks+31 of each row. Rows
// repeat in groups of 8 (stride byte offset); the step moves the start
// address inside the swizzled row.
template <class L>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  const int col = 32 * ks;
  return make_desc(tile + (col / L::ROWB) * L::PART_BYTES + col % L::ROWB, 16,
                   8 * L::ROWB, L::LAYOUT);
}

// A bf16 tile as an MN-major B operand: depth over its rows 16ks ..
// 16ks+15, width over the values of column part hf (ROWB / 2 values).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks, int hf) {
  using L = BfTile<D>;
  return make_desc(tile + hf * L::PART_BYTES + 16 * ks * L::ROWB,
                   L::PART_BYTES, 8 * L::ROWB, L::LAYOUT);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
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
// this thread's shared-memory writes (cp.async, st.shared) made visible to
// the async proxy that wgmma reads through; a barrier follows
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Copy rows [r0, r0 + 64) of a [T x D] bf16 view with token stride ts into
// a tile with 16-byte cp.async copies: the view's base and strides must be
// 16-byte aligned (the launchers refuse any other view).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ts, int r0) {
  constexpr int CPR = D / 8;
  constexpr int CHUNKS = 64 * CPR;  // 128 .. 1024: whole rounds of 128
#pragma unroll
  for (int e0 = 0; e0 < CHUNKS; e0 += 128) {
    const int e = e0 + (int)threadIdx.x;
    const int r = e / CPR, c = e % CPR;
    cp_async16(dst + BfTile<D>::chunk(r, c),
               src + (long long)(r0 + r) * ts + c * 8);
  }
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Store two neighbouring values of one row (column even).
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// f32: one 8-byte store (VEC = 4: the view 16-byte aligned) or two 4-byte
// ones (VEC = 1: any view)
template <int VEC>
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    p[1] = b;
  }
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma: the asm statements are ordered, and each
// one here claims to read and write every register.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ------------------------------------------------------- wgmma instructions
// Accumulator layout of m64nNk16 (f32), thread t of the warpgroup, warp
// w = t / 32, lane l = t % 32: d[4j + e] holds row 16w + l/4 + 8(e/2),
// column 8j + 2(l%4) + e%2. The register A operand of a k16 step uses the
// same layout: four bf16 pairs, (row, cols 2(l%4)+{0,1}), (row + 8, same),
// (row, 8 + same), (row + 8, 8 + same), which is d[8k .. 8k+7] of an
// accumulator whose columns are the step's depth.

// d (+)= A B, A [64 x 16] and B [16 x 64] both read from shared memory,
// both K-major; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A [64 x 16] bf16 in registers (four pairs a thread, the
// accumulator's own layout), B [16 x 16] in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d += A B, A [64 x 16] bf16 in registers (four pairs a thread, the
// accumulator's own layout), B [16 x 32] in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d += A B, A [64 x 16] bf16 in registers (four pairs a thread, the
// accumulator's own layout), B [16 x 64] in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// d (+)= A B with N values of the width (a column part of a bf16 tile), A
// in registers (a[4] per depth step) and B an MN-major tile part.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// ---------------------------------------------- products of one warpgroup

// This thread's rows (row, row + 8) and first column of each 8-column chunk
// in the accumulator layout above, within its warpgroup.
struct Lane {
  int row, col;
  __device__ Lane()
      : row(16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2)),
        col(2 * (threadIdx.x & 3)) {}
};

// reductions over the four lanes that hold one row
__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s = a b^T over depth D, both tiles K-major: s [64 x 64] f32
template <int D>
__device__ __forceinline__ void mma_abt(float (&s)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_ss_n64(s, desc_k<BfTile<D>>(a, ks), desc_k<BfTile<D>>(b, ks),
                 ks > 0);
}

// acc += p b: p [64 x 64] bf16 in registers (four depth steps), b a tile
// read MN-major (depth over its 64 rows, width D)
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 2],
                                       uint32_t (&p)[4][4], uint32_t b) {
  using L = BfTile<D>;
  constexpr int SUB = L::ROWB / 2;  // values of a column part
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hf = 0; hf < L::PARTS; ++hf)
      wgmma_rs<SUB>(acc + hf * (SUB / 2), p[kk], desc_mn<D>(b, kk, hf));
}

// wait for the products in flight; their accumulators are then readable
template <int A, int B>
__device__ __forceinline__ void finish(float (&a)[A], float (&b)[B]) {
  wg_commit();
  wg_wait<0>();
  fence_regs(a);
  fence_regs(b);
}
template <int A, int B>
__device__ __forceinline__ void start(float (&a)[A], float (&b)[B]) {
  fence_regs(a);
  fence_regs(b);
  wg_fence();
}

// ------------------------------------------- split-precision TF32 (3xTF32)
// An f32 value x is held as x = hi + lo, hi = tf32(x) and lo = tf32(x - hi),
// each an f32 bit pattern whose low 13 bits are zero (x - hi is exact in
// f32). A product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi on the tensor
// cores (the a_lo b_lo term, about 2^-22 of a b, is left out): about 2^-21
// relative, the order of reordering an f32 sum, at a third of the TF32
// rate. TF32 wgmma reads both shared-memory operands K-major (it has no
// transpose bit) and has a depth of 8 values (32 bytes) a step.

// cvt.rna (round to nearest, ties away from zero), the low bits cleared
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - hi);
}

// the hi and lo parts of four values into the same 16-byte chunk (byte
// offset off) of a hi tile and a lo tile
__device__ __forceinline__ void put4(uint32_t hi, uint32_t lo, uint32_t off,
                                     float4 x) {
  float h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(hi + off),
               "f"(h[0]), "f"(h[1]), "f"(h[2]), "f"(h[3])
               : "memory");
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + off),
               "f"(l[0]), "f"(l[1]), "f"(l[2]), "f"(l[3])
               : "memory");
}

// m64nNk8 TF32 wgmma (f32 accumulator, the layout above): SS reads A and
// B from shared memory, RS reads A from registers (a[0..3], below); both
// K-major. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss_n16(float* d, uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss_n32(float* d, uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_ss_n64(float* d, uint64_t da,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n16(float* d, const uint32_t* a,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n32(float* d, const uint32_t* a,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs_n64(float* d, const uint32_t* a,
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 16) wgmma_tf32_ss_n16(d, da, db, accumulate);
  else if constexpr (N == 32) wgmma_tf32_ss_n32(d, da, db, accumulate);
  else wgmma_tf32_ss_n64(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a,
                                              uint64_t db, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma width");
  if constexpr (N == 16) wgmma_tf32_rs_n16(d, a, db, accumulate);
  else if constexpr (N == 32) wgmma_tf32_rs_n32(d, a, db, accumulate);
  else wgmma_tf32_rs_n64(d, a, db, accumulate);
}

// The register A operand of an m64nNk8 TF32 step is four values a thread:
// (row, col l%4), (row + 8, same), (row, l%4 + 4), (row + 8, same), row and
// l as in the accumulator layout. An accumulator whose 8 columns 8kk ..
// 8kk+7 are the step's depth holds (row, 2(l%4) + {0, 1}) and (row + 8,
// same) in v[4kk .. 4kk+3]: used in place, A's column l%4 is the depth's
// value 2(l%4) and column l%4 + 4 the value 2(l%4) + 1. The B tile that
// meets it therefore holds each group of 8 depth values in the order 0, 2,
// 4, 6, 1, 3, 5, 7 (key_order); the contraction does not depend on the
// order. These are hi and lo A fragments of the steps of such an
// accumulator.
template <int K>
__device__ __forceinline__ void frags(const float (&v)[K / 2],
                                      uint32_t (&hi)[K / 8][4],
                                      uint32_t (&lo)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float x[4] = {v[4 * kk], v[4 * kk + 2], v[4 * kk + 1],
                        v[4 * kk + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h, l;
      split_tf32(x[i], h, l);
      hi[kk][i] = __float_as_uint(h);
      lo[kk][i] = __float_as_uint(l);
    }
  }
}
// position p of a group of 8 in such a B tile holds depth value key_order(p)
__device__ __forceinline__ constexpr int key_order(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

// s = a b^T in 3xTF32: a [64 x DEPTH] (tiles LA, hi and lo) and b [N x
// DEPTH] (tiles LB), f32 values, both K-major; the small terms (a_hi b_lo,
// a_lo b_hi) first.
template <int N, int DEPTH, class LA, class LB>
__device__ __forceinline__ void mma3_abt(float (&s)[N / 2], uint32_t ah,
                                         uint32_t al, uint32_t bh,
                                         uint32_t bl) {
#pragma unroll
  for (int ks = 0; ks < DEPTH / 8; ++ks) {
    wgmma_tf32_ss<N>(s, desc_k<LA>(ah, ks), desc_k<LB>(bl, ks), ks > 0);
    wgmma_tf32_ss<N>(s, desc_k<LA>(al, ks), desc_k<LB>(bh, ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < DEPTH / 8; ++ks)
    wgmma_tf32_ss<N>(s, desc_k<LA>(ah, ks), desc_k<LB>(bh, ks), 1);
}

// s = a b^T in 3xTF32 as mma3_abt, a [64 x DEPTH] in registers as hi and
// lo A fragments (four values a thread a depth step, the layout above).
template <int N, int DEPTH, class LB>
__device__ __forceinline__ void mma3_rbt(float (&s)[N / 2],
                                         const uint32_t (&ah)[DEPTH / 8][4],
                                         const uint32_t (&al)[DEPTH / 8][4],
                                         uint32_t bh, uint32_t bl) {
#pragma unroll
  for (int ks = 0; ks < DEPTH / 8; ++ks) {
    wgmma_tf32_rs<N>(s, ah[ks], desc_k<LB>(bl, ks), ks > 0);
    wgmma_tf32_rs<N>(s, al[ks], desc_k<LB>(bh, ks), 1);
  }
#pragma unroll
  for (int ks = 0; ks < DEPTH / 8; ++ks)
    wgmma_tf32_rs<N>(s, ah[ks], desc_k<LB>(bh, ks), 1);
}

// acc += p b in 3xTF32: p [64 x DEPTH] as hi and lo A fragments (frags), b
// given as its transpose [N x DEPTH] (tiles LB, depth in key_order). The
// terms of each block of at most 64 columns are summed on the tensor cores
// in a zeroed register block and added to acc in f32 (round to nearest):
// acc sums many such blocks, and the tensor cores' own additions are not
// held to that rounding.
template <int N, int DEPTH, class LB>
__device__ __forceinline__ void mma3_pb_add(float (&acc)[N / 2],
                                            const uint32_t (&ph)[DEPTH / 8][4],
                                            const uint32_t (&pl)[DEPTH / 8][4],
                                            uint32_t bh, uint32_t bl) {
  constexpr int NP = N < 64 ? N : 64;
#pragma unroll
  for (int part = 0; part < N / NP; ++part) {
    const uint32_t rows = part * NP * LB::ROWB;  // rows part·NP onwards
    float t[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) t[i] = 0.f;
    fence_regs(t);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DEPTH / 8; ++kk) {
      wgmma_tf32_rs<NP>(t, ph[kk], desc_k<LB>(bl + rows, kk), kk > 0);
      wgmma_tf32_rs<NP>(t, pl[kk], desc_k<LB>(bh + rows, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < DEPTH / 8; ++kk)
      wgmma_tf32_rs<NP>(t, ph[kk], desc_k<LB>(bh + rows, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(t);
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[part * NP / 2 + i] += t[i];
  }
}

// ------------------------------------------------- mbarriers and TMA loads

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// the initialised barriers made visible to the other threads and to the
// async proxy (TMA); a __syncthreads follows
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrive and announce the bytes that TMA loads will complete on this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of the given parity has completed (a barrier starts
// in phase 0, so waiting on parity 1 of a fresh barrier returns at once)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; its bytes complete on the barrier bar.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// bytes bytes (a multiple of 16) from global memory at src (16-byte
// aligned) into shared memory at dst as they are: a 1-D bulk copy, whose
// bytes complete on the barrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Rows [r0, r0 + 64) of head (n, h) of a [N, H, T, D] tensor map whose box
// is [64 rows x ROWB bytes] into a tile: one box per column part. The map's
// swizzle at the box's row width (32, 64 or 128 bytes) is BfTile<D>::chunk's,
// so the box lands in the tile layout above.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const void* map,
                                         uint32_t bar, int r0, int h, int n) {
  using L = BfTile<D>;
#pragma unroll
  for (int hf = 0; hf < L::PARTS; ++hf)
    tma_load_4d(dst + hf * L::PART_BYTES, map, bar, hf * (L::ROWB / 2), r0, h,
                n);
}

// Registers a thread of this warpgroup may hold from here on; every warp
// of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace hop
}  // namespace
