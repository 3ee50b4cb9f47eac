// Hopper (sm_90a) building blocks of the bf16 attention kernels: swizzled
// shared-memory tiles, wgmma matrix descriptors, instructions and the
// products built on them, cp.async copies, TMA loads with the mbarriers
// that report them, and the fences between them.
//
// A tile is 64 rows of D bf16 values (a 64-row block of q, k, v or do) in
// the layout wgmma reads with a swizzle: rows of min(D, 64) values (32, 64 or
// 128 bytes) swizzled at that width, and for D = 128 two such [64 x 64]
// column halves one after the other. One layout serves both uses of a tile:
// K-major, where the product's depth runs along its rows' values (q in
// q k^T), and MN-major, where the depth runs down its rows (v in p v).

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

template <int D>
struct Tile {
  static constexpr int SUB = D < 64 ? D : 64;  // values in one swizzled row
  static constexpr int ROWB = SUB * 2;         // its bytes: 32, 64 or 128
  static constexpr int HALVES = D / SUB;       // 1, or 2 for D = 128
  static constexpr int HALF_BYTES = 64 * ROWB;
  static constexpr int BYTES = 64 * D * 2;
  // wgmma layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  // byte offset of the 16-byte chunk c (values 8c .. 8c+7) of row r; the
  // swizzle XORs the chunk index with address bits 7 and up, so a tile
  // starts on a 1024-byte boundary
  __device__ static __forceinline__ uint32_t chunk(int r, int c) {
    constexpr int CPR = SUB / 8;
    const uint32_t off = r * ROWB + (c % CPR) * 16;
    return (c / CPR) * HALF_BYTES +
           (off ^ ((off >> 3) & ((ROWB / 16 - 1) << 4)));
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type; base offset 0 (1024-aligned)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// The tile as a K-major operand (64 rows x depth 16), depth step ks: its
// values 16ks .. 16ks+15. Rows repeat in groups of 8 (stride byte offset);
// the step moves the start address inside the swizzled row.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  using L = Tile<D>;
  const int col = 16 * ks;
  return make_desc(tile + (col / L::SUB) * L::HALF_BYTES + (col % L::SUB) * 2,
                   16, 8 * L::ROWB, L::LAYOUT);
}

// The tile as an MN-major B operand: depth over its rows 16ks .. 16ks+15,
// width over the values of column half hf (SUB values).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks, int hf) {
  using L = Tile<D>;
  return make_desc(tile + hf * L::HALF_BYTES + 16 * ks * L::ROWB,
                   L::HALF_BYTES, 8 * L::ROWB, L::LAYOUT);
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
    cp_async16(dst + Tile<D>::chunk(r, c),
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

// d (+)= A B with N = SUB values of the width, A in registers (a[4] per
// depth step) and B an MN-major tile half.
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
    wgmma_ss_n64(s, desc_k<D>(a, ks), desc_k<D>(b, ks), ks > 0);
}

// acc += p b: p [64 x 64] bf16 in registers (four depth steps), b a tile
// read MN-major (depth over its 64 rows, width D)
template <int D>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 2],
                                       uint32_t (&p)[4][4], uint32_t b) {
  using L = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int hf = 0; hf < L::HALVES; ++hf)
      wgmma_rs<L::SUB>(acc + hf * (L::SUB / 2), p[kk], desc_mn<D>(b, kk, hf));
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

// Rows [r0, r0 + 64) of head (n, h) of a [N, H, T, D] tensor map whose box
// is [64 rows x SUB values] into a tile: one box per column half. The map's
// swizzle at the box's row width (32, 64 or 128 bytes) is Tile<D>::chunk's,
// so the box lands in the tile layout above.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const void* map,
                                         uint32_t bar, int r0, int h, int n) {
  using L = Tile<D>;
#pragma unroll
  for (int hf = 0; hf < L::HALVES; ++hf)
    tma_load_4d(dst + hf * L::HALF_BYTES, map, bar, hf * L::SUB, r0, h, n);
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
