// D1: DeMo's deterministic scatter-mean decode on Hopper.
//
// Replaces XLA's scatter-add in gym_tpu/ops/topk_compress.py:83-99
// (scatter_mean_decode; not a pl.pallas_call kernel), which
// gym_tpu/strategy/demo.py:305-311 runs on the gathered picks of all K
// nodes once K·k > 128. out[g, s] is the mean of the val[g, u] whose
// idx[g, u] == s, or 0.0 where there is none.
//
// The summation order is part of the contract. Each slot's sum starts at
// 0.0f and adds its picks in increasing u, in f32, and its count likewise;
// the mean is one IEEE division. That is the order of XLA's serial
// scatter-add, so the result is bit-identical from run to run and to the
// plain twin (ops/scatter_mean.py), and v and -v sent to one slot give
// exactly 0.0, which DeMo's sign() keeps at 0. No atomics: each slot has one
// owner thread.
//
// Bound: bytes. Each pick is read once (8 bytes) and each output written
// once (4 bytes); at DeMo's 64x64 signature, 200 x 2048 picks and 200 x 4096
// outputs, 6.6 MB, about 2 us at 3.35 TB/s. The design is the simple one, far
// from that bound: one block a chunk row; the block stages a chunk of the
// row's picks in shared memory, and every thread scans all of them in order
// (each read is a broadcast from one shared-memory word), adding those that
// fall in its own contiguous run of slots into per-slot sums and counts in
// shared memory. A row wider than one slot tile is done tile by tile. The
// outputs are written by the whole block from shared memory, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPickChunk = 2048;  // picks staged at a time: 16 KB
constexpr int kSlotTile = 4096;   // slots accumulated at a time: 32 KB

__global__ void __launch_bounds__(kThreads)
scatter_mean_kernel(const int* __restrict__ idx,
                    const float* __restrict__ val, int m, int e,
                    float* __restrict__ out) {
  __shared__ int s_idx[kPickChunk];
  __shared__ float s_val[kPickChunk];
  __shared__ float s_sum[kSlotTile];
  __shared__ int s_cnt[kSlotTile];

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const int* row_idx = idx + row * m;
  const float* row_val = val + row * m;
  float* row_out = out + row * e;

  for (int t0 = 0; t0 < e; t0 += kSlotTile) {
    const int tile = min(kSlotTile, e - t0);
    // this thread's slots: [lo, lo + run) of the tile
    const int run = (tile + kThreads - 1) / kThreads;
    const int lo = tid * run;
    for (int s = tid; s < tile; s += kThreads) {
      s_sum[s] = 0.0f;
      s_cnt[s] = 0;
    }
    for (int u0 = 0; u0 < m; u0 += kPickChunk) {
      const int n = min(kPickChunk, m - u0);
      __syncthreads();  // the previous chunk is scanned; zeros are visible
      for (int u = tid; u < n; u += kThreads) {
        s_idx[u] = row_idx[u0 + u];
        s_val[u] = row_val[u0 + u];
      }
      __syncthreads();
      for (int u = 0; u < n; ++u) {
        // the slot's offset in this thread's run; out-of-range slots and
        // negative ones fall outside every run
        const unsigned r = (unsigned)(s_idx[u] - t0 - lo);
        if (r < (unsigned)run) {
          s_sum[lo + r] += s_val[u];
          s_cnt[lo + r] += 1;
        }
      }
    }
    __syncthreads();
    for (int s = tid; s < tile; s += kThreads) {
      const int c = s_cnt[s];
      row_out[t0 + s] = c > 0 ? s_sum[s] / (float)c : 0.0f;
    }
    __syncthreads();  // the tile's sums are read before the next zeroing
  }
}

}  // namespace

extern "C" {

// idx int32 [g, m], val f32 [g, m], out f32 [g, e], all contiguous.
int gym_scatter_mean(const void* idx, const void* val, int g, int m, int e,
                     void* out, void* stream) {
  if (g < 0 || m < 0 || e < 1 || idx == nullptr || val == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  scatter_mean_kernel<<<(unsigned)g, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val), m, e,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
