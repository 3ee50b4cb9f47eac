// D1: DeMo's deterministic scatter-mean decode on Hopper.
//
// Replaces XLA's scatter-add in gym_tpu/ops/topk_compress.py:83-99
// (scatter_mean_decode; not a pl.pallas_call kernel), which
// gym_tpu/strategy/demo.py:305-311 runs on the gathered picks of all K
// nodes once K·k > 128. out[g, s] is the mean of the val[g, u] whose
// idx[g, u] == s, or 0.0 where there is none; picks outside [0, e) count
// in no slot.
//
// The summation order is part of the contract. Each slot's sum starts at
// 0.0f and adds its picks in increasing u, in f32, and its count likewise;
// the mean is one IEEE division. That is the order of XLA's serial
// scatter-add, so the result is bit-identical from run to run and to the
// plain twin (ops/scatter_mean.py), and v and -v sent to one slot give
// exactly 0.0, which DeMo's sign() keeps at 0. No atomics: each slot has one
// owner.
//
// Bound: bytes. Each pick is read once (8 bytes) and each output written
// once (4 bytes); at DeMo's 64x64 signature, 200 x 2048 picks and 200 x 4096
// outputs, 6.6 MB, about 2 us at 3.35 TB/s.
//
// Two kernels, one function, the same bits:
//
// scatter_mean_ref_kernel, the first kernel, kept as the oracle: one block a
// row; the block stages a chunk of the row's picks in shared memory and
// every thread scans all of them in order, adding those that fall in its own
// run of slots. A row costs m reads a thread, m x 256 a block, in one
// dependent chain of shared load, compare and branch a thread: a
// latency-bound scan.
//
// scatter_mean_kernel, the kernel of the main path: slots are owned by
// warps. A warp owns a contiguous run of a row's slots (their sums and
// counts in its own slice of shared memory) and walks the row's picks 32 at
// a time in u order, one pick a lane, loaded coalesced, the next chunk's
// loads in flight while this one is summed. Where the picks of its run
// share no slot (a claim in shared memory read back), each lane adds its
// own; where some do, __match_any_sync groups the lanes by slot and the
// lowest lane of each group adds the group's values onto the slot's
// running sum in lane order (that is u order; the values come by
// __shfl_sync), then the group's size onto the count. A warp takes m / 32
// steps where a thread of the oracle took m, and no two warps touch one
// slot, so the walk needs neither an atomic nor a block barrier. The run a
// warp owns (slots) and the warps a block holds (warps) are the launch's
// settings: blocks a row follow (grid.y), so a row of many slots is split
// over blocks and the card fills when rows are few. choose_plan picks them
// from G and E (scripts/d1_t1_sweep.py on the H100).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPickChunk = 2048;  // picks staged at a time: 16 KB
constexpr int kSlotTile = 4096;   // slots accumulated at a time: 32 KB

__global__ void __launch_bounds__(kThreads)
scatter_mean_ref_kernel(const int* __restrict__ idx,
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

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kSmemMax = 48 * 1024;         // a block's slots, no opt-in
constexpr int kMaxWarps = 8;                // a block's warps
constexpr int kBatches = 4;                 // batches of 32 picks a chunk

// A slot's running sum and count, read and written as one 8-byte word.
struct __align__(8) Slot {
  float sum;
  int count;
};
// shared memory a slot takes: its Slot and its tag
constexpr int kSlotBytes = sizeof(Slot) + sizeof(int);

// Grid (g, blocks a row), `warps` warps a block; warp w of block (row,
// y) owns the slots [lo, lo + span) with lo = (y * warps + w) * run: their
// Slots, then a tag each (the lane that last claimed the slot), in its own
// slice of dynamic shared memory. kBatches batches of 32 picks are loaded
// at a time (a chunk), the next chunk's loads in flight while this one is
// summed.
//
// The picks of a chunk that fall in the run first claim their slots in the
// tags; where every claim reads back, no two of them share a slot, and
// each lane adds its own picks onto their slots at once (one pick a slot:
// the order cannot matter). Otherwise the batches go one by one in u
// order, each the same way: where its picks share no slot, each lane adds
// its own; only a batch with a shared slot groups its lanes with
// __match_any_sync (whose time grows with the distinct slots it sorts),
// and the lowest lane of each group adds the group's values in lane order.
__global__ void __launch_bounds__(32 * kMaxWarps)
scatter_mean_kernel(const int* __restrict__ idx,
                    const float* __restrict__ val, int m, int e, int run,
                    int tiles, float* __restrict__ out) {
  extern __shared__ Slot smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  Slot* w_slot = smem + warp * run;
  int* w_tag = reinterpret_cast<int*>(smem + warps * run) + warp * run;
  const long long row = blockIdx.x;
  const int* row_idx = idx + row * m;
  const float* row_val = val + row * m;
  float* row_out = out + row * e;
  constexpr int kChunk = 32 * kBatches;

  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long first = ((long long)tile * warps + warp) * run;
    if (first >= e) break;  // so are this warp's later tiles
    const int lo = (int)first;
    const int span = min(run, e - lo);
    for (int i = lane; i < span; i += 32) w_slot[i] = Slot{0.0f, 0};
    __syncwarp();
    // lane l holds pick u0 + 32 b + l of batch b (slot -1 past m, in no
    // run)
    int slot[kBatches], next_slot[kBatches];
    float v[kBatches], next_v[kBatches];
#pragma unroll
    for (int b = 0; b < kBatches; ++b) {
      const int u = 32 * b + lane;
      next_slot[b] = u < m ? __ldg(row_idx + u) : -1;
      next_v[b] = u < m ? __ldg(row_val + u) : 0.0f;
    }
    for (int u0 = 0; u0 < m; u0 += kChunk) {
#pragma unroll
      for (int b = 0; b < kBatches; ++b) {
        slot[b] = next_slot[b];
        v[b] = next_v[b];
      }
      if (m - u0 > kChunk) {
#pragma unroll
        for (int b = 0; b < kBatches; ++b) {
          const int u = u0 + kChunk + 32 * b + lane;
          next_slot[b] = u < m ? __ldg(row_idx + u) : -1;
          next_v[b] = u < m ? __ldg(row_val + u) : 0.0f;
        }
      }
      // which lanes of each batch hold a pick of this warp's run
      unsigned in[kBatches];
#pragma unroll
      for (int b = 0; b < kBatches; ++b)
        in[b] = __ballot_sync(
            kFull, (unsigned)slot[b] - (unsigned)lo < (unsigned)span);
      unsigned any = 0u;
#pragma unroll
      for (int b = 0; b < kBatches; ++b) any |= in[b];
      if (any == 0u) continue;
      // every pick of the chunk claims its slot in the tags; where every
      // claim reads back, no two picks of the chunk share a slot, and each
      // lane adds its own picks onto their slots at once
#pragma unroll
      for (int b = 0; b < kBatches; ++b)
        if ((in[b] >> lane) & 1u)
          w_tag[(unsigned)slot[b] - (unsigned)lo] = (b << 5) | lane;
      __syncwarp();
      bool lost = false;
#pragma unroll
      for (int b = 0; b < kBatches; ++b)
        lost |= ((in[b] >> lane) & 1u) &&
                w_tag[(unsigned)slot[b] - (unsigned)lo] != ((b << 5) | lane);
      if (!__any_sync(kFull, lost)) {
#pragma unroll
        for (int b = 0; b < kBatches; ++b)
          if ((in[b] >> lane) & 1u) {
            Slot& t = w_slot[(unsigned)slot[b] - (unsigned)lo];
            Slot s = t;
            s.sum += v[b];
            s.count += 1;
            t = s;
          }
        __syncwarp();  // this chunk's sums before the next chunk's claims
        continue;
      }
      __syncwarp();  // the chunk's claims are read before a batch's claims
      // the batches in u order
#pragma unroll
      for (int b = 0; b < kBatches; ++b) {
        if (in[b] == 0u) continue;
        const bool mine = (in[b] >> lane) & 1u;
        const unsigned r = (unsigned)slot[b] - (unsigned)lo;
        bool shared = false;
        if (__popc(in[b]) > 1) {
          if (mine) w_tag[r] = lane;
          __syncwarp();
          shared = __any_sync(kFull, mine && w_tag[r] != lane);
        }
        if (!shared) {  // one lane a slot: each adds its own pick
          if (mine) {
            Slot s = w_slot[r];
            s.sum += v[b];
            s.count += 1;
            w_slot[r] = s;
          }
        } else {  // groups by slot; the lowest lane adds in lane order
          const unsigned peers = mine ? __match_any_sync(in[b], slot[b])
                                      : 0u;
          const bool lead = mine && __ffs(peers) - 1 == lane;
          Slot s = lead ? w_slot[r] : Slot{0.0f, 0};
          unsigned rest = peers;
          do {
            const int src = __ffs(rest) - 1;  // the lowest lane left
            const float x = __shfl_sync(kFull, v[b], src & 31);
            if (rest != 0u) {
              s.sum += x;
              rest ^= 1u << src;
            }
          } while (__any_sync(kFull, rest != 0u));
          if (lead) {
            s.count += __popc(peers);
            w_slot[r] = s;
          }
        }
        __syncwarp();  // this batch's sums and tags before the next batch
      }
    }
    for (int i = lane; i < span; i += 32) {
      const Slot s = w_slot[i];
      row_out[lo + i] = s.count > 0 ? s.sum / (float)s.count : 0.0f;
    }
    __syncwarp();  // the means are read before the next tile's zeros
  }
}

// The launch of scatter_mean_kernel for g rows of e slots, from at most
// `slots` a warp and `warps` a block (0: choose_plan's): each warp's run of
// slots (balanced over the warps a row needs), the warps a block, the
// blocks a row (tiles; the grid's y at most 65535, the kernel strides over
// the rest) and the block's dynamic shared memory.
struct Plan {
  int run, warps, tiles, grid_y, smem;
};

// the settings scripts/d1_t1_sweep.py picked on the H100 at DeMo's rows
// (config 5's (G, m, E) = (200, 2048, 4096), (108, 2048, 64), (4, 2048,
// 2112)): runs of about G·E / 2048 slots, a power of 2 from 4 to 2048, so
// that the grid holds some 2048 warps whatever the rows, and 4 warps a
// block
void choose_plan(int g, int e, int* slots, int* warps) {
  if (*slots <= 0) {
    const long long want = ((long long)g * e + 2047) / 2048;
    int run = 4;
    while (run < 2048 && run < want) run *= 2;
    *slots = run;
  }
  if (*warps <= 0) *warps = 4;
}

int make_plan(int g, int e, int slots, int warps, Plan* plan) {
  choose_plan(g, e, &slots, &warps);
  if (slots > kSmemMax / kSlotBytes || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const long long need = ((long long)e + slots - 1) / slots;  // warps a row
  plan->run = (int)(((long long)e + need - 1) / need);
  plan->warps = (int)(need < warps ? need : warps);
  while (plan->warps > 1 && plan->warps * plan->run * kSlotBytes > kSmemMax)
    --plan->warps;
  const long long tiles = (need + plan->warps - 1) / plan->warps;
  plan->tiles = (int)tiles;
  plan->grid_y = (int)(tiles < 65535 ? tiles : 65535);
  plan->smem = plan->warps * plan->run * kSlotBytes;
  return 0;
}

// an empty row of picks may come without a buffer
bool bad_args(const void* idx, const void* val, int g, int m, int e,
              const void* out) {
  return g < 0 || m < 0 || e < 1 ||
         (g > 0 && (out == nullptr ||
                    (m > 0 && (idx == nullptr || val == nullptr))));
}

}  // namespace

extern "C" {

// idx int32 [g, m], val f32 [g, m], out f32 [g, e], all contiguous; slots
// and warps as make_plan takes them (0: the defaults).
int gym_scatter_mean(const void* idx, const void* val, int g, int m, int e,
                     int slots, int warps, void* out, void* stream) {
  if (bad_args(idx, val, g, m, e, out)) return (int)cudaErrorInvalidValue;
  Plan p;
  if (int err = make_plan(g, e, slots, warps, &p)) return err;
  if (g == 0) return 0;
  scatter_mean_kernel<<<dim3((unsigned)g, (unsigned)p.grid_y), 32 * p.warps,
                        p.smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val), m, e,
      p.run, p.tiles, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// plan[4] = {run, warps a block, blocks a row, shared memory bytes} of
// gym_scatter_mean's launch at g rows of e slots.
int gym_scatter_mean_plan(int g, int e, int slots, int warps, int* plan) {
  if (g < 0 || e < 1 || plan == nullptr) return (int)cudaErrorInvalidValue;
  Plan p;
  if (int err = make_plan(g, e, slots, warps, &p)) return err;
  plan[0] = p.run;
  plan[1] = p.warps;
  plan[2] = p.tiles;
  plan[3] = p.smem;
  return 0;
}

// The oracle: the first kernel, gym_scatter_mean's function without its
// settings.
int gym_scatter_mean_ref(const void* idx, const void* val, int g, int m,
                         int e, void* out, void* stream) {
  if (bad_args(idx, val, g, m, e, out)) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  scatter_mean_ref_kernel<<<(unsigned)g, kThreads, 0,
                            (cudaStream_t)stream>>>(
      static_cast<const int*>(idx), static_cast<const float*>(val), m, e,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
