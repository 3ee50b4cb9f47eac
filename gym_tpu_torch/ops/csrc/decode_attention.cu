// B7: the serving path's decode attention on Hopper, f32, paged or not.
//
// Replaces XLA's einsum-mask-softmax-einsum of the KV-cache attends in
// gym_tpu/models/nanogpt.py: _decode_attend (:370-383) and
// _decode_attend_paged (:478-492). Neither is a pl.pallas_call kernel; in
// eager PyTorch the same code would gather a whole [b, S, H, hd] window of
// the page pool for every layer and step, whatever each row's cursor is.
//
// Inputs: q [b, t, H, hd] (rows and tokens strided, heads and head dims
// contiguous, as a view of the qkv projection gives them); the K and V pools
// [P, page, H, hd]; a block table [b, nblk] of physical page ids; the cursors
// [b]. Query j of row r sits at logical position cursor[r] + j and attends to
// the logical positions 0 .. min(cursor[r] + j, S - 1), S = nblk * page:
// position p lives in page table[r][p / page] at offset p % page. The
// per-row cache of the unpaged path is the same thing: b pages of size S,
// row r's table [r].
//
// The contract that keeps the serving engine's token streams equal (one
// slot alone and among 16, a prompt and its padded bucket, one position and
// a verify chunk, paged and unpaged): a query's result depends only on its
// q, its position and the K and V at its logical positions. Each query is
// one block's work from start to end, and its arithmetic is fixed by its
// logical positions alone: keys in chunks of 32 aligned at position 0, one
// key a lane, chunk c taken by warp c % W of the block's W warps (4; 2 at
// hd 128); each score a sequential FMA chain over the head dims; each
// warp's online softmax over its chunks in order, with an exact chunk
// maximum and an xor-butterfly chunk sum (every lane gets the same bits),
// and each output element a sequential FMA chain over a chunk's keys in
// position order; the W partial results combined in warp order. Nothing
// depends on t, the batch, the page size or the page ids, and keys past
// the query's last position are never read. No atomics.
//
// Bound: bytes. A decode step of GPT-2 base at 16 slots reads each row's K
// and V once a head (16 rows x ~300 positions x 12 heads x 64 x 4 B x 2,
// ~29.5 MB, ~8.8 us at 3.35 TB/s). The design is the simple one, far from
// that bound: one block a (row, head, query), its warps splitting the
// query's chunks, K staged a chunk at a time in shared memory (rows padded
// by one word: lane l reads key l without bank conflicts), V read from
// global memory as each lane's head dims of one key at a time (coalesced
// across the warp). A prefill chunk reads its keys once a query.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // keys a step: one a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int m = 16; m; m >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

// the xor butterfly: lane i adds lane i^m's value, and a + b == b + a, so
// every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

template <int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    decode_attention_kernel(const float* __restrict__ q, long long q_sb,
                            long long q_st, const float* __restrict__ kp,
                            const float* __restrict__ vp,
                            const int* __restrict__ table, int nblk,
                            int page, const int* __restrict__ cursor, int t,
                            int H, float scale_div, float* __restrict__ out) {
  constexpr int DPL = HD >= 32 ? HD / 32 : 1;  // head dims a lane
  __shared__ float ks[WARPS][kChunk][HD + 1];
  __shared__ float qs[HD];
  __shared__ float ps[WARPS][kChunk];
  __shared__ long long offs[WARPS][kChunk];
  __shared__ float part_m[WARPS], part_l[WARPS];
  __shared__ float part_o[WARPS][HD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int S = nblk * page;
  const int last = min(cursor[r] + j, S - 1);
  const float* qrow = q + r * q_sb + j * q_st + h * HD;
  for (int d = threadIdx.x; d < HD; d += WARPS * 32) qs[d] = qrow[d];
  const int* tab = table + (long long)r * nblk;
  const long long pos_stride = (long long)H * HD;  // floats a position
  float m = -INFINITY, l = 0.f;
  float o[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) o[i] = 0.f;
  __syncthreads();
  for (int c0 = warp * kChunk; c0 <= last; c0 += WARPS * kChunk) {
    const int nk = min(kChunk, last - c0 + 1);
    if (lane < nk) {
      const int p = c0 + lane;
      offs[warp][lane] =
          ((long long)tab[p / page] * page + p % page) * pos_stride + h * HD;
    }
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < nk; ++key) {
      const float* krow = kp + offs[warp][key];
#pragma unroll
      for (int d = lane; d < HD; d += 32) ks[warp][key][d] = krow[d];
    }
    __syncwarp();
    float s = -INFINITY;
    if (lane < nk) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qs[d], ks[warp][lane][d], acc);
      s = acc / scale_div;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);  // 0 at the warp's first chunk
    const float p = lane < nk ? expf(s - m_new) : 0.f;
    l = l * alpha + warp_sum(p);
    ps[warp][lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        float acc = 0.f;
#pragma unroll 4
        for (int key = 0; key < nk; ++key)
          acc = fmaf(ps[warp][key], vp[offs[warp][key] + d], acc);
        o[i] = o[i] * alpha + acc;
      }
    }
    m = m_new;
    __syncwarp();
  }
  // the warps' partial results, combined in warp order (a warp with no
  // chunk holds m = -inf, l = 0, o = 0 and weighs exp(-inf) = 0)
  if (lane == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) part_o[warp][d] = o[i];
  }
  __syncthreads();
  if (warp != 0) return;
  float mx = part_m[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, part_m[w]);
  float wt[WARPS], lt = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    wt[w] = expf(part_m[w] - mx);
    lt = fmaf(part_l[w], wt[w], lt);
  }
  float* orow = out + (((long long)r * t + j) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) acc = fmaf(part_o[w][d], wt[w], acc);
      orow[d] = acc / lt;
    }
  }
}

template <int HD, int WARPS>
int launch(const float* q, long long q_sb, long long q_st, const float* kp,
           const float* vp, const int* table, int nblk, int page,
           const int* cursor, int b, int t, int H, float scale_div,
           float* out, cudaStream_t stream) {
  const dim3 grid(t, H, b);
  decode_attention_kernel<HD, WARPS><<<grid, WARPS * 32, 0, stream>>>(
      q, q_sb, q_st, kp, vp, table, nblk, page, cursor, t, H, scale_div,
      out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [b, t, H, hd] contiguous = attention of q over the K and V pools
// [P, page, H, hd] (contiguous) through table [b, nblk] and cursor [b]
// (int32); q's element (r, j, h, d) at q[r * q_sb + j * q_st + h * hd + d].
// Scores are q.k / scale_div.
int gym_decode_attention(const void* q, long long q_sb, long long q_st,
                         const void* k_pool, const void* v_pool,
                         const void* table, int nblk, int page,
                         const void* cursor, int b, int t, int H, int hd,
                         float scale_div, void* out, void* stream) {
  if (b <= 0 || t <= 0 || H <= 0 || nblk <= 0 || page <= 0 || b > 65535 ||
      H > 65535 || (long long)nblk * page > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* tb = static_cast<const int*>(table);
  const int* cu = static_cast<const int*>(cursor);
  float* of = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return launch<16, 4>(qf, q_sb, q_st, kf, vf, tb, nblk, page, cu, b, t,
                           H, scale_div, of, s);
    case 32:
      return launch<32, 4>(qf, q_sb, q_st, kf, vf, tb, nblk, page, cu, b, t,
                           H, scale_div, of, s);
    case 64:
      return launch<64, 4>(qf, q_sb, q_st, kf, vf, tb, nblk, page, cu, b, t,
                           H, scale_div, of, s);
    case 128:
      return launch<128, 2>(qf, q_sb, q_st, kf, vf, tb, nblk, page, cu, b,
                            t, H, scale_div, of, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
