// batched_edge_gather: Q bbox+time count queries over int32 point columns,
// plus each query's edge candidates, one pass: the device half of the exact
// batched count_many(loose=False).
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:342
// (make_batched_edge_gather_step; per-slot predicates _slot_point :309 and
// _slot_time_edge :331). It is not a TPU kernel: the reference computes it in
// XLA. It is written by hand because its eager torch form would do at least
// the work of batched_count_plain (1.3 s at 50M rows and 64 queries on an
// H100) where batched_count's kernel takes under 1 ms.
//
// What it computes, per query q and row r (local position lpos):
//   in_all   = in_box & in_time & valid            (batched_count's predicate)
//   on_edge  = OR over box slots k of inside_k & (x == xlo_k | x == xhi_k |
//                                                 y == ylo_k | y == yhi_k)
//   time_edge = OR over time slots k of valid_k & ((bin, off) == (blo_k, olo_k)
//                                                 | (bin, off) == (bhi_k, ohi_k))
//   candidate = in_all & (on_edge | time_edge)
// Outputs: counts[q] = sum of in_all (equal to batched_count's); hits[q] =
// the TRUE number of candidates (it may exceed the capacity); pos[q][0..cap)
// = global positions base + lpos of min(hits, cap) of the candidates, in no
// particular order (the wrapper sorts them), -1 beyond (the wrapper fills pos
// with -1 and zeroes counts and hits before the launch). When hits[q] > cap
// the lanes hold some subset of the candidates and the caller falls back.
//
// The edge tests on the staged slots of count_predicate.cuh. A live box is
// staged as (xlo, xhi - xlo, ylo, yhi - ylo): with dx = (uint32)(x - xlo),
// x == xlo is dx == 0 and x == xhi is dx == (uint32)(xhi - xlo), because the
// wrapping subtract is a bijection of the 32-bit words. A time endpoint is
// key == lo key or key == hi key of a live window. Dead slots have no inside
// rows and no valid window, so live-slot staging drops nothing the edges
// need. The edge tests run only for rows that matched (in_all), in warps
// that have one, after the shared row scan.
//
// Append: each thread collects the bitmask of its candidate rows; the warp
// takes an inclusive prefix sum of their counts (five shuffles) and one lane
// adds the warp's total to the query's cursor hits[q] with one atomicAdd,
// which keeps counting past the capacity. Counts are per-warp
// __reduce_add_sync partials in shared memory, added with one atomicAdd per
// (block, query), as in batched_count.cu.
//
// Bound on an H100: batched_count's (integer instructions by pipe, above the
// 16 B/row of column reads), plus the edge compares per matched (row, query)
// and live slot and 4 B per written candidate. chip_smoke.py reckons it from
// the run's inputs.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace {

using namespace geomesa;

__device__ unsigned long long g_path_blocks[2];

// Bit r: matched row r (bit r of m) lies on an edge bucket of a live box it
// is inside, or at an endpoint of a live window.
__device__ __forceinline__ uint32_t edge_mask(const Tile& t, int qi, uint32_t m,
                                              const Rows& rows) {
  const int lv = t.live[qi];
  uint32_t e = 0;
  const int4* box = t.box + qi * t.nb;
  for (int k = 0; k < (lv & 0xffff); ++k) {
    const int4 b = box[k];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const uint32_t dx = (uint32_t)rows.x[r] - (uint32_t)b.x;
      const uint32_t dy = (uint32_t)rows.y[r] - (uint32_t)b.z;
      if (dx <= (uint32_t)b.y && dy <= (uint32_t)b.w &&
          (dx == 0 || dx == (uint32_t)b.y || dy == 0 || dy == (uint32_t)b.w))
        e |= 1u << r;
    }
  }
  const longlong2* win = t.win + qi * t.nt;
  for (int k = 0; k < (lv >> 16); ++k) {
    const longlong2 w = win[k];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (rows.key[r] == w.x || rows.key[r] == w.y) e |= 1u << r;
    }
  }
  return e & m;
}

struct EdgeEpilogue {
  Tile t;
  int q0, cap;
  int64_t base;
  int32_t* hits;  // (Q,): candidate cursor, the true count at the end
  int32_t* pos;   // (Q, cap)
  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t row0,
                                             const Rows& rows) const {
    const unsigned c = __reduce_add_sync(FULL_WARP, __popc(m));
    if (c == 0) return;  // warp-uniform
    const int lane = threadIdx.x & 31;
    if (lane == 0) t.cnt[(threadIdx.x >> 5) * t.q_tile + qi] += c;
    uint32_t e = m ? edge_mask(t, qi, m, rows) : 0u;
    const unsigned ne = __popc(e);
    unsigned incl = ne;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned v = __shfl_up_sync(FULL_WARP, incl, d);
      if (lane >= d) incl += v;
    }
    const unsigned total = __shfl_sync(FULL_WARP, incl, 31);
    if (total == 0) return;  // warp-uniform
    int start = 0;
    if (lane == 31) start = atomicAdd(hits + q0 + qi, (int)total);
    int slot = __shfl_sync(FULL_WARP, start, 31) + (int)(incl - ne);
    int32_t* out = pos + (int64_t)(q0 + qi) * cap;
    // the wrapper guarantees base + n < 2^31: positions are int32
    const int32_t gpos0 = (int32_t)(base + row0);
    while (e && slot < cap) {
      const int r = __ffs(e) - 1;
      e &= e - 1;
      out[slot++] = gpos0 + r;
    }
  }
};

__global__ void __launch_bounds__(THREADS, 2)
batched_edge_gather_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                           const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                           int64_t n, int64_t base, int64_t true_n,
                           const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                           const int32_t* __restrict__ times,  // (Q, nt, 4)
                           int q, int nb, int nt, int q_tile,
                           int32_t* __restrict__ counts,       // (Q,)
                           int32_t* __restrict__ hits,         // (Q,)
                           int32_t* __restrict__ pos,          // (Q, cap)
                           int cap) {
  extern __shared__ int4 smem[];
  __shared__ int meta[2];
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  const Tile t = carve(smem, q_tile, nb, nt);
  stage_tile(boxes, times, q0, qt, t, meta);
  const int n_active = meta[0];
  const int64_t limit = valid_limit(n, base, true_n);
  EdgeEpilogue ep{t, q0, cap, base, hits, pos};
  if (n_active > 0) {
    note_path(g_path_blocks, meta[1]);
    if (meta[1])
      scan_rows<true>(x, y, bins, offs, n, limit, t, n_active, ep);
    else
      scan_rows<false>(x, y, bins, offs, n, limit, t, n_active, ep);
  }
  __syncthreads();
  for (int qi = threadIdx.x; qi < qt; qi += THREADS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += t.cnt[w * q_tile + qi];
    if (sum) atomicAdd(&counts[q0 + qi], sum);
  }
}

}  // namespace

extern "C" int geomesa_batched_edge_gather_q_tile(int nb, int nt) {
  return q_tile_for(nb, nt, 0);
}

// Copies the per-path block counts ([0] <1, 1>, [1] general) since the last
// call into out (host, 2 x uint64) and zeroes them; synchronises the device.
extern "C" int geomesa_batched_edge_gather_path_blocks(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_path_blocks, sizeof(g_path_blocks));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_path_blocks, zero, sizeof(zero));
}

extern "C" int geomesa_batched_edge_gather(const void* x, const void* y, const void* bins,
                                           const void* offs, long long n, long long base,
                                           long long true_n, const void* boxes,
                                           const void* times, int q, int nb, int nt,
                                           int sms, void* counts, void* hits, void* pos,
                                           int cap, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int q_tile = q < q_tile_for(nb, nt, 0) ? q : q_tile_for(nb, nt, 0);
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const size_t smem = (size_t)q_tile * staged_bytes_per_query(nb, nt, 0);
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, batched_edge_gather_kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  dim3 grid((unsigned)(chunks < resident ? chunks : resident), q_tiles);
  batched_edge_gather_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
      (const int32_t*)offs, n, base, true_n, (const int32_t*)boxes,
      (const int32_t*)times, q, nb, nt, q_tile, (int32_t*)counts, (int32_t*)hits,
      (int32_t*)pos, cap);
  return (int)cudaGetLastError();
}
