// planned_gather: batched row retrieval over planned (query, block) pairs,
// the device half of select_many.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:820
// (make_planned_gather_step; its count step make_planned_count_step :716
// only sizes the reference's static buffer). It is not a TPU kernel: the
// reference computes it in XLA. The port's eager torch form
// (ops.kernels.planned_gather_plain) runs about 24 slot passes of small ops
// per chunk of pairs plus a boolean index that syncs with the host each
// chunk; this kernel does the same work in two launches and one read of a
// total.
//
// What it computes: pair p = (query pair_q[p], block pair_blk[p]) covers
// the JOIN_BLOCK rows [blk * JOIN_BLOCK, (blk + 1) * JOIN_BLOCK) of the
// resident columns; pair_hits[p] is the number of those rows below true_n
// that pass query pair_q[p]'s boxes and windows (count_predicate.cuh's
// predicate), and positions[offsets[p] ..] their global positions in row
// order. offsets is the exclusive prefix sum of pair_hits (the wrapper takes
// it with one torch.cumsum and sizes positions from its total).
//
// Bound on an H100: bytes. Each distinct block is read once at least (16 B a
// row), plus the pair lists in, the pair counts out and 8 B per written
// position; the predicate on pairs x 4096 rows is a few integer
// instructions per row and query. chip_smoke.py reckons both from the run's
// pairs.
//
// Design: one 256-thread block per pair; a pair's block of JOIN_BLOCK rows
// is exactly one chunk of 16 consecutive rows a thread, loaded as 16-byte
// vectors before the block stages its pair's query (stage_tile with one
// query: live slots only, a dead query writes no row), so the loads are in
// flight during the staging. The count pass writes pair_hits; the write
// pass recomputes the mask and places each thread's rows at the pair's
// offset plus a block-wide exclusive scan of the per-thread popcounts (warp
// shuffles, then one shared step): rows go out in row order within a pair,
// with no atomics, so the output is deterministic. The write pass reads no
// column for a pair that matched no row or every row of its block (then its
// positions are the block's rows): pairs inside a query's box and window
// cost a 32 KB store instead of a 64 KB read. A pair whose query or
// block lies out of range counts 0 and writes nothing (the caller checks
// the ranges; this keeps every read inside the columns).
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing, returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace {

using namespace geomesa;

constexpr int JOIN_BLOCK = 4096;  // ops/kernels.py JOIN_BLOCK
static_assert(JOIN_BLOCK == CHUNK, "one pair's block is one chunk of THREADS x ROWS rows");

template <bool WRITE>
__global__ void __launch_bounds__(THREADS, 2)
planned_gather_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                      const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                      int64_t n, int64_t true_n,
                      const int32_t* __restrict__ pair_q,    // (P,)
                      const int32_t* __restrict__ pair_blk,  // (P,)
                      const int32_t* __restrict__ boxes,     // (Q, nb, 4)
                      const int32_t* __restrict__ times,     // (Q, nt, 4)
                      int q, int nb, int nt,
                      int64_t* __restrict__ pair_hits,        // (P,): the count pass's output,
                                                              // the write pass's input
                      const int64_t* __restrict__ offsets,    // (P,), the write pass's input
                      int64_t* __restrict__ positions) {      // (H,)
  extern __shared__ int4 smem[];
  __shared__ int meta[2];
  __shared__ int warp_sum[WARPS];
  const int64_t p = blockIdx.x;
  const int qi = pair_q[p];
  const int64_t blk = pair_blk[p];
  if (qi < 0 || qi >= q || blk < 0 || blk >= n / JOIN_BLOCK) {  // block-uniform
    if (!WRITE && threadIdx.x == 0) pair_hits[p] = 0;
    return;
  }
  if (WRITE) {  // block-uniform shortcuts that read no column
    const int64_t hits = pair_hits[p];
    if (hits == 0) return;
    if (hits == JOIN_BLOCK) {  // every row matched: the block's rows, in order
      int64_t* out = positions + offsets[p];
      for (int i = threadIdx.x; i < JOIN_BLOCK; i += THREADS) out[i] = blk * JOIN_BLOCK + i;
      return;
    }
  }
  const int64_t row0 = blk * JOIN_BLOCK + (int64_t)threadIdx.x * ROWS;
  Rows rows;
  const uint32_t valid = load_rows(x, y, bins, offs, n, valid_limit(n, 0, true_n), row0, rows);
  const Tile t = carve(smem, 1, nb, nt);
  stage_tile(boxes, times, qi, 1, t, meta);
  uint32_t m = 0;
  if (meta[0]) {  // block-uniform: the query has a live box and a live window
    const int lv = t.live[0];
    m = (meta[1] ? box_mask<true>(t.box, 1, rows) : box_mask<false>(t.box, lv & 0xffff, rows)) &
        valid;
    if (m)
      m &= meta[1] ? time_mask<true>(t.win, 1, rows) : time_mask<false>(t.win, lv >> 16, rows);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = __popc(m);
  int incl = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL_WARP, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (!WRITE) {
    if (threadIdx.x == 0) {
      int64_t total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) total += warp_sum[w];
      pair_hits[p] = total;
    }
    return;
  }
  int before = incl - c;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  int64_t* out = positions + offsets[p] + before;
  while (m) {
    const int r = __ffs(m) - 1;
    m &= m - 1;
    *out++ = row0 + r;
  }
}

}  // namespace

// offsets == nullptr: the count pass (writes pair_hits); otherwise the write
// pass (reads pair_hits and offsets, writes positions).
extern "C" int geomesa_planned_gather(const void* x, const void* y, const void* bins,
                                      const void* offs, long long n, long long true_n,
                                      const void* pair_q, const void* pair_blk, long long n_pairs,
                                      const void* boxes, const void* times, int q, int nb,
                                      int nt, void* pair_hits, const void* offsets,
                                      void* positions, void* stream) {
  if (n_pairs <= 0 || q <= 0 || n <= 0) return (int)cudaSuccess;
  if (n_pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)staged_bytes_per_query(nb, nt, 0);
  const dim3 grid((unsigned)n_pairs);
  if (offsets == nullptr)
    planned_gather_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins, (const int32_t*)offs, n,
        true_n, (const int32_t*)pair_q, (const int32_t*)pair_blk, (const int32_t*)boxes,
        (const int32_t*)times, q, nb, nt, (int64_t*)pair_hits, nullptr, nullptr);
  else
    planned_gather_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins, (const int32_t*)offs, n,
        true_n, (const int32_t*)pair_q, (const int32_t*)pair_blk, (const int32_t*)boxes,
        (const int32_t*)times, q, nb, nt, (int64_t*)pair_hits, (const int64_t*)offsets,
        (int64_t*)positions);
  return (int)cudaGetLastError();
}
