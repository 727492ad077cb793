// planned_count: index-pruned batched counts over planned (query, block)
// pairs, the resident count of bench config 7.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:716
// (make_planned_count_step, point and overlap forms). It is not a TPU
// kernel: the reference computes it in XLA, a lax.scan over chunks of pairs
// that slices each pair's block and runs the full-scan predicate on it
// (_planned_block_mask :657). A count over pairs has no counterpart among
// the port's kernels: planned_gather.cu's count pass is compiled for
// 4096-row blocks, reads each distinct block once for all of its pairs and
// feeds a write pass, while config 7 plans at 1024 rows and needs only the
// counts.
//
// What it computes: pair p = (query pair_q[p], block pair_blk[p]) covers the
// block_rows rows [blk * block_rows, (blk + 1) * block_rows) of the resident
// columns; counts[pair_q[p]] gains the number of those rows below true_n
// that pass the query. A pair whose query is negative (pad_block_pairs'
// padding) or out of [0, q), or whose block lies outside the columns,
// counts nothing. The point form tests count_predicate.cuh's staged
// predicate (box_mask, time_mask) on x, y, bins, offs; the overlap form
// tests overlap_cull.cuh's overlap_mask and box_time_mask on xmin, ymin,
// xmax, ymax, bins, offs. Both stage the pair's query with
// count_predicate.cuh's stage_tile, so live slots and the (bin, offset)
// keys are the scan kernels' own: the inclusive semantics have one home.
//
// Bound on an H100: bytes. The function must read each distinct block's
// columns once (16 B a row, 24 B in the overlap form), however many
// queries' pairs cover it, and tests them with a few integer instructions
// a row, far below the bytes at 3.35 TB/s. The bound is n_distinct_blocks
// x block_rows x 16 (or 24) B over 3.35 TB/s; chip_smoke.py reckons it
// from the run's pairs and logs the pairs a distinct block.
//
// Design: one CTA per pair, templated on the block size (1024 or 4096 rows)
// and on the form. A point-form thread holds 16 consecutive rows of each
// column (ROWS, 16-byte loads; 64 threads a 1024-row block, 256 a 4096-row
// one), an overlap-form thread 8 (two 16-byte loads a column; 128 or 512
// threads). The loads are issued before the query is staged, so the
// staging's barriers hide under them. Each warp reduces its matches with
// __reduce_add_sync, the CTA sums its warps in shared memory and adds into
// counts[q] with one atomic. The counts are int32 (Q,) zeroed by the
// wrapper; nothing else is written. A simple kernel: each pair reads its
// block even where several queries share it, and config 7's 64 city
// queries do share blocks, so it reads more than its bound counts; a
// kernel that reads a distinct block once for all of its pairs is later
// work.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"
#include "overlap_cull.cuh"

namespace {

using namespace geomesa;

constexpr int OVERLAP_ROWS = 8;  // rows an overlap-form thread holds

template <int BR, bool OVERLAP>
struct Shape {
  static constexpr int ROWS_T = OVERLAP ? OVERLAP_ROWS : ROWS;
  static constexpr int NT = BR / ROWS_T;  // threads of the CTA
  static_assert(BR % (ROWS_T * 32) == 0, "a block is whole warps of rows");
};

// The thread's 8 consecutive rows (row0 .. row0 + 7) of the bbox columns;
// returns the mask of those below limit. The columns are a multiple of the
// block size long, so a valid block's rows are all inside them.
__device__ __forceinline__ uint32_t load_box_rows8(const BoxCols& cols, int64_t row0,
                                                   int64_t limit,
                                                   BoxRowsT<OVERLAP_ROWS>& rows) {
#pragma unroll
  for (int j = 0; j < OVERLAP_ROWS / 4; ++j) {
    const int64_t r = row0 + 4 * j;
    put4(rows.x0, j, __ldg(reinterpret_cast<const int4*>(cols.c[0] + r)));
    put4(rows.y0, j, __ldg(reinterpret_cast<const int4*>(cols.c[1] + r)));
    put4(rows.x1, j, __ldg(reinterpret_cast<const int4*>(cols.c[2] + r)));
    put4(rows.y1, j, __ldg(reinterpret_cast<const int4*>(cols.c[3] + r)));
    const int4 vb = __ldg(reinterpret_cast<const int4*>(cols.c[4] + r));
    const int4 vo = __ldg(reinterpret_cast<const int4*>(cols.c[5] + r));
    rows.key[4 * j] = time_key(vb.x, vo.x);
    rows.key[4 * j + 1] = time_key(vb.y, vo.y);
    rows.key[4 * j + 2] = time_key(vb.z, vo.z);
    rows.key[4 * j + 3] = time_key(vb.w, vo.w);
  }
  const int64_t nv = limit - row0;
  return nv >= OVERLAP_ROWS ? (1u << OVERLAP_ROWS) - 1 : (nv <= 0 ? 0u : (1u << (int)nv) - 1);
}

template <int BR, bool OVERLAP>
__global__ void __launch_bounds__(Shape<BR, OVERLAP>::NT)
planned_count_kernel(BoxCols cols, int64_t n, int64_t true_n,
                     const int32_t* __restrict__ pair_q,    // (P,)
                     const int32_t* __restrict__ pair_blk,  // (P,)
                     const int32_t* __restrict__ boxes,     // (Q, nb, 4)
                     const int32_t* __restrict__ times,     // (Q, nt, 4)
                     int q, int nb, int nt,
                     int32_t* __restrict__ counts) {        // (Q,)
  constexpr int NT = Shape<BR, OVERLAP>::NT;
  constexpr int NW = NT / 32;
  extern __shared__ int4 smem[];
  __shared__ int meta[2];
  const int64_t p = blockIdx.x;
  const int qi = pair_q[p];
  const int64_t blk = pair_blk[p];
  if (qi < 0 || qi >= q || blk < 0 || blk >= n / BR) return;  // block-uniform
  const int64_t limit = valid_limit(n, 0, true_n);
  const int64_t row0 = blk * BR + (int64_t)threadIdx.x * Shape<BR, OVERLAP>::ROWS_T;
  // the loads first: the query's staging below hides under them
  uint32_t valid;
  Rows prow;
  BoxRowsT<OVERLAP_ROWS> brow;
  if constexpr (OVERLAP) {
    valid = load_box_rows8(cols, row0, limit, brow);
  } else {
    valid = load_rows(cols.c[0], cols.c[1], cols.c[2], cols.c[3], n, limit, row0, prow);
  }
  const Tile t = carve<NW>(smem, 1, nb, nt);
  stage_tile<true, NT>(boxes, times, qi, 1, t, meta);
  uint32_t m = 0;
  if (meta[0]) {  // block-uniform: the query has a live box and a live window
    const int lv = t.live[0];
    if constexpr (OVERLAP) {
      if (meta[1]) {
        m = overlap_mask<true>(t.box, 1, brow) & valid;
        if (m) m &= box_time_mask<true>(t.win, 1, brow);
      } else {
        m = overlap_mask<false>(t.box, lv & 0xffff, brow) & valid;
        if (m) m &= box_time_mask<false>(t.win, lv >> 16, brow);
      }
    } else {
      if (meta[1]) {
        m = box_mask<true>(t.box, 1, prow) & valid;
        if (m) m &= time_mask<true>(t.win, 1, prow);
      } else {
        m = box_mask<false>(t.box, lv & 0xffff, prow) & valid;
        if (m) m &= time_mask<false>(t.win, lv >> 16, prow);
      }
    }
  }
  const int c = __reduce_add_sync(FULL_WARP, __popc(m));
  if ((threadIdx.x & 31) == 0) t.cnt[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) sum += t.cnt[w];
    if (sum) atomicAdd(&counts[qi], sum);
  }
}

template <int BR, bool OVERLAP>
cudaError_t launch(const BoxCols& cols, long long n, long long true_n, const int32_t* pair_q,
                   const int32_t* pair_blk, long long n_pairs, const int32_t* boxes,
                   const int32_t* times, int q, int nb, int nt, int32_t* counts,
                   cudaStream_t st) {
  constexpr int NT = Shape<BR, OVERLAP>::NT;
  const size_t smem = (size_t)staged_bytes_per_query(nb, nt, 0, NT / 32);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // B + T beyond any packer's slots
  planned_count_kernel<BR, OVERLAP><<<(unsigned)n_pairs, NT, smem, st>>>(
      cols, n, true_n, pair_q, pair_blk, boxes, times, q, nb, nt, counts);
  return cudaGetLastError();
}

}  // namespace

// Columns x, y, bins, offs (c4, c5 unused) or, with overlap, xmin, ymin,
// xmax, ymax, bins, offs; block_rows 1024 or 4096 and n a multiple of it;
// counts (Q,) int32, zeroed by the caller, gain each pair's matches.
extern "C" int geomesa_planned_count(const void* c0, const void* c1, const void* c2,
                                     const void* c3, const void* c4, const void* c5,
                                     long long n, long long true_n, const void* pair_q,
                                     const void* pair_blk, long long n_pairs, const void* boxes,
                                     const void* times, int q, int nb, int nt, int block_rows,
                                     int overlap, void* counts, void* stream) {
  if (n_pairs <= 0 || n <= 0 || q <= 0) return (int)cudaSuccess;
  if (n_pairs > 0x7fffffffLL || n % block_rows) return (int)cudaErrorInvalidValue;
  const BoxCols cols{{(const int32_t*)c0, (const int32_t*)c1, (const int32_t*)c2,
                      (const int32_t*)c3, (const int32_t*)c4, (const int32_t*)c5}};
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t *pq = (const int32_t*)pair_q, *pb = (const int32_t*)pair_blk;
  const int32_t *bx = (const int32_t*)boxes, *tm = (const int32_t*)times;
  int32_t* out = (int32_t*)counts;
  if (block_rows == 1024) {
    return overlap ? (int)launch<1024, true>(cols, n, true_n, pq, pb, n_pairs, bx, tm, q, nb, nt,
                                            out, st)
                   : (int)launch<1024, false>(cols, n, true_n, pq, pb, n_pairs, bx, tm, q, nb, nt,
                                             out, st);
  }
  if (block_rows == 4096) {
    return overlap ? (int)launch<4096, true>(cols, n, true_n, pq, pb, n_pairs, bx, tm, q, nb, nt,
                                            out, st)
                   : (int)launch<4096, false>(cols, n, true_n, pq, pb, n_pairs, bx, tm, q, nb, nt,
                                             out, st);
  }
  return (int)cudaErrorInvalidValue;
}
