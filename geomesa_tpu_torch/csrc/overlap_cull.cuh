// overlap_cull.cuh: the bbox-overlap row predicate of extended-geometry
// stores, its culled chunk scan and its edge test, for batched_overlap.cu,
// the overlap instance of batched_edge_gather.cu and the overlap count pass
// of planned_gather.cu.
//
// The device counterpart of the reference's overlap mode
// (geomesa_tpu/parallel/query.py: make_batched_overlap_step :914,
// _slot_overlap :316, _batched_overlap_masks :636). A store of lines or
// polygons keeps each feature's bbox as four int32 columns in the
// normalized 31-bit domain, (xmin, ymin, xmax, ymax), beside the time
// columns (bins, offs) of count_predicate.cuh; a feature with no finite
// bounds is stamped xmin = ymin = INT32_MAX, xmax = ymax = -1 and matches
// no query box (store/backends.py). Row r matches query q when
//   ANY live box slot k:  xmin <= qxhi  AND  xmax >= qxlo
//                    AND  ymin <= qyhi  AND  ymax >= qylo
//   AND (with time) ANY live window k (count_predicate.cuh's test)
//   AND lpos < n  AND  base + lpos < true_n.
//
// Slot liveness. The tile is staged by count_predicate.cuh's stage_tile, so
// a box slot is live iff xlo <= xhi && ylo <= yhi and is held as (xlo, xhi
// - xlo, ylo, yhi - ylo); the overlap test takes xhi back as the wrapping
// sum xlo + (xhi - xlo), which is exact. Unlike containment, an inverted
// box could overlap a wide row, so dropping it is a rule of this predicate
// and not a free consequence of it: the plain versions
// (ops/kernels.py overlap_masks) drop the same slots. Both paddings of
// ops/refine.py, [1, 0, 1, 0] and the overlap pad [INT32_MAX, -1,
// INT32_MAX, -1], are inverted and so dead; every box the packers make
// from a query has lo <= hi, so on packed payloads this is the reference's
// predicate. The no-time form (bench config 5's step) stages no windows
// (stage_tile<false>) and reads no time columns.
//
// The cull. A chunk's extent is (min xmin, max xmax, min ymin, max ymax)
// and, with time, the key's min and max, over every loaded row, valid or
// not (rows past n arrive as zeros). chunk_cull.cuh's meets() on that
// extent is an exact superset for overlap: a row that overlaps live box q
// has xmin <= qxhi and xmax >= qxlo, so min xmin <= qxhi and max xmax >=
// qxlo, and the same in y. A stamped row (xmin = INT32_MAX, xmax = -1)
// widens neither the min of xmin nor the max of xmax, so it needs no
// special case and does not loosen its chunk's extent.
//
// Staging. Four (no time) or six int32 columns of a 4096-row chunk, 64 or
// 96 KB, go through dynamic shared memory with cp.async in chunk_cull.cuh's
// layout ([column][group][thread]; bit r of a thread's masks is chunk row
// chunk_row(r)), prefetched one chunk ahead. A thread's rows stay in
// registers for the tests: 64 (no time) or 96 registers of rows, so the
// kernels are built for one 256-thread block per SM at least.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_cull.cuh"
#include "count_predicate.cuh"

namespace geomesa {

// The resident bbox columns in the reference's spatial_cols order; bins and
// offs are null in the no-time form.
struct BoxCols {
  const int32_t* c[6];  // xmin, ymin, xmax, ymax, bins, offs
};

template <bool TIME>
struct BoxLayout {
  static constexpr int COLS = TIME ? 6 : 4;
  static constexpr int BUF_BYTES = COLS * CHUNK * 4;  // one chunk of every column
};

// The ROWS rows of one thread: bounds and time keys (unused without time).
struct BoxRows {
  int32_t x0[ROWS], y0[ROWS], x1[ROWS], y1[ROWS];
  long long key[ROWS];
};

// Starts the copy of chunk c's rows of the thread into buf (laid out
// [column][group][thread]); rows at n or past it arrive as zeros.
template <bool TIME>
__device__ __forceinline__ void prefetch_box_chunk(int4* buf, const BoxCols& cols, int64_t n,
                                                   int64_t c) {
  const int64_t row0 = c * CHUNK + 4 * (int64_t)threadIdx.x;
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int64_t row = row0 + (int64_t)j * GROUP_ROWS;
    const int64_t left = n - row;
    const int bytes = left >= 4 ? 16 : (left <= 0 ? 0 : (int)left * 4);
    const int64_t at = bytes ? row : 0;  // no byte is read when bytes == 0
#pragma unroll
    for (int k = 0; k < BoxLayout<TIME>::COLS; ++k)
      cp_async16(buf + (k * GROUPS + j) * THREADS + threadIdx.x, cols.c[k] + at, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void put4(int32_t (&v)[ROWS], int j, const int4 q) {
  v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
}

// Waits for the thread's copies and takes its rows into registers; returns
// the mask of its rows below limit (chunk rows start at chunk0).
template <bool TIME>
__device__ __forceinline__ uint32_t take_box_chunk(const int4* buf, int64_t chunk0, int64_t limit,
                                                   BoxRows& rows) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    put4(rows.x0, j, buf[(0 * GROUPS + j) * THREADS + threadIdx.x]);
    put4(rows.y0, j, buf[(1 * GROUPS + j) * THREADS + threadIdx.x]);
    put4(rows.x1, j, buf[(2 * GROUPS + j) * THREADS + threadIdx.x]);
    put4(rows.y1, j, buf[(3 * GROUPS + j) * THREADS + threadIdx.x]);
    if constexpr (TIME) {
      const int4 vb = buf[(4 * GROUPS + j) * THREADS + threadIdx.x];
      const int4 vo = buf[(5 * GROUPS + j) * THREADS + threadIdx.x];
      rows.key[4 * j] = time_key(vb.x, vo.x);
      rows.key[4 * j + 1] = time_key(vb.y, vo.y);
      rows.key[4 * j + 2] = time_key(vb.z, vo.z);
      rows.key[4 * j + 3] = time_key(vb.w, vo.w);
    }
    const int64_t nv = limit - (chunk0 + (int64_t)j * GROUP_ROWS + 4 * threadIdx.x);
    valid |= (nv >= 4 ? 0xfu : (nv <= 0 ? 0u : (1u << (int)nv) - 1)) << (4 * j);
  }
  return valid;
}

// Loads the ROWS consecutive rows of a thread from row0 into registers
// (count_predicate.cuh's layout: bit r is row row0 + r); returns the mask of
// its rows below limit. The planned gather's overlap count pass reads a
// block this way, once.
__device__ __forceinline__ uint32_t load_box_rows(const BoxCols& cols, int64_t n, int64_t limit,
                                                  int64_t row0, BoxRows& rows) {
  int32_t b[ROWS], o[ROWS];
  load_col(cols.c[0], row0, n, rows.x0);
  load_col(cols.c[1], row0, n, rows.y0);
  load_col(cols.c[2], row0, n, rows.x1);
  load_col(cols.c[3], row0, n, rows.y1);
  load_col(cols.c[4], row0, n, b);
  load_col(cols.c[5], row0, n, o);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) rows.key[r] = time_key(b[r], o[r]);
  const int64_t nv = limit - row0;
  return nv >= ROWS ? (1u << ROWS) - 1 : (nv <= 0 ? 0u : (1u << (int)nv) - 1);
}

// The warp's extent of its lanes' rows (every lane gets it): min xmin, max
// xmax, min ymin, max ymax and, with time, the key's min and max.
template <bool TIME>
__device__ __forceinline__ Extent box_warp_extent(const BoxRows& rows) {
  Extent e{rows.x0[0], rows.x1[0], rows.y0[0], rows.y1[0], 0, 0};
  if constexpr (TIME) e.klo = e.khi = rows.key[0];
#pragma unroll
  for (int r = 1; r < ROWS; ++r) {
    e.xlo = min(e.xlo, rows.x0[r]), e.xhi = max(e.xhi, rows.x1[r]);
    e.ylo = min(e.ylo, rows.y0[r]), e.yhi = max(e.yhi, rows.y1[r]);
    if constexpr (TIME) e.klo = min(e.klo, rows.key[r]), e.khi = max(e.khi, rows.key[r]);
  }
  e.xlo = __reduce_min_sync(FULL_WARP, e.xlo), e.xhi = __reduce_max_sync(FULL_WARP, e.xhi);
  e.ylo = __reduce_min_sync(FULL_WARP, e.ylo), e.yhi = __reduce_max_sync(FULL_WARP, e.yhi);
  if constexpr (TIME) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      e.klo = min(e.klo, __shfl_xor_sync(FULL_WARP, e.klo, d));
      e.khi = max(e.khi, __shfl_xor_sync(FULL_WARP, e.khi, d));
    }
  }
  return e;
}

// Whether staged query qi has a live box meeting the extent and, with
// time, a live window meeting its key extent (chunk_cull.cuh's meets()).
template <bool TIME>
__device__ __forceinline__ bool box_meets(const Tile& t, int qi, const Extent& e) {
  if constexpr (TIME) {
    return meets(t, qi, e);
  } else {
    const int4* box = t.box + qi * t.nb;
    for (int k = 0; k < (t.live[qi] & 0xffff); ++k) {
      const int4 b = box[k];
      const int xhi = (int)((uint32_t)b.x + (uint32_t)b.y);
      const int yhi = (int)((uint32_t)b.z + (uint32_t)b.w);
      if (b.x <= e.xhi && e.xlo <= xhi && b.z <= e.yhi && e.ylo <= yhi) return true;
    }
    return false;
  }
}

// Bit r: row r's bbox overlaps one of the query's live boxes.
template <bool FAST>
__device__ __forceinline__ uint32_t overlap_mask(const int4* __restrict__ box, int n_live,
                                                 const BoxRows& rows) {
  uint32_t m = 0;
  const int nk = FAST ? 1 : n_live;
  for (int k = 0; k < nk; ++k) {
    const int4 b = box[k];  // (xlo, xhi - xlo, ylo, yhi - ylo), one 16-byte broadcast
    const int xhi = (int)((uint32_t)b.x + (uint32_t)b.y);
    const int yhi = (int)((uint32_t)b.z + (uint32_t)b.w);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (rows.x0[r] <= xhi && rows.x1[r] >= b.x && rows.y0[r] <= yhi && rows.y1[r] >= b.z)
        m |= 1u << r;
    }
  }
  return m;
}

// Bit r: row r lies in one of the query's live windows.
template <bool FAST>
__device__ __forceinline__ uint32_t box_time_mask(const longlong2* __restrict__ win, int n_live,
                                                  const BoxRows& rows) {
  uint32_t m = 0;
  const int nk = FAST ? 1 : n_live;
  for (int k = 0; k < nk; ++k) {
    const longlong2 w = win[k];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (rows.key[r] >= w.x && rows.key[r] <= w.y) m |= 1u << r;
    }
  }
  return m;
}

// Bit r: matched row r (bit r of m) overlaps a live box it shares an
// opposing edge bucket with (xmin == qxhi, xmax == qxlo, ymin == qyhi or
// ymax == qylo), or lies at an endpoint of a live window: the rows where the
// int-domain overlap and the f64 filter can differ (the reference's
// _slot_overlap and _slot_time_edge, geomesa_tpu/parallel/query.py:316,
// :331). Strict int inequality on an axis implies the f64 inequality, so a
// row with no such equality is f64-certain.
__device__ __forceinline__ uint32_t overlap_edge_mask(const Tile& t, int qi, uint32_t m,
                                                      const BoxRows& rows) {
  const int lv = t.live[qi];
  uint32_t e = 0;
  const int4* box = t.box + qi * t.nb;
  for (int k = 0; k < (lv & 0xffff); ++k) {
    const int4 b = box[k];
    const int xhi = (int)((uint32_t)b.x + (uint32_t)b.y);
    const int yhi = (int)((uint32_t)b.z + (uint32_t)b.w);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (rows.x0[r] <= xhi && rows.x1[r] >= b.x && rows.y0[r] <= yhi && rows.y1[r] >= b.z &&
          (rows.x0[r] == xhi || rows.x1[r] == b.x || rows.y0[r] == yhi || rows.y1[r] == b.z))
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

// chunk_cull.cuh's cull_scan over bbox rows: walks the block's chunks
// grid-stride (prefetch, extent, survivors, tests) and hands the
// warp-uniform epilogue ep(qi, match mask, chunk0, rows) every surviving
// query whose live boxes hold a valid row of the warp (all 32 lanes
// together); bit r of the mask is chunk row chunk0 + chunk_row(r). buf is
// BoxLayout<TIME>::BUF_BYTES, warp_ext one Extent per warp, n_surv two ints
// (zeroed before the first call), t.extra one int per staged query. Two
// barriers per chunk, as in cull_scan.
template <bool FAST, bool TIME, typename Epilogue>
__device__ __forceinline__ void box_cull_scan(const BoxCols& cols, int64_t n, int64_t limit,
                                              const Tile& t, int n_active, int4* buf,
                                              Extent* warp_ext, int* n_surv, Epilogue& ep) {
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;
  int* surv = t.extra;  // (q_tile): this chunk's surviving queries
  int parity = 0;
  if (blockIdx.x < n_chunks) prefetch_box_chunk<TIME>(buf, cols, n, blockIdx.x);
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x, parity ^= 1) {
    const int64_t chunk0 = c * CHUNK;
    BoxRows rows;
    const uint32_t valid = take_box_chunk<TIME>(buf, chunk0, limit, rows);
    const Extent we = box_warp_extent<TIME>(rows);
    // the extent has consumed every value the thread read from its buffer
    // slots, so the next chunk's copy into them starts now
    if (c + gridDim.x < n_chunks) prefetch_box_chunk<TIME>(buf, cols, n, c + gridDim.x);
    if ((threadIdx.x & 31) == 0) warp_ext[threadIdx.x >> 5] = we;
    __syncthreads();  // the warps' extents are written
    if (threadIdx.x == 0) n_surv[parity ^ 1] = 0;  // last read before this barrier
    if (chunk0 < limit) {  // block-uniform: a chunk with no valid row keeps no query
      const Extent e = block_extent(warp_ext);
      for (int i = threadIdx.x; i < n_active; i += THREADS) {
        const int qi = t.active[i];
        if (box_meets<TIME>(t, qi, e)) surv[atomicAdd(n_surv + parity, 1)] = qi;
      }
    }
    __syncthreads();  // the survivor list is complete
    const int ns = n_surv[parity];
    for (int i = 0; i < ns; ++i) {
      const int qi = surv[i];
      const int lv = FAST ? 0 : t.live[qi];
      uint32_t m = overlap_mask<FAST>(t.box + qi * t.nb, lv & 0xffff, rows) & valid;
      if (!__any_sync(FULL_WARP, m)) continue;
      if constexpr (TIME) m &= box_time_mask<FAST>(t.win + qi * t.nt, lv >> 16, rows);
      ep(qi, m, chunk0, rows);
    }
  }
}

}  // namespace geomesa
