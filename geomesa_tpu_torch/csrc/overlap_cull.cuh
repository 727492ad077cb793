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
// The cull. A warp's extent is (min xmin, max xmax, min ymin, max ymax)
// and, with time, the key's min and max, over every row it loaded, valid
// or not (rows past n arrive as zeros). chunk_cull.cuh's meets() on that
// extent is an exact superset for overlap: a row that overlaps live box q
// has xmin <= qxhi and xmax >= qxlo, so min xmin <= qxhi and max xmax >=
// qxlo, and the same in y. A stamped row (xmin = INT32_MAX, xmax = -1)
// widens neither the min of xmin nor the max of xmax, so it needs no
// special case and does not loosen its warp's extent. A warp with no valid
// row keeps no query. ops/kernels.py overlap_warp_pairs is the plain
// version of this cull.
//
// The scan (box_cull_scan). What bounds it on an H100 is the bytes of the
// columns (16 or 24 B a row at 3.35 TB/s); at a store's real size (bench
// config 5: 4M rows, ~1,000 chunks of 4096 rows, 0.02 ms of bytes) also
// the latency of the first loads and of the last chunks, since each SM
// walks only 7-8 chunks. The design answers both:
//   - a block is OV_THREADS = 512 threads (16 warps an SM), each holding
//     OV_ROWS = 8 rows of a 4096-row chunk in registers: 32 (no time) or 48
//     registers of rows, so the whole thread fits the 128 registers that
//     16 warps allow;
//   - a chunk's columns arrive in dynamic shared memory by cp.async
//     (16-byte copies, zero-filled past n) in a ring of two chunks (128 or
//     192 KB, one block an SM), the block's chunks taken grid-stride: the
//     first two are issued before the query tile is staged, so the tile's
//     global reads and barriers hide under them, and each stage is
//     refilled with the chunk two rounds ahead as soon as its rows are in
//     registers. Thread t copies, and later reads, exactly its own 16-byte
//     vectors (slot [column][group][t] holds rows group * 2048 + 4t .. +3),
//     so no barrier guards the ring; bit r of a thread's masks is chunk row
//     chunk_row<OV_GROUP_ROWS>(r);
//   - each warp culls on its own rows (256 of each chunk, in two runs of
//     128): its extent, a ballot of the active queries that meet it, and
//     the overlap and window tests of those only. No barrier is taken
//     between the tile's staging and the flush of the counts, so a warp
//     whose data has arrived never waits for another.
// Launch attributes and occupancy are asked once per kernel and shared size
// (launch_cache.cuh).
//
// The edge test of the exact count (overlap_edge_mask) runs per (warp,
// query) only where the warp can hold a candidate: a row shares an
// opposing edge bucket with live box k only if qxhi lies in the warp's
// [min xmin, max xmin], or qxlo in [min xmax, max xmax], or the same holds
// in y; it sits at an endpoint of live window k only if the endpoint lies
// in the warp's [min key, max key]. The warp's ranges cover every row it
// loaded, valid or not, so the skip is an exact superset test
// (may_hold_edge; its plain version is ops/kernels.py
// overlap_edge_possible).
//
// planned_gather.cu's overlap count pass shares the row tests and the
// 8-row register layout (ScanRows), loading its rows without the ring.

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

constexpr int OV_THREADS = 512;                   // threads of a scan block
constexpr int OV_WARPS = OV_THREADS / 32;         // 16
constexpr int OV_ROWS = CHUNK / OV_THREADS;       // rows a thread holds of a chunk: 8
constexpr int OV_GROUPS = OV_ROWS / 4;            // 16-byte groups per thread and column
constexpr int OV_GROUP_ROWS = OV_THREADS * 4;     // rows between a thread's groups
constexpr int MAX_BLOCK_SMEM = 232448;            // shared memory a block may use (227 KB)
constexpr int OV_STATIC_SMEM = 2048;              // kept for the kernels' static shared memory
static_assert(OV_GROUPS * OV_GROUP_ROWS == CHUNK, "a chunk is OV_GROUPS groups of 512 x 4 rows");

template <bool TIME>
struct BoxLayout {
  static constexpr int COLS = TIME ? 6 : 4;
  static constexpr int STAGE_BYTES = COLS * CHUNK * 4;  // one chunk of every column
  static constexpr int STAGES = 2;  // chunks of the cp.async ring
  static constexpr int BUF_BYTES = STAGES * STAGE_BYTES;
  // the query tile's share: what the ring leaves, at most count_predicate's budget
  static constexpr int TILE_BUDGET = MAX_BLOCK_SMEM - OV_STATIC_SMEM - BUF_BYTES < SMEM_BUDGET
                                         ? MAX_BLOCK_SMEM - OV_STATIC_SMEM - BUF_BYTES
                                         : SMEM_BUDGET;
};

// Queries one scan block stages at once.
template <bool TIME>
inline int box_q_tile(int nb, int nt) {
  const int t = BoxLayout<TIME>::TILE_BUDGET / staged_bytes_per_query(nb, nt, 0, OV_WARPS);
  return t > 1 ? t : 1;
}

// The R rows of one thread: bounds and time keys (unused without time).
template <int R>
struct BoxRowsT {
  int32_t x0[R], y0[R], x1[R], y1[R];
  long long key[R];
};
using ScanRows = BoxRowsT<OV_ROWS>;

// Starts the copy of chunk c's rows of the thread into stage (laid out
// [column][group][thread]) and commits it as one cp.async group; a chunk
// at or past n_chunks commits an empty group, so that every round commits
// one. Rows at n or past it arrive as zeros.
template <bool TIME>
__device__ __forceinline__ void prefetch_box_chunk(int4* stage, const BoxCols& cols, int64_t n,
                                                   int64_t c, int64_t n_chunks) {
  if (c < n_chunks) {
    const int64_t row0 = c * CHUNK + 4 * (int64_t)threadIdx.x;
#pragma unroll
    for (int j = 0; j < OV_GROUPS; ++j) {
      const int64_t row = row0 + (int64_t)j * OV_GROUP_ROWS;
      const int64_t left = n - row;
      const int bytes = left >= 4 ? 16 : (left <= 0 ? 0 : (int)left * 4);
      const int64_t at = bytes ? row : 0;  // no byte is read when bytes == 0
#pragma unroll
      for (int k = 0; k < BoxLayout<TIME>::COLS; ++k)
        cp_async16(stage + (k * OV_GROUPS + j) * OV_THREADS + threadIdx.x, cols.c[k] + at, bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Issues the block's first STAGES chunks (grid-stride), one a stage; the
// kernels call it before staging their query tile.
template <bool TIME>
__device__ __forceinline__ void box_scan_prologue(int4* buf, const BoxCols& cols, int64_t n) {
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;
#pragma unroll
  for (int s = 0; s < BoxLayout<TIME>::STAGES; ++s)
    prefetch_box_chunk<TIME>(buf + s * (BoxLayout<TIME>::STAGE_BYTES / 16), cols, n,
                             blockIdx.x + (int64_t)s * gridDim.x, n_chunks);
}

// Waits for every copy of the thread (a block that scans nothing).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void put4(int32_t (&v)[R], int j, const int4 q) {
  v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
}

// Waits for the oldest of the thread's STAGES groups in flight (this
// round's chunk) and takes its rows into registers; returns the mask of its
// rows below limit (chunk rows start at chunk0).
template <bool TIME>
__device__ __forceinline__ uint32_t take_box_chunk(const int4* stage, int64_t chunk0,
                                                   int64_t limit, ScanRows& rows) {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(BoxLayout<TIME>::STAGES - 1) : "memory");
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < OV_GROUPS; ++j) {
    put4(rows.x0, j, stage[(0 * OV_GROUPS + j) * OV_THREADS + threadIdx.x]);
    put4(rows.y0, j, stage[(1 * OV_GROUPS + j) * OV_THREADS + threadIdx.x]);
    put4(rows.x1, j, stage[(2 * OV_GROUPS + j) * OV_THREADS + threadIdx.x]);
    put4(rows.y1, j, stage[(3 * OV_GROUPS + j) * OV_THREADS + threadIdx.x]);
    if constexpr (TIME) {
      const int4 vb = stage[(4 * OV_GROUPS + j) * OV_THREADS + threadIdx.x];
      const int4 vo = stage[(5 * OV_GROUPS + j) * OV_THREADS + threadIdx.x];
      rows.key[4 * j] = time_key(vb.x, vo.x);
      rows.key[4 * j + 1] = time_key(vb.y, vo.y);
      rows.key[4 * j + 2] = time_key(vb.z, vo.z);
      rows.key[4 * j + 3] = time_key(vb.w, vo.w);
    }
    const int64_t nv = limit - (chunk0 + (int64_t)j * OV_GROUP_ROWS + 4 * threadIdx.x);
    valid |= (nv >= 4 ? 0xfu : (nv <= 0 ? 0u : (1u << (int)nv) - 1)) << (4 * j);
  }
  return valid;
}

// The warp's extent of its lanes' rows (every lane gets it): min xmin, max
// xmax, min ymin, max ymax and, with time, the key's min and max.
template <bool TIME>
__device__ __forceinline__ Extent box_warp_extent(const ScanRows& rows) {
  Extent e{rows.x0[0], rows.x1[0], rows.y0[0], rows.y1[0], 0, 0};
  if constexpr (TIME) e.klo = e.khi = rows.key[0];
#pragma unroll
  for (int r = 1; r < OV_ROWS; ++r) {
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

// The inner ends of the warp's bound ranges, which the extent lacks: max
// xmin, min xmax, max ymin, min ymax (every lane gets them).
struct EdgeSpan {
  int x0hi, x1lo, y0hi, y1lo;
};

__device__ __forceinline__ EdgeSpan warp_edge_span(const ScanRows& rows) {
  EdgeSpan s{rows.x0[0], rows.x1[0], rows.y0[0], rows.y1[0]};
#pragma unroll
  for (int r = 1; r < OV_ROWS; ++r) {
    s.x0hi = max(s.x0hi, rows.x0[r]), s.x1lo = min(s.x1lo, rows.x1[r]);
    s.y0hi = max(s.y0hi, rows.y0[r]), s.y1lo = min(s.y1lo, rows.y1[r]);
  }
  s.x0hi = __reduce_max_sync(FULL_WARP, s.x0hi), s.x1lo = __reduce_min_sync(FULL_WARP, s.x1lo);
  s.y0hi = __reduce_max_sync(FULL_WARP, s.y0hi), s.y1lo = __reduce_min_sync(FULL_WARP, s.y1lo);
  return s;
}

// Whether a row of the warp (extent e, span s) can be an edge candidate of
// staged query qi: a live box with qxhi in [min xmin, max xmin], qxlo in
// [min xmax, max xmax], qyhi in [min ymin, max ymin] or qylo in [min ymax,
// max ymax], or a live window with an endpoint in [min key, max key].
// Warp-uniform.
__device__ __forceinline__ bool may_hold_edge(const Tile& t, int qi, const Extent& e,
                                              const EdgeSpan& s) {
  const int lv = t.live[qi];
  const int4* box = t.box + qi * t.nb;
  for (int k = 0; k < (lv & 0xffff); ++k) {
    const int4 b = box[k];
    const int xhi = (int)((uint32_t)b.x + (uint32_t)b.y);
    const int yhi = (int)((uint32_t)b.z + (uint32_t)b.w);
    if ((e.xlo <= xhi && xhi <= s.x0hi) || (s.x1lo <= b.x && b.x <= e.xhi) ||
        (e.ylo <= yhi && yhi <= s.y0hi) || (s.y1lo <= b.z && b.z <= e.yhi))
      return true;
  }
  const longlong2* win = t.win + qi * t.nt;
  for (int k = 0; k < (lv >> 16); ++k) {
    const longlong2 w = win[k];
    if ((e.klo <= w.x && w.x <= e.khi) || (e.klo <= w.y && w.y <= e.khi)) return true;
  }
  return false;
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
template <bool FAST, int R>
__device__ __forceinline__ uint32_t overlap_mask(const int4* __restrict__ box, int n_live,
                                                 const BoxRowsT<R>& rows) {
  uint32_t m = 0;
  const int nk = FAST ? 1 : n_live;
  for (int k = 0; k < nk; ++k) {
    const int4 b = box[k];  // (xlo, xhi - xlo, ylo, yhi - ylo), one 16-byte broadcast
    const int xhi = (int)((uint32_t)b.x + (uint32_t)b.y);
    const int yhi = (int)((uint32_t)b.z + (uint32_t)b.w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (rows.x0[r] <= xhi && rows.x1[r] >= b.x && rows.y0[r] <= yhi && rows.y1[r] >= b.z)
        m |= 1u << r;
    }
  }
  return m;
}

// Bit r: row r lies in one of the query's live windows.
template <bool FAST, int R>
__device__ __forceinline__ uint32_t box_time_mask(const longlong2* __restrict__ win, int n_live,
                                                  const BoxRowsT<R>& rows) {
  uint32_t m = 0;
  const int nk = FAST ? 1 : n_live;
  for (int k = 0; k < nk; ++k) {
    const longlong2 w = win[k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
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
template <int R>
__device__ __forceinline__ uint32_t overlap_edge_mask(const Tile& t, int qi, uint32_t m,
                                                      const BoxRowsT<R>& rows) {
  const int lv = t.live[qi];
  uint32_t e = 0;
  const int4* box = t.box + qi * t.nb;
  for (int k = 0; k < (lv & 0xffff); ++k) {
    const int4 b = box[k];
    const int xhi = (int)((uint32_t)b.x + (uint32_t)b.y);
    const int yhi = (int)((uint32_t)b.z + (uint32_t)b.w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (rows.x0[r] <= xhi && rows.x1[r] >= b.x && rows.y0[r] <= yhi && rows.y1[r] >= b.z &&
          (rows.x0[r] == xhi || rows.x1[r] == b.x || rows.y0[r] == yhi || rows.y1[r] == b.z))
        e |= 1u << r;
    }
  }
  const longlong2* win = t.win + qi * t.nt;
  for (int k = 0; k < (lv >> 16); ++k) {
    const longlong2 w = win[k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (rows.key[r] == w.x || rows.key[r] == w.y) e |= 1u << r;
    }
  }
  return e & m;
}

// Walks the block's chunks grid-stride through the ring that
// box_scan_prologue filled (take, extent, refill, cull, tests) and hands
// the warp-uniform epilogue ep(qi, match mask, chunk0, rows, extent, span)
// every query that survives the warp's cull and whose live boxes hold a
// valid row of the warp (all 32 lanes together); bit r of the mask is
// chunk row chunk0 + chunk_row<OV_GROUP_ROWS>(r); extent and span are the
// warp's (span only with EDGE). buf is BoxLayout<TIME>::BUF_BYTES. Each
// warp goes its own pace: no barrier.
template <bool FAST, bool TIME, bool EDGE, typename Epilogue>
__device__ __forceinline__ void box_cull_scan(const BoxCols& cols, int64_t n, int64_t limit,
                                              const Tile& t, int n_active, int4* buf,
                                              Epilogue& ep) {
  constexpr int S = BoxLayout<TIME>::STAGES;
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;
  const int lane = threadIdx.x & 31;
  int s = 0;  // round i takes stage i % S
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int4* stage = buf + s * (BoxLayout<TIME>::STAGE_BYTES / 16);
    s = s + 1 == S ? 0 : s + 1;
    const int64_t chunk0 = c * CHUNK;
    ScanRows rows;
    const uint32_t valid = take_box_chunk<TIME>(stage, chunk0, limit, rows);
    const Extent we = box_warp_extent<TIME>(rows);
    EdgeSpan span{};
    if constexpr (EDGE) span = warp_edge_span(rows);
    // the thread's rows are in registers: its slots of this stage take the
    // chunk S rounds ahead
    prefetch_box_chunk<TIME>(stage, cols, n, c + S * (int64_t)gridDim.x, n_chunks);
    if (!__any_sync(FULL_WARP, valid)) continue;  // no valid row: the warp keeps no query
    for (int g = 0; g < n_active; g += 32) {
      const int i = g + lane;
      unsigned keep = __ballot_sync(FULL_WARP, i < n_active && box_meets<TIME>(t, t.active[i], we));
      while (keep) {
        const int qi = t.active[g + __ffs(keep) - 1];
        keep &= keep - 1;
        const int lv = FAST ? 0 : t.live[qi];
        uint32_t m = overlap_mask<FAST>(t.box + qi * t.nb, lv & 0xffff, rows) & valid;
        if (!__any_sync(FULL_WARP, m)) continue;
        if constexpr (TIME) m &= box_time_mask<FAST>(t.win + qi * t.nt, lv >> 16, rows);
        ep(qi, m, chunk0, rows, we, span);
      }
    }
  }
}

}  // namespace geomesa
