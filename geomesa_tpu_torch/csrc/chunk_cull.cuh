// chunk_cull.cuh: per-chunk query culling over rows staged through shared
// memory, the culled chunk scan (cull_scan), and the edge split and lane
// append of the exact paths, for batched_edge_gather.cu and grouped_agg.cu.
//
// Resident rows are in z3 order: bin (one day) first, then the Morton key of
// (x, y, offset). One chunk of CHUNK = 4096 consecutive rows therefore spans
// about one day and a compact (x, y, offset) cell, and most (chunk, query)
// pairs of a batch of city-box, few-day queries cannot hold a match. A block
// takes each chunk's extent (min and max of x, of y and of the biased 64-bit
// time key) and lists the active queries that have a live box meeting the
// x/y extent AND a live window meeting the key extent; only those run the
// row tests on the chunk.
//
// Exact by construction: a row that matches query q lies inside one of q's
// live boxes and one of its live windows, so that box meets the chunk's
// x/y extent and that window its key extent. The extent is taken over
// every loaded row, valid or not (rows past n are loaded as zeros, rows
// past true_n as they are), so it is a superset of the valid rows' extent
// and culling never drops a match. A chunk with no valid row keeps no
// query. Unsorted rows keep nearly every pair and lose nothing but the
// extent's cost.
//
// Staging. A chunk's four columns go through a 64 KB shared buffer with
// cp.async (16-byte copies, zero-filled past n), issued as soon as the
// block has taken the previous chunk into registers, so the next chunk's
// bytes stream in while this one is culled and tested. Thread t copies, and
// later reads, exactly its own 16-byte vectors: group j (0..3) of column c
// holds rows j * 1024 + 4t .. +3 of the chunk, at buffer slot [c][j][t].
// Neighbouring threads take neighbouring 16-byte words, so both the global
// copy and the shared read are conflict-free, and no barrier guards the
// buffer (a thread's cp.async.wait_group makes its own copies visible to
// it). Bit r of a thread's row masks is chunk row (r / 4) * 1024 + 4t + r % 4.
//
// Requires 16-byte aligned columns (the wrapper checks).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace geomesa {

constexpr int GROUPS = ROWS / 4;             // 16-byte groups per thread and column
constexpr int GROUP_ROWS = THREADS * 4;      // rows between a thread's groups
constexpr int ROW_BUF_BYTES = 4 * CHUNK * 4; // the four int32 columns of one chunk
static_assert(GROUPS * GROUP_ROWS == CHUNK, "a chunk is GROUPS groups of THREADS x 4 rows");

// The chunk row of bit r of a thread's masks (GR: rows between a thread's
// 16-byte groups, the block's threads x 4).
template <int GR = GROUP_ROWS>
__device__ __forceinline__ int chunk_row(int r) {
  return (r >> 2) * GR + 4 * (int)threadIdx.x + (r & 3);
}

__device__ __forceinline__ void cp_async16(int4* dst, const int32_t* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

// Starts the copy of chunk c's rows of the thread into buf (ROW_BUF_BYTES,
// laid out [column][group][thread]); rows at n or past it arrive as zeros.
__device__ __forceinline__ void prefetch_chunk(int4* buf, const int32_t* __restrict__ x,
                                               const int32_t* __restrict__ y,
                                               const int32_t* __restrict__ bins,
                                               const int32_t* __restrict__ offs, int64_t n,
                                               int64_t c) {
  const int32_t* cols[4] = {x, y, bins, offs};
  const int64_t row0 = c * CHUNK + 4 * (int64_t)threadIdx.x;
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int64_t row = row0 + (int64_t)j * GROUP_ROWS;
    const int64_t left = n - row;
    const int bytes = left >= 4 ? 16 : (left <= 0 ? 0 : (int)left * 4);
    const int64_t at = bytes ? row : 0;  // no byte is read when bytes == 0
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cp_async16(buf + (k * GROUPS + j) * THREADS + threadIdx.x, cols[k] + at, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for the thread's copies and takes its rows into registers; returns
// the mask of its rows below limit (chunk rows start at chunk0).
__device__ __forceinline__ uint32_t take_chunk(const int4* buf, int64_t chunk0, int64_t limit,
                                               Rows& rows) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int4 vx = buf[(0 * GROUPS + j) * THREADS + threadIdx.x];
    const int4 vy = buf[(1 * GROUPS + j) * THREADS + threadIdx.x];
    const int4 vb = buf[(2 * GROUPS + j) * THREADS + threadIdx.x];
    const int4 vo = buf[(3 * GROUPS + j) * THREADS + threadIdx.x];
    rows.x[4 * j] = vx.x, rows.x[4 * j + 1] = vx.y, rows.x[4 * j + 2] = vx.z, rows.x[4 * j + 3] = vx.w;
    rows.y[4 * j] = vy.x, rows.y[4 * j + 1] = vy.y, rows.y[4 * j + 2] = vy.z, rows.y[4 * j + 3] = vy.w;
    rows.key[4 * j] = time_key(vb.x, vo.x);
    rows.key[4 * j + 1] = time_key(vb.y, vo.y);
    rows.key[4 * j + 2] = time_key(vb.z, vo.z);
    rows.key[4 * j + 3] = time_key(vb.w, vo.w);
    const int64_t nv = limit - (chunk0 + (int64_t)j * GROUP_ROWS + 4 * threadIdx.x);
    valid |= (nv >= 4 ? 0xfu : (nv <= 0 ? 0u : (1u << (int)nv) - 1)) << (4 * j);
  }
  return valid;
}

// A chunk's extent: signed bounds of x, y and the time key.
struct Extent {
  int xlo, xhi, ylo, yhi;
  long long klo, khi;
};

// The warp's extent of its lanes' rows (every lane gets it).
__device__ __forceinline__ Extent warp_extent(const Rows& rows) {
  Extent e{rows.x[0], rows.x[0], rows.y[0], rows.y[0], rows.key[0], rows.key[0]};
#pragma unroll
  for (int r = 1; r < ROWS; ++r) {
    e.xlo = min(e.xlo, rows.x[r]), e.xhi = max(e.xhi, rows.x[r]);
    e.ylo = min(e.ylo, rows.y[r]), e.yhi = max(e.yhi, rows.y[r]);
    e.klo = min(e.klo, rows.key[r]), e.khi = max(e.khi, rows.key[r]);
  }
  e.xlo = __reduce_min_sync(FULL_WARP, e.xlo), e.xhi = __reduce_max_sync(FULL_WARP, e.xhi);
  e.ylo = __reduce_min_sync(FULL_WARP, e.ylo), e.yhi = __reduce_max_sync(FULL_WARP, e.yhi);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    e.klo = min(e.klo, __shfl_xor_sync(FULL_WARP, e.klo, d));
    e.khi = max(e.khi, __shfl_xor_sync(FULL_WARP, e.khi, d));
  }
  return e;
}

// The block's extent from the warps' (shared, one per warp).
__device__ __forceinline__ Extent block_extent(const Extent* warps) {
  Extent e = warps[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    const Extent o = warps[w];
    e.xlo = min(e.xlo, o.xlo), e.xhi = max(e.xhi, o.xhi);
    e.ylo = min(e.ylo, o.ylo), e.yhi = max(e.yhi, o.yhi);
    e.klo = min(e.klo, o.klo), e.khi = max(e.khi, o.khi);
  }
  return e;
}

// Whether staged query qi has a live box meeting the x/y extent and a live
// window meeting the key extent. A staged box is (xlo, xhi - xlo, ylo,
// yhi - ylo) with xlo <= xhi, so the wrapping add gives back xhi.
__device__ __forceinline__ bool meets(const Tile& t, int qi, const Extent& e) {
  const int lv = t.live[qi];
  const int4* box = t.box + qi * t.nb;
  bool hit = false;
  for (int k = 0; k < (lv & 0xffff) && !hit; ++k) {
    const int4 b = box[k];
    const int xhi = (int)((uint32_t)b.x + (uint32_t)b.y);
    const int yhi = (int)((uint32_t)b.z + (uint32_t)b.w);
    hit = b.x <= e.xhi && e.xlo <= xhi && b.z <= e.yhi && e.ylo <= yhi;
  }
  if (!hit) return false;
  const longlong2* win = t.win + qi * t.nt;
  for (int k = 0; k < (lv >> 16); ++k) {
    const longlong2 w = win[k];
    if (w.x <= e.khi && e.klo <= w.y) return true;
  }
  return false;
}

// Bit r: matched row r (bit r of m) lies on an edge bucket of a live box it
// is inside, or at an endpoint of a live window: the rows where the
// int-domain predicate and the f64 filter can differ (the reference's
// _slot_point and _slot_time_edge, geomesa_tpu/parallel/query.py:309, :331).
//
// On the staged slots: a live box is (xlo, xhi - xlo, ylo, yhi - ylo); with
// dx = (uint32)(x - xlo), x == xlo is dx == 0 and x == xhi is dx ==
// (uint32)(xhi - xlo), because the wrapping subtract is a bijection of the
// 32-bit words. A time endpoint is key == lo key or key == hi key of a live
// window. Dead slots have no inside rows and no valid window, so live-slot
// staging drops nothing the edges need.
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

// Appends the warp's rows e (bit r of a lane's mask is chunk row
// chunk_row<GR>(r)) to one query's lanes: an inclusive prefix sum of the
// lanes' counts (five shuffles), then one lane adds the warp's total to the
// query's cursor *hits with one atomicAdd, which keeps counting past the
// capacity; each lane writes the global positions gchunk0 + chunk_row<GR>(r)
// of its rows that fall below cap. All 32 lanes call it together.
template <int GR = GROUP_ROWS>
__device__ __forceinline__ void append_lanes(uint32_t e, int64_t gchunk0,
                                             int32_t* __restrict__ hits,
                                             int32_t* __restrict__ pos, int cap) {
  const int lane = threadIdx.x & 31;
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
  if (lane == 31) start = atomicAdd(hits, (int)total);
  int slot = __shfl_sync(FULL_WARP, start, 31) + (int)(incl - ne);
  // the wrappers guarantee base + n < 2^31: positions are int32
  const int32_t gpos0 = (int32_t)gchunk0;
  while (e && slot < cap) {
    const int r = __ffs(e) - 1;
    e &= e - 1;
    pos[slot++] = gpos0 + chunk_row<GR>(r);
  }
}

// Walks the block's chunks grid-stride: prefetch, extent, survivors, tests.
// For each surviving query whose live boxes hold a valid row of a warp, the
// warp-uniform epilogue ep(qi, match mask, chunk0, rows) runs (all 32 lanes
// together); bit r of the mask is chunk row chunk0 + chunk_row(r), held in
// rows. buf is the ROW_BUF_BYTES prefetch buffer, warp_ext one Extent per
// warp, n_surv two ints (zeroed before the first call), t.extra one int per
// staged query (the survivor list).
//
// Two barriers per chunk, both reached by every thread: one after the warps'
// extents are written (then the survivor list is built), one after the
// survivor list is complete. The survivor count is double-buffered by chunk
// parity and reset one chunk ahead, after the first barrier, when no thread
// can still read it.
template <bool FAST, typename Epilogue>
__device__ __forceinline__ void cull_scan(const int32_t* __restrict__ x,
                                          const int32_t* __restrict__ y,
                                          const int32_t* __restrict__ bins,
                                          const int32_t* __restrict__ offs, int64_t n,
                                          int64_t limit, const Tile& t, int n_active, int4* buf,
                                          Extent* warp_ext, int* n_surv, Epilogue& ep) {
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;
  int* surv = t.extra;  // (q_tile): this chunk's surviving queries
  int parity = 0;
  if (blockIdx.x < n_chunks) prefetch_chunk(buf, x, y, bins, offs, n, blockIdx.x);
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x, parity ^= 1) {
    const int64_t chunk0 = c * CHUNK;
    Rows rows;
    const uint32_t valid = take_chunk(buf, chunk0, limit, rows);
    const Extent we = warp_extent(rows);
    // the extent has consumed every value the thread read from its buffer
    // slots, so the next chunk's copy into them starts now
    if (c + gridDim.x < n_chunks) prefetch_chunk(buf, x, y, bins, offs, n, c + gridDim.x);
    if ((threadIdx.x & 31) == 0) warp_ext[threadIdx.x >> 5] = we;
    __syncthreads();  // the warps' extents are written
    if (threadIdx.x == 0) n_surv[parity ^ 1] = 0;  // last read before this barrier
    if (chunk0 < limit) {  // block-uniform: a chunk with no valid row keeps no query
      const Extent e = block_extent(warp_ext);
      for (int i = threadIdx.x; i < n_active; i += THREADS) {
        const int qi = t.active[i];
        if (meets(t, qi, e)) surv[atomicAdd(n_surv + parity, 1)] = qi;
      }
    }
    __syncthreads();  // the survivor list is complete
    const int ns = n_surv[parity];
    for (int i = 0; i < ns; ++i) {
      const int qi = surv[i];
      const int lv = FAST ? 0 : t.live[qi];
      const uint32_t inb = box_mask<FAST>(t.box + qi * t.nb, lv & 0xffff, rows) & valid;
      if (!__any_sync(FULL_WARP, inb)) continue;
      ep(qi, inb & time_mask<FAST>(t.win + qi * t.nt, lv >> 16, rows), chunk0, rows);
    }
  }
}

}  // namespace geomesa
