// count_predicate.cuh: the staged bbox+time row predicate and the row scan
// shared by batched_count.cu and batched_count_hits.cu; the staged slots,
// the row masks and the row loads also serve batched_edge_gather.cu (whose
// own chunk scan culls queries per chunk, chunk_cull.cuh) and
// planned_gather.cu, so the kernels cannot drift.
//
// The device counterpart of _tile_mask (geomesa_tpu/ops/pallas_kernels.py:46).
// Row r (local position lpos) matches query q when
//   ANY box slot k:  xlo <= x <= xhi  AND  ylo <= y <= yhi
//   AND ANY time slot k:  (bin, off) >= (blo, olo)  AND  (bin, off) <= (bhi, ohi)
//       (lexicographic, exactly as pallas_kernels.py:88-89)
//   AND lpos < n  AND  base + lpos < true_n.
//
// Live-slot staging. Each block stages its query tile once in shared memory
// and keeps only the live slots, first, with a live count per query:
//   - a box slot is live iff xlo <= xhi && ylo <= yhi;
//   - a time slot is live iff (blo, olo) <= (bhi, ohi) lexicographically.
// A dead slot matches no row whatever its payload, so dropping it is exact
// for any payload, not only for ops/refine.py's padding sentinels. A query
// with no live box or no live window counts 0 and is left out of the
// block's active list, so it costs no row work.
//
// A compare-only predicate on the staged slots:
//   - a live box is staged as (xlo, xhi - xlo, ylo, yhi - ylo) and tested as
//     (uint32)(x - xlo) <= (uint32)(xhi - xlo) per axis: one subtract and one
//     unsigned compare per bound pair, exact for every int32 x when xlo <= xhi
//     (x < xlo wraps to at least 2^32 - (xhi - x) > xhi - xlo);
//   - (bin, off) becomes one 64-bit key, ((int64)bin << 32) |
//     (uint32)(off ^ 0x80000000): the bias maps the signed offset onto the
//     unsigned low word in order, so the signed 64-bit order of the keys is
//     the lexicographic order of the pairs, negative offsets included (the
//     unconstrained window [0, -1, 2^31-1, 2^31-1] over bins = offs = 0
//     relies on it). A window is staged as its two endpoint keys and tested
//     with two signed 64-bit compares.
//
// The row scan. Each thread holds ROWS consecutive rows of each column in
// registers, loaded as 16-byte vectors, and reuses them for every active
// query of the tile. Per query it builds the bitmask of its rows inside a
// live box; a warp with no such row (one vote) skips the time test.
// Otherwise the match mask is in-box & in-window & valid, and the epilogue
// of the kernel folds it in (a warp count by __reduce_add_sync; the hits
// kernel's lane maxima). When every active query of the tile has one live
// box and one live window, the block runs a compile-time <1, 1> instance of
// the row loop with the slot loops gone; otherwise the general instance
// loops to each query's live counts.
//
// Requires 16-byte aligned columns, boxes and times (the wrapper checks).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace geomesa {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16;  // consecutive rows per thread per chunk (-Xptxas -v: no spills)
constexpr int CHUNK = THREADS * ROWS;
constexpr int SMEM_BUDGET = 45056;  // bytes of dynamic shared memory per block (< 48 KB)
static_assert(ROWS % 4 == 0 && ROWS < 32, "rows load as int4 and fit a 32-bit mask");

// Rows of a slice that may match: lpos < valid_limit(...) is the same test as
// lpos < n AND base + lpos < true_n.
__device__ __forceinline__ int64_t valid_limit(int64_t n, int64_t base, int64_t true_n) {
  return (true_n - base) < n ? (true_n - base) : n;
}

// The biased 64-bit key of (bin, off): signed order == lexicographic order.
__device__ __forceinline__ long long time_key(int32_t bin, int32_t off) {
  return (long long)(((unsigned long long)(uint32_t)bin << 32) | ((uint32_t)off ^ 0x80000000u));
}

// Shared-memory bytes one query of a tile takes: its staged box and time
// slots (16 B each), its live counts and active-list entry, one count per
// warp of the block (`warps`) and `extra_ints` more (the hits kernel's lane
// scoreboard).
__host__ __device__ constexpr int staged_bytes_per_query(int nb, int nt, int extra_ints,
                                                         int warps = WARPS) {
  return 16 * (nb + nt) + 4 * (2 + warps + extra_ints);
}

// Queries one block stages at once (larger batches tile over Q).
inline int q_tile_for(int nb, int nt, int extra_ints) {
  const int t = SMEM_BUDGET / staged_bytes_per_query(nb, nt, extra_ints);
  return t > 1 ? t : 1;
}

// The staged query tile, carved out of the block's dynamic shared memory.
struct Tile {
  int4* box;       // (q_tile, nb): live boxes first, as (xlo, xhi - xlo, ylo, yhi - ylo)
  longlong2* win;  // (q_tile, nt): live windows first, as (lo key, hi key)
  int* live;       // (q_tile): live boxes | live windows << 16
  int* active;     // (n_active): queries with a live box and a live window
  int* cnt;        // (warps of the block, q_tile): per-warp match counts
  int* extra;      // (q_tile, extra_ints)
  int nb, nt, q_tile;
};

template <int NW = WARPS>  // warps of the block
__device__ __forceinline__ Tile carve(void* smem, int q_tile, int nb, int nt) {
  Tile t;
  t.box = reinterpret_cast<int4*>(smem);
  t.win = reinterpret_cast<longlong2*>(t.box + q_tile * nb);
  t.live = reinterpret_cast<int*>(t.win + q_tile * nt);
  t.active = t.live + q_tile;
  t.cnt = t.active + q_tile;
  t.extra = t.cnt + NW * q_tile;
  t.nb = nb;
  t.nt = nt;
  t.q_tile = q_tile;
  return t;
}

// Stages queries [q0, q0 + qt) of (Q, nb, 4) boxes and (Q, nt, 4) times and
// zeroes the per-warp counts; meta[0] = active queries, meta[1] = 1 when every
// active query has one live box and one live window. All threads call it; it
// ends in __syncthreads(). WINDOWS = false (the no-time overlap count of
// overlap_cull.cuh) stages no window and counts every query as having one,
// so activity and the single-slot path follow the boxes alone; its callers
// never read t.win. NT is the block's thread count (a tile carved with
// carve<NT / 32>).
template <bool WINDOWS = true, int NT = THREADS>
__device__ __forceinline__ void stage_tile(const int32_t* __restrict__ boxes,
                                           const int32_t* __restrict__ times, int q0, int qt,
                                           const Tile& t, int* meta) {
  const int nb = t.nb, nt = t.nt;
  const int4* gb = reinterpret_cast<const int4*>(boxes) + (int64_t)q0 * nb;
  const int4* gt = reinterpret_cast<const int4*>(times) + (int64_t)q0 * nt;
  int4* raw_win = reinterpret_cast<int4*>(t.win);
  for (int i = threadIdx.x; i < qt * nb; i += NT) t.box[i] = gb[i];
  if constexpr (WINDOWS)
    for (int i = threadIdx.x; i < qt * nt; i += NT) raw_win[i] = gt[i];
  for (int i = threadIdx.x; i < NT / 32 * t.q_tile; i += NT) t.cnt[i] = 0;
  __syncthreads();

  // one thread per query compacts its own slots in place (write index <= read index)
  for (int qi = threadIdx.x; qi < qt; qi += NT) {
    int4* bq = t.box + qi * nb;
    int kb = 0;
    for (int k = 0; k < nb; ++k) {
      const int4 b = bq[k];  // xlo, xhi, ylo, yhi
      if (b.x <= b.y && b.z <= b.w)
        bq[kb++] = make_int4(b.x, (int)((uint32_t)b.y - (uint32_t)b.x), b.z,
                             (int)((uint32_t)b.w - (uint32_t)b.z));
    }
    int kt = 1;
    if constexpr (WINDOWS) {
      longlong2* wq = t.win + qi * nt;
      const int4* wr = raw_win + qi * nt;
      kt = 0;
      for (int k = 0; k < nt; ++k) {
        const int4 w = wr[k];  // blo, olo, bhi, ohi
        const long long lo = time_key(w.x, w.y), hi = time_key(w.z, w.w);
        if (lo <= hi) wq[kt++] = make_longlong2(lo, hi);
      }
    }
    t.live[qi] = kb | (kt << 16);
  }
  __syncthreads();

  // warp 0 lists the active queries in order and decides the block's path
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n_active = 0;
    bool fast = true;
    for (int g = 0; g < qt; g += 32) {
      const int qi = g + lane;
      const int lv = qi < qt ? t.live[qi] : 0;
      const bool act = (lv & 0xffff) && (lv >> 16);
      const unsigned bal = __ballot_sync(FULL_WARP, act);
      if (act) t.active[n_active + __popc(bal & ((1u << lane) - 1))] = qi;
      n_active += __popc(bal);
      fast = fast && !__any_sync(FULL_WARP, act && lv != (1 | (1 << 16)));
    }
    if (lane == 0) {
      meta[0] = n_active;
      meta[1] = fast;
    }
  }
  __syncthreads();
}

// Adds the tile's per-warp counts to the outputs, one atomicAdd per query
// (NT: the block's threads); all threads call it, after their last count.
template <int NT = THREADS>
__device__ __forceinline__ void flush_counts(const Tile& t, int q0, int qt,
                                             int32_t* __restrict__ counts) {
  __syncthreads();
  for (int qi = threadIdx.x; qi < qt; qi += NT) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) sum += t.cnt[w * t.q_tile + qi];
    if (sum) atomicAdd(&counts[q0 + qi], sum);
  }
}

// The ROWS consecutive rows of one thread: coordinates and time keys.
struct Rows {
  int32_t x[ROWS], y[ROWS];
  long long key[ROWS];
};

__device__ __forceinline__ void load_col(const int32_t* __restrict__ col, int64_t row0, int64_t n,
                                         int32_t (&v)[ROWS]) {
  if (row0 + ROWS <= n) {
    const int4* p = reinterpret_cast<const int4*>(col + row0);
#pragma unroll
    for (int j = 0; j < ROWS / 4; ++j) {
      const int4 q = __ldg(p + j);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) v[r] = row0 + r < n ? __ldg(col + row0 + r) : 0;
  }
}

// Loads the thread's rows of chunk c; returns the mask of its valid rows.
__device__ __forceinline__ uint32_t load_rows(const int32_t* __restrict__ x,
                                              const int32_t* __restrict__ y,
                                              const int32_t* __restrict__ bins,
                                              const int32_t* __restrict__ offs, int64_t n,
                                              int64_t limit, int64_t row0, Rows& rows) {
  int32_t b[ROWS], o[ROWS];
  load_col(x, row0, n, rows.x);
  load_col(y, row0, n, rows.y);
  load_col(bins, row0, n, b);
  load_col(offs, row0, n, o);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) rows.key[r] = time_key(b[r], o[r]);
  const int64_t nv = limit - row0;
  return nv >= ROWS ? (1u << ROWS) - 1 : (nv <= 0 ? 0u : (1u << (int)nv) - 1);
}

// Bit r: row r lies in one of the query's live boxes.
template <bool FAST>
__device__ __forceinline__ uint32_t box_mask(const int4* __restrict__ box, int n_live,
                                             const Rows& rows) {
  uint32_t m = 0;
  const int nk = FAST ? 1 : n_live;
  for (int k = 0; k < nk; ++k) {
    const int4 b = box[k];  // one 16-byte broadcast
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if ((uint32_t)rows.x[r] - (uint32_t)b.x <= (uint32_t)b.y &&
          (uint32_t)rows.y[r] - (uint32_t)b.z <= (uint32_t)b.w)
        m |= 1u << r;
    }
  }
  return m;
}

// Bit r: row r lies in one of the query's live windows.
template <bool FAST>
__device__ __forceinline__ uint32_t time_mask(const longlong2* __restrict__ win, int n_live,
                                              const Rows& rows) {
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

// Walks the block's chunks grid-stride and, per active query, hands the
// warp-uniform epilogue `ep(qi, match mask, row0, rows)` every warp that has
// an in-box row (all 32 lanes call it together). row0 is the thread's first
// local row; bit r of the mask is row row0 + r, held in rows.
template <bool FAST, typename Epilogue>
__device__ __forceinline__ void scan_rows(const int32_t* __restrict__ x,
                                          const int32_t* __restrict__ y,
                                          const int32_t* __restrict__ bins,
                                          const int32_t* __restrict__ offs, int64_t n,
                                          int64_t limit, const Tile& t, int n_active,
                                          Epilogue& ep) {
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t row0 = c * CHUNK + (int64_t)threadIdx.x * ROWS;
    Rows rows;
    const uint32_t valid = load_rows(x, y, bins, offs, n, limit, row0, rows);
    for (int i = 0; i < n_active; ++i) {
      const int qi = t.active[i];
      const int lv = FAST ? 0 : t.live[qi];
      const uint32_t inb = box_mask<FAST>(t.box + qi * t.nb, lv & 0xffff, rows) & valid;
      if (!__any_sync(FULL_WARP, inb)) continue;
      ep(qi, inb & time_mask<FAST>(t.win + qi * t.nt, lv >> 16, rows), row0, rows);
    }
  }
}

// Counts the blocks that took each path: [0] the <1, 1> instance, [1] the
// general one (blocks with no active query take neither). One counter pair
// per library, summed over every launch on every stream, so a reading
// (ops.kernels.path_blocks) is one caller's only while no other thread
// launches the same kernel. One atomicAdd per block.
__device__ __forceinline__ void note_path(unsigned long long* path_blocks, bool fast) {
  if (threadIdx.x == 0) atomicAdd(path_blocks + (fast ? 0 : 1), 1ull);
}

}  // namespace geomesa
