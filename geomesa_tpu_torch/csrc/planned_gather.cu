// planned_gather: batched row retrieval over planned (query, block) pairs,
// the device half of select_many.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:820
// (make_planned_gather_step; its count step make_planned_count_step :716
// only sizes the reference's static buffer). It is not a TPU kernel: the
// reference computes it in XLA. The port's eager torch form
// (ops.kernels.planned_gather_plain) runs about 24 slot passes of small ops
// per chunk of pairs plus a boolean index that syncs with the host each
// chunk; this kernel does the same work in three launches (count pass,
// scan, write pass) and one read of a total.
//
// What it computes: pair p = (query pair_q[p], block pair_blk[p]) covers
// the JOIN_BLOCK rows [blk * JOIN_BLOCK, (blk + 1) * JOIN_BLOCK) of the
// resident columns; pair_hits[p] is the number of those rows below true_n
// that pass query pair_q[p]'s boxes and windows (count_predicate.cuh's
// predicate), and positions[offsets[p] ..] their global positions (int32,
// the reference's contract: geomesa_tpu/parallel/query.py:873-876) in row
// order. offsets[p] = ends[p] - pair_hits[p], ends the inclusive prefix
// sum of pair_hits (the count pass's entry point writes it with a one-block
// scan; the wrapper sizes positions from its last element, its one read of
// the device).
//
// Bound on an H100: bytes. Each distinct block is read once at least (16 B
// a row), plus the pair lists in, the pair counts out and 4 B per written
// position; the predicate on pairs x 4096 rows is a few integer
// instructions per row and query. chip_smoke.py reckons both from the
// run's pairs.
//
// What held the first version back: a block per pair in both passes, so
// each pass read a pair's 64 KB block once per pair (11,907 pairs over
// 6,361 distinct blocks at bench config 2: ~780 MB a pass against the
// bound's ~417 MB once).
//
// Design: two passes over a block-major order of the pairs that the host
// builds (ops.kernels.block_runs: a stable sort of the pairs by block, and
// where each distinct block's run starts).
//   - The count pass runs one 256-thread block per DISTINCT block: it loads
//     the block's JOIN_BLOCK rows once into registers (16 consecutive rows
//     a thread, 16-byte vectors; one chunk of count_predicate.cuh), and
//     while the loads are in flight stages the queries of its pairs, up to
//     a tile of them at a time, live slots only (a query out of range
//     stages dead). Per pair it runs the predicate on the rows in
//     registers and writes the pair's 4096-bit match mask (16 bits a
//     thread, 512 B a pair) to scratch the wrapper allocates, and its count
//     (per-warp sums, added once per tile). Its entry point then launches
//     a one-block scan that writes ends, the inclusive prefix sum of the
//     counts, so the wrapper launches no torch op between the passes.
//   - The write pass runs one block per pair: it reads the pair's 512 B
//     mask instead of its columns, places each thread's rows in shared
//     memory at a block-wide exclusive scan of the per-thread popcounts,
//     in row order, with no atomics (the output is deterministic), and
//     stores them at the pair's offset with neighbouring threads on
//     neighbouring positions (a thread's own rows would stride its
//     warp's stores across the output). A pair with 0 hits reads nothing;
//     one with every row of its block writes the block's rows without its
//     mask.
// A pair whose query or block lies out of range counts 0 and writes
// nothing (the caller checks the ranges; this keeps every read inside the
// columns).
//
// The overlap form (planned_count_overlap_kernel, counted apart as
// planned_gather_overlap) is select_many's retrieval on an
// extended-geometry store: it replaces make_planned_gather_step(...,
// overlap=True) (query.py:820) over _batched_overlap_masks (:636-658), the
// count pass playing the role of make_planned_count_step(overlap=True)
// (:716). It tests each pair's query with the overlap predicate
// (overlap_mask, box_time_mask) on a block's six bbox columns (xmin, ymin,
// xmax, ymax, bins, offs: 24 B a row); counts and the write pass are the
// point form's, so a pair's positions come out the same way. Bound: the
// same terms over 24 B a row.
//
// What held its first count pass back (0.0700 ms for both passes, 0.1809
// ms by CUDA events, at a 4M line store's 3,119 pairs over 877 blocks;
// bound 0.0294 ms): one 256-thread block per distinct block under
// __launch_bounds__(THREADS, 1), each thread holding 16 rows x 24 B in
// registers, so an SM ran one block of 8 warps that loaded its 96 KB,
// staged its pairs and tested them with nothing of the next block in
// flight.
//
// Its design now keeps more of the column bytes in flight on each SM: two
// 256-thread blocks a distinct block, one a half (2048 rows), each thread
// holding 8 rows in registers (two 16-byte loads a column: rows 4t..4t+3
// and 1024+4t..+3 of its half; 80 registers, so three blocks fit an SM
// where one did), placed by the hardware as blocks finish, so one block's
// staging and tests overlap the others' loads. Each half counts its pairs
// apart (pair_hits, ends) and the scan after the pass adds them while it
// writes ends. Each thread's 8 match bits are regrouped by two shuffles
// into the 16 consecutive rows a uint16 of the mask holds
// (store_half_words; its plain version is ops/kernels.py
// overlap_mask_words, over planned_overlap_rows), so the write pass reads
// the masks as the point form writes them. A persistent form over the
// overlap scan's two-chunk cp.async ring ran slower (PERF.md §7).
//
// Plain C entry points for ctypes; they launch on the caller's stream, do
// not synchronise, allocate nothing and return a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"
#include "launch_cache.cuh"
#include "overlap_cull.cuh"

namespace {

using namespace geomesa;

constexpr int JOIN_BLOCK = 4096;  // ops/kernels.py JOIN_BLOCK
static_assert(JOIN_BLOCK == CHUNK, "one pair's block is one chunk of THREADS x ROWS rows");
static_assert(ROWS == 16, "a thread's match mask is 16 bits of a pair's 512 B mask");
constexpr int PAIR_INTS = 1;  // a staged slot's pair index

// Stages the queries qs[0..k) in tile slots 0..k (live slots first, as
// stage_tile does; a query out of [0, q) stages with no live slot) and the
// pair indices ps[0..k) in t.extra; zeroes the per-warp counts. All threads
// call it; it ends in __syncthreads().
__device__ __forceinline__ void stage_pairs(const int32_t* __restrict__ boxes,
                                            const int32_t* __restrict__ times,
                                            const int32_t* __restrict__ qs,
                                            const int32_t* __restrict__ ps, int k, int q,
                                            const Tile& t) {
  const int nb = t.nb, nt = t.nt;
  int4* raw_win = reinterpret_cast<int4*>(t.win);
  for (int i = threadIdx.x; i < k * nb; i += THREADS) {
    const int qi = qs[i / nb];
    if (qi >= 0 && qi < q) t.box[i] = reinterpret_cast<const int4*>(boxes)[(int64_t)qi * nb + i % nb];
  }
  for (int i = threadIdx.x; i < k * nt; i += THREADS) {
    const int qi = qs[i / nt];
    if (qi >= 0 && qi < q) raw_win[i] = reinterpret_cast<const int4*>(times)[(int64_t)qi * nt + i % nt];
  }
  for (int i = threadIdx.x; i < k; i += THREADS) t.extra[i] = ps[i];
  for (int i = threadIdx.x; i < WARPS * t.q_tile; i += THREADS) t.cnt[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += THREADS) {
    const int qi = qs[i];
    int kb = 0, kt = 0;
    if (qi >= 0 && qi < q) {
      int4* bq = t.box + i * nb;
      for (int j = 0; j < nb; ++j) {
        const int4 b = bq[j];  // xlo, xhi, ylo, yhi
        if (b.x <= b.y && b.z <= b.w)
          bq[kb++] = make_int4(b.x, (int)((uint32_t)b.y - (uint32_t)b.x), b.z,
                               (int)((uint32_t)b.w - (uint32_t)b.z));
      }
      longlong2* wq = t.win + i * nt;
      const int4* wr = raw_win + i * nt;
      for (int j = 0; j < nt; ++j) {
        const int4 w = wr[j];  // blo, olo, bhi, ohi
        const long long lo = time_key(w.x, w.y), hi = time_key(w.z, w.w);
        if (lo <= hi) wq[kt++] = make_longlong2(lo, hi);
      }
    }
    t.live[i] = kb | (kt << 16);
  }
  __syncthreads();
}

// ends, the inclusive prefix sum of pair_hits over all pairs in pair order:
// one block, launched by the count pass's entry point after it. HALVES: the
// count pass counted each pair in two halves, the first in pair_hits and
// the second in ends; they are added into pair_hits first. Each pass
// stages ENDS_THREADS x ENDS_ITEMS counts in dynamic shared memory with
// coalesced loads, scans each thread's ENDS_ITEMS consecutive ones, then a
// block-wide scan of the threads' sums, and stores coalesced.
constexpr int ENDS_THREADS = 1024;
constexpr int ENDS_ITEMS = 8;                              // counts a thread scans a pass
constexpr int ENDS_SMEM = ENDS_THREADS * ENDS_ITEMS * 8;  // 64 KB staged a pass

template <bool HALVES>
__global__ void __launch_bounds__(ENDS_THREADS)
planned_ends_kernel(int64_t* __restrict__ pair_hits, int64_t* __restrict__ ends,
                    int64_t n_pairs) {
  extern __shared__ long long buf[];  // (ENDS_THREADS x ENDS_ITEMS)
  __shared__ long long warp_sum[ENDS_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (int64_t base = 0; base < n_pairs; base += (int64_t)ENDS_THREADS * ENDS_ITEMS) {
#pragma unroll
    for (int j = 0; j < ENDS_ITEMS; ++j) {
      const int64_t i = base + (int64_t)j * ENDS_THREADS + threadIdx.x;
      long long v = 0;
      if (i < n_pairs) {
        v = pair_hits[i] + (HALVES ? ends[i] : 0);
        if (HALVES) pair_hits[i] = v;
      }
      buf[j * ENDS_THREADS + threadIdx.x] = v;
    }
    __syncthreads();
    long long v[ENDS_ITEMS], sum = 0;
#pragma unroll
    for (int k = 0; k < ENDS_ITEMS; ++k) {
      v[k] = buf[threadIdx.x * ENDS_ITEMS + k];
      sum += v[k];
    }
    long long incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(FULL_WARP, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    long long at = carry + incl - sum, total = 0;
#pragma unroll
    for (int w = 0; w < ENDS_THREADS / 32; ++w) {
      const long long s = warp_sum[w];
      if (w < warp) at += s;
      total += s;
    }
#pragma unroll
    for (int k = 0; k < ENDS_ITEMS; ++k) {
      at += v[k];
      buf[threadIdx.x * ENDS_ITEMS + k] = at;  // the thread's own slots
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ENDS_ITEMS; ++j) {
      const int64_t i = base + (int64_t)j * ENDS_THREADS + threadIdx.x;
      if (i < n_pairs) ends[i] = buf[j * ENDS_THREADS + threadIdx.x];
    }
    carry += total;
    __syncthreads();  // buf and warp_sum are read before the next pass writes them
  }
}

__global__ void __launch_bounds__(THREADS, 2)
planned_count_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                     const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                     int64_t n, int64_t true_n,
                     const int32_t* __restrict__ order,    // (P,): pairs, block-major
                     const int32_t* __restrict__ order_q,  // (P,): their queries
                     const int32_t* __restrict__ starts,   // (D + 1,): runs in order
                     const int32_t* __restrict__ blocks,   // (D,): each run's block
                     const int32_t* __restrict__ boxes,    // (Q, nb, 4)
                     const int32_t* __restrict__ times,    // (Q, nt, 4)
                     int q, int nb, int nt, int tile,
                     int64_t* __restrict__ pair_hits,      // (P,)
                     uint16_t* __restrict__ masks) {       // (P, THREADS)
  extern __shared__ int4 smem[];
  const int d = blockIdx.x;
  const int s = starts[d], e = starts[d + 1];
  const int64_t blk = blocks[d];
  const bool blk_ok = blk >= 0 && blk < n / JOIN_BLOCK;  // block-uniform
  const int64_t row0 = blk * JOIN_BLOCK + (int64_t)threadIdx.x * ROWS;
  Rows rows;
  uint32_t valid = 0;
  if (blk_ok) valid = load_rows(x, y, bins, offs, n, valid_limit(n, 0, true_n), row0, rows);
  const Tile t = carve(smem, tile, nb, nt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p0 = s; p0 < e; p0 += tile) {
    const int k = min(tile, e - p0);
    stage_pairs(boxes, times, order_q + p0, order + p0, k, q, t);  // the loads are in flight
    for (int i = 0; i < k; ++i) {
      const int lv = t.live[i];
      uint32_t m = 0;
      if (blk_ok && (lv & 0xffff) && (lv >> 16)) {  // block-uniform
        if (lv == (1 | (1 << 16))) {
          m = box_mask<true>(t.box + i * nb, 1, rows) & valid;
          if (m) m &= time_mask<true>(t.win + i * nt, 1, rows);
        } else {
          m = box_mask<false>(t.box + i * nb, lv & 0xffff, rows) & valid;
          if (m) m &= time_mask<false>(t.win + i * nt, lv >> 16, rows);
        }
      }
      masks[(int64_t)t.extra[i] * THREADS + threadIdx.x] = (uint16_t)m;
      const int c = __reduce_add_sync(FULL_WARP, __popc(m));
      if (lane == 0) t.cnt[warp * tile + i] = c;
    }
    __syncthreads();  // the tile's per-warp counts are written
    for (int i = threadIdx.x; i < k; i += THREADS) {
      int64_t total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) total += t.cnt[w * tile + i];
      pair_hits[t.extra[i]] = total;
    }
    __syncthreads();  // the tile is read before the next is staged
  }
}

// A count block of the overlap form holds half a block: half h's rows
// h * HALF_ROWS + j * HALF_GROUP + 4t .. +3 at thread t, bit 4j + i for
// row + i (j = 0, 1): 8 rows a thread, each 16-byte group of a column one
// load, neighbouring threads on neighbouring groups.
constexpr int HALF_ROWS = JOIN_BLOCK / 2;  // 2048
constexpr int HALF_GROUP = THREADS * 4;    // 1024
static_assert(2 * HALF_GROUP == HALF_ROWS, "a half is two groups of THREADS x 4 rows");

// Loads the thread's 8 rows of the half at row0 (a block's first row plus
// h * HALF_ROWS) into registers; returns the mask of those below limit.
// n is a multiple of JOIN_BLOCK, so a valid block's rows are all in the
// columns.
__device__ __forceinline__ uint32_t load_half_rows(const BoxCols& cols, int64_t row0,
                                                   int64_t limit, ScanRows& rows) {
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t r = row0 + (int64_t)j * HALF_GROUP + 4 * threadIdx.x;
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
    const int64_t nv = limit - r;
    valid |= (nv >= 4 ? 0xfu : (nv <= 0 ? 0u : (1u << (int)nv) - 1)) << (4 * j);
  }
  return valid;
}

// Stores one pair's match bits m of the thread's 8 rows in half h as the
// write pass reads a mask: uint16 word w holds rows 16w .. 16w + 15, bit b
// row 16w + b. The low nibbles of threads 4u .. 4u + 3 are word 128h + u,
// their high nibbles word 128h + 64 + u: four lanes of one warp, gathered
// by two shuffles in lane 4(u % 8). All 32 lanes call it together.
__device__ __forceinline__ void store_half_words(uint16_t* __restrict__ words, uint32_t m,
                                                 int h) {
  uint32_t v = (m & 0xfu) | ((m & 0xf0u) << 12);  // low nibble: bits 0-3, high: 16-19
  v |= __shfl_down_sync(FULL_WARP, v, 1) << 4;
  v |= __shfl_down_sync(FULL_WARP, v, 2) << 8;
  if ((threadIdx.x & 3) == 0) {
    const int w = h * (HALF_ROWS / 16) + (threadIdx.x >> 2);
    words[w] = (uint16_t)v;
    words[w + HALF_GROUP / 16] = (uint16_t)(v >> 16);
  }
}

__global__ void __launch_bounds__(THREADS, 3)
planned_count_overlap_kernel(BoxCols cols, int64_t n, int64_t true_n,
                             const int32_t* __restrict__ order,    // (P,): pairs, block-major
                             const int32_t* __restrict__ order_q,  // (P,): their queries
                             const int32_t* __restrict__ starts,   // (D + 1,): runs in order
                             const int32_t* __restrict__ blocks,   // (D,): each run's block
                             const int32_t* __restrict__ boxes,    // (Q, nb, 4)
                             const int32_t* __restrict__ times,    // (Q, nt, 4)
                             int q, int nb, int nt, int tile,
                             int64_t* __restrict__ pair_hits,      // (P,): first halves' counts
                             int64_t* __restrict__ ends,           // (P,): second halves' counts
                             uint16_t* __restrict__ masks) {       // (P, THREADS)
  extern __shared__ int4 smem[];
  const int d = blockIdx.x >> 1, h = blockIdx.x & 1;
  const int s = starts[d], e = starts[d + 1];
  const int64_t blk = blocks[d];
  const bool blk_ok = blk >= 0 && blk < n / JOIN_BLOCK;  // block-uniform
  ScanRows rows;
  uint32_t valid = 0;
  if (blk_ok) valid = load_half_rows(cols, blk * JOIN_BLOCK + h * HALF_ROWS,
                                     valid_limit(n, 0, true_n), rows);
  const Tile t = carve(smem, tile, nb, nt);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t* counts = h ? ends : pair_hits;
  for (int p0 = s; p0 < e; p0 += tile) {
    const int k = min(tile, e - p0);
    stage_pairs(boxes, times, order_q + p0, order + p0, k, q, t);  // the loads are in flight
    for (int i = 0; i < k; ++i) {
      const int lv = t.live[i];
      uint32_t m = 0;
      if (blk_ok && (lv & 0xffff) && (lv >> 16)) {  // block-uniform
        if (lv == (1 | (1 << 16))) {
          m = overlap_mask<true>(t.box + i * nb, 1, rows) & valid;
          if (m) m &= box_time_mask<true>(t.win + i * nt, 1, rows);
        } else {
          m = overlap_mask<false>(t.box + i * nb, lv & 0xffff, rows) & valid;
          if (m) m &= box_time_mask<false>(t.win + i * nt, lv >> 16, rows);
        }
      }
      store_half_words(masks + (int64_t)t.extra[i] * THREADS, m, h);
      const int c = __reduce_add_sync(FULL_WARP, __popc(m));
      if (lane == 0) t.cnt[warp * tile + i] = c;
    }
    __syncthreads();  // the tile's per-warp counts are written
    for (int i = threadIdx.x; i < k; i += THREADS) {
      int64_t total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) total += t.cnt[w * tile + i];
      counts[t.extra[i]] = total;
    }
    __syncthreads();  // the tile is read before the next is staged
  }
}

__global__ void __launch_bounds__(THREADS)
planned_write_kernel(const int32_t* __restrict__ pair_blk,   // (P,)
                     const int64_t* __restrict__ pair_hits,  // (P,)
                     const int64_t* __restrict__ ends,       // (P,): inclusive prefix of hits
                     const uint16_t* __restrict__ masks,     // (P, THREADS)
                     int32_t* __restrict__ positions) {      // (H,)
  __shared__ int32_t rows_out[JOIN_BLOCK];  // the pair's positions, in order
  __shared__ int warp_sum[WARPS];
  const int64_t p = blockIdx.x;
  const int hits = (int)pair_hits[p];
  if (hits == 0) return;  // block-uniform: also every pair out of range
  const int32_t blk0 = pair_blk[p] * JOIN_BLOCK;  // global positions are int32 (n < 2^31)
  int32_t* out = positions + (ends[p] - hits);
  if (hits == JOIN_BLOCK) {  // every row matched: the block's rows, in order
    for (int i = threadIdx.x; i < JOIN_BLOCK; i += THREADS) out[i] = blk0 + i;
    return;
  }
  uint32_t m = masks[p * THREADS + threadIdx.x];
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
  int at = incl - c;
  for (int w = 0; w < warp; ++w) at += warp_sum[w];
  const int32_t row0 = blk0 + threadIdx.x * ROWS;
  while (m) {
    const int r = __ffs(m) - 1;
    m &= m - 1;
    rows_out[at++] = row0 + r;
  }
  __syncthreads();  // neighbouring threads store neighbouring positions
  for (int i = threadIdx.x; i < hits; i += THREADS) out[i] = rows_out[i];
}

LaunchCache ends_cache[2];  // per HALVES: the scan's shared-memory attribute

// Launches the scan of the counts (one block) on the stream.
template <bool HALVES>
cudaError_t launch_ends(int64_t* pair_hits, int64_t* ends, int64_t n_pairs, cudaStream_t st) {
  int per_sm = 1;
  const cudaError_t e = resident_blocks(planned_ends_kernel<HALVES>, ENDS_THREADS, ENDS_SMEM,
                                        ends_cache[HALVES], &per_sm);
  if (e != cudaSuccess) return e;
  planned_ends_kernel<HALVES><<<1, ENDS_THREADS, ENDS_SMEM, st>>>(pair_hits, ends, n_pairs);
  return cudaGetLastError();
}

}  // namespace

// The count pass and its prefix sum: plan is the host's block-major order
// packed as int32 [order (P) | order_q (P) | starts (D + 1) | blocks (D)]
// on the device; pair_hits and ends (P int64), masks (P x THREADS uint16)
// out.
extern "C" int geomesa_planned_gather_count(const void* x, const void* y, const void* bins,
                                            const void* offs, long long n, long long true_n,
                                            const void* plan, long long n_pairs,
                                            long long n_blocks, const void* boxes,
                                            const void* times, int q, int nb, int nt,
                                            void* pair_hits, void* ends, void* masks,
                                            void* stream) {
  if (n_pairs <= 0 || n_blocks <= 0 || n <= 0) return (int)cudaSuccess;
  if (n_pairs > 0x7fffffffLL || n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tile = q_tile_for(nb, nt, PAIR_INTS);
  const size_t smem = (size_t)tile * staged_bytes_per_query(nb, nt, PAIR_INTS);
  const int32_t* p = (const int32_t*)plan;
  planned_count_kernel<<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins, (const int32_t*)offs, n,
      true_n, p, p + n_pairs, p + 2 * n_pairs, p + 2 * n_pairs + n_blocks + 1,
      (const int32_t*)boxes, (const int32_t*)times, q, nb, nt, tile, (int64_t*)pair_hits,
      (uint16_t*)masks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ends<false>((int64_t*)pair_hits, (int64_t*)ends, n_pairs,
                                 (cudaStream_t)stream);
}

// The overlap form's count pass: columns xmin, ymin, xmax, ymax, bins, offs;
// its write pass is geomesa_planned_gather_write. Two blocks a distinct
// block, one a half.
extern "C" int geomesa_planned_gather_overlap_count(
    const void* xmin, const void* ymin, const void* xmax, const void* ymax, const void* bins,
    const void* offs, long long n, long long true_n, const void* plan, long long n_pairs,
    long long n_blocks, const void* boxes, const void* times, int q, int nb, int nt,
    void* pair_hits, void* ends, void* masks, void* stream) {
  if (n_pairs <= 0 || n_blocks <= 0 || n <= 0) return (int)cudaSuccess;
  if (n_pairs > 0x7fffffffLL || n_blocks > 0x3fffffffLL || n % JOIN_BLOCK)
    return (int)cudaErrorInvalidValue;
  const int tile = q_tile_for(nb, nt, PAIR_INTS);
  const size_t smem = (size_t)tile * staged_bytes_per_query(nb, nt, PAIR_INTS);
  const int32_t* p = (const int32_t*)plan;
  const BoxCols cols{{(const int32_t*)xmin, (const int32_t*)ymin, (const int32_t*)xmax,
                      (const int32_t*)ymax, (const int32_t*)bins, (const int32_t*)offs}};
  planned_count_overlap_kernel<<<(unsigned)(2 * n_blocks), THREADS, smem, (cudaStream_t)stream>>>(
      cols, n, true_n, p, p + n_pairs, p + 2 * n_pairs, p + 2 * n_pairs + n_blocks + 1,
      (const int32_t*)boxes, (const int32_t*)times, q, nb, nt, tile, (int64_t*)pair_hits,
      (int64_t*)ends, (uint16_t*)masks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ends<true>((int64_t*)pair_hits, (int64_t*)ends, n_pairs,
                                (cudaStream_t)stream);
}

// The write pass: positions from the count pass's masks, counts and ends.
extern "C" int geomesa_planned_gather_write(const void* pair_blk, long long n_pairs,
                                            const void* pair_hits, const void* ends,
                                            const void* masks, void* positions, void* stream) {
  if (n_pairs <= 0) return (int)cudaSuccess;
  if (n_pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  planned_write_kernel<<<(unsigned)n_pairs, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pair_blk, (const int64_t*)pair_hits, (const int64_t*)ends,
      (const uint16_t*)masks, (int32_t*)positions);
  return (int)cudaGetLastError();
}
