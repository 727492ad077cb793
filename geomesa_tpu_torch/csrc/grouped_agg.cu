// grouped_agg: Q bbox+time GROUP BY queries over the resident point columns,
// the device half of DataStore.aggregate_many. Two kernels: a work list of
// the kept (chunk, query) pairs, then the fold over it.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:1498
// (make_grouped_agg_step, point mode, one shard, without with_ttl). It is
// not a TPU kernel: the reference computes it in XLA, and counts there with
// _onehot_bincount (:1464), one-hot matmuls on the MXU, a TPU device for
// the lack of a scatter. This card has atomics, in shared memory too.
//
// What it computes, per query q and row r (local position lpos), with
// in_all and the boundary split of batched_edge_gather.cu (the reference
// builds both from _slot_point :309 and _slot_time_edge :331):
//   boundary = in_all & (on a live box's edge bucket | at a live window's end)
//   fold     = in_all & ~boundary
// and, over the fold rows of each group g = gid[r] in [0, G) (a row with a
// gid outside it folds nowhere, as an out-of-range segment id in the
// reference's segment_sum):
//   cnt[q][g]      = their count;      first[q][g] = min rowid[r]
//   vcnt[q][v][g]  = their non-NaN values of column v;
//   vsum[q][v][g]  = the sum of those values;
//   vmin/vmax      = their min and max, as order keys (below).
// The boundary rows go to per-query lanes as the edge gather's candidates
// do: hits[q] = their true count, pos[q][0..cap) = global positions base +
// lpos of min(hits, cap) of them in no particular order (the wrapper sorts
// them). The host re-tests them against the f64 filter and ADDS the ones
// that pass, which is sound for min and max too.
//
// The work list's launch first fills cnt, vcnt, vsum and hits with 0,
// first with INT32_MAX, pos with -1, vmin with the order key of +inf and
// vmax with that of -inf (fill_outputs). An order key is the double's bits as a
// signed 64-bit integer, with the sign bit's companions flipped for a
// negative double (b ^ 0x7fff...f): signed order of the keys is the order
// of the doubles (NaN never folds), so vmin and vmax fold as 64-bit integer
// min / max. The launch ends by decoding them in place with the same
// involution and sorting each query's lanes (agg_finish_kernel), so the
// wrapper reads doubles and sorted lanes. aggregate_many's device work is
// three launches: the work list with the fills, the fold, the finish.
//
// Bound on an H100: bytes. The four columns are read once (16 B a row:
// 0.2388 ms for 50M rows at 3.35 TB/s), plus gid, rowid and every value of
// each row that folds in some query, plus the outputs written once. The
// work list's own bound (its extent tests; the extents and payload read,
// the kept pairs and runs written once) is under a microsecond: it is
// bound by its launch and the latency of its few dependent steps.
//
// What held the first version back: it folded every (row, query) with 2 +
// 4 V global atomics (116M at bench config 9, ~2.7 of its 3.1 ms), because
// its grid was chunk-major (one block serves all of its tile's queries on
// a chunk) and 64 queries x 1024 groups x 36 B of partials fit no block's
// shared memory.
//
// Design: query-major runs, one query a block at a time.
//   1. agg_work_list_kernel, one launch before the fold, over ceil(Q / 8) x
//      S items: item (query group g, segment s) tests the live slots of
//      LIST_QUERIES = 8 queries (stage_tile) against the extents of
//      LIST_SEG_CHUNKS = 1024 consecutive chunks (min and max of x, y and
//      the biased time key over the chunk's 4096 loaded rows, valid or not,
//      as chunk_cull.cuh's cull_scan takes them; the wrapper passes them,
//      computed once when the columns are staged) with chunk_cull.cuh's
//      exact test (meets). Each warp tests 32 consecutive extents a step,
//      LIST_STEPS steps, against each query and keeps the ballots. The
//      item first writes -1 in its segment's slots of each query's list,
//      then publishes each query's count for the segment (a flag in the
//      wrapper's scratch), and warp w reads the counts of query w's earlier
//      segments (a look-back, one read a segment) for the query's offset;
//      the item then writes its kept chunks there in chunk order, each
//      lane its own (ballot and popc, no barrier between warps), over the
//      -1s of its own and earlier segments (a later segment writes only
//      after it has read this item's flag, published after the fill).
//      The query's last segment writes kept[q]. The grid is no larger than
//      the blocks the card holds at once, and each block walks its items
//      (g, s) in increasing order, so an item waits only on items that run
//      or ran on a resident block. Every block also writes a slice of the
//      fold's initial outputs (what agg_init_kernel did), so the fold needs
//      no launch of its own for them. The last block to finish cuts every
//      list into runs of run_len chunks, run_len = max(min_run, ceil(kept
//      pairs / target_runs)), so that the fold's resident blocks each take
//      a few runs: the run table (query, first, end) in query order with
//      its -1 tail, the number of runs and the work ints; it leaves the
//      scratch zeroed for the next launch.
//   2. grouped_agg_kernel, persistent: sms x blocks-per-SM blocks; each
//      takes the next run (one atomicAdd), stages its query when it
//      changes, and streams the run's chunks through the cp.async double
//      buffer (prefetch_chunk / take_chunk). Per chunk: the match mask, the
//      edge split (edge_mask, append_lanes: bit for bit the edge gather's),
//      then each lane folds its fold rows: their gid, rowid and values are
//      loaded together (one latency a chunk), then folded with atomics.
//      Mode SHARED (G x (8 + 28 V) B of partials fit beside the 64 KB row
//      buffer): the atomics go to the run's partials in shared memory
//      (int add and min for counts and first rows; f64 add and 64-bit min
//      / max on order keys, which shared memory does by compare-and-swap
//      loops), and at the end of the run one global atomic per touched
//      (group, field) adds them to the outputs. Mode GLOBAL (larger G x V, up to
//      aggregate_many's 65536 groups): the fold's atomics go straight to
//      the outputs, as the first version's did, over the same runs. The
//      wrapper chooses the mode by shape (geomesa_grouped_agg_mode); a
//      CUDA tensor always launches one of the two. Its launch attributes
//      and occupancy are kept per mode and shared size (launch_cache.cuh).
//
// What held the first work list back (0.1168 ms by CUDA events, 0.0438 of
// device work at bench config 9: 12,208 chunks, 64 queries): one block per
// query (64 blocks on 132 SMs), each walking every extent in steps of 2048
// chunks with two barriers a step; the last block cutting every run alone;
// five cudaMemsetAsync launches before the kernel (the lists' -1 fill is
// Q x C x 4 B) and agg_init_kernel after it; and the fold's launch setting
// two attributes and asking the occupancy on every call.
//
// The overlap form (overlap_fold_kernel, entry point
// geomesa_grouped_agg_overlap) is the same fold over a line or polygon
// store's bbox columns (xmin, ymin, xmax, ymax, bins, offs): the overlap mode
// of make_grouped_agg_step (query.py:1498 with overlap=True, per-slot
// predicate _slot_overlap :316). A row matches when its bbox overlaps a live
// box and its (bin, offset) lies in a live window; it is a boundary row when
// it also shares an opposing edge bucket with a box it overlaps or sits at a
// window's end: overlap_cull.cuh's overlap_mask, box_time_mask and
// overlap_edge_mask, the overlap edge gather's tests (4 rows a thread of a
// 1024-thread block, chunk_row<FOLD_GROUP_ROWS>, append_lanes), so its
// lanes hold the edge gather's boundary rows (the same ones where they fit;
// a subset of them where a query's overflow). Its work list is the
// point form's over the bbox state's extents (ops/kernels.py
// chunk_extents_bbox: min xmin, max xmax, min ymin, max ymax and the time
// key's range per chunk), whose test meets() is an exact superset for
// overlap too: a row overlapping live box q has xmin <= qxhi and xmax >=
// qxlo, so the chunk's min xmin <= qxhi and max xmax >= qxlo, and likewise
// in y (overlap_cull.cuh's cull note).
//
// Bound of the overlap form on an H100: bytes, 24 B of every loaded row
// (phase 9c of chip_smoke.py: 4M line strings, 977 chunks, 64 queries) plus
// the folded rows' gid, rowid and values. What held its first version back
// (0.2502 ms of device time against 0.0395): it folded query-major runs, so
// a chunk kept by ~3.9 queries was read ~3.9 times (370 MB where the bound
// charges 96), by blocks at different places of the store at once, from
// device memory (the columns are larger than the 50 MB L2); and it loaded
// its rows straight into registers with no copy in flight. The design:
//   - window runs: the work list cuts each query's kept chunks at the edges
//     of aligned windows of WINDOW = 8 chunks and orders the runs by
//     (window, query) (agg_work_list_kernel's cells), so the queries that
//     keep a window's chunks fold them at about the same time;
//   - a fold block takes FOLD_K consecutive runs at once (mostly several
//     queries of one window), walks the union of their chunks in order
//     (seq_c, with the runs that keep each chunk in seq_m) and reads each
//     chunk once for all of them: 1024 threads, 4 rows a thread (at most
//     64 registers, so 32 warps an SM hide the fold's latencies), the six
//     columns through a one-chunk cp.async ring (96 KB; the next chunk's
//     copy is in flight while this one is masked and folded), and one
//     partial set a run in shared memory, as many as fit beside the ring
//     (ov_fold_sets; none: GLOBAL mode, the fold's atomics on the outputs,
//     as the point form's), flushed once an item;
//   - a row's gid, rowid and values are loaded once for all the item's
//     runs that fold it (fold_rows_k);
//   - the fold's own atomics, its main cost (clock counters in a copy of
//     the kernel ranked them first): a shared f64 add and a shared 64-bit
//     min or max are compare-and-swap loops, so the sums go
//     to the outputs as global reductions (no result waited for), the
//     partial sets keep counts, first rows, min and max (G x (8 + 20 V)
//     B), and a min or max reads its partial first and skips an atomic
//     that cannot move it.
// One block an SM (96 KB of ring and up to three 28 KB partial sets at G =
// 1024, V = 1).
//
// Sums: atomics fold in no fixed order (neither within a run nor across
// runs), so sums may differ from a sequential sum in the last bits: the
// callers state a relative 1e-12. Counts, first, min and max are exact.
//
// Plain C entry points for ctypes; they launch on the caller's stream, do
// not synchronise, allocate nothing and return a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_cull.cuh"
#include "count_predicate.cuh"
#include "launch_cache.cuh"
#include "overlap_cull.cuh"

namespace {

using namespace geomesa;

// the work ints (the work list's last block writes them): blocks done with
// their lists (Q), the next run to take (0), the runs, run_len, the kept
// pairs, and the global atomics the SHARED mode's flushes issued (0)
enum { W_DONE, W_NEXT, W_RUNS, W_RUN_LEN, W_PAIRS, W_FLUSHED, W_INTS };
// the work list's scratch (the wrapper's, zeroed once; every launch leaves
// it zeroed): the blocks done, then one flag a (query, segment): 0 until
// its count c is published as c + 1
enum { S_DONE, S_FLAGS };
constexpr int LIST_STEPS = 4;                             // 32-extent steps a warp takes
constexpr int LIST_SEG_CHUNKS = WARPS * 32 * LIST_STEPS;  // chunks a work-list block tests
constexpr int LIST_QUERIES = 8;                           // queries a work-list block tests
constexpr int RUNS_PER_BLOCK = 4;  // target runs per resident fold block
// The overlap form's runs: each query's kept chunks cut at the edges of
// aligned windows of WINDOW chunks, in (window, query) order (a
// divisor of 32: a window is a bit field of a warp's 32-chunk ballot).
constexpr int WINDOW = 8;
static_assert(32 % WINDOW == 0, "a window is a bit field of one 32-chunk ballot");

// The order keys of +inf and -inf (order_key below).
constexpr long long KEY_POS_INF = 0x7ff0000000000000LL;
constexpr long long KEY_NEG_INF = (long long)0x800fffffffffffffULL;

// The fold's outputs and their sizes, for the work list's fills (cnt null:
// no fill, the work list launched alone).
struct Fills {
  int32_t* cnt;
  int32_t* first;
  int32_t* vcnt;
  double* vsum;
  long long* vmin;
  long long* vmax;
  int32_t* hits;
  int32_t* pos;
  int64_t qg, qvg, q, qcap;
};

// This block's share of the fold's initial outputs: 0 counts, sums and
// hits, INT32_MAX first rows, the order keys of +inf / -inf, -1 lanes;
// neighbouring threads on neighbouring elements.
__device__ __forceinline__ void fill_outputs(const Fills& f) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t i0 = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int64_t i = i0; i < f.qvg; i += step)
    f.vcnt[i] = 0, f.vsum[i] = 0.0, f.vmin[i] = KEY_POS_INF, f.vmax[i] = KEY_NEG_INF;
  for (int64_t i = i0; i < f.qg; i += step) f.cnt[i] = 0, f.first[i] = INT32_MAX;
  for (int64_t i = i0; i < f.qcap; i += step) f.pos[i] = -1;
  for (int64_t i = i0; i < f.q; i += step) f.hits[i] = 0;
}

// Exclusive prefix of v over the block's threads, in thread order; total
// gets the block's sum. All threads call it; it holds two barriers.
__device__ __forceinline__ int block_exclusive(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL_WARP, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = incl - v;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int s = warp_tot[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();
  return before;
}

// WINDOWS: the overlap form's window runs (cells), else the point form's.
template <bool WINDOWS>
__global__ void __launch_bounds__(THREADS)
agg_work_list_kernel(const Extent* __restrict__ ext, int64_t n_chunks, int64_t live_chunks,
                     const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                     const int32_t* __restrict__ times,  // (Q, nt, 4)
                     int q, int nb, int nt, int segs, int target_runs, int min_run,
                     int max_runs,
                     int32_t* __restrict__ list,    // (Q, n_chunks): kept chunks, in order
                     int32_t* __restrict__ kept,    // (Q,)
                     int32_t* __restrict__ run_q,   // (max_runs,)
                     int32_t* __restrict__ run_s,   // (max_runs,)
                     int32_t* __restrict__ run_e,   // (max_runs,)
                     int32_t* __restrict__ work,    // (W_INTS,)
                     int32_t* __restrict__ scratch,  // (S_FLAGS + Q x segs,), zeroed
                     int32_t* __restrict__ cells,  // WINDOWS: (n_windows, Q, 2)
                     int n_windows, Fills fills) {
  static_assert(LIST_QUERIES == WARPS, "warp w looks back for query w of the block");
  extern __shared__ int4 smem[];
  __shared__ int meta[2];
  __shared__ int warp_cnt[WARPS][LIST_QUERIES];  // kept chunks per (warp, query)
  __shared__ int offset_s[LIST_QUERIES];         // each query's first slot of this segment
  __shared__ int warp_tot[WARPS];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  if (fills.cnt) fill_outputs(fills);
  if constexpr (WINDOWS) {  // every block fills a slice of the run table's -1s
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < max_runs; i += step)
      run_q[i] = run_s[i] = run_e[i] = -1;
  }
  const int items = (q + LIST_QUERIES - 1) / LIST_QUERIES * segs;
  // items (group, segment) group-major, in increasing order per block: an
  // item waits only on the same group's earlier segments, which come
  // earlier in every block's order, and every block is resident at once
  // (the grid is no larger), so every wait ends
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int q0 = item / segs * LIST_QUERIES, seg = item % segs;
    const int qt = min(LIST_QUERIES, q - q0);
    // the warp's extents, loaded before the queries are staged
    const int64_t c0 = (int64_t)seg * LIST_SEG_CHUNKS + (int64_t)warp * 32 * LIST_STEPS + lane;
    Extent e[LIST_STEPS];
#pragma unroll
    for (int k = 0; k < LIST_STEPS; ++k) {
      const int64_t c = c0 + 32 * k;
      if (c < live_chunks) e[k] = ext[c];
    }
    // -1 in this segment's slots of each query's list; kept chunks of this
    // and later segments overwrite the head of it after this item publishes
    const int64_t cs = (int64_t)seg * LIST_SEG_CHUNKS;
    const int64_t ce = cs + LIST_SEG_CHUNKS < n_chunks ? cs + LIST_SEG_CHUNKS : n_chunks;
    for (int i = 0; i < qt; ++i) {
      int32_t* row = list + (int64_t)(q0 + i) * n_chunks;
      for (int64_t c = cs + threadIdx.x; c < ce; c += THREADS) row[c] = -1;
    }
    const Tile t = carve(smem, LIST_QUERIES, nb, nt);
    stage_tile(boxes, times, q0, qt, t, meta);
    unsigned keep[LIST_QUERIES][LIST_STEPS];
#pragma unroll
    for (int i = 0; i < LIST_QUERIES; ++i) {
#pragma unroll
      for (int k = 0; k < LIST_STEPS; ++k)
        keep[i][k] =
            __ballot_sync(FULL_WARP, i < qt && c0 + 32 * k < live_chunks && meets(t, i, e[k]));
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < LIST_QUERIES; ++i) {
        int c = 0;
#pragma unroll
        for (int k = 0; k < LIST_STEPS; ++k) c += __popc(keep[i][k]);
        warp_cnt[warp][i] = c;
      }
    }
    __threadfence();  // the -1 fill is visible before any count is published
    __syncthreads();
    // warp w publishes query w's count for this segment, then sums the
    // counts of its earlier segments
    if (warp < qt) {
      const int qi = q0 + warp;
      int total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) total += warp_cnt[w][warp];
      int* flags = scratch + S_FLAGS + (int64_t)qi * segs;
      if (lane == 0) atomicExch(flags + seg, total + 1);
      int prefix = 0;
      for (int j0 = 0; j0 < seg; j0 += 32) {
        const int j = j0 + lane;
        int c = 0;
        if (j < seg) {
          const volatile int* f = flags + j;
          while ((c = *f) == 0) __nanosleep(64);
          c -= 1;
        }
        prefix += __reduce_add_sync(FULL_WARP, c);
      }
      __threadfence();  // the earlier segments' fills come before this item's writes
      if (lane == 0) {
        offset_s[warp] = prefix;
        if (seg == segs - 1) kept[qi] = prefix + total;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < LIST_QUERIES; ++i) {
      if (i < qt) {
        int32_t* row = list + (int64_t)(q0 + i) * n_chunks;
        int at = offset_s[i];
        for (int w = 0; w < warp; ++w) at += warp_cnt[w][i];
#pragma unroll
        for (int k = 0; k < LIST_STEPS; ++k) {
          if ((keep[i][k] >> lane) & 1u)
            row[at + __popc(keep[i][k] & below)] = (int32_t)(c0 + 32 * k);
          // window runs: lane m writes (first slot, kept chunks) of window m of the step
          if (WINDOWS && lane < 32 / WINDOW) {
            const int64_t w = (c0 - lane + 32 * k) / WINDOW + lane;
            if (w < n_windows) {
              const unsigned lo = lane * WINDOW;
              const unsigned field =
                  WINDOW == 32 ? keep[i][k] : (keep[i][k] >> lo) & ((1u << WINDOW) - 1);
              int32_t* cell = cells + 2 * (w * q + q0 + i);
              cell[0] = at + (lo ? __popc(keep[i][k] & ((1u << lo) - 1)) : 0);
              cell[1] = __popc(field);
            }
          }
          at += __popc(keep[i][k]);
        }
      }
    }
    __syncthreads();  // warp_cnt, offset_s and the tile are read before the next item
  }

  // the last block to finish cuts every query's list into runs
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(scratch + S_DONE, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int pairs = 0;
  for (int i0 = 0; i0 < q; i0 += THREADS) {
    const int i = i0 + threadIdx.x;
    int step_total;
    block_exclusive(i < q ? __ldcg(kept + i) : 0, warp_tot, step_total);
    pairs += step_total;
  }
  if constexpr (WINDOWS) {
    // window runs: one a (window, query) cell that kept a chunk, in (window,
    // query) order; PER consecutive cells a thread, read in one round and
    // placed by a block scan
    constexpr int PER = 16;
    const int64_t n_cells = (int64_t)n_windows * q;
    int runs = 0;
    for (int64_t f0 = 0; f0 < n_cells; f0 += (int64_t)THREADS * PER) {
      const int64_t f1 = f0 + (int64_t)threadIdx.x * PER;
      int2 cell[PER];
      int mine = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        cell[j] = f1 + j < n_cells ? __ldcg(reinterpret_cast<const int2*>(cells) + f1 + j)
                                   : make_int2(0, 0);
        mine += cell[j].y > 0;
      }
      int step_total;
      int at = runs + block_exclusive(mine, warp_tot, step_total);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (cell[j].y > 0) {
          run_q[at] = (int32_t)((f1 + j) % q);
          run_s[at] = cell[j].x;
          run_e[at] = cell[j].x + cell[j].y;
          ++at;
        }
      }
      runs += step_total;
    }
    if (threadIdx.x == 0) {
      work[W_DONE] = q;
      work[W_NEXT] = 0;
      work[W_RUNS] = runs;
      work[W_RUN_LEN] = WINDOW;
      work[W_PAIRS] = pairs;
      work[W_FLUSHED] = 0;
      scratch[S_DONE] = 0;
    }
    for (int64_t i = threadIdx.x; i < (int64_t)q * segs; i += THREADS) scratch[S_FLAGS + i] = 0;
    return;
  }
  const int run_len = max(min_run, (pairs + target_runs - 1) / target_runs);
  int runs = 0;
  for (int i0 = 0; i0 < q; i0 += THREADS) {
    const int i = i0 + threadIdx.x;
    const int k = i < q ? __ldcg(kept + i) : 0;
    const int nr = (k + run_len - 1) / run_len;
    int step_total;
    const int at_q = runs + block_exclusive(nr, warp_tot, step_total);
    for (int r = 0; r < nr; ++r) {
      run_q[at_q + r] = i;
      run_s[at_q + r] = r * run_len;
      run_e[at_q + r] = min(k, (r + 1) * run_len);
    }
    runs += step_total;
  }
  for (int i = runs + threadIdx.x; i < max_runs; i += THREADS) run_q[i] = run_s[i] = run_e[i] = -1;
  if (threadIdx.x == 0) {
    work[W_DONE] = q;
    work[W_NEXT] = 0;
    work[W_RUNS] = runs;
    work[W_RUN_LEN] = run_len;
    work[W_PAIRS] = pairs;
    work[W_FLUSHED] = 0;
    scratch[S_DONE] = 0;
  }
  for (int64_t i = threadIdx.x; i < (int64_t)q * segs; i += THREADS) scratch[S_FLAGS + i] = 0;
}

// The order key of a double: signed 64-bit order == the doubles' order.
__device__ __forceinline__ long long order_key(double v) {
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

// Where one query's folds go: its (G,) and (V, G) slices of the outputs
// (mode GLOBAL) or the block's shared partials of the same layout (SHARED).
struct Acc {
  int32_t* cnt;
  int32_t* first;
  int32_t* vcnt;
  double* vsum;
  long long* vmin;
  long long* vmax;
};

// Folds the lane's fold rows f (bit r is chunk row chunk0 + chunk_row(r))
// into acc: gid, rowid and the first value column are loaded for all of
// them first, so a lane waits one latency for the three (and one more per
// further value column), then folded with atomics
// (in shared memory, f64 add and 64-bit min / max are compare-and-swap
// loops: batching a lane's CAS by hand measured 4x slower on the fold).
__device__ __forceinline__ void fold_rows(uint32_t f, int64_t chunk0,
                                          const int32_t* __restrict__ gid,
                                          const int32_t* __restrict__ rowid,
                                          const double* __restrict__ vals, int64_t n, int nv,
                                          int g, const Acc& acc) {
  int gq[ROWS], rq[ROWS];
  double vq[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    gq[r] = -1;
    rq[r] = 0;
    vq[r] = 0.0;
    if ((f >> r) & 1u) {
      gq[r] = __ldg(gid + chunk0 + chunk_row(r));
      rq[r] = __ldg(rowid + chunk0 + chunk_row(r));
      if (nv) vq[r] = __ldg(vals + chunk0 + chunk_row(r));  // value column 0, in the same wait
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if ((unsigned)gq[r] < (unsigned)g) {  // also false for rows not in f
      atomicAdd(acc.cnt + gq[r], 1);
      atomicMin(acc.first + gq[r], rq[r]);
    }
  }
  for (int v = 0; v < nv; ++v) {
    if (v) {
      const double* col = vals + (int64_t)v * n + chunk0;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        vq[r] = (unsigned)gq[r] < (unsigned)g ? __ldg(col + chunk_row(r)) : 0.0;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if ((unsigned)gq[r] < (unsigned)g && !isnan(vq[r])) {
        const int at = v * g + gq[r];
        atomicAdd(acc.vcnt + at, 1);
        atomicAdd(acc.vsum + at, vq[r]);
        const long long key = order_key(vq[r]);
        atomicMin(acc.vmin + at, key);
        atomicMax(acc.vmax + at, key);
      }
    }
  }
}

// Streams chunks list[s..e) of the staged query (tile slot 0) through the
// prefetch buffer: match, edge split, lanes, fold. All threads call it.
template <bool FAST>
__device__ __forceinline__ void fold_run(const BoxCols& cols, int64_t n, int64_t base,
                                         int64_t limit, const Tile& t,
                                         const int32_t* __restrict__ list, int s, int e,
                                         int4* buf, const int32_t* __restrict__ gid,
                                         const int32_t* __restrict__ rowid,
                                         const double* __restrict__ vals, int nv, int g,
                                         const Acc& acc, int32_t* hits, int32_t* pos, int cap) {
  const int32_t *x = cols.c[0], *y = cols.c[1], *bins = cols.c[2], *offs = cols.c[3];
  const int lv = FAST ? 0 : t.live[0];
  prefetch_chunk(buf, x, y, bins, offs, n, list[s]);
  for (int i = s; i < e; ++i) {
    const int64_t chunk0 = (int64_t)list[i] * CHUNK;
    Rows rows;
    const uint32_t valid = take_chunk(buf, chunk0, limit, rows);
    const uint32_t inb = box_mask<FAST>(t.box, lv & 0xffff, rows) & valid;
    const uint32_t m = inb & time_mask<FAST>(t.win, lv >> 16, rows);
    // both masks have consumed every value the thread read from its buffer
    // slots, so the next chunk's copy into them starts now
    if (i + 1 < e) prefetch_chunk(buf, x, y, bins, offs, n, list[i + 1]);
    if (!__any_sync(FULL_WARP, m)) continue;  // warp-uniform
    const uint32_t ed = m ? edge_mask(t, 0, m, rows) : 0u;
    append_lanes(ed, base + chunk0, hits, pos, cap);
    const uint32_t f = m & ~ed;
    if (f) fold_rows(f, chunk0, gid, rowid, vals, n, nv, g, acc);
  }
}

// Bytes of one query's shared partials: vsum, vmin, vmax (8 B each), then
// cnt, first and vcnt (4 B each).
__host__ __device__ constexpr long long partial_bytes(int nv, int g) {
  return (long long)g * (8 + 28LL * nv);
}

__host__ __device__ constexpr int tile_bytes(int nb, int nt) {
  return (staged_bytes_per_query(nb, nt, 0) + 15) / 16 * 16;
}

template <bool SHARED>
__global__ void __launch_bounds__(THREADS, 2)
grouped_agg_kernel(const BoxCols cols,  // x, y, bins, offs
                   int64_t n, int64_t base, int64_t true_n,
                   const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                   const int32_t* __restrict__ times,  // (Q, nt, 4)
                   int nb, int nt,
                   const int32_t* __restrict__ list, int64_t n_chunks,
                   const int32_t* __restrict__ run_q, const int32_t* __restrict__ run_s,
                   const int32_t* __restrict__ run_e, int32_t* __restrict__ work,
                   const int32_t* __restrict__ gid, const int32_t* __restrict__ rowid,
                   const double* __restrict__ vals, int32_t* __restrict__ cnt,
                   int32_t* __restrict__ first, int32_t* __restrict__ vcnt,
                   double* __restrict__ vsum, long long* __restrict__ vmin,
                   long long* __restrict__ vmax, int32_t* __restrict__ hits,
                   int32_t* __restrict__ pos, int nv, int g, int cap) {
  extern __shared__ int4 smem[];  // the row buffer, the staged query, the partials
  __shared__ int meta[2];
  __shared__ int run[3];
  int4* buf = smem;
  char* tile_at = reinterpret_cast<char*>(smem + ROW_BUF_BYTES / 16);
  const Tile t = carve(tile_at, 1, nb, nt);
  const int64_t vg = (int64_t)nv * g;
  Acc part{};
  if (SHARED) {
    double* ps = reinterpret_cast<double*>(tile_at + tile_bytes(nb, nt));
    part.vsum = ps;
    part.vmin = reinterpret_cast<long long*>(ps + vg);
    part.vmax = part.vmin + vg;
    part.cnt = reinterpret_cast<int32_t*>(part.vmax + vg);
    part.first = part.cnt + g;
    part.vcnt = part.first + g;
    for (int i = threadIdx.x; i < g; i += THREADS) part.cnt[i] = 0, part.first[i] = INT32_MAX;
    for (int64_t i = threadIdx.x; i < vg; i += THREADS) {
      part.vcnt[i] = 0;
      part.vsum[i] = 0.0;
      part.vmin[i] = KEY_POS_INF;
      part.vmax[i] = KEY_NEG_INF;
    }
  }
  const int64_t limit = valid_limit(n, base, true_n);
  int flushed = 0;  // global atomics of this thread's flushes
  int cur = -1;     // the staged query
  for (;;) {
    if (threadIdx.x == 0) {
      const int r = atomicAdd(work + W_NEXT, 1);
      const bool any = r < work[W_RUNS];
      run[0] = any ? run_q[r] : -1;
      run[1] = any ? run_s[r] : 0;
      run[2] = any ? run_e[r] : 0;
    }
    __syncthreads();  // the run is read; the previous run's flush is done
    const int qi = run[0];
    if (qi < 0) break;  // block-uniform
    if (qi != cur) {
      stage_tile(boxes, times, qi, 1, t, meta);  // reads nothing of run[]
      cur = qi;
    }
    const int s = run[1], e = run[2];
    const int64_t qg = (int64_t)qi * g, qvg = (int64_t)qi * vg;
    const Acc acc = SHARED ? part
                           : Acc{cnt + qg, first + qg, vcnt + qvg, vsum + qvg, vmin + qvg,
                                 vmax + qvg};
    const int32_t* lq = list + (int64_t)qi * n_chunks;
    int32_t* hq = hits + qi;
    int32_t* pq = pos + (int64_t)qi * cap;
    if (meta[0] && meta[1])
      fold_run<true>(cols, n, base, limit, t, lq, s, e, buf, gid, rowid, vals, nv, g, acc, hq,
                     pq, cap);
    else if (meta[0])
      fold_run<false>(cols, n, base, limit, t, lq, s, e, buf, gid, rowid, vals, nv, g, acc, hq,
                      pq, cap);
    __syncthreads();  // the run's partials are complete
    if (SHARED) {  // one global atomic per touched (group, field); each thread resets its own
      for (int i = threadIdx.x; i < g; i += THREADS) {
        const int c = part.cnt[i];
        if (!c) continue;
        atomicAdd(cnt + qg + i, c);
        atomicMin(first + qg + i, part.first[i]);
        part.cnt[i] = 0;
        part.first[i] = INT32_MAX;
        flushed += 2;
        for (int v = 0; v < nv; ++v) {
          const int at = v * g + i;
          const int vc = part.vcnt[at];
          if (!vc) continue;
          atomicAdd(vcnt + qvg + at, vc);
          atomicAdd(vsum + qvg + at, part.vsum[at]);
          atomicMin(vmin + qvg + at, part.vmin[at]);
          atomicMax(vmax + qvg + at, part.vmax[at]);
          part.vcnt[at] = 0;
          part.vsum[at] = 0.0;
          part.vmin[at] = KEY_POS_INF;
          part.vmax[at] = KEY_NEG_INF;
          flushed += 4;
        }
      }
    }
  }
  if (SHARED) {
    flushed = __reduce_add_sync(FULL_WARP, flushed);
    if ((threadIdx.x & 31) == 0 && flushed) atomicAdd(work + W_FLUSHED, flushed);
  }
}

// The overlap form's fold (see the header note): FOLD_K runs (queries) a
// block at most, the chunk's six columns through a one-chunk cp.async ring.
constexpr int FOLD_K = 3;
constexpr int FOLD_THREADS = 1024;                // threads of a fold block: 32 warps an SM
constexpr int FOLD_WARPS = FOLD_THREADS / 32;
constexpr int FOLD_ROWS = CHUNK / FOLD_THREADS;   // rows a thread holds of a chunk: 4
constexpr int FOLD_GROUPS = FOLD_ROWS / 4;        // 16-byte groups per thread and column
constexpr int FOLD_GROUP_ROWS = FOLD_THREADS * 4; // rows between a thread's groups
using FoldRows = BoxRowsT<FOLD_ROWS>;
constexpr int OV_RING_BYTES = 6 * CHUNK * 4;  // one chunk of the six bbox columns: 96 KB
constexpr int SINGLE_SLOT = 1 | (1 << 16);    // a staged query with one live box and window
static_assert(FOLD_GROUPS * FOLD_GROUP_ROWS == CHUNK, "a chunk is whole 16-byte groups");
static_assert(FOLD_K * WINDOW <= FOLD_THREADS, "a thread a (run, window chunk) gathers the runs");

// Starts the copy of chunk c's rows of the thread into the ring (its
// FOLD_ROWS rows of each of the six columns, laid out [column][group]
// [thread]; rows at n or past it arrive as zeros) and commits it as one
// cp.async group; c == n_chunks commits an empty group.
__device__ __forceinline__ void ring_prefetch(int4* ring, const BoxCols& cols, int64_t n,
                                              int64_t c, int64_t n_chunks) {
  if (c < n_chunks) {
#pragma unroll
    for (int j = 0; j < FOLD_GROUPS; ++j) {
      const int64_t row = c * CHUNK + (int64_t)j * FOLD_GROUP_ROWS + 4 * threadIdx.x;
      const int64_t left = n - row;
      const int bytes = left >= 4 ? 16 : (left <= 0 ? 0 : (int)left * 4);
      const int64_t at = bytes ? row : 0;  // no byte is read when bytes == 0
#pragma unroll
      for (int k = 0; k < 6; ++k)
        cp_async16(ring + (k * FOLD_GROUPS + j) * FOLD_THREADS + threadIdx.x, cols.c[k] + at,
                   bytes);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for the thread's copy into the ring and takes its rows into
// registers; returns the mask of its rows below limit.
__device__ __forceinline__ uint32_t ring_take(const int4* ring, int64_t chunk0, int64_t limit,
                                              FoldRows& rows) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < FOLD_GROUPS; ++j) {
    put4(rows.x0, j, ring[(0 * FOLD_GROUPS + j) * FOLD_THREADS + threadIdx.x]);
    put4(rows.y0, j, ring[(1 * FOLD_GROUPS + j) * FOLD_THREADS + threadIdx.x]);
    put4(rows.x1, j, ring[(2 * FOLD_GROUPS + j) * FOLD_THREADS + threadIdx.x]);
    put4(rows.y1, j, ring[(3 * FOLD_GROUPS + j) * FOLD_THREADS + threadIdx.x]);
    const int4 vb = ring[(4 * FOLD_GROUPS + j) * FOLD_THREADS + threadIdx.x];
    const int4 vo = ring[(5 * FOLD_GROUPS + j) * FOLD_THREADS + threadIdx.x];
    rows.key[4 * j] = time_key(vb.x, vo.x);
    rows.key[4 * j + 1] = time_key(vb.y, vo.y);
    rows.key[4 * j + 2] = time_key(vb.z, vo.z);
    rows.key[4 * j + 3] = time_key(vb.w, vo.w);
    const int64_t nv = limit - (chunk0 + (int64_t)j * FOLD_GROUP_ROWS + 4 * threadIdx.x);
    valid |= (nv >= 4 ? 0xfu : (nv <= 0 ? 0u : (1u << (int)nv) - 1)) << (4 * j);
  }
  return valid;
}

// Bytes of the overlap fold's FOLD_K staged queries, and of one query's
// partials rounded to 16 B (the sets lie one after another): vmin and vmax
// (8 B), cnt, first and vcnt (4 B); the sums go to the outputs.
__host__ __device__ constexpr int ov_tile_bytes(int nb, int nt) {
  return (FOLD_K * staged_bytes_per_query(nb, nt, 0, FOLD_WARPS) + 15) / 16 * 16;
}
__host__ __device__ constexpr long long set_bytes(int nv, int g) {
  return ((long long)g * (8 + 20LL * nv) + 15) / 16 * 16;
}

// Query k's accumulator: its partial set in shared memory (SHARED) or its
// slices of the outputs (GLOBAL).
struct FoldOut {
  int32_t* cnt;
  int32_t* first;
  int32_t* vcnt;
  double* vsum;
  long long* vmin;
  long long* vmax;
  char* parts;
  long long set;
  int64_t vg;
  int g;

  template <bool SHARED>
  __device__ __forceinline__ Acc of(int k, int q) const {
    const int64_t qg = (int64_t)q * g, qvg = (int64_t)q * vg;
    if (SHARED) {  // the set of run k; its sums are query q's outputs
      Acc a;
      a.vmin = reinterpret_cast<long long*>(parts + k * set);
      a.vmax = a.vmin + vg;
      a.cnt = reinterpret_cast<int32_t*>(a.vmax + vg);
      a.first = a.cnt + g;
      a.vcnt = a.first + g;
      a.vsum = vsum + qvg;
      return a;
    }
    return Acc{cnt + qg, first + qg, vcnt + qvg, vsum + qvg, vmin + qvg, vmax + qvg};
  }
};

// Stages queries q[0], q[3], ... (every third int of qs, kq of them) into
// slots 0..kq-1 of t as stage_tile does: live slots first, live counts in
// t.live. All threads call it; it ends in __syncthreads().
__device__ __forceinline__ void stage_queries(const int32_t* __restrict__ boxes,
                                              const int32_t* __restrict__ times, const int* qs,
                                              int kq, const Tile& t) {
  const int nb = t.nb, nt = t.nt;
  int4* raw_win = reinterpret_cast<int4*>(t.win);
  for (int i = threadIdx.x; i < kq * nb; i += FOLD_THREADS)
    t.box[i] = reinterpret_cast<const int4*>(boxes)[(int64_t)qs[3 * (i / nb)] * nb + i % nb];
  for (int i = threadIdx.x; i < kq * nt; i += FOLD_THREADS)
    raw_win[i] = reinterpret_cast<const int4*>(times)[(int64_t)qs[3 * (i / nt)] * nt + i % nt];
  __syncthreads();
  if (threadIdx.x < kq) {  // one thread a slot compacts it in place (write index <= read index)
    const int k = threadIdx.x;
    int4* bq = t.box + k * nb;
    int kb = 0;
    for (int j = 0; j < nb; ++j) {
      const int4 b = bq[j];  // xlo, xhi, ylo, yhi
      if (b.x <= b.y && b.z <= b.w)
        bq[kb++] = make_int4(b.x, (int)((uint32_t)b.y - (uint32_t)b.x), b.z,
                             (int)((uint32_t)b.w - (uint32_t)b.z));
    }
    longlong2* wq = t.win + k * nt;
    const int4* wr = raw_win + k * nt;
    int kt = 0;
    for (int j = 0; j < nt; ++j) {
      const int4 w = wr[j];  // blo, olo, bhi, ohi
      const long long lo = time_key(w.x, w.y), hi = time_key(w.z, w.w);
      if (lo <= hi) wq[kt++] = make_longlong2(lo, hi);
    }
    t.live[k] = kb | (kt << 16);
  }
  __syncthreads();
}

// One folded (row, query) into accumulator a: counts, first row, then per
// value column its count, sum, min and max (order keys). In SHARED mode the
// partials are in shared memory but for the sums: a shared f64 add is a
// compare-and-swap loop (ATOMS.CAST.SPIN.64 in the SASS), so each value
// goes to the output's sum with one global reduction (RED.ADD.F64, no
// result waited for) instead. There a min or max that cannot move the
// partial skips its atomic (a 64-bit one is a compare-and-swap loop too): a
// partial only ever moves one way, so a value the read shows beaten stays
// beaten (exact whatever the read's age).
template <bool SHARED>
__device__ __forceinline__ void fold_one(const Acc& a, int gq, int rq) {
  atomicAdd(a.cnt + gq, 1);
  atomicMin(a.first + gq, rq);
}

template <bool SHARED>
__device__ __forceinline__ void fold_value(const Acc& a, int at, double v) {
  atomicAdd(a.vcnt + at, 1);
  atomicAdd(a.vsum + at, v);
  const long long key = order_key(v);
  if (!SHARED || key < *(volatile long long*)(a.vmin + at)) atomicMin(a.vmin + at, key);
  if (!SHARED || key > *(volatile long long*)(a.vmax + at)) atomicMax(a.vmax + at, key);
}

// Folds, for each run k of the block's item, the lane's fold rows f[k] (bit
// r is chunk row chunk0 + chunk_row<FOLD_GROUP_ROWS>(r)) into its query's
// accumulator: gid, rowid and the first value column are loaded once for
// the union fu of the runs' rows (one latency for all of them), then folded
// run by run.
template <bool SHARED>
__device__ __forceinline__ void fold_rows_k(uint32_t fu, const uint32_t (&f)[FOLD_K],
                                            int64_t chunk0, const int32_t* __restrict__ gid,
                                            const int32_t* __restrict__ rowid,
                                            const double* __restrict__ vals, int64_t n, int nv,
                                            int g, const FoldOut& o, const int* item) {
  int gq[FOLD_ROWS], rq[FOLD_ROWS];
  double vq[FOLD_ROWS];
#pragma unroll
  for (int r = 0; r < FOLD_ROWS; ++r) {
    gq[r] = -1;
    rq[r] = 0;
    vq[r] = 0.0;
    if ((fu >> r) & 1u) {
      const int64_t at = chunk0 + chunk_row<FOLD_GROUP_ROWS>(r);
      gq[r] = __ldg(gid + at);
      rq[r] = __ldg(rowid + at);
      if (nv) vq[r] = __ldg(vals + at);  // value column 0, in the same wait
    }
  }
#pragma unroll
  for (int k = 0; k < FOLD_K; ++k) {
    if (!f[k]) continue;
    const Acc a = o.of<SHARED>(k, item[1 + 3 * k]);
#pragma unroll
    for (int r = 0; r < FOLD_ROWS; ++r)
      if (((f[k] >> r) & 1u) && (unsigned)gq[r] < (unsigned)g) fold_one<SHARED>(a, gq[r], rq[r]);
  }
  for (int v = 0; v < nv; ++v) {
    if (v) {
#pragma unroll
      for (int r = 0; r < FOLD_ROWS; ++r)
        vq[r] = ((fu >> r) & 1u) && (unsigned)gq[r] < (unsigned)g
                    ? __ldg(vals + (int64_t)v * n + chunk0 + chunk_row<FOLD_GROUP_ROWS>(r)) : 0.0;
    }
#pragma unroll
    for (int k = 0; k < FOLD_K; ++k) {
      if (!f[k]) continue;
      const Acc a = o.of<SHARED>(k, item[1 + 3 * k]);
#pragma unroll
      for (int r = 0; r < FOLD_ROWS; ++r)
        if (((f[k] >> r) & 1u) && (unsigned)gq[r] < (unsigned)g && !isnan(vq[r]))
          fold_value<SHARED>(a, v * g + gq[r], vq[r]);
    }
  }
}

// One run k's masks on the chunk's rows: overlap, window, edge split and
// lanes (all 32 lanes together); returns the lane's fold rows.
template <bool FAST>
__device__ __forceinline__ uint32_t run_masks(const Tile& t, int k, const FoldRows& rows,
                                              uint32_t valid, int64_t gchunk0,
                                              int32_t* __restrict__ hits,
                                              int32_t* __restrict__ pos, int cap) {
  const int lv = t.live[k];
  uint32_t m = overlap_mask<FAST>(t.box + k * t.nb, lv & 0xffff, rows) & valid;
  if (!__any_sync(FULL_WARP, m)) return 0u;  // warp-uniform
  m &= box_time_mask<FAST>(t.win + k * t.nt, lv >> 16, rows);
  if (!__any_sync(FULL_WARP, m)) return 0u;
  const uint32_t ed = m ? overlap_edge_mask(t, k, m, rows) : 0u;
  append_lanes<FOLD_GROUP_ROWS>(ed, gchunk0, hits, pos, cap);
  return m & ~ed;
}

template <bool SHARED>
__global__ void __launch_bounds__(FOLD_THREADS, 1)
overlap_fold_kernel(const BoxCols cols,  // xmin, ymin, xmax, ymax, bins, offs
                    int64_t n, int64_t base, int64_t true_n,
                    const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                    const int32_t* __restrict__ times,  // (Q, nt, 4)
                    int nb, int nt, const int32_t* __restrict__ list, int64_t n_chunks,
                    const int32_t* __restrict__ run_q, const int32_t* __restrict__ run_s,
                    const int32_t* __restrict__ run_e, int32_t* __restrict__ work,
                    const int32_t* __restrict__ gid, const int32_t* __restrict__ rowid,
                    const double* __restrict__ vals, int32_t* __restrict__ cnt,
                    int32_t* __restrict__ first, int32_t* __restrict__ vcnt,
                    double* __restrict__ vsum, long long* __restrict__ vmin,
                    long long* __restrict__ vmax, int32_t* __restrict__ hits,
                    int32_t* __restrict__ pos, int nv, int g, int cap, int kmax) {
  extern __shared__ int4 smem[];  // the ring, the staged queries, the partial sets
  __shared__ int item[1 + 3 * FOLD_K];  // runs taken, then (query, first, end) of each
  __shared__ int seq_c[FOLD_K * WINDOW], seq_m[FOLD_K * WINDOW];  // the walk: chunk, runs
  __shared__ unsigned run_bits[FOLD_K];  // each run's chunks as bits of its window
  __shared__ int run_win[FOLD_K], seq_len;
  int4* ring = smem;
  char* tile_at = reinterpret_cast<char*>(smem + OV_RING_BYTES / 16);
  const Tile t = carve<FOLD_WARPS>(tile_at, FOLD_K, nb, nt);
  const int64_t vg = (int64_t)nv * g;
  const FoldOut o{cnt, first, vcnt, vsum, vmin, vmax, tile_at + ov_tile_bytes(nb, nt),
                  set_bytes(nv, g), vg, g};
  if (SHARED) {
    for (int k = 0; k < kmax; ++k) {
      const Acc p = o.of<true>(k, 0);
      for (int i = threadIdx.x; i < g; i += FOLD_THREADS) p.cnt[i] = 0, p.first[i] = INT32_MAX;
      for (int64_t i = threadIdx.x; i < vg; i += FOLD_THREADS) {
        p.vcnt[i] = 0;
        p.vmin[i] = KEY_POS_INF;
        p.vmax[i] = KEY_NEG_INF;
      }
    }
  }
  const int64_t limit = valid_limit(n, base, true_n);
  int flushed = 0;  // global atomics of this thread's flushes
  for (;;) {
    if (threadIdx.x == 0) {  // the next kmax runs of the table
      const int runs = work[W_RUNS];
      const int r0 = atomicAdd(work + W_NEXT, kmax);
      const int kq = r0 < runs ? min(kmax, runs - r0) : 0;
      item[0] = kq;
      for (int k = 0; k < kq; ++k) {
        item[1 + 3 * k] = run_q[r0 + k];
        item[2 + 3 * k] = run_s[r0 + k];
        item[3 + 3 * k] = run_e[r0 + k];
      }
    }
    if (threadIdx.x < FOLD_K) run_bits[threadIdx.x] = 0;
    __syncthreads();  // the item is read
    const int kq = item[0];
    if (kq == 0) break;  // block-uniform
    // each run lies in one window: its chunks as bits of the window
    if (threadIdx.x < kq * WINDOW) {
      const int k = threadIdx.x / WINDOW, j = threadIdx.x % WINDOW;
      const int s = item[2 + 3 * k];
      if (s + j < item[3 + 3 * k]) {
        const int c = __ldg(list + (int64_t)item[1 + 3 * k] * n_chunks + s + j);
        atomicOr(run_bits + k, 1u << (c % WINDOW));
        if (j == 0) run_win[k] = c / WINDOW;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // the union of the runs' chunks in order, each with its runs
      int len = 0, done = 0;
      while (done != (1 << kq) - 1) {
        int w = INT32_MAX;
        for (int k = 0; k < kq; ++k)
          if (!((done >> k) & 1)) w = min(w, run_win[k]);
        unsigned bits = 0;
        int ks = 0;
        for (int k = 0; k < kq; ++k) {
          if (!((done >> k) & 1) && run_win[k] == w) bits |= run_bits[k], ks |= 1 << k;
        }
        done |= ks;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          int m = 0;
          for (int k = 0; k < kq; ++k)
            if (((ks >> k) & 1) && ((run_bits[k] >> b) & 1u)) m |= 1 << k;
          seq_c[len] = w * WINDOW + b;
          seq_m[len++] = m;
        }
      }
      seq_len = len;
    }
    __syncthreads();
    const int len = seq_len;
    // the first chunk streams in while the queries are staged
    ring_prefetch(ring, cols, n, seq_c[0], n_chunks);
    stage_queries(boxes, times, item + 1, kq, t);
    for (int i = 0; i < len; ++i) {
      const int64_t chunk0 = (int64_t)seq_c[i] * CHUNK;
      const int km = seq_m[i];
      FoldRows rows;
      const uint32_t valid = ring_take(ring, chunk0, limit, rows);
      // the thread's rows are in registers: its ring slots take the next chunk
      ring_prefetch(ring, cols, n, i + 1 < len ? seq_c[i + 1] : n_chunks, n_chunks);
      if (!__any_sync(FULL_WARP, valid)) continue;  // warp-uniform
      uint32_t f[FOLD_K];
      uint32_t fu = 0;
#pragma unroll
      for (int k = 0; k < FOLD_K; ++k) {
        f[k] = 0u;
        const int lv = t.live[k];
        // block-uniform: run k keeps this chunk, and its query has a live box and window
        if (!((km >> k) & 1) || !(lv & 0xffff) || !(lv >> 16)) continue;
        const int qi = item[1 + 3 * k];
        int32_t* hq = hits + qi;
        int32_t* pq = pos + (int64_t)qi * cap;
        f[k] = lv == SINGLE_SLOT ? run_masks<true>(t, k, rows, valid, base + chunk0, hq, pq, cap)
                                 : run_masks<false>(t, k, rows, valid, base + chunk0, hq, pq, cap);
        fu |= f[k];
      }
      if (fu) fold_rows_k<SHARED>(fu, f, chunk0, gid, rowid, vals, n, nv, g, o, item);
    }
    __syncthreads();  // the item's partials are complete
    if (SHARED) {  // one global atomic per touched (group, field); each thread resets its own
      for (int k = 0; k < kq; ++k) {
        const Acc p = o.of<true>(k, 0);
        const Acc out = o.of<false>(k, item[1 + 3 * k]);
        for (int i = threadIdx.x; i < g; i += FOLD_THREADS) {
          const int c = p.cnt[i];
          if (!c) continue;
          atomicAdd(out.cnt + i, c);
          atomicMin(out.first + i, p.first[i]);
          p.cnt[i] = 0;
          p.first[i] = INT32_MAX;
          flushed += 2;
          for (int v = 0; v < nv; ++v) {
            const int at = v * g + i;
            const int vc = p.vcnt[at];
            if (!vc) continue;
            atomicAdd(out.vcnt + at, vc);
            atomicMin(out.vmin + at, p.vmin[at]);
            atomicMax(out.vmax + at, p.vmax[at]);
            p.vcnt[at] = 0;
            p.vmin[at] = KEY_POS_INF;
            p.vmax[at] = KEY_NEG_INF;
            flushed += 3;
          }
        }
      }
      __syncthreads();  // the flush has read the item before the next one is taken
    }
  }
  if (SHARED) {
    flushed = __reduce_add_sync(FULL_WARP, flushed);
    if ((threadIdx.x & 31) == 0 && flushed) atomicAdd(work + W_FLUSHED, flushed);
  }
}

constexpr int MAX_LANES = 4096;  // lanes a query's finishing block sorts in shared memory

// One block per query: its order keys back to the doubles' bits, in place
// (the key is its own inverse on the bits), and its lanes sorted
// ascending: the h = min(hits, cap) lanes it filled (slots 0 .. h - 1, the
// rest stay -1), by a bitonic sort in shared memory padded to a power of
// two with INT32_MAX.
__global__ void __launch_bounds__(THREADS)
agg_finish_kernel(long long* __restrict__ vmin, long long* __restrict__ vmax, int64_t vg,
                  const int32_t* __restrict__ hits, int32_t* __restrict__ pos, int cap) {
  __shared__ int32_t lanes[MAX_LANES];
  const int64_t qi = blockIdx.x;
  for (int64_t i = threadIdx.x; i < vg; i += THREADS) {
    const long long a = vmin[qi * vg + i], b = vmax[qi * vg + i];
    vmin[qi * vg + i] = a >= 0 ? a : a ^ 0x7fffffffffffffffLL;
    vmax[qi * vg + i] = b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
  }
  const int h = min(hits[qi], cap);
  if (h <= 1) return;  // block-uniform: nothing to sort
  int h2 = 1;
  while (h2 < h) h2 <<= 1;
  int32_t* lq = pos + qi * cap;
  for (int i = threadIdx.x; i < h2; i += THREADS) lanes[i] = i < h ? lq[i] : INT32_MAX;
  __syncthreads();
  for (int k = 2; k <= h2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < h2; i += THREADS) {
        const int o = i ^ j;
        if (o > i) {
          const int32_t a = lanes[i], b = lanes[o];
          if ((a > b) == ((i & k) == 0)) lanes[i] = b, lanes[o] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < h; i += THREADS) lq[i] = lanes[i];
}

// The dynamic shared memory of the point fold's block in a mode.
size_t fold_smem(bool shared, int nb, int nt, int nv, int g) {
  return ROW_BUF_BYTES + tile_bytes(nb, nt) + (shared ? (size_t)partial_bytes(nv, g) : 0);
}

// 1: the point fold's SHARED partials fit a block beside the row buffer; 0: GLOBAL.
bool shared_fits(int nb, int nt, int nv, int g) {
  return fold_smem(true, nb, nt, nv, g) <= (size_t)smem_optin();
}

// The overlap fold's dynamic shared memory with `sets` partial sets (0: GLOBAL).
size_t ov_fold_smem(int sets, int nb, int nt, int nv, int g) {
  return OV_RING_BYTES + ov_tile_bytes(nb, nt) + (size_t)sets * set_bytes(nv, g);
}

// The overlap fold's partial sets a block holds: as many as fit beside the
// ring and the kernel's static shared memory, up to FOLD_K (SHARED mode, a
// block takes that many runs at once); 0: GLOBAL (FOLD_K runs at once).
int ov_fold_sets(int nb, int nt, int nv, int g) {
  for (int k = FOLD_K; k >= 1; --k)
    if (ov_fold_smem(k, nb, nt, nv, g) + OV_STATIC_SMEM <= (size_t)smem_optin()) return k;
  return 0;
}

LaunchCache fold_cache[2];     // the point fold's, per mode (GLOBAL, SHARED)
LaunchCache ov_fold_cache[2];  // the overlap fold's, per mode
LaunchCache list_cache[2];     // the work list's resident blocks, per form

// A fold's resident blocks on the card (sms x blocks per SM), its launch
// attributes set once per form, mode and shared size.
template <bool SHARED>
cudaError_t fold_blocks(int nb, int nt, int nv, int g, int sms, int* blocks) {
  int per_sm = 1;
  const cudaError_t e = resident_blocks(grouped_agg_kernel<SHARED>, THREADS,
                                        fold_smem(SHARED, nb, nt, nv, g), fold_cache[SHARED],
                                        &per_sm);
  *blocks = sms * per_sm;
  return e;
}

template <bool SHARED>
cudaError_t ov_fold_blocks(int sets, int nb, int nt, int nv, int g, int sms, int* blocks) {
  int per_sm = 1;
  const cudaError_t e = resident_blocks(overlap_fold_kernel<SHARED>, FOLD_THREADS,
                                        ov_fold_smem(sets, nb, nt, nv, g), ov_fold_cache[SHARED],
                                        &per_sm);
  *blocks = sms * per_sm;
  return e;
}

cudaError_t fold_blocks_for(bool overlap, int nb, int nt, int nv, int g, int sms, int* blocks) {
  if (overlap) {
    const int sets = ov_fold_sets(nb, nt, nv, g);
    return sets ? ov_fold_blocks<true>(sets, nb, nt, nv, g, sms, blocks)
                : ov_fold_blocks<false>(0, nb, nt, nv, g, sms, blocks);
  }
  return shared_fits(nb, nt, nv, g) ? fold_blocks<true>(nb, nt, nv, g, sms, blocks)
                                    : fold_blocks<false>(nb, nt, nv, g, sms, blocks);
}

// The finish: min and max decoded, each query's lanes sorted.
cudaError_t launch_finish(int q, void* vmin, void* vmax, int nv, int g, const void* hits,
                          void* pos, int cap, cudaStream_t st) {
  agg_finish_kernel<<<q, THREADS, 0, st>>>((long long*)vmin, (long long*)vmax, (int64_t)nv * g,
                                          (const int32_t*)hits, (int32_t*)pos, cap);
  return cudaGetLastError();
}

// The point form's fold and the finish over columns x, y, bins, offs.
cudaError_t launch_fold(const BoxCols& cols, long long n, long long base, long long true_n,
                        const void* boxes, const void* times, int q, int nb, int nt, int sms,
                        const void* list, const void* run_q, const void* run_s,
                        const void* run_e, void* work, const void* gid, const void* rowid,
                        const void* vals, void* cnt, void* first, void* vcnt, void* vsum,
                        void* vmin, void* vmax, void* hits, void* pos, int nv, int g, int cap,
                        cudaStream_t st) {
  if (q <= 0 || n <= 0) return cudaSuccess;
  if (cap > MAX_LANES) return cudaErrorInvalidValue;
  const long long n_chunks = (n + CHUNK - 1) / CHUNK;
  const bool shared = shared_fits(nb, nt, nv, g);
  int blocks = 0;
  cudaError_t e = fold_blocks_for(false, nb, nt, nv, g, sms, &blocks);
  if (e != cudaSuccess) return e;
  const size_t smem = fold_smem(shared, nb, nt, nv, g);
  auto kernel = shared ? grouped_agg_kernel<true> : grouped_agg_kernel<false>;
  kernel<<<blocks, THREADS, smem, st>>>(
      cols, n, base, true_n, (const int32_t*)boxes, (const int32_t*)times, nb, nt,
      (const int32_t*)list, n_chunks, (const int32_t*)run_q, (const int32_t*)run_s,
      (const int32_t*)run_e, (int32_t*)work, (const int32_t*)gid, (const int32_t*)rowid,
      (const double*)vals, (int32_t*)cnt, (int32_t*)first, (int32_t*)vcnt, (double*)vsum,
      (long long*)vmin, (long long*)vmax, (int32_t*)hits, (int32_t*)pos, nv, g, cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_finish(q, vmin, vmax, nv, g, hits, pos, cap, st);
}

// The overlap form's fold and the finish over the six bbox columns.
cudaError_t launch_overlap_fold(const BoxCols& cols, long long n, long long base,
                                long long true_n, const void* boxes, const void* times, int q,
                                int nb, int nt, int sms, const void* list, const void* run_q,
                                const void* run_s, const void* run_e, void* work,
                                const void* gid, const void* rowid, const void* vals, void* cnt,
                                void* first, void* vcnt, void* vsum, void* vmin, void* vmax,
                                void* hits, void* pos, int nv, int g, int cap, cudaStream_t st) {
  if (q <= 0 || n <= 0) return cudaSuccess;
  if (cap > MAX_LANES) return cudaErrorInvalidValue;
  const long long n_chunks = (n + CHUNK - 1) / CHUNK;
  const int sets = ov_fold_sets(nb, nt, nv, g);
  int blocks = 0;
  cudaError_t e = fold_blocks_for(true, nb, nt, nv, g, sms, &blocks);
  if (e != cudaSuccess) return e;
  auto kernel = sets ? overlap_fold_kernel<true> : overlap_fold_kernel<false>;
  kernel<<<blocks, FOLD_THREADS, ov_fold_smem(sets, nb, nt, nv, g), st>>>(
      cols, n, base, true_n, (const int32_t*)boxes, (const int32_t*)times, nb, nt,
      (const int32_t*)list, n_chunks, (const int32_t*)run_q, (const int32_t*)run_s,
      (const int32_t*)run_e, (int32_t*)work, (const int32_t*)gid, (const int32_t*)rowid,
      (const double*)vals, (int32_t*)cnt, (int32_t*)first, (int32_t*)vcnt, (double*)vsum,
      (long long*)vmin, (long long*)vmax, (int32_t*)hits, (int32_t*)pos, nv, g, cap,
      sets ? sets : FOLD_K);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_finish(q, vmin, vmax, nv, g, hits, pos, cap, st);
}

__global__ void empty_kernel() {}

}  // namespace

// The fold's mode at this shape (overlap: the overlap form): 1 SHARED
// (partials in shared memory), 0 GLOBAL (the fold's atomics on the outputs).
extern "C" int geomesa_grouped_agg_mode(int nb, int nt, int nv, int g, int overlap) {
  return (overlap ? ov_fold_sets(nb, nt, nv, g) > 0 : shared_fits(nb, nt, nv, g)) ? 1 : 0;
}

// The runs a fold block takes at once at this shape: 1 for the point form;
// for the overlap form its partial sets (SHARED) or FOLD_K (GLOBAL).
extern "C" int geomesa_grouped_agg_fold_runs(int nb, int nt, int nv, int g, int overlap) {
  if (!overlap) return 1;
  const int sets = ov_fold_sets(nb, nt, nv, g);
  return sets ? sets : FOLD_K;
}

// The runs the work list aims at for the fold at this shape: RUNS_PER_BLOCK
// per resident fold block (host out: 1 x int).
extern "C" int geomesa_grouped_agg_target_runs(int nb, int nt, int nv, int g, int sms,
                                               int overlap, void* out) {
  int blocks = 0;
  const cudaError_t e = fold_blocks_for(overlap != 0, nb, nt, nv, g, sms, &blocks);
  *(int*)out = RUNS_PER_BLOCK * blocks;
  return (int)e;
}

// A form's and mode's fold kernel as compiled (cudaFuncGetAttributes): out
// (host, 2 x int) gets its registers per thread and its local memory bytes
// per thread (spills).
extern "C" int geomesa_grouped_agg_attrs(int shared, int overlap, void* out) {
  cudaFuncAttributes attr;
  const void* fn = overlap ? (shared ? (const void*)overlap_fold_kernel<true>
                                     : (const void*)overlap_fold_kernel<false>)
                           : (shared ? (const void*)grouped_agg_kernel<true>
                                     : (const void*)grouped_agg_kernel<false>);
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) {
    ((int*)out)[0] = attr.numRegs;
    ((int*)out)[1] = (int)attr.localSizeBytes;
  }
  return (int)e;
}

// The work list (one launch). scratch: the wrapper's int32 buffer of
// scratch_ints >= S_FLAGS + q x ceil(n_chunks / LIST_SEG_CHUNKS) ints,
// zeroed when allocated; the launch leaves it zeroed, so launches that
// share it run one after another (one stream). cnt..pos: the fold's
// outputs to fill (cnt null: none), of q x g, q x nv x g, q and q x cap
// elements. window: 0 for the point form's runs (run_* of q + target_runs
// ints); WINDOW for the overlap form's window runs (run_* of q x
// ceil(n_chunks / WINDOW) ints, cells as many int pairs, 8-byte aligned).
extern "C" int geomesa_agg_work_list(const void* ext, long long n, long long base,
                                     long long true_n, const void* boxes, const void* times,
                                     int q, int nb, int nt, int target_runs, int min_run,
                                     void* list, void* kept, void* run_q, void* run_s,
                                     void* run_e, void* work, void* scratch,
                                     long long scratch_ints, void* cnt, void* first, void* vcnt,
                                     void* vsum, void* vmin, void* vmax, void* hits, void* pos,
                                     int nv, int g, int cap, int window, void* cells,
                                     void* stream) {
  if (q <= 0) return (int)cudaSuccess;  // n == 0 launches: every list is empty
  if (target_runs < 1 || min_run < 1 || n < 0 || (window && (window != WINDOW || !cells)))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n + CHUNK - 1) / CHUNK;
  const long long segs = n_chunks > 0 ? (n_chunks + LIST_SEG_CHUNKS - 1) / LIST_SEG_CHUNKS : 1;
  if ((long long)q * segs > 0x7fffffffLL || S_FLAGS + (long long)q * segs > scratch_ints)
    return (int)cudaErrorInvalidValue;
  const long long n_windows = window ? (n_chunks + WINDOW - 1) / WINDOW : 0;
  const long long max_runs = window ? q * n_windows : (long long)q + target_runs;
  if (max_runs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long limit = (true_n - base) < n ? (true_n - base) : n;
  const long long live = limit <= 0 ? 0 : (limit + CHUNK - 1) / CHUNK;
  const int64_t qg = (int64_t)q * g;
  const Fills fills{(int32_t*)cnt, (int32_t*)first, (int32_t*)vcnt, (double*)vsum,
                    (long long*)vmin, (long long*)vmax, (int32_t*)hits, (int32_t*)pos,
                    cnt ? qg : 0, cnt ? qg * nv : 0, cnt ? q : 0, cnt ? (int64_t)q * cap : 0};
  const long long items = (q + LIST_QUERIES - 1) / LIST_QUERIES * segs;
  const size_t smem = (size_t)LIST_QUERIES * staged_bytes_per_query(nb, nt, 0);
  int per_sm = 1;
  auto kernel = window ? agg_work_list_kernel<true> : agg_work_list_kernel<false>;
  cudaError_t e = resident_blocks(kernel, THREADS, smem, list_cache[window != 0], &per_sm);
  if (e != cudaSuccess) return (int)e;
  const long long resident = (long long)device_attr(cudaDevAttrMultiProcessorCount) * per_sm;
  if (resident < 1) return (int)cudaErrorInvalidDevice;
  const long long grid = items < resident ? items : resident;  // all blocks resident at once
  kernel<<<(unsigned)grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const Extent*)ext, n_chunks, live < n_chunks ? live : n_chunks, (const int32_t*)boxes,
      (const int32_t*)times, q, nb, nt, (int)segs, target_runs, min_run, (int)max_runs,
      (int32_t*)list, (int32_t*)kept, (int32_t*)run_q, (int32_t*)run_s, (int32_t*)run_e,
      (int32_t*)work, (int32_t*)scratch, window ? (int32_t*)cells : nullptr, (int)n_windows,
      fills);
  return (int)cudaGetLastError();
}

// The fold and the finish: the outputs hold their initial values (the work
// list's launch filled them).
extern "C" int geomesa_grouped_agg(const void* x, const void* y, const void* bins,
                                   const void* offs, long long n, long long base,
                                   long long true_n, const void* boxes, const void* times,
                                   int q, int nb, int nt, int sms, const void* list,
                                   const void* run_q, const void* run_s, const void* run_e,
                                   void* work, const void* gid, const void* rowid,
                                   const void* vals, void* cnt, void* first, void* vcnt,
                                   void* vsum, void* vmin, void* vmax, void* hits, void* pos,
                                   int nv, int g, int cap, void* stream) {
  const BoxCols cols{{(const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
                      (const int32_t*)offs, nullptr, nullptr}};
  return (int)launch_fold(cols, n, base, true_n, boxes, times, q, nb, nt, sms, list, run_q,
                          run_s, run_e, work, gid, rowid, vals, cnt, first, vcnt, vsum, vmin,
                          vmax, hits, pos, nv, g, cap, (cudaStream_t)stream);
}

// The overlap form's fold and finish over the bbox columns (xmin, ymin,
// xmax, ymax, bins, offs); the rest as geomesa_grouped_agg.
extern "C" int geomesa_grouped_agg_overlap(const void* xmin, const void* ymin, const void* xmax,
                                           const void* ymax, const void* bins, const void* offs,
                                           long long n, long long base, long long true_n,
                                           const void* boxes, const void* times, int q, int nb,
                                           int nt, int sms, const void* list, const void* run_q,
                                           const void* run_s, const void* run_e, void* work,
                                           const void* gid, const void* rowid, const void* vals,
                                           void* cnt, void* first, void* vcnt, void* vsum,
                                           void* vmin, void* vmax, void* hits, void* pos, int nv,
                                           int g, int cap, void* stream) {
  const BoxCols cols{{(const int32_t*)xmin, (const int32_t*)ymin, (const int32_t*)xmax,
                      (const int32_t*)ymax, (const int32_t*)bins, (const int32_t*)offs}};
  return (int)launch_overlap_fold(cols, n, base, true_n, boxes, times, q, nb, nt, sms, list,
                                  run_q, run_s, run_e, work, gid, rowid, vals, cnt, first, vcnt,
                                  vsum, vmin, vmax, hits, pos, nv, g, cap, (cudaStream_t)stream);
}

// One empty kernel's launch on the stream: the launch floor of the path
// (the ctypes call and the launch), for measurements.
extern "C" int geomesa_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
