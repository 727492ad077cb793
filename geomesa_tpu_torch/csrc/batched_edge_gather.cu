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
// = global positions base + lpos of min(hits, cap) of the candidates, sorted
// ascending, -1 beyond. The scan appends them in no particular order; a
// second kernel of the same entry point (sort_lanes_kernel: a block per
// query, a bitonic sort in shared memory) sorts each query's lanes and pads
// them, and the entry point zeroes counts and hits itself, so the wrapper
// only allocates. When hits[q] > cap the lanes hold some subset of the
// candidates and the caller falls back.
//
// Bound on an H100: bytes. The four columns are read once (16 B a row,
// 0.2388 ms for 50M rows at 3.35 TB/s), plus 4 B per written candidate. A
// full scan of every (row, query) pair would be bound by integer
// instructions instead (batched_count's floor, 0.41 ms at bench config 2),
// but the rows are resident in z3 order and most (chunk, query) pairs of a
// batch cannot match, so the operations this kernel needs are only the
// surviving pairs' row tests plus the per-row extent min/max. chip_smoke.py
// reckons both floors from the run's inputs and the surviving pairs
// (ops.kernels.chunk_query_pairs).
//
// Design (chunk_cull.cuh, on count_predicate.cuh's staged slots):
//   - each block stages its query tile once, live slots first (stage_tile);
//   - it walks 4096-row chunks grid-stride; a chunk's rows arrive in a
//     64 KB shared buffer by cp.async, issued as soon as the previous chunk
//     is in registers and reduced to its extent, so loads overlap the
//     culling and tests;
//   - per chunk it reduces the extent (warp reductions, one shared step)
//     and lists the active queries whose live slots meet it (exact: see
//     chunk_cull.cuh); only those run the in-box, time and edge tests;
//   - the rows stay in registers (16 per thread) for the tests: on unsorted
//     rows nothing is culled, and reading them from shared memory once per
//     surviving query would cost 64 KB of shared loads per query and chunk.
//     The shared buffer therefore serves as the prefetch stage, and two
//     blocks of 110 KB fit an SM (16 warps).
//
// The scan (cull_scan, two barriers per chunk), the edge tests (edge_mask)
// and the append of the candidates (append_lanes: a warp prefix sum and one
// atomicAdd on the query's cursor, which keeps counting past the capacity)
// live in chunk_cull.cuh, shared with grouped_agg.cu. Counts are per-warp
// __reduce_add_sync partials in shared memory, added with one atomicAdd per
// (block, query), as in batched_count.cu.
//
// The overlap instance (batched_edge_gather_overlap_kernel) is the exact
// count_many(loose=False) of an extended-geometry store: it replaces
// make_batched_edge_gather_step(overlap=True) (query.py:342, per-slot
// predicate _slot_overlap :316). Its rows are per-feature bounds (xmin,
// ymin, xmax, ymax, bins, offs: 24 B a row) and its scan is
// overlap_cull.cuh's box_cull_scan: a row is in_all when it overlaps a
// live box and lies in a live window; a candidate when it is in_all and
// shares an opposing edge bucket with a live box it overlaps (xmin ==
// qxhi, xmax == qxlo, ymin == qyhi or ymax == qylo) or sits at a window's
// endpoint (overlap_edge_mask). Its counts equal batched_overlap.cu's with
// time (the reference's invariant, query.py:302-307); lanes, capacity and
// the append are the point instance's. Bound: the same terms over 24 B a
// row and the overlap compares. Its design is batched_overlap.cu's (the
// 512-thread scan of overlap_cull.cuh with its cp.async ring and per-warp
// cull); on top of the count, a warp that matches runs the edge test and
// the append only where one of its rows can be a candidate
// (overlap_cull.cuh may_hold_edge, an exact test on the warp's bound
// ranges): on a store whose rows share no edge bucket with the queries,
// the exact count costs about what the loose one does.
//
// Both instances ask their launch attributes and occupancy once per shared
// size (launch_cache.cuh).
//
// Plain C entry points for ctypes; they launch on the caller's stream, do
// not synchronise, return a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_cull.cuh"
#include "count_predicate.cuh"
#include "launch_cache.cuh"
#include "overlap_cull.cuh"

namespace {

using namespace geomesa;

constexpr int SURVIVOR_INTS = 1;  // the survivor list: one int per staged query

__device__ unsigned long long g_path_blocks[2];

LaunchCache g_launch_point, g_launch_overlap;

// Counts the warp's matches m of query qi and appends its edge candidates;
// all 32 lanes call it together. Bit r of m is chunk row chunk_row(r).
struct EdgeEpilogue {
  const Tile& t;
  int64_t base;
  int32_t* hits;  // the tile's first query's cursor
  int32_t* pos;   // the tile's first query's lanes
  int cap;
  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t chunk0,
                                             const Rows& rows) const {
    const unsigned c = __reduce_add_sync(FULL_WARP, __popc(m));
    if (c == 0) return;  // warp-uniform
    if ((threadIdx.x & 31) == 0) t.cnt[(threadIdx.x >> 5) * t.q_tile + qi] += c;
    append_lanes(m ? edge_mask(t, qi, m, rows) : 0u, base + chunk0, hits + qi,
                 pos + (int64_t)qi * cap, cap);
  }
};

// The overlap instance's: the count, then the edge test and the append
// only where the warp may hold a candidate (may_hold_edge: exact). Bit r
// of m is chunk row chunk_row<OV_GROUP_ROWS>(r).
struct OverlapEdgeEpilogue {
  const Tile& t;
  int64_t base;
  int32_t* hits;
  int32_t* pos;
  int cap;
  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t chunk0,
                                             const ScanRows& rows, const Extent& we,
                                             const EdgeSpan& span) const {
    const unsigned c = __reduce_add_sync(FULL_WARP, __popc(m));
    if (c == 0) return;  // warp-uniform
    if ((threadIdx.x & 31) == 0) t.cnt[(threadIdx.x >> 5) * t.q_tile + qi] += c;
    if (!may_hold_edge(t, qi, we, span)) return;  // warp-uniform
    append_lanes<OV_GROUP_ROWS>(m ? overlap_edge_mask(t, qi, m, rows) : 0u, base + chunk0,
                                hits + qi, pos + (int64_t)qi * cap, cap);
  }
};

constexpr int SORT_THREADS = 256;
// lanes a query's sort holds, 128 KB of shared memory (ops/kernels.py EDGE_MAX_LANES)
constexpr int MAX_SORT_LANES = 32768;

LaunchCache g_launch_sort;

// Block q sorts pos[q][0, min(hits[q], cap)) ascending (a bitonic network
// over the next power of two in shared memory, padded with INT32_MAX, which
// no position reaches: base + n < 2^31) and writes -1 to the rest.
__global__ void __launch_bounds__(SORT_THREADS)
sort_lanes_kernel(const int32_t* __restrict__ hits, int32_t* __restrict__ pos, int cap) {
  extern __shared__ int32_t keys[];  // the next power of two >= cap
  int32_t* lanes = pos + (int64_t)blockIdx.x * cap;
  const int h = min(hits[blockIdx.x], cap);
  if (h > 1) {  // block-uniform
    int p = 2;
    while (p < h) p <<= 1;
    for (int i = threadIdx.x; i < p; i += SORT_THREADS) keys[i] = i < h ? lanes[i] : INT32_MAX;
    __syncthreads();
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < p; i += SORT_THREADS) {
          const int l = i ^ j;
          if (l > i) {
            const int32_t a = keys[i], b = keys[l];
            if ((a > b) == ((i & k) == 0)) keys[i] = b, keys[l] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < h; i += SORT_THREADS) lanes[i] = keys[i];
  }
  for (int i = h + threadIdx.x; i < cap; i += SORT_THREADS) lanes[i] = -1;
}

// Zeroes counts and hits ahead of a scan (on the caller's stream).
int zero_outputs(void* counts, void* hits, int q, void* stream) {
  cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)q * 4, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemsetAsync(hits, 0, (size_t)q * 4, (cudaStream_t)stream);
}

// Sorts and pads every query's lanes after a scan (sort_lanes_kernel).
int sort_lanes(const void* hits, void* pos, int q, int cap, void* stream) {
  if (cap == 0) return (int)cudaSuccess;
  int p = 1;
  while (p < cap) p <<= 1;
  int per_sm = 0;
  const cudaError_t e =
      resident_blocks(sort_lanes_kernel, SORT_THREADS, (size_t)p * 4, g_launch_sort, &per_sm);
  if (e != cudaSuccess) return (int)e;
  sort_lanes_kernel<<<q, SORT_THREADS, (size_t)p * 4, (cudaStream_t)stream>>>(
      (const int32_t*)hits, (int32_t*)pos, cap);
  return (int)cudaGetLastError();
}

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
  extern __shared__ int4 smem[];  // the row buffer, then the staged tile
  __shared__ int meta[2];
  __shared__ Extent warp_ext[WARPS];
  __shared__ int n_surv[2];
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  int4* buf = smem;
  const Tile t = carve(smem + ROW_BUF_BYTES / 16, q_tile, nb, nt);
  if (threadIdx.x < 2) n_surv[threadIdx.x] = 0;  // stage_tile's barriers order this
  stage_tile(boxes, times, q0, qt, t, meta);
  const int n_active = meta[0];
  const int64_t limit = valid_limit(n, base, true_n);
  EdgeEpilogue ep{t, base, hits + q0, pos + (int64_t)q0 * cap, cap};
  if (n_active > 0) {
    note_path(g_path_blocks, meta[1]);
    if (meta[1])
      cull_scan<true>(x, y, bins, offs, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
    else
      cull_scan<false>(x, y, bins, offs, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
  }
  flush_counts(t, q0, qt, counts);
}

__global__ void __launch_bounds__(OV_THREADS, 1)
batched_edge_gather_overlap_kernel(BoxCols cols, int64_t n, int64_t base, int64_t true_n,
                                   const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                                   const int32_t* __restrict__ times,  // (Q, nt, 4)
                                   int q, int nb, int nt, int q_tile,
                                   int32_t* __restrict__ counts,       // (Q,)
                                   int32_t* __restrict__ hits,         // (Q,)
                                   int32_t* __restrict__ pos,          // (Q, cap)
                                   int cap) {
  extern __shared__ int4 smem[];  // the row buffer, then the staged tile
  __shared__ int meta[2];
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  int4* buf = smem;
  box_scan_prologue<true>(buf, cols, n);  // the first chunks load while the tile is staged
  const Tile t = carve<OV_WARPS>(smem + BoxLayout<true>::BUF_BYTES / 16, q_tile, nb, nt);
  stage_tile<true, OV_THREADS>(boxes, times, q0, qt, t, meta);
  const int n_active = meta[0];
  const int64_t limit = valid_limit(n, base, true_n);
  OverlapEdgeEpilogue ep{t, base, hits + q0, pos + (int64_t)q0 * cap, cap};
  if (n_active > 0) {
    if (meta[1])
      box_cull_scan<true, true, true>(cols, n, limit, t, n_active, buf, ep);
    else
      box_cull_scan<false, true, true>(cols, n, limit, t, n_active, buf, ep);
  } else {
    cp_async_wait_all();
  }
  flush_counts<OV_THREADS>(t, q0, qt, counts);
}

// The launch geometry of both instances: the grid is the card's resident
// blocks (at most one per chunk) by the query tiles; the attributes and the
// occupancy come from the instance's cache.
template <typename Kernel>
int launch_geometry(Kernel kernel, int threads, size_t smem, LaunchCache& cache, long long n,
                    int q, int q_tile, int sms, dim3* grid) {
  int per_sm = 0;
  const cudaError_t e = resident_blocks(kernel, threads, smem, cache, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const long long resident = (long long)sms * per_sm;
  *grid = dim3((unsigned)(chunks < resident ? chunks : resident), (q + q_tile - 1) / q_tile);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int geomesa_batched_edge_gather_q_tile(int nb, int nt) {
  return q_tile_for(nb, nt, SURVIVOR_INTS);
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
  if (q <= 0) return (int)cudaSuccess;
  if (cap < 0 || cap > MAX_SORT_LANES) return (int)cudaErrorInvalidValue;
  int e = zero_outputs(counts, hits, q, stream);
  if (e != (int)cudaSuccess) return e;
  if (n > 0) {
    const int tile_max = q_tile_for(nb, nt, SURVIVOR_INTS);
    const int q_tile = q < tile_max ? q : tile_max;
    const size_t smem =
        ROW_BUF_BYTES + (size_t)q_tile * staged_bytes_per_query(nb, nt, SURVIVOR_INTS);
    dim3 grid;
    e = launch_geometry(batched_edge_gather_kernel, THREADS, smem, g_launch_point, n, q, q_tile,
                        sms, &grid);
    if (e != (int)cudaSuccess) return e;
    batched_edge_gather_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
        (const int32_t*)offs, n, base, true_n, (const int32_t*)boxes,
        (const int32_t*)times, q, nb, nt, q_tile, (int32_t*)counts, (int32_t*)hits,
        (int32_t*)pos, cap);
    e = (int)cudaGetLastError();
    if (e != (int)cudaSuccess) return e;
  }
  return sort_lanes(hits, pos, q, cap, stream);
}

// The overlap instance: columns xmin, ymin, xmax, ymax, bins, offs.
extern "C" int geomesa_batched_edge_gather_overlap(
    const void* xmin, const void* ymin, const void* xmax, const void* ymax, const void* bins,
    const void* offs, long long n, long long base, long long true_n, const void* boxes,
    const void* times, int q, int nb, int nt, int sms, void* counts, void* hits, void* pos,
    int cap, void* stream) {
  if (q <= 0) return (int)cudaSuccess;
  if (cap < 0 || cap > MAX_SORT_LANES) return (int)cudaErrorInvalidValue;
  int e = zero_outputs(counts, hits, q, stream);
  if (e != (int)cudaSuccess) return e;
  if (n > 0) {
    const int tile_max = box_q_tile<true>(nb, nt);
    const int q_tile = q < tile_max ? q : tile_max;
    const size_t smem = BoxLayout<true>::BUF_BYTES +
                        (size_t)q_tile * staged_bytes_per_query(nb, nt, 0, OV_WARPS);
    dim3 grid;
    e = launch_geometry(batched_edge_gather_overlap_kernel, OV_THREADS, smem, g_launch_overlap,
                        n, q, q_tile, sms, &grid);
    if (e != (int)cudaSuccess) return e;
    const BoxCols cols{{(const int32_t*)xmin, (const int32_t*)ymin, (const int32_t*)xmax,
                        (const int32_t*)ymax, (const int32_t*)bins, (const int32_t*)offs}};
    batched_edge_gather_overlap_kernel<<<grid, OV_THREADS, smem, (cudaStream_t)stream>>>(
        cols, n, base, true_n, (const int32_t*)boxes, (const int32_t*)times, q, nb, nt, q_tile,
        (int32_t*)counts, (int32_t*)hits, (int32_t*)pos, cap);
    e = (int)cudaGetLastError();
    if (e != (int)cudaSuccess) return e;
  }
  return sort_lanes(hits, pos, q, cap, stream);
}
