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
// the append are the point instance's. The epilogue is one template over
// the two predicates (EdgeEpilogue<PointEdges> and <OverlapEdges>), so the
// point instance's code is unchanged. Bound: the same terms over 24 B a
// row and the overlap compares.
//
// Plain C entry points for ctypes; they launch on the caller's stream, do
// not synchronise, return a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_cull.cuh"
#include "count_predicate.cuh"
#include "overlap_cull.cuh"

namespace {

using namespace geomesa;

constexpr int SURVIVOR_INTS = 1;  // the survivor list: one int per staged query

__device__ unsigned long long g_path_blocks[2];

// The edge tests of the two instances, over their row layouts.
struct PointEdges {
  using RowT = Rows;
  __device__ __forceinline__ static uint32_t edges(const Tile& t, int qi, uint32_t m,
                                                   const Rows& rows) {
    return edge_mask(t, qi, m, rows);
  }
};

struct OverlapEdges {
  using RowT = BoxRows;
  __device__ __forceinline__ static uint32_t edges(const Tile& t, int qi, uint32_t m,
                                                   const BoxRows& rows) {
    return overlap_edge_mask(t, qi, m, rows);
  }
};

// Counts the warp's matches m of query qi and appends its edge candidates;
// all 32 lanes call it together. Bit r of m is chunk row chunk_row(r).
template <class Pred>
struct EdgeEpilogue {
  const Tile& t;
  int64_t base;
  int32_t* hits;  // the tile's first query's cursor
  int32_t* pos;   // the tile's first query's lanes
  int cap;
  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t chunk0,
                                             const typename Pred::RowT& rows) const {
    const unsigned c = __reduce_add_sync(FULL_WARP, __popc(m));
    if (c == 0) return;  // warp-uniform
    if ((threadIdx.x & 31) == 0) t.cnt[(threadIdx.x >> 5) * t.q_tile + qi] += c;
    append_lanes(m ? Pred::edges(t, qi, m, rows) : 0u, base + chunk0, hits + qi,
                 pos + (int64_t)qi * cap, cap);
  }
};

// Adds the tile's per-warp counts to the outputs, one atomicAdd per query.
__device__ __forceinline__ void flush_counts(const Tile& t, int q0, int qt,
                                             int32_t* __restrict__ counts) {
  __syncthreads();
  for (int qi = threadIdx.x; qi < qt; qi += THREADS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += t.cnt[w * t.q_tile + qi];
    if (sum) atomicAdd(&counts[q0 + qi], sum);
  }
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
  EdgeEpilogue<PointEdges> ep{t, base, hits + q0, pos + (int64_t)q0 * cap, cap};
  if (n_active > 0) {
    note_path(g_path_blocks, meta[1]);
    if (meta[1])
      cull_scan<true>(x, y, bins, offs, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
    else
      cull_scan<false>(x, y, bins, offs, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
  }
  flush_counts(t, q0, qt, counts);
}

__global__ void __launch_bounds__(THREADS, 1)
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
  __shared__ Extent warp_ext[WARPS];
  __shared__ int n_surv[2];
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  int4* buf = smem;
  const Tile t = carve(smem + BoxLayout<true>::BUF_BYTES / 16, q_tile, nb, nt);
  if (threadIdx.x < 2) n_surv[threadIdx.x] = 0;  // stage_tile's barriers order this
  stage_tile(boxes, times, q0, qt, t, meta);
  const int n_active = meta[0];
  const int64_t limit = valid_limit(n, base, true_n);
  EdgeEpilogue<OverlapEdges> ep{t, base, hits + q0, pos + (int64_t)q0 * cap, cap};
  if (n_active > 0) {
    if (meta[1])
      box_cull_scan<true, true>(cols, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
    else
      box_cull_scan<false, true>(cols, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
  }
  flush_counts(t, q0, qt, counts);
}

// The launch geometry of both instances: the grid is the card's resident
// blocks (at most one per chunk) by the query tiles.
template <typename Kernel>
int launch_geometry(Kernel kernel, size_t smem, long long n, int q, int q_tile, int sms,
                    dim3* grid) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
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
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int tile_max = q_tile_for(nb, nt, SURVIVOR_INTS);
  const int q_tile = q < tile_max ? q : tile_max;
  const size_t smem =
      ROW_BUF_BYTES + (size_t)q_tile * staged_bytes_per_query(nb, nt, SURVIVOR_INTS);
  dim3 grid;
  const int e = launch_geometry(batched_edge_gather_kernel, smem, n, q, q_tile, sms, &grid);
  if (e != (int)cudaSuccess) return e;
  batched_edge_gather_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
      (const int32_t*)offs, n, base, true_n, (const int32_t*)boxes,
      (const int32_t*)times, q, nb, nt, q_tile, (int32_t*)counts, (int32_t*)hits,
      (int32_t*)pos, cap);
  return (int)cudaGetLastError();
}

// The overlap instance: columns xmin, ymin, xmax, ymax, bins, offs.
extern "C" int geomesa_batched_edge_gather_overlap(
    const void* xmin, const void* ymin, const void* xmax, const void* ymax, const void* bins,
    const void* offs, long long n, long long base, long long true_n, const void* boxes,
    const void* times, int q, int nb, int nt, int sms, void* counts, void* hits, void* pos,
    int cap, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int tile_max = q_tile_for(nb, nt, SURVIVOR_INTS);
  const int q_tile = q < tile_max ? q : tile_max;
  const size_t smem = BoxLayout<true>::BUF_BYTES +
                      (size_t)q_tile * staged_bytes_per_query(nb, nt, SURVIVOR_INTS);
  dim3 grid;
  const int e =
      launch_geometry(batched_edge_gather_overlap_kernel, smem, n, q, q_tile, sms, &grid);
  if (e != (int)cudaSuccess) return e;
  const BoxCols cols{{(const int32_t*)xmin, (const int32_t*)ymin, (const int32_t*)xmax,
                      (const int32_t*)ymax, (const int32_t*)bins, (const int32_t*)offs}};
  batched_edge_gather_overlap_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      cols, n, base, true_n, (const int32_t*)boxes, (const int32_t*)times, q, nb, nt, q_tile,
      (int32_t*)counts, (int32_t*)hits, (int32_t*)pos, cap);
  return (int)cudaGetLastError();
}
