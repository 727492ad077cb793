// batched_overlap: Q bbox-overlap count queries over the per-feature int32
// bounds of an extended-geometry store (lines, polygons), one pass, with or
// without time windows.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:914
// (make_batched_overlap_step) in both of its forms. It is not a TPU kernel:
// the reference computes it in XLA.
//   - No time (with_time=False): columns xmin, ymin, xmax, ymax (16 B a
//     row), boxes (Q, B, 4). Bench config 5's step (bench.py:811-845: 4M
//     trajectory bboxes in xz2 order, 64 city boxes of one slot each).
//   - With time (with_time=True): also bins, offs (24 B a row) and times
//     (Q, T, 4). The loose count_many of an extended-geometry store (B = 8,
//     T = 16 as ops/refine.py packs them).
// The predicate, slot liveness and the exactness of the cull are set out in
// overlap_cull.cuh. counts[q] = the rows matching q (the wrapper zeroes
// counts before the launch).
//
// Bound on an H100: bytes, or operations where many queries survive a
// chunk. Each row of a chunk that some query keeps is read once (16 or 24
// B at 3.35 TB/s: 64 MB and about 0.02 ms at config 5's 4M rows); the
// operations are the kept (row, query) pairs' overlap and window compares
// plus the per-row extent min/max, at the card's integer rates.
// chip_smoke.py reckons both from the run's inputs and the pairs the cull
// keeps (ops.kernels.overlap_chunk_pairs). At config 5's size the first
// loads, the last chunks and the launch path weigh as much as the bytes,
// so the smoke also times the kernel at 64M rows.
//
// Design: overlap_cull.cuh's box_cull_scan: 512-thread blocks (16 warps an
// SM), 8 rows a thread of each 4096-row chunk in registers, a cp.async ring
// of two chunks (128 or 192 KB of dynamic shared memory) whose first chunks
// are issued before the query tile is staged; each warp culls the tile's
// queries on its own rows' extent and runs the overlap and window tests of
// the survivors only, with no barrier between warps. Counts are per-warp
// __reduce_add_sync partials in shared memory, added with one atomicAdd per
// (block, query). The launch attributes and the occupancy are asked once
// per shared size (launch_cache.cuh).
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_cull.cuh"
#include "count_predicate.cuh"
#include "launch_cache.cuh"
#include "overlap_cull.cuh"

namespace {

using namespace geomesa;

LaunchCache g_launch[2];  // [TIME]

// Counts the warp's matches m of query qi; all 32 lanes call it together.
struct CountEpilogue {
  const Tile& t;
  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t, const ScanRows&,
                                             const Extent&, const EdgeSpan&) const {
    const unsigned c = __reduce_add_sync(FULL_WARP, __popc(m));
    if (c && (threadIdx.x & 31) == 0) t.cnt[(threadIdx.x >> 5) * t.q_tile + qi] += c;
  }
};

template <bool TIME>
__global__ void __launch_bounds__(OV_THREADS, 1)
batched_overlap_kernel(BoxCols cols, int64_t n, int64_t base, int64_t true_n,
                       const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                       const int32_t* __restrict__ times,  // (Q, nt, 4); unread without time
                       int q, int nb, int nt, int q_tile,
                       int32_t* __restrict__ counts) {     // (Q,)
  extern __shared__ int4 smem[];  // the row buffer, then the staged tile
  __shared__ int meta[2];
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  int4* buf = smem;
  box_scan_prologue<TIME>(buf, cols, n);  // the first chunks load while the tile is staged
  const Tile t = carve<OV_WARPS>(smem + BoxLayout<TIME>::BUF_BYTES / 16, q_tile, nb, nt);
  stage_tile<TIME, OV_THREADS>(boxes, times, q0, qt, t, meta);
  const int n_active = meta[0];
  const int64_t limit = valid_limit(n, base, true_n);
  CountEpilogue ep{t};
  if (n_active > 0) {
    if (meta[1])
      box_cull_scan<true, TIME, false>(cols, n, limit, t, n_active, buf, ep);
    else
      box_cull_scan<false, TIME, false>(cols, n, limit, t, n_active, buf, ep);
  } else {
    cp_async_wait_all();
  }
  flush_counts<OV_THREADS>(t, q0, qt, counts);
}

template <bool TIME>
int launch(const BoxCols& cols, long long n, long long base, long long true_n,
           const void* boxes, const void* times, int q, int nb, int nt, int sms, void* counts,
           void* stream) {
  const int tile_max = box_q_tile<TIME>(nb, nt);
  const int q_tile = q < tile_max ? q : tile_max;
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const size_t smem = BoxLayout<TIME>::BUF_BYTES +
                      (size_t)q_tile * staged_bytes_per_query(nb, nt, 0, OV_WARPS);
  int per_sm = 0;
  const cudaError_t e =
      resident_blocks(batched_overlap_kernel<TIME>, OV_THREADS, smem, g_launch[TIME], &per_sm);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const long long resident = (long long)sms * per_sm;
  dim3 grid((unsigned)(chunks < resident ? chunks : resident), q_tiles);
  batched_overlap_kernel<TIME><<<grid, OV_THREADS, smem, (cudaStream_t)stream>>>(
      cols, n, base, true_n, (const int32_t*)boxes, (const int32_t*)times, q, nb, nt, q_tile,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}

}  // namespace

// Queries one block stages at once: nt = 0 is the no-time form.
extern "C" int geomesa_batched_overlap_q_tile(int nb, int nt) {
  return nt > 0 ? box_q_tile<true>(nb, nt) : box_q_tile<false>(nb, 0);
}

// nt = 0 selects the no-time form (bins, offs and times unread, may be
// null); nt > 0 needs all three.
extern "C" int geomesa_batched_overlap(const void* xmin, const void* ymin, const void* xmax,
                                       const void* ymax, const void* bins, const void* offs,
                                       long long n, long long base, long long true_n,
                                       const void* boxes, const void* times, int q, int nb,
                                       int nt, int sms, void* counts, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  if (nb < 1 || nt < 0 || (nt > 0 && (!bins || !offs || !times)))
    return (int)cudaErrorInvalidValue;
  const BoxCols cols{{(const int32_t*)xmin, (const int32_t*)ymin, (const int32_t*)xmax,
                      (const int32_t*)ymax, (const int32_t*)bins, (const int32_t*)offs}};
  if (nt > 0) return launch<true>(cols, n, base, true_n, boxes, times, q, nb, nt, sms, counts,
                                  stream);
  return launch<false>(cols, n, base, true_n, boxes, times, q, nb, 0, sms, counts, stream);
}
