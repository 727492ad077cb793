// batched_density: Q bbox+time density grids over int32 point columns, one
// pass: per query, every row inside a live box and a live window adds 1.0 to
// its cell of that query's own (height, width) f32 grid.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:1193
// (make_batched_density_step), its scatter form (:1246-1261). It is not a
// TPU kernel: the reference computes it in XLA, and on a TPU as one-hot
// matmuls on the MXU (:1262-1285), a TPU device for the lack of a fast
// scatter; the grids are the same. This card has atomics.
//
// What it computes, per query q and row r (local position lpos):
//   in_all = in_box & in_time & valid        (batched_count's predicate)
//   grids[q][cy][cx] += 1.0 for every row with in_all, where, in f32 as the
//   reference computes it (:1246-1256), with gb = grid_bounds[q]:
//     xi = f32(x), xlo = f32(gb[0]), xhi = f32(gb[1])
//     sx = width / (xhi - xlo + 1)
//     cx = clip(int((xi - xlo) * sx), 0, width - 1)   (toward zero)
//   and cy likewise from y, gb[2], gb[3] and height. A matching row outside
//   the grid bounds lands in an edge cell, as in the reference.
// The wrapper zeroes the grids before the launch.
//
// Bit-equal cells. Each operation above runs alone, rounded to nearest
// (__int2float_rn, __fsub_rn, __fadd_rn, __fdiv_rn, __fmul_rn), in the
// reference's order, so nvcc cannot contract a product and a sum into an
// FMA; the file is never built with --use_fast_math. The product is clamped
// into [-1, width] before the truncation (__float2int_rz): XLA's conversion
// saturates, and a saturating conversion followed by the clip gives the
// same cell as the clamp followed by the truncation (a NaN product, from
// an inverted bound, lands in cell 0 either way). An f32 cell counts
// exactly and in any order below 2^24 rows, as the reference's does.
//
// Bound on an H100: bytes. The four columns are read once (16 B a row:
// 0.4776 ms for 100M rows at 3.35 TB/s) and the grids written once (Q x H x
// W x 4 B: 4 MB at Q = 16 and 256 x 256). The row tests need fewer
// operations than that once culled, and a match costs one cell (about ten
// f32 and integer operations) and one atomic.
//
// Design: chunk_cull.cuh's culled scan, as batched_edge_gather.cu uses it.
// Each block stages its query tile once (live slots first, stage_tile) and,
// beside it, each query's xlo, ylo, sx and sy; it walks 4096-row chunks
// grid-stride, the rows arriving through a 64 KB cp.async buffer; per chunk
// it lists the active queries whose live slots meet the chunk's extent
// (rows are resident in z3 order, so most (chunk, query) pairs of a batch
// of city-box, few-day queries are culled) and runs the row tests for those
// only. Each matching row adds 1.0 to its cell with one global atomicAdd. A
// 256 x 256 f32 grid is 256 KB, more than a block's shared memory, so the
// grids are not privatized per block.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_cull.cuh"
#include "count_predicate.cuh"

namespace {

using namespace geomesa;

// the survivor list, then xlo, ylo, sx and sy: one int or float each per staged query
constexpr int EXTRA_INTS = 5;

// The cell of coordinate v along an axis of n cells from lo at scale s.
__device__ __forceinline__ int cell_of(int32_t v, float lo, float s, int n) {
  float f = __fmul_rn(__fsub_rn(__int2float_rn(v), lo), s);
  f = fminf(fmaxf(f, -1.0f), __int2float_rn(n));  // a NaN becomes -1
  const int c = __float2int_rz(f);
  return min(max(c, 0), n - 1);
}

// Adds the warp's matches m of query qi into its grid; bit r of m is a row
// held in rows. No warp-wide operation, so a lane with no match returns.
struct DensityEpilogue {
  const float* xlo;  // (q_tile) each, in shared memory
  const float* ylo;
  const float* sx;
  const float* sy;
  float* grids;  // the tile's first query's grid
  int width, height;
  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t, const Rows& rows) const {
    if (!m) return;
    const float x0 = xlo[qi], y0 = ylo[qi], ax = sx[qi], ay = sy[qi];
    float* g = grids + (int64_t)qi * width * height;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if ((m >> r) & 1u) {
        const int cx = cell_of(rows.x[r], x0, ax, width);
        const int cy = cell_of(rows.y[r], y0, ay, height);
        atomicAdd(g + (int64_t)cy * width + cx, 1.0f);
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS, 2)
batched_density_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                       const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                       int64_t n, int64_t base, int64_t true_n,
                       const int32_t* __restrict__ boxes,        // (Q, nb, 4)
                       const int32_t* __restrict__ times,        // (Q, nt, 4)
                       int q, int nb, int nt, int q_tile,
                       const int32_t* __restrict__ grid_bounds,  // (Q, 4) xlo xhi ylo yhi
                       float* __restrict__ grids,                // (Q, height, width)
                       int width, int height) {
  extern __shared__ int4 smem[];  // the row buffer, then the staged tile
  __shared__ int meta[2];
  __shared__ Extent warp_ext[WARPS];
  __shared__ int n_surv[2];
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  int4* buf = smem;
  const Tile t = carve(smem + ROW_BUF_BYTES / 16, q_tile, nb, nt);
  float* cell = reinterpret_cast<float*>(t.extra + q_tile);  // xlo, ylo, sx, sy rows
  if (threadIdx.x < 2) n_surv[threadIdx.x] = 0;  // stage_tile's barriers order this
  stage_tile(boxes, times, q0, qt, t, meta);
  for (int qi = threadIdx.x; qi < qt; qi += THREADS) {
    const int32_t* gb = grid_bounds + (int64_t)(q0 + qi) * 4;
    const float xlo = __int2float_rn(gb[0]), xhi = __int2float_rn(gb[1]);
    const float ylo = __int2float_rn(gb[2]), yhi = __int2float_rn(gb[3]);
    cell[qi] = xlo;
    cell[q_tile + qi] = ylo;
    cell[2 * q_tile + qi] = __fdiv_rn(__int2float_rn(width), __fadd_rn(__fsub_rn(xhi, xlo), 1.0f));
    cell[3 * q_tile + qi] =
        __fdiv_rn(__int2float_rn(height), __fadd_rn(__fsub_rn(yhi, ylo), 1.0f));
  }
  __syncthreads();
  const int n_active = meta[0];
  const int64_t limit = valid_limit(n, base, true_n);
  DensityEpilogue ep{cell, cell + q_tile, cell + 2 * q_tile, cell + 3 * q_tile,
                     grids + (int64_t)q0 * width * height, width, height};
  if (n_active > 0) {
    if (meta[1])
      cull_scan<true>(x, y, bins, offs, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
    else
      cull_scan<false>(x, y, bins, offs, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
  }
}

}  // namespace

extern "C" int geomesa_batched_density_q_tile(int nb, int nt) {
  return q_tile_for(nb, nt, EXTRA_INTS);
}

extern "C" int geomesa_batched_density(const void* x, const void* y, const void* bins,
                                       const void* offs, long long n, long long base,
                                       long long true_n, const void* boxes, const void* times,
                                       int q, int nb, int nt, int sms, const void* grid_bounds,
                                       void* grids, int width, int height, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int tile_max = q_tile_for(nb, nt, EXTRA_INTS);
  const int q_tile = q < tile_max ? q : tile_max;
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const size_t smem = ROW_BUF_BYTES + (size_t)q_tile * staged_bytes_per_query(nb, nt, EXTRA_INTS);
  cudaError_t e = cudaFuncSetAttribute(batched_density_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(batched_density_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, batched_density_kernel, THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  dim3 grid((unsigned)(chunks < resident ? chunks : resident), q_tiles);
  batched_density_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins, (const int32_t*)offs, n, base,
      true_n, (const int32_t*)boxes, (const int32_t*)times, q, nb, nt, q_tile,
      (const int32_t*)grid_bounds, (float*)grids, width, height);
  return (int)cudaGetLastError();
}
