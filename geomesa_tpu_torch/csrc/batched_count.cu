// batched_count: Q bbox+time count queries over int32 point columns, one pass.
//
// Replaces the Pallas kernel geomesa_tpu/ops/pallas_kernels.py:150
// (batched_count -> _count_kernel :95, predicate _tile_mask :46). It computes
// the same function, not the TPU kernel's block schedule: the TPU carries a
// (Q, 128) accumulator across a sequential grid; here blocks run in parallel
// in no order, so each block keeps per-warp partial counts in shared memory
// and adds them into the (Q,) output with one int32 atomicAdd per
// (block, query) that matched.
//
// Bound on an H100: integer instructions, not bytes. The columns are
// 16 B/row (0.24 ms for 50M rows at 3.35 TB/s), while the predicate needs at
// least one subtract and one compare per bound pair of every (row, live box
// slot), and two 64-bit compares (four 32-bit ones) per (row, live window)
// for rows inside a box. Counted by pipe: the compares run only on the ALU
// pipe (64 lanes per SM per clock), a subtract also on the FMA pipe
// (IMAD.IADD), and an SM issues 128 lanes per clock, so the floor is the
// larger of ALU-only instructions at the ALU rate and all instructions at
// the issue rate (chip_smoke.py reckons it from the run's inputs).
//
// Design (count_predicate.cuh): each block stages its query tile once, live
// slots first, as (xlo, xhi - xlo, ylo, yhi - ylo) boxes and biased 64-bit
// window keys, and lists the queries with a live box and a live window; the
// padding slots DataStore packs (B = 8, T = 16 around one live slot each)
// cost nothing per row. Each thread holds 16 consecutive rows of each column
// (int4 loads) across all active queries; per query a warp builds its in-box
// masks, skips the time test when no lane has an in-box row (one vote), and
// otherwise counts in-box & in-window & valid with one __reduce_add_sync,
// writing its shared count only when it is non-zero. A tile whose active
// queries have one live box and one live window each runs the compile-time
// <1, 1> row loop.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace {

using namespace geomesa;

__device__ unsigned long long g_path_blocks[2];

struct CountEpilogue {
  int* cnt;  // (WARPS, q_tile)
  int q_tile;
  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t,
                                             const Rows&) const {
    const unsigned c = __reduce_add_sync(FULL_WARP, __popc(m));
    if ((threadIdx.x & 31) == 0 && c) cnt[(threadIdx.x >> 5) * q_tile + qi] += c;
  }
};

__global__ void __launch_bounds__(THREADS, 2)
batched_count_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                     const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                     int64_t n, int64_t base, int64_t true_n,
                     const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                     const int32_t* __restrict__ times,  // (Q, nt, 4)
                     int q, int nb, int nt, int q_tile,
                     int32_t* __restrict__ out) {
  extern __shared__ int4 smem[];
  __shared__ int meta[2];
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  const Tile t = carve(smem, q_tile, nb, nt);
  stage_tile(boxes, times, q0, qt, t, meta);
  const int n_active = meta[0];
  const int64_t limit = valid_limit(n, base, true_n);
  CountEpilogue ep{t.cnt, q_tile};
  if (n_active > 0) {
    note_path(g_path_blocks, meta[1]);
    if (meta[1])
      scan_rows<true>(x, y, bins, offs, n, limit, t, n_active, ep);
    else
      scan_rows<false>(x, y, bins, offs, n, limit, t, n_active, ep);
  }
  __syncthreads();
  for (int qi = threadIdx.x; qi < qt; qi += THREADS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += t.cnt[w * q_tile + qi];
    if (sum) atomicAdd(&out[q0 + qi], sum);
  }
}

}  // namespace

extern "C" int geomesa_batched_count_q_tile(int nb, int nt) { return q_tile_for(nb, nt, 0); }

// Copies the per-path block counts ([0] <1, 1>, [1] general) since the last
// call into out (host, 2 x uint64) and zeroes them; synchronises the device.
extern "C" int geomesa_batched_count_path_blocks(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_path_blocks, sizeof(g_path_blocks));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_path_blocks, zero, sizeof(zero));
}

extern "C" int geomesa_batched_count(const void* x, const void* y, const void* bins,
                                     const void* offs, long long n, long long base,
                                     long long true_n, const void* boxes,
                                     const void* times, int q, int nb, int nt,
                                     int sms, void* out, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int q_tile = q < q_tile_for(nb, nt, 0) ? q : q_tile_for(nb, nt, 0);
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const size_t smem = (size_t)q_tile * staged_bytes_per_query(nb, nt, 0);
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, batched_count_kernel,
                                                                THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  dim3 grid((unsigned)(chunks < resident ? chunks : resident), q_tiles);
  batched_count_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
      (const int32_t*)offs, n, base, true_n, (const int32_t*)boxes,
      (const int32_t*)times, q, nb, nt, q_tile, (int32_t*)out);
  return (int)cudaGetLastError();
}
