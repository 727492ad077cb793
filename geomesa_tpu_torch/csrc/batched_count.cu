// batched_count: Q bbox+time count queries over int32 point columns, one pass.
//
// Replaces the Pallas kernel geomesa_tpu/ops/pallas_kernels.py:150
// (batched_count -> _count_kernel :95, predicate _tile_mask :46). It computes
// the same function, not the TPU kernel's block schedule: the TPU carries a
// (Q, 128) accumulator across a sequential grid; here blocks run in parallel
// in no order, so each block keeps its partial counts in shared memory and
// adds them into the (Q,) output with one int32 atomicAdd per (block, query).
//
// The row predicate is geomesa::match_rows in count_predicate.cuh, shared
// with batched_count_hits.cu.
//
// Bound on an H100: integer compares, not bytes. The columns are 16 B/row
// (0.24 ms for 50M rows at 3.35 TB/s), while the predicate needs at least 4
// int32 compares per (row, live box slot) and 4 per (row, live time slot) of
// each query (chip_smoke.py reckons it from the run's inputs). Design against
// that bound: the (Q_tile, 4B + 4T) payload sits in shared memory and is read as
// warp-wide broadcasts; each thread holds ROWS rows' four values in
// registers and reuses them for every query of the tile; the time slots are
// evaluated only when some lane of the warp is inside a box (the box test
// alone is the floor of the work); matches are counted with
// __ballot_sync/__popc, so no per-row reduction traffic.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;  // rows per thread per chunk
constexpr int CHUNK = THREADS * ROWS;
constexpr int SMEM_BUDGET = 45056;  // bytes of shared memory per block (< 48 KB)
constexpr int BLOCKS_PER_SM = 8;

// Queries whose payload one block stages in shared memory at once; larger
// batches tile over Q (grid dimension y).
int q_tile_for(int nb, int nt) {
  const int per_q_bytes = (int)sizeof(int32_t) * (4 * (nb + nt) + WARPS);
  const int t = SMEM_BUDGET / per_q_bytes;
  return t > 1 ? t : 1;
}

__global__ void __launch_bounds__(THREADS)
batched_count_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                     const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                     int64_t n, int64_t base, int64_t true_n,
                     const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                     const int32_t* __restrict__ times,  // (Q, nt, 4)
                     int q, int nb, int nt, int q_tile,
                     int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int per_q = 4 * (nb + nt);
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  int32_t* s_pay = smem;                      // (qt, per_q)
  int32_t* s_cnt = smem + q_tile * per_q;     // (WARPS, q_tile)

  for (int i = threadIdx.x; i < qt * per_q; i += THREADS) {
    const int qi = i / per_q;
    const int j = i - qi * per_q;
    const int gq = q0 + qi;
    s_pay[i] = j < 4 * nb ? boxes[(int64_t)gq * 4 * nb + j]
                          : times[(int64_t)gq * 4 * nt + (j - 4 * nb)];
  }
  for (int i = threadIdx.x; i < WARPS * q_tile; i += THREADS) s_cnt[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t limit = geomesa::valid_limit(n, base, true_n);
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;

  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int32_t rx[ROWS], ry[ROWS], rb[ROWS], ro[ROWS];
    bool ok[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int64_t pos = c * CHUNK + (int64_t)r * THREADS + threadIdx.x;
      ok[r] = pos < limit;
      rx[r] = ok[r] ? x[pos] : 0;
      ry[r] = ok[r] ? y[pos] : 0;
      rb[r] = ok[r] ? bins[pos] : 0;
      ro[r] = ok[r] ? offs[pos] : 0;
    }
    for (int qi = 0; qi < qt; ++qi) {
      bool m[ROWS];
      int cnt = 0;
      if (geomesa::match_rows<ROWS>(s_pay + qi * per_q, nb, nt, rx, ry, rb, ro, ok, m)) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) cnt += __popc(__ballot_sync(geomesa::FULL_WARP, m[r]));
      }
      if (lane == 0) s_cnt[warp * q_tile + qi] += cnt;
    }
  }
  __syncthreads();
  for (int qi = threadIdx.x; qi < qt; qi += THREADS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += s_cnt[w * q_tile + qi];
    if (sum) atomicAdd(&out[q0 + qi], sum);
  }
}

}  // namespace

extern "C" int geomesa_batched_count_q_tile(int nb, int nt) { return q_tile_for(nb, nt); }

extern "C" int geomesa_batched_count(const void* x, const void* y, const void* bins,
                                     const void* offs, long long n, long long base,
                                     long long true_n, const void* boxes,
                                     const void* times, int q, int nb, int nt,
                                     int sms, void* out, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int q_tile = q < q_tile_for(nb, nt) ? q : q_tile_for(nb, nt);
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const int grid_x = chunks < (long long)sms * BLOCKS_PER_SM ? (int)chunks : sms * BLOCKS_PER_SM;
  const size_t smem = sizeof(int32_t) * (size_t)q_tile * (4 * (nb + nt) + WARPS);
  dim3 grid(grid_x, q_tiles);
  batched_count_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
      (const int32_t*)offs, n, base, true_n, (const int32_t*)boxes,
      (const int32_t*)times, q, nb, nt, q_tile, (int32_t*)out);
  return (int)cudaGetLastError();
}
