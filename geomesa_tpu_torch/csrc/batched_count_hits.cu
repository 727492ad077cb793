// batched_count_hits: Q bbox+time count queries over int32 point columns,
// plus the newest matched row per 128-row lane, one pass.
//
// Replaces the Pallas kernel geomesa_tpu/ops/pallas_kernels.py:217
// (batched_count_hits -> _count_hits_kernel :118, predicate _tile_mask :46),
// the fused scan of the subscription matrix: one launch per streamed chunk
// gives every standing query its exact count and a sample of its newest
// matches.
//
// Outputs: counts (Q,) int32, and lane_pos (Q, 128) int32, where
// lane_pos[q][l] is the greatest global position base + lpos of a row
// matching q with lpos % 128 == l, or -1 (the caller fills lane_pos with -1
// before the launch). The lane is the column of the reference's row-major
// (N/128, 128) reshape (pallas_kernels.py:243), so the sample equals the
// reference's bit for bit.
//
// What differs from the TPU kernel: the TPU carries (Q, 128) count and
// position accumulators across a sequential grid in VMEM. Here blocks run in
// parallel in no order. A block walks chunks of CHUNK rows grid-stride; row
// pos = c*CHUNK + r*THREADS + tid, and since CHUNK and THREADS are multiples
// of 128, a thread always sees lane tid & 127 (warps w and w+4 share each
// lane). Each thread keeps its newest match of the chunk per query in a
// register and folds it into a (q_tile, 128) shared-memory scoreboard with a
// shared atomicMax; at the end the block issues one global atomicMax per
// (query, lane) that it saw matched. Counts are per-warp __ballot_sync/__popc
// partials in shared memory, added into the output with one atomicAdd per
// (block, query), as in batched_count.cu. The predicate is
// geomesa::match_rows (count_predicate.cuh), the same function that
// batched_count.cu runs.
//
// Bound on an H100: integer compares, as for batched_count: 16 B/row of
// columns, against at least 4 int32 compares per (row, live box slot) and per
// (row, live time slot) of each query, plus one compare per matched
// (row, query) for the lane maximum (chip_smoke.py reckons it from the run's
// inputs). The design keeps the rows in registers across the queries of a
// tile, the payload in shared memory, and the scoreboard traffic at one
// shared atomic per (thread, query) that matched in a chunk.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 128;
constexpr int ROWS = 4;  // rows per thread per chunk
constexpr int CHUNK = THREADS * ROWS;
constexpr int SMEM_BUDGET = 45056;  // bytes of shared memory per block (< 48 KB)
constexpr int BLOCKS_PER_SM = 8;
static_assert(THREADS % LANES == 0, "a thread must keep one lane");

// Queries one block stages at once: payload, per-warp counts and the lane
// scoreboard, per query; larger batches tile over Q (grid dimension y).
int hits_q_tile_for(int nb, int nt) {
  const int per_q_bytes = (int)sizeof(int32_t) * (4 * (nb + nt) + WARPS + LANES);
  const int t = SMEM_BUDGET / per_q_bytes;
  return t > 1 ? t : 1;
}

__global__ void __launch_bounds__(THREADS)
batched_count_hits_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                          const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                          int64_t n, int64_t base, int64_t true_n,
                          const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                          const int32_t* __restrict__ times,  // (Q, nt, 4)
                          int q, int nb, int nt, int q_tile,
                          int32_t* __restrict__ counts,       // (Q,)
                          int32_t* __restrict__ lane_pos) {   // (Q, 128)
  extern __shared__ int32_t smem[];
  const int per_q = 4 * (nb + nt);
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  int32_t* s_pay = smem;                          // (qt, per_q)
  int32_t* s_cnt = s_pay + q_tile * per_q;        // (WARPS, q_tile)
  int32_t* s_pos = s_cnt + WARPS * q_tile;        // (q_tile, LANES)

  for (int i = threadIdx.x; i < qt * per_q; i += THREADS) {
    const int qi = i / per_q;
    const int j = i - qi * per_q;
    const int gq = q0 + qi;
    s_pay[i] = j < 4 * nb ? boxes[(int64_t)gq * 4 * nb + j]
                          : times[(int64_t)gq * 4 * nt + (j - 4 * nb)];
  }
  for (int i = threadIdx.x; i < WARPS * q_tile; i += THREADS) s_cnt[i] = 0;
  for (int i = threadIdx.x; i < q_tile * LANES; i += THREADS) s_pos[i] = -1;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = threadIdx.x & (LANES - 1);
  const int64_t limit = geomesa::valid_limit(n, base, true_n);
  const int64_t n_chunks = (n + CHUNK - 1) / CHUNK;

  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int32_t rx[ROWS], ry[ROWS], rb[ROWS], ro[ROWS];
    bool ok[ROWS];
    // global position of row r; the wrapper guarantees base + n < 2^31
    const int32_t gpos0 = (int32_t)(base + c * CHUNK + threadIdx.x);
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
      if (!geomesa::match_rows<ROWS>(s_pay + qi * per_q, nb, nt, rx, ry, rb, ro, ok, m))
        continue;
      int cnt = 0;
      int32_t newest = -1;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        cnt += __popc(__ballot_sync(geomesa::FULL_WARP, m[r]));
        if (m[r]) newest = gpos0 + r * THREADS;  // rows ascend with r
      }
      if (newest >= 0) atomicMax(&s_pos[qi * LANES + slot], newest);
      if (lane == 0) s_cnt[warp * q_tile + qi] += cnt;
    }
  }
  __syncthreads();
  for (int qi = threadIdx.x; qi < qt; qi += THREADS) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += s_cnt[w * q_tile + qi];
    if (sum) atomicAdd(&counts[q0 + qi], sum);
  }
  for (int i = threadIdx.x; i < qt * LANES; i += THREADS) {
    const int32_t p = s_pos[i];
    if (p >= 0) atomicMax(&lane_pos[(int64_t)q0 * LANES + i], p);
  }
}

}  // namespace

extern "C" int geomesa_batched_count_hits_q_tile(int nb, int nt) {
  return hits_q_tile_for(nb, nt);
}

extern "C" int geomesa_batched_count_hits(const void* x, const void* y, const void* bins,
                                          const void* offs, long long n, long long base,
                                          long long true_n, const void* boxes,
                                          const void* times, int q, int nb, int nt,
                                          int sms, void* counts, void* lane_pos,
                                          void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int q_tile = q < hits_q_tile_for(nb, nt) ? q : hits_q_tile_for(nb, nt);
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const int grid_x = chunks < (long long)sms * BLOCKS_PER_SM ? (int)chunks : sms * BLOCKS_PER_SM;
  const size_t smem = sizeof(int32_t) * (size_t)q_tile * (4 * (nb + nt) + WARPS + LANES);
  dim3 grid(grid_x, q_tiles);
  batched_count_hits_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
      (const int32_t*)offs, n, base, true_n, (const int32_t*)boxes,
      (const int32_t*)times, q, nb, nt, q_tile, (int32_t*)counts,
      (int32_t*)lane_pos);
  return (int)cudaGetLastError();
}
