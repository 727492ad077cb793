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
// parallel in no order, each walking chunks of CHUNK rows grid-stride. A
// thread holds ROWS consecutive rows, lpos = row0 + r, so its rows fall in
// the lanes (row0 + r) & 127; CHUNK is a multiple of 128, so a thread sees
// the same lanes in every chunk. Each matched row folds its global position
// into its own lane of a (q_tile, 128) shared-memory scoreboard with a shared
// atomicMax. Where a warp holds more than DENSE matches of a query (more
// than two per thread), a row that a later thread of the warp beats in the
// same lane is dropped first (three shuffles of the match masks), so a dense
// query pays at most one shared atomic per lane per warp instead of up to
// four conflicting ones; below that the shuffles cost more than the
// conflicts they save. At the end the block issues one global atomicMax per
// (query, lane) that it saw matched. Counts are per-warp __reduce_add_sync
// partials in shared memory, added into the output with one atomicAdd per
// (block, query), as in batched_count.cu. The staged predicate and the row scan are
// count_predicate.cuh's, the same ones batched_count.cu runs.
//
// Bound on an H100: integer instructions counted by pipe, as for
// batched_count: 16 B/row of columns, against one subtract (ALU or FMA pipe)
// and one compare (ALU pipe) per bound pair of every (row, live box slot),
// two 64-bit compares per (row, live window) inside a box, plus one compare
// per matched (row, query) for the lane maximum (chip_smoke.py reckons the
// floor from the run's inputs). The stream's B = T = 1 matrix takes the
// compile-time <1, 1> row loop.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace {

using namespace geomesa;

constexpr int LANES = 128;
constexpr unsigned DENSE = 64;  // matches per warp and query above which the epilogue folds
static_assert(CHUNK % LANES == 0, "a thread must see the same lanes in every chunk");
static_assert(ROWS <= LANES, "a thread's rows must fall in distinct lanes");

__device__ unsigned long long g_path_blocks[2];

struct HitsEpilogue {
  int* cnt;  // (WARPS, q_tile)
  int* pos;  // (q_tile, LANES)
  int q_tile;
  int64_t base;
  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t row0,
                                             const Rows&) const {
    const unsigned c = __reduce_add_sync(FULL_WARP, __popc(m));
    if ((threadIdx.x & 31) == 0 && c) cnt[(threadIdx.x >> 5) * q_tile + qi] += c;
    // global position of the thread's first row; the wrapper guarantees base + n < 2^31
    const int32_t gpos0 = (int32_t)(base + row0);
    const int lane0 = (int)(row0 & (LANES - 1));
    if (c > DENSE) {
      // threads t, t + 8, t + 16, t + 24 of a warp hold the same 16 lanes,
      // the later thread the newer rows: a row whose bit a later thread of
      // the group also has is no lane's maximum, so at most one shared
      // atomic per lane per warp remains
      const int tl = threadIdx.x & 31;
      uint32_t later = 0;
#pragma unroll
      for (int d = 8; d < 32; d += 8) {
        const uint32_t v = __shfl_down_sync(FULL_WARP, m, d);
        if (tl + d < 32) later |= v;
      }
      m &= ~later;
    }
    int* sp = pos + qi * LANES;
    while (m) {
      const int r = __ffs(m) - 1;
      m &= m - 1;
      atomicMax(sp + ((lane0 + r) & (LANES - 1)), gpos0 + r);
    }
  }
};

__global__ void __launch_bounds__(THREADS, 2)
batched_count_hits_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                          const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                          int64_t n, int64_t base, int64_t true_n,
                          const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                          const int32_t* __restrict__ times,  // (Q, nt, 4)
                          int q, int nb, int nt, int q_tile,
                          int32_t* __restrict__ counts,       // (Q,)
                          int32_t* __restrict__ lane_pos) {   // (Q, 128)
  extern __shared__ int4 smem[];
  __shared__ int meta[2];
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, q - q0);
  const Tile t = carve(smem, q_tile, nb, nt);
  int* s_pos = t.extra;  // (q_tile, LANES)
  for (int i = threadIdx.x; i < q_tile * LANES; i += THREADS) s_pos[i] = -1;
  stage_tile(boxes, times, q0, qt, t, meta);
  const int n_active = meta[0];
  const int64_t limit = valid_limit(n, base, true_n);
  HitsEpilogue ep{t.cnt, s_pos, q_tile, base};
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
    if (sum) atomicAdd(&counts[q0 + qi], sum);
  }
  for (int i = threadIdx.x; i < qt * LANES; i += THREADS) {
    const int32_t p = s_pos[i];
    if (p >= 0) atomicMax(&lane_pos[(int64_t)q0 * LANES + i], p);
  }
}

}  // namespace

extern "C" int geomesa_batched_count_hits_q_tile(int nb, int nt) {
  return q_tile_for(nb, nt, LANES);
}

// Copies the per-path block counts ([0] <1, 1>, [1] general) since the last
// call into out (host, 2 x uint64) and zeroes them; synchronises the device.
extern "C" int geomesa_batched_count_hits_path_blocks(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_path_blocks, sizeof(g_path_blocks));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_path_blocks, zero, sizeof(zero));
}

extern "C" int geomesa_batched_count_hits(const void* x, const void* y, const void* bins,
                                          const void* offs, long long n, long long base,
                                          long long true_n, const void* boxes,
                                          const void* times, int q, int nb, int nt,
                                          int sms, void* counts, void* lane_pos,
                                          void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int q_tile = q < q_tile_for(nb, nt, LANES) ? q : q_tile_for(nb, nt, LANES);
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const size_t smem = (size_t)q_tile * staged_bytes_per_query(nb, nt, LANES);
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, batched_count_hits_kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  dim3 grid((unsigned)(chunks < resident ? chunks : resident), q_tiles);
  batched_count_hits_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
      (const int32_t*)offs, n, base, true_n, (const int32_t*)boxes,
      (const int32_t*)times, q, nb, nt, q_tile, (int32_t*)counts,
      (int32_t*)lane_pos);
  return (int)cudaGetLastError();
}
