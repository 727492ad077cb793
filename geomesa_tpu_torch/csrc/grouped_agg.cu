// grouped_agg: Q bbox+time GROUP BY queries over the resident point columns
// in one pass, the device half of DataStore.aggregate_many.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:1498
// (make_grouped_agg_step, point mode, one shard, without with_ttl). It is
// not a TPU kernel: the reference computes it in XLA, and counts there with
// _onehot_bincount (:1464), one-hot matmuls on the MXU, a TPU device for
// the lack of a scatter. This card has atomics, so the fold is atomics.
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
// The wrapper fills cnt, vcnt, vsum and hits with 0, first with INT32_MAX,
// pos with -1, vmin with the order key of +inf and vmax with that of -inf.
// An order key is the double's bits as a signed 64-bit integer, with the
// sign bit's companions flipped for a negative double (b ^ 0x7fff...f):
// signed order of the keys is the order of the doubles (NaN never folds),
// so vmin and vmax fold with 64-bit integer atomicMin / atomicMax. The
// wrapper decodes them with the same involution.
//
// Bound on an H100: bytes, with the atomics beside them. The four columns
// are read once (16 B a row: 0.2388 ms for 50M rows at 3.35 TB/s), plus gid,
// rowid and every value of each row that folds in some query, plus the
// outputs written once. Each folded (row, query) costs 2 + 4 V global
// atomics (count, first; per value column count, sum, min, max), which
// chip_smoke.py logs beside the bound.
//
// Design: the scan is batched_edge_gather's (chunk_cull.cuh cull_scan on
// count_predicate.cuh's staged slots: 4096-row chunks staged by cp.async,
// the (chunk, query) pairs whose extents cannot meet culled, the rows in
// registers). Its epilogue splits a warp's matches into boundary rows,
// appended by append_lanes, and fold rows, which each lane folds one by one
// with global atomics: int atomicAdd for the counts, int atomicMin for
// first, native f64 atomicAdd for the sums. A simple kernel: the groups are
// not privatized in shared memory, so the atomics' order is not fixed and
// sums may differ from a sequential sum in the last bits.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing, returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_cull.cuh"
#include "count_predicate.cuh"

namespace {

using namespace geomesa;

constexpr int SURVIVOR_INTS = 1;  // the survivor list: one int per staged query

// The order key of a double: signed 64-bit order == the doubles' order.
__device__ __forceinline__ long long order_key(double v) {
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

// Splits the warp's matches m of query qi into boundary rows (appended to
// the query's lanes) and fold rows (folded into its groups); all 32 lanes
// call it together. Bit r of m is chunk row chunk0 + chunk_row(r). Every
// pointer addresses the tile's first query.
struct AggEpilogue {
  const Tile& t;
  int64_t base;
  const int32_t* __restrict__ gid;    // (n,)
  const int32_t* __restrict__ rowid;  // (n,)
  const double* __restrict__ vals;    // (nv, n)
  int64_t n;
  int nv, g, cap;
  int32_t* __restrict__ cnt;     // (Q, g)
  int32_t* __restrict__ first;   // (Q, g)
  int32_t* __restrict__ vcnt;    // (Q, nv, g)
  double* __restrict__ vsum;     // (Q, nv, g)
  long long* __restrict__ vmin;  // (Q, nv, g) order keys
  long long* __restrict__ vmax;  // (Q, nv, g) order keys
  int32_t* __restrict__ hits;    // (Q,)
  int32_t* __restrict__ pos;     // (Q, cap)

  __device__ __forceinline__ void operator()(int qi, uint32_t m, int64_t chunk0,
                                             const Rows& rows) const {
    if (!__any_sync(FULL_WARP, m)) return;  // warp-uniform
    const uint32_t e = m ? edge_mask(t, qi, m, rows) : 0u;
    append_lanes(e, base + chunk0, hits + qi, pos + (int64_t)qi * cap, cap);
    uint32_t f = m & ~e;
    const int64_t at_q = (int64_t)qi * g;
    while (f) {
      const int r = __ffs(f) - 1;
      f &= f - 1;
      const int64_t row = chunk0 + chunk_row(r);
      const int grp = __ldg(gid + row);
      if ((unsigned)grp >= (unsigned)g) continue;
      atomicAdd(cnt + at_q + grp, 1);
      atomicMin(first + at_q + grp, __ldg(rowid + row));
      for (int v = 0; v < nv; ++v) {
        const double val = __ldg(vals + (int64_t)v * n + row);
        if (isnan(val)) continue;
        const int64_t at = at_q * nv + (int64_t)v * g + grp;  // ((qi * nv) + v) * g + grp
        atomicAdd(vcnt + at, 1);
        atomicAdd(vsum + at, val);
        const long long key = order_key(val);
        atomicMin(vmin + at, key);
        atomicMax(vmax + at, key);
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS, 2)
grouped_agg_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                   const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                   int64_t n, int64_t base, int64_t true_n,
                   const int32_t* __restrict__ boxes,  // (Q, nb, 4)
                   const int32_t* __restrict__ times,  // (Q, nt, 4)
                   int q, int nb, int nt, int q_tile,
                   const int32_t* __restrict__ gid, const int32_t* __restrict__ rowid,
                   const double* __restrict__ vals, int32_t* __restrict__ cnt,
                   int32_t* __restrict__ first, int32_t* __restrict__ vcnt,
                   double* __restrict__ vsum, long long* __restrict__ vmin,
                   long long* __restrict__ vmax, int32_t* __restrict__ hits,
                   int32_t* __restrict__ pos, int nv, int g, int cap) {
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
  if (n_active == 0) return;  // block-uniform, after the last barrier
  const int64_t qg = (int64_t)q0 * g, qvg = (int64_t)q0 * nv * g;
  AggEpilogue ep{t, base, gid, rowid, vals, n, nv, g, cap,
                 cnt + qg, first + qg, vcnt + qvg, vsum + qvg, vmin + qvg, vmax + qvg,
                 hits + q0, pos + (int64_t)q0 * cap};
  const int64_t limit = valid_limit(n, base, true_n);
  if (meta[1])
    cull_scan<true>(x, y, bins, offs, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
  else
    cull_scan<false>(x, y, bins, offs, n, limit, t, n_active, buf, warp_ext, n_surv, ep);
}

}  // namespace

// The kernel as compiled (cudaFuncGetAttributes): out (host, 2 x int) gets
// its registers per thread and its local memory bytes per thread (spills).
extern "C" int geomesa_grouped_agg_attrs(void* out) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, grouped_agg_kernel);
  if (e == cudaSuccess) {
    ((int*)out)[0] = attr.numRegs;
    ((int*)out)[1] = (int)attr.localSizeBytes;
  }
  return (int)e;
}

extern "C" int geomesa_grouped_agg(const void* x, const void* y, const void* bins,
                                   const void* offs, long long n, long long base,
                                   long long true_n, const void* boxes, const void* times,
                                   int q, int nb, int nt, int sms, const void* gid,
                                   const void* rowid, const void* vals, void* cnt, void* first,
                                   void* vcnt, void* vsum, void* vmin, void* vmax, void* hits,
                                   void* pos, int nv, int g, int cap, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  const int tile_max = q_tile_for(nb, nt, SURVIVOR_INTS);
  const int q_tile = q < tile_max ? q : tile_max;
  const int q_tiles = (q + q_tile - 1) / q_tile;
  const size_t smem =
      ROW_BUF_BYTES + (size_t)q_tile * staged_bytes_per_query(nb, nt, SURVIVOR_INTS);
  cudaError_t e = cudaFuncSetAttribute(grouped_agg_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(grouped_agg_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grouped_agg_kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CHUNK - 1) / CHUNK;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  dim3 grid((unsigned)(chunks < resident ? chunks : resident), q_tiles);
  grouped_agg_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins, (const int32_t*)offs, n, base,
      true_n, (const int32_t*)boxes, (const int32_t*)times, q, nb, nt, q_tile,
      (const int32_t*)gid, (const int32_t*)rowid, (const double*)vals, (int32_t*)cnt,
      (int32_t*)first, (int32_t*)vcnt, (double*)vsum, (long long*)vmin, (long long*)vmax,
      (int32_t*)hits, (int32_t*)pos, nv, g, cap);
  return (int)cudaGetLastError();
}
