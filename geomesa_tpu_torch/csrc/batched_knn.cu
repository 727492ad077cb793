// batched_knn: the k nearest rows of each of Q query points over the int32
// point columns, one read of the rows for all queries, then a merge.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:1125
// (make_batched_knn_step: _local_knn_heaps :987 in its map, blocked :1061 and
// scan :1089 forms, which return the same answer) and, on one card, the ring
// merge of make_ring_knn_step :1295 (no hop). It is not a TPU kernel: the
// reference computes it in XLA.
//
// What it computes, per query q (qx, qy in f32 degrees) and row r at local
// position lpos below limit = min(n, true_n - base), in f32 as the
// reference decodes (:968-984), each operation rounded alone (__int2float_rn,
// __fmul_rn, __fsub_rn, __fadd_rn; no FMA, so that the plain PyTorch
// version, which does not contract, gives the same bits):
//   xf = f32(x) * (360 / 2^31) - 180,   yf = f32(y) * (180 / 2^31) - 90
//   d2 = (xf - qx)^2 + (yf - qy)^2
// A row is eligible when it is valid and its d2 is not NaN. Output slot j <
// k of query q holds the j-th smallest eligible (d2, lpos) in lexicographic
// order (ties go to the lower row, as lax.top_k's and the reference's scan
// form's "the EARLIER row wins"): dist = sqrt(d2) (__fsqrt_rn, IEEE) and row
// = base + lpos; a slot past the eligible rows holds (+inf, base + min(j, n -
// 1)), which is where the reference's map form puts its inf slots (the
// invalid rows after the last valid one, in order) and _pad_to_blocks clamps
// them (:1039).
//
// Bound on an H100: bytes. Every row is read once for all queries (8 B a
// row: 0.24 ms at 100M rows). An exact select need not compute a (row,
// query) distance whose tile cannot hold a row of the query's list, so the
// operations it must do are one lower-bound test a (256-row tile, query)
// pair and the distances of the rows of the tiles that pass it; an
// all-pairs select does about 6 f32 operations a (row, query) pair (1.15 ms
// at 100M rows and 64 queries).
//
// Design. Three kernels:
//   1. knn_select_kernel, grid (blocks, query tiles), 8 consumer warps and
//      2 producer warps a block. Block b takes the chunks of 2048 rows b,
//      b + G, b + 2G, ... (G blocks along x, so that the grid reads
//      neighbouring chunks at once) in increasing order, and a tile of up to
//      64 queries, qpw a consumer warp. The producers keep two chunks in
//      flight by cp.async in a ring of five stages; each decodes the half of
//      a landed chunk that it copied in place (NaN past the valid rows, so
//      that they never pass) with the decoded extent of each of its tiles of
//      TILE = 256 rows (from the int min and max over the tile's valid rows:
//      each decode is monotone), and marks the stage full (an mbarrier). The
//      consumers walk the chunks at their own pace, up to three behind the
//      producers, and mark a stage empty when all of them are done with it,
//      so that a burst of evaluations in one warp holds neither the others
//      nor the copies back. The skip: for each (tile, query) pair of a
//      consumer warp, a lane each, the lower bound lb of the query's d2 over
//      the tile's extent, dx = max(0, xlo - qx, qx - xhi) and the same for
//      dy, lb = dx^2 + dy^2 with the rounded operations dist2 uses. Each
//      decode and each rounded operation is monotone, so lb is at most the
//      d2 of every row of the tile, bit for bit; a pair whose lb exceeds the
//      query's bound (below) holds no row that can enter its list, and is
//      skipped (an empty extent always is; a NaN lb never is). The warp then
//      takes the pairs it kept, tile by tile: with R = 8 rows a lane (two
//      16-byte reads of x and of y) it computes d2 and votes whether any row
//      passes the query's bound, the largest d2 that may still enter the
//      query's list (inclusive): the query's cap while the list has an
//      empty slot, else the k-th entry's d2. A yes appends the passing rows
//      to the query's buffer of 32 candidates in shared memory (a ballot and
//      a prefix count); a full buffer merges into the query's sorted list of
//      k (d2, lpos) entries (knn_flush: each entry's rank by counting, then
//      one scatter), which tightens the bound. The merge orders by (d2,
//      lpos), so rows may arrive in any order. At the end the consumers
//      merge what their buffers hold and write their lists to scratch (Q,
//      blocks, k).
//      (The first version inserted each passing row into the list with a
//      warp-wide shift and read 12% of the all-pairs bound; the second
//      computed every (row, query) d2 and read 42%.)
//   2. knn_gather_kernel copies the cap's sampled rows (below) into scratch.
//   3. knn_merge_kernel, one block per query: k rounds of a block-wide
//      minimum over the blocks' list heads.
//
// The cap. Rows in z3 order approach a point along the curve, so a list
// whose bound starts at +inf takes many inserts before it tightens, and
// skips no tile. A first select and merge over every stride-th valid row
// (stride >= 16, about 2^18 rows sampled and gathered, one query a warp)
// gives each query the k-th smallest d2 of the sample, and the full select
// starts every list's bound there. The sample's rows are valid rows with
// the same d2, so the true k-th smallest d2 is at most the sample's: every
// row of the answer passes the cap, and the merge orders them as before.
// With fewer than k eligible sampled rows the cap is +inf. Below 16 x 2048
// valid rows there is no sample pass. In the sample's select, whose lists
// start at +inf, a list with an empty slot first lowers its bound to the
// k-th smallest of the lanes' row minima of the tile (k <= 32): it then
// takes a few rows past the k it needs instead of every row of its first
// tiles.
//
// Plain C entry points for ctypes; launches on the caller's stream, does not
// synchronise, returns a cudaError_t.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 2048;  // rows of a chunk: a stage of the select's ring
constexpr int R = 8;      // rows a lane evaluates
constexpr int TILE = 32 * R;       // rows under one extent
constexpr int TILES = CH / TILE;   // tiles a chunk
constexpr int STAGES = 5;  // chunks of the select's ring
constexpr int DEPTH = 2;   // chunks the producers keep in flight: consumers may lag STAGES - DEPTH
constexpr int PRODUCERS = 2;  // producer warps of the select, each a half of every chunk
constexpr int SELECT_THREADS = THREADS + 32 * PRODUCERS;  // the consumer and producer warps
constexpr int MAX_K = 256;
constexpr int MAX_QPW = 8;  // queries a warp: a tile holds up to 64
constexpr int BUF = 32;     // candidates a warp buffers per query before merging them
constexpr int SENTINEL = 0x7fffffff;  // the lpos of an empty list slot
constexpr long long SAMPLE_ROWS = 1 << 18;      // rows the cap's sample aims at
constexpr long long MIN_STRIDE = 16;        // the sample takes at most every 16th row
static_assert(TILES * MAX_QPW <= 64 && R == 8, "a warp's (tile, query) pairs: two a lane");

__device__ __forceinline__ float decode_x(int32_t v) {
  return __fsub_rn(__fmul_rn(__int2float_rn(v), 0x1.68p-23f), 180.0f);  // 360 / 2^31
}

__device__ __forceinline__ float decode_y(int32_t v) {
  return __fsub_rn(__fmul_rn(__int2float_rn(v), 0x1.68p-24f), 90.0f);  // 180 / 2^31
}

__device__ __forceinline__ float dist2(float xf, float yf, float qx, float qy) {
  const float dx = __fsub_rn(xf, qx), dy = __fsub_rn(yf, qy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// (d, r) before (e, s) in lexicographic order.
__device__ __forceinline__ bool before(float d, int r, float e, int s) {
  return d < e || (d == e && r < s);
}

// Merges the cnt candidates buffered in (bd, br) into the sorted list (ld,
// lr) of k entries, keeping the k smallest (d2, lpos); returns the list's
// new bound (see the file note): ``open`` while a slot is empty. Every
// buffered row is a distinct real row, never in the list, so the ranks
// below are a permutation: a list entry's is its index plus the buffered
// entries before it; a buffered entry's is the list entries before it (a
// binary search: the list is sorted) plus the buffered entries before it.
// All 32 lanes call it together; L is the list entries a lane holds at
// most (k <= 32 L).
template <int L>
__device__ __noinline__ float knn_flush(float* ld, int* lr, const float* bd, const int* br,
                                        int k, int cnt, float open) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the appends are visible
  float dv[L + 1];
  int rv[L + 1], rank[L + 1];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int e = i * 32 + lane;
    rank[i] = k;  // kept nowhere
    if (e < k) {
      dv[i] = ld[e], rv[i] = lr[e];
      int rk = e;
      for (int f = 0; f < cnt; ++f) rk += before(bd[f], br[f], dv[i], rv[i]);
      rank[i] = rk;
    }
  }
  rank[L] = k;
  if (lane < cnt) {
    dv[L] = bd[lane], rv[L] = br[lane];
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(ld[mid], lr[mid], dv[L], rv[L])) lo = mid + 1; else hi = mid;
    }
    for (int f = 0; f < cnt; ++f) lo += before(bd[f], br[f], dv[L], rv[L]);
    rank[L] = lo;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i <= L; ++i)
    if (rank[i] < k) ld[rank[i]] = dv[i], lr[rank[i]] = rv[i];
  __syncwarp();
  return lr[k - 1] == SENTINEL ? open : ld[k - 1];
}

// The rare path of a query whose vote was yes: appends the lane's rows of
// one tile (d2 in d, NaN where not valid: rows row0 + h * 128 + 4 * lane +
// j for slot 4 * h + j) that pass bound to the query's buffer (bd, br;
// *nbuf held), merging a full buffer into the list first; returns the
// bound. With k <= 32, no cap (the sample's select: a capped list keeps
// its cap's bound, which timed faster) and a list that has an empty slot,
// the bound first drops to the k-th smallest of the lanes' minima dmin: k
// distinct rows of the tile are that near, so no farther row can be among
// the block's k nearest, and the list takes a few rows past the k it needs
// instead of every row of the tile. The bound is inclusive and the flush
// orders by (d2, row), so the rows may arrive in any order. All 32 lanes
// call it together.
__device__ __forceinline__ float knn_append(const float (&d)[R], float dmin, float bound,
                                            int64_t row0, float* ld, int* lr,
                                            float* bd, int* br, int* nbuf, int k, float open) {
  const int lane = threadIdx.x & 31;
  float tile = CUDART_INF_F;
  if (k <= 32 && open == CUDART_INF_F && lr[k - 1] == SENTINEL) {
    const float v = dmin == dmin ? dmin : CUDART_INF_F;
    int rank = 0;  // the lanes before this one in (v, lane) order
#pragma unroll
    for (int o = 0; o < 32; ++o) {
      const float w = __shfl_sync(FULL_WARP, v, o);
      rank += w < v || (w == v && o < lane);
    }
    tile = __shfl_sync(FULL_WARP, v, __ffs(__ballot_sync(FULL_WARP, rank == k - 1)) - 1);
    bound = tile < bound ? tile : bound;
  }
  int cnt = *nbuf;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const bool pass = d[j] <= bound;
    const unsigned b = __ballot_sync(FULL_WARP, pass);
    if (!b) continue;
    if (cnt + __popc(b) > BUF) {
      bound = k <= 32 ? knn_flush<1>(ld, lr, bd, br, k, cnt, open)
                      : knn_flush<MAX_K / 32>(ld, lr, bd, br, k, cnt, open);
      bound = tile < bound ? tile : bound;
      cnt = 0;
    }
    if (pass) {  // a row past a bound the flush lowered is dropped by the next flush
      const int at = cnt + __popc(b & ((1u << lane) - 1));
      bd[at] = d[j];
      br[at] = (int)(row0 + (j >> 2) * 128 + 4 * lane + (j & 3));
    }
    cnt += __popc(b);
  }
  __syncwarp();
  if (lane == 0) *nbuf = cnt;
  __syncwarp();
  return bound;
}

// The least d2 of a query (qx, qy) over a tile whose decoded extent is e
// = (xlo, xhi, ylo, yhi): dx = max(0, xlo - qx, qx - xhi), the same for dy,
// then dx^2 + dy^2, each operation rounded as dist2 rounds it, so the bound
// is at most the d2 of every row of the tile. A NaN query gives NaN.
__device__ __forceinline__ float tile_bound(float4 e, float qx, float qy) {
  float dx = __fsub_rn(e.x, qx), dy = __fsub_rn(e.z, qy);
  const float hx = __fsub_rn(qx, e.y), hy = __fsub_rn(qy, e.w);
  dx = hx > dx ? hx : dx;  // a comparison with NaN is false: NaN stays
  dy = hy > dy ? hy : dy;
  dx = dx < 0.0f ? 0.0f : dx;
  dy = dy < 0.0f ? 0.0f : dy;
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)), "r"(count) : "memory");
}

// Arrives on bar (release: this thread's shared-memory writes and reads
// before it are ordered before the phase completes).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)) : "memory");
}

// Waits until bar's phase of the given parity has completed (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n KNN_WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      " @!done bra KNN_WAIT_%=;\n}\n" ::"r"((unsigned)__cvta_generic_to_shared(bar)),
      "r"(parity) : "memory");
}

// Producer warp part: starts the copy of its half of the CH rows from row
// c0 into stage (x then y, CH int32 each) and commits it as one cp.async
// group (an empty group for a chunk at or past m). With 16-byte aligned
// columns each lane copies 16-byte groups by cp.async, rows at m or past it
// as zeros; otherwise it loads its rows one at a time and stores them.
__device__ __forceinline__ void issue_chunk(int32_t* stage, const int32_t* __restrict__ x,
                                            const int32_t* __restrict__ y, int64_t c0,
                                            int64_t m, bool aligned, int part) {
  const int lane = threadIdx.x & 31;
  if (c0 < m) {
    if (aligned) {
#pragma unroll 4
      for (int h = part * (CH / 128 / PRODUCERS); h < (part + 1) * (CH / 128 / PRODUCERS); ++h) {
        const int at = 4 * (lane + h * 32);
        const int64_t left = m - (c0 + at);
        const int bytes = left >= 4 ? 16 : (left <= 0 ? 0 : (int)left * 4);
        const int64_t src = bytes ? c0 + at : 0;  // no byte is read when bytes == 0
        cp_async16(stage + at, x + src, bytes);
        cp_async16(stage + CH + at, y + src, bytes);
      }
    } else {
      // 16 rows of each column in flight at a time
      for (int h = part * (CH / 32 / PRODUCERS); h < (part + 1) * (CH / 32 / PRODUCERS); h += 16) {
        int vx[16], vy[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int64_t idx = c0 + lane + (h + j) * 32;
          vx[j] = idx < m ? __ldg(x + idx) : 0;
          vy[j] = idx < m ? __ldg(y + idx) : 0;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j)
          stage[lane + (h + j) * 32] = vx[j], stage[CH + lane + (h + j) * 32] = vy[j];
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Producer warp part: decodes its half of the chunk in stage (rows from c0,
// the tiles it copied) in place,
// NaN at limit or past it so that those rows never pass, and writes each
// tile's decoded extent over its valid rows to ext (the int min and max:
// each decode is monotone, so their decodes are the decoded extent; a tile
// with no valid row gets the empty extent (+inf, -inf, +inf, -inf)).
__device__ __forceinline__ void decode_chunk(int32_t* stage, float4* ext, int64_t c0,
                                             int64_t limit, int part) {
  const int lane = threadIdx.x & 31;
  float* bx = reinterpret_cast<float*>(stage);
  float* by = bx + CH;
#pragma unroll 1
  for (int t = part * (TILES / PRODUCERS); t < (part + 1) * (TILES / PRODUCERS); ++t) {
    int xlo = INT32_MAX, xhi = INT32_MIN, ylo = INT32_MAX, yhi = INT32_MIN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = t * TILE + h * 128 + 4 * lane;
      const int4 vx = *reinterpret_cast<const int4*>(stage + at);
      const int4 vy = *reinterpret_cast<const int4*>(stage + CH + at);
      const int xs[4] = {vx.x, vx.y, vx.z, vx.w}, ys[4] = {vy.x, vy.y, vy.z, vy.w};
      float fx[4], fy[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = c0 + at + j < limit;
        if (ok) {
          xlo = min(xlo, xs[j]), xhi = max(xhi, xs[j]);
          ylo = min(ylo, ys[j]), yhi = max(yhi, ys[j]);
        }
        fx[j] = ok ? decode_x(xs[j]) : CUDART_NAN_F;
        fy[j] = ok ? decode_y(ys[j]) : CUDART_NAN_F;
      }
      *reinterpret_cast<float4*>(bx + at) = make_float4(fx[0], fx[1], fx[2], fx[3]);
      *reinterpret_cast<float4*>(by + at) = make_float4(fy[0], fy[1], fy[2], fy[3]);
    }
    xlo = __reduce_min_sync(FULL_WARP, xlo), xhi = __reduce_max_sync(FULL_WARP, xhi);
    ylo = __reduce_min_sync(FULL_WARP, ylo), yhi = __reduce_max_sync(FULL_WARP, yhi);
    if (lane == 0)
      ext[t] = xlo > xhi ? make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F)
                         : make_float4(decode_x(xlo), decode_x(xhi), decode_y(ylo),
                                       decode_y(yhi));
  }
}

// Selects over rows [0, m), those below limit valid; a list entry's lpos
// is its row. Block b takes the
// chunks of CH rows b, b + G, b + 2G, ... (G blocks along x: the whole grid
// reads neighbouring chunks at once) in increasing order, and serves the
// queries [blockIdx.y * 8 * qpw, +8 * qpw), qpw a consumer warp; each
// query's point, bound and buffer count live in shared memory. cap (Q,),
// or null for +inf, starts each query's bound. Warp WARPS is the producer:
// it keeps DEPTH chunks in flight in a ring of STAGES, decodes each landed
// chunk in place with its tiles' extents and marks the stage full; the
// consumer warps 0..WARPS-1 each walk the chunks at their own pace, testing
// and evaluating their queries' pairs, and mark a stage empty when done
// with it, so that a burst of evaluations in one warp does not hold the
// others or the copies back.
__global__ void __launch_bounds__(SELECT_THREADS, 2)
knn_select_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, int64_t m,
                  int64_t limit, const float* __restrict__ qx,
                  const float* __restrict__ qy, const float* __restrict__ cap, int q, int k,
                  int qpw, float* __restrict__ cand_d, int32_t* __restrict__ cand_r) {
  extern __shared__ float4 smem4[];
  const int q_tile = WARPS * qpw;
  // (STAGES, 2, CH): x then y of a chunk, raw as copied, then decoded in place
  int32_t* ring = reinterpret_cast<int32_t*>(smem4);
  float4* ext = reinterpret_cast<float4*>(ring + STAGES * 2 * CH);  // (STAGES, TILES) extents
  uint64_t* full = reinterpret_cast<uint64_t*>(ext + STAGES * TILES);  // (STAGES)
  uint64_t* empty = full + STAGES;                                      // (STAGES)
  float* ld = reinterpret_cast<float*>(empty + STAGES);  // (q_tile, k) list distances
  int* lr = reinterpret_cast<int*>(ld + q_tile * k);     // (q_tile, k) list rows
  float* bd = reinterpret_cast<float*>(lr + q_tile * k);  // (q_tile, BUF) buffered distances
  int* br = reinterpret_cast<int*>(bd + q_tile * BUF);    // (q_tile, BUF) buffered rows
  float* qp = reinterpret_cast<float*>(br + q_tile * BUF);  // (q_tile, 4): x, y, bound, open
  int* nbuf = reinterpret_cast<int*>(qp + 4 * q_tile);      // (q_tile) buffered counts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_block = blockIdx.y * q_tile;
  const int64_t first = blockIdx.x * (int64_t)CH, step = (int64_t)gridDim.x * CH;
  const int chunks = first < m ? (int)((m - first + step - 1) / step) : 0;
  if (threadIdx.x < STAGES) {
    mbar_init(full + threadIdx.x, 32 * PRODUCERS);  // the producers' lanes
    mbar_init(empty + threadIdx.x, THREADS);  // the consumers' threads
  }
  for (int i = threadIdx.x; i < q_tile * k; i += SELECT_THREADS)
    ld[i] = CUDART_INF_F, lr[i] = SENTINEL;
  for (int i = threadIdx.x; i < q_tile; i += SELECT_THREADS) {
    const bool on = q_block + i < q;
    const float open = on ? (cap ? cap[q_block + i] : CUDART_INF_F) : -CUDART_INF_F;
    qp[4 * i] = on ? qx[q_block + i] : 0.0f;
    qp[4 * i + 1] = on ? qy[q_block + i] : 0.0f;
    qp[4 * i + 2] = open;  // an absent query takes no row
    qp[4 * i + 3] = open;
    nbuf[i] = 0;
  }
  __syncthreads();  // the barriers, lists and query states are initialised
  if (warp >= WARPS) {  // a producer: its part of each chunk (the rows it copies, it decodes)
    const int part = warp - WARPS;
    const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) &
                          15) == 0;
    for (int i = 0; i < chunks + DEPTH; ++i) {
      if (i < chunks) {  // copy chunk i once the consumers are done with its stage
        if (i >= STAGES) mbar_wait(empty + i % STAGES, (i / STAGES - 1) & 1);
        issue_chunk(ring + (i % STAGES) * 2 * CH, x, y, first + i * step, m, aligned, part);
      } else {
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      const int j = i - DEPTH;  // then decode chunk j, DEPTH copies behind
      if (j >= 0) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(DEPTH) : "memory");
        __syncwarp();  // every lane's copies of chunk j have landed
        decode_chunk(ring + (j % STAGES) * 2 * CH, ext + (j % STAGES) * TILES, first + j * step,
                     limit, part);
        mbar_arrive(full + j % STAGES);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {  // a consumer: the (tile, query) pairs p = tile * qpw + query of its queries
    const int pairs = TILES * qpw;
    const int qpw_inv = (65536 + qpw - 1) / qpw;  // (p * qpw_inv) >> 16 == p / qpw for p < 64
    const int p_tile[2] = {lane / qpw, (lane + 32) / qpw};
    const int p_slot[2] = {warp * qpw + lane % qpw, warp * qpw + (lane + 32) % qpw};
    for (int i = 0; i < chunks; ++i) {
      const int64_t c0 = first + i * step;
      const float* bx = reinterpret_cast<const float*>(ring + (i % STAGES) * 2 * CH);
      const float* by = bx + CH;
      const float4* e4 = ext + (i % STAGES) * TILES;
      mbar_wait(full + i % STAGES, (i / STAGES) & 1);
      unsigned long long keep = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // a lane tests p = lane and p = lane + 32
        bool kept = false;
        if (lane + 32 * h < pairs) {
          const float4 e = e4[p_tile[h]];
          const float4 p = *reinterpret_cast<const float4*>(qp + 4 * p_slot[h]);
          kept = e.x <= e.y && !(tile_bound(e, p.x, p.y) > p.z);
        }
        keep |= (unsigned long long)__ballot_sync(FULL_WARP, kept) << (32 * h);
      }
      // the kept pairs in increasing p: tile by tile, so each query meets its rows in order
      while (keep) {
        const int pi = __ffsll(keep) - 1;
        keep &= keep - 1;
        const int t = (pi * qpw_inv) >> 16;
        const int sub = t * TILE, slot = warp * qpw + pi - t * qpw;
        const float4 p = *reinterpret_cast<const float4*>(qp + 4 * slot);
        float d[R];  // the lane's rows 4 at a time: 4 * lane + [0, 4) and 128 + the same
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 fx = *reinterpret_cast<const float4*>(bx + sub + h * 128 + 4 * lane);
          const float4 fy = *reinterpret_cast<const float4*>(by + sub + h * 128 + 4 * lane);
          d[4 * h] = dist2(fx.x, fy.x, p.x, p.y), d[4 * h + 1] = dist2(fx.y, fy.y, p.x, p.y);
          d[4 * h + 2] = dist2(fx.z, fy.z, p.x, p.y), d[4 * h + 3] = dist2(fx.w, fy.w, p.x, p.y);
        }
        float dmin = d[0];  // fminf keeps the non-NaN operand
#pragma unroll
        for (int j = 1; j < R; ++j) dmin = fminf(dmin, d[j]);
        if (!__any_sync(FULL_WARP, dmin <= p.z)) continue;
        const float bound = knn_append(d, dmin, p.z, c0 + sub, ld + slot * k,
                                       lr + slot * k, bd + slot * BUF, br + slot * BUF,
                                       nbuf + slot, k, p.w);
        if (lane == 0) qp[4 * slot + 2] = bound;
        __syncwarp();
      }
      mbar_arrive(empty + i % STAGES);
    }
    for (int qq = 0; qq < qpw; ++qq) {
      const int slot = warp * qpw + qq;
      if (nbuf[slot] && k <= 32)
        knn_flush<1>(ld + slot * k, lr + slot * k, bd + slot * BUF, br + slot * BUF, k,
                     nbuf[slot], 0.0f);
      else if (nbuf[slot])
        knn_flush<MAX_K / 32>(ld + slot * k, lr + slot * k, bd + slot * BUF, br + slot * BUF, k,
                              nbuf[slot], 0.0f);
    }
  }
  __syncthreads();
  const int segs = gridDim.x;
  for (int qq = 0; warp < WARPS && qq < qpw; ++qq) {
    const int qi = q_block + warp * qpw + qq;
    if (qi >= q) break;
    const int64_t at = ((int64_t)qi * segs + blockIdx.x) * k;
    for (int s = lane; s < k; s += 32) {
      cand_d[at + s] = ld[(warp * qpw + qq) * k + s];
      cand_r[at + s] = lr[(warp * qpw + qq) * k + s];
    }
  }
}

// Copies the sampled rows idx * stride, idx < m, of x and y into gx and gy.
__global__ void __launch_bounds__(THREADS)
knn_gather_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, int64_t m,
                  int64_t stride, int32_t* __restrict__ gx, int32_t* __restrict__ gy) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < m) gx[i] = __ldg(x + i * stride), gy[i] = __ldg(y + i * stride);
}

// Merges the segments' lists of each query into dist and rows (when not
// null), or into kth (when not null): the k-th smallest d2, +inf when the
// lists hold fewer than k rows.
__global__ void __launch_bounds__(THREADS)
knn_merge_kernel(const float* __restrict__ cand_d, const int32_t* __restrict__ cand_r, int segs,
                 int k, int64_t n, int64_t base, float* __restrict__ dist,
                 int32_t* __restrict__ rows, float* __restrict__ kth) {
  extern __shared__ int heads[];  // (segs): the next entry of each segment's list
  __shared__ float wd[WARPS];
  __shared__ int wr[WARPS], ws[WARPS];
  const int qi = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* cd = cand_d + (int64_t)qi * segs * k;
  const int32_t* cr = cand_r + (int64_t)qi * segs * k;
  for (int s = threadIdx.x; s < segs; s += THREADS) heads[s] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float bd = CUDART_INF_F;
    int br = SENTINEL, bs = -1;
    for (int s = threadIdx.x; s < segs; s += THREADS) {
      const int h = heads[s];
      if (h >= k) continue;
      const float d = cd[(int64_t)s * k + h];
      const int r = cr[(int64_t)s * k + h];
      if (bs < 0 || before(d, r, bd, br)) bd = d, br = r, bs = s;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float d = __shfl_xor_sync(FULL_WARP, bd, o);
      const int r = __shfl_xor_sync(FULL_WARP, br, o);
      const int s = __shfl_xor_sync(FULL_WARP, bs, o);
      if (s >= 0 && (bs < 0 || before(d, r, bd, br) || (d == bd && r == br && s < bs)))
        bd = d, br = r, bs = s;
    }
    if (lane == 0) wd[warp] = bd, wr[warp] = br, ws[warp] = bs;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < WARPS; ++w) {
        const int s = ws[w];
        if (s >= 0 && (bs < 0 || before(wd[w], wr[w], bd, br))) bd = wd[w], br = wr[w], bs = s;
      }
      // every list holds k entries, so some head is left while j < k
      heads[bs] += 1;
      const int64_t at = (int64_t)qi * k + j;
      if (kth && j == k - 1) kth[qi] = br == SENTINEL ? CUDART_INF_F : bd;
      if (dist && br == SENTINEL) {
        dist[at] = CUDART_INF_F;
        rows[at] = (int32_t)(base + (j < n - 1 ? j : n - 1));
      } else if (dist) {
        dist[at] = __fsqrt_rn(bd);
        rows[at] = (int32_t)(base + br);
      }
    }
    __syncthreads();
  }
}

size_t select_smem(int qpw, int k) {
  return (size_t)STAGES * (2 * CH * sizeof(int32_t) + TILES * sizeof(float4) +
                          2 * sizeof(uint64_t)) +
         (size_t)WARPS * qpw * ((k + BUF) * (sizeof(float) + sizeof(int)) + 5 * sizeof(float));
}

// Queries a warp takes: enough for min(q, 64) queries over the 8 warps.
int qpw_for(int q) {
  const int t = q < WARPS * MAX_QPW ? q : WARPS * MAX_QPW;
  return (t + WARPS - 1) / WARPS;
}

cudaError_t occupancy_for(int q, int k, int* per_sm) {
  const size_t smem = select_smem(qpw_for(q), k);
  cudaError_t e = cudaFuncSetAttribute(knn_select_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, knn_select_kernel, SELECT_THREADS,
                                                       smem);
}

struct SelectArgs {
  const int32_t *x, *y;
  int64_t m, limit;
  const float *qx, *qy, *cap;
  int q, k;
  float* cand_d;
  int32_t* cand_r;
};

// One select over rows [0, m) (below limit valid), on segs
// blocks along x with qpw queries a warp, then its merge.
cudaError_t select_and_merge(cudaStream_t s, const SelectArgs& a, int segs, int qpw, int64_t n,
                             int64_t base, float* dist, int32_t* rows, float* kth) {
  const int q_tiles = (a.q + WARPS * qpw - 1) / (WARPS * qpw);
  knn_select_kernel<<<dim3((unsigned)segs, (unsigned)q_tiles), SELECT_THREADS,
                      select_smem(qpw, a.k),
                      s>>>(a.x, a.y, a.m, a.limit, a.qx, a.qy, a.cap, a.q, a.k, qpw,
                           a.cand_d, a.cand_r);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  knn_merge_kernel<<<a.q, THREADS, (size_t)segs * sizeof(int), s>>>(
      a.cand_d, a.cand_r, segs, a.k, n, base, dist, rows, kth);
  return cudaGetLastError();
}

}  // namespace

// The row segments (the select kernel's blocks along x) of a launch at n rows,
// q queries and k neighbours on a card of sms SMs, into *out (host int).
extern "C" int geomesa_batched_knn_segments(long long n, int q, int k, int sms, void* out) {
  int per_sm = 0;
  const cudaError_t e = occupancy_for(q, k, &per_sm);
  if (e != cudaSuccess) return (int)e;
  const long long chunks = (n + CH - 1) / CH;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long segs = chunks < resident ? chunks : resident;
  *(int*)out = (int)(segs > 0 ? segs : 1);
  return (int)cudaSuccess;
}

// cap: (q,) float scratch for the sample pass's k-th d2; sample: (2,
// sample_cap) int32 scratch for its rows (the sampled rows of x, then of
// y), sample_cap a multiple of 4 so that both columns are 16-byte aligned.
extern "C" int geomesa_batched_knn(const void* x, const void* y, long long n, long long base,
                                   long long true_n, const void* qx, const void* qy, int q, int k,
                                   int segs, void* cand_d, void* cand_r, void* cap, void* sample,
                                   long long sample_cap, void* dist, void* rows, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > MAX_K || segs < 1) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t e = occupancy_for(q, k, &per_sm);  // sets the dynamic shared-memory limit
  if (e != cudaSuccess) return (int)e;
  const long long left = true_n - base;
  const long long limit = left < n ? (left > 0 ? left : 0) : n;
  const cudaStream_t s = (cudaStream_t)stream;
  SelectArgs a{(const int32_t*)x, (const int32_t*)y, n, limit, (const float*)qx,
               (const float*)qy, nullptr, q, k, (float*)cand_d, (int32_t*)cand_r};
  const long long stride = limit / SAMPLE_ROWS > MIN_STRIDE ? limit / SAMPLE_ROWS : MIN_STRIDE;
  if (limit / stride >= CH) {  // the cap's sample pass, over the sampled rows gathered
    const long long m = (limit + stride - 1) / stride;
    if (m > sample_cap || sample_cap % 4) return (int)cudaErrorInvalidValue;
    int32_t* gx = (int32_t*)sample;
    knn_gather_kernel<<<(unsigned)((m + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        a.x, a.y, m, stride, gx, gx + sample_cap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    SelectArgs sample_args = a;
    sample_args.x = gx, sample_args.y = gx + sample_cap, sample_args.m = sample_args.limit = m;
    const long long chunks = (m + CH - 1) / CH;
    e = select_and_merge(s, sample_args, chunks < segs ? (int)chunks : segs, 1, n, base, nullptr,
                         nullptr, (float*)cap);
    if (e != cudaSuccess) return (int)e;
    a.cap = (const float*)cap;
  }
  return (int)select_and_merge(s, a, segs, qpw_for(q), n, base, (float*)dist, (int32_t*)rows,
                               nullptr);
}
