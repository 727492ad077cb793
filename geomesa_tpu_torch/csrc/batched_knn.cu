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
// Bound on an H100: operations. Per (row, query) two subtracts, two
// multiplies, an add and a compare: about 6 f32 operations, at most 67 / 2
// T/s issued (1.15 ms at 100M rows and 64 queries), against 8 B a row read
// once for all queries (0.24 ms).
//
// Design. Two kernels:
//   1. knn_select_kernel, grid (segments, query tiles), 8 warps a block:
//      the block takes a contiguous segment of rows and a tile of up to 64
//      queries, qpw a warp. It decodes 2048 rows at a time into shared
//      memory (NaN past the valid rows and past the segment, so that they
//      never pass), and each warp takes R = 8 of them a lane into
//      registers and, for each of its queries (point, bound and buffer
//      count read from shared memory), computes d2 and keeps the
//      smallest; the warp votes whether any lane's smallest passes the
//      query's bound. The bound is the largest d2 that still enters the
//      query's list: the query's cap while the list has an empty slot, else
//      the float just below the k-th entry's d2 (a warp meets its rows in
//      increasing order, so a tie with the k-th entry loses). Nearly every
//      vote is no. A yes appends the passing rows to the query's buffer of
//      32 candidates in shared memory (a ballot and a prefix count); a full
//      buffer merges into the query's sorted list of k (d2, lpos) entries
//      (knn_flush: each entry's rank by counting, then one scatter), which
//      tightens the bound. At the end of its segment the warp merges what
//      its buffers hold and writes its lists to scratch (Q, segments, k).
//      (The first version inserted each passing row into the list with a
//      warp-wide shift: in z3 order the rows reach a point along the curve
//      and pass often, and it read 12% of its bound.)
//   2. knn_merge_kernel, one block per query: k rounds of a block-wide
//      minimum over the segments' list heads.
//
// The cap. Rows in z3 order approach a point along the curve, so a list
// whose bound starts at +inf takes many inserts before it tightens. A first
// select and merge over every stride-th valid row (stride >= 16, about 2^18
// rows sampled, 2048 a segment) gives each query the k-th smallest d2 of
// the sample, and the full select starts every list's bound there
// (inclusive). The sample's rows are valid rows with the same d2, so the
// true k-th smallest d2 is at most the sample's: every row of the answer
// passes the cap, and the merge orders them as before. With fewer than k
// eligible sampled rows the cap is +inf. Below 16 x 2048 valid rows there
// is no sample pass.
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
constexpr int CH = 2048;  // rows decoded into shared memory at a time
constexpr int R = 8;      // rows a lane holds in registers
constexpr int MAX_K = 256;
constexpr int MAX_QPW = 8;  // queries a warp: a tile holds up to 64
constexpr int BUF = 32;     // candidates a warp buffers per query before merging them
constexpr int SENTINEL = 0x7fffffff;  // the lpos of an empty list slot
constexpr long long SAMPLE_ROWS = 1 << 18;      // rows the cap's sample aims at
constexpr long long SAMPLE_SEG_ROWS = 2048;  // sampled rows a segment of its select takes
constexpr long long MIN_STRIDE = 16;        // the sample takes at most every 16th row
static_assert(CH % (32 * R) == 0 && (R & (R - 1)) == 0, "whole register groups; R a power of 2");

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
// All 32 lanes call it together.
__device__ __noinline__ float knn_flush(float* ld, int* lr, const float* bd, const int* br,
                                        int k, int cnt, float open) {
  constexpr int L = MAX_K / 32;  // list entries a lane holds at most; then its buffered one
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
  const float kd = ld[k - 1];
  return lr[k - 1] == SENTINEL ? open : __int_as_float(__float_as_int(kd) - 1);
}

// The rare path of a query whose vote was yes: appends the rows of one
// register group (lane's rows bx[j * 32 + lane], j < R, in shared memory;
// index row0 + j * 32 + lane) that pass bound to the query's buffer (bd,
// br; *nbuf held), merging a full buffer into the list first; returns the
// bound. It reads the rows again from shared memory, so that the hot loop's
// registers stay out of it. All 32 lanes call it together.
__device__ __noinline__ float knn_append(const float* bx, const float* by, float px, float py,
                                         float bound, int64_t row0, int64_t stride, float* ld,
                                         int* lr, float* bd, int* br, int* nbuf, int k,
                                         float open) {
  const int lane = threadIdx.x & 31;
  int cnt = *nbuf;
  for (int j = 0; j < R; ++j) {
    const float d = dist2(bx[j * 32 + lane], by[j * 32 + lane], px, py);
    const bool pass = d <= bound;
    const unsigned b = __ballot_sync(FULL_WARP, pass);
    if (!b) continue;
    if (cnt + __popc(b) > BUF) {
      bound = knn_flush(ld, lr, bd, br, k, cnt, open);
      cnt = 0;
    }
    if (pass) {
      const int at = cnt + __popc(b & ((1u << lane) - 1));
      bd[at] = d;
      br[at] = (int)((row0 + j * 32 + lane) * stride);
    }
    cnt += __popc(b);
  }
  __syncwarp();
  if (lane == 0) *nbuf = cnt;
  __syncwarp();
  return bound;
}

// Selects over rows idx * stride for idx in [0, m), those with idx below
// limit valid; a list entry's lpos is idx * stride. A block serves the
// queries [blockIdx.y * 8 * qpw, +8 * qpw), qpw a warp; each query's point,
// bound and buffer count live in shared memory (a warp reads its query's
// three floats once per 256 rows), so the hot loop holds only its rows in
// registers. cap (Q,), or null for +inf, starts each query's bound.
__global__ void __launch_bounds__(THREADS)
knn_select_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, int64_t m,
                  int64_t limit, int64_t stride, const float* __restrict__ qx,
                  const float* __restrict__ qy, const float* __restrict__ cap, int q, int k,
                  int qpw, int64_t seg_len, float* __restrict__ cand_d,
                  int32_t* __restrict__ cand_r) {
  extern __shared__ float smem[];
  const int q_tile = WARPS * qpw;
  float* bx = smem;                                   // (CH) decoded x
  float* by = bx + CH;                                // (CH) decoded y
  float* ld = by + CH;                                // (q_tile, k) list distances
  int* lr = reinterpret_cast<int*>(ld + q_tile * k);  // (q_tile, k) list rows
  float* bd = reinterpret_cast<float*>(lr + q_tile * k);  // (q_tile, BUF) buffered distances
  int* br = reinterpret_cast<int*>(bd + q_tile * BUF);    // (q_tile, BUF) buffered rows
  float* qp = reinterpret_cast<float*>(br + q_tile * BUF);  // (q_tile, 4): x, y, bound, open
  int* nbuf = reinterpret_cast<int*>(qp + 4 * q_tile);      // (q_tile) buffered counts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_block = blockIdx.y * q_tile;
  for (int i = threadIdx.x; i < q_tile * k; i += THREADS) ld[i] = CUDART_INF_F, lr[i] = SENTINEL;
  for (int i = threadIdx.x; i < q_tile; i += THREADS) {
    const bool on = q_block + i < q;
    const float open = on ? (cap ? cap[q_block + i] : CUDART_INF_F) : -CUDART_INF_F;
    qp[4 * i] = on ? qx[q_block + i] : 0.0f;
    qp[4 * i + 1] = on ? qy[q_block + i] : 0.0f;
    qp[4 * i + 2] = open;  // an absent query takes no row
    qp[4 * i + 3] = open;
    nbuf[i] = 0;
  }
  __syncthreads();  // the lists and query states are initialised (a segment may hold no row)
  const int64_t s0 = (int64_t)blockIdx.x * seg_len;
  const int64_t s1 = s0 + seg_len < m ? s0 + seg_len : m;
  const int64_t end = s1 < limit ? s1 : limit;
  for (int64_t c0 = s0; c0 < s1; c0 += CH) {
    if (c0 != s0) __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < CH; i += THREADS) {
      const int64_t idx = c0 + i;
      const bool ok = idx < end;
      bx[i] = ok ? decode_x(__ldg(x + idx * stride)) : CUDART_NAN_F;
      by[i] = ok ? decode_y(__ldg(y + idx * stride)) : CUDART_NAN_F;
    }
    __syncthreads();
    for (int sub = 0; sub < CH; sub += 32 * R) {
      float xr[R], yr[R];
#pragma unroll
      for (int j = 0; j < R; ++j) xr[j] = bx[sub + j * 32 + lane], yr[j] = by[sub + j * 32 + lane];
#pragma unroll 2
      for (int qq = 0; qq < qpw; ++qq) {
        const int slot = warp * qpw + qq;
        const float4 p = *reinterpret_cast<const float4*>(qp + 4 * slot);
        float d[R];
#pragma unroll
        for (int j = 0; j < R; ++j) d[j] = dist2(xr[j], yr[j], p.x, p.y);
#pragma unroll
        for (int w = 1; w < R; w *= 2)  // a tree of minima; fminf keeps the non-NaN operand
#pragma unroll
          for (int j = 0; j + w < R; j += 2 * w) d[j] = fminf(d[j], d[j + w]);
        if (!__any_sync(FULL_WARP, d[0] <= p.z)) continue;
        const float bound = knn_append(bx + sub, by + sub, p.x, p.y, p.z, c0 + sub, stride,
                                       ld + slot * k, lr + slot * k, bd + slot * BUF,
                                       br + slot * BUF, nbuf + slot, k, p.w);
        if (lane == 0) qp[4 * slot + 2] = bound;
        __syncwarp();
      }
    }
  }
  for (int qq = 0; qq < qpw; ++qq) {
    const int slot = warp * qpw + qq;
    if (nbuf[slot])
      knn_flush(ld + slot * k, lr + slot * k, bd + slot * BUF, br + slot * BUF, k, nbuf[slot],
                0.0f);
  }
  __syncthreads();
  const int segs = gridDim.x;
  for (int qq = 0; qq < qpw; ++qq) {
    const int qi = q_block + warp * qpw + qq;
    if (qi >= q) break;
    const int64_t at = ((int64_t)qi * segs + blockIdx.x) * k;
    for (int s = lane; s < k; s += 32) {
      cand_d[at + s] = ld[(warp * qpw + qq) * k + s];
      cand_r[at + s] = lr[(warp * qpw + qq) * k + s];
    }
  }
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
  return (size_t)2 * CH * sizeof(float) +
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
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, knn_select_kernel, THREADS, smem);
}

struct SelectArgs {
  const int32_t *x, *y;
  int64_t m, limit, stride;
  const float *qx, *qy, *cap;
  int q, k;
  float* cand_d;
  int32_t* cand_r;
};

// One select over rows idx * stride, idx < m (below limit valid), on segs
// segments, then its merge.
cudaError_t select_and_merge(cudaStream_t s, const SelectArgs& a, int segs, int64_t n,
                             int64_t base, float* dist, int32_t* rows, float* kth) {
  const int qpw = qpw_for(a.q);
  const int q_tiles = (a.q + WARPS * qpw - 1) / (WARPS * qpw);
  const int64_t chunks = (a.m + CH - 1) / CH;
  const int64_t seg_len = (chunks + segs - 1) / segs * CH;
  knn_select_kernel<<<dim3((unsigned)segs, (unsigned)q_tiles), THREADS, select_smem(qpw, a.k),
                      s>>>(a.x, a.y, a.m, a.limit, a.stride, a.qx, a.qy, a.cap, a.q, a.k, qpw,
                           seg_len, a.cand_d, a.cand_r);
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

// cap: (q,) float scratch for the sample pass's k-th d2.
extern "C" int geomesa_batched_knn(const void* x, const void* y, long long n, long long base,
                                   long long true_n, const void* qx, const void* qy, int q, int k,
                                   int segs, void* cand_d, void* cand_r, void* cap, void* dist,
                                   void* rows, void* stream) {
  if (q <= 0 || n <= 0) return (int)cudaSuccess;
  if (k < 1 || k > MAX_K || segs < 1) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t e = occupancy_for(q, k, &per_sm);  // sets the dynamic shared-memory limit
  if (e != cudaSuccess) return (int)e;
  const long long left = true_n - base;
  const long long limit = left < n ? (left > 0 ? left : 0) : n;
  const cudaStream_t s = (cudaStream_t)stream;
  SelectArgs a{(const int32_t*)x, (const int32_t*)y, n, limit, 1, (const float*)qx,
               (const float*)qy, nullptr, q, k, (float*)cand_d, (int32_t*)cand_r};
  const long long stride = limit / SAMPLE_ROWS > MIN_STRIDE ? limit / SAMPLE_ROWS : MIN_STRIDE;
  if (limit / stride >= CH) {  // the cap's sample pass
    SelectArgs sample = a;
    sample.m = sample.limit = (limit + stride - 1) / stride;
    sample.stride = stride;
    const long long per_seg = (sample.m + SAMPLE_SEG_ROWS - 1) / SAMPLE_SEG_ROWS;
    e = select_and_merge(s, sample, per_seg < segs ? (int)per_seg : segs, n, base, nullptr,
                         nullptr, (float*)cap);
    if (e != cudaSuccess) return (int)e;
    a.cap = (const float*)cap;
  }
  return (int)select_and_merge(s, a, segs, n, base, (float*)dist, (int32_t*)rows, nullptr);
}
