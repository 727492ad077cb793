// polygon_join: the block-sparse ST_Within count of the spatial join: for
// each polygon, the resident points strictly inside it by the f32 crossing
// number, over the row blocks its plan names.
//
// Replaces the XLA step geomesa_tpu/ops/join.py:357 (make_block_join_step)
// and its kernel body _membership (:56), which the reference also maps over
// every point for points_in_polygons_count (:77). It is not a TPU kernel:
// the reference computes it in XLA, K x V x N elementwise on the VPU.
//
// What it computes. A pair i is (polygon p, block b): the rows [b * block,
// (b + 1) * block) of the resident f32 columns x, y (degrees, sorted in z2
// order). counts[p] gains the rows r of the pair with
//   r < true_n,
//   bb.xmin <= x <= bb.xmax and bb.ymin <= y <= bb.ymax   (bbox[p]),
//   an odd number of crossings over the edges (v[e], v[e + 1]),
//   e in [0, nverts[p] - 1), of p's closed ring:
//     straddle = (y1 > y) != (y2 > y)
//     xint     = x1 + ((y - y1) * (x2 - x1)) / (y2 - y1)
//     crossing = straddle && x < xint
// exactly as _membership (:62-73) computes them in f32. Each operation of
// xint runs alone, rounded to nearest (__fsub_rn, __fmul_rn, __fdiv_rn,
// __fadd_rn, in the reference's order), so nvcc cannot contract a product
// and a sum into an FMA; the file is never built with --use_fast_math.
// Padding vertices repeat the last real one, so their zero-length edges
// never straddle: looping over the real count nverts[p] gives the
// reference's count over every padded edge. No closing edge is added that
// the ring lacks. With pair_poly == NULL every block is a candidate of
// every polygon: points_in_polygons_count. Pairs may come in any order; a
// pair listed twice counts twice; a pair out of range counts nothing.
//
// Bound on an H100: operations. Any implementation must take each row
// inside a bbox's parity, and compute the xint and compare of each (row,
// edge) whose edge straddles the row's line; the rest of the work can be
// skipped by extents and bands, as this kernel does. chip_smoke.py's
// join_floor counts those from the run's data at the instructions they
// issue, over the 33.5 T instructions/s issue rate, against every distinct
// block's 8 B a row read once.
//
// Design: a CTA per work item, each block's rows read once per item.
// - Work items. An item is a run of at most RUN consecutive pairs (or, with
//   pair_poly == NULL, one block and RUN consecutive polygons) and one tile
//   of at most TILE rows of the block. The caller orders pairs by block
//   (parallel/query.py join_pairs), so an item's pairs share one block: its
//   CTA stages the tile's x and y in shared memory (64 KB at 8192 rows)
//   once and tests every pair of the run against it, restaging only where
//   the block changes (any order stays correct: a run of one pair per
//   block is an item too). Splitting a block's pairs into runs spreads the
//   hot city blocks over several CTAs. One CTA per item, rather than
//   persistent CTAs on an atomic counter: the hardware hands blocks out in
//   order as the counter would, and no counter needs zeroing per launch.
// - The whole CTA on one pair at a time, 512 threads, two CTAs an SM. A
//   pair's rows inside the bbox range from none to the whole tile, so a
//   warp per pair left most warps idle behind the heaviest pair of a run;
//   and at 256 threads the row loop's latency was exposed (PERF.md).
// - Staging in y order. The tile's rows below true_n with a y (NaN rows
//   never count) are staged bucketed by y: BUCKETS buckets over their y
//   range, a count, a scan and a scatter, the tile read three times through
//   L2; the rest of the tile is NaN padding, which no bbox test passes.
//   Any order counts the same; this one puts rows of nearly one y next to
//   each other, so that the threads of a warp walk the same y-band's edges
//   below. Each 128-row group's exact x/y extent (NaN left out) follows.
// - In-bbox rows compacted. Per polygon, a warp skips each of its groups
//   whose extent misses the bbox (exact: a row inside the bbox lies inside
//   its group's extent; y order makes most groups miss), tests the rows of
//   the others, and appends the rows inside the bbox to one shared list
//   (four ballots, one shared atomic a group). The threads then take the
//   list's rows, so no thread tests an edge for a row outside the bbox.
// - Edges bucketed by y-band. Per polygon, NB bands over the bbox's height,
//   j(y) = clamp(trunc(__fmul_rn(__fsub_rn(y, ymin), inv)), 0, NB - 1) with
//   inv = __fdiv_rn(NB, ymax - ymin); each edge with lo = min(y1, y2) < hi =
//   max(y1, y2) is listed in bands j(lo)..j(hi); a row tests only the edges
//   of band j(y). Exact: an edge straddles row y iff lo <= y < hi, and j is
//   monotone (each step rounds to nearest with a positive scale, and the
//   clamp keeps order), so j(lo) <= j(y) <= j(hi). A horizontal edge, or
//   one with a NaN y, straddles no row (a NaN y1 or y2 makes xint NaN, and
//   x < NaN is false) and is listed nowhere. Parity is an XOR, so the
//   order of a band's list does not matter. A zero-height, NaN or infinite
//   height (or an infinite inv) takes one band. NB is half the largest
//   power of two at most nverts, at most MAX_BANDS, halved until NB x
//   (nverts - 1) fits BAND_CAP: a band lists each edge at most once, so
//   its list has room for nverts - 1 entries, and NB lists of 2-byte edge
//   ids stay within 32 KB at MAX_VERTS (32 bands of 511 edges). The lists
//   are built in shared memory from the staged ring, with one shared atomic
//   per (edge, band), by no launch and no scratch memory of their own.
// - A thread per compacted row walks its band's list and computes every
//   listed edge's xint, keeping it only where the edge straddles the row:
//   a listed edge has y1 != y2, so the division is defined, and without a
//   branch the divisions of consecutive edges overlap.
// - The ring is staged once per polygon; the next pair's ring is
//   prefetched with cp.async while the current one's rows are tested (the
//   edges are read then from their own (x1, y1, x2, y2) table, not from
//   the ring).
// - Counts: summed in the warp, then per pair slot of the item in shared
//   memory, then one atomicAdd per (item, pair) with a non-zero count.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 128;         // rows under one extent: 4 a lane  (POLYGON_GROUP_ROWS)
constexpr int PASS = 1024;         // a tile is whole passes of a CTA  (POLYGON_PASS_ROWS)
constexpr int TILE = 8192;         // rows of a block staged at once   (POLYGON_TILE_ROWS)
constexpr int RUN = 32;            // pairs of a work item at most     (POLYGON_RUN)
constexpr int MAX_VERTS = 512;     //                                  (POLYGON_MAX_VERTS)
constexpr int MAX_BANDS = 64;      //                                  (POLYGON_MAX_BANDS)
constexpr int BAND_CAP = 16384;    // band-list entries of a ring      (POLYGON_BAND_CAP)
constexpr int BUCKETS = 256;       // y-buckets a tile's rows are staged in order of
static_assert(PASS % GROUP == 0 && TILE % PASS == 0, "a tile is whole groups");
static_assert(RUN <= THREADS, "one thread flushes each pair slot");
static_assert(BUCKETS % 32 == 0 && (BUCKETS + 2 * WARPS + 1) * 4 <= PASS * 2,
              "the staging counters fit the row list");

// ops/kernels.py polygon_band_count
__host__ __device__ constexpr int band_count(int nv) {
  int pow2 = 1;
  while (pow2 * 2 <= nv) pow2 *= 2;
  int nb = pow2 / 2;
  if (nb > MAX_BANDS) nb = MAX_BANDS;
  if (nb < 1) nb = 1;
  while (nb > 1 && nb * (nv - 1) > BAND_CAP) nb /= 2;
  return nb;
}

// ops/kernels.py band_index: fmaxf takes 0 for a NaN step
__device__ __forceinline__ int band_of(float y, float ymin, float inv, int nb) {
  if (nb == 1) return 0;
  const float v = __fmul_rn(__fsub_rn(y, ymin), inv);
  return (int)fminf(fmaxf(v, 0.0f), (float)(nb - 1));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL_WARP, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_WARP, v, o));
  return v;
}

__host__ __device__ constexpr size_t smem_bytes(int tile, int v, int band_cap) {
  return (size_t)tile * 8                      // x, y
         + (size_t)(tile / GROUP) * 16         // group extents
         + (size_t)v * 16 + (size_t)v * 8      // edge table, ring
         + (size_t)(2 * MAX_BANDS + 2 + RUN) * 4  // band and list counters, pair slots
         + (size_t)tile * 2                    // compacted rows
         + (size_t)band_cap * 2;               // band lists
}

__global__ void __launch_bounds__(THREADS, 2)
polygon_join_kernel(const float* __restrict__ x, const float* __restrict__ y, int64_t true_n,
                    const int32_t* __restrict__ pair_poly,  // (P,) or NULL: every block
                    const int32_t* __restrict__ pair_blk,   // (P,)
                    int64_t n_pairs, int64_t n_blocks,
                    const float2* __restrict__ verts,       // (K, V)
                    int v,
                    const int32_t* __restrict__ nverts,     // (K,)
                    const float4* __restrict__ bbox,        // (K,): xmin, ymin, xmax, ymax
                    int k, int block, int tile, int n_tiles,
                    int32_t* __restrict__ counts) {         // (K,)
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + tile;
  float4* gext = reinterpret_cast<float4*>(sy + tile);     // xmin, xmax, ymin, ymax
  float4* edges = gext + tile / GROUP;                      // x1, y1, x2, y2
  float2* ring = reinterpret_cast<float2*>(edges + v);
  int* band_n = reinterpret_cast<int*>(ring + v);           // two sets, by pair parity
  int* list_n = band_n + 2 * MAX_BANDS;                     // two, by pair parity
  int* slot_cnt = list_n + 2;                               // RUN
  uint16_t* rows = reinterpret_cast<uint16_t*>(slot_cnt + RUN);
  uint16_t* bands = rows + tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool dense = pair_poly == nullptr;
  int64_t item = blockIdx.x;
  const int t = (int)(item % n_tiles);
  item /= n_tiles;
  int64_t first, last, dense_b = 0;
  if (dense) {
    const int64_t chunks = (k + RUN - 1) / RUN;
    dense_b = item / chunks;
    first = item % chunks * RUN;
    last = min((int64_t)k, first + RUN);
  } else {
    first = item * RUN;
    last = min(n_pairs, first + RUN);
  }
  const int rows_t = min(tile, block - t * tile);  // a multiple of PASS
  const int groups = rows_t / GROUP;               // a multiple of WARPS
  // pair i's polygon and block; false where it is out of range (CTA-uniform)
  auto pair_of = [&](int64_t i, int& p, int64_t& b) -> bool {
    if (dense) {
      p = (int)i;
      b = dense_b;
      return true;
    }
    const int32_t pp = pair_poly[i], pb = pair_blk[i];
    p = pp;
    b = pb;
    return pp >= 0 && pp < k && pb >= 0 && pb < n_blocks;
  };
  auto fetch_ring = [&](int p) {
    const int nv = min(max(nverts[p], 0), v);
    for (int j = tid; j < nv; j += THREADS) cp_async8(ring + j, verts + (int64_t)p * v + j);
  };

  if (tid < RUN) slot_cnt[tid] = 0;
  if (tid < 2 * MAX_BANDS) band_n[tid] = 0;
  if (tid < 2) list_n[tid] = 0;
  int64_t i = first, b = -1, staged = -1;
  int p = 0;
  while (i < last && !pair_of(i, p, b)) ++i;
  if (i < last) fetch_ring(p);
  cp_async_wait_all();
  __syncthreads();

  for (int it = 0; i < last; ++it) {
    const int nv = min(max(nverts[p], 0), v);
    const int n_edges = nv - 1;
    const float4 bb = bbox[p];
    int nb = band_count(nv);
    float inv = 0.0f;
    if (nb > 1) {
      const float h = __fsub_rn(bb.w, bb.y);
      inv = __fdiv_rn((float)nb, h);
      if (!(h > 0.0f) || !isfinite(h) || !isfinite(inv)) {
        nb = 1;
        inv = 0.0f;
      }
    }
    int* bn = band_n + (it & 1) * MAX_BANDS;
    int* ln = list_n + (it & 1);

    // -- stage the block's tile where it changed, its rows bucketed by y ---------
    if (b != staged) {
      const int64_t row0 = b * block + (int64_t)t * tile;
      const float4* gx = reinterpret_cast<const float4*>(x + row0);
      const float4* gy = reinterpret_cast<const float4*>(y + row0);
      const int live = (int)max((int64_t)0, min((int64_t)rows_t, true_n - row0));
      int* hist = reinterpret_cast<int*>(rows);  // the row list is free until compaction
      float* part = reinterpret_cast<float*>(hist + BUCKETS);
      int* stored = hist + BUCKETS + 2 * WARPS;
      // the live rows' y range (fminf and fmaxf pass over a NaN)
      float lo = __int_as_float(0x7f800000), hi = __int_as_float(0xff800000);  // +inf, -inf
      for (int i = tid; i < rows_t / 4; i += THREADS) {
        const float4 yv = __ldg(gy + i);
        const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * i + r < live) {
            lo = fminf(lo, ys[r]);
            hi = fmaxf(hi, ys[r]);
          }
        }
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      if (lane == 0) {
        part[warp] = lo;
        part[WARPS + warp] = hi;
      }
      for (int j = tid; j < BUCKETS; j += THREADS) hist[j] = 0;
      __syncthreads();
#pragma unroll
      for (int u = 0; u < WARPS; ++u) {
        lo = fminf(lo, part[u]);
        hi = fmaxf(hi, part[WARPS + u]);
      }
      float scale = (float)BUCKETS / (hi - lo);  // the order only: any rounding will do
      if (!(hi > lo) || !isfinite(scale)) scale = 0.0f;
      auto bucket = [&](float v) {
        return (int)fminf(fmaxf((v - lo) * scale, 0.0f), (float)(BUCKETS - 1));
      };
      for (int i = tid; i < rows_t / 4; i += THREADS) {
        const float4 yv = __ldg(gy + i);
        const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (4 * i + r < live && !isnan(ys[r])) atomicAdd(hist + bucket(ys[r]), 1);
      }
      __syncthreads();
      if (warp == 0) {  // exclusive scan: lane l holds buckets 8l .. 8l + 7
        constexpr int PER = BUCKETS / 32;
        int c[PER], sum = 0;
#pragma unroll
        for (int u = 0; u < PER; ++u) sum += c[u] = hist[lane * PER + u];
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(FULL_WARP, incl, o);
          if (lane >= o) incl += v;
        }
        int at = incl - sum;
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          hist[lane * PER + u] = at;
          at += c[u];
        }
        if (lane == 31) *stored = incl;
      }
      __syncthreads();
      for (int i = tid; i < rows_t / 4; i += THREADS) {
        const float4 xv = __ldg(gx + i), yv = __ldg(gy + i);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
        const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * i + r < live && !isnan(ys[r])) {
            const int at = atomicAdd(hist + bucket(ys[r]), 1);
            sx[at] = xs[r];
            sy[at] = ys[r];
          }
        }
      }
      const float nan = __int_as_float(0x7fffffff);  // never inside a bbox
      for (int at = *stored + tid; at < rows_t; at += THREADS) sx[at] = sy[at] = nan;
      __syncthreads();
      for (int g = warp; g < groups; g += WARPS) {
        const float4 a = reinterpret_cast<const float4*>(sx)[g * 32 + lane];
        const float4 c = reinterpret_cast<const float4*>(sy)[g * 32 + lane];
        const float lox = warp_min(fminf(fminf(a.x, a.y), fminf(a.z, a.w)));
        const float hix = warp_max(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)));
        const float loy = warp_min(fminf(fminf(c.x, c.y), fminf(c.z, c.w)));
        const float hiy = warp_max(fmaxf(fmaxf(c.x, c.y), fmaxf(c.z, c.w)));
        if (lane == 0) gext[g] = make_float4(lox, hix, loy, hiy);
      }
      __syncwarp();
      staged = b;
    }
    const int valid = rows_t;  // rows past true_n and NaN rows were left out: NaN padding

    // -- the ring's edges and their y-band lists ---------------------------------
    for (int e = tid; e < n_edges; e += THREADS) {
      const float2 a = ring[e], c = ring[e + 1];
      edges[e] = make_float4(a.x, a.y, c.x, c.y);
      const float lo = fminf(a.y, c.y), hi = fmaxf(a.y, c.y);  // a NaN y: lo == hi
      if (!(lo < hi)) continue;  // horizontal or NaN: straddles no row
      const int j1 = band_of(hi, bb.y, inv, nb);
      for (int j = band_of(lo, bb.y, inv, nb); j <= j1; ++j)
        bands[j * n_edges + atomicAdd(bn + j, 1)] = (uint16_t)e;
    }

    // -- the rows inside the bbox, compacted: a warp its own groups -------------
    for (int g = warp; g < groups; g += WARPS) {
      const float4 ex = gext[g];
      if (!(ex.y >= bb.x && ex.x <= bb.z && ex.w >= bb.y && ex.z <= bb.w)) continue;
      const int r0 = g * GROUP + lane * 4;
      const float4 xv = reinterpret_cast<const float4*>(sx)[g * 32 + lane];
      const float4 yv = reinterpret_cast<const float4*>(sy)[g * 32 + lane];
      const float px[4] = {xv.x, xv.y, xv.z, xv.w};
      const float py[4] = {yv.x, yv.y, yv.z, yv.w};
      unsigned m[4];
      int total = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        m[r] = __ballot_sync(FULL_WARP, r0 + r < valid && px[r] >= bb.x && px[r] <= bb.z &&
                                            py[r] >= bb.y && py[r] <= bb.w);
        total += __popc(m[r]);
      }
      if (total == 0) continue;  // warp-uniform
      int base = 0;
      if (lane == 0) base = atomicAdd(ln, total);
      base = __shfl_sync(FULL_WARP, base, 0);
      const unsigned below = (1u << lane) - 1;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (m[r] >> lane & 1) rows[base + __popc(m[r] & below)] = (uint16_t)(r0 + r);
        base += __popc(m[r]);
      }
    }
    __syncthreads();  // the edges, bands, rows and the tile are in place

    // -- next pair's ring in flight; this pair's rows against their band ---------
    int64_t nx = i + 1, nb_blk = b;
    int np = p;
    while (nx < last && !pair_of(nx, np, nb_blk)) ++nx;
    if (nx < last) fetch_ring(np);
    if (tid < MAX_BANDS) band_n[((it + 1) & 1) * MAX_BANDS + tid] = 0;
    if (tid == 0) list_n[(it + 1) & 1] = 0;
    const int n_in = *ln;
    int cnt = 0;
    for (int q = tid; q < n_in; q += THREADS) {
      const int r = rows[q];
      const float px = sx[r], py = sy[r];
      const int j = band_of(py, bb.y, inv, nb);
      const uint16_t* list = bands + j * n_edges;
      const int len = bn[j];
      bool odd = false;
      for (int c = 0; c < len; ++c) {
        const float4 ed = edges[list[c]];
        const float xint = __fadd_rn(
            ed.x, __fdiv_rn(__fmul_rn(__fsub_rn(py, ed.y), __fsub_rn(ed.z, ed.x)),
                            __fsub_rn(ed.w, ed.y)));
        odd ^= ((ed.y > py) != (ed.w > py)) && px < xint;
      }
      cnt += odd;
    }
    cnt = __reduce_add_sync(FULL_WARP, cnt);
    if (lane == 0 && cnt) atomicAdd(slot_cnt + (int)(i - first), cnt);
    cp_async_wait_all();
    __syncthreads();  // the rows are counted and the next ring has landed
    i = nx;
    p = np;
    b = nb_blk;
  }

  if (tid < last - first) {
    const int c = slot_cnt[tid];
    if (c) atomicAdd(counts + (dense ? first + tid : pair_poly[first + tid]), c);
  }
}

}  // namespace

// counts (K,) must be zeroed by the caller. n is a multiple of block, block
// a multiple of PASS, 1 <= v <= MAX_VERTS; x and y start on 16-byte
// boundaries and verts on an 8-byte one. With pair_poly == NULL, n_pairs is
// not read (every block of every polygon).
extern "C" int geomesa_polygon_join(const void* x, const void* y, long long n,
                                    long long true_n, const void* pair_poly,
                                    const void* pair_blk, long long n_pairs, const void* verts,
                                    int v, const void* nverts, const void* bbox, int k,
                                    int block, void* counts, void* stream) {
  if (k <= 0 || n <= 0 || (pair_poly != nullptr && n_pairs <= 0)) return (int)cudaSuccess;
  if (block <= 0 || block % PASS || n % block || v < 1 || v > MAX_VERTS)
    return (int)cudaErrorInvalidValue;
  const int tile = block < TILE ? block : TILE;
  const int n_tiles = (block + tile - 1) / tile;
  const long long n_blocks = n / block;
  const long long items =
      (pair_poly != nullptr ? (n_pairs + RUN - 1) / RUN : n_blocks * ((k + RUN - 1) / RUN)) *
      n_tiles;
  if (items > INT_MAX) return (int)cudaErrorInvalidValue;
  int band_cap = 1;
  for (int nv = 2; nv <= v; ++nv) {
    const int need = band_count(nv) * (nv - 1);
    if (need > band_cap) band_cap = need;
  }
  const size_t smem = smem_bytes(tile, v, band_cap);
  cudaError_t err = cudaFuncSetAttribute(
      polygon_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  polygon_join_kernel<<<(unsigned)items, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, true_n, (const int32_t*)pair_poly,
      (const int32_t*)pair_blk, n_pairs, n_blocks, (const float2*)verts, v,
      (const int32_t*)nverts, (const float4*)bbox, k, block, tile, n_tiles, (int32_t*)counts);
  return (int)cudaGetLastError();
}
