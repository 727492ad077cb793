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
// Skipping the division on an edge that does not straddle is exact (its
// crossing is false, and dy == 0 never straddles), and so is skipping the
// edge loop for a warp whose rows all lie outside the bbox. Padding
// vertices repeat the last real one, so their zero-length edges never
// straddle: looping over the real count nverts[p] gives the reference's
// count over every padded edge. No closing edge is added that the ring
// lacks. With pair_poly == NULL every block is a candidate of every polygon
// (pair i = (i / n_blocks, i % n_blocks)): points_in_polygons_count.
//
// Bound on an H100: operations. A tested row costs 8 B (x and y) and its
// bbox test; a row inside the bbox costs the compare and straddle test of
// every edge of its polygon, and a division on the few edges that straddle
// it. chip_smoke.py's join_floor counts the run's rows inside each
// polygon's bbox times its edges at the instructions the edge loop issues
// per (row, edge), over the 33.5 T instructions/s issue rate, against the
// distinct blocks' bytes read once.
//
// Design. Pairs run grid-stride, one 256-thread CTA at a time each. The
// caller orders them by block (parallel/query.py join_pairs), so CTAs in
// flight together test the same blocks and most row reads hit L2. A CTA
// stages its polygon's ring in shared memory (at most MAX_VERTS vertices,
// 4 KB as float2), then walks the block in passes of PASS rows: each thread
// loads 4 consecutive rows of x and of y as 16-byte vectors, tests them
// against the bbox, and a warp with no row inside skips the edge loop (one
// vote). The edge loop reads each vertex once per warp (a broadcast from
// shared memory) and keeps, as bit masks over a thread's rows, each row's
// side of the previous vertex and its crossing parity; an edge that
// straddles no row of the warp (one vote) costs each row one compare and
// its bit, and only a straddling edge runs the division. The counts are
// reduced in the warp, then the CTA, and added with one atomicAdd per pair.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;                // consecutive rows a thread tests per pass (a float4)
constexpr int PASS = THREADS * ROWS;   // ops/kernels.py POLYGON_PASS_ROWS
constexpr int MAX_VERTS = 512;         // ops/kernels.py POLYGON_MAX_VERTS
constexpr int CTAS_PER_SM = 8;

__global__ void __launch_bounds__(THREADS)
polygon_join_kernel(const float* __restrict__ x, const float* __restrict__ y, int64_t n,
                    int64_t true_n,
                    const int32_t* __restrict__ pair_poly,  // (P,) or NULL: every block
                    const int32_t* __restrict__ pair_blk,   // (P,)
                    int64_t n_pairs,
                    const float2* __restrict__ verts,       // (K, V)
                    int v,
                    const int32_t* __restrict__ nverts,     // (K,)
                    const float4* __restrict__ bbox,        // (K,): xmin, ymin, xmax, ymax
                    int k, int block,
                    int32_t* __restrict__ counts) {         // (K,)
  __shared__ float2 ring[MAX_VERTS];
  __shared__ int warp_cnt[WARPS];
  const int64_t n_blocks = n / block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t i = blockIdx.x; i < n_pairs; i += gridDim.x) {
    int64_t p, b;
    if (pair_poly != nullptr) {
      p = pair_poly[i];
      b = pair_blk[i];
    } else {
      p = i / n_blocks;
      b = i - p * n_blocks;
    }
    if (p < 0 || p >= k || b < 0 || b >= n_blocks) continue;  // CTA-uniform
    const int nv = min(max(nverts[p], 0), v);
    const float4 bb = bbox[p];
    __syncthreads();  // the previous pair's ring and warp counts are read
    for (int j = threadIdx.x; j < nv; j += THREADS) ring[j] = verts[p * v + j];
    __syncthreads();
    int cnt = 0;
    for (int r0 = 0; r0 < block; r0 += PASS) {
      const int64_t row = b * block + r0 + threadIdx.x * ROWS;
      const float4 xs = __ldg(reinterpret_cast<const float4*>(x + row));
      const float4 ys = __ldg(reinterpret_cast<const float4*>(y + row));
      const float px[ROWS] = {xs.x, xs.y, xs.z, xs.w};
      const float py[ROWS] = {ys.x, ys.y, ys.z, ys.w};
      unsigned live = 0;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool in = row + r < true_n && px[r] >= bb.x && px[r] <= bb.z && py[r] >= bb.y &&
                        py[r] <= bb.w;
        live |= (unsigned)in << r;
      }
      if (!__any_sync(FULL_WARP, live)) continue;  // warp-uniform
      // bit r of above: the previous vertex lies above row r's horizontal line
      unsigned odd = 0, above = 0;
      float2 a = ring[0];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) above |= (unsigned)(a.y > py[r]) << r;
      for (int e = 1; e < nv; ++e) {
        const float2 c = ring[e];
        unsigned ab = 0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) ab |= (unsigned)(c.y > py[r]) << r;
        const unsigned straddle = ab ^ above;  // the edge (a, c) straddles row r's line
        if (__any_sync(FULL_WARP, straddle)) {  // warp-uniform: most edges straddle no row
          const float dx = __fsub_rn(c.x, a.x), dy = __fsub_rn(c.y, a.y);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (straddle >> r & 1) {
              const float xint =
                  __fadd_rn(a.x, __fdiv_rn(__fmul_rn(__fsub_rn(py[r], a.y), dx), dy));
              odd ^= (unsigned)(px[r] < xint) << r;
            }
          }
        }
        above = ab;
        a = c;
      }
      cnt += __popc(odd & live);
    }
    cnt = __reduce_add_sync(FULL_WARP, cnt);
    if (lane == 0) warp_cnt[warp] = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) total += warp_cnt[w];
      if (total) atomicAdd(counts + p, total);
    }
  }
}

}  // namespace

// counts (K,) must be zeroed by the caller. n is a multiple of block, block a
// multiple of PASS, 1 <= v <= MAX_VERTS; x and y start on 16-byte
// boundaries. With pair_poly == NULL, n_pairs must be K * (n / block).
extern "C" int geomesa_polygon_join(const void* x, const void* y, long long n,
                                    long long true_n, const void* pair_poly,
                                    const void* pair_blk, long long n_pairs, const void* verts,
                                    int v, const void* nverts, const void* bbox, int k,
                                    int block, int sms, void* counts, void* stream) {
  if (n_pairs <= 0 || k <= 0 || n <= 0) return (int)cudaSuccess;
  if (block <= 0 || block % PASS || n % block || v < 1 || v > MAX_VERTS || sms < 1)
    return (int)cudaErrorInvalidValue;
  const long long grid = n_pairs < (long long)sms * CTAS_PER_SM ? n_pairs
                                                                 : (long long)sms * CTAS_PER_SM;
  polygon_join_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, n, true_n, (const int32_t*)pair_poly,
      (const int32_t*)pair_blk, n_pairs, (const float2*)verts, v, (const int32_t*)nverts,
      (const float4*)bbox, k, block, (int32_t*)counts);
  return (int)cudaGetLastError();
}
