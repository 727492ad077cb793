// corridor_masks: the corridor engine's fused band masks, N rows x Q
// corridors x S segments in one pass.
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:1371
// (make_corridor_step, a lax.map over corridors of the clamped
// point-to-segment distance, the (bin, offset) time window and the heading
// test). It is not a TPU kernel: the reference computes it in XLA.
//
// What it computes, per (corridor q, row r): cand[q, r] is true when some
// segment k of q has d2 <= buf2_hi[q], the row's (bin, offset) inside the
// segment's time quad and, with HEADING, the row's heading within tol_hi[q]
// of the segment's bearing (or tol_hi[q] >= 360, "no heading constraint");
// sure[q, r] the same with buf2_lo[q] and tol_lo[q]. d2 is the f32 squared
// distance to the segment:
//   dx = x2 - x1, dy = y2 - y1, len2 = dx * dx + dy * dy,
//   tp = len2 > 0 ? ((cx - x1) * dx + (cy - y1) * dy) / len2 : 0,
//   tp = clamp(tp, 0, 1) (NaN stays NaN, as torch.clamp and jnp.clip keep it),
//   d2 = (cx - (x1 + tp * dx))^2 + (cy - (y1 + tp * dy))^2;
// the heading difference is |remainder(h - b + 180, 360) - 180|, with
// BIDIR its minimum with 180 minus itself. Every f32 operation is written
// with a round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn), which nvcc never contracts into an FMA, in the order of the
// plain version (ops/kernels.py corridor_masks_plain), so the masks equal
// it bit for bit; the remainder is torch.remainder's own formula, fmodf
// (exact) then + 360 where the result is non-zero and negative. A NaN or
// infinite heading fails both bands unless the tolerance is the >= 360
// sentinel. The time test is count_predicate.cuh's: the row's biased
// 64-bit key (bin << 32 | (uint32)(off ^ 0x80000000)) between the quad's
// two endpoint keys, so time semantics cannot drift from the scan kernels;
// the unsatisfiable quad [1, 0, 0, -1] that pads short corridors' segments
// passes no row, and the unconstrained [0, -1, 2^31 - 1, 2^31 - 1] every
// row of a date-less store (bins = offs = 0). A negative buf2 (a padded
// corridor) passes no row.
//
// Bound on an H100: the larger of the bytes (each row's x, y, bins and
// offs read once, 16 B, the heading's 4 B more in the HEADING variants, the
// only ones that read it, and 2 B of masks per (corridor, row) written) and the f32 operations of Q x S x N (row, segment) tests at 67
// TFLOP/s (chip_smoke.py reckons both from the run's shapes).
//
// Design: one thread per row, 256 a CTA. Each CTA stages a tile of
// corridors in shared memory (per segment x1, y1, dx, dy, len2 as the
// plain version computes them, the quad's two keys and the bearing; per
// corridor its four band thresholds), and each thread walks the tile's
// corridors and segments with its row in registers and writes one byte of
// cand and one of sure per corridor (neighbouring threads on neighbouring
// rows). At the bench's shapes (16 corridors x 2 segments) the tile is the
// whole batch, under 2 KB. A corridor of more segments than one tile holds
// is walked in segment tiles, its flags kept in registers across them.
//
// Plain C entry point for ctypes; launches on the caller's stream, does not
// synchronise, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace {

using geomesa::time_key;

constexpr int THREADS = 256;
constexpr int SMEM_BYTES = 40960;  // a tile's staged corridors (static shared memory)
constexpr int SEG_BYTES = 16 + 4 + 16 + 4;  // (x1, y1, dx, dy), len2, (lo, hi keys), bearing
constexpr int CORRIDOR_BYTES = 16;  // (buf2_lo, buf2_hi, tol_lo, tol_hi)

struct Staged {
  float4* seg;      // (qt, st): x1, y1, dx, dy
  float* len2;      // (qt, st)
  longlong2* win;   // (qt, st): the quad's endpoint keys
  float* brg;       // (qt, st)
  float4* band;     // (qt): buf2_lo, buf2_hi, tol_lo, tol_hi
};

__device__ __forceinline__ Staged carve(unsigned char* smem, int qt, int st) {
  Staged s;
  s.seg = reinterpret_cast<float4*>(smem);
  s.win = reinterpret_cast<longlong2*>(s.seg + qt * st);
  s.band = reinterpret_cast<float4*>(s.win + qt * st);
  s.len2 = reinterpret_cast<float*>(s.band + qt);
  s.brg = s.len2 + qt * st;
  return s;
}

// torch.clamp(v, 0, 1): NaN passes through.
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.f), 1.f);
}

template <bool HEADING, bool BIDIR>
__global__ void __launch_bounds__(THREADS)
corridor_masks_kernel(const float* __restrict__ cx, const float* __restrict__ cy,
                      const int32_t* __restrict__ bins, const int32_t* __restrict__ offs,
                      const float* __restrict__ hdg, int64_t n,
                      const float* __restrict__ segs,     // (Q, S, 4): x1, y1, x2, y2
                      const int32_t* __restrict__ tq,     // (Q, S, 4): blo, olo, bhi, ohi
                      const float* __restrict__ brg,      // (Q, S)
                      const float* __restrict__ buf2_lo, const float* __restrict__ buf2_hi,
                      const float* __restrict__ tol_lo, const float* __restrict__ tol_hi,
                      int q, int s, int qt, int st,
                      uint8_t* __restrict__ cand, uint8_t* __restrict__ sure) {  // (Q, N)
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  const Staged sg = carve(smem, qt, st);
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool live = row < n;
  float px = 0.f, py = 0.f, h = 0.f;
  long long key = 0;
  if (live) {
    px = cx[row];
    py = cy[row];
    key = time_key(bins[row], offs[row]);
    if (HEADING) h = hdg[row];
  }
  for (int q0 = 0; q0 < q; q0 += qt) {
    const int nq = min(qt, q - q0);
    bool acc_c = false, acc_s = false;  // a one-corridor tile's flags across segment tiles
    for (int s0 = 0; s0 < s; s0 += st) {
      const int ns = min(st, s - s0);
      __syncthreads();  // the previous tile is read
      for (int i = threadIdx.x; i < nq * ns; i += THREADS) {
        const int qi = i / ns, k = i % ns;
        const int64_t g = (int64_t)(q0 + qi) * s + s0 + k;
        const float4 v = reinterpret_cast<const float4*>(segs)[g];
        const float dx = __fsub_rn(v.z, v.x), dy = __fsub_rn(v.w, v.y);
        sg.seg[qi * st + k] = make_float4(v.x, v.y, dx, dy);
        sg.len2[qi * st + k] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const int4 w = reinterpret_cast<const int4*>(tq)[g];
        sg.win[qi * st + k] = make_longlong2(time_key(w.x, w.y), time_key(w.z, w.w));
        sg.brg[qi * st + k] = brg[g];
      }
      for (int qi = threadIdx.x; qi < nq; qi += THREADS)
        sg.band[qi] = make_float4(buf2_lo[q0 + qi], buf2_hi[q0 + qi], tol_lo[q0 + qi],
                                  tol_hi[q0 + qi]);
      __syncthreads();
      if (!live) continue;
      for (int qi = 0; qi < nq; ++qi) {
        const float4 band = sg.band[qi];
        bool c = false, su = false;
        for (int k = 0; k < ns; ++k) {
          const longlong2 w = sg.win[qi * st + k];
          if (key < w.x || key > w.y) continue;
          const float4 v = sg.seg[qi * st + k];
          const float len2 = sg.len2[qi * st + k];
          const float num = __fadd_rn(__fmul_rn(__fsub_rn(px, v.x), v.z),
                                      __fmul_rn(__fsub_rn(py, v.y), v.w));
          const float tp = clamp01(len2 > 0.f ? __fdiv_rn(num, len2) : 0.f);
          const float ex = __fsub_rn(px, __fadd_rn(v.x, __fmul_rn(tp, v.z)));
          const float ey = __fsub_rn(py, __fadd_rn(v.y, __fmul_rn(tp, v.w)));
          const float d2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
          bool hc = true, hs = true;
          if (HEADING) {
            float r = fmodf(__fadd_rn(__fsub_rn(h, sg.brg[qi * st + k]), 180.f), 360.f);
            if (r != 0.f && r < 0.f) r = __fadd_rn(r, 360.f);  // the divisor 360 is positive
            float diff = fabsf(__fsub_rn(r, 180.f));
            if (BIDIR) diff = fminf(diff, __fsub_rn(180.f, diff));
            hc = diff <= band.w || band.w >= 360.f;
            hs = diff <= band.z || band.z >= 360.f;
          }
          c = c || (d2 <= band.y && hc);
          su = su || (d2 <= band.x && hs);
        }
        if (st < s) {  // qt == 1: the corridor's segments span several tiles
          acc_c = acc_c || c;
          acc_s = acc_s || su;
        } else {
          const int64_t o = (int64_t)(q0 + qi) * n + row;
          cand[o] = c;
          sure[o] = su;
        }
      }
    }
    if (st < s && live) {
      const int64_t o = (int64_t)q0 * n + row;
      cand[o] = acc_c;
      sure[o] = acc_s;
    }
  }
}

template <bool HEADING, bool BIDIR>
cudaError_t launch(const float* cx, const float* cy, const int32_t* bins, const int32_t* offs,
                   const float* hdg, long long n, const float* segs, const int32_t* tq,
                   const float* brg, const float* b2lo, const float* b2hi, const float* tlo,
                   const float* thi, int q, int s, uint8_t* cand, uint8_t* sure,
                   cudaStream_t stream) {
  const int per_corridor = s * SEG_BYTES + CORRIDOR_BYTES;
  int qt, st;
  if (per_corridor <= SMEM_BYTES) {
    st = s;
    qt = min(q, SMEM_BYTES / per_corridor);
  } else {
    qt = 1;
    st = (SMEM_BYTES - CORRIDOR_BYTES) / SEG_BYTES;
  }
  const long long blocks = (n + THREADS - 1) / THREADS;
  corridor_masks_kernel<HEADING, BIDIR><<<(unsigned)blocks, THREADS, 0, stream>>>(
      cx, cy, bins, offs, hdg, n, segs, tq, brg, b2lo, b2hi, tlo, thi, q, s, qt, st, cand, sure);
  return cudaGetLastError();
}

}  // namespace

// Rows cx, cy (f32), bins, offs (int32), hdg (f32, unread without heading);
// corridors segs (Q, S, 4) f32, tq (Q, S, 4) int32, brg (Q, S) f32 and the
// four (Q,) f32 bands; cand and sure (Q, N) bytes out, every one written.
extern "C" int geomesa_corridor_masks(const void* cx, const void* cy, const void* bins,
                                      const void* offs, const void* hdg, long long n,
                                      const void* segs, const void* tq, const void* brg,
                                      const void* buf2_lo, const void* buf2_hi,
                                      const void* tol_lo, const void* tol_hi, int q, int s,
                                      int heading, int bidirectional, void* cand, void* sure,
                                      void* stream) {
  if (n <= 0 || q <= 0) return (int)cudaSuccess;
  if (s <= 0 || (n + THREADS - 1) / THREADS > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto args = [&](auto fn) {
    return (int)fn((const float*)cx, (const float*)cy, (const int32_t*)bins,
                   (const int32_t*)offs, (const float*)hdg, n, (const float*)segs,
                   (const int32_t*)tq, (const float*)brg, (const float*)buf2_lo,
                   (const float*)buf2_hi, (const float*)tol_lo, (const float*)tol_hi, q, s,
                   (uint8_t*)cand, (uint8_t*)sure, (cudaStream_t)stream);
  };
  if (heading)
    return bidirectional ? args(launch<true, true>) : args(launch<true, false>);
  return bidirectional ? args(launch<false, true>) : args(launch<false, false>);
}
