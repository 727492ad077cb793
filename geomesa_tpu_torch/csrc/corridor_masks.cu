// corridor_masks: the corridor engine's fused band masks, N rows x Q
// corridors x S segments in one pass, packed one bit a (corridor, row).
//
// Replaces the XLA step geomesa_tpu/parallel/query.py:1371
// (make_corridor_step, a lax.map over corridors of the clamped
// point-to-segment distance, the (bin, offset) time window and the heading
// test). It is not a TPU kernel: the reference computes it in XLA.
//
// Two entry forms, one kernel body:
// - the row form (geomesa_corridor_masks) reads f32 cx, cy, int32 bins,
//   offs and f32 heading a row: the rows of a candidate table (line and
//   polygon stores, the Oracle backend, a plan that scans no resident
//   point state);
// - the gather form (geomesa_corridor_masks_gather) reads a point state's
//   resident int32 x, y, bins and offs through a list of candidate
//   sorted-order positions, so the candidates never leave the card. x and
//   y become f32 degrees by one dequantization rule, the normalized cell's
//   centre: lo + (i + 0.5) * (span / 2^31) in f64 (exact: every term is a
//   multiple of 2^-30 under 2^38 of them), rounded once to f32
//   (ops/kernels.py corridor_dequantize, which the plain version and the
//   tests share). The heading, when read, is aligned with the candidates.
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
// Output: for each corridor, cand and sure as 32-bit words, bit j of word w
// the row 32 w + j, (Q, ceil(N / 32)) words each; the bits past N are 0.
//
// Bound on an H100: the larger of the bytes and the f32 operations. Bytes:
// the row form reads 16 B a row (x, y, bins, offs; 20 with the heading, in
// the HEADING variants only), the gather form 4 B of position and 16 B of
// columns a candidate (20 and 20 with the heading); both write 2 bits a
// (corridor, row). Operations, as this kernel runs them: every one of the
// Q x S x N (row, segment) pairs takes the time test (two 64-bit compares,
// four ALU instructions), a pair inside the segment's time quad the reach
// box's four compares, and only a pair inside the box too the distance
// test's 19 f32 operations (27 with the heading, 29 bidirectional); the
// ALU instructions at the ALU rate (64 lanes an SM a clock), all of them
// at the issue rate (chip_smoke.py corridor_pairs counts the pairs from
// the run's data, corridor_floor the bound). At 2M rows x 64 corridors
// the bytes fall from the byte masks' 288 MB to 64 MB, and the time
// tests of all pairs set the bound.
//
// Design: 256 threads a CTA, 4 rows a thread, 4 CTAs an SM (64 registers):
// lane l of a warp holds the rows 128 w + 32 r + l (r = 0..3) of its warp's
// 128, so every load of a column is 32 neighbouring rows and every staged
// segment read from shared memory serves 4 rows. Each CTA stages a tile of corridors in dynamic
// shared memory sized to the tile (per segment x1, y1, dx, dy, len2 as the
// plain version computes them, its reach box, the quad's two keys and the
// bearing; per corridor its four band thresholds; at most 40 KB). Per
// corridor a warp ballots each of its 4 row groups into one word per mask,
// and lanes 0-3 store the warp's 4 consecutive words: one 16-B store a
// mask, 1/16 of the byte masks' traffic. A corridor of more segments than
// one tile holds is walked in segment tiles, its flags kept in registers
// across them; more corridors than a tile holds are walked tile by tile.
// Warps wholly past N skip the tests but keep to the CTA's barriers.
//
// The distance test, whose correctly rounded division is the costly step,
// runs only for a row inside the segment's time quad and its reach box:
// the segment's bbox grown by reach = sqrt(buf2_hi) * 1.001 + 1e-3 + 1e-6 *
// m (m the largest |coordinate| of the segment), each step rounded to
// nearest (ops/kernels.py corridor_reach_boxes is its plain form). The skip
// is exact: a row outside the box in x (or y) has |ex| (or |ey|) above
// sqrt(buf2_hi) * 1.001, since the foot x1 + tp * dx with tp in [0, 1] lies
// in the bbox up to two roundings (each at most half an ulp of 3 m, under
// 1e-6 * m / 2) and the box's own edge and reach round within the 1e-3 pad;
// then d2 = fl(fl(ex^2) + fl(ey^2)) >= fl(ex^2) > buf2_hi >= buf2_lo, so
// both bands are false whatever the heading. A NaN row coordinate or a
// negative buf2_hi (a NaN reach) fails no compare of the box test, so the
// full test runs. In z3 order (the gather form over a point state) a warp's
// rows are neighbours in space and time, so whole warps skip a segment.
//
// Plain C entry points for ctypes; each launches on the caller's stream,
// does not synchronise, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_predicate.cuh"

namespace {

using geomesa::time_key;

// Rows a thread, and the CTAs an SM must hold (__launch_bounds__, which caps
// the registers): 4 rows and 4 CTAs (64 registers) were the fastest at
// config 10's four shapes of 1, 2, 4 and 8 rows a thread and 1 to 8 CTAs an
// SM (PERF.md keeps the timed variants).
constexpr int THREADS = 256;
constexpr int ROWS = 4;                        // rows a thread
constexpr int MIN_BLOCKS = 4;
static_assert(ROWS >= 1 && ROWS <= 32, "a warp stores its row groups' words from lanes 0..ROWS-1");
constexpr int WARP_ROWS = 32 * ROWS;           // a warp's rows: ROWS words a mask
constexpr int CTA_ROWS = THREADS * ROWS;       // a CTA's rows: a row block
constexpr int SMEM_BYTES = 40960;              // a tile's staged corridors at most
// (x1, y1, dx, dy), the reach box, (lo, hi keys), len2, bearing
constexpr int SEG_BYTES = 16 + 16 + 16 + 4 + 4;
constexpr int CORRIDOR_BYTES = 16;             // (buf2_lo, buf2_hi, tol_lo, tol_hi)
constexpr unsigned FULL = 0xffffffffu;
// the dequantization's cells: 360 / 2^31 and 180 / 2^31 degrees, exact in f64
constexpr double LON_CELL = 360.0 / 2147483648.0;
constexpr double LAT_CELL = 180.0 / 2147483648.0;
// the reach box: sqrt(buf2_hi) * REACH_SCALE + REACH_PAD + REACH_REL * m
constexpr float REACH_SCALE = 1.001f, REACH_PAD = 1e-3f, REACH_REL = 1e-6f;

struct Staged {
  float4* seg;      // (qt, st): x1, y1, dx, dy
  float4* reach;    // (qt, st): the reach box xlo, xhi, ylo, yhi
  float* len2;      // (qt, st)
  longlong2* win;   // (qt, st): the quad's endpoint keys
  float* brg;       // (qt, st)
  float4* band;     // (qt): buf2_lo, buf2_hi, tol_lo, tol_hi
};

__device__ __forceinline__ Staged carve(unsigned char* smem, int qt, int st) {
  Staged s;
  s.seg = reinterpret_cast<float4*>(smem);
  s.reach = s.seg + qt * st;
  s.win = reinterpret_cast<longlong2*>(s.reach + qt * st);
  s.band = reinterpret_cast<float4*>(s.win + qt * st);
  s.len2 = reinterpret_cast<float*>(s.band + qt);
  s.brg = s.len2 + qt * st;
  return s;
}

// The rows a launch reads: the row form's f32 coordinates, or the gather
// form's resident int32 columns and candidate positions.
struct Rows {
  const float* cx;
  const float* cy;
  const int32_t* x;
  const int32_t* y;
  const int32_t* bins;
  const int32_t* offs;
  const int32_t* pos;
  const float* hdg;
  int64_t n;  // rows (row form) or candidates (gather form)
};

struct Corridors {
  const float* segs;   // (Q, S, 4): x1, y1, x2, y2
  const int32_t* tq;   // (Q, S, 4): blo, olo, bhi, ohi
  const float* brg;    // (Q, S)
  const float* buf2_lo;
  const float* buf2_hi;
  const float* tol_lo;
  const float* tol_hi;
  int q, s;
};

// torch.clamp(v, 0, 1): NaN passes through.
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.f), 1.f);
}

// lo + (i + 0.5) * cell in f64, exact, then one round to f32.
__device__ __forceinline__ float dequantize(int32_t i, double lo, double cell) {
  return __double2float_rn(__dadd_rn(lo, __dmul_rn(__dadd_rn((double)i, 0.5), cell)));
}

// Ballot a warp's ROWS row groups into ROWS words of each mask; lanes
// 0..ROWS-1 store them (word0 + lane), as far as the corridor's words go.
__device__ __forceinline__ void store_words(const bool (&c)[ROWS], const bool (&su)[ROWS],
                                            int lane, int64_t word0, int64_t words,
                                            uint32_t* cand, uint32_t* sure) {
  uint32_t wc = 0, ws = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint32_t bc = __ballot_sync(FULL, c[r]), bs = __ballot_sync(FULL, su[r]);
    if (lane == r) {
      wc = bc;
      ws = bs;
    }
  }
  if (lane < ROWS && word0 + lane < words) {
    cand[word0 + lane] = wc;
    sure[word0 + lane] = ws;
  }
}

template <bool GATHER, bool HEADING, bool BIDIR>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
corridor_masks_kernel(Rows rw, Corridors cr, int qt, int st, uint32_t* __restrict__ cand,
                      uint32_t* __restrict__ sure) {  // (Q, words)
  extern __shared__ __align__(16) unsigned char smem[];
  const Staged sg = carve(smem, qt, st);
  const int lane = threadIdx.x & 31;
  const int64_t warp_row0 = (int64_t)blockIdx.x * CTA_ROWS + (threadIdx.x >> 5) * WARP_ROWS;
  const int64_t words = (rw.n + 31) / 32, word0 = warp_row0 / 32;
  const bool warp_live = warp_row0 < rw.n;  // uniform across the warp
  bool live[ROWS];
  float px[ROWS], py[ROWS], h[ROWS];
  long long key[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t row = warp_row0 + r * 32 + lane;
    live[r] = row < rw.n;
    px[r] = py[r] = h[r] = 0.f;
    key[r] = 0;
    if (live[r]) {
      int64_t i = row;
      if (GATHER) {
        i = rw.pos[row];
        px[r] = dequantize(rw.x[i], -180.0, LON_CELL);
        py[r] = dequantize(rw.y[i], -90.0, LAT_CELL);
      } else {
        px[r] = rw.cx[row];
        py[r] = rw.cy[row];
      }
      key[r] = time_key(rw.bins[i], rw.offs[i]);
      if (HEADING) h[r] = rw.hdg[row];
    }
  }
  const int q = cr.q, s = cr.s;
  for (int q0 = 0; q0 < q; q0 += qt) {
    const int nq = min(qt, q - q0);
    bool acc_c[ROWS] = {}, acc_s[ROWS] = {};  // a one-corridor tile's flags across segment tiles
    for (int s0 = 0; s0 < s; s0 += st) {
      const int ns = min(st, s - s0);
      __syncthreads();  // the previous tile is read
      for (int i = threadIdx.x; i < nq * ns; i += THREADS) {
        const int qi = i / ns, k = i % ns;
        const int64_t g = (int64_t)(q0 + qi) * s + s0 + k;
        const float4 v = reinterpret_cast<const float4*>(cr.segs)[g];
        const float dx = __fsub_rn(v.z, v.x), dy = __fsub_rn(v.w, v.y);
        sg.seg[qi * st + k] = make_float4(v.x, v.y, dx, dy);
        const float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.z)), fmaxf(fabsf(v.y), fabsf(v.w)));
        const float reach = __fadd_rn(__fadd_rn(__fmul_rn(__fsqrt_rn(cr.buf2_hi[q0 + qi]),
                                                          REACH_SCALE), REACH_PAD),
                                      __fmul_rn(m, REACH_REL));
        sg.reach[qi * st + k] = make_float4(
            __fsub_rn(fminf(v.x, v.z), reach), __fadd_rn(fmaxf(v.x, v.z), reach),
            __fsub_rn(fminf(v.y, v.w), reach), __fadd_rn(fmaxf(v.y, v.w), reach));
        sg.len2[qi * st + k] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const int4 w = reinterpret_cast<const int4*>(cr.tq)[g];
        sg.win[qi * st + k] = make_longlong2(time_key(w.x, w.y), time_key(w.z, w.w));
        sg.brg[qi * st + k] = cr.brg[g];
      }
      for (int qi = threadIdx.x; qi < nq; qi += THREADS)
        sg.band[qi] = make_float4(cr.buf2_lo[q0 + qi], cr.buf2_hi[q0 + qi],
                                  cr.tol_lo[q0 + qi], cr.tol_hi[q0 + qi]);
      __syncthreads();
      if (!warp_live) continue;
      for (int qi = 0; qi < nq; ++qi) {
        const float4 band = sg.band[qi];
        bool c[ROWS] = {}, su[ROWS] = {};
        for (int k = 0; k < ns; ++k) {
          const longlong2 w = sg.win[qi * st + k];
          const float4 box = sg.reach[qi * st + k];
          const float4 v = sg.seg[qi * st + k];
          const float len2 = sg.len2[qi * st + k];
          const float b = HEADING ? sg.brg[qi * st + k] : 0.f;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (!live[r] || key[r] < w.x || key[r] > w.y || px[r] < box.x || px[r] > box.y ||
                py[r] < box.z || py[r] > box.w)
              continue;  // no band holds the row (see the note on the reach box)
            const float num = __fadd_rn(__fmul_rn(__fsub_rn(px[r], v.x), v.z),
                                        __fmul_rn(__fsub_rn(py[r], v.y), v.w));
            const float tp = clamp01(len2 > 0.f ? __fdiv_rn(num, len2) : 0.f);
            const float ex = __fsub_rn(px[r], __fadd_rn(v.x, __fmul_rn(tp, v.z)));
            const float ey = __fsub_rn(py[r], __fadd_rn(v.y, __fmul_rn(tp, v.w)));
            const float d2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
            bool hc = true, hs = true;
            if (HEADING) {
              float m = fmodf(__fadd_rn(__fsub_rn(h[r], b), 180.f), 360.f);
              if (m != 0.f && m < 0.f) m = __fadd_rn(m, 360.f);  // the divisor 360 is positive
              float diff = fabsf(__fsub_rn(m, 180.f));
              if (BIDIR) diff = fminf(diff, __fsub_rn(180.f, diff));
              hc = diff <= band.w || band.w >= 360.f;
              hs = diff <= band.z || band.z >= 360.f;
            }
            c[r] = c[r] || (d2 <= band.y && hc);
            su[r] = su[r] || (d2 <= band.x && hs);
          }
        }
        if (st < s) {  // qt == 1: the corridor's segments span several tiles
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            acc_c[r] = acc_c[r] || c[r];
            acc_s[r] = acc_s[r] || su[r];
          }
        } else {
          const int64_t o = (int64_t)(q0 + qi) * words;
          store_words(c, su, lane, word0, words, cand + o, sure + o);
        }
      }
    }
    if (st < s && warp_live) {
      const int64_t o = (int64_t)q0 * words;
      store_words(acc_c, acc_s, lane, word0, words, cand + o, sure + o);
    }
  }
}

template <bool GATHER, bool HEADING, bool BIDIR>
cudaError_t launch(const Rows& rw, const Corridors& cr, uint32_t* cand, uint32_t* sure,
                   cudaStream_t stream) {
  const int per_corridor = cr.s * SEG_BYTES + CORRIDOR_BYTES;
  int qt, st;
  if (per_corridor <= SMEM_BYTES) {
    st = cr.s;
    qt = min(cr.q, SMEM_BYTES / per_corridor);
  } else {
    qt = 1;
    st = (SMEM_BYTES - CORRIDOR_BYTES) / SEG_BYTES;
  }
  const size_t smem = (size_t)qt * (st * SEG_BYTES + CORRIDOR_BYTES);
  const long long blocks = (rw.n + CTA_ROWS - 1) / CTA_ROWS;
  corridor_masks_kernel<GATHER, HEADING, BIDIR>
      <<<(unsigned)blocks, THREADS, smem, stream>>>(rw, cr, qt, st, cand, sure);
  return cudaGetLastError();
}

template <bool GATHER>
int dispatch(const Rows& rw, const Corridors& cr, int heading, int bidirectional, void* cand,
             void* sure, void* stream) {
  if (rw.n <= 0 || cr.q <= 0) return (int)cudaSuccess;
  if (cr.s <= 0 || (rw.n + CTA_ROWS - 1) / CTA_ROWS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  uint32_t* c = (uint32_t*)cand;
  uint32_t* su = (uint32_t*)sure;
  cudaStream_t st = (cudaStream_t)stream;
  if (heading)
    return bidirectional ? (int)launch<GATHER, true, true>(rw, cr, c, su, st)
                         : (int)launch<GATHER, true, false>(rw, cr, c, su, st);
  return bidirectional ? (int)launch<GATHER, false, true>(rw, cr, c, su, st)
                       : (int)launch<GATHER, false, false>(rw, cr, c, su, st);
}

Corridors corridors(const void* segs, const void* tq, const void* brg, const void* buf2_lo,
                    const void* buf2_hi, const void* tol_lo, const void* tol_hi, int q, int s) {
  return Corridors{(const float*)segs, (const int32_t*)tq, (const float*)brg,
                   (const float*)buf2_lo, (const float*)buf2_hi, (const float*)tol_lo,
                   (const float*)tol_hi, q, s};
}

}  // namespace

// The row form. Rows cx, cy (f32), bins, offs (int32), hdg (f32, unread
// without heading); corridors segs (Q, S, 4) f32, tq (Q, S, 4) int32, brg
// (Q, S) f32 and the four (Q,) f32 bands; cand and sure (Q, ceil(N / 32))
// uint32 words out, every one written.
extern "C" int geomesa_corridor_masks(const void* cx, const void* cy, const void* bins,
                                      const void* offs, const void* hdg, long long n,
                                      const void* segs, const void* tq, const void* brg,
                                      const void* buf2_lo, const void* buf2_hi,
                                      const void* tol_lo, const void* tol_hi, int q, int s,
                                      int heading, int bidirectional, void* cand, void* sure,
                                      void* stream) {
  const Rows rw{(const float*)cx, (const float*)cy, nullptr, nullptr, (const int32_t*)bins,
                (const int32_t*)offs, nullptr, (const float*)hdg, n};
  return dispatch<false>(rw, corridors(segs, tq, brg, buf2_lo, buf2_hi, tol_lo, tol_hi, q, s),
                         heading, bidirectional, cand, sure, stream);
}

// The gather form. A point state's resident int32 x, y, bins, offs (sorted
// order), n candidate positions pos (int32, each below the state's rows),
// hdg (n,) f32 aligned with the candidates (unread without heading); the
// corridors and outputs as in the row form, over the n candidates.
extern "C" int geomesa_corridor_masks_gather(const void* x, const void* y, const void* bins,
                                             const void* offs, const void* pos,
                                             const void* hdg, long long n, const void* segs,
                                             const void* tq, const void* brg,
                                             const void* buf2_lo, const void* buf2_hi,
                                             const void* tol_lo, const void* tol_hi, int q,
                                             int s, int heading, int bidirectional, void* cand,
                                             void* sure, void* stream) {
  const Rows rw{nullptr, nullptr, (const int32_t*)x, (const int32_t*)y, (const int32_t*)bins,
                (const int32_t*)offs, (const int32_t*)pos, (const float*)hdg, n};
  return dispatch<true>(rw, corridors(segs, tq, brg, buf2_lo, buf2_hi, tol_lo, tol_hi, q, s),
                        heading, bidirectional, cand, sure, stream);
}
