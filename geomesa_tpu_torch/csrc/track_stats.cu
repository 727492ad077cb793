// track_stats: every entity's track statistics in one pass over the
// segmented track layout, the device half of trajectory.state.track_stats.
//
// Replaces the XLA step geomesa_tpu/trajectory/state.py:364
// (cached_track_stats_step, its body :379-399). It is not a TPU kernel: the
// reference computes it in XLA as elementwise work and four segment_sums.
//
// What it computes. Rows are sorted by (entity, time); entity e owns rows
// offsets[e] .. offsets[e + 1] - 1 of the f32 columns x, y, dt (dt: seconds
// since the previous row of the entity, 0 on its first row). For row i of
// entity e (first = i == offsets[e]):
//   dx = x[i] - x[i - 1], dy = y[i] - y[i - 1],
//   dist = first ? 0 : sqrt(dx * dx + dy * dy),  step_dt = first ? 0 : dt[i],
//   brg  = atan2(dx, dy) * (180 / pi),           moved = !first && dist > 0,
//   turn = moved && moved(i - 1) ? |remainder(brg - brg(i - 1) + 180, 360) - 180| : 0,
// and per entity the four f32 sums
//   length += dist, duration += step_dt, heading change += turn,
//   dwell += dist <= dwell_eps ? step_dt : 0.
// dist is computed with __fmul_rn / __fadd_rn / __fsqrt_rn in the plain
// version's order (ops/kernels.py track_stats_plain), which nvcc never
// contracts into an FMA, so dist > 0 and dist <= dwell_eps decide exactly
// as the plain version does on the card; the remainder is torch.remainder's
// own formula, fmodf (exact) then + 360 where the result is non-zero and
// negative. atan2f may differ from torch's in the last bit, and the sums
// are added in another order, so the sums agree with the plain version
// within a stated tolerance, not bit for bit.
//
// Design: a warp-segmented reduction over the sorted rows with a carry.
// Each warp takes SPAN = 16 x 32 consecutive rows, 32 at a time, one row a
// lane. A lane's entity is the warp's current entity when the next entity
// starts past the 32 rows (one warp-uniform compare), else a binary search
// of the offsets from it. The previous row's coordinates, bearing and
// moved flag come from the neighbouring lane by shuffles (lane 0 takes them
// from the previous step's lane 31, or loads them at the span's start). An
// inclusive segmented scan of the four terms (five shuffle steps, keyed by
// the sorted entity ids) gives each segment's sum at its last lane; a
// segment that ends inside the 32 rows adds its sum (plus the warp's carry
// when it continues it) with one atomicAdd per sum to the outputs, and the
// segment at lane 31 becomes the carry. So a warp issues one atomic a
// (warp, segment) and sum, and an entity holding half the rows is spread
// over every warp of its rows, each adding its span's partial once: no
// entity's rows are serialised on one warp. The outputs are zeroed by the
// entry point (cudaMemsetAsync) before the launch.
//
// Bound on an H100: bytes. The three columns are read once (12 B a row),
// the offsets once (8 B an entity) and the four sums written once (16 B an
// entity): at bench config 10 (2M rows, 7,812 entities) 24.2 MB, 7.2 us at
// 3.35 TB/s, so the kernel is as likely bound by its launch and the latency
// of its few dependent loads as by its bytes.
//
// Plain C entry point for ctypes; it launches on the caller's stream, does
// not synchronise, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPAN_STEPS = 16;              // 32-row steps a warp takes
constexpr int SPAN = 32 * SPAN_STEPS;       // rows a warp takes
constexpr float RAD2DEG = 57.29577951308232f;

// The largest entity e in [lo, hi] with offsets[e] <= row, given
// offsets[lo] <= row: the entity of row (empty entities are skipped).
__device__ __forceinline__ int find_entity(const int64_t* __restrict__ offsets, int lo, int hi,
                                           int64_t row) {
  if (lo >= hi || __ldg(offsets + lo + 1) > row) return lo;
  lo += 1;  // offsets[lo] <= row
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (__ldg(offsets + mid) <= row) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The step into row i from row i - 1: distance and bearing, as the plain
// version computes them.
__device__ __forceinline__ float step_dist(float dx, float dy) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

__device__ __forceinline__ float step_bearing(float dx, float dy) {
  return __fmul_rn(atan2f(dx, dy), RAD2DEG);
}

// |remainder(brg - prev + 180, 360) - 180| with torch.remainder's sign rule.
__device__ __forceinline__ float turn_deg(float brg, float prev) {
  float m = fmodf(__fadd_rn(__fsub_rn(brg, prev), 180.f), 360.f);
  if (m != 0.f && m < 0.f) m = __fadd_rn(m, 360.f);
  return fabsf(__fsub_rn(m, 180.f));
}

struct Sums {
  float len, dur, turn, dwell;
};

__device__ __forceinline__ void flush(float* __restrict__ out, int64_t e_count, int e,
                                      const Sums& s) {
  atomicAdd(out + e, s.len);
  atomicAdd(out + e_count + e, s.dur);
  atomicAdd(out + 2 * e_count + e, s.turn);
  atomicAdd(out + 3 * e_count + e, s.dwell);
}

__global__ void __launch_bounds__(THREADS)
track_stats_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ dt, const int64_t* __restrict__ offsets, int64_t n,
                   int e_count, float dwell_eps,
                   float* __restrict__ out) {  // (4, E): length, duration, heading change, dwell
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int64_t s0 = warp * SPAN;
  if (s0 >= n) return;  // warp-uniform
  const int64_t s1 = s0 + SPAN < n ? s0 + SPAN : n;
  const int last_e = e_count - 1;
  int e_base = find_entity(offsets, 0, last_e, s0);  // the entity of the step's first row
  int carry_e = -1;  // the open segment at the previous step's lane 31
  Sums carry{0.f, 0.f, 0.f, 0.f};
  float prev_x = 0.f, prev_y = 0.f, prev_brg = 0.f;  // row base - 1's, for lane 0
  bool prev_moved = false;
  for (int64_t base = s0; base < s1; base += 32) {
    const int64_t i = base + lane;
    const bool valid = i < s1;
    // the lane's entity: the step's entity unless another starts within it
    if (base > s0) e_base = find_entity(offsets, e_base, last_e, base);
    const bool one = __ldg(offsets + e_base + 1) > base + 31 || e_base == last_e;
    const int e = !valid ? e_count : (one ? e_base : find_entity(offsets, e_base, last_e, i));
    const int64_t start = valid ? __ldg(offsets + e) : 0;
    const bool first = !valid || i == start;
    const float xi = valid ? __ldg(x + i) : 0.f;
    const float yi = valid ? __ldg(y + i) : 0.f;
    float xp = __shfl_up_sync(FULL_WARP, xi, 1), yp = __shfl_up_sync(FULL_WARP, yi, 1);
    if (lane == 0) {
      if (base == s0 && i > 0) {  // the span's first row: load the previous row
        xp = __ldg(x + i - 1);
        yp = __ldg(y + i - 1);
      } else {
        xp = prev_x;
        yp = prev_y;
      }
    }
    const float dx = __fsub_rn(xi, xp), dy = __fsub_rn(yi, yp);
    const float dist = first ? 0.f : step_dist(dx, dy);
    const float step_dt = first ? 0.f : __ldg(dt + i);
    const float brg = step_bearing(dx, dy);
    const bool moved = !first && dist > 0.f;
    float pbrg = __shfl_up_sync(FULL_WARP, brg, 1);
    bool pmoved = __shfl_up_sync(FULL_WARP, moved ? 1 : 0, 1) != 0;
    if (lane == 0) {
      if (base == s0) {  // the previous step, into row i - 1, when it is of the entity
        pmoved = false;
        if (moved && i - 1 > start) {
          const float qx = __fsub_rn(xp, __ldg(x + i - 2)), qy = __fsub_rn(yp, __ldg(y + i - 2));
          pmoved = step_dist(qx, qy) > 0.f;
          pbrg = step_bearing(qx, qy);
        }
      } else {
        pbrg = prev_brg;
        pmoved = prev_moved;
      }
    }
    Sums v{dist, step_dt, moved && pmoved ? turn_deg(brg, pbrg) : 0.f,
           dist <= dwell_eps ? step_dt : 0.f};
    // inclusive segmented scan keyed by the sorted entity ids
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int eu = __shfl_up_sync(FULL_WARP, e, d);
      const float a = __shfl_up_sync(FULL_WARP, v.len, d);
      const float b = __shfl_up_sync(FULL_WARP, v.dur, d);
      const float c = __shfl_up_sync(FULL_WARP, v.turn, d);
      const float w = __shfl_up_sync(FULL_WARP, v.dwell, d);
      if (lane >= d && eu == e) {
        v.len += a;
        v.dur += b;
        v.turn += c;
        v.dwell += w;
      }
    }
    // the carry closes where this step does not continue it
    const int e0 = __shfl_sync(FULL_WARP, e, 0);
    if (carry_e >= 0 && carry_e != e0) {
      if (lane == 0) flush(out, e_count, carry_e, carry);
      carry_e = -1;
    }
    if (e == carry_e) {
      v.len += carry.len;
      v.dur += carry.dur;
      v.turn += carry.turn;
      v.dwell += carry.dwell;
    }
    const int e_next = __shfl_down_sync(FULL_WARP, e, 1);
    if (lane < 31 && e_next != e && e < e_count) flush(out, e_count, e, v);
    // lane 31's segment may go on: it is the carry; its row is the next step's previous one
    carry_e = __shfl_sync(FULL_WARP, e, 31);
    carry.len = __shfl_sync(FULL_WARP, v.len, 31);
    carry.dur = __shfl_sync(FULL_WARP, v.dur, 31);
    carry.turn = __shfl_sync(FULL_WARP, v.turn, 31);
    carry.dwell = __shfl_sync(FULL_WARP, v.dwell, 31);
    prev_x = __shfl_sync(FULL_WARP, xi, 31);
    prev_y = __shfl_sync(FULL_WARP, yi, 31);
    prev_brg = __shfl_sync(FULL_WARP, brg, 31);
    prev_moved = __shfl_sync(FULL_WARP, moved ? 1 : 0, 31) != 0;
    if (carry_e >= e_count) carry_e = -1;  // past the span's rows: nothing open
  }
  if (carry_e >= 0 && lane == 0) flush(out, e_count, carry_e, carry);
}

}  // namespace

// The four (E,) f32 sums, laid out as one (4, E) output: zeroed here, then
// one launch. x, y, dt: (n,) f32; offsets: (E + 1,) int64, nondecreasing,
// from 0 to n.
extern "C" int geomesa_track_stats(const void* x, const void* y, const void* dt,
                                   const void* offsets, long long n, int e_count, float dwell_eps,
                                   void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (e_count <= 0) return (int)cudaSuccess;
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * 4 * (size_t)e_count, st);
  if (e != cudaSuccess || n <= 0) return (int)e;
  const long long warps = (n + SPAN - 1) / SPAN;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  track_stats_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
      (const float*)x, (const float*)y, (const float*)dt, (const int64_t*)offsets, n, e_count,
      dwell_eps, (float*)out);
  return (int)cudaGetLastError();
}
