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
//   dwell += dist <= dwell_eps ? step_dt : 0,
// an entity with no row summing to 0. dist is computed with __fmul_rn /
// __fadd_rn / __fsqrt_rn in the plain version's order (ops/kernels.py
// track_stats_plain), which nvcc never contracts into an FMA, so dist > 0
// and dist <= dwell_eps decide exactly as the plain version does on the
// card; the remainder is torch.remainder's own formula (fmod, then + 360
// where the result is non-zero and negative), in two exact branches over
// the bearings' range (turn_deg). atan2f may differ from
// torch's in the last bit, and the sums are added in another order, so the
// sums agree with the plain version within a stated tolerance, not bit for
// bit. They are the same from launch to launch: every sum is added in an
// order fixed by the layout alone.
//
// Bound on an H100: bytes. The three columns are read once (12 B a row),
// the offsets once (8 B an entity) and the four sums written once (16 B an
// entity): at bench config 10 (2M rows, 7,812 entities) 24.2 MB, 7.2 us at
// 3.35 TB/s. What held the first version (a warp-segmented scan, 0.0428 ms
// of device time) back: a warp took 512 rows in 16 dependent steps of 32,
// each behind a binary search of the offsets and the load of the entity's
// first row, with 4 B loads and a separate memset before the launch.
//
// Design: a block-tiled segmented reduction, single pass.
//   - Block b takes the tile of TILE = 2048 consecutive rows from b x TILE
//     (blocks start in index order, as decoupled look-back scans take
//     them); each thread holds ROWS = 8 of them and loads x, y and dt as
//     16-byte vectors (and the two rows before its first) before any
//     dependent work.
//   - Entity ids from head flags: warp 0 finds the entity of the row before
//     the tile (lo) by a warp-wide search of the offsets, its first round
//     32 consecutive offsets around the row's share of the entities (one
//     round on evenly filled layouts); the block then reads offsets lo + 1
//     on, coalesced, until one passes the tile: a non-empty entity marks
//     its first row as a head (ent_at), an empty one gets its zeros, and
//     the first offset past the tile says whether the tile's last row ends
//     its entity. The entity ranges (lo, hi] of the tiles partition the
//     entities (the last tile's runs to E - 1), so every empty entity is
//     written once.
//   - The terms of a row need the previous row's step only (its bearing and
//     whether it moved), which each thread computes from the two rows
//     before its first.
//   - A segmented reduction of the four terms: serial over a thread's rows,
//     then a segmented scan over the warp's lanes (shuffles) and over the
//     block's warps (shared memory). A row that ends its entity writes the
//     entity's sums with plain stores: the entity's in-tile sum, plus the
//     carry from earlier tiles where it began before the tile.
//   - The carry: each tile publishes, as soon as its own scan is done, its
//     tail (the sums from its last head to its end, status HEAD) or, with no
//     head, its whole sums (status PART), the status tagged with the
//     launch's epoch (the wrapper's count of launches on the scratch), so
//     no launch clears the scratch and none needs a memset. A tile whose
//     first row continues an entity looks back (warp 0, 32 tiles a round)
//     to the nearest HEAD tile and adds the published sums of the tiles
//     between in tile order. No tile waits on another's look-back, and the
//     sums' order depends on the layout only; the sums are written once
//     each.
//   - 64 registers a thread at most, four blocks an SM.
//
// Plain C entry point for ctypes; it launches on the caller's stream, does
// not synchronise, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;                  // consecutive rows a thread holds
constexpr int TILE = THREADS * ROWS;     // rows a block takes
constexpr float RAD2DEG = 57.29577951308232f;
// the scratch (the wrapper's int32 buffer): a status a tile, then four sums
// a tile; a status is the launch's epoch << 2 | PART or HEAD, anything else
// (another launch's, or 0) is not ready
enum { PART = 1, HEAD = 2 };
constexpr int EPOCH_BITS = 29;

// The largest entity e in [0, e_count - 1] with offsets[e] <= row (row >= 0,
// offsets[0] = 0), the entity of row (empty entities skipped), and its
// offset. All 32 lanes call it. The first round probes the 32 entities
// around row's share of them (n rows), the later ones 32 evenly spaced
// offsets of what is left, each narrowing the range 32-fold.
__device__ __forceinline__ int warp_entity(const int64_t* __restrict__ offsets, int e_count,
                                           int64_t n, int64_t row, int64_t& at) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = e_count - 1;  // offsets[lo] <= row; the answer lies in [lo, hi]
  int64_t lo_off = 0;
  const long long guess = (long long)((double)row / (double)n * e_count) - 16;
  bool first = true;
  while (lo < hi) {
    const long long span = hi - lo;
    int p = first ? (int)min(max(guess + lane, (long long)lo), (long long)hi)
                  : lo + (int)((span * (lane + 1) + 31) / 32);  // lane 31 probes hi
    const int64_t v = __ldg(offsets + p);
    const unsigned ok = __ballot_sync(FULL_WARP, v <= row);
    const int t = __popc(ok);  // the probes at or below row are a prefix of the lanes
    const int p_lo = __shfl_sync(FULL_WARP, p, t > 0 ? t - 1 : 0);
    const int64_t v_lo = __shfl_sync(FULL_WARP, v, t > 0 ? t - 1 : 0);
    const int p_hi = __shfl_sync(FULL_WARP, p, t < 32 ? t : 31);
    if (t > 0) lo = p_lo, lo_off = v_lo;
    if (t < 32) hi = p_hi - 1;
    first = false;
  }
  at = lo_off;
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

// |remainder(brg - prev + 180, 360) - 180| with torch.remainder's sign rule
// (fmod, then + 360 where the result is non-zero and negative). Both
// bearings lie in [-180, 180], so v = brg - prev + 180 lies in [-180, 540]
// and fmod(v, 360) is v, or v - 360 for v >= 360 (exact: Sterbenz), so the
// two branches below give torch's result bit for bit without fmodf.
__device__ __forceinline__ float turn_deg(float brg, float prev) {
  float m = __fadd_rn(__fsub_rn(brg, prev), 180.f);
  if (m >= 360.f) m = __fsub_rn(m, 360.f);
  else if (m < 0.f) m = __fadd_rn(m, 360.f);
  return fabsf(__fsub_rn(m, 180.f));
}

struct Sums {
  float len, dur, turn, dwell;
};

__device__ __forceinline__ void add(Sums& a, const Sums& b) {
  a.len += b.len, a.dur += b.dur, a.turn += b.turn, a.dwell += b.dwell;
}

// A segmented-scan state: the entity of the last head in the range (-1:
// none) and the sums since it (or over the whole range).
struct Seg {
  int ent;
  Sums s;
};

// The range L followed by the range R.
__device__ __forceinline__ Seg combine(const Seg& l, const Seg& r) {
  if (r.ent >= 0) return r;
  Seg o = l;
  add(o.s, r.s);
  return o;
}

__device__ __forceinline__ Seg shfl_up(const Seg& v, int d) {
  return Seg{__shfl_up_sync(FULL_WARP, v.ent, d),
             {__shfl_up_sync(FULL_WARP, v.s.len, d), __shfl_up_sync(FULL_WARP, v.s.dur, d),
              __shfl_up_sync(FULL_WARP, v.s.turn, d), __shfl_up_sync(FULL_WARP, v.s.dwell, d)}};
}

__device__ __forceinline__ void store(float* __restrict__ out, int64_t e_count, int e,
                                      const Sums& s) {
  out[e] = s.len;
  out[e_count + e] = s.dur;
  out[2 * e_count + e] = s.turn;
  out[3 * e_count + e] = s.dwell;
}

// Loads the thread's rows r0 .. r0 + ROWS - 1 of col (zeros past n), as two
// 16-byte vectors where they lie whole and aligned.
__device__ __forceinline__ void load_rows(const float* __restrict__ col, int64_t r0, int64_t n,
                                          bool vec, float (&v)[ROWS]) {
  if (vec && r0 + ROWS <= n) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(col + r0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(col + r0) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < ROWS; ++j) v[j] = r0 + j < n ? __ldg(col + r0 + j) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 4)
track_stats_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ dt, const int64_t* __restrict__ offsets, int64_t n,
                   int e_count, float dwell_eps,
                   float* __restrict__ out,  // (4, E): length, duration, heading change, dwell
                   int* __restrict__ scratch, int epoch) {
  __shared__ int ent_at[TILE];  // the entity a head row starts, -1 on other rows
  __shared__ Seg warp_seg[WARPS];
  __shared__ int lo_s, head_prev_s, past_s;
  __shared__ Sums carry_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tiles = gridDim.x, tile = blockIdx.x;
  int* status = scratch;
  float* published = reinterpret_cast<float*>(scratch + tiles);  // (tiles, 4)
  const int64_t row0 = tile * TILE;
  const int64_t row_end = row0 + TILE < n ? row0 + TILE : n;
  const int64_t r0 = row0 + (int64_t)threadIdx.x * ROWS;

  // the rows first: every load of the thread is issued before dependent work
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(dt)) & 15) == 0;
  float xr[ROWS], yr[ROWS], dr[ROWS];
  load_rows(x, r0, row_end, vec, xr);
  load_rows(y, r0, row_end, vec, yr);
  load_rows(dt, r0, row_end, vec, dr);
  const float x1 = r0 >= 1 ? __ldg(x + r0 - 1) : 0.f, y1 = r0 >= 1 ? __ldg(y + r0 - 1) : 0.f;
  const float x2 = r0 >= 2 ? __ldg(x + r0 - 2) : 0.f, y2 = r0 >= 2 ? __ldg(y + r0 - 2) : 0.f;

  for (int i = threadIdx.x; i < TILE; i += THREADS) ent_at[i] = -1;
  if (warp == 0) {  // the entity of the row before the tile
    int lo = -1, head_prev = 0;
    if (row0 > 0) {
      int64_t lo_off;
      lo = warp_entity(offsets, e_count, n, row0 - 1, lo_off);
      head_prev = lo_off == row0 - 1;
    }
    // past_s: 2 x the first entity past the tile + whether it starts right after it (E: none)
    if (lane == 0) lo_s = lo, head_prev_s = head_prev, past_s = 2 * e_count + (n == row_end);
  }
  __syncthreads();
  // heads and empty entities from lo + 1 on, offsets read once, coalesced,
  // up to the first entity that starts past the tile (past_s)
  for (int64_t base = lo_s + 1;; base += THREADS) {
    const int64_t e = base + threadIdx.x;
    bool past = false;
    if (e < e_count) {
      const int64_t off = __ldg(offsets + e), next = __ldg(offsets + e + 1);
      if (off >= row_end) {
        past = true;
        atomicMin(&past_s, 2 * (int)e + (off == row_end));
      } else if (off < next) {
        ent_at[off - row0] = (int)e;
      } else {
        store(out, e_count, (int)e, Sums{0.f, 0.f, 0.f, 0.f});
      }
    }
    if (__syncthreads_or(past || e >= e_count - 1)) break;
  }
  __syncthreads();
  const int lo = lo_s;
  const int past = past_s >> 1;  // the first entity past the tile (E: none)
  const bool ends_last = past_s & 1;  // the tile's last row ends its entity
  if (tile == tiles - 1) {  // the entities past the last row: empty
    for (int64_t e = past + threadIdx.x; e < e_count; e += THREADS)
      store(out, e_count, (int)e, Sums{0.f, 0.f, 0.f, 0.f});
  }

  // the terms of the thread's rows
  const int l0 = threadIdx.x * ROWS;  // the thread's first row in the tile
  const bool head_before = threadIdx.x ? ent_at[l0 - 1] >= 0 : head_prev_s != 0;
  bool pmoved = false;  // the step into row r0 - 1: it moved, and its bearing
  float pbrg = 0.f;
  if (r0 >= 2 && !head_before) {
    const float qx = __fsub_rn(x1, x2), qy = __fsub_rn(y1, y2);
    pmoved = step_dist(qx, qy) > 0.f;
    pbrg = step_bearing(qx, qy);
  }
  Sums terms[ROWS];
  Seg agg{-1, {0.f, 0.f, 0.f, 0.f}};  // the thread's rows as one range
  float px = x1, py = y1;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const bool valid = r0 + j < row_end;
    const bool first = valid && ent_at[l0 + j] >= 0;
    const float dx = __fsub_rn(xr[j], px), dy = __fsub_rn(yr[j], py);
    const float dist = first ? 0.f : step_dist(dx, dy);
    const float sdt = first ? 0.f : dr[j];
    const float brg = step_bearing(dx, dy);
    const bool moved = !first && dist > 0.f;
    terms[j] = valid ? Sums{dist, sdt, moved && pmoved ? turn_deg(brg, pbrg) : 0.f,
                            dist <= dwell_eps ? sdt : 0.f}
                     : Sums{0.f, 0.f, 0.f, 0.f};
    if (first) {
      agg.ent = ent_at[l0 + j];
      agg.s = terms[j];
    } else {
      add(agg.s, terms[j]);
    }
    px = xr[j], py = yr[j], pmoved = moved, pbrg = brg;
  }

  // the block's segmented scan: each thread's exclusive prefix and the tile's total
  Seg incl = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg u = shfl_up(incl, d);
    if (lane >= d) incl = combine(u, incl);
  }
  if (lane == 31) warp_seg[warp] = incl;
  Seg excl = shfl_up(incl, 1);
  if (lane == 0) excl = Seg{-1, {0.f, 0.f, 0.f, 0.f}};
  __syncthreads();
  Seg before{-1, {0.f, 0.f, 0.f, 0.f}}, total{-1, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before = combine(before, warp_seg[w]);
    total = combine(total, warp_seg[w]);
  }
  excl = combine(before, excl);

  // publish the tile's part, then look back for the carry of its first entity
  const int tag = epoch << 2;
  if (threadIdx.x == 0) {
    float* p = published + 4 * tile;
    p[0] = total.s.len, p[1] = total.s.dur, p[2] = total.s.turn, p[3] = total.s.dwell;
    __threadfence();
    atomicExch(status + tile, tag | (total.ent >= 0 ? HEAD : PART));
  }
  const bool continues = row0 > 0 && ent_at[0] < 0;  // the tile's first row is not a head
  if (continues && warp == 0) {
    Sums carry{0.f, 0.f, 0.f, 0.f};
    for (int64_t b = tile - 1;; b -= 32) {
      const int64_t tb = b - lane;  // lane l reads tile b - l
      // wait for the tiles up to the nearest HEAD one only, not for the whole window
      unsigned heads;
      int st;
      for (;;) {
        st = tb >= 0 ? *(const volatile int*)(status + tb) : (tag | HEAD);  // tile 0 has a head
        const unsigned ready = __ballot_sync(FULL_WARP, (st & ~3) == tag);
        heads = __ballot_sync(FULL_WARP, (st & ~3) == tag && (st & 3) == HEAD);
        const unsigned need = heads ? (heads & -heads) * 2 - 1 : FULL_WARP;  // lanes 0 .. stop
        if ((ready & need) == need) break;
        __nanosleep(32);
      }
      __threadfence();
      const int stop = heads ? __ffs(heads) - 1 : 31;  // the nearest HEAD tile, or the window's end
      Sums v{0.f, 0.f, 0.f, 0.f};
      if (lane <= stop && tb >= 0) {
        const volatile float* p = published + 4 * tb;
        v = Sums{p[0], p[1], p[2], p[3]};
      }
      // the window's tiles added in tile order (lane stop first), then the nearer windows
      Sums w{0.f, 0.f, 0.f, 0.f};
      for (int l = stop; l >= 0; --l) {
        const Sums u{__shfl_sync(FULL_WARP, v.len, l), __shfl_sync(FULL_WARP, v.dur, l),
                     __shfl_sync(FULL_WARP, v.turn, l), __shfl_sync(FULL_WARP, v.dwell, l)};
        add(w, u);
      }
      add(w, carry);
      carry = w;
      if (heads) break;
    }
    if (lane == 0) carry_s = carry;
  }
  __syncthreads();

  // every entity whose last row lies in the tile: its sums, once
  Seg cur = excl;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int64_t i = r0 + j;
    if (i >= row_end) break;
    if (ent_at[l0 + j] >= 0) {
      cur.ent = ent_at[l0 + j];
      cur.s = terms[j];
    } else {
      add(cur.s, terms[j]);
    }
    const bool ends = i + 1 < row_end ? ent_at[l0 + j + 1] >= 0 : ends_last;
    if (ends) {
      if (cur.ent >= 0) {
        store(out, e_count, cur.ent, cur.s);
      } else {  // the tile's first entity, begun before the tile
        Sums s = carry_s;
        add(s, cur.s);
        store(out, e_count, lo, s);
      }
    }
  }
}

// No row: every entity's sums are 0.
__global__ void __launch_bounds__(THREADS)
track_zero_kernel(float* __restrict__ out, int64_t count) {
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * THREADS)
    out[i] = 0.f;
}

}  // namespace

// The four (E,) f32 sums, laid out as one (4, E) output, in one launch.
// x, y, dt: (n,) f32; offsets: (E + 1,) int64, nondecreasing, from 0 to n;
// scratch: the wrapper's int32 buffer of at least 5 x ceil(n / TILE) ints
// (scratch_ints), zeroed when allocated; epoch: in [1, 2^29), a different
// one for each launch on the scratch since it was zeroed (the launches on
// one scratch run one after another).
extern "C" int geomesa_track_stats(const void* x, const void* y, const void* dt,
                                   const void* offsets, long long n, int e_count, float dwell_eps,
                                   void* out, void* scratch, long long scratch_ints, int epoch,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (e_count <= 0) return (int)cudaSuccess;
  if (n <= 0) {
    const long long count = 4LL * e_count;
    const long long blocks = (count + THREADS * 8 - 1) / (THREADS * 8);
    track_zero_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, st>>>(
        (float*)out, count);
    return (int)cudaGetLastError();
  }
  const long long tiles = (n + TILE - 1) / TILE;
  // e_count < 2^30: the first entity past a tile is kept as 2 e + 1 in an int
  if (tiles > 0x7fffffffLL || e_count >= (1 << 30) || 5 * tiles > scratch_ints || epoch < 1 ||
      epoch >= (1 << EPOCH_BITS))
    return (int)cudaErrorInvalidValue;
  track_stats_kernel<<<(unsigned)tiles, THREADS, 0, st>>>(
      (const float*)x, (const float*)y, (const float*)dt, (const int64_t*)offsets, n, e_count,
      dwell_eps, (float*)out, (int*)scratch, epoch);
  return (int)cudaGetLastError();
}
