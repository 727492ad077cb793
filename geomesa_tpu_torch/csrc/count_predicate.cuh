// count_predicate.cuh: the bbox+time row predicate shared by batched_count.cu
// and batched_count_hits.cu, so the two kernels cannot drift.
//
// The device counterpart of _tile_mask (geomesa_tpu/ops/pallas_kernels.py:46).
// Row r (local position lpos) matches query q when
//   ANY box slot k:  xlo <= x <= xhi  AND  ylo <= y <= yhi
//   AND ANY time slot k:  (bin, off) >= (blo, olo)  AND  (bin, off) <= (bhi, ohi)
//       (lexicographic, exactly as pallas_kernels.py:88-89)
//   AND lpos < n  AND  base + lpos < true_n.
// Every packed slot is evaluated, so the unsatisfiable padding sentinels of
// ops/refine.py keep their meaning.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace geomesa {

constexpr unsigned FULL_WARP = 0xffffffffu;

// Rows of a slice that may match: lpos < valid_limit(...) is the same test as
// lpos < n AND base + lpos < true_n.
__device__ __forceinline__ int64_t valid_limit(int64_t n, int64_t base, int64_t true_n) {
  return (true_n - base) < n ? (true_n - base) : n;
}

// Evaluates one query's packed payload (4*nb box ints, then 4*nt time ints,
// as staged in shared memory) against the ROWS rows a thread holds in
// registers. m[r] is the full predicate for row r (ok[r] is its validity).
//
// The time slots are evaluated only when some lane of the warp is inside a
// box: the return value is that warp-uniform flag, and when it is false every
// m[r] is false. All 32 lanes of the warp must call it together.
template <int ROWS>
__device__ __forceinline__ bool match_rows(const int32_t* __restrict__ pay, int nb, int nt,
                                           const int32_t (&rx)[ROWS], const int32_t (&ry)[ROWS],
                                           const int32_t (&rb)[ROWS], const int32_t (&ro)[ROWS],
                                           const bool (&ok)[ROWS], bool (&m)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) m[r] = false;
  for (int k = 0; k < nb; ++k) {
    const int32_t xlo = pay[4 * k], xhi = pay[4 * k + 1];
    const int32_t ylo = pay[4 * k + 2], yhi = pay[4 * k + 3];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      m[r] |= (rx[r] >= xlo) & (rx[r] <= xhi) & (ry[r] >= ylo) & (ry[r] <= yhi);
  }
  bool any_box = false;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = m[r] && ok[r];
    any_box |= m[r];
  }
  if (!__any_sync(FULL_WARP, any_box)) return false;
  const int32_t* pt = pay + 4 * nb;
  bool t[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) t[r] = false;
  for (int k = 0; k < nt; ++k) {
    const int32_t blo = pt[4 * k], olo = pt[4 * k + 1];
    const int32_t bhi = pt[4 * k + 2], ohi = pt[4 * k + 3];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool after = (rb[r] > blo) | ((rb[r] == blo) & (ro[r] >= olo));
      const bool before = (rb[r] < bhi) | ((rb[r] == bhi) & (ro[r] <= ohi));
      t[r] |= after & before;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) m[r] = m[r] && t[r];
  return true;
}

}  // namespace geomesa
