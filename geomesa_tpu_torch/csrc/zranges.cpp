// zranges.cpp: z-range decomposition on the host, the planner's hot spot.
//
// Port copy of geomesa_tpu/native/zranges.cpp (geomesa_zranges, :79), with
// the same extern "C" contract. A BFS over the implicit quad/oct tree of
// Morton prefix cells classifies each cell against the query box as
// contained (emit exact), disjoint (drop) or overlapping (split, or emit
// loosely once the range budget or the depth floor is hit); the ranges are
// then sorted and merged. Bit-identical to the pure-Python BFS kept as
// zranges_plain in geomesa_tpu_torch/curve/zranges.py (the tests hold all
// three equal).
//
// Host C++, not a kernel: g++ -O2 -shared -fPIC builds it at first use into
// geomesa_tpu_torch/_build/, and geomesa_tpu_torch/curve/zranges.py binds it
// with ctypes.

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

struct Cell {
  uint64_t dims[3];
  int level;
};

inline uint64_t spread2(uint64_t x) {
  x &= 0x00000000FFFFFFFFULL;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFULL;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFULL;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0FULL;
  x = (x | (x << 2)) & 0x3333333333333333ULL;
  x = (x | (x << 1)) & 0x5555555555555555ULL;
  return x;
}

inline uint64_t spread3(uint64_t x) {
  x &= 0x00000000001FFFFFULL;
  x = (x | (x << 32)) & 0x001F00000000FFFFULL;
  x = (x | (x << 16)) & 0x001F0000FF0000FFULL;
  x = (x | (x << 8)) & 0x100F00F00F00F00FULL;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ULL;
  x = (x | (x << 2)) & 0x1249249249249249ULL;
  return x;
}

inline uint64_t encode(int dims, const uint64_t* v) {
  if (dims == 2) return spread2(v[0]) | (spread2(v[1]) << 1);
  return spread3(v[0]) | (spread3(v[1]) << 1) | (spread3(v[2]) << 2);
}

// The cell against the box: 0 disjoint, 1 overlapping, 2 contained.
inline int classify(const Cell& c, int dims, int precision, const uint64_t* lows,
                    const uint64_t* highs) {
  const int s = precision - c.level;
  bool contained = true;
  for (int d = 0; d < dims; d++) {
    const uint64_t clo = c.dims[d] << s;
    const uint64_t chi = clo | ((1ULL << s) - 1);
    if (chi < lows[d] || clo > highs[d]) return 0;
    if (clo < lows[d] || chi > highs[d]) contained = false;
  }
  return contained ? 2 : 1;
}

inline void emit(std::vector<std::pair<uint64_t, uint64_t>>& out, const Cell& c, int dims,
                 int precision) {
  const int s = precision - c.level;
  uint64_t corner[3];
  for (int d = 0; d < dims; d++) corner[d] = c.dims[d] << s;
  const uint64_t zlo = encode(dims, corner);
  out.emplace_back(zlo, zlo | ((1ULL << (dims * s)) - 1));  // dims * s <= 63
}

}  // namespace

extern "C" {

// Covers the inclusive box [lows, highs] (dims 2 or 3, precision bits a
// dimension, dims * precision <= 63) with inclusive uint64 z intervals,
// sorted and merged, written as (lo, hi) pairs to out (room for cap pairs).
// Returns the number of pairs, 0 for an inverted box, or -1 when out is too
// small or the arguments are out of range.
long geomesa_zranges(int dims, const uint64_t* lows, const uint64_t* highs, int precision,
                     long max_ranges, long max_recurse, uint64_t* out, long cap) {
  if (dims < 2 || dims > 3 || precision < 1 || dims * precision > 63) return -1;
  for (int d = 0; d < dims; d++)
    if (highs[d] < lows[d]) return 0;

  // the whole domain is one range
  const uint64_t full = (1ULL << precision) - 1;
  bool whole = true;
  for (int d = 0; d < dims; d++)
    if (lows[d] != 0 || highs[d] != full) whole = false;
  if (whole) {
    if (cap < 1) return -1;
    out[0] = 0;
    out[1] = (1ULL << (dims * precision)) - 1;
    return 1;
  }

  const int max_level = precision < max_recurse ? precision : (int)max_recurse;
  std::vector<std::pair<uint64_t, uint64_t>> ranges;
  ranges.reserve(max_ranges > 0 ? max_ranges : 64);
  std::vector<Cell> frontier;
  frontier.push_back(Cell{{0, 0, 0}, 0});
  size_t head = 0;

  while (head < frontier.size()) {
    if ((long)ranges.size() + (long)(frontier.size() - head) >= max_ranges) {
      // the budget is spent: emit every remaining non-disjoint cell loosely
      for (; head < frontier.size(); head++) {
        if (classify(frontier[head], dims, precision, lows, highs) != 0)
          emit(ranges, frontier[head], dims, precision);
      }
      break;
    }
    const Cell c = frontier[head++];
    const int cls = classify(c, dims, precision, lows, highs);
    if (cls == 0) continue;
    if (cls == 2 || c.level >= max_level) {
      emit(ranges, c, dims, precision);
      continue;
    }
    for (int child = 0; child < (1 << dims); child++) {
      Cell nc;
      nc.level = c.level + 1;
      for (int d = 0; d < dims; d++) nc.dims[d] = (c.dims[d] << 1) | ((child >> d) & 1);
      frontier.push_back(nc);
    }
    if (head > 4096) {  // drop the consumed prefix to bound memory
      frontier.erase(frontier.begin(), frontier.begin() + head);
      head = 0;
    }
  }

  std::sort(ranges.begin(), ranges.end());
  long n = 0;
  for (size_t i = 0; i < ranges.size(); i++) {
    // merge when the range starts at or before the previous end + 1 (ends
    // stay below 2^63, so the + 1 cannot wrap)
    if (n > 0 && ranges[i].first <= out[2 * (n - 1) + 1] + 1) {
      if (ranges[i].second > out[2 * (n - 1) + 1]) out[2 * (n - 1) + 1] = ranges[i].second;
    } else {
      if (n >= cap) return -1;
      out[2 * n] = ranges[i].first;
      out[2 * n + 1] = ranges[i].second;
      n++;
    }
  }
  return n;
}

}  // extern "C"
