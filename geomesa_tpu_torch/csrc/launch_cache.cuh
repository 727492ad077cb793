// launch_cache.cuh: a kernel's shared-memory attributes and its resident
// blocks per SM, set and asked once per (device, dynamic shared bytes)
// instead of on every launch.
//
// cudaFuncSetAttribute and cudaOccupancyMaxActiveBlocksPerMultiprocessor
// cost host time on every call, and a count batch over a store of a few
// million rows takes only tens of microseconds on the card, so the
// wrappers of batched_overlap.cu and batched_edge_gather.cu keep one
// LaunchCache per kernel instance (grouped_agg.cu one per fold mode). The
// dynamic shared-memory limit is only
// ever raised (a launch with fewer bytes than an earlier one finds the
// limit already high enough), and the carveout is set with it. A mutex
// guards the cache: ctypes releases the GIL, so launches may come from
// several host threads at once. device_attr() keeps a device attribute
// (the opt-in shared-memory limit, the SM count) the same way, asked once
// per device.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace geomesa {

struct LaunchCache {
  static constexpr int SLOTS = 32;
  std::mutex mu;
  int used = 0;
  int device[SLOTS];
  size_t smem[SLOTS];
  int per_sm[SLOTS];
  int n_dev = 0;
  int limit_dev[SLOTS];
  size_t limit[SLOTS];  // the dynamic shared-memory limit set on limit_dev
};

// Gives kernel's resident blocks per SM (at least 1) at `threads` threads
// and `smem` dynamic shared bytes on the current device, after making sure
// its dynamic shared-memory limit admits smem and its carveout prefers
// shared memory.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, LaunchCache& cache,
                            int* per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int i = 0; i < cache.used; ++i) {
    if (cache.device[i] == dev && cache.smem[i] == smem) {
      *per_sm = cache.per_sm[i];
      return cudaSuccess;
    }
  }
  int li = 0;
  while (li < cache.n_dev && cache.limit_dev[li] != dev) ++li;
  if (li == cache.n_dev || cache.limit[li] < smem) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    if (li == cache.n_dev && cache.n_dev < LaunchCache::SLOTS) {
      cache.limit_dev[cache.n_dev++] = dev;
      cache.limit[li] = smem;
    } else if (li < cache.n_dev) {
      cache.limit[li] = smem;
    }
  }
  int p = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  *per_sm = p > 0 ? p : 1;
  if (cache.used < LaunchCache::SLOTS) {  // a full cache asks again on each launch
    cache.device[cache.used] = dev;
    cache.smem[cache.used] = smem;
    cache.per_sm[cache.used++] = *per_sm;
  }
  return cudaSuccess;
}

// The current device's value of attr (0 on an error), asked once per
// (device, attribute).
inline int device_attr(cudaDeviceAttr attr) {
  static std::mutex mu;
  static int known_dev[LaunchCache::SLOTS], known_attr[LaunchCache::SLOTS],
      known[LaunchCache::SLOTS];
  static int n_known = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_known; ++i)
    if (known_dev[i] == dev && known_attr[i] == (int)attr) return known[i];
  int v = 0;
  if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return 0;
  if (n_known < LaunchCache::SLOTS) {
    known_dev[n_known] = dev;
    known_attr[n_known] = (int)attr;
    known[n_known++] = v;
  }
  return v;
}

// The current device's opt-in shared memory per block (0 on an error).
inline int smem_optin() { return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin); }

}  // namespace geomesa
