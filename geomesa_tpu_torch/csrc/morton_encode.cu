// morton_encode: Morton (Z-order) interleave of normalized coordinates into
// int64 curve keys, one thread per row.
//
// z3_encode replaces geomesa_tpu/ops/pallas_kernels.py:380 (z3_encode ->
// _elementwise_call :357 -> _z3_kernel :340, masks _M3_WORDS :293): three
// <= 21-bit values -> a 63-bit code. z2_encode replaces :393 (z2_encode ->
// _z2_kernel :349, masks _M2_WORDS :304): two <= 31-bit values -> a 62-bit
// code. The bit layouts are those of curve/zorder.py: x on bit 0, y on bit 1
// (and t on bit 2).
//
// The TPU kernels carry each code as (hi, lo) uint32 words because the TPU
// vector unit has no 64-bit integers. Hopper has 64-bit shifts and logic
// (each a pair of 32-bit instructions), so each spread is the magic-mask
// sequence of zorder.spread2/spread3 on one uint64 and the code is written as
// one int64. Each input is first masked with the sequence's first mask word,
// exactly as _spread_words does: 21 bits for z3, all 32 bits for z2. So an
// out-of-width input gives the TPU kernel's answer; a z2 input with bit 31
// set (a negative int32) sets bit 62 or 63 of the code, as it does there.
// Normalized coordinates (21 and 31 bits) never do, so bit 63 stays 0 and
// signed order equals unsigned order: torch.sort sorts the codes directly.
//
// Bound on an H100: bytes. Each row reads 12 B (z3) or 8 B (z2) and writes
// 8 B: at 50M rows 1.0 GB -> 0.30 ms and 0.8 GB -> 0.24 ms at 3.35 TB/s. The
// arithmetic is ~63 (z3) and ~44 (z2) int32 instructions per row
// (chip_smoke.py morton_floor_ops reckons it), below the bytes at the int32
// rate. Design against that bound: one coalesced 4 B load per column and one
// 8 B store per row, a grid-stride loop over enough blocks to fill every SM,
// 64-bit indexing; no shared memory, nothing reused across rows.
//
// Plain C entry points for ctypes; launch on the caller's stream, do not
// synchronise, return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ uint64_t spread3(uint32_t v) {
  uint64_t x = v & 0x00000000001FFFFFull;
  x = (x | (x << 32)) & 0x001F00000000FFFFull;
  x = (x | (x << 16)) & 0x001F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

__device__ __forceinline__ uint64_t spread2(uint32_t v) {
  uint64_t x = v;  // the first mask word, 0x00000000FFFFFFFF, keeps all 32 bits
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  x = (x | (x << 1)) & 0x5555555555555555ull;
  return x;
}

__global__ void __launch_bounds__(THREADS)
z3_encode_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                 const int32_t* __restrict__ t, int64_t n, int64_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const uint64_t z = spread3((uint32_t)x[i]) | (spread3((uint32_t)y[i]) << 1) |
                       (spread3((uint32_t)t[i]) << 2);
    out[i] = (int64_t)z;
  }
}

__global__ void __launch_bounds__(THREADS)
z2_encode_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ y, int64_t n,
                 int64_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    out[i] = (int64_t)(spread2((uint32_t)x[i]) | (spread2((uint32_t)y[i]) << 1));
  }
}

int grid_for(long long n, int sms) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" int geomesa_z3_encode(const void* x, const void* y, const void* t, long long n,
                                 int sms, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  z3_encode_kernel<<<grid_for(n, sms), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, (const int32_t*)t, n, (int64_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int geomesa_z2_encode(const void* x, const void* y, long long n, int sms,
                                 void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  z2_encode_kernel<<<grid_for(n, sms), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (const int32_t*)y, n, (int64_t*)out);
  return (int)cudaGetLastError();
}
