// Device helpers shared by the port's CUDA sources (sm_90a).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace impop {

constexpr int kGroup = 16;      // X/Y rows per stacked-product pass
constexpr int kTileI = 128;     // X columns staged in shared memory per step

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_sumf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum_u64(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stacked row products for one group of kGroup rows and one chunk of
// blockDim.x (= kThreads) columns starting at j0:
//
//   y[g0 + rr, j] = sum_i x[g0 + rr, i] * elem(i, j)      (i ascending)
//
// in fp32 FMA (no TF32, no bf16: callers pass value-carrying (1 - sim)
// entries).  x and y are [x_rows, n] row-major; rows at or past x_rows read
// as zero and are not written.  xs is a kGroup * kTileI float staging tile
// in shared memory.  Every thread of the block must call it (it holds
// __syncthreads).
template <int kThreads, class Elem>
__device__ __forceinline__ void group_products(const float* __restrict__ x, int n,
                                               int x_rows, int g0, int j0, float* xs,
                                               float* __restrict__ y, Elem elem) {
  const int tid = threadIdx.x;
  const int j = j0 + tid;
  const bool active = j < n;
  float acc[kGroup];
#pragma unroll
  for (int rr = 0; rr < kGroup; ++rr) acc[rr] = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kTileI) {
    const int iend = min(kTileI, n - i0);
    __syncthreads();
    for (int e = tid; e < kGroup * kTileI; e += kThreads) {
      const int rr = e / kTileI, ii = e % kTileI;
      xs[e] = (ii < iend && g0 + rr < x_rows)
                  ? x[static_cast<size_t>(g0 + rr) * n + i0 + ii] : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int ii = 0; ii < iend; ++ii) {
      const float v = elem(i0 + ii, j);
#pragma unroll
      for (int rr = 0; rr < kGroup; ++rr) acc[rr] = fmaf(xs[rr * kTileI + ii], v, acc[rr]);
    }
  }
  if (active) {
#pragma unroll
    for (int rr = 0; rr < kGroup; ++rr)
      if (g0 + rr < x_rows) y[static_cast<size_t>(g0 + rr) * n + j] = acc[rr];
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace impop
