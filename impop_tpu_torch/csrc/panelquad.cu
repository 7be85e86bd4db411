// Masked panel sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   impop_tpu/ops/panelquad.py  masked_pair_sums_pallas / _kernel
// for a batch of windows:
//
//   Yd = Wd . ((1 - sim) . mask),   Yp = Wp . mask,   mask = present & offdiag
//
// with sim [W, N, N] f32, present [W, N, N] uint8, Wd [W, Rd, N], Wp
// [W, Rp, N] f32.  It serves the weighted (column-mode) scan, whose
// identity matrix comes from the weighted identity kernel instead of the
// whole-window kernel.
//
// Design: the product loop of the whole-window kernel's phase C
// (impop::group_products), now reading sim / present from device memory.
// One block computes 16 rows of Yd or Yp for 256 columns; the grid's x axis
// walks (row group, column chunk) of one window and its y axis the windows,
// so the blocks that re-read one window's [N, N] matrices run together and
// hit L2.  fp32 FMA only: (1 - sim) carries real values, so no TF32 or bf16.
//
// What bounds it on this card: the N^2 reads of sim / present per block
// (5 bytes each), once per 16-row group of each stack; the FMAs are 16 per
// element read.
//
// The C function returns cudaGetLastError() after its launch; it never
// synchronises and never allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

using impop::group_products;
using impop::kGroup;
using impop::kTileI;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
masked_pair_sums_kernel(const float* __restrict__ sim, const uint8_t* __restrict__ present,
                        const float* __restrict__ wd, const float* __restrict__ wp,
                        int n, int rd, int rp, float* __restrict__ yd,
                        float* __restrict__ yp) {
  __shared__ float xs[kGroup * kTileI];
  const int w = blockIdx.y;
  const int n_chunks = (n + kThreads - 1) / kThreads;
  const int gd = (rd + kGroup - 1) / kGroup;
  const int g = blockIdx.x / n_chunks;
  const int j0 = (blockIdx.x % n_chunks) * kThreads;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* sm = sim + static_cast<size_t>(w) * nn;
  const uint8_t* pr = present + static_cast<size_t>(w) * nn;

  if (g < gd) {
    auto div = [&](int i, int j) -> float {
      const size_t e = static_cast<size_t>(i) * n + j;
      return (pr[e] && i != j) ? __fsub_rn(1.0f, sm[e]) : 0.0f;
    };
    group_products<kThreads>(wd + static_cast<size_t>(w) * rd * n, n, rd, g * kGroup, j0, xs,
                             yd + static_cast<size_t>(w) * rd * n, div);
  } else {
    auto mask = [&](int i, int j) -> float {
      const size_t e = static_cast<size_t>(i) * n + j;
      return (pr[e] && i != j) ? 1.0f : 0.0f;
    };
    group_products<kThreads>(wp + static_cast<size_t>(w) * rp * n, n, rp, (g - gd) * kGroup,
                             j0, xs, yp + static_cast<size_t>(w) * rp * n, mask);
  }
}

}  // namespace

extern "C" {

int impop_masked_pair_sums(const void* sim, const void* present, const void* wd,
                           const void* wp, int w, int n, int rd, int rp, void* yd,
                           void* yp, void* stream) {
  const int n_chunks = (n + kThreads - 1) / kThreads;
  const int groups = (rd + kGroup - 1) / kGroup + (rp + kGroup - 1) / kGroup;
  const dim3 grid(groups * n_chunks, w);
  masked_pair_sums_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sim), static_cast<const uint8_t*>(present),
      static_cast<const float*>(wd), static_cast<const float*>(wp), n, rd, rp,
      static_cast<float*>(yd), static_cast<float*>(yp));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
