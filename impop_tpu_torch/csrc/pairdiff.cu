// Weighted (column-mode) identity for Hopper (sm_90a).
//
// Replaces the weighted branch of the Pallas TPU kernel of the JAX package
//   impop_tpu/ops/pairdiff.py  pairwise_identity_pallas(site_weights=...) / _kernel
// for a batch of windows.  With a = call at a valid site (0/1), v = valid
// (call >= 0, member row, active site), c = v - a and per-site weights w:
//
//   diff[i, j]     = sum_s w_s (a_is c_js + c_is a_js)
//   compared[i, j] = sum_s v_is v_js
//   present        = compared > 0 & member_i & member_j
//   sim            = present ? 1 - diff / max(length, 1) : 0
//
// and the member diagonal forced to sim 1, present true.  The JAX package
// runs the same sum in XLA below S = 2048; here one kernel serves every S.
//
// Design: a plain tiled fp32 product over the [N, N] output.  One block
// owns a 64 x 64 output tile of one window; 256 threads each hold a 4 x 4
// micro-tile of both sums in registers.  Sites stream through shared memory
// 16 at a time, decoded from int8 on the way in (a * w, c * w and v for the
// row side, a, c and v for the column side).  fp32 FMA only: the weights
// are indel lengths, which a TF32 or bf16 operand would round.  With
// integer weights whose per-pair sum stays below 2^24 every product and
// partial sum is an exact integer, so the sums equal the plain version's in
// any order, and the epilogue divides with __fdiv_rn / __fsub_rn exactly as
// the reference does (the grouping threshold compares sim with a strict >).
//
// What bounds it on this card: fp32 FMA issue, 3 FMAs per (i, j, site)
// (3 N^2 S per window); the int8 tile is read N / 64 times from L2.
//
// The C function returns cudaGetLastError() after its launch; it never
// synchronises and never allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // output tile edge
constexpr int kTs = 16;            // sites per shared-memory step
constexpr int kPad = kTile + 1;    // row stride of the staged operands

__global__ void __launch_bounds__(kThreads)
weighted_identity_kernel(const int8_t* __restrict__ geno, const uint8_t* __restrict__ member,
                         const uint8_t* __restrict__ smask, const float* __restrict__ weights,
                         const float* __restrict__ length, int n, int s,
                         float* __restrict__ sim_out, uint8_t* __restrict__ pres_out) {
  __shared__ float aw_i[kTs][kPad], cw_i[kTs][kPad], v_i[kTs][kPad];
  __shared__ float a_j[kTs][kPad], c_j[kTs][kPad], v_j[kTs][kPad];

  const int w = blockIdx.z;
  const int ti = blockIdx.y * kTile, tj = blockIdx.x * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int8_t* g = geno + static_cast<size_t>(w) * n * s;
  const uint8_t* mem = member + static_cast<size_t>(w) * n;
  const uint8_t* sm = smask + static_cast<size_t>(w) * s;
  const float* wt = weights + static_cast<size_t>(w) * s;

  float accd[4][4], accc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) { accd[a][b] = 0.0f; accc[a][b] = 0.0f; }

  for (int s0 = 0; s0 < s; s0 += kTs) {
    for (int e = tid; e < kTile * kTs; e += kThreads) {
      const int r = e / kTs, k = e % kTs;
      const int site = s0 + k;
      const bool site_ok = site < s && sm[site];
      const float wv = site < s ? wt[site] : 0.0f;
      float av = 0.0f, vv = 0.0f;
      const int i = ti + r;
      if (site_ok && i < n && mem[i]) {
        const int8_t c = g[static_cast<size_t>(i) * s + site];
        if (c >= 0) { vv = 1.0f; av = static_cast<float>(c); }
      }
      aw_i[k][r] = av * wv;
      cw_i[k][r] = (vv - av) * wv;
      v_i[k][r] = vv;
      av = 0.0f; vv = 0.0f;
      const int j = tj + r;
      if (site_ok && j < n && mem[j]) {
        const int8_t c = g[static_cast<size_t>(j) * s + site];
        if (c >= 0) { vv = 1.0f; av = static_cast<float>(c); }
      }
      a_j[k][r] = av;
      c_j[k][r] = vv - av;
      v_j[k][r] = vv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTs; ++k) {
      float ra[4], rc[4], rv[4], ca[4], cc[4], cv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        ra[m] = aw_i[k][ty + 16 * m];
        rc[m] = cw_i[k][ty + 16 * m];
        rv[m] = v_i[k][ty + 16 * m];
        ca[m] = a_j[k][tx + 16 * m];
        cc[m] = c_j[k][tx + 16 * m];
        cv[m] = v_j[k][tx + 16 * m];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          accd[a][b] = fmaf(ra[a], cc[b], accd[a][b]);
          accd[a][b] = fmaf(rc[a], ca[b], accd[a][b]);
          accc[a][b] = fmaf(rv[a], cv[b], accc[a][b]);
        }
    }
    __syncthreads();
  }

  const float len = fmaxf(length[w], 1.0f);
  float* so = sim_out + static_cast<size_t>(w) * n * n;
  uint8_t* po = pres_out + static_cast<size_t>(w) * n * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti + ty + 16 * a;
    if (i >= n) continue;
    const bool mi = mem[i] != 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tj + tx + 16 * b;
      if (j >= n) continue;
      bool present = accc[a][b] > 0.0f && mi && mem[j] != 0;
      float simv = present ? __fsub_rn(1.0f, __fdiv_rn(accd[a][b], len)) : 0.0f;
      if (i == j && mi) {
        simv = 1.0f;
        present = true;
      }
      so[static_cast<size_t>(i) * n + j] = simv;
      po[static_cast<size_t>(i) * n + j] = present ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

int impop_weighted_identity(const void* geno, const void* member, const void* smask,
                            const void* weights, const void* length, int w, int n, int s,
                            void* sim, void* present, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile, w);
  weighted_identity_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(geno), static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(smask), static_cast<const float*>(weights),
      static_cast<const float*>(length), n, s, static_cast<float*>(sim),
      static_cast<uint8_t*>(present));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
