// Identity from allele tiles for Hopper (sm_90a), two kernels.
//
// pairwise_identity_kernel: unit weights.  Replaces the unit-weight Pallas
// TPU kernels of the JAX package, which compute one function on three TPU
// schedules:
//   impop_tpu/ops/pairdiff.py  pairwise_identity_pallas / _make_kernel_tri_resident
//                              (N <= 512, operand column resident in VMEM)
//   impop_tpu/ops/pairdiff.py  pairwise_identity_pallas / _kernel_tri
//                              (N > 512, streamed tile pairs)
//   impop_tpu/ops/pairdiff.py  _pairwise_identity_pallas_i8 / _kernel_i8
//                              (the same Grams on int8 operands)
// With v = valid (call >= 0, member row, active site) and z = 2 max(g, 0) - v
// (the int8 operands of pairdiff.py:532-535):
//
//   compared[i, j] = sum_s v_is v_js,   zz[i, j] = sum_s z_is z_js
//   diff           = (compared - zz) / 2
//   present        = compared > 0 & member_i & member_j
//   sim            = present ? 1 - diff / max(length, 1) : 0
//
// and the member diagonal forced to sim 1, present true.  For any code g the
// z-Gram equals the reference CPU path's x(v - x)^T + (v - x)x^T, so codes
// above 1 agree too; the int32 sums are exact for every int8 code whose z
// still fits int8 (g <= 63), the same domain as the reference's int8 path.
//
// Design: one block per (window, 64 x 64 output tile pair ti <= tj); it
// writes the (i, j) cells and, off the diagonal, the mirrored (j, i) cells,
// so the lower triangle is never computed.  Sites stream through shared
// memory 64 at a time: each row's z and v are decoded from the int8 tile
// (masks applied) and packed four sites to a 32-bit word.  256 threads each
// hold a 4 x 4 register tile of both int32 sums and run __dp4a on packed
// site quads: 2 dp4a per (i, j, 4 sites).  The epilogue divides with
// __fdiv_rn / __fsub_rn exactly as the reference does.
//
// What bounds it on this card: integer instruction rate, N^2 S / 4 dp4a per window
// (half that with the triangle), plus the per-row decode, which every tile
// pair repeats (N / 64 times per row).  The int8 tensor cores would run the
// same exact Grams at about 30x the dp4a rate: a later kernel would decode
// z and v once into device memory and feed mma.sync / wgmma s8 tiles
// through TMA, leaving the epilogue as it is.
//
// weighted_identity_kernel: column-mode weights.  Replaces the weighted
// branch of the Pallas TPU kernel of the JAX package
//   impop_tpu/ops/pairdiff.py  pairwise_identity_pallas(site_weights=...) / _kernel
// for a batch of windows.  With a = call at a valid site (0/1), c = v - a
// and per-site weights w:
//
//   diff[i, j]     = sum_s w_s (a_is c_js + c_is a_js)
//   compared[i, j] = sum_s v_is v_js
//
// and the same epilogue.  The JAX package runs the same sum in XLA below
// S = 2048; here one kernel serves every S.
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
// What bounds it on this card: fp32 FMA rate, 3 FMAs per (i, j, site)
// (3 N^2 S per window); the int8 tile is read N / 64 times from L2.
//
// The C functions return cudaGetLastError() after their launch; they never
// synchronise and never allocate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // output tile edge
constexpr int kTs = 16;            // sites per shared-memory step
constexpr int kPad = kTile + 1;    // row stride of the staged operands

constexpr int kUWords = 16;        // packed 4-site words per stage (64 sites)

// z and v of four consecutive sites of one row, packed one byte per site.
__device__ __forceinline__ void pack_quad(const int8_t* __restrict__ g,
                                          const uint8_t* __restrict__ mem,
                                          const uint8_t* __restrict__ sm, int row,
                                          int site0, int n, int s, int& zw, int& vw) {
  uint32_t z = 0u, v = 0u;
  if (row < n && mem[row]) {
    const int8_t* gr = g + static_cast<size_t>(row) * s;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int site = site0 + q;
      if (site < s && sm[site]) {
        const int c = gr[site];
        if (c >= 0) {
          v |= 1u << (8 * q);
          z |= static_cast<uint32_t>(static_cast<uint8_t>(2 * c - 1)) << (8 * q);
        }
      }
    }
  }
  zw = static_cast<int>(z);
  vw = static_cast<int>(v);
}

__global__ void __launch_bounds__(kThreads)
pairwise_identity_kernel(const int8_t* __restrict__ geno, const uint8_t* __restrict__ member,
                         const uint8_t* __restrict__ smask, const float* __restrict__ length,
                         int n, int s, int t_blocks, float* __restrict__ sim_out,
                         uint8_t* __restrict__ pres_out) {
  __shared__ int z_i[kUWords][kPad], v_i[kUWords][kPad];
  __shared__ int z_j[kUWords][kPad], v_j[kUWords][kPad];

  const int w = blockIdx.y;
  int p = blockIdx.x, ti = 0;
  while (p >= t_blocks - ti) {
    p -= t_blocks - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int8_t* g = geno + static_cast<size_t>(w) * n * s;
  const uint8_t* mem = member + static_cast<size_t>(w) * n;
  const uint8_t* sm = smask + static_cast<size_t>(w) * s;

  int accz[4][4], accv[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) { accz[a][b] = 0; accv[a][b] = 0; }

  for (int s0 = 0; s0 < s; s0 += 4 * kUWords) {
    for (int e = tid; e < kTile * kUWords; e += kThreads) {
      const int r = e / kUWords, k = e % kUWords;
      pack_quad(g, mem, sm, i0 + r, s0 + 4 * k, n, s, z_i[k][r], v_i[k][r]);
      pack_quad(g, mem, sm, j0 + r, s0 + 4 * k, n, s, z_j[k][r], v_j[k][r]);
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kUWords; ++k) {
      int rz[4], rv[4], cz[4], cv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        rz[m] = z_i[k][ty + 16 * m];
        rv[m] = v_i[k][ty + 16 * m];
        cz[m] = z_j[k][tx + 16 * m];
        cv[m] = v_j[k][tx + 16 * m];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          accz[a][b] = __dp4a(rz[a], cz[b], accz[a][b]);
          accv[a][b] = __dp4a(rv[a], cv[b], accv[a][b]);
        }
    }
    __syncthreads();
  }

  const float len = fmaxf(length[w], 1.0f);
  float* so = sim_out + static_cast<size_t>(w) * n * n;
  uint8_t* po = pres_out + static_cast<size_t>(w) * n * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= n) continue;
    const bool mi = mem[i] != 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      if (j >= n) continue;
      bool present = accv[a][b] > 0 && mi && mem[j] != 0;
      const float diff = static_cast<float>((accv[a][b] - accz[a][b]) / 2);
      float simv = present ? __fsub_rn(1.0f, __fdiv_rn(diff, len)) : 0.0f;
      if (i == j && mi) {
        simv = 1.0f;
        present = true;
      }
      so[static_cast<size_t>(i) * n + j] = simv;
      po[static_cast<size_t>(i) * n + j] = present ? 1 : 0;
      if (ti != tj) {
        so[static_cast<size_t>(j) * n + i] = simv;
        po[static_cast<size_t>(j) * n + i] = present ? 1 : 0;
      }
    }
  }
}

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

int impop_pairwise_identity(const void* geno, const void* member, const void* smask,
                            const void* length, int w, int n, int s, void* sim,
                            void* present, void* stream) {
  const int t_blocks = (n + kTile - 1) / kTile;
  const dim3 grid(t_blocks * (t_blocks + 1) / 2, w);
  pairwise_identity_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(geno), static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(smask), static_cast<const float*>(length), n, s, t_blocks,
      static_cast<float*>(sim), static_cast<uint8_t*>(present));
  return static_cast<int>(cudaGetLastError());
}

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
