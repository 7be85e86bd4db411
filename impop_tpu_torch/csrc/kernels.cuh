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

// ---- window identity in bit-packed form (window_stats_kernel phase A0,
// identity_group_kernel phase A).  Rows are bit-packed into 32-site words of alt
// bits (valid and call > 0) and valid bits (site_mask & member & call >= 0);
// biallelic codes.  N and S are multiples of 32.

// A0: the alt / valid words of rows [i_lo, i_lo + rows) ([S/32, N] each,
// word-major) and the column bitmaps of valid alt and valid ref calls over
// those rows (OR-ed in with shared-memory atomics).  Every warp of the
// block calls it; col_alt / col_ref must be zero before the first call.
__device__ inline void pack_rows(const int8_t* __restrict__ geno,
                                 const uint8_t* __restrict__ smask,
                                 const uint8_t* __restrict__ mem, int n, int s, int i_lo,
                                 int rows, uint32_t* abits, uint32_t* vbits, uint32_t* col_alt,
                                 uint32_t* col_ref, int warp, int n_warps, int lane) {
  const int sw = s / 32;
  for (int item = warp; item < rows * sw; item += n_warps) {
    const int i = i_lo + item / sw, k = item % sw;
    const int site = 32 * k + lane;
    const int8_t g = geno[static_cast<size_t>(i) * s + site];
    const bool valid = g >= 0 && smask[site] && mem[i];
    const uint32_t av = __ballot_sync(0xffffffffu, valid && g > 0);
    const uint32_t vv = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) {
      abits[static_cast<size_t>(k) * n + i] = av;
      vbits[static_cast<size_t>(k) * n + i] = vv;
      atomicOr(&col_alt[k], av);
      atomicOr(&col_ref[k], vv & ~av);
    }
  }
}

// A0 over every row.
__device__ inline void pack_bits(const int8_t* __restrict__ geno,
                                 const uint8_t* __restrict__ smask,
                                 const uint8_t* __restrict__ mem, int n, int s,
                                 uint32_t* abits, uint32_t* vbits, uint32_t* col_alt,
                                 uint32_t* col_ref, int warp, int n_warps, int lane) {
  pack_rows(geno, smask, mem, n, s, 0, n, abits, vbits, col_alt, col_ref, warp, n_warps, lane);
}

// A1: every pair (i, j), one warp per (i, 32 consecutive j).  For each pair
// every lane calls emit(i, j, jw, diff_n, present, sim, link) with
//   diff_n  = mutually valid sites that differ (the reference's
//             (v.v - z.z) / 2),
//   present = i == j ? member_i : mutual valid sites > 0 & both members,
//   sim     = 1 - diff_n / len (IEEE division) where present off the
//             diagonal, 1 on the present diagonal, 0 elsewhere,
//   link    = present & j > i & sim > thr (strict, in f32),
// so emit may ballot (all 32 lanes call it together).
template <class Emit>
__device__ inline void pair_loop(const uint32_t* __restrict__ abits,
                                 const uint32_t* __restrict__ vbits,
                                 const uint8_t* __restrict__ mem, int n, int s, float len,
                                 float thr, int warp, int n_warps, int lane, Emit emit) {
  const int sw = s / 32, nw = n / 32;
  for (int item = warp; item < n * nw; item += n_warps) {
    const int i = item / nw, jw = item % nw;
    const int j = 32 * jw + lane;
    int both_n = 0, diff_n = 0;
    for (int k = 0; k < sw; ++k) {
      const size_t ko = static_cast<size_t>(k) * n;
      const uint32_t both = vbits[ko + i] & vbits[ko + j];
      both_n += __popc(both);
      diff_n += __popc(both & (abits[ko + i] ^ abits[ko + j]));
    }
    const bool mi = mem[i] != 0, mj = mem[j] != 0;
    const bool present = (i == j) ? mi : (both_n > 0 && mi && mj);
    float sim = 0.0f;
    if (present) {
      sim = (i == j) ? 1.0f
                     : __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(diff_n), len));
    }
    const bool link = present && j > i && sim > thr;
    emit(i, j, jw, diff_n, present, sim, link);
  }
}

// ---- greedy grouping (window_stats_kernel phase B, seed_peel_kernel,
// identity_group_kernel)

// Loads mask row `row` (& member) into todo ([nw] words of one warp);
// returns its member count.
__device__ inline int load_mask_row(const uint8_t* __restrict__ row,
                                    const uint8_t* __restrict__ mem, int nw,
                                    uint32_t* todo, int lane) {
  int n_r = 0;
  for (int k = 0; k < nw; ++k) {
    const int i = 32 * k + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, row[i] && mem[i]);
    if (lane == 0) todo[k] = word;
    n_r += __popc(word);
  }
  __syncwarp();
  return n_r;
}

// Greedy seed walk of one mask row by one warp: the next undecided member
// is a seed and absorbs the undecided members its link row (bits j > i
// only) reaches.  todo holds the mask's member bits on entry.  For each
// seed i: wrow[i] = size / max(n_r, 1) (if wrow), seedrow[i] = 1 (if
// seedrow), seed_out[i] = 1 (if seed_out), bit i of any_bits (if any_bits),
// and gid_out[i] = i and gid_out[m] = i for every member m it absorbs (if
// gid_out).  Returns the number of seeds.
__device__ inline int peel_row(const uint32_t* __restrict__ link, int nw, uint32_t* todo,
                               int n_r, float* wrow, float* seedrow, uint8_t* seed_out,
                               uint32_t* any_bits, int32_t* gid_out, int lane) {
  const float denom = fmaxf(static_cast<float>(n_r), 1.0f);
  int groups = 0;
  for (int k = 0; k < nw; ++k) {
    while (true) {
      const uint32_t cand = todo[k];
      __syncwarp();
      if (cand == 0u) break;
      const int b = __ffs(cand) - 1;
      const int i = 32 * k + b;
      int absorbed = 0;
      // link row i holds bits j > i only: words before k are empty
      for (int k2 = k + lane; k2 < nw; k2 += 32) {
        uint32_t t = todo[k2];
        if (k2 == k) t &= ~(1u << b);
        const uint32_t lk = link[static_cast<size_t>(i) * nw + k2];
        const uint32_t took = lk & t;
        absorbed += __popc(took);
        todo[k2] = t & ~lk;
        if (gid_out)
          for (uint32_t m = took; m; m &= m - 1u) gid_out[32 * k2 + __ffs(m) - 1] = i;
      }
      absorbed = warp_sum(absorbed);
      if (lane == 0) {
        if (wrow) wrow[i] = __fdiv_rn(static_cast<float>(absorbed + 1), denom);
        if (seedrow) seedrow[i] = 1.0f;
        if (seed_out) seed_out[i] = 1;
        if (any_bits) atomicOr(&any_bits[k], 1u << b);
        if (gid_out) gid_out[i] = i;
      }
      ++groups;
      __syncwarp();
    }
  }
  return groups;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace impop
