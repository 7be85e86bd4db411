// Device helpers shared by the port's CUDA sources (sm_90a).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace impop {

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

// ---- window identity in bit-packed form (window_stats_kernel phases A0
// and A1, identity_group_kernel's pack and pairs launches).  Rows are
// bit-packed into 32-site words of alt bits (valid and call > 0) and valid
// bits (site_mask & member & call >= 0); biallelic codes.  N and S are
// multiples of 32.

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

// A0 for one block of rows: zero the block's column bitmaps (shared
// memory, [2, S/32]), pack rows [i_lo, i_lo + rows), then OR the bitmaps
// into the window's colbits ([2, S/32] in device memory, zero before the
// launch; integer atomics give the same bits in any order).  Every thread
// of the block calls it (it holds __syncthreads).
__device__ inline void pack_block(const int8_t* __restrict__ geno,
                                  const uint8_t* __restrict__ smask,
                                  const uint8_t* __restrict__ mem, int n, int s, int i_lo,
                                  int rows, uint32_t* abits, uint32_t* col_smem,
                                  uint32_t* colbits) {
  const int sw = s / 32, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x / 32;
  uint32_t* col_alt = col_smem;
  uint32_t* col_ref = col_smem + sw;
  for (int k = tid; k < sw; k += blockDim.x) { col_alt[k] = 0u; col_ref[k] = 0u; }
  __syncthreads();
  pack_rows(geno, smask, mem, n, s, i_lo, rows, abits, abits + static_cast<size_t>(sw) * n,
            col_alt, col_ref, warp, n_warps, lane);
  __syncthreads();
  for (int k = tid; k < sw; k += blockDim.x) {
    if (col_alt[k]) atomicOr(&colbits[k], col_alt[k]);
    if (col_ref[k]) atomicOr(&colbits[sw + k], col_ref[k]);
  }
}

// A1: pair block bp (0 .. nw (nw + 1) / 2 - 1) as word row iw <= word
// column jw, row by row of the upper triangle.
__device__ __forceinline__ void upper_block(int bp, int nw, int* iw, int* jw) {
  int r = 0;
  while (bp >= nw - r) {
    bp -= nw - r;
    ++r;
  }
  *iw = r;
  *jw = r + bp;
}

// A1: whether rows i0 + ii and j share a mutually valid site (present
// needs only > 0), kept as one bit a row (uint32_t: 31 registers fewer,
// the faster form at few site words) or as the OR of the mutually valid
// words of each row (uint32_t[32]: fewer operations a word, the faster form
// at many).  kBitsMaxSites picks the form by the site count.
constexpr int kBitsMaxSites = 512;

__device__ __forceinline__ void or_present(uint32_t& both, uint32_t bw, int ii) {
  both |= static_cast<uint32_t>(bw != 0u) << ii;
}
__device__ __forceinline__ void or_present(uint32_t (&both)[32], uint32_t bw, int ii) {
  both[ii] |= bw;
}
__device__ __forceinline__ bool any_present(uint32_t both, int ii) { return (both >> ii) & 1u; }
__device__ __forceinline__ bool any_present(const uint32_t (&both)[32], int ii) {
  return both[ii] != 0u;
}
__device__ __forceinline__ void clear_present(uint32_t& both) { both = 0u; }
__device__ __forceinline__ void clear_present(uint32_t (&both)[32]) {
#pragma unroll
  for (int ii = 0; ii < 32; ++ii) both[ii] = 0u;
}

// The present form of a pair kernel: PresentForm<true>::type is the bit form.
template <bool kBits>
struct PresentForm {
  using type = uint32_t;
};
template <>
struct PresentForm<false> {
  using type = uint32_t[32];
};

// A1: the counts of the 32 x 32 pair block of rows i0 .. i0 + 31 against
// the lane's column j: `both` (either form above) and dn[ii] = popc of the
// mutually valid differing sites (exact, the reference's (v.v - z.z) / 2).
// The 32 row words of a site word come in one coalesced load and are
// broadcast by shuffles.
template <class Both>
__device__ __forceinline__ void pair_counts(const uint32_t* __restrict__ abits,
                                            const uint32_t* __restrict__ vbits, int n, int sw,
                                            int i0, int j, int lane, Both& both, int (&dn)[32]) {
  clear_present(both);
#pragma unroll
  for (int ii = 0; ii < 32; ++ii) dn[ii] = 0;
  for (int k = 0; k < sw; ++k) {
    const size_t ko = static_cast<size_t>(k) * n;
    const uint32_t a_rows = abits[ko + i0 + lane], v_rows = vbits[ko + i0 + lane];
    const uint32_t aj = abits[ko + j], vj = vbits[ko + j];
#pragma unroll
    for (int ii = 0; ii < 32; ++ii) {
      const uint32_t ai = __shfl_sync(0xffffffffu, a_rows, ii);
      const uint32_t bw = __shfl_sync(0xffffffffu, v_rows, ii) & vj;
      or_present(both, bw, ii);
      dn[ii] += __popc(bw & (ai ^ aj));
    }
  }
}

// ---- the greedy walk of P masks over link words (seed_peel_kernel of
// windowstat.cu; the seed peel and identity_group launch it): seeds
// [b, p_count, n] uint8 (skipped when null) and gid [b, p_count, n] int32
// from link [b, n, n/32] (bits j > i only), member [b, n] and pmasks
// [b, p_count, n], n a multiple of 32, at most 32^3; member and pmasks
// 16-byte aligned.  Returns the launch's error.
int seed_walk(const uint32_t* link, const uint8_t* member, const uint8_t* pmasks, int b,
              int n, int p_count, uint8_t* seeds, int32_t* gid, cudaStream_t st);

// a / b rounded to nearest even, given inv = the correctly rounded 1 / b:
// q = a * inv is within one ulp, r = a - b q is exact in an FMA, and
// q + r * inv rounds to the IEEE quotient (Markstein's theorem; no
// overflow or underflow for a >= 0 and 1 <= b < 2^31 short of a
// denormal quotient).  Bit-identical to __fdiv_rn there, at four
// instructions instead of the division subroutine (the identity
// epilogue's sim and the window kernel's (1 - sim) of a count of
// differing sites over the window length).
__device__ __forceinline__ float div_rn(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  const float r = __fmaf_rn(-q, b, a);
  return __fmaf_rn(r, inv, q);
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace impop
