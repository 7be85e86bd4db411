// EHH death sites and per-allele step sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   impop_tpu/ops/ehhdeath.py  ehh_area_pallas / _make_kernel
// and the compaction and carrier selection around it
// (impop_tpu/stats/ehh.py ehh_area_dynamic), for a batch of windows.
//
// Per window, with xb = (call == 1) at active sites:
//   - the active sites are compacted by rank; fi = number of active sites
//     left of the focal column, n_act = number of active sites;
//   - carriers of allele a are members whose raw focal call binarises to a;
//   - for every pair i < j of carriers of one allele, death_r is the first
//     rank > fi where xb differs (else n_act) and death_l the last rank
//     < fi where it differs (else -1);
//     steps = max(min(death_r, n_act) - fi - 1, 0) + max(fi - 1 - death_l, 0);
//   - out: sums[w, a] = sum of steps over the carrier pairs of allele a
//     (int64: C(N, 2) * S passes 2^24 at N = 512, S = 128), and the
//     carrier counts carr[w, a].
//
// Design (one block of 256 threads per window).  The TPU kernel decodes
// the death ranks from the f32 exponents of bit-weighted bf16 Grams,
// because Mosaic has no bit scan; on Hopper the direct exact form is
// cheap.  Phase 1 ballots the site mask into 32-site words, prefix-sums
// their popcounts into per-word base ranks, and compacts each haplotype
// row (one warp per row) into 64-bit words of xb by rank, with atomicOr
// into a per-warp row buffer in shared memory; the packed rows go to a
// [SW64, N] scratch in device memory (the wrapper allocates it), word-major
// so that a warp reading 32 rows j of one word is coalesced.  Phase 2 walks
// the pairs (one warp per row i, lanes over j): XOR the two rows' words and
// find the first set bit above fi with __ffsll and the last below fi with
// __clzll, reading only as many words as it takes.  Steps accumulate per
// thread in 64-bit integers and meet in shared-memory atomics.
//
// What bounds it on this card: phase 2's C(N, 2) pair walks, a few
// L1-resident 64-bit loads each; phase 1 reads the int8 tile once.
//
// The C function returns cudaGetLastError() after its launch; it never
// synchronises and never allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

using impop::set_smem;
using impop::warp_sum_u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr uint8_t kNoAllele = 255;

size_t ehh_smem_bytes(int n, int s) {
  const int sw = (s + 31) / 32, sw64 = (s + 63) / 64;
  return sizeof(unsigned long long) * kWarps * sw64 + 2 * sizeof(uint32_t) * sw +
         static_cast<size_t>(n);
}

// xc is written in phase 1 and read in phase 2 of the same launch, so it is
// deliberately not __restrict__ (no read-only cache path for it).
__global__ void __launch_bounds__(kThreads)
ehh_area_kernel(const int8_t* __restrict__ geno, const uint8_t* __restrict__ member,
                const uint8_t* __restrict__ smask, const int32_t* __restrict__ focal,
                int n, int s, unsigned long long* xc_all, long long* __restrict__ sums,
                int32_t* __restrict__ carr) {
  extern __shared__ unsigned long long smem64[];
  __shared__ unsigned long long s_sum[2];
  __shared__ int s_carr[2];
  __shared__ int s_fi, s_nact;

  const int w = blockIdx.x;
  const int SW = (s + 31) / 32, SW64 = (s + 63) / 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* rowbuf = smem64;                                   // [kWarps, SW64]
  uint32_t* act = reinterpret_cast<uint32_t*>(rowbuf + kWarps * SW64);  // [SW]
  int* base = reinterpret_cast<int*>(act + SW);                         // [SW]
  uint8_t* allele = reinterpret_cast<uint8_t*>(base + SW);              // [n]

  const int8_t* g = geno + static_cast<size_t>(w) * n * s;
  const uint8_t* mem = member + static_cast<size_t>(w) * n;
  const uint8_t* sm = smask + static_cast<size_t>(w) * s;
  unsigned long long* xc = xc_all + static_cast<size_t>(w) * SW64 * n;
  const int f = focal[w];

  // ---- ranks: active-site words, their base ranks, fi and n_act
  for (int k = warp; k < SW; k += kWarps) {
    const int site = 32 * k + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, site < s && sm[site]);
    if (lane == 0) act[k] = word;
  }
  for (int e = tid; e < kWarps * SW64; e += kThreads) rowbuf[e] = 0ull;
  if (tid < 2) {
    s_sum[tid] = 0ull;
    s_carr[tid] = 0;
  }
  __syncthreads();
  if (warp == 0) {
    int run = 0;
    for (int k0 = 0; k0 < SW; k0 += 32) {
      const int k = k0 + lane;
      const int c = k < SW ? __popc(act[k]) : 0;
      int x = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (k < SW) base[k] = run + x - c;
      run += __shfl_sync(0xffffffffu, x, 31);
    }
    __syncwarp();
    if (lane == 0) {
      int fi = 0;
      if (f >= s) {
        fi = run;
      } else if (f > 0) {
        const int kf = f >> 5, b = f & 31;
        fi = base[kf] + __popc(act[kf] & ((1u << b) - 1u));
      }
      s_fi = fi;
      s_nact = run;
    }
  }
  __syncthreads();
  const int fi = s_fi, n_act = s_nact;

  // ---- phase 1: compact each row by rank; carrier allele per member
  unsigned long long* rb = rowbuf + warp * SW64;
  for (int i = warp; i < n; i += kWarps) {
    const int8_t* gi = g + static_cast<size_t>(i) * s;
    for (int k = 0; k < SW; ++k) {
      const int site = 32 * k + lane;
      const uint32_t aw = act[k];
      if (site < s && ((aw >> lane) & 1u) && gi[site] == 1) {
        const int r = base[k] + __popc(aw & ((1u << lane) - 1u));
        atomicOr(&rb[r >> 6], 1ull << (r & 63));
      }
    }
    __syncwarp();
    for (int k = lane; k < SW64; k += 32) {
      xc[static_cast<size_t>(k) * n + i] = rb[k];
      rb[k] = 0ull;
    }
    __syncwarp();
    if (lane == 0) {
      uint8_t a = kNoAllele;
      if (mem[i]) {
        a = (f >= 0 && f < s && gi[f] == 1) ? 1 : 0;
        atomicAdd(&s_carr[a], 1);
      }
      allele[i] = a;
    }
  }
  __syncthreads();

  // ---- phase 2: death ranks and steps for every same-allele carrier pair
  unsigned long long acc0 = 0ull, acc1 = 0ull;
  const int kr0 = (fi + 1) >> 6;          // word of the first rank right of fi
  const int kl0 = (fi - 1) >> 6;          // word of the last rank left of fi
  const int bl0 = (fi - 1) & 63;
  for (int i = warp; i < n; i += kWarps) {
    const uint8_t ai = allele[i];
    if (ai == kNoAllele) continue;
    for (int j = i + 1 + lane; j < n; j += 32) {
      if (allele[j] != ai) continue;
      int death_r = n_act;
      for (int k = kr0; 64 * k < n_act; ++k) {
        unsigned long long d = xc[static_cast<size_t>(k) * n + i] ^ xc[static_cast<size_t>(k) * n + j];
        if (k == kr0) d &= ~0ull << ((fi + 1) & 63);
        if (d) {
          death_r = min(64 * k + __ffsll(static_cast<long long>(d)) - 1, n_act);
          break;
        }
      }
      int death_l = -1;
      if (fi >= 1) {
        for (int k = kl0; k >= 0; --k) {
          unsigned long long d = xc[static_cast<size_t>(k) * n + i] ^ xc[static_cast<size_t>(k) * n + j];
          if (k == kl0 && bl0 < 63) d &= (2ull << bl0) - 1ull;
          if (d) {
            death_l = 64 * k + 63 - __clzll(static_cast<long long>(d));
            break;
          }
        }
      }
      const unsigned long long steps =
          static_cast<unsigned long long>(max(death_r - fi - 1, 0) + max(fi - 1 - death_l, 0));
      if (ai) acc1 += steps; else acc0 += steps;
    }
  }
  acc0 = warp_sum_u64(acc0);
  acc1 = warp_sum_u64(acc1);
  if (lane == 0) {
    atomicAdd(&s_sum[0], acc0);
    atomicAdd(&s_sum[1], acc1);
  }
  __syncthreads();
  if (tid == 0) {
    sums[2 * w] = static_cast<long long>(s_sum[0]);
    sums[2 * w + 1] = static_cast<long long>(s_sum[1]);
    carr[2 * w] = s_carr[0];
    carr[2 * w + 1] = s_carr[1];
  }
}

}  // namespace

extern "C" {

int impop_ehh_area(const void* geno, const void* member, const void* smask, const void* focal,
                   int w, int n, int s, void* xc, void* sums, void* carr, void* stream) {
  const size_t smem = ehh_smem_bytes(n, s);
  const int err = set_smem(reinterpret_cast<const void*>(ehh_area_kernel), smem);
  if (err) return err;
  ehh_area_kernel<<<w, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(geno), static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(smask), static_cast<const int32_t*>(focal), n, s,
      static_cast<unsigned long long*>(xc), static_cast<long long*>(sums),
      static_cast<int32_t*>(carr));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
