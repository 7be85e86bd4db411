// Fused identity + greedy grouping + S for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   impop_tpu/ops/idgroup.py  identity_group_pallas / _make_kernel
// which runs, per window, the z-Gram identity, the greedy seed peel for R
// masks, the group ids and S, writing sim / present / gid out for the
// statistics that follow (fused_window_stats with return_matrices=True).
//
// Design: three launches on one stream, many blocks per window, through
// the device code the window kernel uses (kernels.cuh, windowstat.cu).
//   pack   idgroup_pack_kernel, one block per (window, 32 rows): each row
//          is bit-packed into 32-site words of alt bits a and valid bits v;
//          the column bitmaps of valid alt and valid ref calls are joined
//          by integer atomics (impop::pack_block, the window kernel's A0).
//   pairs  idgroup_pairs_kernel, one warp per 32 x 32 block of pairs on or
//          above the diagonal (impop::pair_counts, the window kernel's
//          A1): diff = popc(v_i & v_j & (a_i ^ a_j)), present = popc(v_i &
//          v_j) > 0 and both members, sim = 1 - diff / max(length, 1) with
//          IEEE division and subtraction (a per-block table of the same
//          expression for diff <= kTabMax: a division for every pair makes
//          the call 8% slower on an H100 at [512,128]x320,
//          bench/sums_group_variants.py
//          variant notab), link = present & j > i & sim >
//          thr (strict, in f32).  Lane l owns column j, so the block's rows
//          are stored coalesced; a block above the diagonal stages its
//          tile in shared memory and stores the mirror (sim and present are
//          symmetric) row by row as well.  The link words (bits j > i) go
//          to scratch.  The first block of a window also writes S: columns
//          that hold both a valid 0 and a valid 1.
//   walk   seed_peel_kernel (impop::seed_walk, the seed peel's walk): one
//          warp per mask, link words in shared memory (device memory above
//          160 KiB: N = 1152), the next seed by a warp-min over the
//          undecided members, gid written by the same step (N outside the
//          mask; the seeds themselves are not kept).
// Domain: biallelic codes (0 ref, 1 alt, -1 missing), as the TPU kernel's;
// N and S multiples of 32, N at most 32 736 (the pair launch's grid y).
//
// What bounds it on this card: the [N, N] f32 + uint8 writes of sim and
// present (5 bytes per pair); then the pairs' N^2 S / 64 word pairs of two
// popcounts each; the walk is a chain of one step per seed.
//
// The C function returns the first CUDA error of its launches; it never
// synchronises and never allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

using impop::any_present;
using impop::pack_block;
using impop::pair_counts;
using impop::set_smem;
using impop::upper_block;
using impop::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPackRows = 32;      // rows per block of the pack
constexpr int kTabMax = 1024;      // sim table entries beyond d = 0
constexpr int kTileStride = 33;    // floats per staged mirror row
constexpr int kPresStride = 36;    // bytes per staged mirror row

__global__ void __launch_bounds__(kThreads)
idgroup_pack_kernel(const int8_t* __restrict__ geno, const uint8_t* __restrict__ member,
                    const uint8_t* __restrict__ smask, int n, int s, uint32_t* bits,
                    uint32_t* colbits) {
  extern __shared__ uint32_t col_smem[];   // [2, S/32]
  const int w = blockIdx.x, sw = s / 32;
  pack_block(geno + static_cast<size_t>(w) * n * s, smask + static_cast<size_t>(w) * s,
             member + static_cast<size_t>(w) * n, n, s, blockIdx.y * kPackRows, kPackRows,
             bits + static_cast<size_t>(w) * 2 * sw * n, col_smem,
             colbits + static_cast<size_t>(w) * 2 * sw);
}

template <bool kBits>
__global__ void __launch_bounds__(kThreads)
idgroup_pairs_kernel(const uint32_t* __restrict__ bits, const uint32_t* __restrict__ colbits,
                     const uint8_t* __restrict__ member, const float* __restrict__ length,
                     float thr, int n, int s, uint32_t* __restrict__ link_all,
                     float* __restrict__ sim_out, uint8_t* __restrict__ pres_out,
                     float* __restrict__ s_out) {
  extern __shared__ __align__(16) float fsm[];
  const int w = blockIdx.x;
  const int SW = s / 32, NW = n / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tabn = min(s, kTabMax) + 1;
  float* tab = fsm;                                             // [tabn]
  float* ts = fsm + ((tabn + 3) & ~3) + warp * 32 * kTileStride;  // this warp's [32, 33]
  uint8_t* tp = reinterpret_cast<uint8_t*>(fsm + ((tabn + 3) & ~3) + kWarps * 32 * kTileStride) +
                warp * 32 * kPresStride;                        // this warp's [32, 36]
  const float len = fmaxf(length[w], 1.0f);
  for (int d = tid; d < tabn; d += kThreads)
    tab[d] = __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(d), len));
  if (blockIdx.y == 0 && warp == 0) {
    const uint32_t* cb = colbits + static_cast<size_t>(w) * 2 * SW;
    int cnt = 0;
    for (int k = lane; k < SW; k += 32) cnt += __popc(cb[k] & cb[SW + k]);
    cnt = warp_sum(cnt);
    if (lane == 0) s_out[w] = static_cast<float>(cnt);
  }
  __syncthreads();
  const int bp = blockIdx.y * kWarps + warp;
  if (bp >= NW * (NW + 1) / 2) return;
  int iw, jw;
  upper_block(bp, NW, &iw, &jw);
  const int i0 = 32 * iw, j = 32 * jw + lane;
  const uint32_t* abits = bits + static_cast<size_t>(w) * 2 * SW * n;
  const uint32_t* vbits = abits + static_cast<size_t>(SW) * n;
  const uint8_t* mem = member + static_cast<size_t>(w) * n;
  uint32_t* link = link_all + static_cast<size_t>(w) * n * NW;
  float* so = sim_out + static_cast<size_t>(w) * n * n;
  uint8_t* po = pres_out + static_cast<size_t>(w) * n * n;

  typename impop::PresentForm<kBits>::type both;
  int dn[32];
  pair_counts(abits, vbits, n, SW, i0, j, lane, both, dn);
  const bool mj = mem[j] != 0;
  const uint32_t mrows = __ballot_sync(0xffffffffu, mem[i0 + lane] != 0);
#pragma unroll
  for (int ii = 0; ii < 32; ++ii) {
    const int i = i0 + ii;
    const bool mi = (mrows >> ii) & 1u;
    const bool present = i == j ? mi : (any_present(both, ii) && mi && mj);
    float sim = 0.0f;
    if (present)
      sim = i == j ? 1.0f
                   : dn[ii] < tabn ? tab[dn[ii]]
                                   : __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(dn[ii]), len));
    const bool lk = present && j > i && sim > thr;
    so[static_cast<size_t>(i) * n + j] = sim;
    po[static_cast<size_t>(i) * n + j] = present ? 1 : 0;
    const uint32_t lw = __ballot_sync(0xffffffffu, lk);
    if (lane == 0) link[static_cast<size_t>(i) * NW + jw] = lw;
    ts[lane * kTileStride + ii] = sim;
    tp[lane * kPresStride + ii] = present ? 1 : 0;
  }
  if (jw == iw) return;
  // the mirror block: rows j of word jw, columns i of word iw (no links)
  __syncwarp();
  link[static_cast<size_t>(j) * NW + iw] = 0u;
  for (int jj = 0; jj < 32; ++jj) {
    const size_t o = static_cast<size_t>(32 * jw + jj) * n + i0 + lane;
    so[o] = ts[jj * kTileStride + lane];
    po[o] = tp[jj * kPresStride + lane];
  }
}

}  // namespace

extern "C" {

// colbits [w, 2, s/32] must be zero on entry; bits [w, 2, s/32, n] and link
// [w, n, n/32] are scratch; member and pmasks 16-byte aligned.
int impop_identity_group(const void* geno, const void* member, const void* smask,
                         const void* pmasks, const void* length, float thr, int w, int n,
                         int s, int r_count, void* bits, void* colbits, void* link, void* sim,
                         void* present, void* gid, void* s_count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mem = static_cast<const uint8_t*>(member);
  uint32_t* bw = static_cast<uint32_t*>(bits);
  uint32_t* cb = static_cast<uint32_t*>(colbits);
  uint32_t* lk = static_cast<uint32_t*>(link);

  const size_t pack_smem = sizeof(uint32_t) * 2 * (s / 32);
  int err = set_smem(reinterpret_cast<const void*>(idgroup_pack_kernel), pack_smem);
  if (err) return err;
  idgroup_pack_kernel<<<dim3(w, n / kPackRows), kThreads, pack_smem, st>>>(
      static_cast<const int8_t*>(geno), mem, static_cast<const uint8_t*>(smask), n, s, bw, cb);

  const int tabn = (s < kTabMax ? s : kTabMax) + 1;
  const size_t pair_smem = sizeof(float) * (((tabn + 3) & ~3) + kWarps * 32 * kTileStride) +
                           kWarps * 32 * kPresStride;
  const bool bits_form = s <= impop::kBitsMaxSites;
  err = set_smem(bits_form ? reinterpret_cast<const void*>(idgroup_pairs_kernel<true>)
                           : reinterpret_cast<const void*>(idgroup_pairs_kernel<false>),
                 pair_smem);
  if (err) return err;
  const int nw = n / 32, word_blocks = nw * (nw + 1) / 2;
  const dim3 grid(w, (word_blocks + kWarps - 1) / kWarps);
  const float* lens = static_cast<const float*>(length);
  float* so = static_cast<float*>(sim);
  uint8_t* po = static_cast<uint8_t*>(present);
  float* sc = static_cast<float*>(s_count);
  if (bits_form)
    idgroup_pairs_kernel<true><<<grid, kThreads, pair_smem, st>>>(bw, cb, mem, lens, thr, n, s,
                                                                  lk, so, po, sc);
  else
    idgroup_pairs_kernel<false><<<grid, kThreads, pair_smem, st>>>(bw, cb, mem, lens, thr, n, s,
                                                                   lk, so, po, sc);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (r_count == 0) return 0;
  return impop::seed_walk(lk, mem, static_cast<const uint8_t*>(pmasks), w, n, r_count, nullptr,
                          static_cast<int32_t*>(gid), st);
}

}  // extern "C"
