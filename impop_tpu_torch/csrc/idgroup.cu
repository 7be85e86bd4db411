// Fused identity + greedy grouping + S for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   impop_tpu/ops/idgroup.py  identity_group_pallas / _make_kernel
// which runs, per window, the z-Gram identity, the greedy seed peel for R
// masks, the group ids and S, writing sim / present / gid out for the
// statistics that follow (fused_window_stats with return_matrices=True).
//
// Design: one thread block per window, two phases of window_stats_kernel
// (windowstat.cu), through the device functions both share (kernels.cuh).
//   A  identity.  Rows are bit-packed into 32-site words of alt and valid
//      bits; for a pair (i, j) diff = popc(v_i & v_j & (a_i ^ a_j)) and
//      present = popc(v_i & v_j) > 0 and both members.  sim = 1 - diff /
//      max(length, 1) with IEEE division goes straight to the [N, N] f32
//      output, present to the [N, N] uint8 output, and the link bits
//      (sim > threshold, strict, j > i) to scratch.  A warp covers 32
//      consecutive columns j, so the output rows are written coalesced.
//      S counts columns that hold both a valid 0 and a valid 1.
//   B  grouping.  One warp walks one mask row: the next undecided member is
//      a seed; OR-ing its link row out of the undecided set absorbs its
//      group.  The walk writes gid: the seed's own index at the seed, the
//      same index at every member it absorbs, N for rows outside the mask.
//      A member is absorbed by the earliest seed that links to it, so this
//      equals the reference's gid = min{seed j < i : link(j, i)}.
// Domain: biallelic codes (0 ref, 1 alt, -1 missing), as the TPU kernel's;
// N and S multiples of 32, any size.
//
// What bounds it on this card: phase A's pair loop, N^2 S / 32 word pairs
// of two popcounts each, on one SM per window, and the [N, N] f32 + uint8
// output writes (5 bytes per pair); phase B's dependent chain of link-row
// loads, one per seed.
//
// The C function returns cudaGetLastError() after its launch; it never
// synchronises and never allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

using impop::load_mask_row;
using impop::pack_bits;
using impop::pair_loop;
using impop::peel_row;
using impop::set_smem;
using impop::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
identity_group_kernel(const int8_t* __restrict__ geno, const uint8_t* __restrict__ member,
                      const uint8_t* __restrict__ smask, const uint8_t* __restrict__ pmasks,
                      const float* __restrict__ length, float thr, int n, int s, int r_count,
                      uint32_t* bits, uint32_t* link_all, float* __restrict__ sim_out,
                      uint8_t* __restrict__ pres_out, int32_t* __restrict__ gid_out,
                      float* __restrict__ s_out) {
  extern __shared__ uint32_t smem[];
  const int w = blockIdx.x;
  const int SW = s / 32, NW = n / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* col_alt = smem;                 // [SW]
  uint32_t* col_ref = col_alt + SW;         // [SW]
  uint32_t* todo_all = col_ref + SW;        // [kWarps, NW]

  const int8_t* g = geno + static_cast<size_t>(w) * n * s;
  const uint8_t* mem = member + static_cast<size_t>(w) * n;
  const uint8_t* sm = smask + static_cast<size_t>(w) * s;
  const uint8_t* pm = pmasks + static_cast<size_t>(w) * r_count * n;
  uint32_t* abits = bits + static_cast<size_t>(w) * 2 * SW * n;
  uint32_t* vbits = abits + static_cast<size_t>(SW) * n;
  uint32_t* link = link_all + static_cast<size_t>(w) * n * NW;
  float* so = sim_out + static_cast<size_t>(w) * n * n;
  uint8_t* po = pres_out + static_cast<size_t>(w) * n * n;
  int32_t* gid = gid_out + static_cast<size_t>(w) * r_count * n;
  const float len = fmaxf(length[w], 1.0f);

  for (int k = tid; k < SW; k += kThreads) { col_alt[k] = 0u; col_ref[k] = 0u; }
  __syncthreads();

  // ---- A: bit-pack, S, then sim / present out and the link bits
  pack_bits(g, sm, mem, n, s, abits, vbits, col_alt, col_ref, warp, kWarps, lane);
  __syncthreads();
  if (warp == 0) {
    int cnt = 0;
    for (int k = lane; k < SW; k += 32) cnt += __popc(col_alt[k] & col_ref[k]);
    cnt = warp_sum(cnt);
    if (lane == 0) s_out[w] = static_cast<float>(cnt);
  }
  pair_loop(abits, vbits, mem, n, s, len, thr, warp, kWarps, lane,
            [&](int i, int j, int jw, int, bool present, float sim, bool lk) {
              so[static_cast<size_t>(i) * n + j] = sim;
              po[static_cast<size_t>(i) * n + j] = present ? 1 : 0;
              const uint32_t lw = __ballot_sync(0xffffffffu, lk);
              if (lane == 0) link[static_cast<size_t>(i) * NW + jw] = lw;
            });
  __syncthreads();

  // ---- B: one warp per mask row; gid N outside the mask, then the walk
  uint32_t* todo = todo_all + warp * NW;
  for (int r = warp; r < r_count; r += kWarps) {
    int32_t* grow = gid + static_cast<size_t>(r) * n;
    for (int i = lane; i < n; i += 32) grow[i] = n;
    __syncwarp();
    const int n_r = load_mask_row(pm + static_cast<size_t>(r) * n, mem, NW, todo, lane);
    peel_row(link, NW, todo, n_r, nullptr, nullptr, nullptr, nullptr, grow, lane);
  }
}

}  // namespace

extern "C" {

int impop_identity_group(const void* geno, const void* member, const void* smask,
                         const void* pmasks, const void* length, float thr, int w, int n,
                         int s, int r_count, void* bits, void* link, void* sim,
                         void* present, void* gid, void* s_count, void* stream) {
  const size_t smem = sizeof(uint32_t) * (2 * (s / 32) + kWarps * (n / 32));
  const int err = set_smem(reinterpret_cast<const void*>(identity_group_kernel), smem);
  if (err) return err;
  identity_group_kernel<<<w, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(geno), static_cast<const uint8_t*>(member),
      static_cast<const uint8_t*>(smask), static_cast<const uint8_t*>(pmasks),
      static_cast<const float*>(length), thr, n, s, r_count, static_cast<uint32_t*>(bits),
      static_cast<uint32_t*>(link), static_cast<float*>(sim), static_cast<uint8_t*>(present),
      static_cast<int32_t*>(gid), static_cast<float*>(s_count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
