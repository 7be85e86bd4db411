// Whole-window panel statistics and greedy seed peel for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   impop_tpu/ops/windowstat.py  window_stats_pallas / _make_kernel
//     (identity, S, greedy grouping, group weights, every panel and pair
//      reduction, seed_risk -- one program per window)
//   impop_tpu/ops/seedpeel.py    seed_peel_pallas / _kernel
//     (greedy seed flags for P masks from a given sim / present)
//
// Design: one thread block per window, four phases.
//   A  identity.  Each haplotype row is bit-packed into 32-site words of
//      alt bits a and valid bits v (site_mask & member & call >= 0).  For a
//      pair (i, j): diff = popc(v_i & v_j & (a_i ^ a_j)) (exact, equal to
//      the reference's (v.v - z.z) / 2), present = popc(v_i & v_j) > 0 and
//      both members.  sim = 1 - diff / max(length, 1) is computed with IEEE
//      division and compared with a strict > against the f32 threshold, so
//      every link decision is bit-identical to the reference.  A warp
//      covers 32 consecutive columns j, so __ballot_sync yields the packed
//      present and link words directly.  S counts columns that hold both a
//      valid 0 and a valid 1.  The loop runs over site words, so any site
//      capacity works (the TPU kernel's S <= 2048 bound was its VMEM).
//   B  grouping.  The greedy recurrence is a sequential walk in row order;
//      the TPU turned it into a frontier-peel fixpoint only because Mosaic
//      has no cheap scalar loop.  Here one warp walks one mask row: the
//      next undecided member of the mask is a seed, and OR-ing its link row
//      (bits j > i) out of the undecided set absorbs its group.  The group
//      size is 1 + the popcount of what it absorbed, so the weight
//      w = size / max(n, 1) is written at the seed without a histogram.
//   C  reductions.  Y = X . M for the stacked rows X = [w; mask_a; mask_b]
//      against div = (1 - sim) . offdiag . present, and X = [seeds; mask_a;
//      mask_b] against the 0/1 mask, in full fp32 FMA (no TF32, no bf16:
//      these values are not exact in a narrower type).  (1 - sim) comes
//      from a per-window table indexed by the integer diff, rounded
//      exactly as the reference rounds it.  The product loop is
//      impop::group_products (kernels.cuh), shared with panelquad.cu.
//   D  row-dots.  Every output is a dot of one Y row with one X row; the
//      host passes the (Y row, X row, output column) triples as an int32
//      array, so pair indices are data, not template constants.  Then
//      seed_risk: any two seeds (over every mask row) without data.
//
// Memory: the [N, N] working set (1 MiB of f32 per window at N = 512) does
// not fit one block's 227 KB of shared memory, so per-window scratch lives
// in device memory the wrapper allocates: diff as uint16 (512 KiB at
// N = 512), bit-packed present and link (32 KiB each), and the X / Y row
// stacks.  Shared memory holds the (1 - sim) table, a staged X tile, the
// column bitmaps and the per-warp undecided sets.
//
// What bounds it on this card: phase C, N^2 x (rows) fp32 FMAs reading the
// uint16 diff once per 16-row group (from L2 after phase A wrote it); and
// phase B's dependent chain of link-row loads, one per seed.
//
// The C functions return cudaGetLastError() after their launch; they never
// synchronise and never allocate.

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

using impop::group_products;
using impop::kGroup;
using impop::kTileI;
using impop::load_mask_row;
using impop::pack_bits;
using impop::pair_loop;
using impop::peel_row;
using impop::set_smem;
using impop::warp_sum;
using impop::warp_sumf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTabMax = 4096;   // (1 - sim) table entries beyond d = 0

struct WinParams {
  const int8_t* geno;      // [W, N, S]
  const uint8_t* member;   // [W, N]
  const uint8_t* smask;    // [W, S]
  const uint8_t* pm;       // [W, R, N] grouping mask stack
  const uint8_t* ma;       // [W, Q, N] stripped Hudson side A
  const uint8_t* mb;       // [W, Q, N] stripped Hudson side B
  const float* length;     // [W]
  const int32_t* dots;     // [T, 3] (Y row, X row, output column)
  float thr;
  int n, s, r, pq, q, t;
  int rd, rp;              // padded row counts of the two stacks
  int n_out;
  uint32_t* bits;          // [W, 2, S/32, N]  alt words, then valid words
  uint32_t* pres;          // [W, N, N/32]
  uint32_t* link;          // [W, N, N/32]   bits j > i only
  uint16_t* diff;          // [W, N, N]
  float* x;                // [W, rd + rp, N]
  float* y;                // [W, rd + rp, N]
  float* out;              // [W, n_out]
};

__global__ void __launch_bounds__(kThreads)
window_stats_kernel(WinParams p) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_risk;

  const int w = blockIdx.x;
  const int N = p.n, S = p.s, SW = p.s / 32, NW = p.n / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tabn = min(S, kTabMax) + 1;
  const int xrows = p.rd + p.rp;

  float* tab = reinterpret_cast<float*>(smem);             // [tabn]
  float* xs = tab + tabn;                                   // [kGroup, kTileI]
  uint32_t* col_alt = reinterpret_cast<uint32_t*>(xs + kGroup * kTileI);
  uint32_t* col_ref = col_alt + SW;                         // [SW]
  uint32_t* seeds_any = col_ref + SW;                       // [NW]
  uint32_t* todo_all = seeds_any + NW;                      // [kWarps, NW]

  const int8_t* geno = p.geno + static_cast<size_t>(w) * N * S;
  const uint8_t* mem = p.member + static_cast<size_t>(w) * N;
  const uint8_t* smask = p.smask + static_cast<size_t>(w) * S;
  const uint8_t* pm = p.pm + static_cast<size_t>(w) * p.r * N;
  const uint8_t* ma = p.ma + static_cast<size_t>(w) * p.q * N;
  const uint8_t* mb = p.mb + static_cast<size_t>(w) * p.q * N;
  uint32_t* abits = p.bits + static_cast<size_t>(w) * 2 * SW * N;
  uint32_t* vbits = abits + static_cast<size_t>(SW) * N;
  uint32_t* pres = p.pres + static_cast<size_t>(w) * N * NW;
  uint32_t* link = p.link + static_cast<size_t>(w) * N * NW;
  uint16_t* diff = p.diff + static_cast<size_t>(w) * N * N;
  float* x = p.x + static_cast<size_t>(w) * xrows * N;
  float* y = p.y + static_cast<size_t>(w) * xrows * N;
  float* out = p.out + static_cast<size_t>(w) * p.n_out;
  const float len = fmaxf(p.length[w], 1.0f);

  // ---- setup: shared state, the (1 - sim) table, the X stacks
  for (int k = tid; k < SW; k += kThreads) { col_alt[k] = 0u; col_ref[k] = 0u; }
  for (int k = tid; k < NW; k += kThreads) seeds_any[k] = 0u;
  if (tid == 0) s_risk = 0;
  for (int d = tid; d < tabn; d += kThreads) {
    const float sim = __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(d), len));
    tab[d] = __fsub_rn(1.0f, sim);
  }
  // X rows: [0, R) weights, [R, R+Q) mask_a, [R+Q, R+2Q) mask_b, zero pad
  // to rd; then [rd, rd+PQ) seeds, mask_a, mask_b, zero pad to rd+rp.
  for (size_t e = tid; e < static_cast<size_t>(xrows) * N; e += kThreads) {
    const int row = static_cast<int>(e / N), i = static_cast<int>(e % N);
    const int loc = row < p.rd ? row - p.r : row - p.rd - p.pq;
    float v = 0.0f;
    if (loc >= 0 && loc < p.q) v = ma[static_cast<size_t>(loc) * N + i] ? 1.0f : 0.0f;
    else if (loc >= p.q && loc < 2 * p.q)
      v = mb[static_cast<size_t>(loc - p.q) * N + i] ? 1.0f : 0.0f;
    x[e] = v;
  }
  __syncthreads();

  // ---- A0: bit-pack alt / valid words and the column bitmaps
  pack_bits(geno, smask, mem, N, S, abits, vbits, col_alt, col_ref, warp, kWarps, lane);
  __syncthreads();
  if (warp == 0) {
    int cnt = 0;
    for (int k = lane; k < SW; k += 32) cnt += __popc(col_alt[k] & col_ref[k]);
    cnt = warp_sum(cnt);
    if (lane == 0) out[p.n_out - 2] = static_cast<float>(cnt);
  }

  // ---- A1: diff, present and link for every pair (i, j); lanes = 32 j's
  pair_loop(abits, vbits, mem, N, S, len, p.thr, warp, kWarps, lane,
            [&](int i, int j, int jw, int diff_n, bool present, float, bool lk) {
              diff[static_cast<size_t>(i) * N + j] = static_cast<uint16_t>(diff_n);
              const uint32_t pw = __ballot_sync(0xffffffffu, present);
              const uint32_t lw = __ballot_sync(0xffffffffu, lk);
              if (lane == 0) {
                pres[static_cast<size_t>(i) * NW + jw] = pw;
                link[static_cast<size_t>(i) * NW + jw] = lw;
              }
            });
  __syncthreads();

  // ---- B: one warp per grouping row
  uint32_t* todo = todo_all + warp * NW;
  for (int r = warp; r < p.r; r += kWarps) {
    const int n_r = load_mask_row(pm + static_cast<size_t>(r) * N, mem, NW, todo, lane);
    float* seedrow = r < p.pq ? x + static_cast<size_t>(p.rd + r) * N : nullptr;
    const int groups = peel_row(link, NW, todo, n_r, x + static_cast<size_t>(r) * N,
                                seedrow, nullptr, seeds_any, nullptr, lane);
    if (lane == 0) {
      out[p.r + r] = static_cast<float>(n_r);
      out[2 * p.r + r] = static_cast<float>(groups);
    }
  }
  __syncthreads();

  // ---- C: Y = X . div (rows [0, rd)) and Y = X . mask (rows [rd, rd+rp))
  for (int g0 = 0; g0 < xrows; g0 += kGroup) {
    const bool use_div = g0 < p.rd;
    auto elem = [&](int i, int j) -> float {
      const uint32_t pword = pres[static_cast<size_t>(i) * NW + (j >> 5)];
      if (!(((pword >> (j & 31)) & 1u) && i != j)) return 0.0f;
      if (!use_div) return 1.0f;
      const int d = diff[static_cast<size_t>(i) * N + j];
      return d < tabn ? tab[d]
                      : __fsub_rn(1.0f, __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(d), len)));
    };
    for (int j0 = 0; j0 < N; j0 += kThreads)
      group_products<kThreads>(x, N, xrows, g0, j0, xs, y, elem);
  }
  __syncthreads();

  // ---- D: row-dots, then seed_risk
  for (int t = warp; t < p.t; t += kWarps) {
    const int yr = p.dots[3 * t], xr = p.dots[3 * t + 1], col = p.dots[3 * t + 2];
    const float* yrow = y + static_cast<size_t>(yr) * N;
    const float* xrow = x + static_cast<size_t>(xr) * N;
    float acc = 0.0f;
    for (int j = lane; j < N; j += 32) acc = fmaf(yrow[j], xrow[j], acc);
    acc = warp_sumf(acc);
    if (lane == 0) out[col] = acc;
  }
  for (int e = tid; e < N * NW; e += kThreads) {
    const int i = e / NW, k = e % NW;
    if (!((seeds_any[i >> 5] >> (i & 31)) & 1u)) continue;
    uint32_t gap = seeds_any[k] & ~pres[static_cast<size_t>(i) * NW + k];
    if (k == (i >> 5)) gap &= ~(1u << (i & 31));
    if (gap) s_risk = 1;
  }
  __syncthreads();
  if (tid == 0) out[p.n_out - 1] = s_risk ? 1.0f : 0.0f;
}

// Seed flags for P masks of one window per block, from a given sim/present.
__global__ void __launch_bounds__(kThreads)
seed_peel_kernel(const float* __restrict__ sim, const uint8_t* __restrict__ present,
                 const uint8_t* __restrict__ member, const uint8_t* __restrict__ pmasks,
                 float thr, int n, int p_count, uint32_t* link_all, uint8_t* seeds) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int NW = n / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* sm = sim + static_cast<size_t>(b) * n * n;
  const uint8_t* pr = present + static_cast<size_t>(b) * n * n;
  const uint8_t* mem = member + static_cast<size_t>(b) * n;
  const uint8_t* pm = pmasks + static_cast<size_t>(b) * p_count * n;
  uint32_t* link = link_all + static_cast<size_t>(b) * n * NW;
  uint8_t* sd = seeds + static_cast<size_t>(b) * p_count * n;

  for (int item = warp; item < n * NW; item += kWarps) {
    const int i = item / NW, jw = item % NW;
    const int j = 32 * jw + lane;
    const size_t e = static_cast<size_t>(i) * n + j;
    const bool lk = j > i && mem[i] && mem[j] && pr[e] && sm[e] > thr;
    const uint32_t lw = __ballot_sync(0xffffffffu, lk);
    if (lane == 0) link[static_cast<size_t>(i) * NW + jw] = lw;
  }
  for (size_t e = tid; e < static_cast<size_t>(p_count) * n; e += kThreads) sd[e] = 0;
  __syncthreads();

  uint32_t* todo = smem + warp * NW;
  for (int r = warp; r < p_count; r += kWarps) {
    const int n_r = load_mask_row(pm + static_cast<size_t>(r) * n, mem, NW, todo, lane);
    peel_row(link, NW, todo, n_r, nullptr, nullptr, sd + static_cast<size_t>(r) * n,
             nullptr, nullptr, lane);
  }
}

}  // namespace

extern "C" {

const char* impop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of window_stats_kernel for caps (n, s).
size_t impop_window_stats_smem(int n, int s) {
  const int tabn = (s < kTabMax ? s : kTabMax) + 1;
  return sizeof(float) * (tabn + kGroup * kTileI) +
         sizeof(uint32_t) * (2 * (s / 32) + (n / 32) * (1 + kWarps));
}

int impop_window_stats(const void* geno, const void* member, const void* smask,
                       const void* pm, const void* ma, const void* mb,
                       const void* length, const void* dots, float thr,
                       int w, int n, int s, int r, int pq, int q, int t,
                       int rd, int rp, int n_out,
                       void* bits, void* pres, void* link, void* diff,
                       void* x, void* y, void* out, void* stream) {
  WinParams p;
  p.geno = static_cast<const int8_t*>(geno);
  p.member = static_cast<const uint8_t*>(member);
  p.smask = static_cast<const uint8_t*>(smask);
  p.pm = static_cast<const uint8_t*>(pm);
  p.ma = static_cast<const uint8_t*>(ma);
  p.mb = static_cast<const uint8_t*>(mb);
  p.length = static_cast<const float*>(length);
  p.dots = static_cast<const int32_t*>(dots);
  p.thr = thr;
  p.n = n; p.s = s; p.r = r; p.pq = pq; p.q = q; p.t = t;
  p.rd = rd; p.rp = rp; p.n_out = n_out;
  p.bits = static_cast<uint32_t*>(bits);
  p.pres = static_cast<uint32_t*>(pres);
  p.link = static_cast<uint32_t*>(link);
  p.diff = static_cast<uint16_t*>(diff);
  p.x = static_cast<float*>(x);
  p.y = static_cast<float*>(y);
  p.out = static_cast<float*>(out);
  const size_t smem = impop_window_stats_smem(n, s);
  const int err = set_smem(reinterpret_cast<const void*>(window_stats_kernel), smem);
  if (err) return err;
  window_stats_kernel<<<w, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int impop_seed_peel(const void* sim, const void* present, const void* member,
                    const void* pmasks, float thr, int b, int n, int p_count,
                    void* link, void* seeds, void* stream) {
  const size_t smem = sizeof(uint32_t) * kWarps * (n / 32);
  const int err = set_smem(reinterpret_cast<const void*>(seed_peel_kernel), smem);
  if (err) return err;
  seed_peel_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sim), static_cast<const uint8_t*>(present),
      static_cast<const uint8_t*>(member), static_cast<const uint8_t*>(pmasks), thr,
      n, p_count, static_cast<uint32_t*>(link), static_cast<uint8_t*>(seeds));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
