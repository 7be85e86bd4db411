// Whole-window panel statistics and greedy seed peel for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   impop_tpu/ops/windowstat.py  window_stats_pallas / _make_kernel
//     (identity, S, greedy grouping, group weights, every panel and pair
//      reduction, seed_risk -- one program per window)
//   impop_tpu/ops/seedpeel.py    seed_peel_pallas / _kernel
//     (greedy seed flags for P masks from a given sim / present), here
//     with the group ids (impop_tpu/stats/grouping.py _gid_from_seeds)
//
// The window program (window_stats_kernel: five launches on one stream,
// many blocks per window in every phase but the serial peel).
//   A0 window_pack_kernel, one block per (window, 32 rows).  Each row is
//      bit-packed into 32-site words of alt bits a and valid bits v
//      (site_mask & member & call >= 0); the column bitmaps of valid alt
//      and valid ref calls are OR-ed per block in shared memory, then into
//      device memory (integer atomics: the same bits in any order).  The
//      block also writes its 32 columns of the stacked X rows and their
//      bit-packed 0/1 rows.
//   A1 window_pairs_kernel, one warp per 32 x 32 block of pairs above or
//      on the diagonal (the block below is its mirror: present is
//      symmetric, link holds bits j > i only).  For a pair (i, j):
//      diff = popc(v_i & v_j & (a_i ^ a_j)) (exact, equal to the
//      reference's (v.v - z.z) / 2), present = popc(v_i & v_j) > 0 and
//      both members.  A lane owns a column j; the 32 row words of a site
//      word come in one coalesced load and are broadcast by shuffles.
//      sim = 1 - diff / max(length, 1) is non-increasing in diff, so the
//      link rule sim > thr (IEEE division and subtraction, strict, in
//      f32) is diff <= dmax for a per-window bound found by bisection on
//      the same expression: every link decision is bit-identical to the
//      reference.  Ballots give the packed present and link words.  diff
//      goes out as uint16 with the sentinel 0xffff where the pair is
//      absent or i == j (S <= 65535 and a multiple of 32, so no count
//      reaches the sentinel).
//   B  window_peel_kernel, one block per window, one warp per mask row:
//      the greedy recurrence is a sequential walk in row order.  The link
//      bits of the window (N^2 / 32 words, 32 KiB at N = 512) are copied to
//      shared memory first.  The next undecided member of the mask is a
//      seed, and OR-ing its link row (bits j > i) out of the undecided set
//      absorbs its group; the weight size / max(n, 1) is written at the
//      seed.  Then S and seed_risk (any two seeds without data).
//   C  window_products_kernel, one block per (window, 64 columns).
//      Y = X . div for the value rows [0, rd) (weights, mask_a, mask_b)
//      against div = (1 - sim) . offdiag . present, and Y = X . mask for
//      the 0/1 rows [rd, rd + rp) (seeds, mask_a, mask_b).  Value rows: a
//      register-blocked fp32 product, each thread 4 rows x 4 columns, two
//      16-byte shared loads per 16 FMAs, i ascending, the next step's
//      operands loaded into registers meanwhile; each (1 - sim)
//      element is built once per block from the diff and a per-block table
//      rounded exactly as the reference rounds it.  fp32 FMA only (no TF32,
//      no bf16: the values are not exact in a narrower type).  0/1 rows:
//      AND + popcount of the row's packed bits against present row j
//      (present is symmetric), exact integers as fp32 sums are below 2^24.
//      The 0/1 rows' packed words come from A0 (masks) and B (seeds).
//      Each block then takes every row-dot whose Y row it holds over its
//      64 columns (X columns staged in shared memory) and writes the
//      partial.
//   D  window_dots_kernel sums each row-dot's partials in column-tile
//      order (no float atomics: a row is the same from run to run).
//
// Memory: per-window scratch in device memory the wrapper allocates: the
// packed words, diff as uint16 (512 KiB at N = 512), bit-packed present
// and link (32 KiB each), the X row stack and the partial row-dots.
//
// What bounds it on this card: phase C's N^2 x rd fp32 FMAs (the value
// rows) and phase A1's N^2 S / 64 word pairs of two popcounts each.
//
// The seed peel (seed_peel: seeds and gid of P masks from a given sim /
// present, two launches):
//   S1 seed_link_kernel, one warp per (window, row): the link words
//      (sim > thr strict in f32, present, both members, bits j > i only)
//      from 16-byte loads of the row's upper triangle.  Bound by bytes:
//      about N^2 * 5 / 2 bytes a window.
//   S2 seed_peel_kernel, one block per (window, 4 masks), one warp per
//      mask: the link words in shared memory (32 KiB at N = 512; from
//      device memory above 160 KiB), the undecided members in registers,
//      one warp-min / AND-NOT step per seed, and gid written by the same
//      walk (the seed that absorbs a member is its smallest linked seed).
//      identity_group (idgroup.cu) launches the same walk on its own link
//      words, through impop::seed_walk, without the seeds.
//      Bound by the chain: the longest mask's seed count times a step's
//      latency (a warp reduction and a shared-memory load).
//
// The C functions return the first CUDA error of their launches; they
// never synchronise and never allocate.

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
using impop::warp_sumf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTabMax = 4096;          // (1 - sim) table entries beyond d = 0
constexpr int kPackRows = 32;          // rows per block of A0
constexpr int kColTile = 64;           // Y columns per block of C
constexpr int kRowChunk = 64;          // Y rows per pass of C
constexpr int kKc = 32;                // i values per staged step of C
constexpr int kXtStride = kRowChunk + 4;
constexpr uint16_t kAbsent = 0xffffu;  // diff of an absent pair or i == j
constexpr size_t kLinkSmemMax = 160 * 1024;
constexpr size_t kXSmemMax = 64 * 1024;     // staged X columns of C

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
  int n_out, nct;          // output columns; column tiles of phase C
  int link_smem;           // phase B copies the link bits to shared memory
  int x_smem;              // phase C stages its X columns in shared memory
  uint32_t* bits;          // [W, 2, S/32, N]  alt words, then valid words
  uint32_t* colbits;       // [W, 2, S/32]     valid alt, valid ref columns (zeroed)
  uint32_t* pres;          // [W, N, N/32]
  uint32_t* link;          // [W, N, N/32]   bits j > i only
  uint16_t* diff;          // [W, N, N]
  float* x;                // [W, rd + rp, N]
  uint32_t* xbits;         // [W, rp, N/32]  the 0/1 rows, bit-packed
  float* partial;          // [W, T, nct]
  float* out;              // [W, n_out]
};

__device__ __forceinline__ float div_elem(int d, const float* tab, int tabn, float len) {
  if (d == kAbsent) return 0.0f;
  return d < tabn ? tab[d]
                  : __fsub_rn(1.0f, __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(d), len)));
}

// ---- A0: packed words and column bitmaps of 32 rows; their X columns
__global__ void __launch_bounds__(kThreads) window_pack_kernel(WinParams p) {
  extern __shared__ uint32_t smem[];
  const int w = blockIdx.x, i_lo = blockIdx.y * kPackRows;
  const int N = p.n, S = p.s, SW = p.s / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xrows = p.rd + p.rp;
  const uint8_t* ma = p.ma + static_cast<size_t>(w) * p.q * N;
  const uint8_t* mb = p.mb + static_cast<size_t>(w) * p.q * N;
  float* x = p.x + static_cast<size_t>(w) * xrows * N;
  uint32_t* abits = p.bits + static_cast<size_t>(w) * 2 * SW * N;

  // X rows: [0, R) weights, [R, R+Q) mask_a, [R+Q, R+2Q) mask_b, zero pad
  // to rd; then [rd, rd+PQ) seeds, mask_a, mask_b, zero pad to rd+rp.
  for (int e = tid; e < xrows * kPackRows; e += kThreads) {
    const int row = e / kPackRows, i = i_lo + e % kPackRows;
    const int loc = row < p.rd ? row - p.r : row - p.rd - p.pq;
    float v = 0.0f;
    if (loc >= 0 && loc < p.q) v = ma[static_cast<size_t>(loc) * N + i] ? 1.0f : 0.0f;
    else if (loc >= p.q && loc < 2 * p.q)
      v = mb[static_cast<size_t>(loc - p.q) * N + i] ? 1.0f : 0.0f;
    x[static_cast<size_t>(row) * N + i] = v;
  }
  __syncthreads();
  // the 0/1 rows' word for these 32 columns (the seed rows are filled by B)
  uint32_t* xbits = p.xbits + static_cast<size_t>(w) * p.rp * (N / 32) + i_lo / 32;
  for (int row = warp; row < p.rp; row += kWarps) {
    const uint32_t word = __ballot_sync(
        0xffffffffu, x[static_cast<size_t>(p.rd + row) * N + i_lo + lane] != 0.0f);
    if (lane == 0) xbits[static_cast<size_t>(row) * (N / 32)] = word;
  }
  pack_block(p.geno + static_cast<size_t>(w) * N * S, p.smask + static_cast<size_t>(w) * S,
             p.member + static_cast<size_t>(w) * N, N, S, i_lo, kPackRows, abits, smem,
             p.colbits + static_cast<size_t>(w) * 2 * SW);
}

// The largest count of differing sites d whose sim = 1 - d / len (IEEE
// division and subtraction, as the reference rounds them) still exceeds
// thr strictly, or -1: sim is non-increasing in d, so link(i, j) is
// exactly present & j > i & diff <= dmax.
__device__ int link_dmax(int s, float len, float thr) {
  auto links = [&](int d) {
    return __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(d), len)) > thr;
  };
  if (!links(0)) return -1;
  if (links(s)) return s;
  int lo = 0, hi = s;   // links(lo), !links(hi)
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (links(mid)) lo = mid;
    else hi = mid;
  }
  return lo;
}

// ---- A1: diff, present and link, one warp per 32 x 32 block (iw <= jw)
// of word rows iw and word columns jw; a block above the diagonal also
// writes its mirror (present is symmetric, link holds bits j > i only).
// Lane l owns column j = 32 jw + l and keeps its words in registers; the
// 32 row words of each site word come in one coalesced load and are
// broadcast by shuffles.
template <bool kBits>
__global__ void __launch_bounds__(kThreads) window_pairs_kernel(WinParams p) {
  __shared__ int s_dmax;
  const int w = blockIdx.x;
  const int N = p.n, SW = p.s / 32, NW = p.n / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float len = fmaxf(p.length[w], 1.0f);
  if (threadIdx.x == 0) s_dmax = link_dmax(p.s, len, p.thr);
  __syncthreads();
  const int dmax = s_dmax;
  const int bp = blockIdx.y * kWarps + warp;
  if (bp >= NW * (NW + 1) / 2) return;
  int iw, jw;
  upper_block(bp, NW, &iw, &jw);
  const int i0 = 32 * iw, j = 32 * jw + lane;
  const uint32_t* abits = p.bits + static_cast<size_t>(w) * 2 * SW * N;
  const uint32_t* vbits = abits + static_cast<size_t>(SW) * N;
  const uint8_t* mem = p.member + static_cast<size_t>(w) * N;
  uint32_t* pres = p.pres + static_cast<size_t>(w) * N * NW;
  uint32_t* link = p.link + static_cast<size_t>(w) * N * NW;
  uint16_t* diff = p.diff + static_cast<size_t>(w) * N * N;

  typename impop::PresentForm<kBits>::type both;
  int dn[32];
  pair_counts(abits, vbits, N, SW, i0, j, lane, both, dn);
  const bool mj = mem[j] != 0;
  const uint32_t mrows = __ballot_sync(0xffffffffu, mem[i0 + lane] != 0);
  uint32_t mirror = 0u;
  uint32_t packed[16];
#pragma unroll
  for (int ii = 0; ii < 32; ++ii) {
    const int i = i0 + ii;
    const bool mi = (mrows >> ii) & 1u;
    const bool present = i == j ? mi : (any_present(both, ii) && mi && mj);
    const bool lk = present && j > i && dn[ii] <= dmax;
    const uint32_t d16 = present && i != j ? static_cast<uint32_t>(dn[ii]) : kAbsent;
    diff[static_cast<size_t>(i) * N + j] = static_cast<uint16_t>(d16);
    const uint32_t pw = __ballot_sync(0xffffffffu, present);
    const uint32_t lw = __ballot_sync(0xffffffffu, lk);
    if (lane == 0) {
      pres[static_cast<size_t>(i) * NW + jw] = pw;
      link[static_cast<size_t>(i) * NW + jw] = lw;
    }
    mirror |= static_cast<uint32_t>(present) << ii;
    if (ii & 1) packed[ii >> 1] |= d16 << 16;
    else packed[ii >> 1] = d16;
  }
  if (jw == iw) return;
  pres[static_cast<size_t>(j) * NW + iw] = mirror;
  link[static_cast<size_t>(j) * NW + iw] = 0u;
  uint4* drow = reinterpret_cast<uint4*>(diff + static_cast<size_t>(j) * N + i0);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    drow[q] = make_uint4(packed[4 * q], packed[4 * q + 1], packed[4 * q + 2], packed[4 * q + 3]);
}

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
// seed i: wrow[i] = size / max(n_r, 1), seedrow[i] = 1 (if seedrow) and
// bit i of any_bits.  Returns the number of seeds.
__device__ inline int peel_row(const uint32_t* __restrict__ link, int nw, uint32_t* todo,
                               int n_r, float* wrow, float* seedrow, uint32_t* any_bits,
                               int lane) {
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
        absorbed += __popc(lk & t);
        todo[k2] = t & ~lk;
      }
      absorbed = warp_sum(absorbed);
      if (lane == 0) {
        wrow[i] = __fdiv_rn(static_cast<float>(absorbed + 1), denom);
        if (seedrow) seedrow[i] = 1.0f;
        atomicOr(&any_bits[k], 1u << b);
      }
      ++groups;
      __syncwarp();
    }
  }
  return groups;
}

// ---- B: one warp per grouping row; then S and seed_risk
__global__ void __launch_bounds__(kThreads) window_peel_kernel(WinParams p) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_risk;
  const int w = blockIdx.x;
  const int N = p.n, SW = p.s / 32, NW = p.n / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xrows = p.rd + p.rp;
  uint32_t* todo_all = smem;                    // [kWarps, NW]
  uint32_t* seeds_any = todo_all + kWarps * NW; // [NW]
  uint32_t* slink = seeds_any + NW;             // [N, NW] when link_smem
  const uint32_t* pres = p.pres + static_cast<size_t>(w) * N * NW;
  const uint32_t* link = p.link + static_cast<size_t>(w) * N * NW;
  const uint8_t* mem = p.member + static_cast<size_t>(w) * N;
  const uint8_t* pm = p.pm + static_cast<size_t>(w) * p.r * N;
  float* x = p.x + static_cast<size_t>(w) * xrows * N;
  float* out = p.out + static_cast<size_t>(w) * p.n_out;

  for (int k = tid; k < NW; k += kThreads) seeds_any[k] = 0u;
  if (tid == 0) s_risk = 0;
  if (p.link_smem) {
    for (int e = tid; e < N * NW; e += kThreads) slink[e] = link[e];
    link = slink;
  }
  __syncthreads();

  uint32_t* todo = todo_all + warp * NW;
  for (int r = warp; r < p.r; r += kWarps) {
    const int n_r = load_mask_row(pm + static_cast<size_t>(r) * N, mem, NW, todo, lane);
    float* seedrow = r < p.pq ? x + static_cast<size_t>(p.rd + r) * N : nullptr;
    const int groups = peel_row(link, NW, todo, n_r, x + static_cast<size_t>(r) * N,
                                seedrow, seeds_any, lane);
    if (lane == 0) {
      out[p.r + r] = static_cast<float>(n_r);
      out[2 * p.r + r] = static_cast<float>(groups);
    }
    if (seedrow) {   // the seed row, bit-packed for phase C
      __syncwarp();
      uint32_t* xb = p.xbits + (static_cast<size_t>(w) * p.rp + r) * NW;
      for (int kw = 0; kw < NW; ++kw) {
        const uint32_t word = __ballot_sync(0xffffffffu, seedrow[32 * kw + lane] != 0.0f);
        if (lane == 0) xb[kw] = word;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    const uint32_t* cb = p.colbits + static_cast<size_t>(w) * 2 * SW;
    int cnt = 0;
    for (int k = lane; k < SW; k += 32) cnt += __popc(cb[k] & cb[SW + k]);
    cnt = warp_sum(cnt);
    if (lane == 0) out[p.n_out - 2] = static_cast<float>(cnt);
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

// Phase C's row-dots over this block's 64 columns for the Y rows
// [g0, g_end) staged in ys: one warp per dot, lanes over the columns.
// xd points at X column j0 of row 0, rows `stride` floats apart (the
// block's staged columns, or the window's X rows in device memory).
__device__ __forceinline__ void tile_dots(const WinParams& p, const float* ys, const float* xd,
                                          int stride, int w, int ct, int j0, int g0, int g_end,
                                          int lane, int warp) {
  for (int t = warp; t < p.t; t += kWarps) {
    const int yr = p.dots[3 * t];
    if (yr < g0 || yr >= g_end) continue;
    const float* xrow = xd + static_cast<size_t>(p.dots[3 * t + 1]) * stride;
    float acc = 0.0f;
    for (int jj = lane; jj < kColTile; jj += 32)
      if (j0 + jj < p.n) acc = fmaf(ys[(yr - g0) * kColTile + jj], xrow[jj], acc);
    acc = warp_sumf(acc);
    if (lane == 0) p.partial[(static_cast<size_t>(w) * p.t + t) * p.nct + ct] = acc;
  }
}

// ---- C: Y tiles of 64 columns, then their partial row-dots
__global__ void __launch_bounds__(kThreads, 3) window_products_kernel(WinParams p) {
  extern __shared__ __align__(16) float fsm[];
  const int w = blockIdx.x, ct = blockIdx.y, j0 = ct * kColTile;
  const int N = p.n, NW = p.n / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xrows = p.rd + p.rp;
  const int tabn = min(p.s, kTabMax) + 1;
  float* tab = fsm;                                            // [tabn]
  float* xt = fsm + ((tabn + 3) & ~3);                         // [kKc, kXtStride]
  float* ms = xt + kKc * kXtStride;                            // [kKc, kColTile]
  float* ys = ms + kKc * kColTile;                             // [kRowChunk, kColTile]
  uint32_t* xb = reinterpret_cast<uint32_t*>(ys + kRowChunk * kColTile);  // [kRowChunk, NW]
  float* xcols = reinterpret_cast<float*>(xb + kRowChunk * NW);           // [xrows, kColTile]
  const float* x = p.x + static_cast<size_t>(w) * xrows * N;
  const uint32_t* xbits = p.xbits + static_cast<size_t>(w) * p.rp * NW;
  const float* xd = p.x_smem ? xcols : x + j0;
  const int xstride = p.x_smem ? kColTile : N;
  const uint16_t* diff = p.diff + static_cast<size_t>(w) * N * N;
  const uint32_t* pres = p.pres + static_cast<size_t>(w) * N * NW;
  const float len = fmaxf(p.length[w], 1.0f);

  for (int d = tid; d < tabn; d += kThreads) {
    const float sim = __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(d), len));
    tab[d] = __fsub_rn(1.0f, sim);
  }
  if (p.x_smem)
    for (int e = tid; e < xrows * kColTile; e += kThreads) {
      const int row = e / kColTile, jj = e % kColTile;
      xcols[e] = j0 + jj < N ? x[static_cast<size_t>(row) * N + j0 + jj] : 0.0f;
    }

  // value rows: thread (s4, c4) holds rows 4 s4 .. + 3, columns 4 c4 .. + 3
  const int s4 = tid >> 4, c4 = tid & 15;
  constexpr int kXPer = kKc * kRowChunk / kThreads;          // X values per thread
  constexpr int kDPer = kKc * (kColTile / 4) / kThreads;     // 4-diff groups per thread
  for (int g0 = 0; g0 < p.rd; g0 += kRowChunk) {
    const bool rows_on = g0 + 4 * s4 < p.rd;   // rd is a multiple of 16
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
    // the next step's X values and diffs wait in registers while this
    // step's products run
    float xpre[kXPer];
    ushort4 dpre[kDPer];
    auto fetch = [&](int i0) {
#pragma unroll
      for (int m = 0; m < kXPer; ++m) {
        const int e = tid + kThreads * m, k = e % kKc, row = e / kKc;   // coalesced in k
        xpre[m] = g0 + row < p.rd ? x[static_cast<size_t>(g0 + row) * N + i0 + k] : 0.0f;
      }
#pragma unroll
      for (int m = 0; m < kDPer; ++m) {
        const int e = tid + kThreads * m, k = e / (kColTile / 4), j = j0 + 4 * (e % (kColTile / 4));
        dpre[m] = j < N ? *reinterpret_cast<const ushort4*>(diff + static_cast<size_t>(i0 + k) * N + j)
                        : make_ushort4(kAbsent, kAbsent, kAbsent, kAbsent);
      }
    };
    fetch(0);
    for (int i0 = 0; i0 < N; i0 += kKc) {
      __syncthreads();   // the table is written; the last step's tiles are read
#pragma unroll
      for (int m = 0; m < kXPer; ++m) {
        const int e = tid + kThreads * m;
        xt[(e % kKc) * kXtStride + e / kKc] = xpre[m];
      }
#pragma unroll
      for (int m = 0; m < kDPer; ++m) {
        const int e = tid + kThreads * m, k = e / (kColTile / 4), c = e % (kColTile / 4);
        const ushort4 d = dpre[m];
        *reinterpret_cast<float4*>(ms + k * kColTile + 4 * c) =
            make_float4(div_elem(d.x, tab, tabn, len), div_elem(d.y, tab, tabn, len),
                        div_elem(d.z, tab, tabn, len), div_elem(d.w, tab, tabn, len));
      }
      __syncthreads();
      if (i0 + kKc < N) fetch(i0 + kKc);
      if (!rows_on) continue;
#pragma unroll 8
      for (int k = 0; k < kKc; ++k) {
        const float4 mv = *reinterpret_cast<const float4*>(ms + k * kColTile + 4 * c4);
        const float4 xv = *reinterpret_cast<const float4*>(xt + k * kXtStride + 4 * s4);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][0] = fmaf(xs[a], mv.x, acc[a][0]);
          acc[a][1] = fmaf(xs[a], mv.y, acc[a][1]);
          acc[a][2] = fmaf(xs[a], mv.z, acc[a][2]);
          acc[a][3] = fmaf(xs[a], mv.w, acc[a][3]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(ys + (4 * s4 + a) * kColTile + 4 * c4) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    __syncthreads();
    tile_dots(p, ys, xd, xstride, w, ct, j0, g0, min(g0 + kRowChunk, p.rd), lane, warp);
  }

  // 0/1 rows: thread (column c, rows rq + 4 m) counts AND + popcount
  const int c = tid % kColTile, rq = tid / kColTile, j = j0 + c;
  for (int g0 = p.rd; g0 < xrows; g0 += kRowChunk) {
    __syncthreads();   // ys and xb of the previous pass are read
    for (int e = tid; e < kRowChunk * NW; e += kThreads) {
      const int rr = e / NW;
      xb[e] = g0 + rr < xrows ? xbits[static_cast<size_t>(g0 - p.rd) * NW + e] : 0u;
    }
    __syncthreads();
    int cnt[kRowChunk / 4];
#pragma unroll
    for (int m = 0; m < kRowChunk / 4; ++m) cnt[m] = 0;
    if (j < N) {
      for (int kw = 0; kw < NW; ++kw) {
        uint32_t pw = pres[static_cast<size_t>(j) * NW + kw];
        if (kw == (j >> 5)) pw &= ~(1u << (j & 31));
#pragma unroll
        for (int m = 0; m < kRowChunk / 4; ++m) cnt[m] += __popc(xb[(rq + 4 * m) * NW + kw] & pw);
      }
    }
#pragma unroll
    for (int m = 0; m < kRowChunk / 4; ++m)
      ys[(rq + 4 * m) * kColTile + c] = static_cast<float>(cnt[m]);
    __syncthreads();
    tile_dots(p, ys, xd, xstride, w, ct, j0, g0, min(g0 + kRowChunk, xrows), lane, warp);
  }
}

// ---- D: every row-dot as the sum of its column tiles' partials, in order
__global__ void __launch_bounds__(kThreads) window_dots_kernel(WinParams p, int w_count) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= w_count * p.t) return;
  const int w = e / p.t, t = e % p.t;
  const float* part = p.partial + static_cast<size_t>(e) * p.nct;
  float acc = 0.0f;
  for (int ct = 0; ct < p.nct; ++ct) acc += part[ct];
  p.out[static_cast<size_t>(w) * p.n_out + p.dots[3 * t + 2]] = acc;
}

size_t products_smem(int n, int s, int xrows, bool x_smem) {
  const int tabn = (s < kTabMax ? s : kTabMax) + 1;
  return sizeof(float) * (((tabn + 3) & ~3) + kKc * kXtStride + kKc * kColTile +
                          kRowChunk * kColTile + (x_smem ? xrows * kColTile : 0)) +
         sizeof(uint32_t) * kRowChunk * (n / 32);
}

// ---- seed peel (seed_peel_pallas), two launches over many blocks

constexpr int kSegCols = 512;     // columns a warp covers per step of the link build
constexpr int kWalkWarps = 4;     // masks per block of the walk

// Bit e of the result: byte e of the 16 is nonzero.
__device__ __forceinline__ uint32_t nonzero16(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t out = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out |= static_cast<uint32_t>(((w[q] >> (8 * e)) & 0xffu) != 0u) << (4 * q + e);
  return out;
}

// S1: the link words of every (window, row), one warp per row i.  Lane l
// reads columns j .. j + 15 (j = 16 l of a 512-column step) with 16-byte
// loads of sim, present and member; the two lanes of a 32-column word join
// their halves by a shuffle.  Columns at or left of i are neither read nor
// linked (bits j > i only), so a row costs half its bytes.
__global__ void __launch_bounds__(kThreads)
seed_link_kernel(const float* __restrict__ sim, const uint8_t* __restrict__ present,
                 const uint8_t* __restrict__ member, float thr, int n,
                 uint32_t* __restrict__ link) {
  const int b = blockIdx.x, i = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(b) * n + i;
  const float* srow = sim + row * n;
  const uint8_t* prow = present + row * n;
  const uint8_t* mem = member + static_cast<size_t>(b) * n;
  uint32_t* lrow = link + row * (n / 32);
  const bool mi = mem[i] != 0;
  for (int j0 = 0; j0 < n; j0 += kSegCols) {
    const int j = j0 + 16 * lane;
    uint32_t bits = 0u;
    if (mi && j < n && j + 15 > i) {
      const uint32_t both = nonzero16(*reinterpret_cast<const uint4*>(prow + j)) &
                            nonzero16(*reinterpret_cast<const uint4*>(mem + j));
      const float4* s4 = reinterpret_cast<const float4*>(srow + j);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = s4[q];
        const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * q + e;
          bits |= static_cast<uint32_t>(j + c > i && ((both >> c) & 1u) && s[e] > thr) << c;
        }
      }
    }
    const uint32_t hi = __shfl_down_sync(0xffffffffu, bits, 1);
    if (!(lane & 1) && j < n) lrow[j >> 5] = bits | (hi << 16);
  }
}

// The 32 bits of (mask & member) over 32 members, from 16-byte loads.
__device__ __forceinline__ uint32_t mask_word(const uint8_t* pm, const uint8_t* mem) {
  const uint4* p = reinterpret_cast<const uint4*>(pm);
  const uint4* m = reinterpret_cast<const uint4*>(mem);
  return (nonzero16(p[0]) & nonzero16(m[0])) | ((nonzero16(p[1]) & nonzero16(m[1])) << 16);
}

// S2: the greedy walk, one block per (window, kWalkWarps masks), one warp
// per mask.  The window's link words go to shared memory first (read from
// device memory when they do not fit).  Lane k keeps the undecided members
// of words k, k + 32, ... in registers (W words).  A step finds the lowest
// undecided member i (each lane's __ffs, one __reduce_min_sync): it is a
// seed; AND-NOT of its link
// row (bits j > i) absorbs its group, and each absorbed member m gets
// gid[m] = i, the smallest seed linked to m (a smaller one would have
// absorbed m first).  One step per seed; nothing else is counted.
template <int W>
__global__ void __launch_bounds__(kWalkWarps * 32)
seed_peel_kernel(const uint32_t* __restrict__ link_all, const uint8_t* __restrict__ member,
                 const uint8_t* __restrict__ pmasks, int n, int p_count, int link_smem,
                 uint8_t* __restrict__ seeds, int32_t* __restrict__ gid) {
  extern __shared__ uint4 slink4[];
  const int b = blockIdx.x, nw = n / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t* link = link_all + static_cast<size_t>(b) * n * nw;
  if (link_smem) {
    const uint4* src = reinterpret_cast<const uint4*>(link);
    for (int e = tid; e < n * nw / 4; e += kWalkWarps * 32) slink4[e] = src[e];
    link = reinterpret_cast<const uint32_t*>(slink4);
    __syncthreads();
  }
  const int r = blockIdx.y * kWalkWarps + warp;
  if (r >= p_count) return;
  const size_t row = static_cast<size_t>(b) * p_count + r;
  const uint8_t* pm = pmasks + row * n;
  const uint8_t* mem = member + static_cast<size_t>(b) * n;
  uint8_t* sd = seeds ? seeds + row * n : nullptr;
  int32_t* gd = gid + row * n;

  uint32_t todo[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int k = 32 * w + lane;
    todo[w] = k < nw ? mask_word(pm + 32 * k, mem + 32 * k) : 0u;
  }
  for (int e = lane; e < n; e += 32) {
    if (sd) sd[e] = 0;
    gd[e] = n;   // outside the mask
  }
  __syncwarp();   // orders the fills before the walk's writes
  while (true) {
    // the lowest undecided member: each lane's lowest, then one warp min
    uint32_t mine = 0xffffffffu;
#pragma unroll
    for (int w = W - 1; w >= 0; --w)
      if (todo[w]) mine = 32u * (32 * w + lane) + __ffs(todo[w]) - 1;
    const uint32_t next = __reduce_min_sync(0xffffffffu, mine);
    if (next == 0xffffffffu) break;
    const int i = static_cast<int>(next), kw = i >> 5, bit = i & 31;
    const uint32_t* lrow = link + static_cast<size_t>(i) * nw;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int k = 32 * w + lane;
      if (k == kw) todo[w] &= ~(1u << bit);
      if (k >= kw && k < nw) {   // link row i holds bits j > i only
        const uint32_t lk = lrow[k];
        for (uint32_t took = todo[w] & lk; took; took &= took - 1u)
          gd[32 * k + __ffs(took) - 1] = i;
        todo[w] &= ~lk;
      }
    }
    if (lane == 0) {
      if (sd) sd[i] = 1;
      gd[i] = i;
    }
  }
}

template <int W>
int launch_walk(dim3 grid, size_t smem, cudaStream_t st, const uint32_t* link,
                const uint8_t* member, const uint8_t* pmasks, int n, int p_count,
                int link_smem, uint8_t* seeds, int32_t* gid) {
  const int err = set_smem(reinterpret_cast<const void*>(seed_peel_kernel<W>), smem);
  if (err) return err;
  seed_peel_kernel<W><<<grid, kWalkWarps * 32, smem, st>>>(link, member, pmasks, n, p_count,
                                                            link_smem, seeds, gid);
  return 0;
}

}  // namespace

int impop::seed_walk(const uint32_t* link, const uint8_t* member, const uint8_t* pmasks, int b,
                     int n, int p_count, uint8_t* seeds, int32_t* gid, cudaStream_t st) {
  const size_t link_bytes = sizeof(uint32_t) * static_cast<size_t>(n) * (n / 32);
  const int link_smem = link_bytes <= kLinkSmemMax;
  const size_t smem = link_smem ? link_bytes : 0;
  const dim3 grid(b, (p_count + kWalkWarps - 1) / kWalkWarps);
  const int nw = n / 32;
  const auto walk = [&](auto launch) {
    return launch(grid, smem, st, link, member, pmasks, n, p_count, link_smem, seeds, gid);
  };
  int err;
  if (nw <= 32) err = walk(launch_walk<1>);
  else if (nw <= 64) err = walk(launch_walk<2>);
  else if (nw <= 128) err = walk(launch_walk<4>);
  else if (nw <= 256) err = walk(launch_walk<8>);
  else if (nw <= 512) err = walk(launch_walk<16>);
  else if (nw <= 1024) err = walk(launch_walk<32>);
  else err = static_cast<int>(cudaErrorInvalidValue);
  return err ? err : static_cast<int>(cudaGetLastError());
}

extern "C" {

const char* impop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// colbits must be zero on entry; n and s multiples of 32, s <= 65535.
int impop_window_stats(const void* geno, const void* member, const void* smask,
                       const void* pm, const void* ma, const void* mb,
                       const void* length, const void* dots, float thr,
                       int w, int n, int s, int r, int pq, int q, int t,
                       int rd, int rp, int n_out,
                       void* bits, void* colbits, void* pres, void* link, void* diff,
                       void* x, void* xbits, void* partial, void* out, void* stream) {
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
  p.nct = (n + kColTile - 1) / kColTile;
  const size_t link_bytes = sizeof(uint32_t) * static_cast<size_t>(n) * (n / 32);
  p.link_smem = link_bytes <= kLinkSmemMax;
  p.x_smem = sizeof(float) * (rd + rp) * kColTile <= kXSmemMax;
  p.bits = static_cast<uint32_t*>(bits);
  p.colbits = static_cast<uint32_t*>(colbits);
  p.pres = static_cast<uint32_t*>(pres);
  p.link = static_cast<uint32_t*>(link);
  p.diff = static_cast<uint16_t*>(diff);
  p.x = static_cast<float*>(x);
  p.xbits = static_cast<uint32_t*>(xbits);
  p.partial = static_cast<float*>(partial);
  p.out = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  const size_t pack_smem = sizeof(uint32_t) * 2 * (s / 32);
  int err = set_smem(reinterpret_cast<const void*>(window_pack_kernel), pack_smem);
  if (err) return err;
  window_pack_kernel<<<dim3(w, n / kPackRows), kThreads, pack_smem, st>>>(p);
  const int nw = n / 32, word_blocks = nw * (nw + 1) / 2;
  const dim3 pair_grid(w, (word_blocks + kWarps - 1) / kWarps);
  if (s <= impop::kBitsMaxSites) window_pairs_kernel<true><<<pair_grid, kThreads, 0, st>>>(p);
  else window_pairs_kernel<false><<<pair_grid, kThreads, 0, st>>>(p);
  const size_t peel_smem =
      sizeof(uint32_t) * (kWarps + 1) * (n / 32) + (p.link_smem ? link_bytes : 0);
  err = set_smem(reinterpret_cast<const void*>(window_peel_kernel), peel_smem);
  if (err) return err;
  window_peel_kernel<<<w, kThreads, peel_smem, st>>>(p);
  const size_t prod_smem = products_smem(n, s, rd + rp, p.x_smem);
  err = set_smem(reinterpret_cast<const void*>(window_products_kernel), prod_smem);
  if (err) return err;
  window_products_kernel<<<dim3(w, p.nct), kThreads, prod_smem, st>>>(p);
  window_dots_kernel<<<(w * t + kThreads - 1) / kThreads, kThreads, 0, st>>>(p, w);
  return static_cast<int>(cudaGetLastError());
}

// n a multiple of 32, at most 32 * 32 * 32; every pointer 16-byte aligned.
int impop_seed_peel(const void* sim, const void* present, const void* member,
                    const void* pmasks, float thr, int b, int n, int p_count,
                    void* link, void* seeds, void* gid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mem = static_cast<const uint8_t*>(member);
  uint32_t* lk = static_cast<uint32_t*>(link);
  seed_link_kernel<<<dim3(b, (n + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      static_cast<const float*>(sim), static_cast<const uint8_t*>(present), mem, thr, n, lk);
  return impop::seed_walk(lk, mem, static_cast<const uint8_t*>(pmasks), b, n, p_count,
                          static_cast<uint8_t*>(seeds), static_cast<int32_t*>(gid), st);
}

}  // extern "C"
