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
//   C  window_products_kernel, one block per (window, 64 columns): one
//      consumer warpgroup per tile of 64 value rows and a producer warp
//      (csrc/rowprod.cuh; two blocks per SM at one tile).
//      Y = X . div for the value rows [0, rd) (weights, mask_a, mask_b)
//      against div = (1 - sim) . offdiag . present, on the tensor cores:
//      the producer keeps the diff tiles ([32 i, 64 j] uint16) of the
//      next four chunks in flight by TMA (a ring with full / empty
//      mbarriers); the consumers turn chunk c + 1's diffs into the three
//      bf16 pieces of tab[d] = 1 - f32(1 - d / len), the (1 - sim) of the
//      reference rounded as the reference rounds it (d / len by a
//      correctly rounded reciprocal and one FMA correction, bit-identical
//      to IEEE division; tab[d] is not d / len, which differs by up to
//      1.3e-4 relative at len = 5000; absent pairs and i == j: zeros),
//      while the wgmma of chunk c runs.  The X rows are the wgmma's A operand in registers:
//      each thread loads its X values from device memory two chunks ahead
//      and splits them into three pieces.  Of the nine piece products the
//      six with p + q <= 4 are kept (the dropped ones are below 2^-21 of
//      each term), every one exact in fp32; a chunk's 12 products
//      accumulate in fp32 registers, the chunks are summed in i order with
//      round-to-nearest adds (no TF32, no single bf16 pass; the sums are
//      the same from run to run).  0/1 rows [rd, rd + rp) (seeds, mask_a,
//      mask_b): AND + POPC of the rows' packed bits against the packed
//      present words of column j (present is symmetric; both staged in
//      shared memory, loaded with the block's tables) on the tensor cores
//      (mma m16n8k256 b1, int32 sums: exact counts).  The 0/1 rows'
//      packed words come from A0 (masks) and B (seeds).  Each block then
//      takes every row-dot whose Y row it holds over its 64 columns (X
//      columns and the dot table staged in shared memory, one thread a
//      dot) and writes the partial.
//   D  window_dots_kernel sums each row-dot's partials in column-tile
//      order (no float atomics: a row is the same from run to run).
//
// Memory: per-window scratch in device memory the wrapper allocates: the
// packed words, diff as uint16 (512 KiB at N = 512), bit-packed present
// and link (32 KiB each), the X row stack and the partial row-dots.
//
// What bounds it on this card: at [512, 128] x 320 most of the time goes
// to phase C, then to A1's N^2 S / 64 word pairs of two popcounts (PERF.md
// has the times).  Phase C's own bounds are its
// tensor-core products (6 bf16 products of a 64-row tile a pair: 64
// GFLOP, 65 us at 989 TFLOP/s) and its read of diff (168 MB, 50 us at
// 3.35 TB/s); it runs at several times them, bound by latency: each block
// waits on its wgmma chain and its decode once a chunk with only two
// blocks (ten warps) per SM to cover it (bench/window_breakdown.py times
// the parts).  The 0/1 rows' counts take b1 mma, not __popc, which the
// card retires at 16 a clock per SM.
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
#include "rowprod.cuh"

namespace {

using impop::any_present;
using impop::pack_block;
using impop::pair_counts;
using impop::set_smem;
using impop::upper_block;
using impop::warp_sum;

namespace rp = impop::rp;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPackRows = 32;          // rows per block of A0
constexpr int kColTile = rp::kCols;    // Y columns per block of C
constexpr int kRowChunk = 64;          // 0/1 rows per pass of C
constexpr uint16_t kAbsent = 0xffffu;  // diff of an absent pair or i == j
constexpr size_t kLinkSmemMax = 160 * 1024;
constexpr size_t kXSmemMax = 48 * 1024;     // staged X columns of C
constexpr int kDiffBox = rp::kKc * kColTile * 2;  // a raw diff tile [32 i, 64 j]
constexpr size_t kSmemCap = 232448;         // shared memory of a block

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
// [g0, g_end) staged in ys: one thread a dot, over the columns from a
// start rotated by the lane (the lanes read distinct banks), in a fixed
// order; dots: the (Y row, X row) of every dot, in shared memory.
__device__ __forceinline__ void tile_dots(const WinParams& p, const int* dots, const float* ys,
                                          const float* xd, int stride, int w, int ct, int j0,
                                          int g0, int g_end, int tid, int n_threads) {
  const int cols = min(kColTile, p.n - j0), lane = tid & 31;
  for (int t = tid; t < p.t; t += n_threads) {
    const int yr = dots[3 * t];
    if (yr < g0 || yr >= g_end) continue;
    const float* yrow = ys + (yr - g0) * kColTile;
    const float* xrow = xd + static_cast<size_t>(dots[3 * t + 1]) * stride;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kColTile; ++k) {
      const int jj = (k + lane) & (kColTile - 1);
      if (jj < cols) acc = fmaf(yrow[jj], xrow[jj], acc);
    }
    p.partial[(static_cast<size_t>(w) * p.t + t) * p.nct + ct] = acc;
  }
}

// Phase C's shared memory: the ring's mbarriers, the dot table, the
// staged X columns, the 0/1 rows' and the columns' packed
// words, the TMA ring of diff tiles, then the double buffer of B pieces
// (after a pass, the pass's Y tile; in the 0/1 rows' passes, their Y
// rows).  The host sizes the launch with the same function.
struct ProdLayout {
  int dots, xcols, bits, raw, dec, total;
};

// Words apart of the 0/1 rows' packed rows and of the columns' present
// words in shared memory (conflict-free b1 mma fragments).
__host__ __device__ constexpr int bit_stride(int n) { return n / 32 + 4; }

__host__ __device__ inline ProdLayout prod_layout(int n, int xrows, int t, bool x_smem,
                                                  int tiles) {
  ProdLayout l;
  l.dots = rp::kBarBytes;
  l.xcols = l.dots + (12 * t + 127) / 128 * 128;
  l.bits = l.xcols + (x_smem ? (4 * xrows * kColTile + 127) / 128 * 128 : 0);
  l.raw = l.bits + 4 * (kRowChunk + kColTile) * bit_stride(n);
  l.dec = l.raw + rp::kRaw * kDiffBox;
  const int ys = 4 * tiles * rp::kRows * kColTile;
  l.total = l.dec + (ys > 2 * rp::kDecHalf ? ys : 2 * rp::kDecHalf);
  return l;
}

// ---- C: Y tiles of 64 columns on the tensor cores, then their partial
// row-dots.  A pass takes kTiles tiles of 64 value rows (warpgroup g
// multiplies tile g); the i axis comes in chunks of 32.
template <int kTiles>
__global__ void __launch_bounds__(rp::threads(kTiles), 3 - kTiles)
    window_products_kernel(WinParams p, const __grid_constant__ CUtensorMap dmap) {
  constexpr int kCons = 128 * kTiles;   // consumer threads
  constexpr int kPassRows = kTiles * rp::kRows;
  extern __shared__ __align__(128) uint8_t csm[];
  const int w = blockIdx.x, ct = blockIdx.y, j0 = ct * kColTile;
  const int N = p.n, NW = p.n / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xrows = p.rd + p.rp;
  const ProdLayout lay = prod_layout(N, xrows, p.t, p.x_smem, kTiles);
  int* dots = reinterpret_cast<int*>(csm + lay.dots);         // [T, 3]
  uint64_t* full = reinterpret_cast<uint64_t*>(csm);
  uint64_t* empty = full + rp::kRaw;
  float* xcols = reinterpret_cast<float*>(csm + lay.xcols);  // [xrows, kColTile]
  uint8_t* raw = csm + lay.raw;
  uint8_t* dec = csm + lay.dec;
  const int nch = N / rp::kKc;
  const int passes = (p.rd + kPassRows - 1) / kPassRows;
  const float len = fmaxf(p.length[w], 1.0f), inv = __frcp_rn(len);

  if (tid == 0) {
    for (int q = 0; q < rp::kRaw; ++q) {
      impop::mbar_init(&full[q], 1);
      impop::mbar_init(&empty[q], kCons / 32);
    }
    impop::mbar_init_fence();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, warp, 0) >= kCons / 32) {   // the producer warp: the diff tiles by TMA
    if (lane == 0)
      for (int c = 0; c < passes * nch; ++c) {
        const int slot = c % rp::kRaw;
        if (c >= rp::kRaw) impop::mbar_wait(&empty[slot], ((c / rp::kRaw) + 1) & 1);
        impop::fence_proxy_async();
        impop::mbar_expect_tx(&full[slot], kDiffBox);
        impop::tma_load(raw + slot * kDiffBox, &dmap, j0, (c % nch) * rp::kKc, w, &full[slot]);
      }
    return;
  }

  // the consumers: barrier rp::kSyncId
  for (int e = tid; e < 3 * p.t; e += kCons) dots[e] = p.dots[e];
  const float* x = p.x + static_cast<size_t>(w) * xrows * N;
  if (p.x_smem)
#pragma unroll 8
    for (int e = tid; e < xrows * kColTile; e += kCons) {
      const int row = e / kColTile, jj = e % kColTile;
      xcols[e] = j0 + jj < N ? x[static_cast<size_t>(row) * N + j0 + jj] : 0.0f;
    }
  const float* xd = p.x_smem ? xcols : x + j0;
  const int xstride = p.x_smem ? kColTile : N;
  // the 0/1 rows' packed words (rows rd .. rd + 63 here, later ones per
  // pass) and the packed present words of the block's columns (present
  // is symmetric, i == j cleared), loaded now beside the tables
  const int bs = bit_stride(N);
  uint32_t* xb = reinterpret_cast<uint32_t*>(csm + lay.bits);   // [kRowChunk, bs]
  uint32_t* pw_s = xb + kRowChunk * bs;                         // [kColTile, bs]
  const uint32_t* xbits = p.xbits + static_cast<size_t>(w) * p.rp * NW;
  const uint32_t* pres = p.pres + static_cast<size_t>(w) * N * NW;
  auto stage_rows = [&](int g0) {
#pragma unroll 8
    for (int e = tid; e < kRowChunk * NW; e += kCons) {
      const int rr = e / NW;
      xb[rr * bs + e % NW] = g0 + rr < xrows ? xbits[static_cast<size_t>(g0 - p.rd) * NW + e] : 0u;
    }
  };
  stage_rows(p.rd);
#pragma unroll 8
  for (int e = tid; e < kColTile * NW; e += kCons) {
    const int jj = j0 + e / NW, kw = e % NW;
    uint32_t word = jj < N ? pres[static_cast<size_t>(jj) * NW + kw] : 0u;
    if (kw == (jj >> 5)) word &= ~(1u << (jj & 31));   // i == j is not a pair
    pw_s[(e / NW) * bs + kw] = word;
  }
  impop::named_sync(rp::kSyncId, kCons);   // the tables are written

  // Chunk c: wait for its diff tile, turn each diff d of column j, i
  // values 8 ig .. + 7 into the three pieces of tab[d] = 1 - f32(1 - d /
  // len) (IEEE division and subtraction, as the reference rounds (1 -
  // sim); absent pairs and i == j: zero) in half c % 2 of the buffer,
  // release the ring slot.
  auto decode = [&](int c) {
    const int slot = c % rp::kRaw;
    impop::mbar_wait(&full[slot], (c / rp::kRaw) & 1);
    const uint16_t* dg = reinterpret_cast<const uint16_t*>(raw + slot * kDiffBox);
    uint8_t* ds = dec + (c & 1) * rp::kDecHalf;
#pragma unroll
    for (int it = tid; it < kColTile * (rp::kKc / 8); it += kCons) {
      const int j = it & (kColTile - 1), ig = it / kColTile;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = dg[(8 * ig + k) * kColTile + j];
        const float q = impop::div_rn(static_cast<float>(d), len, inv);
        v[k] = d == kAbsent ? 0.0f : __fsub_rn(1.0f, __fsub_rn(1.0f, q));
      }
      const rp::Pack8 o = rp::pack8(v);
      const int off = rp::kmajor(j, ig);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        *reinterpret_cast<uint4*>(ds + pc * rp::kPiece + off) = o.p[pc];
    }
    impop::fence_proxy_async();   // the pieces -> wgmma
    __syncwarp();
    if (lane == 0) impop::mbar_arrive(&empty[slot]);
  };

  // value rows: tile g of a pass is X rows [g0 + 64 g, + 64) of [0, rd)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), t128 = tid & 127;
  float* ys = reinterpret_cast<float*>(dec);   // [kPassRows, kColTile] after a pass
  for (int pass = 0; pass < passes; ++pass) {
    const int g0 = pass * kPassRows, row0 = g0 + wg * rp::kRows;
    const int rows = min(rp::kRows, p.rd - row0);
    float sum[32];
    // group weights (rows [0, R)) carry values; mask_a / mask_b rows are 0/1
    rp::tile_pass<kCons>(decode, dec, pass * nch, nch, x + static_cast<size_t>(row0) * N, N,
                         rows, N, false, row0 < p.r, t128, sum);
    if (rows > 0)
#pragma unroll
      for (int r = 0; r < 32; ++r)
        ys[(wg * rp::kRows + rp::acc_row(t128, r)) * kColTile + rp::acc_col(t128, r)] = sum[r];
    impop::named_sync(rp::kSyncId, kCons);
    tile_dots(p, dots, ys, xd, xstride, w, ct, j0, g0, min(g0 + kPassRows, p.rd), tid, kCons);
    impop::named_sync(rp::kSyncId, kCons);   // ys is read
  }

  // 0/1 rows: Σ popc(row word & column word) over the window's words, on
  // the tensor cores (mma m16n8k256 b1, AND + POPC into int32: exact
  // counts; padding rows are zero words and count zero); warp k takes
  // (16-row, 8-column) tiles k, k + n_warps, ...
  float* yb = reinterpret_cast<float*>(dec);   // [kRowChunk, kColTile]
  const int grp = lane >> 2, tig = lane & 3;
  for (int g0 = p.rd; g0 < xrows; g0 += kRowChunk) {
    if (g0 > p.rd) {
      impop::named_sync(rp::kSyncId, kCons);   // xb and yb of the previous pass are read
      stage_rows(g0);
      impop::named_sync(rp::kSyncId, kCons);
    }
    for (int tile = warp; tile < (kRowChunk / 16) * (kColTile / 8); tile += kCons / 32) {
      const int r0 = 16 * (tile / (kColTile / 8)), c0 = 8 * (tile % (kColTile / 8));
      const uint32_t* ra = xb + (r0 + grp) * bs;
      const uint32_t* rb = pw_s + (c0 + grp) * bs;
      int cnt[4] = {0, 0, 0, 0};
      for (int kb = 0; kb < NW; kb += 8) {
        const bool lo = kb + tig < NW, hi = kb + 4 + tig < NW;
        const uint32_t a0 = lo ? ra[kb + tig] : 0u, a1 = lo ? ra[8 * bs + kb + tig] : 0u;
        const uint32_t a2 = hi ? ra[kb + 4 + tig] : 0u, a3 = hi ? ra[8 * bs + kb + 4 + tig] : 0u;
        const uint32_t b0 = lo ? rb[kb + tig] : 0u, b1 = hi ? rb[kb + 4 + tig] : 0u;
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(cnt[0]), "+r"(cnt[1]), "+r"(cnt[2]), "+r"(cnt[3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          yb[(r0 + grp + 8 * h) * kColTile + c0 + 2 * tig + e] = static_cast<float>(cnt[2 * h + e]);
    }
    impop::named_sync(rp::kSyncId, kCons);
    tile_dots(p, dots, yb, xd, xstride, w, ct, j0, g0, min(g0 + kRowChunk, xrows), tid, kCons);
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
  const int tiles = rd <= rp::kRows ? 1 : 2;   // value-row tiles of a pass of C
  p.x_smem = sizeof(float) * (rd + rp) * kColTile <= kXSmemMax &&
             prod_layout(n, rd + rp, t, true, tiles).total <= static_cast<int>(kSmemCap);
  // phase C's TMA view of diff [w, n, n] uint16, in [32 i, 64 j] boxes
  CUtensorMap dmap{};
  if (rd > 0 && !impop::tensor_map_3d(&dmap, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, diff, n, n, w,
                                      n, kColTile, rp::kKc))
    return static_cast<int>(cudaErrorInvalidValue);
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
  const size_t prod_smem = prod_layout(n, rd + rp, t, p.x_smem, tiles).total;
  const void* prod = tiles == 1 ? reinterpret_cast<const void*>(window_products_kernel<1>)
                                : reinterpret_cast<const void*>(window_products_kernel<2>);
  err = set_smem(prod, prod_smem);
  if (err) return err;
  if (tiles == 1)
    window_products_kernel<1><<<dim3(w, p.nct), rp::threads(1), prod_smem, st>>>(p, dmap);
  else
    window_products_kernel<2><<<dim3(w, p.nct), rp::threads(2), prod_smem, st>>>(p, dmap);
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
