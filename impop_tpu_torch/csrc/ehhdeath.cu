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
// The TPU kernel decodes the death ranks from the f32 exponents of
// bit-weighted bf16 Grams, because Mosaic has no bit scan; on Hopper the
// direct exact form is cheap.  Two launches, each over many blocks per
// window:
//   P1 ehh_pack_kernel, one block per (window, 32 rows).  The block ballots
//      the site mask into 32-site words and prefix-sums their popcounts
//      into base ranks (fi, n_act).  A warp takes 4 rows and loads their
//      calls of 4 site words before using any (the first 4 while the ranks
//      are summed); each 32-site word's alt bits are compacted by a warp
//      OR-reduction (__reduce_or_sync of 1 << in-word rank), and since the
//      ranks are contiguous the pieces fill a row's 64-bit words in order,
//      in a register: [N, nw] words of the [W, N, ceil(S/64)] scratch,
//      nw = ceil(n_act / 64).  The
//      block of rows 0-31 also writes fi / n_act, every member's allele,
//      the carrier list of each allele in ascending row order (a prefix
//      count over 32-row ballots) and the carrier counts.
//   P2 ehh_pairs_kernel, blocks over (window, tiles of 64 x 64 positions
//      on or above the diagonal of one allele's carrier list), so that
//      only same-allele pairs are walked.  A block stages its two row
//      groups' words in shared memory (read in place from device memory
//      when 2 x 64 x nw words pass 48 KiB); a thread takes 4 x 4 pairs and
//      finds death_r by __ffsll over the words above fi and death_l by
//      __clzll below it, reading only as many words as it takes.  A
//      thread sums its death ranks (32 bits) and turns them into steps in
//      an int64; then a block sum and one 64-bit integer atomicAdd into
//      sums[w, a] (the wrapper zeroes sums; integer sums are the same in
//      any order).
//
// What bounds it on this card: P2's pair walks (C(n_0, 2) + C(n_1, 2) per
// window, a few shared-memory loads and bit scans each); P1 reads the
// int8 tile once.
//
// The C function returns the first CUDA error of its launches; it never
// synchronises and never allocates.

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

using impop::set_smem;
using impop::warp_sum_u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPackRows = 32;              // rows per block of P1
constexpr int kRowsPerWarp = kPackRows / kWarps;
constexpr int kWordsAhead = 4;             // site words a warp loads ahead in P1
constexpr int kTile = 64;                  // list positions per side of a P2 tile
constexpr int kSub = kTile / 16;           // rows per thread and side (16 x 16 threads)
constexpr size_t kStageMax = 48 * 1024;    // P2 stages its words up to this size
constexpr int kPairBlocksPerSm = 32;       // P2 blocks aimed at per SM

struct EhhParams {
  const int8_t* geno;        // [W, N, S]
  const uint8_t* member;     // [W, N]
  const uint8_t* smask;      // [W, S]
  const int32_t* focal;      // [W]
  int n, s;
  unsigned long long* xc;    // [W, N, ceil(S/64)] alt bits by rank
  int32_t* meta;             // [W, 2] fi, n_act
  int32_t* lists;            // [W, 2, N] carriers of each allele, ascending
  unsigned long long* sums;  // [W, 2] zeroed
  int32_t* carr;             // [W, 2]
};

// Exclusive prefix sums of cnt[0, count) in place, by one warp; returns
// the total.
__device__ int warp_scan_excl(int* cnt, int count, int lane) {
  int run = 0;
  for (int k0 = 0; k0 < count; k0 += 32) {
    const int k = k0 + lane;
    const int c = k < count ? cnt[k] : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (k < count) cnt[k] = run + x - c;
    run += __shfl_sync(0xffffffffu, x, 31);
  }
  __syncwarp();
  return run;
}

size_t pack_smem_bytes(int n, int s) {
  const int sw = (s + 31) / 32, nc = (n + 31) / 32;
  return sizeof(uint32_t) * 2 * sw + sizeof(int) * 4 * nc;
}

// ---- P1: compacted rows of 32 haplotypes; in block y = 0 the carriers
__global__ void __launch_bounds__(kThreads) ehh_pack_kernel(EhhParams p) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_nact;
  const int w = blockIdx.x, i_lo = blockIdx.y * kPackRows;
  const int N = p.n, S = p.s, SW = (S + 31) / 32, SW64 = (S + 63) / 64, NC = (N + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t* act = smem;                                   // [SW] active-site words
  int* base = reinterpret_cast<int*>(act + SW);           // [SW] their base ranks
  const int8_t* g = p.geno + static_cast<size_t>(w) * N * S;
  const uint8_t* sm = p.smask + static_cast<size_t>(w) * S;
  const int f = p.focal[w];

  // kRowsPerWarp rows a warp; their calls of kWordsAhead site words are
  // loaded before any is used, the first ones before the ranks below, so
  // that those loads overlap the rank prologue
  const int8_t* gi[kRowsPerWarp];
  unsigned long long* out[kRowsPerWarp];
  unsigned long long cur[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m) {
    const int i = i_lo + warp + kWarps * m;
    row_ok[m] = i < N;
    gi[m] = g + static_cast<size_t>(i) * S;
    out[m] = p.xc + (static_cast<size_t>(w) * N + i) * SW64;
    cur[m] = 0ull;
  }
  int8_t v[kRowsPerWarp][kWordsAhead];
  auto load_calls = [&](int k0) {
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m)
#pragma unroll
      for (int kk = 0; kk < kWordsAhead; ++kk) {
        const int site = 32 * (k0 + kk) + lane;
        v[m][kk] = row_ok[m] && site < S ? gi[m][site] : 0;
      }
  };
  load_calls(0);

  for (int k = warp; k < SW; k += kWarps) {
    const int site = 32 * k + lane;
    const uint32_t word = __ballot_sync(0xffffffffu, site < S && sm[site]);
    if (lane == 0) {
      act[k] = word;
      base[k] = __popc(word);
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int n_act = warp_scan_excl(base, SW, lane);
    if (lane == 0) {
      s_nact = n_act;
      if (blockIdx.y == 0) {
        int fi = 0;
        if (f >= S) fi = n_act;
        else if (f > 0) fi = base[f >> 5] + __popc(act[f >> 5] & ((1u << (f & 31)) - 1u));
        p.meta[2 * w] = fi;
        p.meta[2 * w + 1] = n_act;
      }
    }
  }
  __syncthreads();

  // words past ceil(n_act / 64) are never read
  if (s_nact > 0) {
    int cur_k = 0;   // the 64-bit word being filled: the same for every row
    for (int k0 = 0; k0 < SW; k0 += kWordsAhead) {
      if (k0) load_calls(k0);
#pragma unroll
      for (int kk = 0; kk < kWordsAhead; ++kk) {
        const int k = k0 + kk;
        if (k >= SW) break;
        const uint32_t aw = act[k];
        if (!aw) continue;
        // the word's active sites compacted: bit q = the q-th one's call
        const bool on = (aw >> lane) & 1u;
        const uint32_t bit = 1u << __popc(aw & ((1u << lane) - 1u));
        const int r0 = base[k], kw = r0 >> 6, off = r0 & 63;
        const bool spill = off + __popc(aw) > 64;   // runs into word kw + 1
#pragma unroll
        for (int m = 0; m < kRowsPerWarp; ++m) {
          const unsigned long long c =
              __reduce_or_sync(0xffffffffu, on && v[m][kk] == 1 ? bit : 0u);
          if (kw != cur_k) {   // the ranks are contiguous: kw == cur_k + 1
            if (lane == 0 && row_ok[m]) out[m][cur_k] = cur[m];
            cur[m] = 0ull;
          }
          cur[m] |= c << off;
          if (spill) {
            if (lane == 0 && row_ok[m]) out[m][kw] = cur[m];
            cur[m] = c >> (64 - off);
          }
        }
        cur_k = spill ? kw + 1 : kw;
      }
    }
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m)
      if (lane == 0 && row_ok[m]) out[m][cur_k] = cur[m];
  }
  if (blockIdx.y != 0) return;

  // alleles, carrier lists and counts of the whole window
  int* cnt = base + SW;                                   // [2, NC] per-chunk counts
  uint32_t* bw = reinterpret_cast<uint32_t*>(cnt + 2 * NC);  // [2, NC] carrier bits
  const uint8_t* mem = p.member + static_cast<size_t>(w) * N;
  const bool f_in = f >= 0 && f < S;
  for (int c = warp; c < NC; c += kWarps) {
    const int i = 32 * c + lane;
    const bool in = i < N && mem[i];
    const bool alt = in && f_in && g[static_cast<size_t>(i) * S + f] == 1;
    const uint32_t b1 = __ballot_sync(0xffffffffu, alt);
    const uint32_t b0 = __ballot_sync(0xffffffffu, in && !alt);
    if (lane == 0) {
      bw[c] = b0;
      bw[NC + c] = b1;
      cnt[c] = __popc(b0);
      cnt[NC + c] = __popc(b1);
    }
  }
  __syncthreads();
  if (warp < 2) {
    const int total = warp_scan_excl(cnt + warp * NC, NC, lane);
    if (lane == 0) p.carr[2 * w + warp] = total;
  }
  __syncthreads();
  for (int e = tid; e < 2 * NC * 32; e += kThreads) {
    const int a = e / (32 * NC), c = (e / 32) % NC, l = e % 32;
    const uint32_t word = bw[a * NC + c];
    if ((word >> l) & 1u)
      p.lists[(static_cast<size_t>(w) * 2 + a) * N + cnt[a * NC + c] +
              __popc(word & ((1u << l) - 1u))] = 32 * c + l;
  }
}

// ---- P2: same-allele carrier pairs, one 64 x 64 tile of list positions
// at a time; the blocks of a window stride over its tiles
__global__ void __launch_bounds__(kThreads) ehh_pairs_kernel(EhhParams p, int staged) {
  extern __shared__ unsigned long long swords[];   // [2, kTile, nwp] when staged
  __shared__ int s_rows[2][kTile];
  __shared__ unsigned long long s_part[kWarps];
  const int w = blockIdx.x, N = p.n, SW64 = (p.s + 63) / 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int py = tid / 16, qx = tid % 16;
  const int fi = p.meta[2 * w], n_act = p.meta[2 * w + 1];
  const int nw = (n_act + 63) / 64, nwp = nw | 1;   // odd row pitch: no bank conflicts
  const int c0 = p.carr[2 * w], c1 = p.carr[2 * w + 1];
  const int t0 = (c0 + kTile - 1) / kTile, t1 = (c1 + kTile - 1) / kTile;
  const int tiles0 = t0 * (t0 + 1) / 2, tiles = tiles0 + t1 * (t1 + 1) / 2;
  const unsigned long long* xw = p.xc + static_cast<size_t>(w) * N * SW64;
  const int kr0 = (fi + 1) >> 6;                                   // right: ranks > fi
  const unsigned long long keep_r0 = ~0ull << ((fi + 1) & 63);
  const int kl0 = (fi - 1) >> 6, bl0 = (fi - 1) & 63;              // left: ranks < fi
  const unsigned long long keep_l0 = bl0 < 63 ? (2ull << bl0) - 1ull : ~0ull;
  const int right_rest = max(n_act - fi - 1, 0);                    // death_r = n_act

  for (int q = blockIdx.y; q < tiles; q += gridDim.y) {
    const int a = q < tiles0 ? 0 : 1;
    const int t = a ? t1 : t0, c = a ? c1 : c0;
    int rem = a ? q - tiles0 : q, ta = 0;
    while (rem >= t - ta) {
      rem -= t - ta;
      ++ta;
    }
    const int tb = ta + rem;
    const int32_t* list = p.lists + (static_cast<size_t>(w) * 2 + a) * N;
    __syncthreads();   // the previous tile's rows, words and partials are read
    if (tid < 2 * kTile) {
      const int side = tid / kTile, pp = tid % kTile;
      const int pos = (side ? tb : ta) * kTile + pp;
      s_rows[side][pp] = pos < c ? list[pos] : -1;
    }
    __syncthreads();

    const unsigned long long* wa;
    const unsigned long long* wb;
    int ia[kSub], ib[kSub], pitch;
    if (staged) {
      for (int e = tid; e < 2 * kTile * nw; e += kThreads) {
        const int side = e / (kTile * nw), pp = (e / nw) % kTile, k = e % nw;
        const int row = s_rows[side][pp];
        swords[(side * kTile + pp) * nwp + k] = row >= 0 ? xw[static_cast<size_t>(row) * SW64 + k] : 0ull;
      }
      __syncthreads();
      wa = swords;
      wb = swords + kTile * nwp;
      pitch = nwp;
#pragma unroll
      for (int m = 0; m < kSub; ++m) {
        ia[m] = py + 16 * m;
        ib[m] = qx + 16 * m;
      }
    } else {
      wa = wb = xw;
      pitch = SW64;
#pragma unroll
      for (int m = 0; m < kSub; ++m) {
        ia[m] = max(s_rows[0][py + 16 * m], 0);
        ib[m] = max(s_rows[1][qx + 16 * m], 0);
      }
    }
    uint32_t valid = 0u;   // bit 4 m + m2: pair (py + 16 m, qx + 16 m2)
#pragma unroll
    for (int m = 0; m < kSub; ++m)
#pragma unroll
      for (int m2 = 0; m2 < kSub; ++m2) {
        const int pa = py + 16 * m, pb = qx + 16 * m2;
        const bool ok = ta * kTile + pa < c && tb * kTile + pb < c && (ta < tb || pa < pb);
        valid |= static_cast<uint32_t>(ok) << (kSub * m + m2);
      }

    // right of the focal: the bits kept are ranks fi + 1 .. n_act - 1, so
    // a pair that dies at rank d adds d - fi - 1 >= 0 steps (positions
    // summed in 32 bits: 16 pairs of at most 65 536 ranks)
    int dsum = 0, dcnt = 0;
    uint32_t pend = valid;
    for (int k = kr0; k < nw && pend; ++k) {
      const unsigned long long keep = k == kr0 ? keep_r0 : ~0ull;
      unsigned long long av[kSub], bv[kSub];
#pragma unroll
      for (int m = 0; m < kSub; ++m) {
        av[m] = wa[ia[m] * pitch + k];
        bv[m] = wb[ib[m] * pitch + k];
      }
#pragma unroll
      for (int e = 0; e < kSub * kSub; ++e) {
        const unsigned long long d = (av[e / kSub] ^ bv[e % kSub]) & keep;
        if (((pend >> e) & 1u) && d) {
          dsum += 64 * k + __ffsll(static_cast<long long>(d)) - 1;
          ++dcnt;
          pend &= ~(1u << e);
        }
      }
    }
    long long steps = static_cast<long long>(dsum) - static_cast<long long>(dcnt) * (fi + 1) +
                      static_cast<long long>(__popc(pend)) * right_rest;   // death_r = n_act
    // left of the focal: ranks 0 .. fi - 1; a death at rank d adds
    // fi - 1 - d >= 0
    dsum = 0;
    dcnt = 0;
    pend = fi >= 1 ? valid : 0u;
    for (int k = kl0; k >= 0 && pend; --k) {
      const unsigned long long keep = k == kl0 ? keep_l0 : ~0ull;
      unsigned long long av[kSub], bv[kSub];
#pragma unroll
      for (int m = 0; m < kSub; ++m) {
        av[m] = wa[ia[m] * pitch + k];
        bv[m] = wb[ib[m] * pitch + k];
      }
#pragma unroll
      for (int e = 0; e < kSub * kSub; ++e) {
        const unsigned long long d = (av[e / kSub] ^ bv[e % kSub]) & keep;
        if (((pend >> e) & 1u) && d) {
          dsum += 64 * k + 63 - __clzll(static_cast<long long>(d));
          ++dcnt;
          pend &= ~(1u << e);
        }
      }
    }
    steps += static_cast<long long>(dcnt) * (fi - 1) - dsum +
             static_cast<long long>(__popc(pend)) * fi;   // death_l = -1
    unsigned long long acc = static_cast<unsigned long long>(steps);

    acc = warp_sum_u64(acc);
    if (lane == 0) s_part[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      unsigned long long tot = 0ull;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) tot += s_part[v];
      if (tot) atomicAdd(&p.sums[2 * w + a], tot);
    }
  }
}

}  // namespace

extern "C" {

int impop_ehh_area(const void* geno, const void* member, const void* smask, const void* focal,
                   int w, int n, int s, void* xc, void* meta, void* lists, void* sums,
                   void* carr, void* stream) {
  EhhParams p;
  p.geno = static_cast<const int8_t*>(geno);
  p.member = static_cast<const uint8_t*>(member);
  p.smask = static_cast<const uint8_t*>(smask);
  p.focal = static_cast<const int32_t*>(focal);
  p.n = n;
  p.s = s;
  p.xc = static_cast<unsigned long long*>(xc);
  p.meta = static_cast<int32_t*>(meta);
  p.lists = static_cast<int32_t*>(lists);
  p.sums = static_cast<unsigned long long*>(sums);
  p.carr = static_cast<int32_t*>(carr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  const size_t pack_smem = pack_smem_bytes(n, s);
  int err = set_smem(reinterpret_cast<const void*>(ehh_pack_kernel), pack_smem);
  if (err) return err;
  ehh_pack_kernel<<<dim3(w, (n + kPackRows - 1) / kPackRows), kThreads, pack_smem, st>>>(p);

  // tiles of one window: T(t0) + T(t1) <= T(t0 + t1), t0 + t1 <= ceil(N / kTile) + 1
  const int tmax = (n + kTile - 1) / kTile + 1;
  const int tiles_max = tmax * (tmax + 1) / 2;
  static int sms = 0;   // asked once, outside any graph capture that follows
  if (sms == 0) {
    int dev = 0;
    err = static_cast<int>(cudaGetDevice(&dev));
    if (!err) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (err) return err;
  }
  const int per_window = (kPairBlocksPerSm * sms + w - 1) / w;
  const int gy = per_window < 1 ? 1 : (per_window > tiles_max ? tiles_max : per_window);
  const size_t stage = sizeof(unsigned long long) * 2 * kTile * (((s + 63) / 64) | 1);
  const int staged = stage <= kStageMax;
  ehh_pairs_kernel<<<dim3(w, gy), kThreads, staged ? stage : 0, st>>>(p, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
