// Masked panel sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   impop_tpu/ops/panelquad.py  masked_pair_sums_pallas / _kernel
// for a batch of windows:
//
//   Yd = Wd . ((1 - sim) . mask),   Yp = Wp . mask,   mask = present & offdiag
//
// with sim [W, N, N] f32, present [W, N, N] uint8 (not assumed symmetric),
// Wd [W, Rd, N] and Wp [W, Rp, N] f32.  It serves the weighted (column-mode)
// scan, the matrices-out route and the per-statistic drivers.
//
// Two launches:
//   P  masked_rows_pack_kernel, one warp per (window, Wp row): is every
//      entry 0 or 1?  If so the row is bit-packed (32 columns a word) and
//      flagged; the product counts it by AND + popcount.  Rows with any
//      other value take the fp32 path.  Decided on the device: no host sync.
//   S  masked_pair_sums_kernel, one block per (window, 64 columns j).  The
//      i axis comes in chunks of 32 rows through a ring of kStages slots in
//      shared memory (cp.async: sim, present and the chunk's X values of
//      every value row, two chunks in flight while one is used), so each
//      window's sim / present are read once per column tile whatever
//      Rd + Rp is (up to kValueCap value rows; a larger stack takes a second
//      grid layer, which reads them again).  From each chunk the block
//      builds once, each thread 8 rows of one column:
//        - the (1 - sim) . mask tile (and, if some Wp row is not 0/1, the
//          mask as floats), which all value rows share;
//        - the chunk's mask word of every column j (bit k is
//          mask(i0 + k, j)), kept for the popcount rows (in shared memory
//          up to N = 4096, else in the wrapper's scratch).
//      Value rows (all of Wd, and Wp when it holds a row that is not 0/1):
//      a register-blocked fp32 product, each thread 4 rows x 4 columns of
//      up to two 64-row blocks (1 or 2 rows of a 16- or 32-row block for
//      small stacks, so that every warp takes a share), operands through
//      16-byte shared loads, i ascending (a row's sum is the same from run
//      to run; no TF32, no bf16: (1 - sim) carries real values).  0/1 rows
//      of Wp, after the last chunk: AND + popcount of the packed row
//      against the column's mask words, exact integers (below 2^24, as the
//      fp32 sums of the plain version are).
//
// What bounds it on this card: the 5 bytes of sim + present per element,
// read once; the value rows' FMAs (2 Rd flops per element) come next.
//
// The C function returns the first CUDA error of its launches; it never
// synchronises and never allocates (flags, packed rows and mask words are
// the wrapper's scratch).

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.cuh"

namespace {

using impop::set_smem;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColTile = 64;               // columns j per block
constexpr int kKc = 32;                    // rows i per staged chunk (one mask word)
constexpr int kRowBlock = 64;              // value rows per register block
constexpr int kRowBlocks = 2;              // register blocks per thread
constexpr int kValueCap = kRowBlock * kRowBlocks;  // value rows per block
constexpr int kRowPad = 16;                // stacks are padded to 16 rows
constexpr int kStages = 3;                 // chunks in the cp.async ring
constexpr int kXStride = kKc + 4;          // floats per staged X row
constexpr int kMcolSmemMax = 32 * 1024;    // mask words kept in shared memory
                                           // (ops/panelquad.py _MCOL_SMEM_MAX)
constexpr int kSimTile = kKc * kColTile;   // floats of one staged sim chunk
constexpr int kPresTile = kKc * kColTile / 4;  // floats holding the present bytes

struct SumParams {
  const float* sim;        // [W, N, N]
  const uint8_t* pres;     // [W, N, N]
  const float* wd;         // [W, rd, N]
  const float* wp;         // [W, rp, N]
  const int32_t* flags;    // [W, rp]     1: the Wp row is 0/1
  const uint32_t* wbits;   // [W, rp, nwc] the 0/1 rows, bit-packed
  uint32_t* mcol;          // [W, nct, nwc, kColTile] mask words of column j
  float* yd;               // [W, rd, N]
  float* yp;               // [W, rp, N]
  int n, rd, rp, rd_pad, rp_pad, nwc, nct;
  int vec;                 // 16-byte cp.async (N % 16 == 0, aligned bases)
  int xcap;                // value rows a ring slot holds (<= kValueCap)
  int mcol_smem;           // the mask words live in shared memory
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---- P: the 0/1 check and bit-packing of every Wp row
__global__ void __launch_bounds__(kThreads)
masked_rows_pack_kernel(const float* __restrict__ wp, int n, int rp, int nwc,
                        int32_t* __restrict__ flags, uint32_t* __restrict__ wbits) {
  const int w = blockIdx.y, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rp) return;
  const size_t row = static_cast<size_t>(w) * rp + r;
  const float* x = wp + row * n;
  uint32_t* out = wbits + row * nwc;
  bool binary = true;
  for (int kw = 0; kw < nwc; ++kw) {
    const int i = 32 * kw + lane;
    const float v = i < n ? x[i] : 0.0f;
    const uint32_t other = __ballot_sync(0xffffffffu, !(v == 0.0f || v == 1.0f));
    const uint32_t ones = __ballot_sync(0xffffffffu, v == 1.0f);
    if (lane == 0) out[kw] = ones;
    binary = binary && other == 0u;
  }
  if (lane == 0) flags[row] = binary ? 1 : 0;
}

// ---- S: one (window, column tile, value-row layer) per block.  kRt
// value rows per thread and row block (16 kRt rows a block; 1 and 2 for
// the drivers' small stacks, so that every warp shares the FMAs).
template <int kRt>
__device__ __forceinline__ void sums_tile(const SumParams& p, float* fsm, int w, int ct,
                                          int v_lo, int rx, bool wp_values, bool counts) {
  constexpr int kRows = 16 * kRt;                      // rows per row block
  constexpr int kBlocks = kRt == 4 ? kValueCap / kRows : 1;
  const int j0 = ct * kColTile;
  const int N = p.n, tid = threadIdx.x;
  const size_t nn = static_cast<size_t>(N) * N;
  const float* sim = p.sim + static_cast<size_t>(w) * nn;
  const uint8_t* pres = p.pres + static_cast<size_t>(w) * nn;
  const float* wd = p.wd + static_cast<size_t>(w) * p.rd * N;
  const float* wp = p.wp + static_cast<size_t>(w) * p.rp * N;
  const int32_t* flags = p.flags + static_cast<size_t>(w) * p.rp;

  const int stage_floats = kSimTile + kPresTile + p.xcap * kXStride;
  float* ds = fsm + kStages * stage_floats;    // [kKc, kColTile] (1 - sim) . mask
  float* ms = ds + kSimTile;                   // [kKc, kColTile] mask as floats
  uint8_t* mbytes = reinterpret_cast<uint8_t*>(ms + kSimTile);  // [kColTile, 4]
  // the mask words of every chunk: shared memory when they fit
  uint32_t* mcol = p.mcol_smem ? reinterpret_cast<uint32_t*>(mbytes + 4 * kColTile)
                               : p.mcol + (static_cast<size_t>(w) * p.nct + ct) * p.nwc * kColTile;

  // The X row of value row v (Wd rows, then Wp rows), or null for padding.
  auto xrow = [&](int v) -> const float* {
    if (v < p.rd_pad) return v < p.rd ? wd + static_cast<size_t>(v) * N : nullptr;
    const int r = v - p.rd_pad;
    return r < p.rp ? wp + static_cast<size_t>(r) * N : nullptr;
  };

  // sim, present and X rows [i0, i0 + kKc) of this tile into ring slot `slot`
  auto stage = [&](int slot, int i0) {
    float* ss = fsm + slot * stage_floats;
    uint8_t* ps = reinterpret_cast<uint8_t*>(ss + kSimTile);
    float* xs = ss + kSimTile + kPresTile;
    if (i0 < N) {
      if (p.vec) {
        for (int e = tid; e < kSimTile / 4; e += kThreads) {
          const int k = e >> 4, q = e & 15, i = i0 + k, j = j0 + 4 * q;
          const bool in = i < N && j < N;
          cp_async16(ss + k * kColTile + 4 * q, in ? sim + static_cast<size_t>(i) * N + j : sim,
                     in);
        }
        for (int e = tid; e < kSimTile / 16; e += kThreads) {
          const int k = e >> 2, q = e & 3, i = i0 + k, j = j0 + 16 * q;
          const bool in = i < N && j < N;
          cp_async16(ps + k * kColTile + 16 * q,
                     in ? pres + static_cast<size_t>(i) * N + j : pres, in);
        }
        for (int e = tid; e < rx * (kKc / 4); e += kThreads) {
          const int v = e >> 3, q = e & 7, i = i0 + 4 * q;
          const float* x = xrow(v_lo + v);
          const bool in = x != nullptr && i < N;
          cp_async16(xs + v * kXStride + 4 * q, in ? x + i : sim, in);
        }
      } else {   // any N: plain loads (made visible by the barriers that follow)
        for (int e = tid; e < kSimTile; e += kThreads) {
          const int k = e / kColTile, c = e % kColTile, i = i0 + k, j = j0 + c;
          const bool in = i < N && j < N;
          const size_t o = static_cast<size_t>(i) * N + j;
          ss[e] = in ? sim[o] : 0.0f;
          ps[e] = in ? pres[o] : 0;
        }
        for (int e = tid; e < rx * kKc; e += kThreads) {
          const int v = e / kKc, k = e % kKc, i = i0 + k;
          const float* x = xrow(v_lo + v);
          xs[v * kXStride + k] = (x != nullptr && i < N) ? x[i] : 0.0f;
        }
      }
    }
    cp_async_commit();   // empty past the last chunk: the wait count stays uniform
  };

  // rows kRt rg .. + kRt - 1 of each row block, columns 4 c4 .. + 3
  const int rg = tid >> 4, c4 = tid & 15;
  float acc[kBlocks][kRt][4];
#pragma unroll
  for (int rb = 0; rb < kBlocks; ++rb)
#pragma unroll
    for (int a = 0; a < kRt; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[rb][a][b] = 0.0f;

  const int n_chunks = (N + kKc - 1) / kKc;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) stage(c, c * kKc);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int i0 = ch * kKc;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk ch landed; chunk ch - 1's slot and tiles are read
    stage((ch + kStages - 1) % kStages, i0 + (kStages - 1) * kKc);
    const float* ss = fsm + (ch % kStages) * stage_floats;
    const uint8_t* ps = reinterpret_cast<const uint8_t*>(ss + kSimTile);
    const float* xs = ss + kSimTile + kPresTile;

    // the chunk's shared tiles: thread (column c, rows 8 q8 .. + 7); its
    // mask bits are byte q8 of column c's word (bit k is mask(i0 + k, j))
    {
      const int c = tid % kColTile, q8 = tid / kColTile, j = j0 + c;
      uint32_t bits = 0u;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k = 8 * q8 + q, e = k * kColTile + c;
        const bool mk = ps[e] != 0 && i0 + k != j;   // zero-filled past N
        ds[e] = mk ? __fsub_rn(1.0f, ss[e]) : 0.0f;
        if (wp_values) ms[e] = mk ? 1.0f : 0.0f;
        bits |= static_cast<uint32_t>(mk) << q;
      }
      if (counts) mbytes[4 * c + q8] = static_cast<uint8_t>(bits);
    }
    __syncthreads();
    if (counts && tid < kColTile)
      mcol[static_cast<size_t>(ch) * kColTile + tid] =
          *reinterpret_cast<const uint32_t*>(mbytes + 4 * tid);

    // value rows: fp32 FMA, i ascending
#pragma unroll
    for (int rb = 0; rb < kBlocks; ++rb) {
      const int g = rb * kRows + kRt * rg;   // staged row of this thread
      if (g >= rx) continue;                 // warp-uniform (rx is a multiple of 16)
      const float* mt = v_lo + g < p.rd_pad ? ds : ms;
      const float* xr = xs + g * kXStride;
#pragma unroll
      for (int k4 = 0; k4 < kKc / 4; ++k4) {
        float4 xv[kRt];
#pragma unroll
        for (int a = 0; a < kRt; ++a)
          xv[a] = *reinterpret_cast<const float4*>(xr + a * kXStride + 4 * k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 m = *reinterpret_cast<const float4*>(mt + (4 * k4 + kk) * kColTile + 4 * c4);
#pragma unroll
          for (int a = 0; a < kRt; ++a) {
            const float x = kk == 0 ? xv[a].x : kk == 1 ? xv[a].y : kk == 2 ? xv[a].z : xv[a].w;
            acc[rb][a][0] = fmaf(x, m.x, acc[rb][a][0]);
            acc[rb][a][1] = fmaf(x, m.y, acc[rb][a][1]);
            acc[rb][a][2] = fmaf(x, m.z, acc[rb][a][2]);
            acc[rb][a][3] = fmaf(x, m.w, acc[rb][a][3]);
          }
        }
      }
    }
  }

  // value rows out: Wd rows to Yd, Wp rows that are not 0/1 to Yp
#pragma unroll
  for (int rb = 0; rb < kBlocks; ++rb) {
    const int g = rb * kRows + kRt * rg;
    if (g >= rx) continue;
#pragma unroll
    for (int a = 0; a < kRt; ++a) {
      const int v = v_lo + g + a;
      float* y = nullptr;
      if (v < p.rd_pad) {
        if (v < p.rd) y = p.yd + (static_cast<size_t>(w) * p.rd + v) * N;
      } else {
        const int r = v - p.rd_pad;
        if (r < p.rp && flags[r] == 0) y = p.yp + (static_cast<size_t>(w) * p.rp + r) * N;
      }
      if (y == nullptr) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + 4 * c4 + b;
        if (j < N) y[j] = acc[rb][a][b];
      }
    }
  }
  if (!counts) return;

  // 0/1 rows of Wp: AND + popcount against column j's mask words
  __syncthreads();   // the mask words of every chunk are written
  const int c = tid % kColTile, rq = tid / kColTile, j = j0 + c;
  const uint32_t* wb = p.wbits + static_cast<size_t>(w) * p.rp * p.nwc;
  constexpr int kPer = kRowBlock / (kThreads / kColTile);
  for (int r0 = 0; r0 < p.rp; r0 += kRowBlock) {
    int cnt[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) cnt[m] = 0;
    const int rows = min(kPer, (p.rp - r0 - rq + 3) / 4);   // rows r0 + rq + 4 m < rp
#pragma unroll 4
    for (int kw = 0; kw < p.nwc; ++kw) {
      const uint32_t mc = mcol[static_cast<size_t>(kw) * kColTile + c];
#pragma unroll
      for (int m = 0; m < kPer; ++m)
        if (m < rows)
          cnt[m] += __popc(__ldg(wb + static_cast<size_t>(r0 + rq + 4 * m) * p.nwc + kw) & mc);
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int r = r0 + rq + (kThreads / kColTile) * m;
      if (m < rows && j < N && flags[r] != 0)
        p.yp[(static_cast<size_t>(w) * p.rp + r) * N + j] = static_cast<float>(cnt[m]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) masked_pair_sums_kernel(SumParams p) {
  extern __shared__ __align__(16) float fsm[];
  const int w = blockIdx.y, tid = threadIdx.x;
  const int32_t* flags = p.flags + static_cast<size_t>(w) * p.rp;
  // Wp joins the value rows only when one of its rows is not 0/1
  bool other = false;
  for (int r = tid; r < p.rp; r += kThreads) other = other || flags[r] == 0;
  const bool wp_values = __syncthreads_or(other);
  const int v_lo = blockIdx.z * kValueCap;                      // this layer's value rows
  const int v_hi = min(p.rd_pad + (wp_values ? p.rp_pad : 0), v_lo + kValueCap);
  const bool lead = blockIdx.z == 0;                            // builds the mask words
  if (!lead && v_lo >= v_hi) return;
  const int rx = max(v_hi - v_lo, 0);                           // multiple of 16
  const bool counts = lead && p.rp > 0;
  if (rx <= 16) sums_tile<1>(p, fsm, w, blockIdx.x, v_lo, rx, wp_values, counts);
  else if (rx <= 32) sums_tile<2>(p, fsm, w, blockIdx.x, v_lo, rx, wp_values, counts);
  else sums_tile<4>(p, fsm, w, blockIdx.x, v_lo, rx, wp_values, counts);
}

int pad_rows(int r) { return (r + kRowPad - 1) / kRowPad * kRowPad; }

}  // namespace

extern "C" {

// flags [w, rp] int32, wbits [w, rp, ceil(n/32)] and mcol
// [w, ceil(n/64), ceil(n/32), 64] uint32 are scratch; mcol is used only when
// a tile's mask words outgrow kMcolSmemMax (N > 4096), and may be null else.
int impop_masked_pair_sums(const void* sim, const void* present, const void* wd,
                           const void* wp, int w, int n, int rd, int rp, void* flags,
                           void* wbits, void* mcol, void* yd, void* yp, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SumParams p;
  p.sim = static_cast<const float*>(sim);
  p.pres = static_cast<const uint8_t*>(present);
  p.wd = static_cast<const float*>(wd);
  p.wp = static_cast<const float*>(wp);
  p.flags = static_cast<const int32_t*>(flags);
  p.wbits = static_cast<const uint32_t*>(wbits);
  p.mcol = static_cast<uint32_t*>(mcol);
  p.yd = static_cast<float*>(yd);
  p.yp = static_cast<float*>(yp);
  p.n = n; p.rd = rd; p.rp = rp;
  p.rd_pad = pad_rows(rd);
  p.rp_pad = pad_rows(rp);
  p.nwc = (n + 31) / 32;
  p.nct = (n + kColTile - 1) / kColTile;
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  p.vec = n % 16 == 0 && aligned(sim) && aligned(present) && aligned(wd) && aligned(wp);
  const int layers = (p.rd_pad + p.rp_pad + kValueCap - 1) / kValueCap;
  p.xcap = p.rd_pad + p.rp_pad < kValueCap ? p.rd_pad + p.rp_pad : kValueCap;
  const size_t mcol_bytes = sizeof(uint32_t) * p.nwc * kColTile;
  p.mcol_smem = mcol_bytes <= kMcolSmemMax;

  if (rp > 0) {
    masked_rows_pack_kernel<<<dim3((rp + kWarps - 1) / kWarps, w), kThreads, 0, st>>>(
        p.wp, n, rp, p.nwc, static_cast<int32_t*>(flags), static_cast<uint32_t*>(wbits));
  }
  const size_t smem =
      sizeof(float) * (kStages * (kSimTile + kPresTile + p.xcap * kXStride) + 2 * kSimTile +
                       kColTile) +
      (p.mcol_smem ? mcol_bytes : 0);
  const int err = set_smem(reinterpret_cast<const void*>(masked_pair_sums_kernel), smem);
  if (err) return err;
  masked_pair_sums_kernel<<<dim3(p.nct, w, layers), kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
