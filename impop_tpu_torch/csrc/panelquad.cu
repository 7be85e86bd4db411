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
//   P  masked_rows_pack_kernel, one warp per (window, row of [Wd; Wp]): is
//      every entry 0 or 1?  The flag decides, on the device (no host
//      sync), how many bf16 pieces the row's tile takes.
//   S  masked_pair_sums_kernel, one block per (window, 64 columns j, layer
//      of up to two 64-row tiles of the stacks [Wd tiles, Wp tiles]): the
//      value product of rowprod.cuh on the tensor cores.  The producer warp
//      keeps the sim and present tiles ([32 i, 64 j]) of the next four
//      chunks in flight by TMA, into a ring of slots with full / empty
//      mbarriers, so that no block-wide barrier waits on a load.  The
//      consumer warpgroups (one a tile) build chunk t + 1's B pieces while
//      their wgmma of chunk t runs, and meet at a named barrier the
//      producer never joins: the three bf16 pieces of (1 - sim) . mask
//      (when the layer holds a Wd tile) and the mask as one bf16 piece
//      (when it holds a Wp tile), built once per block and chunk for
//      every row of the tiles.  Warpgroup g loads its tile's X rows from
//      device memory two chunks ahead and splits them into three pieces
//      in registers (the wgmma's A operand): a Wd tile takes the six kept
//      products x_p . d_q with p + q <= 4 (three when all its rows are
//      0/1), a Wp tile x_p . mask for p = 1..3 (one when all its rows are
//      0/1).  Every product is exact in fp32; a chunk's products
//      accumulate in fp32 registers and the chunks are added in i order
//      with round-to-nearest adds, so a row's sum is the same from run to
//      run.  The dropped products are below 2^-21 of each term; never
//      TF32, never a single bf16 pass.  A 0/1 row of Wp sums exact 0/1
//      products to integers below 2^24: exactly the plain version's
//      counts.  Stacks past two tiles take further layers (grid z), which
//      read sim and present again.
//
// What bounds it on this card: the 5 bytes of sim + present per element,
// read once a layer (the columns scan's [512, 512] x 64: 84 MB, 25 us at
// 3.35 TB/s), and the tensor-core products (7 m64n64k16 a 16 x 64 block of
// pairs there, 15 GFLOP, 15 us at 989 TFLOP/s).  It runs at several times
// that (PERF.md), bound by latency like the window kernel's phase C: a
// block of two warpgroups is alone on its SM
// and waits once a chunk on its wgmma chain; at the drivers' 2 + 2 rows
// both tiles are almost empty, and their wgmma cost what full ones do.
//
// The TMA views need row strides of whole 16-byte units: the wrapper pads
// the rows of sim, present, Wd and Wp to ld, a multiple of 16 elements,
// when N is not one (the padding is never read).  The C function returns
// the first CUDA error of its launches; it never synchronises and never
// allocates (the flags are the wrapper's scratch).

#include <cstdint>
#include <cuda_runtime.h>

#include "kernels.cuh"
#include "rowprod.cuh"

namespace {

namespace rp = impop::rp;

using impop::set_smem;

constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kColTile = rp::kCols;            // columns j per block
constexpr int kSimBox = rp::kKc * kColTile * 4;  // a raw sim tile [32 i, 64 j]
constexpr int kPresBox = rp::kKc * kColTile;     // a raw present tile
constexpr int kTileBox = kSimBox + kPresBox;  // one ring slot

struct SumParams {
  const float* wd;         // [W, rd, ld]
  const float* wp;         // [W, rp, ld]
  const int32_t* flags;    // [W, rd + rp]  1: the row is 0/1
  float* yd;               // [W, rd, N]
  float* yp;               // [W, rp, N]
  int n, ld, rd, rp;
  int nd, tiles;           // Wd tiles; Wd and Wp tiles
};

// ---- P: the 0/1 check of every row of Wd and Wp
__global__ void __launch_bounds__(kPackThreads)
masked_rows_pack_kernel(const float* __restrict__ wd, const float* __restrict__ wp, int n,
                        int ld, int rd, int rp_rows, int32_t* __restrict__ flags) {
  const int w = blockIdx.y, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (r >= rd + rp_rows) return;
  const float* x = r < rd ? wd + (static_cast<size_t>(w) * rd + r) * ld
                          : wp + (static_cast<size_t>(w) * rp_rows + r - rd) * ld;
  bool binary = true;
  for (int i = lane; i < n; i += 32) {
    const float v = x[i];
    binary = binary && (v == 0.0f || v == 1.0f);
  }
  binary = __all_sync(0xffffffffu, binary);
  if (lane == 0) flags[static_cast<size_t>(w) * (rd + rp_rows) + r] = binary ? 1 : 0;
}

// ---- S: one (column tile, window, layer) per block; kTiles tiles a
// layer, warpgroup g multiplies tile g
template <int kTiles>
__global__ void __launch_bounds__(rp::threads(kTiles), 3 - kTiles)
    masked_pair_sums_kernel(SumParams p, const __grid_constant__ CUtensorMap smap,
                            const __grid_constant__ CUtensorMap pmap) {
  constexpr int kCons = 128 * kTiles;   // consumer threads
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + rp::kRaw;
  uint8_t* raw = smem + rp::kBarBytes;
  uint8_t* dec = raw + rp::kRaw * kTileBox;
  const int ct = blockIdx.x, w = blockIdx.y, j0 = ct * kColTile;
  const int N = p.n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nch = (N + rp::kKc - 1) / rp::kKc;

  // which B pieces the layer's tiles need: (1 - sim) . mask for a Wd
  // tile, the mask for a Wp tile
  bool need_d = false, need_m = false;
#pragma unroll
  for (int g = 0; g < kTiles; ++g) {
    const int gt = blockIdx.z * kTiles + g;
    need_d = need_d || gt < p.nd;
    need_m = need_m || (gt >= p.nd && gt < p.tiles);
  }

  if (tid == 0) {
    for (int q = 0; q < rp::kRaw; ++q) {
      impop::mbar_init(&full[q], 1);
      impop::mbar_init(&empty[q], kCons / 32);
    }
    impop::mbar_init_fence();
  }
  __syncthreads();

  if (__shfl_sync(0xffffffffu, warp, 0) >= kCons / 32) {   // the producer warp: sim and present tiles by TMA
    if (lane == 0)
      for (int c = 0; c < nch; ++c) {
        const int slot = c % rp::kRaw, i0 = c * rp::kKc;
        if (c >= rp::kRaw) impop::mbar_wait(&empty[slot], ((c / rp::kRaw) + 1) & 1);
        impop::fence_proxy_async();
        uint8_t* dst = raw + slot * kTileBox;
        impop::mbar_expect_tx(&full[slot], kTileBox);
        impop::tma_load(dst, &smap, j0, i0, w, &full[slot]);
        impop::tma_load(dst + kSimBox, &pmap, j0, i0, w, &full[slot]);
      }
    return;
  }

  // the consumers: barrier rp::kSyncId.  This warpgroup's tile: rows
  // [row0, row0 + rows) of Wd (d_tile) or Wp
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), t128 = tid & 127;
  const int gt = blockIdx.z * kTiles + wg;
  const bool d_tile = gt < p.nd;
  const int r_count = d_tile ? p.rd : p.rp;
  const int row0 = rp::kRows * (d_tile ? gt : gt - p.nd);
  const int rows = gt < p.tiles ? min(rp::kRows, r_count - row0) : 0;
  // does the tile hold a row that is not 0/1?  thread t128 reads row
  // t128's flag, the warpgroup ORs them
  const bool other = t128 < rows && p.flags[static_cast<size_t>(w) * (p.rd + p.rp) +
                                            (d_tile ? 0 : p.rd) + row0 + t128] == 0;
  const bool values = impop::named_or(rp::kSyncId + 1 + wg, 128, other);

  // Chunk c: wait for its tiles, build column j's pieces over i values
  // 8 ig .. + 7 in half c % 2 of the buffer, release the ring slot.
  auto decode = [&](int c) {
    const int slot = c % rp::kRaw;
    impop::mbar_wait(&full[slot], (c / rp::kRaw) & 1);
    const uint8_t* rs = raw + slot * kTileBox;
    const float* ss = reinterpret_cast<const float*>(rs);
    const uint8_t* ps = rs + kSimBox;
    uint8_t* ds = dec + (c & 1) * rp::kDecHalf;
#pragma unroll
    for (int it = tid; it < kColTile * (rp::kKc / 8); it += kCons) {
      const int j = it & (kColTile - 1), ig = it / kColTile;
      const int i0 = c * rp::kKc + 8 * ig, jg = j0 + j;
      float v[8];
      uint32_t mk = 0u;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = (8 * ig + k) * kColTile + j;
        const bool m = ps[e] != 0 && i0 + k != jg;   // zero-filled past N
        v[k] = m ? __fsub_rn(1.0f, ss[e]) : 0.0f;
        mk |= static_cast<uint32_t>(m) << k;
      }
      const int off = rp::kmajor(j, ig);
      if (need_d) {
        const rp::Pack8 o = rp::pack8(v);
#pragma unroll
        for (int pc = 0; pc < 3; ++pc)
          *reinterpret_cast<uint4*>(ds + pc * rp::kPiece + off) = o.p[pc];
      }
      if (need_m) {
        uint32_t q[4];
#pragma unroll
        for (int h = 0; h < 4; ++h)
          q[h] = ((mk >> (2 * h)) & 1u ? 0x3f80u : 0u) |
                 ((mk >> (2 * h + 1)) & 1u ? 0x3f800000u : 0u);
        *reinterpret_cast<uint4*>(ds + 3 * rp::kPiece + off) = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
    impop::fence_proxy_async();   // the pieces -> wgmma
    __syncwarp();
    if (lane == 0) impop::mbar_arrive(&empty[slot]);
  };

  const float* x = (d_tile ? p.wd : p.wp) + (static_cast<size_t>(w) * r_count + row0) * p.ld;
  float sum[32];
  rp::tile_pass<kCons>(decode, dec, 0, nch, x, p.ld, rows, N, !d_tile, values, t128, sum);
  if (rows <= 0) return;

  // the tile's rows out: Wd rows to Yd, Wp rows to Yp
  float* y = (d_tile ? p.yd : p.yp) + static_cast<size_t>(w) * r_count * N;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int row = rp::acc_row(t128, r), j = j0 + rp::acc_col(t128, r);
    if (row < rows && j < N) y[static_cast<size_t>(row0 + row) * N + j] = sum[r];
  }
}

template <int kTiles>
int launch_sums(const SumParams& p, dim3 grid, cudaStream_t st, const CUtensorMap& smap,
                const CUtensorMap& pmap) {
  const size_t smem = rp::kBarBytes + rp::kRaw * kTileBox + 2 * rp::kDecHalf;
  const int err = set_smem(reinterpret_cast<const void*>(masked_pair_sums_kernel<kTiles>), smem);
  if (err) return err;
  masked_pair_sums_kernel<kTiles><<<grid, rp::threads(kTiles), smem, st>>>(p, smap, pmap);
  return 0;
}

}  // namespace

extern "C" {

// Rows of sim, present, wd and wp are ld elements apart (ld % 16 == 0,
// ld >= n), every base 16-byte aligned; flags [w, rd + rp] int32 is
// scratch; yd / yp rows are n apart.
int impop_masked_pair_sums(const void* sim, const void* present, const void* wd,
                           const void* wp, int w, int n, int ld, int rd, int rp_rows,
                           void* flags, void* yd, void* yp, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SumParams p;
  p.wd = static_cast<const float*>(wd);
  p.wp = static_cast<const float*>(wp);
  p.flags = static_cast<const int32_t*>(flags);
  p.yd = static_cast<float*>(yd);
  p.yp = static_cast<float*>(yp);
  p.n = n;
  p.ld = ld;
  p.rd = rd;
  p.rp = rp_rows;
  p.nd = (rd + rp::kRows - 1) / rp::kRows;
  p.tiles = p.nd + (rp_rows + rp::kRows - 1) / rp::kRows;
  if (p.tiles == 0) return 0;
  CUtensorMap smap{}, pmap{};
  if (!impop::tensor_map_3d(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sim, n, n, w, ld,
                            kColTile, rp::kKc) ||
      !impop::tensor_map_3d(&pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, present, n, n, w, ld,
                            kColTile, rp::kKc))
    return static_cast<int>(cudaErrorInvalidValue);

  masked_rows_pack_kernel<<<dim3((rd + rp_rows + kPackWarps - 1) / kPackWarps, w), kPackThreads,
                            0, st>>>(p.wd, p.wp, n, ld, rd, rp_rows, static_cast<int32_t*>(flags));
  const int tiles = p.tiles > 1 ? 2 : 1;
  const dim3 grid((n + kColTile - 1) / kColTile, w, (p.tiles + tiles - 1) / tiles);
  const int err = tiles == 1 ? launch_sums<1>(p, grid, st, smap, pmap)
                             : launch_sums<2>(p, grid, st, smap, pmap);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
