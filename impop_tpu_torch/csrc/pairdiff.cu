// Identity from allele tiles for Hopper (sm_90a): the Grams on the tensor
// cores, one kernel for unit weights and one for column weights.
//
// Unit weights, unit_gram_kernel.  Replaces the unit-weight Pallas TPU
// kernels of the JAX package, which compute one function on three TPU
// schedules:
//   impop_tpu/ops/pairdiff.py:403  pairwise_identity_pallas (tri-resident,
//                                  N <= 512, operand column in VMEM)
//   impop_tpu/ops/pairdiff.py:460  pairwise_identity_pallas (N > 512,
//                                  streamed tile pairs)
//   impop_tpu/ops/pairdiff.py:281  _pairwise_identity_pallas_i8 (the same
//                                  Grams on int8 operands)
// With v = valid (call >= 0, active site) and z = 2 max(g, 0) - v:
//
//   compared = v.v^T,   zz = z.z^T,   diff = (compared - zz) / 2
//   present  = compared > 0 & member_i & member_j
//   sim      = present ? 1 - diff / max(length, 1) : 0
//
// and the member diagonal forced to sim 1, present true (member enters
// only here: a non-member row is never present).  The int32 sums are exact
// for every code whose z still fits int8 (g <= 63), so sim and present
// equal the plain version's for any summation order.
//
// Column weights, weighted_gram_kernel.  Replaces the weighted branch of
//   impop_tpu/ops/pairdiff.py:486  pairwise_identity_pallas(site_weights=...)
// With a = call at a valid site, c = v - a (biallelic codes; a code above 1
// counts as the alt allele) and per-site weights w:
//
//   diff = sum_s w_s (a_i c_j + c_i a_j),   compared = v.v^T
//
// and the same epilogue.  Each fp32 weight is split exactly into three bf16
// pieces w = w1 + w2 + w3 (each the top 8 significant bits of what is left,
// rounded toward zero, so every piece is >= 0 for w >= 0 and the three
// cover all 24 bits of the fp32 significand).  The row operand of piece p
// is [a w_p | c w_p] and the column operand [c | a]: 0/1 times a bf16 piece
// is exact, so every product is exact and only the fp32 accumulation
// rounds.  With integer weights (indel lengths) and per-pair sums below
// 2^24 every partial sum is an exact integer: sim and present equal the
// plain version's.  Non-integer weights agree within fp32 rounding of the
// sums (relative 2^-24 per addition).  A stage runs only the pieces it
// needs (block-uniform, decided on the device by __syncthreads_or): integer
// weights below 256 need one.  Never TF32.
//
// Unit weights, design (unit_gram_kernel).  One CTA of 256 threads (two
// warpgroups) per (window, 128 x 128 output tile pair ti <= tj, site
// split); the lower triangle is never computed.
//   loads   thread 0 keeps the raw int8 tiles of the next stages in
//           flight, one TMA box (cp.async.bulk.tensor) of 64 sites x 128
//           rows for the i rows (none on a diagonal tile) and one for the
//           j rows, and a bulk copy of the site mask, into a 6-deep ring;
//           completion on an mbarrier per slot.  Out-of-bounds rows and
//           sites arrive as zeros.
//   decode  every warp turns stage t + 1 into z and v in the K-major
//           core-matrix layout wgmma reads (8 rows x 16 bytes per core
//           matrix, no swizzle), double-buffered;
//   math    meanwhile each warpgroup's wgmma.mma_async m64n128k32 s8 ->
//           s32 of stage t runs for its 64 rows, z.z^T and v.v^T from
//           shared memory, int32 accumulators in registers (2 x 64 per
//           thread, about 165 registers in all, one CTA per SM).
// compared = v.v^T on the tensor cores costs what z.z^T costs; a popcount
// of packed v on the CUDA cores would take about as long as the whole
// kernel at these shapes.  Two barriers per stage order the decode with
// the products.  The epilogue stages sim / present in shared memory and
// writes the (i, j) tile and its mirror (j, i) with 16-byte stores.
// Warp specialisation (a producer warpgroup decoding for a consumer
// warpgroup, two CTAs per SM) was tried first: setmaxnreg did not give
// the consumer room for its 128 accumulators without spills, and four
// decoding warps per SM could not keep up with wgmma (PERF.md).
//
// Weighted, design (weighted_gram_kernel, the first tensor-core design,
// kept).  One block of 512 threads (16 warps, each
// 32 x 32 outputs) per (window, 128 x 128 output tile pair ti <= tj, site
// split).  Raw int8 tiles of the 2 x 128 rows (one set on a diagonal tile),
// the site mask and the weights stream through a 4-deep cp.async ring of
// 16-byte copies; each stage is decoded once into double-buffered operand
// tiles in shared memory.  Fragments come from ldmatrix; math is mma.sync
// m16n8k16 bf16 -> f32 (weighted diff) and m16n8k32 s8 -> s32 (v Gram).
// The epilogue stages the sim (f32) and present (u8) tile in shared memory
// and writes the (i, j) tile and its mirror (j, i) with 16-byte stores.
//
// Filling the card (both): the wrapper picks the site split
// (ops/pairdiff.py identity_partition).  With one split the main kernel
// runs the epilogue; with more, each split writes its accumulators to a
// scratch the wrapper allocates (coalesced, [split][tile][register]
// [thread]) and a reduce kernel sums them in split order (int32 exactly;
// f32 in a fixed order) and runs the same epilogue.
//
// Ragged shapes: any N (a tile pair runs whole: rows past N are never
// loaded, decode as zero and are never stored; the output stores fall back
// to scalars when N % 4 (f32) or N % 16 (u8) leaves rows unaligned).
// S must be a multiple of 16 so that every copy is 16-byte
// aligned: the wrapper pads S once (masked columns) when it is not, which
// costs one copy of the tile, and only on that path.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8,
// 989 TFLOP/s bf16).  Unit weights, [512, 2048] x 64: 67 MB of int8 in and
// 84 MB of sim + present out, 45 us of bytes, against 69 GOP of int8 on the
// triangle (35 us): bytes.  [512, 8192] x 8: 34 GOP (17 us) against 44 MB
// (13 us): operations, and only 80 tile pairs for 132 SMs, which the site
// split addresses.  Weighted, [512, 128] x 64: 88 MB of bytes (26 us)
// against 4.3 GFLOP of bf16 (4 us): bytes, so the epilogue's stores
// dominate and the coalesced mirrored writes are what matters.
//
// The C functions return the first CUDA error of their launches; they never
// synchronise and never allocate.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "kernels.cuh"
#include "rowprod.cuh"

namespace {

constexpr int kThreads = 512;          // 16 warps: 4 x 4 of 32 x 32 outputs
constexpr int kMt = 2;                  // m16 tiles per warp (32 rows)
constexpr int kTile = 128;              // output tile edge
constexpr int kStages = 4;              // cp.async ring depth
constexpr int kAccRegs = 64;            // accumulator registers per thread
constexpr int kSimStride = kTile + 4;   // staged sim row, floats (16-byte rows)
constexpr int kPresStride = kTile + 16; // staged present row, bytes
constexpr int kEpilogueSmem = 4 * kTile * kSimStride + kTile * kPresStride;

// The weighted kernel's stage geometry and shared-memory layout.
struct Cfg {
  static constexpr int kKt = 32;
  static constexpr int kPiece = 4 * kKt + 16;             // [a w | c w] bf16 row
  static constexpr int kV = kKt + 16;                     // v row, bytes
  // three pieces, the column operand [c | a], v_i, v_j
  static constexpr int kDecBytes = 4 * kTile * kPiece + 2 * kTile * kV;
  static constexpr int kRawBytes = kStages * 2 * kTile * kKt;
  static constexpr int kSmkOff = kRawBytes;
  static constexpr int kWtOff = kSmkOff + kStages * kKt;
  static constexpr int kDecOff = kWtOff + kStages * kKt * 4;
  static constexpr int kSmem = kDecOff + 2 * kDecBytes;
};

static_assert(Cfg::kSmem >= kEpilogueSmem, "epilogue reuses the ring");
static_assert(Cfg::kSmem <= 232448, "weighted kernel's shared memory");

struct GramArgs {
  const int8_t* geno;      // [W, N, S], S % 16 == 0
  const uint8_t* member;   // [W, N]
  const uint8_t* smask;    // [W, S]
  const float* weights;    // [W, S] (weighted kernel only)
  const float* length;     // [W]
  int n, s, t_blocks, pairs, splits, chunk;  // chunk: stages per split
  int* scratch;            // [splits, W * pairs, kAccRegs, kThreads] when splits > 1
  float* sim;              // [W, N, N]
  uint8_t* pres;           // [W, N, N]
};

struct Acc {
  float d[kMt][4][4];  // diff
  int v[kMt][4][4];    // compared = v.v^T
};

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; a false predicate copies nothing and
// zero-fills the 16 bytes (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// No "memory" clobber: the barriers order shared memory, and without it
// the compiler may interleave a warp's decode with its matrix math.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 32-byte deep step (k32 of int8, k16 of bf16: the fragment layouts
// agree byte for byte) of this warp's 32 x 32 outputs: A rows [row0, +32)
// of a tile with row stride `sa`, B rows [col0, +32) with stride `sb`, both
// at byte offset kb.  ldmatrix.x4 gives A's four 8 x 16-byte matrices
// (rows 0-7 / 8-15 x bytes 0-15 / 16-31) and two n8 tiles of B.
template <class T>
__device__ __forceinline__ void warp_step(T (&acc)[kMt][4][4], const uint8_t* a_base, int sa,
                                          const uint8_t* b_base, int sb, int row0, int col0,
                                          int kb, int lane) {
  uint32_t b[2][4];
  const int br = (lane & 7) + (lane >> 4) * 8, bk = kb + ((lane >> 3) & 1) * 16;
  ldsm_x4(b[0], b_base + (col0 + br) * sb + bk);
  ldsm_x4(b[1], b_base + (col0 + 16 + br) * sb + bk);
  const int ar = (lane & 7) + ((lane >> 3) & 1) * 8, ak = kb + (lane >> 4) * 16;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    uint32_t a[4];
    ldsm_x4(a, a_base + (row0 + mt * 16 + ar) * sa + ak);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma(acc[mt][nt], a, b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
  }
}

// ------------------------------------------------------------------ tiles

// Linear tile-pair index -> (ti, tj), row-major over ti <= tj (mirrored by
// ops/pairdiff.py tile_pair).
__device__ __forceinline__ void tile_pair(int p, int t, int& ti, int& tj) {
  ti = 0;
  while (p >= t - ti) {
    p -= t - ti;
    ++ti;
  }
  tj = ti + p;
}

// Stage `kt` (sites kt * kKt ...) of rows i0.. (and j0.. unless diag) into
// ring slot `slot`.
__device__ __forceinline__ void load_stage(uint8_t* smem, int slot, int kt, const int8_t* g,
                                           const uint8_t* sm, const float* wt, int n, int s,
                                           int i0, int j0, bool diag, int tid) {
  using C = Cfg;
  constexpr int kChunks = C::kKt / 16;
  uint8_t* raw = smem + slot * 2 * kTile * C::kKt;
  const int site0 = kt * C::kKt;
  const int count = (diag ? 1 : 2) * kTile * kChunks;
  for (int e = tid; e < count; e += kThreads) {
    const int part = e / (kTile * kChunks), rem = e % (kTile * kChunks);
    const int r = rem / kChunks, c = rem % kChunks;
    const int row = (part ? j0 : i0) + r, site = site0 + c * 16;
    const bool ok = row < n && site < s;
    cp_async16(raw + (part * kTile + r) * C::kKt + c * 16,
               ok ? g + static_cast<size_t>(row) * s + site : g, ok);
  }
  if (tid < kChunks) {
    const int site = site0 + tid * 16;
    cp_async16(smem + C::kSmkOff + slot * C::kKt + tid * 16, site < s ? sm + site : sm,
               site < s);
  }
  if (tid >= 32 && tid < 32 + C::kKt / 4) {
    const int site = site0 + (tid - 32) * 4;
    cp_async16(smem + C::kWtOff + 4 * (slot * C::kKt + (tid - 32) * 4),
               site < s ? wt + site : wt, site < s);
  }
}

// Byte-parallel decode of four sites (plain integer ops: the __v*4 SIMD
// intrinsics are emulated on sm_90).  g: four int8 codes; m: the site mask
// bytes, 0 or 1.  Returns 0x01 per valid byte (call >= 0 at an active site).
__device__ __forceinline__ uint32_t valid_bits(uint32_t g, uint32_t m) {
  return (~g >> 7) & m & 0x01010101u;  // bit 7 of each byte, inverted
}

// z = 2g - 1 on valid bytes (0 elsewhere), for codes 0..63: 2g has bit 7
// clear, so adding 0x7f per byte cannot carry, and flipping bit 7 of
// 2g + 0x7f gives 2g - 1 mod 256.
__device__ __forceinline__ uint32_t z_bytes(uint32_t g, uint32_t v) {
  const uint32_t vm = v * 0xffu;
  return ((((g & vm) << 1) + 0x7f7f7f7fu) ^ 0x80808080u) & vm;
}

// Weighted: per thread one word of 4 sites (q) over rows r = tid / 8 + 32k.
// Returns the pieces this thread's sites need beyond the first (0, 1 or 2).
__device__ __forceinline__ int decode_weighted(const uint8_t* smem, int slot, uint8_t* dec,
                                               bool diag, int tid) {
  using C = Cfg;
  const uint8_t* raw = smem + slot * 2 * kTile * C::kKt;
  const uint8_t* smk = smem + C::kSmkOff + slot * C::kKt;
  const float* wt = reinterpret_cast<const float*>(smem + C::kWtOff) + slot * C::kKt;
  const int q = tid & 7, r0 = tid >> 3;
  const float4 w4 = *reinterpret_cast<const float4*>(wt + 4 * q);
  const float w[4] = {w4.x, w4.y, w4.z, w4.w};
  uint32_t pc[3][2] = {{0u, 0u}, {0u, 0u}, {0u, 0u}};
  int extra = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t b1 = __float_as_uint(w[t]) & 0xffff0000u;
    const float r1 = w[t] - __uint_as_float(b1);
    const uint32_t b2 = __float_as_uint(r1) & 0xffff0000u;
    const float r2 = r1 - __uint_as_float(b2);
    const uint32_t b3 = __float_as_uint(r2) & 0xffff0000u;
    const uint32_t bits[3] = {b1, b2, b3};
#pragma unroll
    for (int p = 0; p < 3; ++p) pc[p][t >> 1] |= (t & 1) ? bits[p] : bits[p] >> 16;
    extra = max(extra, b3 ? 2 : (b2 ? 1 : 0));
  }
  const uint32_t m = *reinterpret_cast<const uint32_t*>(smk + 4 * q);
  constexpr uint32_t kOne = 0x3f803f80u;  // bf16 1.0 twice
  uint8_t* pieces = dec;
  uint8_t* colop = dec + 3 * kTile * C::kPiece;
  uint8_t* vi = dec + 4 * kTile * C::kPiece;
  const int parts = diag ? 1 : 2;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    if (part >= parts) break;
#pragma unroll
    for (int k = 0; k < kTile * 8 / kThreads; ++k) {
      const int r = r0 + kThreads / 8 * k;
      const uint32_t g =
          *reinterpret_cast<const uint32_t*>(raw + (part * kTile + r) * C::kKt + 4 * q);
      const uint32_t v = valid_bits(g, m);
      // a = code > 0 at a valid site: (g + 0x7f) sets bit 7 of a byte 1..127
      // (no carry once invalid bytes are cleared)
      const uint32_t a = (((g & (v * 0xffu)) + 0x7f7f7f7fu) >> 7) & v;
      const uint32_t am = a * 0xffu, cm = (v ^ a) * 0xffu;
      const uint32_t a01 = __byte_perm(am, 0u, 0x1100), a23 = __byte_perm(am, 0u, 0x3322);
      const uint32_t c01 = __byte_perm(cm, 0u, 0x1100), c23 = __byte_perm(cm, 0u, 0x3322);
      *reinterpret_cast<uint32_t*>(vi + part * kTile * C::kV + r * C::kV + 4 * q) = v;
      if (part == 0) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          uint8_t* row = pieces + p * kTile * C::kPiece + r * C::kPiece;
          *reinterpret_cast<uint2*>(row + 8 * q) = make_uint2(pc[p][0] & a01, pc[p][1] & a23);
          *reinterpret_cast<uint2*>(row + 2 * C::kKt + 8 * q) =
              make_uint2(pc[p][0] & c01, pc[p][1] & c23);
        }
      }
      if (part == 1 || diag) {
        uint8_t* row = colop + r * C::kPiece;
        *reinterpret_cast<uint2*>(row + 8 * q) = make_uint2(kOne & c01, kOne & c23);
        *reinterpret_cast<uint2*>(row + 2 * C::kKt + 8 * q) = make_uint2(kOne & a01, kOne & a23);
      }
    }
  }
  return extra;
}

__device__ __forceinline__ void mma_stage(Acc& acc, const uint8_t* dec, bool diag,
                                          int row0, int col0, int lane, int pieces) {
  using C = Cfg;
  const uint8_t* colop = dec + 3 * kTile * C::kPiece;
  const uint8_t* vi = dec + 4 * kTile * C::kPiece;
  const uint8_t* vj = diag ? vi : vi + kTile * C::kV;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (p >= pieces) break;
#pragma unroll
    for (int kb = 0; kb < 4 * C::kKt; kb += 32)
      warp_step(acc.d, dec + p * kTile * C::kPiece, C::kPiece, colop, C::kPiece, row0, col0,
                kb, lane);
  }
  warp_step(acc.v, vi, C::kV, vj, C::kV, row0, col0, 0, lane);
}

// ------------------------------------------------------------------ epilogue

using impop::div_rn;

__device__ void epilogue(const Acc& acc, uint8_t* smem, const GramArgs& a, int w, int ti,
                         int tj) {
  const int n = a.n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp >> 2) * 32, col0 = (warp & 3) * 32, g = lane >> 2, t4 = lane & 3;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const uint8_t* mem = a.member + static_cast<size_t>(w) * n;
  const float len = fmaxf(a.length[w], 1.0f), inv = __frcp_rn(len);
  float* st = reinterpret_cast<float*>(smem);
  uint8_t* sp = smem + 4 * kTile * kSimStride;

  bool mcol[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + col0 + nt * 8 + 2 * t4 + e;
      mcol[nt][e] = j < n && mem[j] != 0;
    }
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + mt * 16 + g + 8 * h, i = i0 + r;
      const bool mi = i < n && mem[i] != 0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col0 + nt * 8 + 2 * t4 + e, x = 2 * h + e;
          const int vv = acc.v[mt][nt][x];
          const float diff = acc.d[mt][nt][x];
          bool present = vv > 0 && mi && mcol[nt][e];
          float simv = present ? __fsub_rn(1.0f, div_rn(diff, len, inv)) : 0.0f;
          if (i == j0 + c && mi) {
            simv = 1.0f;
            present = true;
          }
          st[r * kSimStride + c] = simv;
          sp[r * kPresStride + c] = present ? 1 : 0;
        }
    }
  __syncthreads();

  const size_t base = static_cast<size_t>(w) * n * n;
  float* so = a.sim + base;
  uint8_t* po = a.pres + base;
  const bool vec4 = (n & 3) == 0, vec16 = (n & 15) == 0;
  // (i, j): 32 lanes per output row, 16 bytes each
  for (int e = tid; e < kTile * 32; e += kThreads) {
    const int r = e >> 5, q = e & 31, i = i0 + r, j = j0 + 4 * q;
    if (i >= n || j >= n) continue;
    const float4 val = *reinterpret_cast<const float4*>(st + r * kSimStride + 4 * q);
    float* dst = so + static_cast<size_t>(i) * n + j;
    if (vec4 && j + 4 <= n) {
      *reinterpret_cast<float4*>(dst) = val;
    } else {
      const float vals[4] = {val.x, val.y, val.z, val.w};
      for (int t = 0; t < 4 && j + t < n; ++t) dst[t] = vals[t];
    }
  }
  for (int e = tid; e < kTile * 8; e += kThreads) {
    const int r = e >> 3, q = e & 7, i = i0 + r, j = j0 + 16 * q;
    if (i >= n || j >= n) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(sp + r * kPresStride + 16 * q);
    uint8_t* dst = po + static_cast<size_t>(i) * n + j;
    if (vec16 && j + 16 <= n) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const uint8_t* vals = sp + r * kPresStride + 16 * q;
      for (int t = 0; t < 16 && j + t < n; ++t) dst[t] = vals[t];
    }
  }
  if (ti == tj) return;
  // (j, i): gathered from columns of the staged tile; a warp covers 8 output
  // rows x 4 chunks of 16 bytes
  for (int e = tid; e < kTile * 32; e += kThreads) {
    const int it = e >> 5;
    const int c = (it & 15) * 8 + (lane & 7), q = (it >> 4) * 4 + (lane >> 3);
    const int j = j0 + c, i = i0 + 4 * q;
    if (j >= n || i >= n) continue;
    float vals[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) vals[t] = st[(4 * q + t) * kSimStride + c];
    float* dst = so + static_cast<size_t>(j) * n + i;
    if (vec4 && i + 4 <= n) {
      *reinterpret_cast<float4*>(dst) = make_float4(vals[0], vals[1], vals[2], vals[3]);
    } else {
      for (int t = 0; t < 4 && i + t < n; ++t) dst[t] = vals[t];
    }
  }
  // a warp covers 16 output rows x 2 chunks of 16 bytes
  for (int e = tid; e < kTile * 8; e += kThreads) {
    const int it = e >> 5;
    const int c = (it & 7) * 16 + (lane & 15), q = (it >> 3) * 2 + (lane >> 4);
    const int j = j0 + c, i = i0 + 16 * q;
    if (j >= n || i >= n) continue;
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int t = 0; t < 16; ++t)
      words[t >> 2] |= static_cast<uint32_t>(sp[(16 * q + t) * kPresStride + c]) << (8 * (t & 3));
    uint8_t* dst = po + static_cast<size_t>(j) * n + i;
    if (vec16 && i + 16 <= n) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      for (int t = 0; t < 16 && i + t < n; ++t) dst[t] = (words[t >> 2] >> (8 * (t & 3))) & 0xffu;
    }
  }
}

// ------------------------------------------------------------------ kernels

__global__ void __launch_bounds__(kThreads, 1) weighted_gram_kernel(GramArgs a) {
  using C = Cfg;
  extern __shared__ __align__(128) uint8_t smem[];
  int ti, tj;
  tile_pair(blockIdx.x, a.t_blocks, ti, tj);
  const int w = blockIdx.y, split = blockIdx.z;
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp >> 2) * 32, col0 = (warp & 3) * 32;
  const int n = a.n, s = a.s;
  const int nk = (s + C::kKt - 1) / C::kKt;
  const int kt0 = split * a.chunk, nt = max(0, min(nk - kt0, a.chunk));
  const int8_t* g = a.geno + static_cast<size_t>(w) * n * s;
  const uint8_t* sm = a.smask + static_cast<size_t>(w) * s;
  const float* wt = a.weights + static_cast<size_t>(w) * s;
  uint8_t* dec = smem + C::kDecOff;

  Acc acc;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc.d[mt][nt2][x] = 0;
        acc.v[mt][nt2][x] = 0;
      }

  // group t of the cp.async ring holds stage t (empty past the split's end)
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st < nt) load_stage(smem, st, kt0 + st, g, sm, wt, n, s, i0, j0, diag, tid);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  int extra = 0;
  if (nt > 0) {
    extra = decode_weighted(smem, 0, dec, diag, tid);
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();  // stage t + 1 has landed (this thread's copies)
    // one barrier: dec[t & 1] and raw stage t + 1 are visible to all, and
    // every warp is done with dec[(t + 1) & 1] and raw slot t % kStages
    const int pieces =
        __syncthreads_or(extra == 2) ? 3 : (__syncthreads_or(extra == 1) ? 2 : 1);
    if (t + kStages < nt)
      load_stage(smem, t % kStages, kt0 + t + kStages, g, sm, wt, n, s, i0, j0, diag, tid);
    cp_async_commit();
    // of the four warps of a scheduler (w, w + 4, w + 8, w + 12) two take
    // the phases in the other order, so decode (integer pipe) overlaps mma
    const bool decode_first = (warp >> 2) & 1;
    const uint8_t* cur = dec + (t & 1) * C::kDecBytes;
    if (!decode_first) mma_stage(acc, cur, diag, row0, col0, lane, pieces);
    if (t + 1 < nt) {
      uint8_t* next = dec + ((t + 1) & 1) * C::kDecBytes;
      extra = decode_weighted(smem, (t + 1) % kStages, next, diag, tid);
    }
    if (decode_first) mma_stage(acc, cur, diag, row0, col0, lane, pieces);
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue reuses the ring

  if (a.splits == 1) {
    epilogue(acc, smem, a, w, ti, tj);
    return;
  }
  int* out = a.scratch +
             (static_cast<size_t>(split) * gridDim.y * a.pairs + static_cast<size_t>(w) * a.pairs +
              blockIdx.x) * kAccRegs * kThreads + tid;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int ri = (mt * 4 + nt2) * 4 + x;
        out[ri * kThreads] = __float_as_int(acc.d[mt][nt2][x]);
        out[(kAccRegs / 2 + ri) * kThreads] = acc.v[mt][nt2][x];
      }
}

__global__ void __launch_bounds__(kThreads, 1) weighted_reduce_kernel(GramArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  int ti, tj;
  tile_pair(blockIdx.x, a.t_blocks, ti, tj);
  const int w = blockIdx.y, tid = threadIdx.x;
  const size_t tiles = static_cast<size_t>(gridDim.y) * a.pairs;
  const int* in = a.scratch + (static_cast<size_t>(w) * a.pairs + blockIdx.x) * kAccRegs * kThreads +
                  tid;
  Acc acc;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc.d[mt][nt][x] = 0;
        acc.v[mt][nt][x] = 0;
      }
  // splits outermost, in order: each pass issues all 128 loads at once
  for (int sp = 0; sp < a.splits; ++sp) {
    const int* part = in + sp * tiles * kAccRegs * kThreads;
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int ri = (mt * 4 + nt) * 4 + x;
          acc.d[mt][nt][x] += __int_as_float(__ldcs(part + ri * kThreads));
          acc.v[mt][nt][x] += __ldcs(part + (kAccRegs / 2 + ri) * kThreads);
        }
  }
  epilogue(acc, smem, a, w, ti, tj);
}

int launch_weighted(const GramArgs& a, int w, cudaStream_t stream) {
  const int smem = Cfg::kSmem;
  cudaError_t err = cudaFuncSetAttribute(weighted_gram_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  weighted_gram_kernel<<<dim3(a.pairs, w, a.splits), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  err = cudaFuncSetAttribute(weighted_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kEpilogueSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  weighted_reduce_kernel<<<dim3(a.pairs, w), kThreads, kEpilogueSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ unit weights (wgmma)

namespace unitw {

constexpr int kThreadsU = 256;                 // two warpgroups: tile rows [0, 64), [64, 128)
constexpr int kKt = 64;                        // sites per stage
constexpr int kRaw = 6;                        // raw ring depth: boxes five stages ahead
constexpr int kRawRows = 2 * kTile;            // i rows, then j rows (TMA boxes)
constexpr int kRawSmk = kRawRows * kKt;        // the site mask after the rows
constexpr int kRawSlot = (kRawSmk + kKt + 127) / 128 * 128;
constexpr int kLbo = 128;                      // next 16-byte K chunk of a core matrix
constexpr int kSbo = kLbo * (kKt / 16);        // next 8-row group
constexpr int kOp = kTile * kKt;               // one decoded operand, bytes
constexpr int kDecSlot = 4 * kOp;              // z_i, v_i, z_j, v_j
constexpr int kDecOff = kRaw * kRawSlot;
constexpr int kBarOff = kDecOff + 2 * kDecSlot;
constexpr int kSmemU = kBarOff + 8 * kRaw;
constexpr int kStSim = kTile + 4;              // staged sim row, floats
constexpr int kStPres = kTile + 16;            // staged present row, bytes
constexpr int kEpiSmem = 4 * kTile * kStSim + kTile * kStPres;
constexpr int kAccInts = 2 * 64 * kThreadsU;   // scratch ints of one tile pair

static_assert(kEpiSmem <= kBarOff, "the epilogue stages in the rings");
static_assert(kDecOff % 128 == 0 && kDecSlot % 128 == 0, "operand alignment");
static_assert(kSmemU <= 232448, "shared memory of a CTA");

// The ring's mbarriers, TMA and wgmma synchronisation (rowprod.cuh).
using impop::bulk_load;
using impop::fence_proxy_async;
using impop::mbar_expect_tx;
using impop::mbar_init;
using impop::mbar_wait;
using impop::tma_load;
using impop::wgmma_commit;
using impop::wgmma_fence;
using impop::wgmma_wait;

// K-major operand in the no-swizzle core-matrix layout: 8 rows x 16 bytes
// per core matrix, kLbo to the next 16 bytes of K, kSbo to the next 8 rows.
__device__ __forceinline__ uint64_t operand_desc(const void* p) {
  return impop::smem_desc(p, kLbo, kSbo);
}

// Keeps the compiler from moving accesses of an accumulator register
// across the asynchronous matrix math.
__device__ __forceinline__ void reg_fence(int (&d)[64]) {
#pragma unroll
  for (int x = 0; x < 64; ++x) asm volatile("" : "+r"(d[x])::"memory");
}

// d[64 x 128] += A[64 x 32] . B[128 x 32]^T, int8 operands K-major in
// shared memory, int32 accumulators: thread t of the warpgroup holds
// d[4 jn + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 jn + 2 (t % 4) + e].
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Where a CTA works: tile pair, window, split, its rows and stages.
struct Work {
  int ti, tj, w, i0, j0, kt0, nt;
  bool diag;
};

__device__ __forceinline__ Work work_of(const GramArgs& a) {
  Work k;
  tile_pair(blockIdx.x, a.t_blocks, k.ti, k.tj);
  k.w = blockIdx.y;
  k.diag = k.ti == k.tj;
  k.i0 = k.ti * kTile;
  k.j0 = k.tj * kTile;
  const int nk = (a.s + kKt - 1) / kKt;
  k.kt0 = blockIdx.z * a.chunk;
  k.nt = max(0, min(nk - k.kt0, a.chunk));
  return k;
}

// Thread 0: stage t's raw tiles (one TMA box of 128 i rows, none on a
// diagonal tile, and one of 128 j rows) and site mask into ring slot
// t % kRaw.
__device__ __forceinline__ void issue_stage(const GramArgs& a, const Work& k,
                                            const CUtensorMap* map, uint8_t* smem,
                                            uint64_t* raw_full, int t) {
  const int slot = t % kRaw;
  uint8_t* raw = smem + slot * kRawSlot;
  const int site0 = (k.kt0 + t) * kKt;
  const int bytes = min(kKt, a.s - site0);      // a multiple of 16
  mbar_expect_tx(&raw_full[slot],
                 static_cast<uint32_t>((k.diag ? kTile : kRawRows) * kKt + bytes));
  if (!k.diag) tma_load(raw, map, site0, k.i0, k.w, &raw_full[slot]);
  tma_load(raw + kTile * kKt, map, site0, k.j0, k.w, &raw_full[slot]);
  bulk_load(raw + kRawSmk, a.smask + static_cast<size_t>(k.w) * a.s + site0, bytes,
            &raw_full[slot]);
}

// Every thread: z and v of one raw stage into a decoded slot, in the
// K-major core-matrix layout wgmma reads.  A thread keeps one 16-byte
// chunk c (so it reads the site mask once) over rows rb + 64 m, four
// independent rows; eight consecutive threads take eight consecutive rows
// of a chunk, so the core-matrix writes are conflict-free.  Rows past N
// and chunks past S decode as zero.
__device__ __forceinline__ void decode_stage(const uint8_t* raw, uint8_t* dec, int site0, int s,
                                             int n, const Work& k, int tid) {
  const int c = (tid >> 3) & 3, rb = 8 * (tid >> 5) + (tid & 7);
  const bool site_ok = site0 + 16 * c < s;
  const uint4 mq = *reinterpret_cast<const uint4*>(raw + kRawSmk + 16 * c);
#pragma unroll
  for (int m = 0; m < kRawRows / 64; ++m) {
    const bool is_i = m < kTile / 64;
    if (is_i && k.diag) continue;
    const int rl = rb + 64 * m - (is_i ? 0 : kTile);
    uint4 z = make_uint4(0u, 0u, 0u, 0u), v = z;
    if (site_ok && (is_i ? k.i0 : k.j0) + rl < n) {
      const uint4 gq = *reinterpret_cast<const uint4*>(raw + (rb + 64 * m) * kKt + 16 * c);
      v = make_uint4(valid_bits(gq.x, mq.x), valid_bits(gq.y, mq.y), valid_bits(gq.z, mq.z),
                     valid_bits(gq.w, mq.w));
      z = make_uint4(z_bytes(gq.x, v.x), z_bytes(gq.y, v.y), z_bytes(gq.z, v.z),
                     z_bytes(gq.w, v.w));
    }
    uint8_t* zb = dec + (is_i ? 0 : 2 * kOp) + (rl >> 3) * kSbo + c * kLbo + (rl & 7) * 16;
    *reinterpret_cast<uint4*>(zb) = z;
    *reinterpret_cast<uint4*>(zb + kOp) = v;
  }
}

// sim / present of the CTA's 128 x 128 tile from its Grams (warpgroup g
// holds rows [64 g, 64 g + 64)), staged in shared memory, then the (i, j)
// rows and, off the diagonal, the mirror (j, i).  All 256 threads call it.
__device__ __forceinline__ void unit_epilogue(const int (&zacc)[64], const int (&vacc)[64],
                                              uint8_t* smem, const GramArgs& a, const Work& k) {
  const int n = a.n, tid = threadIdx.x, lane = tid & 31, wq = tid >> 5;
  const uint8_t* mem = a.member + static_cast<size_t>(k.w) * n;
  const float len = fmaxf(a.length[k.w], 1.0f), inv = __frcp_rn(len);
  float* st = reinterpret_cast<float*>(smem);
  uint8_t* sp = smem + 4 * kTile * kStSim;

  uint32_t mcol = 0u;   // bit 2 jn + e: member column 8 jn + 2 (lane % 4) + e
#pragma unroll
  for (int jn = 0; jn < 16; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = k.j0 + 8 * jn + 2 * (lane & 3) + e;
      if (j < n && mem[j] != 0) mcol |= 1u << (2 * jn + e);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * wq + (lane >> 2) + 8 * h, i = k.i0 + r;
    const bool mi = i < n && mem[i] != 0;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * jn + 2 * h + e, c = 8 * jn + 2 * (lane & 3) + e;
        const int vv = vacc[x];
        const float diff = static_cast<float>((vv - zacc[x]) / 2);
        bool present = vv > 0 && mi && ((mcol >> (2 * jn + e)) & 1u);
        float simv = present ? __fsub_rn(1.0f, div_rn(diff, len, inv)) : 0.0f;
        if (i == k.j0 + c && mi) {
          simv = 1.0f;
          present = true;
        }
        st[r * kStSim + c] = simv;
        sp[r * kStPres + c] = present ? 1 : 0;
      }
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(k.w) * n * n;
  float* so = a.sim + base;
  uint8_t* po = a.pres + base;
  const bool vec4 = (n & 3) == 0, vec16 = (n & 15) == 0;
  // (i, j): 32 lanes per output row, 16 bytes each
  for (int e = tid; e < kTile * 32; e += kThreadsU) {
    const int r = e >> 5, q = e & 31, i = k.i0 + r, j = k.j0 + 4 * q;
    if (i >= n || j >= n) continue;
    const float4 val = *reinterpret_cast<const float4*>(st + r * kStSim + 4 * q);
    float* dst = so + static_cast<size_t>(i) * n + j;
    if (vec4 && j + 4 <= n) {
      *reinterpret_cast<float4*>(dst) = val;
    } else {
      const float vals[4] = {val.x, val.y, val.z, val.w};
      for (int t = 0; t < 4 && j + t < n; ++t) dst[t] = vals[t];
    }
  }
  for (int e = tid; e < kTile * 8; e += kThreadsU) {
    const int r = e >> 3, q = e & 7, i = k.i0 + r, j = k.j0 + 16 * q;
    if (i >= n || j >= n) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(sp + r * kStPres + 16 * q);
    uint8_t* dst = po + static_cast<size_t>(i) * n + j;
    if (vec16 && j + 16 <= n) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const uint8_t* vals = sp + r * kStPres + 16 * q;
      for (int t = 0; t < 16 && j + t < n; ++t) dst[t] = vals[t];
    }
  }
  if (k.diag) return;
  // (j, i): gathered from columns of the staged tile; a warp covers 8
  // output rows x 4 chunks of 16 bytes
  for (int e = tid; e < kTile * 32; e += kThreadsU) {
    const int it = e >> 5;
    const int c = (it & 15) * 8 + (lane & 7), q = (it >> 4) * 4 + (lane >> 3);
    const int j = k.j0 + c, i = k.i0 + 4 * q;
    if (j >= n || i >= n) continue;
    float vals[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) vals[t] = st[(4 * q + t) * kStSim + c];
    float* dst = so + static_cast<size_t>(j) * n + i;
    if (vec4 && i + 4 <= n) {
      *reinterpret_cast<float4*>(dst) = make_float4(vals[0], vals[1], vals[2], vals[3]);
    } else {
      for (int t = 0; t < 4 && i + t < n; ++t) dst[t] = vals[t];
    }
  }
  // a warp covers 16 output rows x 2 chunks of 16 bytes
  for (int e = tid; e < kTile * 8; e += kThreadsU) {
    const int it = e >> 5;
    const int c = (it & 7) * 16 + (lane & 15), q = (it >> 3) * 2 + (lane >> 4);
    const int j = k.j0 + c, i = k.i0 + 16 * q;
    if (j >= n || i >= n) continue;
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int t = 0; t < 16; ++t)
      words[t >> 2] |= static_cast<uint32_t>(sp[(16 * q + t) * kStPres + c]) << (8 * (t & 3));
    uint8_t* dst = po + static_cast<size_t>(j) * n + i;
    if (vec16 && i + 16 <= n) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      for (int t = 0; t < 16 && i + t < n; ++t) dst[t] = (words[t >> 2] >> (8 * (t & 3))) & 0xffu;
    }
  }
}

// The pipeline: the TMA boxes of stages t + 1 .. t + kRaw - 1 in flight
// (thread 0, an mbarrier per ring slot) while every warp decodes stage
// t + 1 and both warpgroups' wgmma of stage t run on the tensor cores.
__global__ void __launch_bounds__(kThreadsU, 1)
    unit_gram_kernel(GramArgs a, const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Work k = work_of(a);
  const int tid = threadIdx.x, wg = tid >> 7;
  uint64_t* raw_full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  if (tid == 0) {
    for (int s = 0; s < kRaw; ++s) mbar_init(&raw_full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(kRaw, k.nt); ++t) issue_stage(a, k, &map, smem, raw_full, t);
  }
  __syncthreads();

  int zacc[64], vacc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    zacc[x] = 0;
    vacc[x] = 0;
  }
  reg_fence(zacc);
  reg_fence(vacc);
  // warpgroup wg's i rows: rows [64 wg, 64 wg + 64) of the i operand, or of
  // the j operand on a diagonal tile
  const int i_off = (k.diag ? 2 * kOp : 0) + wg * (kTile / 16) * kSbo;
  if (k.nt > 0) {
    mbar_wait(&raw_full[0], 0);
    decode_stage(smem, smem + kDecOff, k.kt0 * kKt, a.s, a.n, k, tid);
    fence_proxy_async();
    __syncthreads();
  }
  for (int t = 0; t < k.nt; ++t) {
    const uint8_t* dec = smem + kDecOff + (t & 1) * kDecSlot;
    const uint8_t* zi = dec + i_off;
    const uint8_t* vi = zi + kOp;
    const uint8_t* zj = dec + 2 * kOp;
    const uint8_t* vj = zj + kOp;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKt / 32; ++kk) {
      wgmma_s8(zacc, operand_desc(zi + 2 * kLbo * kk), operand_desc(zj + 2 * kLbo * kk));
      wgmma_s8(vacc, operand_desc(vi + 2 * kLbo * kk), operand_desc(vj + 2 * kLbo * kk));
    }
    wgmma_commit();
    if (t + 1 < k.nt) {
      wgmma_wait<1>();   // stage t - 1's products are done with the other slot
      __syncthreads();   // ... in both warpgroups; stage t's raw slot is decoded
      if (tid == 0 && t + kRaw < k.nt) {
        fence_proxy_async();
        issue_stage(a, k, &map, smem, raw_full, t + kRaw);
      }
      const int slot = (t + 1) % kRaw;
      mbar_wait(&raw_full[slot], ((t + 1) / kRaw) & 1);
      decode_stage(smem + slot * kRawSlot, smem + kDecOff + ((t + 1) & 1) * kDecSlot,
                   (k.kt0 + t + 1) * kKt, a.s, a.n, k, tid);
      fence_proxy_async();
      __syncthreads();
    }
  }
  wgmma_wait<0>();
  reg_fence(zacc);
  reg_fence(vacc);
  __syncthreads();   // every wgmma is done before the epilogue reuses the rings

  if (a.splits == 1) {
    unit_epilogue(zacc, vacc, smem, a, k);
    return;
  }
  int* out = a.scratch +
             ((static_cast<size_t>(blockIdx.z) * gridDim.y + k.w) * a.pairs + blockIdx.x) *
                 kAccInts +
             tid;
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    out[x * kThreadsU] = zacc[x];
    out[(64 + x) * kThreadsU] = vacc[x];
  }
}

__global__ void __launch_bounds__(kThreadsU, 1) unit_reduce_kernel(GramArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Work k = work_of(a);
  const size_t tiles = static_cast<size_t>(gridDim.y) * a.pairs;
  const int* in =
      a.scratch + (static_cast<size_t>(k.w) * a.pairs + blockIdx.x) * kAccInts + threadIdx.x;
  int zacc[64], vacc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    zacc[x] = 0;
    vacc[x] = 0;
  }
  // splits outermost, in order: each pass issues all 128 loads at once
  for (int sp = 0; sp < a.splits; ++sp) {
    const int* part = in + sp * tiles * kAccInts;
#pragma unroll
    for (int x = 0; x < 64; ++x) {
      zacc[x] += __ldcs(part + x * kThreadsU);
      vacc[x] += __ldcs(part + (64 + x) * kThreadsU);
    }
  }
  unit_epilogue(zacc, vacc, smem, a, k);
}

// [W, N, S] int8 geno as a 3-D tensor, boxes of kKt sites x kTile rows.
bool geno_map(CUtensorMap* map, const GramArgs& a, int w) {
  return impop::tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.geno, a.s, a.n, w, a.s,
                              kKt, kTile);
}

int launch(const GramArgs& a, int w, cudaStream_t stream) {
  CUtensorMap map;
  if (!geno_map(&map, a, w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(unit_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemU);
  if (err != cudaSuccess) return static_cast<int>(err);
  unit_gram_kernel<<<dim3(a.pairs, w, a.splits), kThreadsU, kSmemU, stream>>>(a, map);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  err = cudaFuncSetAttribute(unit_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kEpiSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  unit_reduce_kernel<<<dim3(a.pairs, w), kThreadsU, kEpiSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace unitw

GramArgs make_args(const void* geno, const void* member, const void* smask, const void* weights,
                   const void* length, int n, int s, int splits, int chunk, void* scratch,
                   void* sim, void* present) {
  GramArgs a;
  a.geno = static_cast<const int8_t*>(geno);
  a.member = static_cast<const uint8_t*>(member);
  a.smask = static_cast<const uint8_t*>(smask);
  a.weights = static_cast<const float*>(weights);
  a.length = static_cast<const float*>(length);
  a.n = n;
  a.s = s;
  a.t_blocks = (n + kTile - 1) / kTile;
  a.pairs = a.t_blocks * (a.t_blocks + 1) / 2;
  a.splits = splits;
  a.chunk = chunk;
  a.scratch = static_cast<int*>(scratch);
  a.sim = static_cast<float*>(sim);
  a.pres = static_cast<uint8_t*>(present);
  return a;
}

}  // namespace

extern "C" {

// S % 16 == 0; splits * chunk stages of 64 sites cover S; scratch holds
// splits * W * pairs * 128 * 256 int32 when splits > 1.
int impop_pairwise_identity(const void* geno, const void* member, const void* smask,
                            const void* length, int w, int n, int s, int splits, int chunk,
                            void* scratch, void* sim, void* present, void* stream) {
  const GramArgs a = make_args(geno, member, smask, nullptr, length, n, s, splits, chunk,
                               scratch, sim, present);
  return unitw::launch(a, w, static_cast<cudaStream_t>(stream));
}

// As above, with stages of 32 sites and weights [W, S] f32.
int impop_weighted_identity(const void* geno, const void* member, const void* smask,
                            const void* weights, const void* length, int w, int n, int s,
                            int splits, int chunk, void* scratch, void* sim, void* present,
                            void* stream) {
  const GramArgs a = make_args(geno, member, smask, weights, length, n, s, splits, chunk,
                               scratch, sim, present);
  return launch_weighted(a, w, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
