// Identity from allele tiles for Hopper (sm_90a): two Grams on the tensor
// cores, one skeleton.
//
// Unit weights, gram_kernel<false>.  Replaces the unit-weight Pallas TPU
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
// Column weights, gram_kernel<true>.  Replaces the weighted branch of
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
// Design (both).  One block of 512 threads (16 warps, each 32 x 32 outputs)
// per (window, 128 x 128 output tile pair ti <= tj, site split); the lower
// triangle is never computed.  Raw int8 tiles of the 2 x 128 rows (one set
// on a diagonal tile) and the site mask (and weights) stream through a
// 4-deep cp.async ring of 16-byte copies; each stage is decoded once into
// double-buffered operand tiles in shared memory, four sites per 32-bit
// word with plain integer ops (no per-byte branches; the __v*4 intrinsics
// are emulated on sm_90 and cost several times more): unit weights store
// z only and take v = z & 0x01 per byte from the loaded fragments.  The
// decode of stage t + 1 and the mma.sync of stage t sit between the same
// two barriers, so one warp's decode overlaps another's matrix math.
// Fragments come from ldmatrix (decoded rows padded by 16 bytes, so the
// eight row addresses of each 8 x 8 matrix hit distinct banks).  Math:
// mma.sync m16n8k32 s8 -> s32 (z and v Grams), m16n8k16 bf16 -> f32
// (weighted diff).  The epilogue stages the sim (f32) and present (u8)
// tile in shared memory and writes the (i, j) tile and its mirror (j, i)
// with 16-byte stores, four lanes per output row.
//
// Filling the card: the wrapper picks the site split (ops/pairdiff.py
// identity_partition).  With one split the main kernel runs the epilogue;
// with more, each split writes its accumulators to a scratch the wrapper
// allocates ([split][tile][register][thread], coalesced) and
// gram_reduce_kernel sums them in split order (int32 exactly; f32 in a
// fixed order) and runs the same epilogue.
//
// Ragged shapes: any N (rows past N load as zero and are never written;
// the output stores fall back to scalars when N % 4 (f32) or N % 16 (u8)
// leaves rows unaligned).  S must be a multiple of 16 so that every
// 16-byte copy is aligned: the wrapper pads S once (masked columns) when it
// is not, which costs one copy of the tile, and only on that path.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8,
// 989 TFLOP/s bf16).  Unit weights, [512, 2048] x 64: 67 MB of int8 in and
// 84 MB of sim + present out, 45 us of bytes, against 69 GOP of int8 on the
// triangle (35 us): bytes.  [512, 8192] x 8: 34 GOP (17 us) against 44 MB
// (13 us): operations, and only 80 tile pairs for 132 SMs, which the site
// split addresses.  Weighted, [512, 128] x 64: 88 MB of bytes (26 us)
// against 4.3 GFLOP of bf16 (4 us): bytes, so the epilogue's stores
// dominate and the coalesced mirrored writes are what matters.  On the
// card the unit-weight kernel stays well above its bound (PERF.md;
// chip_smoke.py phase 2i, impop_tpu_torch/bench/gram_breakdown.py): with
// one 512-thread block per SM the mma.sync phase, the decode and the
// epilogue's stores run one after another, and mma.sync does not reach the
// rate of wgmma, which is the next step (warp-specialised loads and
// decode feeding wgmma, and an epilogue overlapped with the next tile).
//
// The C functions return the first CUDA error of their launches; they never
// synchronise and never allocate.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;          // 16 warps: 4 x 4 of 32 x 32 outputs
constexpr int kMt = 2;                  // m16 tiles per warp (32 rows)
constexpr int kTile = 128;              // output tile edge
constexpr int kStages = 4;              // cp.async ring depth
constexpr int kAccRegs = 64;            // accumulator registers per thread
constexpr int kSimStride = kTile + 4;   // staged sim row, floats (16-byte rows)
constexpr int kPresStride = kTile + 16; // staged present row, bytes
constexpr int kEpilogueSmem = 4 * kTile * kSimStride + kTile * kPresStride;

template <bool kW>
struct Cfg;

template <>
struct Cfg<false> {
  static constexpr int kKt = 64;                          // sites per stage
  static constexpr int kDec = kKt + 16;                   // z row, bytes
  static constexpr int kDecBytes = 2 * kTile * kDec;      // z_i, z_j (v = z & 1)
  static constexpr int kRawBytes = kStages * 2 * kTile * kKt;
  static constexpr int kSmkOff = kRawBytes;
  static constexpr int kWtOff = kSmkOff + kStages * kKt;  // (no weights)
  static constexpr int kDecOff = kWtOff;
  static constexpr int kSmem = kDecOff + 2 * kDecBytes;
};

template <>
struct Cfg<true> {
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

static_assert(Cfg<false>::kSmem >= kEpilogueSmem, "epilogue reuses the ring");
static_assert(Cfg<true>::kSmem <= 232448, "weighted kernel's shared memory");

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

template <bool kW>
struct Acc {
  using D = typename std::conditional<kW, float, int>::type;
  D d[kMt][4][4];   // unit weights: z.z^T; weighted: diff
  int v[kMt][4][4]; // compared = v.v^T
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
template <bool kW>
__device__ __forceinline__ void load_stage(uint8_t* smem, int slot, int kt, const int8_t* g,
                                           const uint8_t* sm, const float* wt, int n, int s,
                                           int i0, int j0, bool diag, int tid) {
  using C = Cfg<kW>;
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
  if constexpr (kW) {
    if (tid >= 32 && tid < 32 + C::kKt / 4) {
      const int site = site0 + (tid - 32) * 4;
      cp_async16(smem + C::kWtOff + 4 * (slot * C::kKt + (tid - 32) * 4),
                 site < s ? wt + site : wt, site < s);
    }
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

// Unit weights: z of every row of the stage, 16 sites per step (v = z & 1
// is taken from the fragments).  Each thread keeps one 16-site column
// chunk, so it reads the site mask once.
__device__ __forceinline__ void decode_unit(const uint8_t* smem, int slot, uint8_t* dec,
                                            bool diag, int tid) {
  using C = Cfg<false>;
  const uint8_t* raw = smem + slot * 2 * kTile * C::kKt;
  const int c = tid & 3;
  const uint4 mq = *reinterpret_cast<const uint4*>(smem + C::kSmkOff + slot * C::kKt + c * 16);
  const uint32_t mw[4] = {mq.x, mq.y, mq.z, mq.w};
  const int rows = (diag ? 1 : 2) * kTile;
  for (int r = tid >> 2; r < rows; r += kThreads / 4) {
    const uint4 gq = *reinterpret_cast<const uint4*>(raw + r * C::kKt + c * 16);
    const uint32_t gw[4] = {gq.x, gq.y, gq.z, gq.w};
    uint32_t z[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) z[q] = z_bytes(gw[q], valid_bits(gw[q], mw[q]));
    *reinterpret_cast<uint4*>(dec + r * C::kDec + c * 16) = make_uint4(z[0], z[1], z[2], z[3]);
  }
}

// Weighted: per thread one word of 4 sites (q) over rows r = tid / 8 + 32k.
// Returns the pieces this thread's sites need beyond the first (0, 1 or 2).
__device__ __forceinline__ int decode_weighted(const uint8_t* smem, int slot, uint8_t* dec,
                                               bool diag, int tid) {
  using C = Cfg<true>;
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

// Both unit-weight Grams from the z tiles: zz from the fragments as loaded,
// vv from the same fragments & 0x01 per byte (z is odd exactly where valid).
__device__ __forceinline__ void mma_stage(Acc<false>& acc, const uint8_t* dec, bool diag,
                                          int row0, int col0, int lane, int) {
  using C = Cfg<false>;
  const uint8_t* zi = dec;
  const uint8_t* zj = diag ? zi : dec + kTile * C::kDec;
  const int br = (lane & 7) + (lane >> 4) * 8, ar = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kb = 0; kb < C::kKt; kb += 32) {
    uint32_t b[2][4], bv[2][4];
    const int bk = kb + ((lane >> 3) & 1) * 16, ak = kb + (lane >> 4) * 16;
    ldsm_x4(b[0], zj + (col0 + br) * C::kDec + bk);
    ldsm_x4(b[1], zj + (col0 + 16 + br) * C::kDec + bk);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int x = 0; x < 4; ++x) bv[h][x] = b[h][x] & 0x01010101u;
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      uint32_t a[4], av[4];
      ldsm_x4(a, zi + (row0 + mt * 16 + ar) * C::kDec + ak);
#pragma unroll
      for (int x = 0; x < 4; ++x) av[x] = a[x] & 0x01010101u;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int h = nt >> 1, o = (nt & 1) * 2;
        mma(acc.d[mt][nt], a, b[h][o], b[h][o + 1]);
        mma(acc.v[mt][nt], av, bv[h][o], bv[h][o + 1]);
      }
    }
  }
}

__device__ __forceinline__ void mma_stage(Acc<true>& acc, const uint8_t* dec, bool diag,
                                          int row0, int col0, int lane, int pieces) {
  using C = Cfg<true>;
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

// a / b rounded to nearest even, given inv = the correctly rounded 1 / b:
// q = a * inv is within one ulp, r = a - b q is exact in an FMA, and
// q + r * inv rounds to the IEEE quotient (Markstein's theorem; no
// overflow or underflow for diff >= 0 and 1 <= b < 2^31 short of a
// denormal quotient).  Bit-identical to __fdiv_rn there, at four
// instructions instead of the division subroutine, whose cost dominated
// tiles with few sites.
__device__ __forceinline__ float div_rn(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  const float r = __fmaf_rn(-q, b, a);
  return __fmaf_rn(r, inv, q);
}

template <bool kW>
__device__ void epilogue(const Acc<kW>& acc, uint8_t* smem, const GramArgs& a, int w, int ti,
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
          float diff;
          if constexpr (kW) diff = acc.d[mt][nt][x];
          else diff = static_cast<float>((vv - acc.d[mt][nt][x]) / 2);
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

template <class T>
__device__ __forceinline__ int acc_bits(T x) {
  if constexpr (std::is_same<T, float>::value) return __float_as_int(x);
  else return x;
}

// ------------------------------------------------------------------ kernels

template <bool kW>
__global__ void __launch_bounds__(kThreads, 1) gram_kernel(GramArgs a) {
  using C = Cfg<kW>;
  extern __shared__ __align__(16) uint8_t smem[];
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
  const float* wt = kW ? a.weights + static_cast<size_t>(w) * s : nullptr;
  uint8_t* dec = smem + C::kDecOff;

  Acc<kW> acc;
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
    if (st < nt) load_stage<kW>(smem, st, kt0 + st, g, sm, wt, n, s, i0, j0, diag, tid);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  int extra = 0;
  if (nt > 0) {
    if constexpr (kW) extra = decode_weighted(smem, 0, dec, diag, tid);
    else decode_unit(smem, 0, dec, diag, tid);
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();  // stage t + 1 has landed (this thread's copies)
    // one barrier: dec[t & 1] and raw stage t + 1 are visible to all, and
    // every warp is done with dec[(t + 1) & 1] and raw slot t % kStages
    int pieces = 1;
    if constexpr (kW) {
      pieces = __syncthreads_or(extra == 2) ? 3 : (__syncthreads_or(extra == 1) ? 2 : 1);
    } else {
      __syncthreads();
    }
    if (t + kStages < nt)
      load_stage<kW>(smem, t % kStages, kt0 + t + kStages, g, sm, wt, n, s, i0, j0, diag, tid);
    cp_async_commit();
    // of the four warps of a scheduler (w, w + 4, w + 8, w + 12) two take
    // the phases in the other order, so decode (integer pipe) overlaps mma
    const bool decode_first = (warp >> 2) & 1;
    const uint8_t* cur = dec + (t & 1) * C::kDecBytes;
    if (!decode_first) mma_stage(acc, cur, diag, row0, col0, lane, pieces);
    if (t + 1 < nt) {
      uint8_t* next = dec + ((t + 1) & 1) * C::kDecBytes;
      if constexpr (kW) extra = decode_weighted(smem, (t + 1) % kStages, next, diag, tid);
      else decode_unit(smem, (t + 1) % kStages, next, diag, tid);
    }
    if (decode_first) mma_stage(acc, cur, diag, row0, col0, lane, pieces);
  }
  cp_async_wait<0>();
  __syncthreads();  // the epilogue reuses the ring

  if (a.splits == 1) {
    epilogue<kW>(acc, smem, a, w, ti, tj);
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
        out[ri * kThreads] = acc_bits(acc.d[mt][nt2][x]);
        out[(kAccRegs / 2 + ri) * kThreads] = acc.v[mt][nt2][x];
      }
}

template <bool kW>
__global__ void __launch_bounds__(kThreads, 1) gram_reduce_kernel(GramArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  int ti, tj;
  tile_pair(blockIdx.x, a.t_blocks, ti, tj);
  const int w = blockIdx.y, tid = threadIdx.x;
  const size_t tiles = static_cast<size_t>(gridDim.y) * a.pairs;
  const int* in = a.scratch + (static_cast<size_t>(w) * a.pairs + blockIdx.x) * kAccRegs * kThreads +
                  tid;
  Acc<kW> acc;
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
          if constexpr (kW) acc.d[mt][nt][x] += __int_as_float(__ldcs(part + ri * kThreads));
          else acc.d[mt][nt][x] += __ldcs(part + ri * kThreads);
          acc.v[mt][nt][x] += __ldcs(part + (kAccRegs / 2 + ri) * kThreads);
        }
  }
  epilogue<kW>(acc, smem, a, w, ti, tj);
}

template <bool kW>
int launch(const GramArgs& a, int w, cudaStream_t stream) {
  const int smem = Cfg<kW>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(gram_kernel<kW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_kernel<kW><<<dim3(a.pairs, w, a.splits), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gram_reduce_kernel<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kEpilogueSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<kW><<<dim3(a.pairs, w), kThreads, kEpilogueSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

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
  return launch<false>(a, w, static_cast<cudaStream_t>(stream));
}

// As above, with stages of 32 sites and weights [W, S] f32.
int impop_weighted_identity(const void* geno, const void* member, const void* smask,
                            const void* weights, const void* length, int w, int n, int s,
                            int splits, int chunk, void* scratch, void* sim, void* present,
                            void* stream) {
  const GramArgs a = make_args(geno, member, smask, weights, length, n, s, splits, chunk,
                               scratch, sim, present);
  return launch<true>(a, w, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
