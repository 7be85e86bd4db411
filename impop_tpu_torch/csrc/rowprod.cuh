// Value-row products on the tensor cores for Hopper (sm_90a), shared by
// windowstat.cu (window_products_kernel, the window program's phase C) and
// panelquad.cu (masked_pair_sums_kernel):
//
//   Y[m, j] = sum_i X[m, i] . B[i, j]
//
// for a block of 64 columns j, with B = (1 - sim) . mask (the value rows:
// group weights, fp32 rows of Wd or Wp) or B = mask (the 0/1 rows).  The
// TMA and mbarrier helpers of the unit identity kernel (pairdiff.cu) live
// here too.
//
// The product.  Each fp32 operand x is split into three bf16 pieces
// x = x1 + x2 + x3: each piece is the top 8 significant bits of what is
// left, rounded toward zero (the bit pattern cut to its upper 16 bits), so
// |x2| < 2^-7 |x|, |x3| < 2^-15 |x| and the three pieces hold all 24 bits
// of the fp32 significand: hi + mid + lo == x exactly.  That holds
// wherever every piece is a normal bf16 or zero, which (1 - sim) always
// is: 1 - s of a float s is 0 or at least 2^-24 in magnitude, so its last
// piece is at least 2^-47.  (Below 2^-110 the last piece could fall under
// bf16's subnormal step, and the split would drop bits.)  A 0/1 operand
// is its own first piece.  Of the nine piece products x_p . b_q the block
// keeps the six with p + q <= 4 (x1 b1, x1 b2, x1 b3, x2 b1, x2 b2,
// x3 b1), or the three of a 0/1 factor; each is exact in fp32 (8 x 8
// significant bits).  The dropped x2 b3, x3 b2 and x3 b3 are below 2^-22,
// 2^-22 and 2^-30 of |x b|: less than 2^-21 of each term in all, against
// the 1e-5 relative budget of the sums.  Never TF32, never one piece (one
// bf16 pass errs by about 1e-3 relative, impop_tpu/ops/panelquad.py:41).
//
// Accumulation.  wgmma.mma_async m64n64k16 bf16 -> fp32 in registers.  A
// chunk of 32 i values (two k16 steps, up to 12 products) starts its own
// accumulator (scale-d 0 on its first product); after the chunk the
// warpgroup adds it to a second fp32 accumulator with round-to-nearest
// additions, chunk by chunk in i order.  So the tensor core's own
// accumulation (aligned to the largest term, rounded toward zero) spans
// at most 12 products of one chunk, and a column's sum is the same from
// run to run (no atomics, a fixed order).
//
// Operands in shared memory, K-major without swizzle: 8 rows x 16 bytes (8
// bf16 along K) per core matrix, kLbo to the next 8 K values, kSbo to the
// next 8 rows.  A chunk's operand piece (64 rows x 32 K) is kPiece bytes.
//
// The block: one consumer warpgroup per 64-row tile of X rows (threads
// 0 .. 128 tiles - 1) and one producer warp.  Lane 0 of the producer keeps
// the raw tiles of B (diff, or sim and present) of the next kRaw chunks in
// flight by TMA (cp.async.bulk.tensor) into a ring, with a "full" mbarrier
// per slot (bytes) and an "empty" one (the consumer warps).  The consumers
// decode chunk c + 1 into the free half of a double buffer of B pieces
// while each warpgroup's wgmma of chunk c runs, then meet at a named
// barrier that the producer never joins.  The A operand, the X pieces,
// never touches shared memory: each warpgroup thread loads its X values
// from device memory two chunks ahead and splits them in registers, so
// the wgmma reads only B from shared memory (2 KB an instruction, half the
// port's rate) and the decode has the rest.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace impop {

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of parity `parity` to complete.  A pipeline fault
// traps after about 2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const unsigned addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A box of a 3-D tensor (coordinates innermost first) into shared memory;
// out-of-bounds elements arrive as zeros and count toward the bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy shared-memory writes -> visible to the async proxy (wgmma,
// bulk copies), and the reverse order for a slot about to be refilled
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// K-major operand without swizzle: lbo bytes to the next 16 bytes of K,
// sbo to the next 8 rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Barrier `id` (1-15) among the first `count` threads of the block.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Whether pred holds for any of the first `count` threads of the block
// (barrier `id`; every one of them calls it).
__device__ __forceinline__ bool named_or(int id, int count, bool pred) {
  uint32_t out;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 q, %1, 0;\nbar.red.or.pred p, %2, %3, q;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(out)
      : "r"(static_cast<uint32_t>(pred)), "r"(id), "r"(count)
      : "memory");
  return out != 0u;
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point lookup
// (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [d2, d1, d0] row-major tensor (row stride ld0 elements, d1 rows a
// slice) in boxes of b0 x b1 x 1; false when the encoder is missing or
// refuses (strides must be multiples of 16 bytes, the base 16-byte aligned).
inline bool tensor_map_3d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                          const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint64_t ld0,
                          uint32_t b0, uint32_t b1) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {ld0 * elem_bytes, ld0 * d1 * elem_bytes};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------------ the product

namespace rp {

constexpr int kRows = 64;                  // M: X rows of a tile (wgmma m64)
constexpr int kCols = 64;                  // N: columns j of a block (wgmma n64)
constexpr int kKc = 32;                    // K: i values of a chunk (two k16 steps)
constexpr int kRaw = 4;                    // chunks in the TMA ring
constexpr int kLbo = 128;                  // next 8 K values of a core matrix
constexpr int kSbo = kLbo * (kKc / 8);     // next 8 rows
constexpr int kPiece = kCols * kKc * 2;    // one bf16 piece of a 64 x 32 B tile, bytes
constexpr int kBPieces = 4;                // three pieces of (1 - sim) . mask, the mask
constexpr int kDecHalf = kBPieces * kPiece;  // one half of the double buffer of pieces
constexpr int kBarBytes = 128;             // the ring's mbarriers
constexpr int kSyncId = 1;                 // the consumers' named barrier

// Threads of a block with `tiles` consumer warpgroups and the producer warp.
__host__ __device__ constexpr int threads(int tiles) { return 128 * tiles + 32; }

// Byte offset of column j, K values [8 kc, 8 kc + 8) in a B piece.
__device__ __forceinline__ int kmajor(int j, int kc) {
  return (j >> 3) * kSbo + kc * kLbo + (j & 7) * 16;
}

// The three pieces of x as fp32 bit patterns with the low 16 bits clear
// (the bf16 value in the upper half); a non-finite x goes whole into the
// first piece (NaN as the quiet NaN).
__device__ __forceinline__ void split3(float x, uint32_t& p1, uint32_t& p2, uint32_t& p3) {
  const uint32_t bits = __float_as_uint(x);
  if (!(fabsf(x) <= 3.402823466e38f)) {
    p1 = x != x ? 0x7fc00000u : bits & 0xffff0000u;
    p2 = p3 = 0u;
    return;
  }
  p1 = bits & 0xffff0000u;
  const float r1 = __fsub_rn(x, __uint_as_float(p1));   // exact
  p2 = __float_as_uint(r1) & 0xffff0000u;
  const float r2 = __fsub_rn(r1, __uint_as_float(p2));  // exact
  p3 = __float_as_uint(r2) & 0xffff0000u;               // == r2
}

// Eight consecutive K values of one column of B: their three pieces as
// three 16-byte rows of a core matrix (value k in bf16 lane k).
struct Pack8 {
  uint4 p[3];
};

__device__ __forceinline__ Pack8 pack8(const float (&v)[8]) {
  uint32_t a[8], b[8], c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) split3(v[k], a[k], b[k], c[k]);
  Pack8 o;
  o.p[0] = make_uint4(__byte_perm(a[0], a[1], 0x7632), __byte_perm(a[2], a[3], 0x7632),
                      __byte_perm(a[4], a[5], 0x7632), __byte_perm(a[6], a[7], 0x7632));
  o.p[1] = make_uint4(__byte_perm(b[0], b[1], 0x7632), __byte_perm(b[2], b[3], 0x7632),
                      __byte_perm(b[4], b[5], 0x7632), __byte_perm(b[6], b[7], 0x7632));
  o.p[2] = make_uint4(__byte_perm(c[0], c[1], 0x7632), __byte_perm(c[2], c[3], 0x7632),
                      __byte_perm(c[4], c[5], 0x7632), __byte_perm(c[6], c[7], 0x7632));
  return o;
}

// The A operand of one chunk in registers: the three pieces of the X
// values of a warpgroup thread, in the m64k16 fragment layout of each k16
// step (thread t of the warpgroup, register g = 2 v + h: row 16 (t / 32) +
// (t % 32) / 4 + 8 h, K values 8 v + 2 (t % 4) + e in bf16 lane e).
struct AFrag {
  uint32_t r[3][kKc / 16][4];   // [piece][k16 step][register]
};

// The thread's 16 X values of chunk i0 (xv[8 kk + 2 g + e]) from rows
// [0, rows) of x (rows ld floats apart, ld even, the base 8-byte aligned);
// rows past `rows` and K values past n read as zero.
__device__ __forceinline__ void load_x(const float* __restrict__ x, int ld, int rows, int n,
                                       int i0, int t, float (&xv)[16]) {
  const int m = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
#pragma unroll
  for (int kk = 0; kk < kKc / 16; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int r = m + 8 * (g & 1), i = i0 + 16 * kk + 8 * (g >> 1) + 2 * q;
      float2 v = make_float2(0.0f, 0.0f);
      if (r < rows && i < n)
        v = __ldg(reinterpret_cast<const float2*>(x + static_cast<size_t>(r) * ld + i));
      xv[8 * kk + 2 * g] = v.x;
      xv[8 * kk + 2 * g + 1] = v.y;
    }
}

__device__ __forceinline__ void split_x(const float (&xv)[16], AFrag& a) {
#pragma unroll
  for (int kk = 0; kk < kKc / 16; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t p[3], q[3];
      split3(xv[8 * kk + 2 * g], p[0], p[1], p[2]);
      split3(xv[8 * kk + 2 * g + 1], q[0], q[1], q[2]);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) a.r[pc][kk][g] = __byte_perm(p[pc], q[pc], 0x7632);
    }
}

// d[32] (+)= A[64 x 16] . B[16 x 64]: A bf16 in registers, B bf16 K-major
// in shared memory, fp32 accumulators; scale_d 0 overwrites d.  Thread t
// of the warpgroup holds d[4 jn + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 +
// 8 h][8 jn + 2 (t % 4) + e].
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving accesses of registers the asynchronous
// matrix math reads or writes across it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int x = 0; x < 32; ++x) asm volatile("" : "+f"(d[x])::"memory");
}
__device__ __forceinline__ void reg_fence(AFrag& a) {
#pragma unroll
  for (int pc = 0; pc < 3; ++pc)
#pragma unroll
    for (int kk = 0; kk < kKc / 16; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) asm volatile("" : "+r"(a.r[pc][kk][g])::"memory");
}

__device__ __forceinline__ uint64_t desc(const uint8_t* p) { return smem_desc(p, kLbo, kSbo); }

// One chunk's kept piece products into acc (which it overwrites): a
// holds the tile's X pieces, b the B pieces (three of (1 - sim) . mask, or
// the mask alone when mask_b).  values: the tile holds a row that is not
// 0/1 (its pieces 2 and 3 are not all zero).  Warpgroup-uniform arguments.
__device__ __forceinline__ void chunk_products(float (&acc)[32], const AFrag& a, const uint8_t* b,
                                               bool mask_b, bool values) {
#pragma unroll
  for (int kk = 0; kk < kKc / 16; ++kk) {
    const int off = kk * 2 * kLbo;
    if (mask_b) {
      const uint64_t m = desc(b + 3 * kPiece + off);
      wgmma_bf16(acc, a.r[0][kk], m, kk);
      if (values) {
        wgmma_bf16(acc, a.r[1][kk], m, 1);
        wgmma_bf16(acc, a.r[2][kk], m, 1);
      }
    } else {
      const uint64_t b1 = desc(b + off), b2 = desc(b + kPiece + off), b3 = desc(b + 2 * kPiece + off);
      wgmma_bf16(acc, a.r[0][kk], b1, kk);
      wgmma_bf16(acc, a.r[0][kk], b2, 1);
      wgmma_bf16(acc, a.r[0][kk], b3, 1);
      if (values) {
        wgmma_bf16(acc, a.r[1][kk], b1, 1);
        wgmma_bf16(acc, a.r[1][kk], b2, 1);
        wgmma_bf16(acc, a.r[2][kk], b1, 1);
      }
    }
  }
}

// Row and column of accumulator register x of warpgroup thread t.
__device__ __forceinline__ int acc_row(int t, int x) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((x >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int x) { return 8 * (x >> 2) + 2 * (t & 3) + (x & 1); }

// The consumers' loop over chunks c0 .. c0 + nch - 1 of one pass.
// decode(c) builds chunk c's B pieces into dec + (c % 2) kDecHalf and
// releases its ring slot (every consumer thread calls it).  Each
// warpgroup multiplies its tile's X rows (rows [0, rows) of x, ld floats
// apart, K values past n zero; no rows: zeros) against them: while the
// wgmma of chunk c runs, chunk c + 1 is decoded and its X pieces split,
// and the X values of chunk c + 2 are loaded.  sum: the tile's fp32 sums
// (thread t of the warpgroup, the accumulator layout of wgmma_bf16).
// Every warpgroup runs the same wgmma sequence whatever its rows, and the
// flags are broadcast from lane 0, so that the compiler sees the matrix
// math on a warp-uniform path (else it serialises the wgmma).
template <int kCons, class Decode>
__device__ __forceinline__ void tile_pass(Decode&& decode, const uint8_t* dec, int c0, int nch,
                                          const float* x, int ld, int rows, int n, bool mask_b,
                                          bool values, int t, float (&sum)[32]) {
  mask_b = __shfl_sync(0xffffffffu, mask_b, 0);
  values = __shfl_sync(0xffffffffu, values, 0);
  float acc[32], xv[16];
  AFrag a0, a1;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    acc[r] = 0.0f;
    sum[r] = 0.0f;
  }
  load_x(x, ld, rows, n, 0, t, xv);
  split_x(xv, a0);
  if (nch > 1) load_x(x, ld, rows, n, kKc, t, xv);
  decode(c0);
  named_sync(kSyncId, kCons);
  auto step = [&](int k, AFrag& cur, AFrag& next) {
    const int c = c0 + k;
    reg_fence(acc);
    reg_fence(cur);
    wgmma_fence();
    chunk_products(acc, cur, dec + (c & 1) * kDecHalf, mask_b, values);
    wgmma_commit();
    if (k + 1 < nch) {
      decode(c + 1);
      split_x(xv, next);
      if (k + 2 < nch) load_x(x, ld, rows, n, (k + 2) * kKc, t, xv);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(cur);
#pragma unroll
    for (int r = 0; r < 32; ++r) sum[r] = __fadd_rn(sum[r], acc[r]);
    named_sync(kSyncId, kCons);   // chunk c's pieces are read
  };
  for (int k = 0; k < nch; k += 2) {
    step(k, a0, a1);
    if (k + 1 < nch) step(k + 1, a1, a0);
  }
}

}  // namespace rp
}  // namespace impop
