// bf16 products on Hopper's tensor cores with f32 sums, and the cp.async
// ring that feeds them: shared by the bf16 flash kernels, the forward
// (flash_fwd_kernel_bf16) and the two-pass backward (flash_bwd_dq_kernel_bf16,
// flash_bwd_dkv_kernel_bf16) in flash_attn.cu and the fused backward
// (flash_bwd_fused_kernel_bf16) in flash_bwd_fused.cu.
//
// * mma.sync.m16n8k16 with bf16 operands and f32 accumulation: a product
//   of two bf16 values is exact in f32, so S = Q K^T and dP = dO V^T of
//   bf16 inputs are the reference's f32 sums of exact products.
// * An f32 operand x (P or dS, kept in the accumulator registers that
//   produced it) against a bf16 operand: x is split in registers into
//   three bf16 parts, x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 -
//   x2). Each part keeps 8 significant bits and bf16 has f32's exponent
//   range, so x1 + x2 + x3 = x exactly wherever x3 stays normal (|x| >=
//   2^-100 or so) and each part's product with a bf16 value is exact in
//   f32. Three mma.sync over one B fragment, the smallest part first,
//   give the product at f32 accuracy (ops/attention.py:split_bf16x3 is
//   the same split in plain PyTorch).
// * Tiles live in shared memory as bf16, [rows, 64] with 128 bytes a row,
//   the row's eight 16-byte chunks XOR'd by row mod 8 (swz): ldmatrix
//   reads 8 rows of one chunk column, which then hit 32 different banks
//   whether it loads them as stored or transposed.
//
// Fragments of mma.sync.m16n8k16 (lane = 4 g + t; each register holds two
// bf16, the lower column or row in its low half): A (16 x 16, row-major)
// a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t +
// 8..); B (16 x 8) b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g); C (16 x 8)
// c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, the same columns). So the C
// fragments of n-tiles 2kk and 2kk + 1 are, packed in pairs, the A
// fragment of k-slice kk (frag_acc3).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

// Element offset of 16-byte chunk c (8 bf16) of row r in a swizzled
// [rows, 64] bf16 tile.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8. r[i] is matrix i's fragment: row l / 4, columns 2 (l % 4)
// and 2 (l % 4) + 1 (.trans: those rows of the transposed matrix).
__device__ __forceinline__ void ldsm4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += A B, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b0, const uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B for A split in three parts, the smallest first.
__device__ __forceinline__ void mma3(float c[4], const uint32_t a[3][4],
                                     const uint32_t b0, const uint32_t b1) {
  mma(c, a[2], b0, b1);
  mma(c, a[1], b0, b1);
  mma(c, a[0], b0, b1);
}

// Two f32 values as a bf16 pair (round to nearest even), x0 in the low
// half; and the halves back as f32 (exact).
__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float low(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float high(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// x0, x1 split three ways: p[0] the bf16 pair nearest, p[1] the pair
// nearest what is left, p[2] the rest (each subtraction exact in f32).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  p0 = pack(x0, x1);
  x0 -= low(p0);
  x1 -= high(p0);
  p1 = pack(x0, x1);
  x0 -= low(p1);
  x1 -= high(p1);
  p2 = pack(x0, x1);
}

// The A fragment of k-slice kk from the accumulators of n-tiles 2 kk (c0)
// and 2 kk + 1 (c1), split three ways: a[i] is part i.
__device__ __forceinline__ void frag_acc3(uint32_t a[3][4], const float c0[4],
                                          const float c1[4]) {
  split3(c0[0], c0[1], a[0][0], a[1][0], a[2][0]);
  split3(c0[2], c0[3], a[0][1], a[1][1], a[2][1]);
  split3(c1[0], c1[1], a[0][2], a[1][2], a[2][2]);
  split3(c1[2], c1[3], a[0][3], a[1][3], a[2][3]);
}

// The A fragment of a 16 x 16 slice of a swizzled tile: rows r0 .. r0 +
// 15, columns 16 kk ..
__device__ __forceinline__ void frag_a(uint32_t a[4], const __nv_bfloat16* t,
                                       int r0, int kk) {
  const int l = threadIdx.x & 31, m = l >> 3;
  ldsm4(a, t + swz(r0 + ((m & 1) << 3) + (l & 7), 2 * kk + (m >> 1)));
}

// B fragments of B(k, n) = T[n][k] (the tile as stored, rows are n): k in
// slice kk, n in tiles jn and jn + 1 (rows 8 jn ..): b[0..1] tile jn,
// b[2..3] tile jn + 1.
__device__ __forceinline__ void frag_bt(uint32_t b[4], const __nv_bfloat16* t,
                                        int kk, int jn) {
  const int l = threadIdx.x & 31, m = l >> 3;
  ldsm4(b, t + swz(8 * (jn + (m >> 1)) + (l & 7), 2 * kk + (m & 1)));
}

// B fragments of B(k, n) = T[k][n] (rows are k): k in slice kk (rows
// 16 kk ..), n in tiles jn and jn + 1 (columns 8 jn ..), by ldmatrix.trans.
__device__ __forceinline__ void frag_bn(uint32_t b[4], const __nv_bfloat16* t,
                                        int kk, int jn) {
  const int l = threadIdx.x & 31, m = l >> 3;
  ldsm4_t(b, t + swz(16 * kk + ((m & 1) << 3) + (l & 7), jn + (m >> 1)));
}

// A fragments of a 16 x 16 slice of A(m, k) = T[k][m] (the tile stored
// transposed, rows are k): k in slice kk (rows 16 kk ..), m in rows 16 mi ..
// (columns 16 mi ..), by ldmatrix.trans.
__device__ __forceinline__ void frag_at(uint32_t a[4], const __nv_bfloat16* t,
                                        int kk, int mi) {
  const int l = threadIdx.x & 31, m = l >> 3;
  ldsm4_t(a, t + swz(16 * kk + ((m >> 1) << 3) + (l & 7), 2 * mi + (m & 1)));
}

// ---------------------------------------------------------------------------
// Streamed tiles: [64, 64] bf16 tiles through a ring of cp.async stages.
// ---------------------------------------------------------------------------

constexpr int D = 64;         // the head width: a row is 128 bytes
constexpr int PT = 64;        // rows of a streamed tile
constexpr int TILE = PT * D;  // elements of a streamed tile

// The two-pass pair's layout (flash_attn.cu's head note has the others
// measured):
constexpr int BSTAGES = 3;  // the streamed tiles' ring
constexpr int BBLOCKS = 2;  // blocks an SM (__launch_bounds__)
constexpr int BNC = 16;     // a streamed tile's columns a warp takes at once

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + ROWS - 1 of one (batch, head) slice into a swizzled
// bf16 tile (swz) by cp.async, 16 bytes a copy (not waited for), NTH
// threads; rows at or past n_rows are zero-filled.
template <int ROWS, int NTH>
__device__ __forceinline__ void issue_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int row0, int n_rows,
                                           long row_stride) {
  for (int e = threadIdx.x; e < ROWS * D / 8; e += NTH) {
    const int r = e >> 3, c = e & 7;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + swz(r, c),
               src + (long)(in ? row0 + r : 0) * row_stride + 8 * c, in);
  }
}

// A query tile's lse and delta (rows row0 .. row0 + PT - 1 of the (batch,
// head) at offset base) into dst[0, PT) and dst[PT, 2 PT) by cp.async, NTH
// threads; rows at or past n_rows are zero.
template <int NTH>
__device__ __forceinline__ void issue_rows(float* dst,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           long base, int row0, int n_rows) {
  for (int i = threadIdx.x; i < 2 * PT; i += NTH) {
    const int r = row0 + i % PT;
    const float* src = (i < PT ? lse : delta) + base;
    cp_async4(dst + i, src + (r < n_rows ? r : 0), r < n_rows);
  }
}

// acc += A B^T over this warp's 16 rows and NC columns c0 ..: A the
// resident tile's rows r0 .., B a streamed tile's rows c0 .., contracted
// over D; one bf16 mma.sync a product.
template <int NC>
__device__ __forceinline__ void mma_bf16(float (&acc)[NC / 8][4],
                                         const __nv_bfloat16* res, int r0,
                                         const __nv_bfloat16* tile, int c0) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, res, r0, kk);
#pragma unroll
    for (int jp = 0; jp < NC / 16; ++jp) {
      uint32_t b[4];
      frag_bt(b, tile, kk, c0 / 8 + 2 * jp);
      mma(acc[2 * jp], a, b[0], b[1]);
      mma(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc += X T over this warp's 16 rows: X [16, NC] f32 accumulators (P or
// dS over a streamed tile's rows c0 ..), T those rows of the tile [64, D];
// each slice of X split three ways, three bf16 mma.sync a product.
template <int NC>
__device__ __forceinline__ void mma_split(float (&acc)[8][4],
                                          const float (&x)[NC / 8][4],
                                          const __nv_bfloat16* tile, int c0) {
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    uint32_t a[3][4];
    frag_acc3(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t b[4];
      frag_bn(b, tile, c0 / 16 + kk, 2 * jp);
      mma3(acc[2 * jp], a, b[0], b[1]);
      mma3(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace bf16mma
