// f32 products on Hopper's tensor cores at f32 accuracy (3xTF32), shared
// by the flash-attention kernels: flash_bwd_fused_kernel
// (flash_bwd_fused.cu), the forward flash_fwd_kernel and the two-pass pair
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel (flash_attn.cu); the GNN
// weight pass step_weight_grad_kernel (fused_gnn_bwd.cu) uses split and
// mma3.
//
// Each f32 operand is split as hi = tf32(x), lo = tf32(x - hi), and
// hi*hi + hi*lo + lo*hi is accumulated in f32 by mma.sync.m16n8k8, the
// small terms first (CUTLASS's OpMultiplyAddFastF32, the scheme of
// PyTorch's own f32 memory-efficient attention): f32 accuracy, as the
// reference runs f32 at Precision.HIGHEST. Single-pass TF32 is never used.
//
// The flash kernels' bf16 instances read bf16 inputs through load4 and write
// bf16 outputs through store2/store4: a bf16 value widens to f32 exactly, and
// its TF32 split is exact (lo = 0), so such an instance computes what the f32
// kernel computes on the widened inputs, rounded once (RNE) on the way out.
//
// Fragments of mma.sync.m16n8k8 (lane = 4 g + t): A (16 x 8, row-major)
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8)
// b0 (k t, n g), b1 (k t + 4, n g); C (16 x 8) c0, c1 (g, 2 t and 2 t + 1),
// c2, c3 (g + 8, the same columns).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// Four consecutive elements as f32: one 16-byte load of f32, one 8-byte load
// of bf16 widened (a bf16 value is the high half of its f32).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Two or four consecutive f32 results stored as the output's type; bf16
// rounds to nearest even (__float2bfloat16_rn, torch's rounding).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  store2(p, x.x, x.y);
  store2(p + 2, x.z, x.w);
}

constexpr int D = 64;  // head width (ops/attention.py:KERNEL_HEAD_DIM)

// Element (r, c) of a [64, 64] tile in shared memory: each row's 4-column
// groups permuted by an XOR of the row. Fragment loads read 8 rows x 4
// columns (row-major operands) or 4 rows x 8 columns (transposed ones);
// sigma spreads both over 32 banks.
__device__ __forceinline__ int sw(int r, int c) {
  const int x = r & 7;
  const int sigma = ((x << 1) | (x >> 2)) & 7;
  return r * D + (c ^ (sigma << 2));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo to about 2^-22 relative, each part a TF32 value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A B in 3xTF32 from split operands: the small terms first, then the
// large one (CUTLASS's order).
__device__ __forceinline__ void mma3(float c[4], const uint32_t ahi[4],
                                     const uint32_t alo[4],
                                     const uint32_t bhi[2],
                                     const uint32_t blo[2]) {
  mma(c, alo, bhi);
  mma(c, ahi, blo);
  mma(c, ahi, bhi);
}

// acc += A B for this warp's 16 x 32 piece of a [64, 64] product with a
// contraction of 64: rows m0.., columns n0.. (4 tiles of 8). A(m, k) and
// B(k, n) read swizzled tiles, each either as stored (row index first) or
// transposed (kAT / kBT). acc[j] is the mma accumulator of column tile j:
// (row m0 + g, columns n0 + 8 j + 2 t, +1) and (row m0 + g + 8, the same).
template <bool kAT, bool kBT>
__device__ __forceinline__ void warp_mma(float acc[4][4], const float* A,
                                         const float* B, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < 64; k0 += 8) {
    const int ra[4][2] = {{m0 + g, k0 + t}, {m0 + g + 8, k0 + t},
                          {m0 + g, k0 + t + 4}, {m0 + g + 8, k0 + t + 4}};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ra[i][0], k = ra[i][1];
      split(kAT ? A[sw(k, m)] : A[sw(m, k)], ahi[i], alo[i]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 8 * j + g;
      uint32_t bhi[2], blo[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = k0 + t + 4 * i;
        split(kBT ? B[sw(n, k)] : B[sw(k, n)], bhi[i], blo[i]);
      }
      mma3(acc[j], ahi, alo, bhi, blo);
    }
  }
}

}  // namespace tf32x3
