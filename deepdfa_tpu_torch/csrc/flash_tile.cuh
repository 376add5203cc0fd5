// Tile math of the flash-attention forward (flash_fwd_kernel in
// flash_attn.cu): the score tile and the P V product (the counterpart of
// _tile_scores in deepdfa_tpu/ops/attention.py:181).
//
// Layout. A block of NT = 256 threads works on 64-row query tiles and
// 64-row key tiles of one (batch, head). Thread t = 16 * ty + tx owns
// rows ty + 16 * i (i < 4) of a tile and columns tx + 16 * j: j < 4 of a
// [64, 64] score tile, j < D / 16 of a [64, D] head tile. The 16 threads
// of one row are one half-warp, so a row's max and sum are shuffles.
// Tiles sit in shared memory with a row stride of D + 1 (score tiles
// 64 + 1): odd strides, so the column walks of the products below hit 16
// different banks.
//
// Every product is an f32 FMA on the CUDA cores, at the reference's f32
// semantics (no TF32).

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr int BQ = 64;       // query rows a tile
constexpr int BK = 64;       // key rows a tile
constexpr int NT = 256;      // threads a block
constexpr int PS = BK + 1;   // row stride of a [BQ, BK] tile in shared memory
constexpr float NEG_INF = -1e30f;  // the reference's NEG_INF

__device__ __forceinline__ int tid_y() { return threadIdx.x >> 4; }
__device__ __forceinline__ int tid_x() { return threadIdx.x & 15; }

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a [64, D + 1]
// tile, times ``scale``; rows at or past n_rows read as zero (the ragged
// edge). ``src`` points at row 0 of the slice; rows are ``row_stride``
// floats apart ([B, T, H, D] has H * D).
template <int D>
__device__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                          int n_rows, long row_stride, float scale) {
  constexpr int V = D / 4;
  for (int e = threadIdx.x; e < 64 * V; e += NT) {
    const int r = e / V, c = (e % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      x = *reinterpret_cast<const float4*>(src + (long)(row0 + r) * row_stride
                                           + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x * scale;
    d[1] = x.y * scale;
    d[2] = x.z * scale;
    d[3] = x.w * scale;
  }
}

// Which of the key tile's 64 rows are real tokens: in range and set in
// the [Tk] padding mask of this batch row.
__device__ __forceinline__ void load_key_valid(int* dst,
                                               const unsigned char* mask_row,
                                               int k0, int tk) {
  if (threadIdx.x < 64) {
    const int k = k0 + threadIdx.x;
    dst[threadIdx.x] = (k < tk && mask_row[k]) ? 1 : 0;
  }
}

// The score tile s = (scale Q) K^T of query tile q0 and key tile k0 with
// the padding and (optionally) causal masks at NEG_INF: s[i][j] is row
// ty + 16 i, column tx + 16 j. Qs holds the pre-scaled queries.
template <int D>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks,
                                            const int* kvalid, int q0, int k0,
                                            bool causal, float s[4][4]) {
  const int ty = tid_y(), tx = tid_x();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool keep = kvalid[c] && (!causal || q0 + ty + 16 * i >= k0 + c);
      if (!keep) s[i][j] = NEG_INF;
    }
}

// acc[a][b] += sum_c A[ty + 16 a][c] * B[c][tx + 16 b]: A B over the 64
// columns of a [BQ, BK] tile A and the rows of a [BK, D] tile B (O += P V).
template <int D>
__device__ __forceinline__ void acc_nn(float acc[4][D / 16], const float* A,
                                       const float* B) {
  const int ty = tid_y(), tx = tid_x();
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    float a[4], b[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * PS + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) b[j] = B[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace flash
