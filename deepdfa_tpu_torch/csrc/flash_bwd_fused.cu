// The single-pass flash-attention backward for Hopper (sm_90a): dq, dk and
// dv of exact softmax attention over the [B, T, H, D] layout with a
// [B, Tk] padding mask (1 = token) and an optional causal mask, f32 in and
// out, the products on the tensor cores at f32 accuracy (3xTF32).
//
// flash_bwd_fused_kernel replaces deepdfa_tpu/ops/attention.py:
//                        _flash_bwd_fused_kernel (the single-pass branch
//                        of _flash_backward): P rebuilt from the saved row
//                        logsumexp, dP = dO V^T, dS = P (dP - delta), then
//                        dV = P^T dO, dK = dS^T (scale Q), dQ = scale dS K.
// flash_dq_sum_kernel    its second step: the dq partials of the key
//                        tiles summed in key-tile order, times scale.
//
// Plain PyTorch version: flash_bwd_fused_reference in
// deepdfa_tpu_torch/ops/attention.py (delta is computed outside, as the
// reference's _flash_backward does). Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file.
//
// What bounds it. At the training shape (B 16, T 512, H 12, D 64) the
// five [64, 64] x [64, 64] products of each (query tile, key tile) pair
// come to 10 B H T^2 D = 32 GFLOP at most (fewer with padded keys: only
// the (query, key) pairs the mask leaves count) against ~60 MB of
// compulsory traffic: bound by operations. The products run as 3xTF32
// on the tensor cores, so the bound divides f32 work by a third of the
// 495 TFLOP/s TF32 rate (ops/attention.py:kernel_cost; chip_smoke.py
// prints the bound beside the measured time and the card's name and
// power limit).
//
// Design.
// * The TPU grid (B*H, nk, nq) ran in order on one core with one (batch,
//   head)'s dq resident in VMEM. Here one block owns one (batch*head, key
//   tile): 1536 blocks at the training shape, fewer than 97 KB of shared
//   memory each so two fit an SM. dk and dv stay in registers across the
//   block's walk over the query tiles.
// * dq sums over key tiles, which are other blocks. Without atomics: each
//   block writes its [64, D] partial dq of each query tile to an f32
//   buffer [nk, B, Tq, H, D]; flash_dq_sum_kernel then adds the partials
//   of a row in key-tile order and applies scale. Every output element
//   has one owner and a fixed summation order, so two launches on the
//   same inputs give the same bits.
// * A key tile with no real key has P = dS = 0: its block writes zero dk
//   and dv and no partials, and the sum skips it (the same test on the
//   same mask). This is the same function, with no approximation.
// * The five products are 3xTF32 mma.sync.m16n8k8 (tf32_mma.cuh, shared
//   with the two-pass pair): f32 accuracy, as the reference runs f32 at
//   Precision.HIGHEST. Single-pass TF32 is never used.
// * 8 warps a block; each product's [64, 64] output is 4 x 2 warp tiles
//   of 16 x 32. Operands come from shared memory, where every [64, 64]
//   tile is stored with its 4-column groups XOR-swizzled by row, so the
//   fragment loads of both orientations (row-major and transposed) hit 32
//   different banks.
// * Fully masked rows have lse = log(1e-30) and every score masked, so P
//   and their gradients are 0, not NaN; ragged edges (T not a multiple of
//   64) are masked by index; causal skips the query tiles wholly before
//   the key tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace flash_bwd {

using tf32x3::D;  // head width (ops/attention.py:KERNEL_HEAD_DIM)
using tf32x3::sw;
using tf32x3::warp_mma;

constexpr int TB = 64;  // query and key tile rows
constexpr int NT = 256;  // threads a block: 8 warps
constexpr int TILE_FLOATS = TB * D;  // one swizzled [64, 64] tile
constexpr float NEG_INF = -1e30f;    // the reference's NEG_INF

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a swizzled tile,
// times scale; rows at or past n_rows read as zero.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows,
                                          long row_stride, float scale) {
  for (int e = threadIdx.x; e < TB * D / 4; e += NT) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      x = *reinterpret_cast<const float4*>(src + (long)(row0 + r) * row_stride
                                           + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(dst + sw(r, c)) = x;
  }
}

// Write this warp's 16 x 32 accumulator piece to rows row0 + m0.. of a
// [T, H, D] slice (row_stride floats apart), rows < n_rows only.
__device__ __forceinline__ void store_acc(float* dst, const float acc[4][4],
                                          int row0, int m0, int n0,
                                          int n_rows, long row_stride) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + m0 + g + 8 * half;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(dst + (long)r * row_stride + n0 + 8 * j
                                 + 2 * t) =
          make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// Shared memory of flash_bwd_fused_kernel: six swizzled [64, 64] tiles
// (K, V, Q, dO, P, dS), lse and delta of the query tile, the key mask.
constexpr size_t kSmemBytes =
    sizeof(float) * (6 * TILE_FLOATS + 2 * TB) + sizeof(int) * TB;

__global__ void __launch_bounds__(NT, 2) flash_bwd_fused_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq_part,
    float* __restrict__ dk, float* __restrict__ dv, int B, int H, int tq,
    int tk, int causal, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE_FLOATS;
  float* Qs = Vs + TILE_FLOATS;
  float* dOs = Qs + TILE_FLOATS;
  float* Ps = dOs + TILE_FLOATS;
  float* dSs = Ps + TILE_FLOATS;
  float* lse_s = dSs + TILE_FLOATS;
  float* delta_s = lse_s + TB;
  int* kvalid = reinterpret_cast<int*>(delta_s + TB);

  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * TB;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;

  int valid = 0;
  if (tid < TB) {
    valid = k0 + tid < tk && mask[(long)b * tk + k0 + tid];
    kvalid[tid] = valid;
  }
  if (!__syncthreads_or(valid)) {
    // No real key: P = dS = 0, so dk = dv = 0 and no dq partial.
    const float zeros[4][4] = {};
    store_acc(dk + koff, zeros, k0, m0, n0, tk, rs);
    store_acc(dv + koff, zeros, k0, m0, n0, tk, rs);
    return;
  }
  load_tile(Ks, k + koff, k0, tk, rs, 1.f);
  load_tile(Vs, v + koff, k0, tk, rs, 1.f);

  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);
  const int nq = (tq + TB - 1) / TB;
  // Causal: query tiles wholly before this key tile see none of it.
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * TB;
    __syncthreads();  // the previous query tile's readers are done
    load_tile(Qs, q + qoff, q0, tq, rs, scale);  // pre-scaled: S and dK
    load_tile(dOs, dout + qoff, q0, tq, rs, 1.f);
    if (tid < TB) {
      const bool in = q0 + tid < tq;
      lse_s[tid] = in ? lse[(long)bh * tq + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[(long)bh * tq + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    warp_mma<false, true>(s, Qs, Ks, m0, n0);    // S = (scale Q) K^T
    warp_mma<false, true>(dp, dOs, Vs, m0, n0);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + g + 8 * (i >> 1);
        const int c = n0 + 8 * j + 2 * t + (i & 1);
        const bool keep = q0 + r < tq && kvalid[c] &&
                          (!causal || q0 + r >= k0 + c);
        const float p = keep ? expf(s[j][i] - lse_s[r]) : 0.f;
        s[j][i] = p;
        dp[j][i] = p * (dp[j][i] - delta_s[r]);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half, c = n0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(Ps + sw(r, c)) =
            make_float2(s[j][2 * half], s[j][2 * half + 1]);
        *reinterpret_cast<float2*>(dSs + sw(r, c)) =
            make_float2(dp[j][2 * half], dp[j][2 * half + 1]);
      }
    __syncthreads();
    warp_mma<true, false>(dv_acc, Ps, dOs, m0, n0);  // dV += P^T dO
    warp_mma<true, false>(dk_acc, dSs, Qs, m0, n0);  // dK += dS^T (scale Q)
    float dq_acc[4][4];
    zero(dq_acc);
    warp_mma<false, false>(dq_acc, dSs, Ks, m0, n0);  // dS K
    store_acc(dq_part + (((long)kt * B + b) * tq * H + h) * D, dq_acc, q0,
              m0, n0, tq, rs);
  }
  store_acc(dk + koff, dk_acc, k0, m0, n0, tk, rs);
  store_acc(dv + koff, dv_acc, k0, m0, n0, tk, rs);
}

constexpr int SUM_ROWS = 16;  // query rows a block of flash_dq_sum_kernel

// dq[b, r] = scale * sum over key tiles kt, ascending, of the partial of
// (kt, r) where flash_bwd_fused_kernel wrote one: kt holds a real key and
// (causal) r's query tile is not before it. One block a (16 rows, batch
// row); the key tiles' liveness is read from the same mask.
__global__ void __launch_bounds__(NT) flash_dq_sum_kernel(
    const float* __restrict__ dq_part, const unsigned char* __restrict__ mask,
    float* __restrict__ dq, int B, int H, int tq, int tk, int causal,
    float scale) {
  extern __shared__ int live[];
  const int b = blockIdx.y, r0 = blockIdx.x * SUM_ROWS;
  const int nk = (tk + TB - 1) / TB;
  for (int kt = threadIdx.x; kt < nk; kt += NT) {
    int any = 0;
    for (int c = kt * TB; c < min(tk, kt * TB + TB); ++c)
      any |= mask[(long)b * tk + c];
    live[kt] = any != 0;
  }
  __syncthreads();
  const int row4 = H * D / 4;  // float4s a [H, D] row
  const int rows = min(SUM_ROWS, tq - r0);
  const float4* part = reinterpret_cast<const float4*>(dq_part);
  float4* out = reinterpret_cast<float4*>(dq);
  for (int e = threadIdx.x; e < rows * row4; e += NT) {
    const int r = r0 + e / row4, c = e % row4;
    const int kt_end = causal ? min(nk, r / TB + 1) : nk;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int kt = 0; kt < kt_end; ++kt) {
      if (!live[kt]) continue;
      const float4 x = part[(((long)kt * B + b) * tq + r) * row4 + c];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    out[((long)b * tq + r) * row4 + c] =
        make_float4(acc.x * scale, acc.y * scale, acc.z * scale,
                    acc.w * scale);
  }
}

int bwd_fused(const float* q, const float* k, const float* v,
              const unsigned char* mask, const float* dout, const float* lse,
              const float* delta, float* dq_part, float* dq, float* dk,
              float* dv, int B, int H, int tq, int tk, int causal,
              float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int nk = (tk + TB - 1) / TB;
  flash_bwd_fused_kernel<<<dim3(nk, B * H), NT, kSmemBytes, stream>>>(
      q, k, v, mask, dout, lse, delta, dq_part, dk, dv, B, H, tq, tk, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dq_sum_kernel<<<dim3((tq + SUM_ROWS - 1) / SUM_ROWS, B), NT,
                        sizeof(int) * nk, stream>>>(dq_part, mask, dq, B, H,
                                                    tq, tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd

// ---------------------------------------------------------------------------
// Plain C interface (ctypes): returns the launches' first cudaError_t.
// q, dout, dq: [B, Tq, H, D]; k, v, dk, dv: [B, Tk, H, D]; mask: [B, Tk]
// bytes; lse, delta: [B, H, Tq]; dq_part: [ceil(Tk / 64), B, Tq, H, D]
// scratch; all f32 (but mask) and contiguous, D = 64.
// ---------------------------------------------------------------------------

extern "C" int flash_bwd_fused_launch(
    const float* q, const float* k, const float* v, const unsigned char* mask,
    const float* dout, const float* lse, const float* delta, float* dq_part,
    float* dq, float* dk, float* dv, int B, int H, int tq, int tk, int causal,
    float scale, cudaStream_t stream) {
  return flash_bwd::bwd_fused(q, k, v, mask, dout, lse, delta, dq_part, dq,
                              dk, dv, B, H, tq, tk, causal, scale, stream);
}
