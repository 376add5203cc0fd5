// The single-pass flash-attention backward for Hopper (sm_90a): dq, dk and
// dv of exact softmax attention over the [B, T, H, D] layout with a
// [B, Tk] padding mask (1 = token) and an optional causal mask, the
// products on the tensor cores at f32 accuracy. An f32 instance (3xTF32)
// and a bf16 one (bf16 products; q, k, v, dO in and dq, dk, dv out in
// bf16; lse, delta and the dq partials f32).
//
// flash_bwd_fused_kernel replaces deepdfa_tpu/ops/attention.py:
//                        _flash_bwd_fused_kernel (the single-pass branch
//                        of _flash_backward): P rebuilt from the saved row
//                        logsumexp, dP = dO V^T, dS = P (dP - delta), then
//                        dV = P^T dO, dK = dS^T (scale Q), dQ = scale dS K.
// flash_dq_sum_kernel    its second step: the dq partials of the key
//                        tiles summed in key-tile order, times scale.
// flash_bwd_fused_kernel_bf16 and flash_dq_sum_kernel_bf16: the bf16
//                        instance, kernels of their own (below).
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
//
// The bf16 instance, built for Hopper's bf16 tensor cores on the skeleton
// of flash_bwd_dkv_kernel_bf16 (flash_attn.cu; the shared device code in
// bf16_mma.cuh).
// * One block a (batch*head, FKR keys), a warp 16 keys: K and V resident
//   as swizzled bf16 tiles, Q, dO, lse and delta streamed through a
//   FSTAGES ring of cp.async copies over the query tiles that meet the
//   block (causal: none wholly before it).
// * S^T = K Q^T and dP^T = V dO^T: one bf16 m16n8k16 mma.sync a product
//   (exact products, f32 sums), S scaled in f32 (scale = 1/8: exact). P^T
//   and dS^T stay in registers; dV += P^T dO and dK += dS^T Q take each
//   split three ways into bf16 (three mma.sync, the smallest part first).
// * dq's partial for the query tile, dS K over the block's keys: the
//   warps hold dS^T by keys, the product contracts over them, so each
//   warp writes its dS^T's three bf16 parts to swizzled shared tiles; after
//   a barrier every warp reads a [16, DQ_COLS] piece's A operand back by
//   ldmatrix.trans, with the resident K as B (three mma.sync a product),
//   and stores its f32 partial once. flash_dq_sum_kernel_bf16 adds the
//   partials of a row in key-block order, times scale, rounded once to
//   bf16. No atomics: two launches give the same bits.
// * A 16-key slice with no real key, or (causal) wholly after the query
//   tile, has dS = 0: its warp skips its products and every warp its
//   slice of the dq product (no approximation); a block with no real key
//   writes zero dk and dv and no partials, and the sum skips it.
// * Not the f32 instance's bits: the sums group 16 products where 3xTF32
//   grouped 8, and the partials sum over FKR keys, so an output may land
//   one bf16 step from the f32 kernel's rounded result (or within 1e-5 of
//   it where sums cancel); as a mean over each output it lies no further
//   from a float64 evaluation of the reference's formulas (chip_smoke.py's
//   attention_kernels_bf16).
// Layouts built and timed by scripts/torch_flash_bf16_layouts.py: see
// FKW below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace flash_bwd {

using tf32x3::D;  // head width (ops/attention.py:KERNEL_HEAD_DIM)
using tf32x3::load4;
using tf32x3::store2;
using tf32x3::store4;
using tf32x3::sw;
using tf32x3::warp_mma;

constexpr int TB = 64;  // query and key tile rows
constexpr int NT = 256;  // threads a block: 8 warps
constexpr int TILE_FLOATS = TB * D;  // one swizzled [64, 64] tile
constexpr float NEG_INF = -1e30f;    // the reference's NEG_INF

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Rows [row0, row0 + 64) of one (batch, head) slice into a swizzled f32
// tile, times scale; rows at or past n_rows read as zero.
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows,
                                          long row_stride, float scale) {
  for (int e = threadIdx.x; e < TB * D / 4; e += NT) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4(src + (long)(row0 + r) * row_stride + c);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(dst + sw(r, c)) = x;
  }
}

// Write this warp's 16 x 32 accumulator piece to rows row0 + m0.. of a
// [T, H, D] slice (row_stride elements apart), rows < n_rows only.
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
      store2(dst + (long)r * row_stride + n0 + 8 * j + 2 * t,
             acc[j][2 * half], acc[j][2 * half + 1]);
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

constexpr int SUM_ROWS = 16;  // query rows a block of the dq sum

// dq[b, r] = scale * sum over key blocks kb (KR keys each), ascending, of
// the partial of (kb, r) where the fused kernel wrote one: kb holds a real
// key and (causal) r's query tile is not before it. One block a (16 rows,
// batch row); the key blocks' liveness is read from the same mask into
// live[]. dq is written as T (bf16: rounded once, from the f32 sum).
template <typename T, int KR>
__device__ __forceinline__ void dq_sum(const float* __restrict__ dq_part,
                                       const unsigned char* __restrict__ mask,
                                       T* __restrict__ dq, int* live, int B,
                                       int H, int tq, int tk, int causal,
                                       float scale) {
  const int b = blockIdx.y, r0 = blockIdx.x * SUM_ROWS;
  const int nk = (tk + KR - 1) / KR;
  for (int kt = threadIdx.x; kt < nk; kt += NT) {
    int any = 0;
    for (int c = kt * KR; c < min(tk, kt * KR + KR); ++c)
      any |= mask[(long)b * tk + c];
    live[kt] = any != 0;
  }
  __syncthreads();
  const int row4 = H * D / 4;  // float4s a [H, D] row
  const int rows = min(SUM_ROWS, tq - r0);
  const float4* part = reinterpret_cast<const float4*>(dq_part);
  for (int e = threadIdx.x; e < rows * row4; e += NT) {
    const int r = r0 + e / row4, c = e % row4;
    const int kt_end = causal ? min(nk, r / KR + 1) : nk;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int kt = 0; kt < kt_end; ++kt) {
      if (!live[kt]) continue;
      const float4 x = part[(((long)kt * B + b) * tq + r) * row4 + c];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    store4(dq + (((long)b * tq + r) * row4 + c) * 4,
           make_float4(acc.x * scale, acc.y * scale, acc.z * scale,
                       acc.w * scale));
  }
}

// The f32 instance's sum, over 64-key tiles.
__global__ void __launch_bounds__(NT) flash_dq_sum_kernel(
    const float* __restrict__ dq_part, const unsigned char* __restrict__ mask,
    float* __restrict__ dq, int B, int H, int tq, int tk, int causal,
    float scale) {
  extern __shared__ int live32[];
  dq_sum<float, TB>(dq_part, mask, dq, live32, B, H, tq, tk, causal, scale);
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

// ---------------------------------------------------------------------------
// The bf16 instance: bf16 tiles, bf16 mma.sync (bf16_mma.cuh).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using bf16mma::BNC;
using bf16mma::cp_async_commit;
using bf16mma::cp_async_wait;
using bf16mma::frag_at;
using bf16mma::frag_bn;
using bf16mma::issue_bf16;
using bf16mma::issue_rows;
using bf16mma::mma_bf16;
using bf16mma::mma_split;
using bf16mma::swz;
constexpr int TILE16 = TB * D;  // bf16 elements of a streamed tile

// The layout kept. Built and timed by scripts/torch_flash_bf16_layouts.py
// (B 16, T 512, H 12 on an H100 SXM; PERF.md has the numbers):
// ms at that shape, the kernel and its sum, the kept layout first and last:
//   128 keys a block, a 2-stage ring, two blocks an SM (kept; 113 KB, 128
//     registers, 34 bytes spilled): 0.3054-0.3060;
//   64 keys, a 3-stage ring, two blocks an SM (89.5 KB, 213 registers, no
//     spill): 0.3492 (twice the partials' bytes and K, V loads);
//   128 keys, a 3-stage ring, one block an SM (129.5 KB, 209 registers):
//     0.3363.
constexpr int FKW = 8;      // warps a block, 16 keys each
constexpr int FSTAGES = 2;  // the query tiles' ring
constexpr int FBLOCKS = 2;  // blocks an SM (__launch_bounds__)
constexpr int FKR = 16 * FKW;  // keys a block: a dq partial's key block
constexpr int FNT = 32 * FKW;  // threads a block
// The dq product: 4 warps along the query tile's 64 rows, the rest along
// its D columns.
static_assert(FKW % 4 == 0, "4 warps a column of the dq product");
constexpr int DQ_COLS = D / (FKW / 4);

// Shared memory of flash_bwd_fused_kernel_bf16: K and V resident, Q and dO
// in the ring, dS^T's three bf16 parts [FKR, 64], a stage's lse and delta
// (at 128 keys and 2 stages: 113 KB, two blocks an SM).
constexpr size_t kSmemBytesBf16 =
    sizeof(bf16) * (2 * FKR * D + 2 * FSTAGES * TILE16 + 3 * FKR * TB)
    + sizeof(float) * 2 * FSTAGES * TB;

// Which of the block's 16-key slices (keys k0 + 16 w ..) hold a real key,
// one bit each; every warp computes the same bits.
__device__ __forceinline__ unsigned live_slices(
    const unsigned char* __restrict__ mrow, int k0, int tk) {
  constexpr int KPL = FKR / 32;  // keys a lane
  constexpr int LPS = 16 / KPL;  // lanes a slice
  const int lane = threadIdx.x & 31;
  bool any = false;
#pragma unroll
  for (int u = 0; u < KPL; ++u) {
    const int key = k0 + KPL * lane + u;
    any |= key < tk && mrow[key];
  }
  const unsigned vote = __ballot_sync(0xffffffffu, any);
  unsigned bits = 0;
#pragma unroll
  for (int w = 0; w < FKW; ++w)
    if ((vote >> (LPS * w)) & ((1u << LPS) - 1)) bits |= 1u << w;
  return bits;
}

// Write a warp's [16, D] accumulator (rows row0 + g, + 8) to a [T, H, D]
// slice, times scale, rounded once to bf16, rows < n_rows only.
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[8][4],
                                           int row0, int n_rows,
                                           long row_stride, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + (long)r * row_stride + 8 * j + 2 * t,
             acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
  }
}

__global__ void __launch_bounds__(FNT, FBLOCKS) flash_bwd_fused_kernel_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq_part,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int tq,
    int tk, int causal, float scale) {
  extern __shared__ float4 smem_fused16[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_fused16);
  bf16* Vs = Ks + FKR * D;
  bf16* ring = Vs + FKR * D;  // [FSTAGES][Q, dO][TILE16]
  bf16* dSs = ring + 2 * FSTAGES * TILE16;  // [3][FKR, TB]: dS^T's parts
  // [FSTAGES][2][TB]: a stage's lse, then delta
  float* rowv = reinterpret_cast<float*>(dSs + 3 * FKR * TB);

  const int kb = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kb * FKR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows of Ks and Vs
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;
  const unsigned char* mrow = mask + (long)b * tk;
  const unsigned live = live_slices(mrow, k0, tk);
  const int kr = k0 + r0 + g;  // this thread's keys: kr and kr + 8
  const bool real[2] = {kr < tk && mrow[kr], kr + 8 < tk && mrow[kr + 8]};
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  if (!live) {
    // No real key: P = dS = 0, so dk = dv = 0 and no partial; nothing is
    // loaded.
    store_rows(dk + koff, dk_acc, k0 + r0, tk, rs, 1.f);
    store_rows(dv + koff, dv_acc, k0 + r0, tk, rs, 1.f);
    return;
  }
  // Start the copies of query tile qt (Q, dO, lse, delta) into stage st.
  auto issue = [&](int qt, int st) {
    bf16* qs = ring + 2 * st * TILE16;
    issue_bf16<TB, FNT>(qs, q + qoff, qt * TB, tq, rs);
    issue_bf16<TB, FNT>(qs + TILE16, dout + qoff, qt * TB, tq, rs);
    issue_rows<FNT>(rowv + 2 * TB * st, lse, delta, (long)bh * tq, qt * TB,
                    tq);
  };

  const int nq = (tq + TB - 1) / TB;
  // Causal: query tiles wholly before the block's first key see none of it.
  int qt = causal ? min(nq, k0 / TB) : 0;
  // K and V join the first copy group; then FSTAGES - 1 query tiles.
  issue_bf16<FKR, FNT>(Ks, k + koff, k0, tk, rs);
  issue_bf16<FKR, FNT>(Vs, v + koff, k0, tk, rs);
#pragma unroll
  for (int st = 0; st < FSTAGES - 1; ++st) {
    if (qt + st < nq) issue(qt + st, st);
    cp_async_commit();
  }
  // This warp's piece of the dq product: query rows 16 mi .., columns n0 ..
  const int mi = warp & 3, n0 = DQ_COLS * (warp >> 2);
  float* part = dq_part + (((long)kb * B + b) * tq * H + h) * D;
  for (int s = 0; qt < nq; ++s, ++qt) {
    const int st = s % FSTAGES;
    cp_async_wait<FSTAGES - 2>();
    __syncthreads();  // tile s landed; its stage and dS^T's tiles are free
    if (qt + FSTAGES - 1 < nq)  // overlaps this tile's products
      issue(qt + FSTAGES - 1, (s + FSTAGES - 1) % FSTAGES);
    cp_async_commit();
    const bf16* Qt = ring + 2 * st * TILE16;
    const bf16* Ot = Qt + TILE16;
    const float* lse_s = rowv + 2 * TB * st;
    const float* delta_s = lse_s + TB;
    const int q0 = qt * TB;
    // Whether key slice w meets this query tile: a real key, and (causal)
    // not wholly after the tile's last query. Otherwise its dS is 0.
    auto slice_live = [&](int w) {
      return ((live >> w) & 1u) && (!causal || q0 + TB - 1 >= k0 + 16 * w);
    };
    if (slice_live(warp)) {
#pragma unroll
      for (int c0 = 0; c0 < TB; c0 += BNC) {  // queries q0 + c0 ..
        float s_acc[BNC / 8][4], dp[BNC / 8][4];
        zero(s_acc);
        zero(dp);
        mma_bf16<BNC>(s_acc, Ks, r0, Qt, c0);  // S^T / scale = K Q^T
        mma_bf16<BNC>(dp, Vs, r0, Ot, c0);     // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < BNC / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = kr + 8 * (i >> 1);             // key
            const int c = c0 + 8 * j + 2 * t + (i & 1);  // query q0 + c
            const bool keep = real[i >> 1] && q0 + c < tq &&
                              (!causal || q0 + c >= r);
            const float p =
                keep ? expf(s_acc[j][i] * scale - lse_s[c]) : 0.f;
            s_acc[j][i] = p;                         // P^T
            dp[j][i] = p * (dp[j][i] - delta_s[c]);  // dS^T
          }
        mma_split<BNC>(dv_acc, s_acc, Ot, c0);  // dV += P^T dO
        mma_split<BNC>(dk_acc, dp, Qt, c0);     // dK / scale += dS^T Q
        // dS^T's three parts, for the dq product.
#pragma unroll
        for (int j = 0; j < BNC / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = c0 + 8 * j + 2 * t;
            uint32_t p0, p1, p2;
            bf16mma::split3(dp[j][2 * half], dp[j][2 * half + 1], p0, p1,
                            p2);
            uint32_t* x = reinterpret_cast<uint32_t*>(
                dSs + swz(r0 + g + 8 * half, c >> 3) + (c & 7));
            x[0] = p0;
            x[FKR * TB / 2] = p1;  // the next part's tile
            x[FKR * TB] = p2;
          }
      }
    }
    __syncthreads();  // every live slice's dS^T parts written
    // dq's partial: dS K over the block's live key slices.
    float dq_acc[DQ_COLS / 8][4];
    zero(dq_acc);
#pragma unroll
    for (int w = 0; w < FKW; ++w) {
      if (!slice_live(w)) continue;
      uint32_t a[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) frag_at(a[i], dSs + i * FKR * TB, w, mi);
#pragma unroll
      for (int jp = 0; jp < DQ_COLS / 16; ++jp) {
        uint32_t bk[4];
        frag_bn(bk, Ks, w, n0 / 8 + 2 * jp);
        bf16mma::mma3(dq_acc[2 * jp], a, bk[0], bk[1]);
        bf16mma::mma3(dq_acc[2 * jp + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = q0 + 16 * mi + g + 8 * half;
      if (r >= tq) continue;
#pragma unroll
      for (int j = 0; j < DQ_COLS / 8; ++j)
        *reinterpret_cast<float2*>(part + (long)r * rs + n0 + 8 * j + 2 * t) =
            make_float2(dq_acc[j][2 * half], dq_acc[j][2 * half + 1]);
    }
  }
  cp_async_wait<0>();  // a walk with no query tile leaves K and V in flight
  store_rows(dk + koff, dk_acc, k0 + r0, tk, rs, scale);
  store_rows(dv + koff, dv_acc, k0 + r0, tk, rs, 1.f);
}

// The bf16 instance's sum, over FKR-key blocks.
__global__ void __launch_bounds__(NT) flash_dq_sum_kernel_bf16(
    const float* __restrict__ dq_part, const unsigned char* __restrict__ mask,
    bf16* __restrict__ dq, int B, int H, int tq, int tk, int causal,
    float scale) {
  extern __shared__ int live16[];
  dq_sum<bf16, FKR>(dq_part, mask, dq, live16, B, H, tq, tk, causal, scale);
}

int bwd_fused(const bf16* q, const bf16* k, const bf16* v,
              const unsigned char* mask, const bf16* dout, const float* lse,
              const float* delta, float* dq_part, bf16* dq, bf16* dk,
              bf16* dv, int B, int H, int tq, int tk, int causal,
              float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel_bf16,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytesBf16);
  if (err != cudaSuccess) return (int)err;
  const int nk = (tk + FKR - 1) / FKR;
  flash_bwd_fused_kernel_bf16<<<dim3(nk, B * H), FNT, kSmemBytesBf16,
                                stream>>>(q, k, v, mask, dout, lse, delta,
                                          dq_part, dk, dv, B, H, tq, tk,
                                          causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_dq_sum_kernel_bf16<<<dim3((tq + SUM_ROWS - 1) / SUM_ROWS, B), NT,
                             sizeof(int) * nk, stream>>>(
      dq_part, mask, dq, B, H, tq, tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd

// ---------------------------------------------------------------------------
// Plain C interface (ctypes): returns the launches' first cudaError_t.
// q, dout, dq: [B, Tq, H, D]; k, v, dk, dv: [B, Tk, H, D]; mask: [B, Tk]
// bytes; lse, delta: [B, H, Tq] f32; dq_part: [ceil(Tk / 64), B, Tq, H, D]
// f32 scratch (flash_bwd_fused_bf16_launch: ceil(Tk / FKR) key blocks);
// the rest f32 (flash_bwd_fused_bf16_launch: bf16); all contiguous, D = 64.
// ---------------------------------------------------------------------------

extern "C" int flash_bwd_fused_launch(
    const float* q, const float* k, const float* v, const unsigned char* mask,
    const float* dout, const float* lse, const float* delta, float* dq_part,
    float* dq, float* dk, float* dv, int B, int H, int tq, int tk, int causal,
    float scale, cudaStream_t stream) {
  return flash_bwd::bwd_fused(q, k, v, mask, dout, lse, delta, dq_part, dq,
                              dk, dv, B, H, tq, tk, causal, scale, stream);
}

extern "C" int flash_bwd_fused_bf16_launch(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const unsigned char* mask, const __nv_bfloat16* dout, const float* lse,
    const float* delta, float* dq_part, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int H, int tq, int tk,
    int causal, float scale, cudaStream_t stream) {
  return flash_bwd::bwd_fused(q, k, v, mask, dout, lse, delta, dq_part, dq,
                              dk, dv, B, H, tq, tk, causal, scale, stream);
}

// The keys a dq partial of the bf16 instance covers: its dq_part is
// [ceil(Tk / key_rows), B, Tq, H, D] f32.
extern "C" int flash_bwd_fused_bf16_key_rows() { return flash_bwd::FKR; }
