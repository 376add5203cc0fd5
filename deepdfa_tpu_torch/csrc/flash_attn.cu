// Flash-attention kernels for Hopper (sm_90a): exact softmax attention
// over the [B, T, H, D] layout with a [B, Tk] padding mask (1 = token)
// and an optional causal mask, f32 throughout.
//
// flash_fwd_kernel        replaces deepdfa_tpu/ops/attention.py:
//                         _flash_kernel (launched from _flash_forward):
//                         O = softmax(scale Q K^T + mask) V by the online
//                         softmax, and the row logsumexp the backward
//                         rebuilds P from.
// flash_bwd_dq_kernel     replaces _flash_bwd_dq_kernel (the two-pass
//                         branch): dq = scale sum_j dS K.
// flash_bwd_dkv_kernel    replaces _flash_bwd_dkv_kernel (the two-pass
//                         branch): dv = sum_i P^T dO, dk = sum_i dS^T
//                         (scale Q).
//
// The single-pass backward (_flash_bwd_fused_kernel) is
// flash_bwd_fused_kernel in flash_bwd_fused.cu. The score tile and the
// tile-gradient step the kernels here share are in flash_tile.cuh. Plain
// PyTorch versions: flash_fwd_reference, flash_bwd_dq_reference and
// flash_bwd_dkv_reference in deepdfa_tpu_torch/ops/attention.py. Built
// by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file.
//
// What bounds them. At the training shape (B 16, T 512, H 12, D 64) the
// forward needs at most 4 B H T^2 D = 12.9 GFLOP (fewer with padded
// keys: only the (query, key) pairs the mask leaves count) against at
// most 25 MB of compulsory traffic (q, k, v in, o out); the two-pass
// backward pair 14 B H T^2 D against ~60 MB. At the H100 SXM data-sheet peaks for a 700 W card
// (67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s) that is ~190 us
// of arithmetic against ~8 us of bytes for the forward: every kernel is
// bound by f32 operations (ops/attention.py:kernel_cost counts them on
// the call's mask; chip_smoke.py prints the bound beside the measured
// time). The kernels compute whole 64 x 64 tiles, padded keys included,
// so they do more operations than the bound counts. f32 is held to the
// reference's f32 semantics, so TF32 tensor cores are out: every
// product is an f32 FMA.
//
// Design.
// * Tiles of 64 queries by 64 keys; 256 threads a block, each owning a
//   4 x 4 piece of a score tile and a 4 x D/16 piece of a [64, D] tile,
//   so every FMA reads two operands from shared memory for four.
// * A TPU grid is sequential and carries (acc, m, l) across its kv steps
//   in scratch; here the kv walk is a loop inside the block, and m, l and
//   O stay in registers. A query row's 16 threads are one half-warp, so
//   its max and sum are shuffles and P needs no block-wide barrier.
// * Fully masked rows: m stays NEG_INF, the shift is pinned to 0, every
//   P is 0, so O = 0 and lse = log(1e-30); the backward's exp(s - lse)
//   then underflows to 0 and the row's gradients are 0, not NaN.
// * The ragged edge (T not a multiple of 64) is masked by index in the
//   kernels, so every length runs here; the reference's blockwise
//   fallback for lengths it cannot tile has no counterpart.
// * Backward: where the fused kernel's dq partials grow too large
//   (flash_fused_bwd_ok in ops/attention.py: T 4096 at D 64) the pair of
//   two-pass kernels runs, each with one block per (batch, head, tile).
//   Every output element has one owner thread and a fixed summation
//   order: no atomics, deterministic.
// * Causal: key tiles wholly above a query tile's diagonal are skipped;
//   their scores would all be masked.

#include <cuda_runtime.h>

#include "flash_tile.cuh"

namespace flash {

// The head width the kernels are built for: codebert-base and
// unixcoder-base (768 / 12 heads). ops/attention.py:KERNEL_HEAD_DIM
// refuses any other before a launch.
constexpr int D = 64;

__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ mask,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                     int tq, int tk, int causal, float scale) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + 64 * (D + 1);
  float* Vs = Ks + 64 * (D + 1);
  float* Ps = Vs + 64 * (D + 1);
  int* kvalid = reinterpret_cast<int*>(Ps + BQ * PS);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int ty = tid_y(), tx = tid_x();
  const long rs = (long)H * D;
  const float* qb = q + ((long)b * tq * H + h) * D;
  const float* kb = k + ((long)b * tk * H + h) * D;
  const float* vb = v + ((long)b * tk * H + h) * D;

  load_tile<D>(Qs, qb, q0, tq, rs, scale);
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  int nk = (tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, kb, k0, tk, rs, 1.f);
    load_tile<D>(Vs, vb, k0, tk, rs, 1.f);
    load_key_valid(kvalid, mask + (long)b * tk, k0, tk);
    __syncthreads();
    float s[4][4];
    tile_scores<D>(Qs, Ks, kvalid, q0, k0, causal != 0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      // Fully masked so far: pin the shift to 0 so the exps stay finite.
      const float shift = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float corr =
          expf((m[i] <= NEG_INF / 2 ? NEG_INF : m[i]) - shift);
      float row = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = kvalid[c] ? expf(s[i][j] - shift) : 0.f;
        Ps[r * PS + c] = p;
        row += p;
      }
      l[i] = l[i] * corr + half_warp_sum(row);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row's P comes from its own half-warp
    acc_nn<D>(acc, Ps, Vs);
  }
  float* ob = o + ((long)b * tq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long)r * rs + tx + 16 * j] = acc[i][j] / lc;
    // lse = shift + log(l): exp(s - lse) is the normalized probability;
    // a fully masked row lands at log(1e-30).
    if (tx == 0)
      lse[(long)bh * tq + r] = (m[i] <= NEG_INF / 2 ? 0.f : m[i]) + logf(lc);
  }
}

__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int tq,
    int tk, int causal, float scale) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * (D + 1);
  float* Ks = dOs + 64 * (D + 1);
  float* Vs = Ks + 64 * (D + 1);
  float* dSs = Vs + 64 * (D + 1);
  float* lse_s = dSs + BQ * PS;
  float* delta_s = lse_s + BQ;
  int* kvalid = reinterpret_cast<int*>(delta_s + BQ);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;

  load_tile<D>(Qs, q + qoff, q0, tq, rs, scale);
  load_tile<D>(dOs, dout + qoff, q0, tq, rs, 1.f);
  load_rowvec(lse_s, lse + (long)bh * tq, q0, tq);
  load_rowvec(delta_s, delta + (long)bh * tq, q0, tq);
  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;
  int nk = (tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D>(Ks, k + koff, k0, tk, rs, 1.f);
    load_tile<D>(Vs, v + koff, k0, tk, rs, 1.f);
    load_key_valid(kvalid, mask + (long)b * tk, k0, tk);
    __syncthreads();
    float s[4][4];
    tile_scores<D>(Qs, Ks, kvalid, q0, k0, causal != 0, s);
    tile_grads<D, false>(s, dOs, Vs, lse_s, delta_s, q0, tq, nullptr, dSs);
    __syncwarp();  // a row's dS comes from its own half-warp
    acc_nn<D>(dq_acc, dSs, Ks);
  }
  store_tile<D>(dq + qoff, dq_acc, q0, tq, rs, scale);
}

__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int H, int tq, int tk, int causal, float scale) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * (D + 1);
  float* Ks = dOs + 64 * (D + 1);
  float* Vs = Ks + 64 * (D + 1);
  float* Ps = Vs + 64 * (D + 1);
  float* dSs = Ps + BQ * PS;
  float* lse_s = dSs + BQ * PS;
  float* delta_s = lse_s + BQ;
  int* kvalid = reinterpret_cast<int*>(delta_s + BQ);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;

  load_tile<D>(Ks, k + koff, k0, tk, rs, 1.f);
  load_tile<D>(Vs, v + koff, k0, tk, rs, 1.f);
  load_key_valid(kvalid, mask + (long)b * tk, k0, tk);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  const int nq = (tq + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<D>(Qs, q + qoff, q0, tq, rs, scale);
    load_tile<D>(dOs, dout + qoff, q0, tq, rs, 1.f);
    load_rowvec(lse_s, lse + (long)bh * tq, q0, tq);
    load_rowvec(delta_s, delta + (long)bh * tq, q0, tq);
    __syncthreads();
    float s[4][4];
    tile_scores<D>(Qs, Ks, kvalid, q0, k0, causal != 0, s);
    tile_grads<D, true>(s, dOs, Vs, lse_s, delta_s, q0, tq, Ps, dSs);
    __syncthreads();
    acc_tn<D>(dv_acc, Ps, dOs);
    acc_tn<D>(dk_acc, dSs, Qs);  // no extra scale: Qs is pre-scaled
  }
  store_tile<D>(dk + koff, dk_acc, k0, tk, rs, 1.f);
  store_tile<D>(dv + koff, dv_acc, k0, tk, rs, 1.f);
}

size_t fwd_smem() {
  return sizeof(float) * (3 * 64 * (D + 1) + BQ * PS) + sizeof(int) * BK;
}

size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * PS + 2 * BQ)
         + sizeof(int) * BK;
}

size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * PS + 2 * BQ)
         + sizeof(int) * BK;
}

// Opt the kernel into ``bytes`` of dynamic shared memory (above 48 KB
// needs it), then launch; returns the first CUDA error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t bytes, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

int fwd(const float* q, const float* k, const float* v,
        const unsigned char* mask, float* o, float* lse, int B, int H, int tq,
        int tk, int causal, float scale, cudaStream_t stream) {
  dim3 grid((tq + BQ - 1) / BQ, B * H);
  return launch(flash_fwd_kernel, grid, fwd_smem(), stream, q, k, v,
                mask, o, lse, H, tq, tk, causal, scale);
}

int bwd_dq(const float* q, const float* k, const float* v,
           const unsigned char* mask, const float* dout, const float* lse,
           const float* delta, float* dq, int B, int H, int tq, int tk,
           int causal, float scale, cudaStream_t stream) {
  dim3 grid((tq + BQ - 1) / BQ, B * H);
  return launch(flash_bwd_dq_kernel, grid, dq_smem(), stream, q, k, v,
                mask, dout, lse, delta, dq, H, tq, tk, causal, scale);
}

int bwd_dkv(const float* q, const float* k, const float* v,
            const unsigned char* mask, const float* dout, const float* lse,
            const float* delta, float* dk, float* dv, int B, int H, int tq,
            int tk, int causal, float scale, cudaStream_t stream) {
  dim3 grid((tk + BK - 1) / BK, B * H);
  return launch(flash_bwd_dkv_kernel, grid, dkv_smem(), stream, q, k,
                v, mask, dout, lse, delta, dk, dv, H, tq, tk, causal, scale);
}

}  // namespace flash

// ---------------------------------------------------------------------------
// Plain C interface (ctypes): each returns the launch's cudaError_t.
// q, o, dq: [B, Tq, H, D]; k, v, dk, dv: [B, Tk, H, D]; mask: [B, Tk]
// bytes; lse, delta: [B, H, Tq]; all f32 and contiguous.
// ---------------------------------------------------------------------------

extern "C" int flash_fwd_launch(const float* q, const float* k,
                                const float* v, const unsigned char* mask,
                                float* o, float* lse, int B, int H, int tq,
                                int tk, int causal, float scale,
                                cudaStream_t stream) {
  return flash::fwd(q, k, v, mask, o, lse, B, H, tq, tk, causal, scale,
                    stream);
}

extern "C" int flash_bwd_dq_launch(const float* q, const float* k,
                                   const float* v, const unsigned char* mask,
                                   const float* dout, const float* lse,
                                   const float* delta, float* dq, int B,
                                   int H, int tq, int tk, int causal,
                                   float scale, cudaStream_t stream) {
  return flash::bwd_dq(q, k, v, mask, dout, lse, delta, dq, B, H, tq, tk,
                       causal, scale, stream);
}

extern "C" int flash_bwd_dkv_launch(const float* q, const float* k,
                                    const float* v, const unsigned char* mask,
                                    const float* dout, const float* lse,
                                    const float* delta, float* dk, float* dv,
                                    int B, int H, int tq, int tk,
                                    int causal, float scale,
                                    cudaStream_t stream) {
  return flash::bwd_dkv(q, k, v, mask, dout, lse, delta, dk, dv, B, H, tq,
                        tk, causal, scale, stream);
}
