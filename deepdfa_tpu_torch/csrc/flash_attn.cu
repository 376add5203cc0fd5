// Flash-attention kernels for Hopper (sm_90a): exact softmax attention
// over the [B, T, H, D] layout with a [B, Tk] padding mask (1 = token)
// and an optional causal mask. Each kernel has an f32 instance and a bf16
// one (q, k, v, dO in and o, dq, dk, dv out in bf16; lse and delta f32; every
// score, probability and sum f32, as the reference's kernels widen their
// operands and accumulate with preferred_element_type=f32).
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
// flash_bwd_fused_kernel in flash_bwd_fused.cu. The 3xTF32 products are
// in tf32_mma.cuh, which the fused backward shares; the bf16 kernels'
// bf16 products and cp.async ring in bf16_mma.cuh. Plain PyTorch
// versions: flash_fwd_reference, flash_bwd_dq_reference and
// flash_bwd_dkv_reference in deepdfa_tpu_torch/ops/attention.py. Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file.
//
// What bounds them. At the training shape (B 16, T 512, H 12, D 64) the
// forward needs at most 4 B H T^2 D = 12.9 GFLOP (fewer with padded
// keys: only the (query, key) pairs the mask leaves count) against at
// most 25 MB of compulsory traffic (q, k, v in, o out); the two-pass
// backward pair 14 B H T^2 D against ~60 MB. Every kernel is bound by
// operations (ops/attention.py:kernel_cost counts them on the call's
// mask; chip_smoke.py prints the bound beside the measured time): f32
// work as 3xTF32 on the tensor cores, a third of the H100 SXM data-sheet
// 495 TFLOP/s for a 700 W card; at bf16 S and dP at the dense bf16 rate
// (989 TFLOP/s) and the products with P or dS at a third of it.
//
// Shared design. One block a (batch, head, 64 query rows) for the
// forward, a (batch, head, 128 query rows) for the dq kernel and a
// (batch, head, 128 keys) for the dk/dv kernel, each walking the other
// side's 64-row tiles.
// * Each warp owns 16 rows for the whole walk: it computes its 16 x 64
//   piece of S (and dP in the backward; S^T and dP^T in the dk/dv kernel),
//   so P and dS stay in its registers and feed the next products as mma A
//   fragments (frag_acc): no shared-memory round trip, no barrier between
//   the products. The forward's online softmax (row max, row sum, the
//   rescale of the O accumulator) runs on those registers, a row's four
//   lanes combined by quad shuffles.
// * The f32 instances' products are 3xTF32 mma.sync (tf32_mma.cuh). Each
//   operand is split into hi and lo once: the resident one (scale Q, dO; K
//   and V) once a block, into the A-fragment order its warp reads with one
//   128-bit load a part; each streamed tile once a load, in place.
// * The streamed tiles (K and V; Q, dO, lse and delta) arrive by
//   cp.async: in the pair through a ring (the next tiles' copies overlap
//   this one's products), in the forward single buffered with two blocks
//   an SM (one block's copies overlap the other's products). Streamed
//   tiles are XOR-swizzled by row, so the fragment reads of both
//   orientations hit 32 banks.
// * Dead key tiles are skipped with no approximation: a key tile with no
//   real key has P = dS = 0 and leaves the forward's running max and sum
//   as they were. The forward and the dq kernel mark the live tiles of
//   their walk from the mask (one bit each) and neither load nor multiply
//   the others; in the dk/dv kernel the warps of a dead 64-key tile skip
//   their products and write zeros, and a block with no real key returns
//   at once. Each tile is tested on the mask: padding need not be a tail.
// * Fully masked rows: m stays NEG_INF, the shift is pinned to 0, every
//   P is 0, so O = 0 and lse = log(1e-30); the backward's exp(s - lse)
//   then underflows to 0 and the row's gradients are 0, not NaN.
// * Causal: tiles wholly across the diagonal are skipped (64-row tiles,
//   by warps); the ragged edge (T not a multiple of 64) is masked by
//   index, so every length runs here; the reference's blockwise fallback
//   for lengths it cannot tile has no counterpart.
// * Every output element has one owner thread and a fixed summation
//   order: no atomics, so two launches give the same bits.
//
// The f32 forward's block: 64 query rows (4 warps), K and V single buffered,
// 96 KB of shared memory, two blocks an SM. Two layouts were built and
// timed: this one, and 128 query rows (8 warps) with K and V double
// buffered, 160 KB, one block an SM (64-row blocks double buffered would
// take 128 KB, one block an SM, 4 warps). ptxas gave 193-194 registers to
// this one and 183 to the 128-row one, neither spilling, so both reach
// their occupancy. On an H100 SXM at 700 W (chip_smoke.py's attention phase
// under scripts/torch_kernel_ab.py, both runs of the new tree) the 64-row
// blocks took 0.281-0.284 ms at B 16, T 512 and 6.02-6.06 ms at B 8,
// T 4096, the 128-row ones 0.290-0.293 and 6.32: twice the blocks, each
// waiting on half the rows at a tile's barriers, in finer waves over 132
// SMs, with the other block's products hiding a tile's copy.
//
// Backward pair. Where the fused kernel's dq partials grow too large
// (flash_fused_bwd_ok in ops/attention.py: T 4096 at D 64) the pair runs:
// flash_bwd_dq_kernel with one block per (batch, head, 128 query rows)
// walking the key tiles, flash_bwd_dkv_kernel with one block per (batch,
// head, 128 keys) walking the query tiles. The f32 instances hold both
// parts of everything, double buffered: 225 KB of shared memory, one
// block an SM.
//
// The bf16 kernels (flash_fwd_kernel_bf16 and the bf16 pair,
// flash_bwd_dq_kernel_bf16 and flash_bwd_dkv_kernel_bf16) are kernels of
// their own, built for Hopper's bf16 tensor cores (bf16_mma.cuh; the
// fused backward's bf16 kernel in flash_bwd_fused.cu is built the same
// way).
// * bf16 stays bf16: the resident tiles (Q and dO; K and V) and the
//   streamed ones land by cp.async, 16 bytes a copy, as bf16 in shared
//   memory, each row's 16-byte chunks XOR'd by row (bf16mma::swz), and
//   reach the products by ldmatrix (.trans for the B operand of dS K,
//   P^T dO and dS^T Q). No hi or lo tile, no widening pass: 32 KB of
//   residents and 16 KB a ring stage.
// * S = Q K^T and dP = dO V^T (S^T and dP^T in the dk/dv kernel): one
//   m16n8k16 bf16 mma.sync with f32 sums, the products of two bf16 values
//   exact. scale = 1/sqrt(64) = 1/8 is a power of two, so S is scaled in
//   f32 after the product and dq and dk as they are stored, exactly as
//   the reference's scale Q.
// * O += P V, dq += dS K, dV += P^T dO, dK += dS^T Q: P and dS stay in the
//   accumulator registers that made them; each value is split there into
//   three bf16 parts (bf16mma::split3), exact, and the three parts' mma.sync
//   share one B fragment, the smallest first: the product at f32 accuracy
//   (each part times a bf16 value exact in f32), where 3xTF32 kept 22 of
//   P's bits. Counted in m16n8k16-sized steps for a 16-deep slice of a
//   16 x 8 output: 1 + 1 + 3 = 5 for dq and 8 for dk/dv, against the
//   3xTF32 design's 18 and 24.
// * Not the f32 kernels' bits: the sums group 16 products where 3xTF32
//   grouped 8, so an output may land one bf16 step from the f32 kernel's
//   rounded result (or, near 0 where sums cancel, within 1e-5 of it); as a
//   mean over each output it lies no further from a float64 evaluation of
//   the reference's formulas (chip_smoke.py's attention_kernels_bf16).
// * The forward: one block a (batch, head, 128 query rows), Q resident,
//   K and V through a 3-stage ring over the live key tiles; a warp takes a
//   key tile FWD_NC keys at a time: S, its masks and the online softmax
//   on those registers (the fully masked row's shift pinned to 0, lse =
//   shift + log(max(l, 1e-30)), as the f32 kernel), then O += P V; O stays
//   f32 in registers and is rounded once to bf16 as it is stored. Keys
//   past a warp's last row (causal) are skipped: they leave m, l and O as
//   they are.
// * The walk is as above (dead key tiles, causal tiles, masks, no
//   atomics). Ring: BSTAGES tiles in flight; a warp takes a streamed
//   tile BNC columns at a time, so its S and dP pieces take 8 registers
//   each beside the 64 of the dk/dv accumulators.
// Layouts built and timed by scripts/torch_flash_bf16_layouts.py (B 8,
// T 4096, H 12, on an H100 SXM at 700 W, two calls, each running the kept
// layout first and last; ms dq, dk/dv):
//   two blocks an SM, 3-stage ring, 16 columns a pass (kept; 80 and 81.5
//     KB, 128 registers, 24 and 26 bytes spilled): 2.538-2.568,
//     3.524-3.592;
//   the same at 32 columns (24 and 94 bytes spilled): 2.550-2.556,
//     3.864-3.866;
//   two blocks, 4-stage ring, 32 columns: 2.535-2.581, 3.901-3.926;
//   one block an SM, 4-stage ring, 64 columns (201 and 230 registers, no
//     spill): 3.536-3.563, 4.679-4.716.
// Half the warps on an SM hide less of the mma.sync and ldmatrix latency
// than a few spilled bytes cost; a deeper ring gains nothing measurable.
// The forward's layouts (B 16, T 512 and B 8, T 4096, H 12, the same card,
// one call, the kept one first and last; ms):
//   128 query rows, two blocks an SM, 64 keys at once (kept; 128
//     registers, 4 bytes spilled): 0.1054, 2.3485;
//   the same 16 keys at once (8 bytes spilled): 0.1159, 2.6145-2.6344;
//   64 query rows, three blocks an SM, 64 keys at once (159 registers):
//     0.1160, 2.4843; 16 keys at once (140 registers): 0.1339, 2.8792.
// A whole key tile a pass rescales O once a tile, not four times, and
// issues its 16 S products back to back.
// A wgmma version would take 64-row warpgroup tiles (4 warps together),
// K, V, Q or dO as the B operand straight from the swizzled shared tiles,
// and S, dP and the split parts of P and dS as A from registers; the split
// keeps its three products, each one wgmma.

#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "tf32_mma.cuh"

namespace flash {

// The head width the kernels are built for: codebert-base and
// unixcoder-base (768 / 12 heads). ops/attention.py:KERNEL_HEAD_DIM
// refuses any other before a launch.
constexpr int D = 64;
constexpr float NEG_INF = -1e30f;  // the reference's NEG_INF

// ---------------------------------------------------------------------------
// Device code shared by the forward and the two-pass backward pair.
// ---------------------------------------------------------------------------

using bf16mma::cp_async16;
using bf16mma::cp_async_commit;
using bf16mma::cp_async_wait;
using bf16mma::issue_bf16;
using bf16mma::issue_rows;
using tf32x3::load4;
using tf32x3::mma3;
using tf32x3::split;
using tf32x3::store2;
using bf16 = __nv_bfloat16;

constexpr int PW = 8;         // warps a block of the pair
constexpr int PNT = 32 * PW;  // threads a block of the pair
constexpr int PR = 16 * PW;   // resident rows a block: 16 a warp
constexpr int PT = 64;        // rows of a streamed tile
constexpr int RES = PR * D;   // floats of a resident operand's hi or lo part
constexpr int TILE = PT * D;  // floats of one streamed tile

// Element (r, c) of a streamed [64, 64] tile in shared memory: each row's
// 4-column groups XOR'd by r mod 8, so that both fragment reads (frag_bt:
// 8 rows x 4 columns; frag_bp: 4 even or 4 odd rows x 8 columns) hit 32
// different banks.
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + (c ^ ((r & 7) << 2));
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Rows row0 .. row0 + ROWS - 1 of one (batch, head) slice (row_stride
// elements apart), times scale, split once into TF32 hi and
// lo parts, each stored in the order warp r / 16 reads them as mma A
// fragments: float4 (w * 8 + kc) * 32 + lane holds a0..a3 of contraction
// chunk kc. Rows at or past n_rows are zero. NTH threads share the work.
template <int ROWS = PR, int NTH = PNT>
__device__ void load_resident(float* hi, float* lo,
                              const float* __restrict__ src, int row0,
                              int n_rows, long row_stride, float scale) {
  for (int e = threadIdx.x; e < ROWS * D / 4; e += NTH) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      x = load4(src + (long)(row0 + r) * row_stride + c);
    const float xs[4] = {x.x * scale, x.y * scale, x.z * scale, x.w * scale};
    // (r, c + u): warp r / 16, chunk c / 8, lane 4 (r % 8) + u, slot
    // (r / 8) % 2 + 2 ((c / 4) % 2).
    const int base = (((r >> 4) * 8 + (c >> 3)) * 32 + (r & 7) * 4) * 4
                     + ((r >> 3) & 1) + 2 * ((c >> 2) & 1);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t h, l;
      split(xs[u], h, l);
      hi[base + 4 * u] = __uint_as_float(h);
      lo[base + 4 * u] = __uint_as_float(l);
    }
  }
}

// Rows row0 .. row0 + 63 of one (batch, head) slice into a swizzled tile by
// cp.async (not waited for); rows at or past n_rows are zero-filled.
template <int NTH = PNT>
__device__ __forceinline__ void issue_tile(float* dst,
                                           const float* __restrict__ src,
                                           int row0, int n_rows,
                                           long row_stride) {
  for (int e = threadIdx.x; e < TILE / 4; e += NTH) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + swz(r, c), src + (long)(in ? row0 + r : 0) * row_stride
                                    + c, in);
  }
}

// A landed tile, times scale, split once: the hi part in place, the lo part
// beside it (the same swizzled positions).
template <int NTH = PNT>
__device__ __forceinline__ void split_tile(float* tile, float* lo,
                                           float scale) {
  for (int e = threadIdx.x; e < TILE / 4; e += NTH) {
    float4 x = reinterpret_cast<float4*>(tile)[e];
    uint32_t h[4], l[4];
    split(x.x * scale, h[0], l[0]);
    split(x.y * scale, h[1], l[1]);
    split(x.z * scale, h[2], l[2]);
    split(x.w * scale, h[3], l[3]);
    reinterpret_cast<float4*>(tile)[e] =
        make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    reinterpret_cast<float4*>(lo)[e] =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// Chunk kc of this warp's resident A operand (one part).
__device__ __forceinline__ void frag_a(uint32_t a[4], const float* part,
                                       int kc) {
  const float4 x = reinterpret_cast<const float4*>(
      part)[((threadIdx.x >> 5) * 8 + kc) * 32 + (threadIdx.x & 31)];
  a[0] = __float_as_uint(x.x);
  a[1] = __float_as_uint(x.y);
  a[2] = __float_as_uint(x.z);
  a[3] = __float_as_uint(x.w);
}

// B(k, n) = T[n][k] of a split tile, k in chunk kc, n in column tile j.
__device__ __forceinline__ void frag_bt(uint32_t hi[2], uint32_t lo[2],
                                        const float* thi, const float* tlo,
                                        int kc, int j) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = swz(8 * j + g, 8 * kc + t + 4 * i);
    hi[i] = __float_as_uint(thi[x]);
    lo[i] = __float_as_uint(tlo[x]);
  }
}

// B(k, n) = T[k][n] of a split tile, k in chunk kc with its slots permuted
// as frag_acc leaves them: slot t is row 8 kc + 2 t, slot t + 4 row
// 8 kc + 2 t + 1.
__device__ __forceinline__ void frag_bp(uint32_t hi[2], uint32_t lo[2],
                                        const float* thi, const float* tlo,
                                        int kc, int j) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = swz(8 * kc + 2 * t + i, 8 * j + g);
    hi[i] = __float_as_uint(thi[x]);
    lo[i] = __float_as_uint(tlo[x]);
  }
}

// Chunk kc of an A operand straight from this warp's accumulator tile
// (c = its column tile kc), split: columns 2 t and 2 t + 1 of rows g and
// g + 8 become slots t and t + 4, the order frag_bp reads B's rows in. P and
// dS never leave the registers.
__device__ __forceinline__ void frag_acc(uint32_t hi[4], uint32_t lo[4],
                                         const float c[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// acc += A B^T over this warp's 16 rows: A [16, 64] from a resident operand,
// B [64, 64] a split streamed tile, contracted over D.
__device__ __forceinline__ void mma_resident(float acc[8][4], const float* ahi,
                                             const float* alo,
                                             const float* thi,
                                             const float* tlo) {
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) {
    uint32_t a_hi[4], a_lo[4];
    frag_a(a_hi, ahi, kc);
    frag_a(a_lo, alo, kc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b_hi[2], b_lo[2];
      frag_bt(b_hi, b_lo, thi, tlo, kc, j);
      mma3(acc[j], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// acc += A T over this warp's 16 rows: A [16, 64] the warp's accumulator
// tile (P or dS), T [64, D] a split streamed tile, contracted over its rows.
__device__ __forceinline__ void mma_registers(float acc[8][4],
                                              const float a[8][4],
                                              const float* thi,
                                              const float* tlo) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    uint32_t a_hi[4], a_lo[4];
    frag_acc(a_hi, a_lo, a[kc]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t b_hi[2], b_lo[2];
      frag_bp(b_hi, b_lo, thi, tlo, kc, j);
      mma3(acc[j], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// Write this warp's [16, D] accumulator (rows row0 + 16 warp + g, + 8) to a
// [T, H, D] slice of T, times scale, rows < n_rows only.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float acc[8][4],
                                           int row0, int n_rows,
                                           long row_stride, float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 16 * (threadIdx.x >> 5) + g + 8 * half;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + (long)r * row_stride + 8 * j + 2 * t,
             acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
}

// Which of key tiles 0 .. kend - 1 hold a real key (in range and set in
// this batch row's mask), one bit each in live[]: NTH threads, each
// reading 16 keys, a warp 8 tiles. Starts and ends with a barrier.
template <int NTH>
__device__ void mark_live_tiles(unsigned* live,
                                const unsigned char* __restrict__ mrow,
                                int kend, int tk) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kmax = min(tk, kend * PT);
  for (int i = tid; i < (kend + 31) / 32; i += NTH) live[i] = 0;
  __syncthreads();
  for (int base = 0; base < kmax; base += NTH * 16) {
    const int c0 = base + tid * 16;
    bool any = false;
#pragma unroll
    for (int u = 0; u < 16; ++u) any |= c0 + u < kmax && mrow[c0 + u];
    const unsigned vote = __ballot_sync(0xffffffffu, any);
    if (lane == 0) {
      unsigned bits = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if ((vote >> (4 * i)) & 0xfu) bits |= 1u << i;
      const int tile0 = base / PT + 8 * warp;
      if (bits) atomicOr(&live[tile0 >> 5], bits << (tile0 & 31));
    }
  }
  __syncthreads();
}

// The first live key tile at or after kt (kend if none): dead ones are
// skipped, neither loaded nor multiplied.
__device__ __forceinline__ int next_live(const unsigned* live, int kt,
                                         int kend) {
  while (kt < kend && !((live[kt >> 5] >> (kt & 31)) & 1u)) ++kt;
  return kt;
}

// Warps 0 and 1 vote key tile kt's real keys into kbits[0] and kbits[1].
__device__ __forceinline__ void vote_keys(
    unsigned* kbits, const unsigned char* __restrict__ mrow, int kt, int tk) {
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int key = kt * PT + threadIdx.x;
    const unsigned vote = __ballot_sync(0xffffffffu, key < tk && mrow[key]);
    if ((threadIdx.x & 31) == 0) kbits[warp] = vote;
  }
}

// Start the copies of key tile kt (K into ks, V into vs; not waited for)
// and vote its real keys into kbits[0] and kbits[1].
template <int NTH>
__device__ __forceinline__ void issue_kv(float* ks, float* vs,
                                         unsigned* kbits,
                                         const float* __restrict__ kb,
                                         const float* __restrict__ vb,
                                         const unsigned char* __restrict__ mrow,
                                         int kt, int tk, long rs) {
  issue_tile<NTH>(ks, kb, kt * PT, tk, rs);
  issue_tile<NTH>(vs, vb, kt * PT, tk, rs);
  vote_keys(kbits, mrow, kt, tk);
}

// ---------------------------------------------------------------------------
// The forward.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int FW = 4;         // warps a block of the forward
constexpr int FNT = 32 * FW;  // threads a block of the forward
constexpr int FR = 16 * FW;   // query rows a block of the forward

// Shared memory of flash_fwd_kernel: scale Q split (2 resident parts), K
// and V, their lo parts, the tile's key bits, and one bit a key tile of
// the walk: 96 KB, two blocks an SM.
size_t fwd_smem(int tk) {
  const int nk = (tk + PT - 1) / PT;
  return sizeof(float) * (2 * FR * D + 4 * TILE)
         + sizeof(unsigned) * (2 + (nk + 31) / 32);
}

// One block a (batch, head, 64 query rows), 4 warps of 16 rows each,
// walking the live key tiles: a tile is split once it lands, multiplied,
// and only then is the next one's copy issued (the other block on the SM
// runs its products meanwhile).
__global__ void __launch_bounds__(FNT, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ mask,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                     int tq, int tk, int causal, float scale) {
  extern __shared__ float4 smem_fwd[];
  float* Qhi = reinterpret_cast<float*>(smem_fwd);
  float* Qlo = Qhi + FR * D;
  float* Khi = Qlo + FR * D;  // the landed tile, its hi part once split
  float* Vhi = Khi + TILE;
  float* Klo = Vhi + TILE;
  float* Vlo = Klo + TILE;
  unsigned* kbits = reinterpret_cast<unsigned*>(Vlo + TILE);  // [2]
  unsigned* live = kbits + 2;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * FR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;
  const unsigned char* mrow = mask + (long)b * tk;
  int kend = (tk + PT - 1) / PT;
  // Causal: key tiles wholly above the block's last query row see nothing.
  if (causal) kend = min(kend, (q0 + FR - 1) / PT + 1);
  auto issue = [&](int kt) {
    issue_kv<FNT>(Khi, Vhi, kbits, k + koff, v + koff, mrow, kt, tk, rs);
  };

  mark_live_tiles<FNT>(live, mrow, kend, tk);
  int kt = next_live(live, 0, kend);
  if (kt < kend) issue(kt);
  cp_async_commit();
  // Resident for the whole walk, split once: scale Q.
  load_resident<FR, FNT>(Qhi, Qlo, q + qoff, q0, tq, rs, scale);
  // Rows g and g + 8 of the warp: running max, sum, and the O accumulator.
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o_acc[8][4];
  zero(o_acc);
  while (kt < kend) {
    cp_async_wait_all();
    __syncthreads();  // tile kt landed
    split_tile<FNT>(Khi, Klo, 1.f);
    split_tile<FNT>(Vhi, Vlo, 1.f);
    __syncthreads();
    const int k0 = kt * PT;
    // Causal: a query tile wholly before the key tile sees none of it.
    if (!causal || k0 <= q0 + PT - 1) {
      float s_acc[8][4];
      zero(s_acc);
      mma_resident(s_acc, Qhi, Qlo, Khi, Klo);  // S = (scale Q) K^T
      const unsigned kb0 = kbits[0], kb1 = kbits[1];
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + 16 * warp + g + 8 * (i >> 1);
          const int c = 8 * j + 2 * t + (i & 1);
          const bool real = ((j < 4 ? kb0 >> c : kb1 >> (c - 32)) & 1u);
          if (!real || (causal && r < k0 + c)) s_acc[j][i] = NEG_INF;
          mx[i >> 1] = fmaxf(mx[i >> 1], s_acc[j][i]);
        }
      float shift[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float m_new = fmaxf(m_r[half], quad_max(mx[half]));
        // Fully masked so far: pin the shift to 0 so the exps stay finite.
        shift[half] = m_new <= NEG_INF / 2 ? 0.f : m_new;
        corr[half] = expf((m_r[half] <= NEG_INF / 2 ? NEG_INF : m_r[half])
                          - shift[half]);
        m_r[half] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sv = s_acc[j][i];
          const float p = sv <= NEG_INF / 2 ? 0.f : expf(sv - shift[i >> 1]);
          s_acc[j][i] = p;  // P, the A operand of P V
          sum[i >> 1] += p;
          o_acc[j][i] *= corr[i >> 1];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half)
        l_r[half] = l_r[half] * corr[half] + quad_sum(sum[half]);
      mma_registers(o_acc, s_acc, Vhi, Vlo);  // O += P V
    }
    __syncthreads();  // every reader of the tile and its key bits done
    kt = next_live(live, kt + 1, kend);
    if (kt < kend) issue(kt);
    cp_async_commit();
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + 16 * warp + g + 8 * half;
    if (r >= tq) continue;
    const float lc = fmaxf(l_r[half], 1e-30f);
    float* orow = o + qoff + (long)r * rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(orow + 8 * j + 2 * t, o_acc[j][2 * half] / lc,
             o_acc[j][2 * half + 1] / lc);
    // lse = shift + log(l): exp(s - lse) is the normalized probability; a
    // fully masked row lands at log(1e-30).
    if (t == 0)
      lse[(long)bh * tq + r] =
          (m_r[half] <= NEG_INF / 2 ? 0.f : m_r[half]) + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// The two-pass backward pair.
// ---------------------------------------------------------------------------

// Shared memory of flash_bwd_dq_kernel: scale Q and dO split (4 resident
// parts), K and V in two stages, their lo parts, a stage's key bits, and
// one bit a key tile of the walk.
size_t dq_smem(int tk) {
  const int nk = (tk + PT - 1) / PT;
  return sizeof(float) * (4 * RES + 6 * TILE)
         + sizeof(unsigned) * (4 + (nk + 31) / 32);
}

// Shared memory of flash_bwd_dkv_kernel: K and V split (4 resident
// parts), Q and dO in two stages, their lo parts, a stage's lse and delta.
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * RES + 6 * TILE + 4 * PT);
}

__global__ void __launch_bounds__(PNT, 1) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int H, int tq,
    int tk, int causal, float scale) {
  extern __shared__ float4 smem_dq[];
  float* Qhi = reinterpret_cast<float*>(smem_dq);
  float* Qlo = Qhi + RES;
  float* Ohi = Qlo + RES;
  float* Olo = Ohi + RES;
  float* Ks = Olo + RES;  // [2][TILE]: a stage's landed tile, its hi part
  float* Vs = Ks + 2 * TILE;
  float* Klo = Vs + 2 * TILE;
  float* Vlo = Klo + TILE;
  unsigned* kbits = reinterpret_cast<unsigned*>(Vlo + TILE);  // [2][2]
  unsigned* live = kbits + 4;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * PR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;
  const unsigned char* mrow = mask + (long)b * tk;
  int kend = (tk + PT - 1) / PT;
  // Causal: key tiles wholly above the block's last query row see nothing.
  if (causal) kend = min(kend, (q0 + PR - 1) / PT + 1);

  // Start the copies of key tile kt into stage st, its real keys into
  // kbits[st].
  auto issue = [&](int kt, int st) {
    issue_kv<PNT>(Ks + st * TILE, Vs + st * TILE, kbits + 2 * st, k + koff,
                  v + koff, mrow, kt, tk, rs);
  };

  mark_live_tiles<PNT>(live, mrow, kend, tk);
  int kt = next_live(live, 0, kend);
  if (kt < kend) issue(kt, 0);
  cp_async_commit();
  // Resident for the whole walk, split once: scale Q (S) and dO (dP).
  load_resident(Qhi, Qlo, q + qoff, q0, tq, rs, scale);
  load_resident(Ohi, Olo, dout + qoff, q0, tq, rs, 1.f);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + 16 * warp + g + 8 * half;
    lse_r[half] = r < tq ? lse[(long)bh * tq + r] : 0.f;
    delta_r[half] = r < tq ? delta[(long)bh * tq + r] : 0.f;
  }
  // This warp's 64-row query tile: past tq, it has nothing to compute.
  const int qtile0 = q0 + 64 * (warp >> 2);
  float dq_acc[8][4];
  zero(dq_acc);
  for (int s = 0; kt < kend; ++s) {
    const int st = s & 1;
    cp_async_wait_all();
    __syncthreads();  // stage st landed; stage st ^ 1 and the lo parts free
    const int kn = next_live(live, kt + 1, kend);
    if (kn < kend) issue(kn, st ^ 1);  // overlaps this tile's products
    cp_async_commit();
    float* Khi = Ks + st * TILE;
    float* Vhi = Vs + st * TILE;
    split_tile(Khi, Klo, 1.f);
    split_tile(Vhi, Vlo, 1.f);
    __syncthreads();
    const int k0 = kt * PT;
    // Causal: a query tile wholly before the key tile sees none of it.
    if (qtile0 < tq && (!causal || k0 <= qtile0 + PT - 1)) {
      float s_acc[8][4], dp[8][4];
      zero(s_acc);
      zero(dp);
      mma_resident(s_acc, Qhi, Qlo, Khi, Klo);  // S = (scale Q) K^T
      mma_resident(dp, Ohi, Olo, Vhi, Vlo);     // dP = dO V^T
      const unsigned kb0 = kbits[2 * st], kb1 = kbits[2 * st + 1];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + 16 * warp + g + 8 * (i >> 1);
          const int c = 8 * j + 2 * t + (i & 1);
          const bool real = ((j < 4 ? kb0 >> c : kb1 >> (c - 32)) & 1u);
          const bool keep = r < tq && real && (!causal || r >= k0 + c);
          const float p = keep ? expf(s_acc[j][i] - lse_r[i >> 1]) : 0.f;
          s_acc[j][i] = p * (dp[j][i] - delta_r[i >> 1]);  // dS
        }
      mma_registers(dq_acc, s_acc, Khi, Klo);  // dq += dS K
    }
    kt = kn;
  }
  store_rows(dq + qoff, dq_acc, q0, tq, rs, scale);
}

__global__ void __launch_bounds__(PNT, 1) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int H, int tq, int tk, int causal, float scale) {
  extern __shared__ float4 smem_dkv[];
  float* Khi = reinterpret_cast<float*>(smem_dkv);
  float* Klo = Khi + RES;
  float* Vhi = Klo + RES;
  float* Vlo = Vhi + RES;
  float* Qs = Vlo + RES;  // [2][TILE]: a stage's landed tile, its hi part
  float* Os = Qs + 2 * TILE;
  float* Qlo = Os + 2 * TILE;
  float* Olo = Qlo + TILE;
  float* rowv = Olo + TILE;  // [2][2][PT]: a stage's lse, then delta

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * PR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;
  const unsigned char* mrow = mask + (long)b * tk;

  // This warp's 64-key tile (warps 0-3 the block's first, 4-7 its second)
  // and whether it holds a real key; this thread's keys (rows g, g + 8).
  const int ktile0 = k0 + PT * (warp >> 2);
  const int key = ktile0 + lane;
  const bool tile_live =
      __any_sync(0xffffffffu, (key < tk && mrow[key]) ||
                                  (key + 32 < tk && mrow[key + 32]));
  const int kr = k0 + 16 * warp + g;
  const bool real[2] = {kr < tk && mrow[kr], kr + 8 < tk && mrow[kr + 8]};
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  if (!__syncthreads_or(tile_live)) {
    // No real key: P = dS = 0, so dk = dv = 0; nothing is loaded.
    store_rows(dk + koff, dk_acc, k0, tk, rs, 1.f);
    store_rows(dv + koff, dv_acc, k0, tk, rs, 1.f);
    return;
  }
  // Start the copies of query tile qt (Q, dO, lse, delta) into stage st.
  auto issue = [&](int qt, int st) {
    issue_tile(Qs + st * TILE, q + qoff, qt * PT, tq, rs);
    issue_tile(Os + st * TILE, dout + qoff, qt * PT, tq, rs);
    issue_rows<PNT>(rowv + 2 * PT * st, lse, delta, (long)bh * tq, qt * PT,
                    tq);
  };

  const int nq = (tq + PT - 1) / PT;
  // Causal: query tiles wholly before the block's first key see none of it.
  int qt = causal ? min(nq, k0 / PT) : 0;
  if (qt < nq) issue(qt, 0);
  cp_async_commit();
  // Resident for the whole walk, split once: K (S^T) and V (dP^T).
  load_resident(Khi, Klo, k + koff, k0, tk, rs, 1.f);
  load_resident(Vhi, Vlo, v + koff, k0, tk, rs, 1.f);
  for (int s = 0; qt < nq; ++s, ++qt) {
    const int st = s & 1;
    cp_async_wait_all();
    __syncthreads();  // stage st landed; stage st ^ 1 and the lo parts free
    if (qt + 1 < nq) issue(qt + 1, st ^ 1);  // overlaps this tile's products
    cp_async_commit();
    float* Qhi = Qs + st * TILE;
    float* Ohi = Os + st * TILE;
    split_tile(Qhi, Qlo, scale);  // scale Q: S and dK
    split_tile(Ohi, Olo, 1.f);
    __syncthreads();
    const int q0 = qt * PT;
    // A dead key tile, or (causal) a query tile wholly before it: skipped.
    if (tile_live && (!causal || q0 + PT - 1 >= ktile0)) {
      float s_acc[8][4], dp[8][4];
      zero(s_acc);
      zero(dp);
      mma_resident(s_acc, Khi, Klo, Qhi, Qlo);  // S^T = K (scale Q)^T
      mma_resident(dp, Vhi, Vlo, Ohi, Olo);     // dP^T = V dO^T
      const float* lse_s = rowv + 2 * PT * st;
      const float* delta_s = lse_s + PT;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = kr + 8 * (i >> 1);  // key
          const int c = 8 * j + 2 * t + (i & 1);  // query q0 + c
          const bool keep = real[i >> 1] && q0 + c < tq &&
                            (!causal || q0 + c >= r);
          const float p = keep ? expf(s_acc[j][i] - lse_s[c]) : 0.f;
          s_acc[j][i] = p;                             // P^T
          dp[j][i] = p * (dp[j][i] - delta_s[c]);      // dS^T
        }
      mma_registers(dv_acc, s_acc, Ohi, Olo);  // dV += P^T dO
      mma_registers(dk_acc, dp, Qhi, Qlo);     // dK += dS^T (scale Q)
    }
  }
  store_rows(dk + koff, dk_acc, k0, tk, rs, 1.f);
  store_rows(dv + koff, dv_acc, k0, tk, rs, 1.f);
}

// ---------------------------------------------------------------------------
// The bf16 two-pass backward pair: bf16 tiles, bf16 mma.sync (bf16_mma.cuh).
// ---------------------------------------------------------------------------

using bf16mma::BBLOCKS;
using bf16mma::BNC;
using bf16mma::BSTAGES;
using bf16mma::mma_bf16;
using bf16mma::mma_split;
constexpr int BRES = PR * D;  // bf16 elements of a resident tile

// Shared memory of flash_bwd_dq_kernel_bf16: Q and dO resident, K and V in
// the ring, a stage's key bits, and one bit a key tile of the walk.
size_t dq_smem_bf16(int tk) {
  const int nk = (tk + PT - 1) / PT;
  return sizeof(bf16) * (2 * BRES + 2 * BSTAGES * TILE)
         + sizeof(unsigned) * (2 * BSTAGES + (nk + 31) / 32);
}

// Shared memory of flash_bwd_dkv_kernel_bf16: K and V resident, Q and dO in
// the ring with a stage's lse and delta.
constexpr size_t dkv_smem_bf16() {
  return sizeof(bf16) * (2 * BRES + 2 * BSTAGES * TILE)
         + sizeof(float) * 2 * BSTAGES * PT;
}

// One block a (batch, head, 128 query rows), 8 warps of 16 rows, walking
// the live key tiles through a BSTAGES ring; Q and dO resident as bf16.
__global__ void __launch_bounds__(PNT, BBLOCKS) flash_bwd_dq_kernel_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int tq,
    int tk, int causal, float scale) {
  extern __shared__ float4 smem_dq16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_dq16);
  bf16* Os = Qs + BRES;
  bf16* ring = Os + BRES;  // [BSTAGES][K, V][TILE]
  unsigned* kbits = reinterpret_cast<unsigned*>(ring + 2 * BSTAGES * TILE);
  unsigned* live = kbits + 2 * BSTAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * PR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows of Qs and Os
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;
  const unsigned char* mrow = mask + (long)b * tk;
  int kend = (tk + PT - 1) / PT;
  // Causal: key tiles wholly above the block's last query row see nothing.
  if (causal) kend = min(kend, (q0 + PR - 1) / PT + 1);

  // Start the copies of key tile kt into stage st, its real keys into
  // kbits[st].
  auto issue = [&](int kt, int st) {
    bf16* ks = ring + 2 * st * TILE;
    issue_bf16<PT, PNT>(ks, k + koff, kt * PT, tk, rs);
    issue_bf16<PT, PNT>(ks + TILE, v + koff, kt * PT, tk, rs);
    vote_keys(kbits + 2 * st, mrow, kt, tk);
  };

  mark_live_tiles<PNT>(live, mrow, kend, tk);
  // Q and dO join the first copy group; then BSTAGES - 1 live key tiles
  // are in flight, a group each (empty past the last).
  issue_bf16<PR, PNT>(Qs, q + qoff, q0, tq, rs);
  issue_bf16<PR, PNT>(Os, dout + qoff, q0, tq, rs);
  int kt = next_live(live, 0, kend), ki = kt;
#pragma unroll
  for (int st = 0; st < BSTAGES - 1; ++st) {
    if (ki < kend) {
      issue(ki, st);
      ki = next_live(live, ki + 1, kend);
    }
    cp_async_commit();
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + r0 + g + 8 * half;
    lse_r[half] = r < tq ? lse[(long)bh * tq + r] : 0.f;
    delta_r[half] = r < tq ? delta[(long)bh * tq + r] : 0.f;
  }
  // This warp's 64-row query tile: past tq, it has nothing to compute.
  const int qtile0 = q0 + 64 * (warp >> 2);
  float dq_acc[8][4];
  zero(dq_acc);
  for (int s = 0; kt < kend; ++s) {
    const int st = s % BSTAGES;
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();  // tile s landed; the stage tile s - 1 used is free
    if (ki < kend) {  // overlaps this tile's products
      issue(ki, (s + BSTAGES - 1) % BSTAGES);
      ki = next_live(live, ki + 1, kend);
    }
    cp_async_commit();
    const bf16* Kt = ring + 2 * st * TILE;
    const bf16* Vt = Kt + TILE;
    const int k0 = kt * PT;
    // Causal: a query tile wholly before the key tile sees none of it.
    if (qtile0 < tq && (!causal || k0 <= qtile0 + PT - 1)) {
      const unsigned kb0 = kbits[2 * st], kb1 = kbits[2 * st + 1];
#pragma unroll
      for (int c0 = 0; c0 < PT; c0 += BNC) {  // keys k0 + c0 ..
        float s_acc[BNC / 8][4], dp[BNC / 8][4];
        zero(s_acc);
        zero(dp);
        mma_bf16<BNC>(s_acc, Qs, r0, Kt, c0);  // S / scale = Q K^T
        mma_bf16<BNC>(dp, Os, r0, Vt, c0);     // dP = dO V^T
#pragma unroll
        for (int j = 0; j < BNC / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = q0 + r0 + g + 8 * (i >> 1);
            const int c = c0 + 8 * j + 2 * t + (i & 1);
            const unsigned bits = c0 + 8 * j < 32 ? kb0 : kb1;
            const bool real = (bits >> (c & 31)) & 1u;
            const bool keep = r < tq && real && (!causal || r >= k0 + c);
            const float p =
                keep ? expf(s_acc[j][i] * scale - lse_r[i >> 1]) : 0.f;
            s_acc[j][i] = p * (dp[j][i] - delta_r[i >> 1]);  // dS
          }
        mma_split<BNC>(dq_acc, s_acc, Kt, c0);  // dq += dS K
      }
    }
    kt = next_live(live, kt + 1, kend);
  }
  cp_async_wait_all();  // a walk with no live tile leaves Q and dO in flight
  store_rows(dq + qoff, dq_acc, q0, tq, rs, scale);
}

// One block a (batch, head, 128 keys), 8 warps of 16 keys, walking the
// query tiles through a BSTAGES ring; K and V resident as bf16.
__global__ void __launch_bounds__(PNT, BBLOCKS) flash_bwd_dkv_kernel_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int tq, int tk, int causal, float scale) {
  extern __shared__ float4 smem_dkv16[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_dkv16);
  bf16* Vs = Ks + BRES;
  bf16* ring = Vs + BRES;  // [BSTAGES][Q, dO][TILE]
  // [BSTAGES][2][PT]: a stage's lse, then delta
  float* rowv = reinterpret_cast<float*>(ring + 2 * BSTAGES * TILE);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * PR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows of Ks and Vs
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;
  const unsigned char* mrow = mask + (long)b * tk;

  // This warp's 64-key tile (warps 0-3 the block's first, 4-7 its second)
  // and whether it holds a real key; this thread's keys (rows g, g + 8).
  const int ktile0 = k0 + PT * (warp >> 2);
  const int key = ktile0 + lane;
  const bool tile_live =
      __any_sync(0xffffffffu, (key < tk && mrow[key]) ||
                                  (key + 32 < tk && mrow[key + 32]));
  const int kr = k0 + r0 + g;
  const bool real[2] = {kr < tk && mrow[kr], kr + 8 < tk && mrow[kr + 8]};
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  if (!__syncthreads_or(tile_live)) {
    // No real key: P = dS = 0, so dk = dv = 0; nothing is loaded.
    store_rows(dk + koff, dk_acc, k0, tk, rs, 1.f);
    store_rows(dv + koff, dv_acc, k0, tk, rs, 1.f);
    return;
  }
  // Start the copies of query tile qt (Q, dO, lse, delta) into stage st.
  auto issue = [&](int qt, int st) {
    bf16* qs = ring + 2 * st * TILE;
    issue_bf16<PT, PNT>(qs, q + qoff, qt * PT, tq, rs);
    issue_bf16<PT, PNT>(qs + TILE, dout + qoff, qt * PT, tq, rs);
    issue_rows<PNT>(rowv + 2 * PT * st, lse, delta, (long)bh * tq, qt * PT,
                    tq);
  };

  const int nq = (tq + PT - 1) / PT;
  // Causal: query tiles wholly before the block's first key see none of it.
  int qt = causal ? min(nq, k0 / PT) : 0;
  // K and V join the first copy group; then BSTAGES - 1 query tiles.
  issue_bf16<PR, PNT>(Ks, k + koff, k0, tk, rs);
  issue_bf16<PR, PNT>(Vs, v + koff, k0, tk, rs);
#pragma unroll
  for (int st = 0; st < BSTAGES - 1; ++st) {
    if (qt + st < nq) issue(qt + st, st);
    cp_async_commit();
  }
  for (int s = 0; qt < nq; ++s, ++qt) {
    const int st = s % BSTAGES;
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();  // tile s landed; the stage tile s - 1 used is free
    if (qt + BSTAGES - 1 < nq)  // overlaps this tile's products
      issue(qt + BSTAGES - 1, (s + BSTAGES - 1) % BSTAGES);
    cp_async_commit();
    const bf16* Qt = ring + 2 * st * TILE;
    const bf16* Ot = Qt + TILE;
    const float* lse_s = rowv + 2 * PT * st;
    const float* delta_s = lse_s + PT;
    const int q0 = qt * PT;
    // A dead key tile, or (causal) a query tile wholly before it: skipped.
    if (tile_live && (!causal || q0 + PT - 1 >= ktile0)) {
#pragma unroll
      for (int c0 = 0; c0 < PT; c0 += BNC) {  // queries q0 + c0 ..
        float s_acc[BNC / 8][4], dp[BNC / 8][4];
        zero(s_acc);
        zero(dp);
        mma_bf16<BNC>(s_acc, Ks, r0, Qt, c0);  // S^T / scale = K Q^T
        mma_bf16<BNC>(dp, Vs, r0, Ot, c0);     // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < BNC / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = kr + 8 * (i >> 1);                  // key
            const int c = c0 + 8 * j + 2 * t + (i & 1);       // query q0 + c
            const bool keep = real[i >> 1] && q0 + c < tq &&
                              (!causal || q0 + c >= r);
            const float p =
                keep ? expf(s_acc[j][i] * scale - lse_s[c]) : 0.f;
            s_acc[j][i] = p;                         // P^T
            dp[j][i] = p * (dp[j][i] - delta_s[c]);  // dS^T
          }
        mma_split<BNC>(dv_acc, s_acc, Ot, c0);  // dV += P^T dO
        mma_split<BNC>(dk_acc, dp, Qt, c0);     // dK / scale += dS^T Q
      }
    }
  }
  cp_async_wait_all();  // a walk with no query tile leaves K and V in flight
  store_rows(dk + koff, dk_acc, k0, tk, rs, scale);
  store_rows(dv + koff, dv_acc, k0, tk, rs, 1.f);
}

// ---------------------------------------------------------------------------
// The bf16 forward: bf16 tiles, bf16 mma.sync (bf16_mma.cuh).
// ---------------------------------------------------------------------------

// The layout kept (the note at the head of this file has the others
// measured):
constexpr int FWD_WARPS = 8;   // warps a block, 16 query rows each
constexpr int FWD_BLOCKS = 2;  // blocks an SM (__launch_bounds__)
constexpr int FWD_NC = 64;     // a key tile's columns a warp takes at once
constexpr int FWD_STAGES = 3;  // the key tiles' ring
constexpr int FWD_NT = 32 * FWD_WARPS;
constexpr int FWD_ROWS = 16 * FWD_WARPS;

// Shared memory of flash_fwd_kernel_bf16: Q resident, K and V in the ring,
// a stage's key bits, and one bit a key tile of the walk.
size_t fwd_smem_bf16(int tk) {
  const int nk = (tk + PT - 1) / PT;
  return sizeof(bf16) * (FWD_ROWS * D + 2 * FWD_STAGES * TILE)
         + sizeof(unsigned) * (2 * FWD_STAGES + (nk + 31) / 32);
}

// One block a (batch, head, FWD_ROWS query rows), a warp a 16-row slice,
// walking the live key tiles through a FWD_STAGES ring; Q resident as bf16.
// A warp takes a tile FWD_NC keys at a time: S = Q K^T by one bf16
// mma.sync a product, scaled in f32 (scale is a power of two: exact); the
// online softmax on those registers; O += P V with P split three ways.
__global__ void __launch_bounds__(FWD_NT, FWD_BLOCKS) flash_fwd_kernel_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int tq, int tk,
    int causal, float scale) {
  extern __shared__ float4 smem_fwd16[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_fwd16);
  bf16* ring = Qs + FWD_ROWS * D;  // [FWD_STAGES][K, V][TILE]
  unsigned* kbits =
      reinterpret_cast<unsigned*>(ring + 2 * FWD_STAGES * TILE);
  unsigned* live = kbits + 2 * FWD_STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * FWD_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows of Qs
  const long rs = (long)H * D;
  const long qoff = ((long)b * tq * H + h) * D;
  const long koff = ((long)b * tk * H + h) * D;
  const unsigned char* mrow = mask + (long)b * tk;
  int kend = (tk + PT - 1) / PT;
  // Causal: key tiles wholly above the block's last query row see nothing.
  if (causal) kend = min(kend, (q0 + FWD_ROWS - 1) / PT + 1);
  // Start the copies of key tile kt into stage st, its real keys into
  // kbits[2 st ..].
  auto issue = [&](int kt, int st) {
    bf16* ks = ring + 2 * st * TILE;
    issue_bf16<PT, FWD_NT>(ks, k + koff, kt * PT, tk, rs);
    issue_bf16<PT, FWD_NT>(ks + TILE, v + koff, kt * PT, tk, rs);
    vote_keys(kbits + 2 * st, mrow, kt, tk);
  };

  mark_live_tiles<FWD_NT>(live, mrow, kend, tk);
  // Q joins the first copy group; then FWD_STAGES - 1 live key tiles are
  // in flight, a group each (empty past the last).
  issue_bf16<FWD_ROWS, FWD_NT>(Qs, q + qoff, q0, tq, rs);
  int kt = next_live(live, 0, kend), ki = kt;
#pragma unroll
  for (int st = 0; st < FWD_STAGES - 1; ++st) {
    if (ki < kend) {
      issue(ki, st);
      ki = next_live(live, ki + 1, kend);
    }
    cp_async_commit();
  }
  // Rows g and g + 8 of the warp: running max, sum, and the O accumulator.
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float o_acc[8][4];
  zero(o_acc);
  const int last = q0 + r0 + 15;  // this warp's last query row
  for (int s = 0; kt < kend; ++s) {
    const int st = s % FWD_STAGES;
    cp_async_wait<FWD_STAGES - 2>();
    __syncthreads();  // tile s landed; the stage tile s - 1 used is free
    if (ki < kend) {  // overlaps this tile's products
      issue(ki, (s + FWD_STAGES - 1) % FWD_STAGES);
      ki = next_live(live, ki + 1, kend);
    }
    cp_async_commit();
    const bf16* Kt = ring + 2 * st * TILE;
    const bf16* Vt = Kt + TILE;
    const int k0 = kt * PT;
    const unsigned kb0 = kbits[2 * st], kb1 = kbits[2 * st + 1];
#pragma unroll
    for (int c0 = 0; c0 < PT; c0 += FWD_NC) {  // keys k0 + c0 ..
      // Causal: keys past the warp's last row are masked for all of its
      // rows, which leaves m, l and O as they are: skipped.
      if (causal && k0 + c0 > last) break;
      float s_acc[FWD_NC / 8][4];
      zero(s_acc);
      mma_bf16<FWD_NC>(s_acc, Qs, r0, Kt, c0);  // S / scale = Q K^T
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < FWD_NC / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + r0 + g + 8 * (i >> 1);
          const int c = c0 + 8 * j + 2 * t + (i & 1);
          const unsigned bits = c0 + 8 * j < 32 ? kb0 : kb1;
          const bool real = (bits >> (c & 31)) & 1u;
          s_acc[j][i] = real && (!causal || r >= k0 + c)
                            ? s_acc[j][i] * scale : NEG_INF;
          mx[i >> 1] = fmaxf(mx[i >> 1], s_acc[j][i]);
        }
      float shift[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float m_new = fmaxf(m_r[half], quad_max(mx[half]));
        // Fully masked so far: pin the shift to 0 so the exps stay finite.
        shift[half] = m_new <= NEG_INF / 2 ? 0.f : m_new;
        corr[half] = expf((m_r[half] <= NEG_INF / 2 ? NEG_INF : m_r[half])
                          - shift[half]);
        m_r[half] = m_new;
      }
#pragma unroll
      for (int j = 0; j < FWD_NC / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sv = s_acc[j][i];
          const float p = sv <= NEG_INF / 2 ? 0.f : expf(sv - shift[i >> 1]);
          s_acc[j][i] = p;  // P, split three ways as the A operand of P V
          sum[i >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o_acc[j][i] *= corr[i >> 1];
#pragma unroll
      for (int half = 0; half < 2; ++half)
        l_r[half] = l_r[half] * corr[half] + quad_sum(sum[half]);
      mma_split<FWD_NC>(o_acc, s_acc, Vt, c0);  // O += P V
    }
    kt = next_live(live, kt + 1, kend);
  }
  cp_async_wait<0>();  // a walk with no live tile leaves Q in flight
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + r0 + g + 8 * half;
    if (r >= tq) continue;
    const float lc = fmaxf(l_r[half], 1e-30f);
    bf16* orow = o + qoff + (long)r * rs;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)  // rounded once to bf16 (RNE)
      store2(orow + 8 * j + 2 * t, o_acc[j][2 * half] / lc,
             o_acc[j][2 * half + 1] / lc);
    // lse = shift + log(l), as the f32 kernel's.
    if (t == 0)
      lse[(long)bh * tq + r] =
          (m_r[half] <= NEG_INF / 2 ? 0.f : m_r[half]) + logf(lc);
  }
}

// Opt the kernel into ``bytes`` of dynamic shared memory (above 48 KB
// needs it), then launch ``threads`` a block; returns the first CUDA error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t bytes,
           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

int fwd(const float* q, const float* k, const float* v,
        const unsigned char* mask, float* o, float* lse, int B, int H,
        int tq, int tk, int causal, float scale, cudaStream_t stream) {
  dim3 grid((tq + FR - 1) / FR, B * H);
  return launch(flash_fwd_kernel, grid, FNT, fwd_smem(tk), stream, q, k, v,
                mask, o, lse, H, tq, tk, causal, scale);
}

int fwd(const bf16* q, const bf16* k, const bf16* v,
        const unsigned char* mask, bf16* o, float* lse, int B, int H,
        int tq, int tk, int causal, float scale, cudaStream_t stream) {
  dim3 grid((tq + FWD_ROWS - 1) / FWD_ROWS, B * H);
  return launch(flash_fwd_kernel_bf16, grid, FWD_NT, fwd_smem_bf16(tk),
                stream, q, k, v, mask, o, lse, H, tq, tk, causal, scale);
}

int bwd_dq(const float* q, const float* k, const float* v,
           const unsigned char* mask, const float* dout, const float* lse,
           const float* delta, float* dq, int B, int H, int tq, int tk,
           int causal, float scale, cudaStream_t stream) {
  dim3 grid((tq + PR - 1) / PR, B * H);
  return launch(flash_bwd_dq_kernel, grid, PNT, dq_smem(tk), stream, q, k, v,
                mask, dout, lse, delta, dq, H, tq, tk, causal, scale);
}

int bwd_dq(const bf16* q, const bf16* k, const bf16* v,
           const unsigned char* mask, const bf16* dout, const float* lse,
           const float* delta, bf16* dq, int B, int H, int tq, int tk,
           int causal, float scale, cudaStream_t stream) {
  dim3 grid((tq + PR - 1) / PR, B * H);
  return launch(flash_bwd_dq_kernel_bf16, grid, PNT, dq_smem_bf16(tk), stream,
                q, k, v, mask, dout, lse, delta, dq, H, tq, tk, causal, scale);
}

int bwd_dkv(const float* q, const float* k, const float* v,
            const unsigned char* mask, const float* dout, const float* lse,
            const float* delta, float* dk, float* dv, int B, int H, int tq,
            int tk, int causal, float scale, cudaStream_t stream) {
  dim3 grid((tk + PR - 1) / PR, B * H);
  return launch(flash_bwd_dkv_kernel, grid, PNT, dkv_smem(), stream, q, k, v,
                mask, dout, lse, delta, dk, dv, H, tq, tk, causal, scale);
}

int bwd_dkv(const bf16* q, const bf16* k, const bf16* v,
            const unsigned char* mask, const bf16* dout, const float* lse,
            const float* delta, bf16* dk, bf16* dv, int B, int H, int tq,
            int tk, int causal, float scale, cudaStream_t stream) {
  dim3 grid((tk + PR - 1) / PR, B * H);
  return launch(flash_bwd_dkv_kernel_bf16, grid, PNT, dkv_smem_bf16(), stream,
                q, k, v, mask, dout, lse, delta, dk, dv, H, tq, tk, causal,
                scale);
}

}  // namespace flash

// ---------------------------------------------------------------------------
// Plain C interface (ctypes): each returns the launch's cudaError_t.
// q, o, dq: [B, Tq, H, D]; k, v, dk, dv: [B, Tk, H, D]; mask: [B, Tk]
// bytes; lse, delta: [B, H, Tq] f32; the rest f32 (the *_bf16_launch
// instances: bf16); all contiguous.
// ---------------------------------------------------------------------------

#define FLASH_ATTN_C_INTERFACE(SUFFIX, T)                                     \
  extern "C" int flash_fwd##SUFFIX##_launch(                                  \
      const T* q, const T* k, const T* v, const unsigned char* mask, T* o,    \
      float* lse, int B, int H, int tq, int tk, int causal, float scale,      \
      cudaStream_t stream) {                                                  \
    return flash::fwd(q, k, v, mask, o, lse, B, H, tq, tk, causal, scale,     \
                      stream);                                                \
  }                                                                           \
  extern "C" int flash_bwd_dq##SUFFIX##_launch(                               \
      const T* q, const T* k, const T* v, const unsigned char* mask,          \
      const T* dout, const float* lse, const float* delta, T* dq, int B,      \
      int H, int tq, int tk, int causal, float scale, cudaStream_t stream) {  \
    return flash::bwd_dq(q, k, v, mask, dout, lse, delta, dq, B, H, tq, tk, \
                         causal, scale, stream);                              \
  }                                                                           \
  extern "C" int flash_bwd_dkv##SUFFIX##_launch(                              \
      const T* q, const T* k, const T* v, const unsigned char* mask,          \
      const T* dout, const float* lse, const float* delta, T* dk, T* dv,      \
      int B, int H, int tq, int tk, int causal, float scale,                  \
      cudaStream_t stream) {                                                  \
    return flash::bwd_dkv(q, k, v, mask, dout, lse, delta, dk, dv, B, H, tq, \
                          tk, causal, scale, stream);                         \
  }

FLASH_ATTN_C_INTERFACE(, float)
FLASH_ATTN_C_INTERFACE(_bf16, __nv_bfloat16)
