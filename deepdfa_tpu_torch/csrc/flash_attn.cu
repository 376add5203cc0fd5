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
// in tf32_mma.cuh, which the fused backward shares. Plain PyTorch
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
// f32 operations (ops/attention.py:kernel_cost counts them on the call's
// mask; chip_smoke.py prints the bound beside the measured time), all
// run as 3xTF32 on the tensor cores: f32 work at a third of the H100 SXM
// data-sheet 495 TFLOP/s for a 700 W card.
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
// * Every product is 3xTF32 mma.sync (tf32_mma.cuh). Each operand is
//   split into hi and lo once: the resident one (scale Q, dO; K and V)
//   once a block, into the A-fragment order its warp reads with one
//   128-bit load a part; each streamed tile once a load, in place.
// * The streamed tiles (K and V; Q, dO, lse and delta) arrive by
//   cp.async: in the pair double buffered (the next tile's copies overlap
//   this one's split and products), in the forward single buffered with
//   two blocks an SM (one block's copies overlap the other's products).
//   Streamed tiles are XOR-swizzled by row (swz), so the B-fragment reads
//   of both orientations hit 32 banks.
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
// Forward block size: 64 query rows (4 warps), K and V single buffered,
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
// head, 128 keys) walking the query tiles. Both parts of everything take
// 225 KB of shared memory, one block an SM.
//
// The bf16 instances. A bf16 streamed tile lands by cp.async in a row-major
// bf16 staging buffer (two for the pair's two stages) and is widened and
// split from there into the same swizzled f32 hi and lo tiles the f32
// instance splits in place; the resident operands are widened as they load.
// Everything after is the f32 instance's code: the 3xTF32 products of
// widened values (exact splits, lo = 0) and of f32 P and dS, so a bf16
// instance gives bit for bit the f32 kernel's result on the widened inputs,
// rounded once to bf16 (RNE) as it is stored. Shared memory: the forward
// 112 KB (two blocks an SM), the pair 224 and 226 KB (the streamed hi and
// lo tiles single, their bf16 stages double). Their bound counts S and dP,
// products of two bf16 inputs, at the dense bf16 tensor-core rate (989
// TFLOP/s) and the rest at 3xTF32's (ops/attention.py:kernel_cost), so
// they run further from it than the f32 instances from theirs.

#include <cuda_runtime.h>
#include <type_traits>

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

using tf32x3::load4;
using tf32x3::mma3;
using tf32x3::split;
using tf32x3::store2;
using bf16 = __nv_bfloat16;

// True for the bf16 instances.
template <typename T>
constexpr bool kBf16 = std::is_same<T, bf16>::value;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows row0 .. row0 + ROWS - 1 of one (batch, head) slice (row_stride
// elements apart), widened to f32, times scale, split once into TF32 hi and
// lo parts, each stored in the order warp r / 16 reads them as mma A
// fragments: float4 (w * 8 + kc) * 32 + lane holds a0..a3 of contraction
// chunk kc. Rows at or past n_rows are zero. NTH threads share the work.
template <int ROWS = PR, int NTH = PNT, typename T>
__device__ void load_resident(float* hi, float* lo,
                              const T* __restrict__ src, int row0,
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

// The bf16 instance's copy: the rows into a row-major bf16 staging tile,
// 8 elements a copy.
template <int NTH = PNT>
__device__ __forceinline__ void issue_tile(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int row0, int n_rows,
                                           long row_stride) {
  for (int e = threadIdx.x; e < TILE / 8; e += NTH) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * D + c, src + (long)(in ? row0 + r : 0) * row_stride
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

// A landed tile split: an f32 one in place (hi is where it landed), a bf16
// one widened from its staging tile into hi and lo at the swizzled positions
// an f32 tile takes, so the hi and lo tiles are the f32 instance's on the
// widened values.
template <int NTH = PNT>
__device__ __forceinline__ void split_landed(const float* landed, float* hi,
                                             float* lo, float scale) {
  split_tile<NTH>(hi, lo, scale);
}

template <int NTH = PNT>
__device__ __forceinline__ void split_landed(const bf16* landed, float* hi,
                                             float* lo, float scale) {
  for (int e = threadIdx.x; e < TILE / 4; e += NTH) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    const float4 x = load4(landed + r * D + c);
    uint32_t h[4], l[4];
    split(x.x * scale, h[0], l[0]);
    split(x.y * scale, h[1], l[1]);
    split(x.z * scale, h[2], l[2]);
    split(x.w * scale, h[3], l[3]);
    *reinterpret_cast<float4*>(hi + swz(r, c)) =
        make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(lo + swz(r, c)) =
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

__device__ __forceinline__ void zero(float acc[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
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

// Start the copies of key tile kt (K into ks, V into vs; not waited for);
// warps 0 and 1 vote its real keys into kbits[0] and kbits[1].
template <int NTH, typename T>
__device__ __forceinline__ void issue_kv(T* ks, T* vs,
                                         unsigned* kbits,
                                         const T* __restrict__ kb,
                                         const T* __restrict__ vb,
                                         const unsigned char* __restrict__ mrow,
                                         int kt, int tk, long rs) {
  issue_tile<NTH>(ks, kb, kt * PT, tk, rs);
  issue_tile<NTH>(vs, vb, kt * PT, tk, rs);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int key = kt * PT + threadIdx.x;
    const unsigned vote = __ballot_sync(0xffffffffu, key < tk && mrow[key]);
    if ((threadIdx.x & 31) == 0) kbits[warp] = vote;
  }
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
// and V, their lo parts, (bf16) K and V's staging tiles, the tile's key
// bits, and one bit a key tile of the walk: 96 KB (bf16 112 KB), two
// blocks an SM.
template <typename T>
size_t fwd_smem(int tk) {
  const int nk = (tk + PT - 1) / PT;
  return sizeof(float) * (2 * FR * D + 4 * TILE)
         + (kBf16<T> ? sizeof(bf16) * 2 * TILE : 0)
         + sizeof(unsigned) * (2 + (nk + 31) / 32);
}

// One block a (batch, head, 64 query rows), 4 warps of 16 rows each,
// walking the live key tiles: a tile is split once it lands, multiplied,
// and only then is the next one's copy issued (the other block on the SM
// runs its products meanwhile).
template <typename T>
__global__ void __launch_bounds__(FNT, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const unsigned char* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int tq, int tk, int causal, float scale) {
  extern __shared__ float4 smem_fwd[];
  float* Qhi = reinterpret_cast<float*>(smem_fwd);
  float* Qlo = Qhi + FR * D;
  float* Khi = Qlo + FR * D;  // f32: the landed tile, its hi part once split
  float* Vhi = Khi + TILE;
  float* Klo = Vhi + TILE;
  float* Vlo = Klo + TILE;
  bf16* stage = reinterpret_cast<bf16*>(Vlo + TILE);  // bf16: K, V landed
  // Where a key tile's K and V land: in place (f32) or staged (bf16).
  T* Kland = reinterpret_cast<T*>(kBf16<T> ? (void*)stage : (void*)Khi);
  T* Vland = reinterpret_cast<T*>(kBf16<T> ? (void*)(stage + TILE)
                                           : (void*)Vhi);
  unsigned* kbits = reinterpret_cast<unsigned*>(
      kBf16<T> ? (void*)(stage + 2 * TILE) : (void*)(Vlo + TILE));  // [2]
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
    issue_kv<FNT>(Kland, Vland, kbits, k + koff, v + koff, mrow, kt, tk, rs);
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
    split_landed<FNT>(Kland, Khi, Klo, 1.f);
    split_landed<FNT>(Vland, Vhi, Vlo, 1.f);
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
    T* orow = o + qoff + (long)r * rs;
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

// f32 tiles a streamed operand of the pair takes for its hi parts: both
// stages in place (f32), or one widened from the stage that landed (bf16).
template <typename T>
constexpr int kHiStages = kBf16<T> ? 1 : 2;

// Shared memory of flash_bwd_dq_kernel: scale Q and dO split (4 resident
// parts), K and V in two stages (bf16: their hi parts once and two bf16
// stages), their lo parts, a stage's key bits, and one bit a key tile of
// the walk.
template <typename T>
size_t dq_smem(int tk) {
  const int nk = (tk + PT - 1) / PT;
  return sizeof(float) * (4 * RES + (2 * kHiStages<T> + 2) * TILE)
         + (kBf16<T> ? sizeof(bf16) * 4 * TILE : 0)
         + sizeof(unsigned) * (4 + (nk + 31) / 32);
}

// Shared memory of flash_bwd_dkv_kernel: K and V split (4 resident parts),
// Q and dO in two stages (bf16: as dq_smem), their lo parts, a stage's lse
// and delta.
template <typename T>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * RES + (2 * kHiStages<T> + 2) * TILE + 4 * PT)
         + (kBf16<T> ? sizeof(bf16) * 4 * TILE : 0);
}

template <typename T>
__global__ void __launch_bounds__(PNT, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const unsigned char* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int tq,
    int tk, int causal, float scale) {
  constexpr int HS = kHiStages<T>;
  extern __shared__ float4 smem_dq[];
  float* Qhi = reinterpret_cast<float*>(smem_dq);
  float* Qlo = Qhi + RES;
  float* Ohi = Qlo + RES;
  float* Olo = Ohi + RES;
  float* Ks = Olo + RES;  // [HS][TILE]: hi parts (f32: a stage's landed tile)
  float* Vs = Ks + HS * TILE;
  float* Klo = Vs + HS * TILE;
  float* Vlo = Klo + TILE;
  bf16* stage = reinterpret_cast<bf16*>(Vlo + TILE);  // bf16: [2][K, V]
  unsigned* kbits = reinterpret_cast<unsigned*>(
      kBf16<T> ? (void*)(stage + 4 * TILE) : (void*)(Vlo + TILE));  // [2][2]
  unsigned* live = kbits + 4;
  // Where stage st's K and V land.
  auto kland = [&](int st) {
    return reinterpret_cast<T*>(kBf16<T> ? (void*)(stage + 2 * st * TILE)
                                         : (void*)(Ks + st * TILE));
  };
  auto vland = [&](int st) {
    return reinterpret_cast<T*>(kBf16<T>
                                    ? (void*)(stage + (2 * st + 1) * TILE)
                                    : (void*)(Vs + st * TILE));
  };

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
    issue_kv<PNT>(kland(st), vland(st), kbits + 2 * st, k + koff, v + koff,
                  mrow, kt, tk, rs);
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
    float* Khi = Ks + (st % HS) * TILE;
    float* Vhi = Vs + (st % HS) * TILE;
    split_landed(kland(st), Khi, Klo, 1.f);
    split_landed(vland(st), Vhi, Vlo, 1.f);
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

template <typename T>
__global__ void __launch_bounds__(PNT, 1) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const unsigned char* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int H, int tq, int tk, int causal, float scale) {
  constexpr int HS = kHiStages<T>;
  extern __shared__ float4 smem_dkv[];
  float* Khi = reinterpret_cast<float*>(smem_dkv);
  float* Klo = Khi + RES;
  float* Vhi = Klo + RES;
  float* Vlo = Vhi + RES;
  float* Qs = Vlo + RES;  // [HS][TILE]: hi parts (f32: a stage's landed tile)
  float* Os = Qs + HS * TILE;
  float* Qlo = Os + HS * TILE;
  float* Olo = Qlo + TILE;
  float* rowv = Olo + TILE;  // [2][2][PT]: a stage's lse, then delta
  bf16* stage = reinterpret_cast<bf16*>(rowv + 4 * PT);  // bf16: [2][Q, dO]
  auto qland = [&](int st) {
    return reinterpret_cast<T*>(kBf16<T> ? (void*)(stage + 2 * st * TILE)
                                         : (void*)(Qs + st * TILE));
  };
  auto oland = [&](int st) {
    return reinterpret_cast<T*>(kBf16<T>
                                    ? (void*)(stage + (2 * st + 1) * TILE)
                                    : (void*)(Os + st * TILE));
  };

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
    issue_tile(qland(st), q + qoff, qt * PT, tq, rs);
    issue_tile(oland(st), dout + qoff, qt * PT, tq, rs);
    for (int i = tid; i < 2 * PT; i += PNT) {
      const int r = qt * PT + i % PT;
      const float* src = (i < PT ? lse : delta) + (long)bh * tq;
      cp_async4(rowv + 2 * PT * st + i, src + (r < tq ? r : 0), r < tq);
    }
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
    float* Qhi = Qs + (st % HS) * TILE;
    float* Ohi = Os + (st % HS) * TILE;
    split_landed(qland(st), Qhi, Qlo, scale);  // scale Q: S and dK
    split_landed(oland(st), Ohi, Olo, 1.f);
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

template <typename T>
int fwd(const T* q, const T* k, const T* v, const unsigned char* mask, T* o,
        float* lse, int B, int H, int tq, int tk, int causal, float scale,
        cudaStream_t stream) {
  dim3 grid((tq + FR - 1) / FR, B * H);
  return launch(flash_fwd_kernel<T>, grid, FNT, fwd_smem<T>(tk), stream, q, k,
                v, mask, o, lse, H, tq, tk, causal, scale);
}

template <typename T>
int bwd_dq(const T* q, const T* k, const T* v, const unsigned char* mask,
           const T* dout, const float* lse, const float* delta, T* dq, int B,
           int H, int tq, int tk, int causal, float scale,
           cudaStream_t stream) {
  dim3 grid((tq + PR - 1) / PR, B * H);
  return launch(flash_bwd_dq_kernel<T>, grid, PNT, dq_smem<T>(tk), stream, q,
                k, v, mask, dout, lse, delta, dq, H, tq, tk, causal, scale);
}

template <typename T>
int bwd_dkv(const T* q, const T* k, const T* v, const unsigned char* mask,
            const T* dout, const float* lse, const float* delta, T* dk, T* dv,
            int B, int H, int tq, int tk, int causal, float scale,
            cudaStream_t stream) {
  dim3 grid((tk + PR - 1) / PR, B * H);
  return launch(flash_bwd_dkv_kernel<T>, grid, PNT, dkv_smem<T>(), stream, q,
                k, v, mask, dout, lse, delta, dk, dv, H, tq, tk, causal,
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
    return flash::fwd<T>(q, k, v, mask, o, lse, B, H, tq, tk, causal, scale,  \
                         stream);                                             \
  }                                                                           \
  extern "C" int flash_bwd_dq##SUFFIX##_launch(                               \
      const T* q, const T* k, const T* v, const unsigned char* mask,          \
      const T* dout, const float* lse, const float* delta, T* dq, int B,      \
      int H, int tq, int tk, int causal, float scale, cudaStream_t stream) {  \
    return flash::bwd_dq<T>(q, k, v, mask, dout, lse, delta, dq, B, H, tq,    \
                            tk, causal, scale, stream);                       \
  }                                                                           \
  extern "C" int flash_bwd_dkv##SUFFIX##_launch(                              \
      const T* q, const T* k, const T* v, const unsigned char* mask,          \
      const T* dout, const float* lse, const float* delta, T* dk, T* dv,      \
      int B, int H, int tq, int tk, int causal, float scale,                  \
      cudaStream_t stream) {                                                  \
    return flash::bwd_dkv<T>(q, k, v, mask, dout, lse, delta, dk, dv, B, H,   \
                             tq, tk, causal, scale, stream);                  \
  }

FLASH_ATTN_C_INTERFACE(, float)
FLASH_ATTN_C_INTERFACE(_bf16, __nv_bfloat16)
