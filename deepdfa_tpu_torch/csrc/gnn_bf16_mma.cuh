// The bf16 gated step's dense products on Hopper's tensor cores: the
// device functions that the bf16 forward (fused_step_kernel_bf16,
// persistent_fwd_kernel_bf16 and its hist instance, fused_gnn.cu) and the
// bf16 backward (fused_step_bwd_kernel_bf16, persistent_bwd_kernel_bf16,
// fused_gnn_bwd.cu) all call, so that each output element keeps one
// chain in every kernel.
//
// Every product of the reference's bf16 step and its backward (_fwd_kernel
// and _bwd_kernel at dt = bfloat16, deepdfa_tpu/ops/fused_gnn.py:271,
// 405-476) multiplies two bf16 values and sums in f32: the messages h W_e,
// the gate's six sums x W_ir, h W_hr, x W_iz, h W_hz, x W_in, h W_hn
// (apart: each rounds before its bias), dx = bf16(dpre_i) W_i^T, dhl = dhc
// + bf16(dpre_h) W_h^T and dh = dhl + dmsg_c W_e^T. Each is one bf16
// mma.sync.m16n8k16 a 16-deep k-slice with f32 accumulation (bf16_mma.cuh:
// mma, ldsm4, ldsm4_t). With f32 band values the messages, dx and dmsg
// stay f32: dmsg_c W_e^T takes dmsg split three ways (split3, mma3,
// smallest part first), which gives the f32 product exactly as the flash
// kernels' split does.
//
// Layout. Rows sit in shared memory as tiles at a row stride of hp + 8
// elements (hp: H rounded up to 16; the k columns [H, hp) hold zeros, so
// padding k is exact): bf16 tiles for the A operands h and x, an f32 tile
// for the cotangent, dmsg, and the messages and dx at the message dtype.
// The row stride is 4 words mod 8 in bf16 (ldmatrix's 8 rows of 16 bytes
// hit 32 banks) and 8 mod 32 in f32 (a float2 fragment load hits 32
// banks a half-warp). The rounded dp, [rows, 4 hp] bf16 (r | z | n | hn
// blocks, each padded), is staged from device memory a pass at a time.
// The weights come as bf16 copies of the packed masters and their
// transposes ([K, N] row-major, made once a call by the wrapper), every
// product's B(k, n) = W[k][n]: a stage of the weight ring holds ks k rows
// of each of the product's column blocks ([ks, hp + 8] bf16, zeros past
// H and past each k block's H rows), read by ldmatrix.trans.
//
// Work. A warp takes an item: 16 rows by kNC output columns of every
// accumulator set (a set: one A operand against one column block; the
// gate holds six sets, so the six sums of an element sit in one thread
// for its epilogue). A pass gives the 8 warps their items over a chunk
// of row tiles and streams the k slabs through the ring once; a product
// takes as many passes as its row tiles need. Each accumulator starts at
// 0 and adds its 16-deep k-slices in ascending order, whichever warp,
// pass, ring stage or kernel holds it, and an mma.sync element depends
// only on its own row of A and column of B: so every element keeps one
// chain in every kernel, and a persistent sweep equals the per-step scan
// bit for bit.

#pragma once

#include <type_traits>

#include "bf16_mma.cuh"
#include "group_step.cuh"

namespace gnnmma {

using bf16mma::ldsm4;
using bf16mma::ldsm4_t;
using bf16mma::mma;
using bf16mma::pack;
using bf16mma::split3;

constexpr int kThreads = kGroupThreads;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNC = 32;      // output columns of a warp's item
constexpr int kKS = 16;      // the gate's k rows a stage (one k-slice)
constexpr int kGateSets = 6;  // the widest product's column blocks
// The backward's weight ring: one stage (a slab loads, then its products
// run), so that its sweep holds two blocks an SM, which hide each other's
// loads better than a second stage does (scripts/torch_gnn_bwd_bf16_layouts.py
// times both). A kernel may take another count: the products' template
// argument kS (the forward's is fused_gnn.cu's kFwdRingStages).
constexpr int kRingStages = 1;

// H rounded up to 16; the row stride of a row tile (elements, bf16 or
// f32) and of a weight stage's slab; of the dp tile (bf16).
__host__ __device__ inline int hp16(int H) { return (H + 15) & ~15; }
__host__ __device__ inline int tile_ld(int H) { return hp16(H) + 8; }
__host__ __device__ inline int dp_ld(int H) { return 4 * hp16(H) + 8; }
// Bytes of one stage of the weight ring: the gate's six [kKS, hp + 8]
// slabs; the narrower products fit more k rows in it.
__host__ __device__ inline int ring_stage_bytes(int H) {
  return kGateSets * kKS * tile_ld(H) * 2;
}
// Bytes of a ring of kS stages.
template <int kS = kRingStages>
__host__ __device__ inline int ring_bytes(int H) {
  return kS * ring_stage_bytes(H);
}
// Row tiles a pass covers: the warps over the items of one row tile.
__host__ __device__ inline int pass_tiles(int H) {
  return kWarps / ((hp16(H) + kNC - 1) / kNC);
}
// Rows of the dp tile: one pass's rows, at most the rows there are.
__host__ __device__ inline int dp_rows(int H, int rows) {
  const int r16 = (rows + 15) & ~15, p = 16 * pass_tiles(H);
  return r16 < p ? r16 : p;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   bf16mma::smem_addr(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

// One column block of a product's weights: B(k, n) = m[srow(k)][coff +
// n] of a row-major bf16 matrix with ncols columns, where k runs over
// the padded k space (blocks of hp, the first H rows of each real: srow
// = (k / hp) H + k % hp) and n over [0, H).
struct WBlock {
  const __nv_bfloat16* m;
  int ncols, coff;
};

// The weight ring: kS stages of sb bytes; slab s (k rows [s ks, s ks +
// ks)) in stage s mod kS. Slabs s + 1 .. s + kS - 1 are in flight while
// slab s is consumed (kS = 1: each slab loads, then is consumed); ends
// with a barrier, so every read of a stage is done.
template <int kS, typename Issue, typename Compute>
__device__ __forceinline__ void ring(int n_slabs, char* stages, int sb,
                                     Issue issue, Compute compute) {
#pragma unroll
  for (int p = 0; p < kS - 1; ++p) {
    if (p < n_slabs) issue(p, stages + p * sb);
    bf16mma::cp_async_commit();
  }
  for (int s = 0; s < n_slabs; ++s) {
    if constexpr (kS == 1) {
      issue(s, stages);
      bf16mma::cp_async_commit();
      bf16mma::cp_async_wait<0>();
    } else {
      bf16mma::cp_async_wait<kS - 2>();
    }
    __syncthreads();  // slab s landed; the stage of slab s - 1 is free
    if constexpr (kS > 1) {
      const int next = s + kS - 1;
      if (next < n_slabs) issue(next, stages + (next % kS) * sb);
      bf16mma::cp_async_commit();
    }
    compute(s, stages + (s % kS) * sb);
    if constexpr (kS == 1) __syncthreads();
  }
  __syncthreads();
}

// Calls f(r, i) for the pieces i in [0, per) of rows [0, R), the block's
// threads kThreads pieces apart, each thread's (r, i) advanced
// incrementally: no division a piece.
template <typename F>
__device__ __forceinline__ void for_pieces(int R, int per, F f) {
  const int step_r = kThreads / per, step_i = kThreads % per;
  int r = threadIdx.x / per, i = threadIdx.x % per;
  while (r < R) {
    f(r, i);
    r += step_r;
    i += step_i;
    while (i >= per) {
      i -= per;
      ++r;
    }
  }
}

// k rows [k0, k0 + kn) of NB column blocks into a stage: block b at
// [b ks, b ks + kn) rows of stride tile_ld(H), zeros where the padded k
// or the column has no weight. 16-byte pieces where H % 8 == 0 (bases
// 16-byte aligned), else 8-byte ones (for_pieces; k < 3 hp, so its k
// block is two compares).
template <int NB>
__device__ __forceinline__ void issue_w(char* stage, const WBlock (&w)[NB],
                                        int k0, int kn, int ks, int H) {
  const int hp = hp16(H), ld = tile_ld(H);
  const bool v16 = H % 8 == 0;
  const int pv = v16 ? 8 : 4;
  __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(stage);
  for_pieces(kn, hp / pv, [&](int kr, int ci) {
    const int c = ci * pv, k = k0 + kr;
    const int kb = (k >= hp) + (k >= 2 * hp), jj = k - kb * hp;
    const bool in = jj < H && c < H;
    const size_t srow = in ? static_cast<size_t>(kb * H + jj) : 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const __nv_bfloat16* src =
          w[b].m + (in ? srow * w[b].ncols + w[b].coff + c : 0);
      __nv_bfloat16* d = dst + (b * ks + kr) * ld + c;
      if (v16)
        bf16mma::cp_async16(d, src, in);
      else
        cp_async8(d, src, in);
    }
  });
}

// The A fragment of rows r0 .. r0 + 15, k columns k0 .. k0 + 15 of a bf16
// tile at stride ld (ldmatrix).
__device__ __forceinline__ void frag_a(uint32_t a[4], const __nv_bfloat16* t,
                                       int ld, int r0, int k0) {
  const int l = threadIdx.x & 31, m = l >> 3;
  ldsm4(a, t + (r0 + ((m & 1) << 3) + (l & 7)) * ld + k0 + ((m >> 1) << 3));
}

// B fragments of n-tiles n0 / 8 and n0 / 8 + 1 of k-slice rows kr ..
// kr + 15 of a [k, n] bf16 slab at stride ld (ldmatrix.trans): b[0..1]
// the first tile, b[2..3] the second.
__device__ __forceinline__ void frag_b(uint32_t b[4],
                                       const __nv_bfloat16* slab, int ld,
                                       int kr, int n0) {
  const int l = threadIdx.x & 31, m = l >> 3;
  ldsm4_t(b, slab + (kr + ((m & 1) << 3) + (l & 7)) * ld + n0 +
                 ((m >> 1) << 3));
}

// The A fragment of rows r0 .., k columns k0 .. of an f32 tile at stride
// ld (float2 loads): NP = 1, the values rounded to bf16 (exact where they
// are bf16 values); NP = 3, split three ways (a[i] part i).
template <int NP>
__device__ __forceinline__ void frag_a_f32(uint32_t (&a)[NP][4],
                                           const float* t, int ld, int r0,
                                           int k0) {
  const int l = threadIdx.x & 31, g = l >> 2, t4 = l & 3;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 v = *reinterpret_cast<const float2*>(
        t + (r0 + g + 8 * (u & 1)) * ld + k0 + 2 * t4 + 8 * (u >> 1));
    if constexpr (NP == 1)
      a[0][u] = pack(v.x, v.y);
    else
      split3(v.x, v.y, a[0][u], a[1][u], a[2][u]);
  }
}

// One product over rows [0, R): NA A operands, each against NB column
// blocks of its weights (w[a][b]), over a padded k space of kdim (a
// multiple of 16) in slabs of ks k rows (a multiple of 16; the stage
// holds NA NB of them), the weights through a ring of kS stages. Per
// pass: stage(t0, nt) readies the A operands of row tiles [t0, t0 + nt);
// each warp's item, row tile t0 + lt, takes
// load_a(a, t0, lt, k0, frag) for each A operand's k-slice (NP parts,
// frag[p] part p, the largest first; the mma's take the smallest first)
// into its NA NB sets of kNC / 8 n-tiles, then calls epi(row, col, v) for
// each of its rows below R and even columns col below H, v[set][0..1] the
// set's sums at (row, col) and (row, col + 1), and after a barrier
// post(t0, nt) (the ring's stages are free then; post ends with a barrier
// if it does anything). Ends with a barrier.
struct NoPost {
  __device__ void operator()(int, int) const {}
};

template <int NA, int NB, int NP, int kS = kRingStages, typename Stage,
          typename LoadA, typename Epi, typename Post = NoPost>
__device__ __forceinline__ void product(int R, int H, int kdim, int ks,
                                        const WBlock (&w)[NA][NB],
                                        char* stages, Stage stage,
                                        LoadA load_a, Epi epi,
                                        Post post = Post()) {
  constexpr int NS = NA * NB, NT = kNC / 8;
  const int hp = hp16(H), ld = tile_ld(H);
  const int cc_n = (hp + kNC - 1) / kNC, pt = kWarps / cc_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = (R + 15) / 16, sb = ring_stage_bytes(H);
  WBlock flat[NS];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) flat[a * NB + b] = w[a][b];
  for (int t0 = 0; t0 < mt; t0 += pt) {
    const int nt = min(pt, mt - t0);
    stage(t0, nt);
    const int lt = warp / cc_n, cc = warp % cc_n;
    const bool active = lt < nt;
    const int c0 = cc * kNC;
    float acc[NS][NT][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[s][j][i] = 0.f;
    ring<kS>(
        (kdim + ks - 1) / ks, stages, sb,
        [&](int s, char* st) {
          issue_w<NS>(st, flat, s * ks, min(ks, kdim - s * ks), ks, H);
        },
        [&](int s, const char* st) {
          if (!active) return;
          const __nv_bfloat16* slab =
              reinterpret_cast<const __nv_bfloat16*>(st);
          const int kn = min(ks, kdim - s * ks);
          for (int kr = 0; kr < kn; kr += 16) {
            uint32_t af[NA][NP][4];
#pragma unroll
            for (int a = 0; a < NA; ++a)
              load_a(a, t0, lt, s * ks + kr, af[a]);
#pragma unroll
            for (int jp = 0; jp < NT / 2; ++jp) {
              const int n0 = c0 + 16 * jp;
              if (n0 >= hp) continue;
#pragma unroll
              for (int a = 0; a < NA; ++a)
#pragma unroll
                for (int b = 0; b < NB; ++b) {
                  uint32_t bf[4];
                  frag_b(bf, slab + (a * NB + b) * ks * ld, ld, kr, n0);
#pragma unroll
                  for (int p = NP - 1; p >= 0; --p) {
                    mma(acc[a * NB + b][2 * jp], af[a][p], bf[0], bf[1]);
                    mma(acc[a * NB + b][2 * jp + 1], af[a][p], bf[2],
                        bf[3]);
                  }
                }
            }
          }
        });
    if (active) {
      const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = 16 * (t0 + lt) + g + 8 * hf;
          const int col = c0 + 8 * j + 2 * t4;
          if (row < R && col < H) {
            float v[NS][2];
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              v[s][0] = acc[s][j][2 * hf];
              v[s][1] = acc[s][j][2 * hf + 1];
            }
            epi(row, col, v);
          }
        }
    }
    __syncthreads();
    post(t0, nt);
  }
}

// k rows a stage holds for a product of ns column blocks.
__device__ __forceinline__ int stage_k_rows(int H, int ns) {
  return (ring_stage_bytes(H) / (ns * tile_ld(H) * 2)) & ~15;
}

// The messages of rows [0, R): m = h W_e (hb: h as a bf16 tile), then
// epi(row, col, m[0..1]) with m = edge_msg_bf16(sum, b_e, round_msg).
template <int kS = kRingStages, typename Epi>
__device__ __forceinline__ void messages(int R, int H,
                                         const __nv_bfloat16* hb,
                                         const __nv_bfloat16* ek,
                                         const float* __restrict__ eb,
                                         bool round_msg, char* stages,
                                         Epi epi) {
  const WBlock w[1][1] = {{{ek, H, 0}}};
  const int ld = tile_ld(H);
  product<1, 1, 1, kS>(
      R, H, hp16(H), stage_k_rows(H, 1), w, stages, [](int, int) {},
      [&](int, int t0, int lt, int k0, uint32_t(&f)[1][4]) {
        frag_a(f[0], hb, ld, 16 * (t0 + lt), k0);
      },
      [&](int row, int col, const float(&v)[1][2]) {
        float m[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          m[e] = edge_msg_bf16(v[0][e], __ldg(eb + col + e), round_msg);
        epi(row, col, m);
      });
}

// The gate's six sums of rows [0, R) from the bf16 tiles xb (x) and hb
// (h): ir, iz, in = x W_i[:, r|z|n], hr, hz, hn = h W_h[:, r|z|n], each
// apart; then epi(row, col, v) with v[0..5] = ir, iz, in, hr, hz, hn, two
// columns each, and post(t0, nt) after each pass (product's). wi and wh
// have rows of wld columns (0: their own 3H).
template <int kS = kRingStages, typename Epi, typename Post = NoPost>
__device__ __forceinline__ void gate_sums(int R, int H,
                                          const __nv_bfloat16* xb,
                                          const __nv_bfloat16* hb,
                                          const __nv_bfloat16* wi,
                                          const __nv_bfloat16* wh,
                                          char* stages, Epi epi,
                                          Post post = Post(), int wld = 0) {
  const int n = wld > 0 ? wld : 3 * H;
  const WBlock w[2][3] = {{{wi, n, 0}, {wi, n, H}, {wi, n, 2 * H}},
                          {{wh, n, 0}, {wh, n, H}, {wh, n, 2 * H}}};
  const int ld = tile_ld(H);
  product<2, 3, 1, kS>(
      R, H, hp16(H), kKS, w, stages, [](int, int) {},
      [&](int a, int t0, int lt, int k0, uint32_t(&f)[1][4]) {
        frag_a(f[0], a == 0 ? xb : hb, ld, 16 * (t0 + lt), k0);
      },
      epi, post);
}

// dx = bf16(dpre_i) W_i^T and the recurrent product bf16(dpre_h) W_h^T of
// rows [0, R), contracted over the padded 3 hp: dp (device memory, [R,
// 4H] f32 from row 0, written by this block) is staged a pass at a time,
// rounded to bf16, into dpb (dp_rows(H, R) rows at dp_ld(H)); dpre_i's k
// blocks are dp's r, z, n, dpre_h's r, z, hn (wiT, whT: [3H, H]). Then
// epi(row, col, v) with v[0] the dx sums, v[1] the recurrent ones.
template <typename Epi>
__device__ __forceinline__ void gate_bwd_products(
    int R, int H, const float* dp, __nv_bfloat16* dpb,
    const __nv_bfloat16* wiT, const __nv_bfloat16* whT, char* stages,
    Epi epi) {
  const WBlock w[2][1] = {{{wiT, H, 0}}, {{whT, H, 0}}};
  const int hp = hp16(H), ldp = dp_ld(H);
  product<2, 1, 1>(
      R, H, 3 * hp, stage_k_rows(H, 2), w, stages,
      [&](int t0, int nt) {
        // Rows 16 t0 .. of dp, rounded, each block padded to hp (zeros).
        const int r0 = 16 * t0, rows = min(R - r0, 16 * nt), q = hp / 4;
        for_pieces(rows, 4 * q, [&](int r, int i) {
          const int b = (i >= q) + (i >= 2 * q) + (i >= 3 * q);
          const int c = 4 * (i - b * q);
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (c < H)
            v = *reinterpret_cast<const float4*>(
                dp + static_cast<size_t>(r0 + r) * 4 * H + b * H + c);
          uint2 u;
          u.x = pack(v.x, v.y);
          u.y = pack(v.z, v.w);
          *reinterpret_cast<uint2*>(dpb + r * ldp + b * hp + c) = u;
        });
        __syncthreads();
      },
      [&](int a, int, int lt, int k0, uint32_t(&f)[1][4]) {
        // The dp rows of the pass; dpre_h's third block is dp's fourth (hn).
        const int col = (a == 1 && k0 >= 2 * hp) ? k0 + hp : k0;
        frag_a(f[0], dpb, ldp, 16 * lt, col);
      },
      epi);
}

// dmsg_c W_e^T of rows [0, R) from the f32 tile dm (dmsg, zeros past H):
// dmsg_c is dmsg rounded to bf16 (NP = 1: bf16 messages) or dmsg split
// three ways (NP = 3: f32 messages). epi(row, col, v[0][0..1]).
template <int NP, typename Epi>
__device__ __forceinline__ void dmsg_times_ekT(int R, int H, const float* dm,
                                               const __nv_bfloat16* ekT,
                                               char* stages, Epi epi) {
  const WBlock w[1][1] = {{{ekT, H, 0}}};
  const int ld = tile_ld(H);
  product<1, 1, NP>(
      R, H, hp16(H), stage_k_rows(H, 1), w, stages, [](int, int) {},
      [&](int, int t0, int lt, int k0, uint32_t(&f)[NP][4]) {
        frag_a_f32<NP>(f, dm, ld, 16 * (t0 + lt), k0);
      },
      epi);
}

// Rows [0, R) of a [.., H] row-major bf16 array into a bf16 tile at
// stride tile_ld(H), zeros in the columns [H, hp) (4 values a piece).
__device__ __forceinline__ void tile_in(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int R,
                                        int H) {
  const int ld = tile_ld(H);
  for_pieces(R, hp16(H) / 4, [&](int r, int i) {
    const int c = 4 * i;
    uint2 u = make_uint2(0u, 0u);
    if (c < H)
      u = *reinterpret_cast<const uint2*>(src + static_cast<size_t>(r) * H +
                                          c);
    *reinterpret_cast<uint2*>(dst + r * ld + c) = u;
  });
}

// The same from an f32 array (no padding: the aggregates read columns
// below H only), and from a bf16 array into an f32 tile (widened).
__device__ __forceinline__ void tile_in(float* dst, const float* src, int R,
                                        int H) {
  const int ld = tile_ld(H);
  for_pieces(R, H / 4, [&](int r, int i) {
    *reinterpret_cast<float4*>(dst + r * ld + 4 * i) =
        *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * H +
                                         4 * i);
  });
}

__device__ __forceinline__ void tile_in(float* dst, const __nv_bfloat16* src,
                                        int R, int H) {
  const int ld = tile_ld(H);
  for_pieces(R, H / 4, [&](int r, int i) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        src + static_cast<size_t>(r) * H + 4 * i);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * i) =
        make_float4(bf16mma::low(u.x), bf16mma::high(u.x), bf16mma::low(u.y),
                    bf16mma::high(u.y));
  });
}

// Zeros in columns [H, hp) of rows [0, R) of a tile (bf16 or f32).
template <typename T>
__device__ __forceinline__ void zero_pad(T* t, int R, int H) {
  const int pad = hp16(H) - H, ld = tile_ld(H);
  if (pad > 0)
    for_pieces(R, pad, [&](int r, int i) {
      t[r * ld + H + i] = static_cast<T>(0.f);
    });
}

// Two values at p, of the tile's or array's type (bf16: rounded).
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [0, R) of a tile (stride tile_ld(H)) into a [.., H] row-major
// array of the same type, two values a piece.
template <typename T>
__device__ __forceinline__ void tile_out(T* dst, const T* src, int R,
                                         int H) {
  using Pair = typename std::conditional<sizeof(T) == 2, uint32_t,
                                         float2>::type;
  const int ld = tile_ld(H);
  for_pieces(R, H / 2, [&](int r, int i) {
    *reinterpret_cast<Pair*>(dst + static_cast<size_t>(r) * H + 2 * i) =
        *reinterpret_cast<const Pair*>(src + r * ld + 2 * i);
  });
}

}  // namespace gnnmma
