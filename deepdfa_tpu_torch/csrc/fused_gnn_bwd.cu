// Gated graph step backward kernels for Hopper (sm_90a): the VJP of
// h' = GRU(A @ (h W_e + b_e), h) with packed r|z|n gate weights, as the
// forward in fused_gnn.cu computes it.
//
// fused_step_bwd_kernel    replaces deepdfa_tpu/ops/fused_gnn.py:_bwd_kernel
//                          (launched from _run_bwd): one step's backward,
//                          in two passes (gate, then the A^T pass).
// persistent_bwd_kernel    replaces deepdfa_tpu/ops/fused_gnn.py:
//                          _persist_bwd_kernel (launched from
//                          _run_persistent_bwd): the reverse sweep over
//                          steps K-1..0 in one launch, the inter-step
//                          cotangent resident on chip.
// fused_step_bwd_kernel_bf16, persistent_bwd_kernel_bf16 (__global__s
//                          of their own) replace _bwd_kernel and
//                          _persist_bwd_kernel at dt = bfloat16, their
//                          products on the bf16 tensor cores
//                          (gnn_bf16_mma.cuh; see their section below).
// step_weight_grad_kernel  the weight-gradient reduction that both TPU
//                          kernels fold into their bodies
//                          (_bwd_kernel's dwi/dwh/dek accumulators,
//                          _persist_bwd_kernel's per-step partials and
//                          their fold): a fixed-order contraction over
//                          every row of every step.
//
// Plain PyTorch versions: fused_step_backward_reference,
// persistent_backward_reference and step_weight_grad_reference in
// deepdfa_tpu_torch/ops/fused_gnn.py. Built by ops/_build.py like
// fused_gnn.cu; the device functions shared with the forward are in
// gated_step.cuh and group_step.cuh, the bf16 instances' products in
// gnn_bf16_mma.cuh.
//
// The math (per row; g is the output cotangent; x the edge message
// aggregate A (h W_e + b_e), recomputed as the forward computes it):
//   dz = g (h - n), dn = g (1 - z), dhc = g z, dpre_n = dn (1 - n^2),
//   dpre_r = dpre_n pre_hn r (1 - r), dpre_z = dz z (1 - z),
//   dpre_hn = dpre_n r;  dpre_i = [r|z|n], dpre_h = [r|z|hn]
//   dx = dpre_i W_i^T,  dhl = dhc + dpre_h W_h^T
//   dmsg = A^T dx,      dh = dhl + dmsg W_e^T
//   dW_i = x^T dpre_i, dW_h = h^T dpre_h, dW_e = h^T dmsg, biases: column
//   sums of dpre_i, dpre_h, dmsg.
// As in the TPU kernel, nothing but (h, the weights, the band) is saved
// from the forward: the gates are recomputed here.
//
// What bounds them. At the training batch (N = 16384 rows, H = 128, 5
// steps) one step's backward is ~7.5 GFLOP of dense f32 work (the
// recomputed forward and four [N, H] x [H, 3H]-sized products) and the
// weight gradients another ~3.8 GFLOP a step, against some 100 MB of
// traffic a step: bound by f32 operations. The step kernels run them as
// f32 FMAs on the CUDA cores (67 TFLOP/s); the weight pass as 3xTF32 on
// the tensor cores (tf32_mma.cuh: f32 work at a third of 495 TFLOP/s;
// single-pass TF32 is out, as the reference holds f32 to
// Precision.HIGHEST), where its 294 MB of cotangents in (5 steps) come
// close to bounding it too (0.088 ms at 3.35 TB/s against 0.114 ms).
// ops/fused_gnn.py:kernel_cost counts each kernel's operations and bytes
// on the run's inputs; chip_smoke.py prints the bound beside the time.
//
// Design.
// * Weight gradients are a reduction over every row. The TPU accumulated
//   them in one sequential grid; Hopper blocks run in no order, and
//   atomics would make the gradients change from run to run. So the
//   gate kernels write their per-row cotangents (x [N, H], dp = dpre_r |
//   dpre_z | dpre_n | dpre_hn [N, 4H], dmsg [N, H]: 24 H bytes a row a
//   step) and step_weight_grad_kernel contracts them in two passes. Pass
//   1: each block owns one 128 x 128 tile of one gradient (all of its H
//   rows for H <= 128: x and h are read once a tile of R), one step (the
//   step is on the grid, so the steps run side by side) and one split of
//   the rows, and writes the split's sum for that step; the blocks of the
//   first row tile also sum their bias columns. Splits are sized from the
//   row count and width alone so that one step's tiles fill the 132 SMs
//   (ops/fused_gnn.py:wgrad_rows_per_split: 19 splits of 864 rows, 133
//   blocks a step at N = 16384, H = 128). Slabs of 32 rows arrive by
//   cp.async, double buffered, are split into TF32 hi and lo once, in
//   place, and are contracted as 3xTF32 mma.sync, each warp's 32 x 64
//   piece accumulated in registers in row order; a slab row is 136 floats
//   apart, so both fragment reads (4 rows x 8 columns) hit 32 banks. 102
//   KB of shared memory and 128 registers (ptxas: 64 B of spill) give two
//   blocks an SM. Pass 2 adds, for
//   every entry, the splits in order into each step's sum and the steps
//   from K-1 down to 0 (the scan VJP's association). One owner an entry
//   in each pass, no atomics, and an order that depends only on the row
//   count: the gradients are deterministic and a K-step call equals the
//   fold of K one-step calls bit for bit; with it the persistent backward
//   equals the scan of fused_step_bwd_kernel.
// * A^T rows come from the block-band form of A^T
//   (ops/band_spmm.py:band_transpose_vals), read by the forward's own
//   warp-per-row aggregate.
// * The per-step backward needs dx of neighbouring rows for A^T, which
//   other blocks compute, so it runs as two passes (instances of one
//   kernel): pass 0 (the recompute, the gate backward; x, dp, dx and dhl
//   to device memory), pass 1 (dmsg = A^T dx, dh = dhl + dmsg W_e^T). A
//   block owns a fixed tile of 32 rows (16 at the serving bucket, to fill
//   the SMs; ops/fused_gnn.py:step_plan), no gate, and runs
//   persistent_bwd_kernel's register-tiled products over it: the
//   recompute, the dx/dh pair over [w_i^T | w_h^T] slabs, dmsg W_e^T, and
//   the same staged aggregate as the forward (fused_gnn.cu). dp is read
//   back from device memory within pass 0, as the persistent kernel does
//   (the weight pass reads it anyway).
// * Persistent: one block per closed row group (no edge leaves it, so
//   A^T does not either). The block keeps the group's cotangent dh, h (then
//   dx) and the aggregate (then x, then dmsg) in shared memory, three row
//   arrays, from step K-1 down to 0; h comes from the recompute sweep's
//   hist (persistent_fwd_hist_kernel) or h_0, and dp goes through device
//   memory (the weight pass reads it anyway). Bound by f32 operations
//   (0.57 ms for 5 steps at the training batch); the simple kernel of the
//   first port ran at 11 % of it, slower than its own plain version: six
//   weight matrices (~900 KB) re-read from L2 for every 16-row chunk. This
//   one runs the forward's register-tiled, slab-streamed products
//   (group_step.cuh) for the recompute, the dx/dh pair (j over 3H against
//   [w_i^T | w_h^T] slabs) and dmsg W_e^T, with two blocks an SM (113,088
//   bytes for groups of 48 rows; ops/fused_gnn.py:persistent_bwd_smem_ok
//   gates it against 227 KB, and a batch over the gate runs
//   fused_step_bwd_kernel K times instead). Each element keeps
//   fused_step_bwd_kernel's FMA chain: the sweep equals its scan bit for
//   bit.

#include <stdint.h>

#include <algorithm>

#include "gnn_bf16_mma.cuh"
#include "group_step.cuh"
#include "tf32_mma.cuh"

namespace {

// One step's backward over a fixed tile of row_tile rows a block, in two
// passes (kPass). Pass 0: recompute x (written out), the gate cotangents
// dp (written out, then read back by this block for) dx and dhl. Shared
// memory: kStages weight-slab stages of kGR k rows, then [row_tile, ld]
// arrays d_s (g, then dhc, then dhl), h_s (h, then dx) and a_s (the
// aggregate, then x), then the row sums. Pass 1: dmsg = A^T dx over the
// tile's rows (dx of the tile from x_s, the halo's from device memory;
// written out) and dh = dhl + dmsg W_e^T. Shared memory: the stages, x_s
// (dx) and a_s (dmsg), then the row sums. Each element keeps
// persistent_bwd_kernel's chains.
template <typename VT, int kPass, int kGR>
__global__ void __launch_bounds__(kGroupThreads, 2)
    fused_step_bwd_kernel(const float* __restrict__ h,
                          const VT* __restrict__ vals,
                          const VT* __restrict__ tvals,
                          const float* __restrict__ g,
                          const float* __restrict__ ek,
                          const float* __restrict__ eb,
                          const float* __restrict__ wi,
                          const float* __restrict__ bi,
                          const float* __restrict__ wh,
                          const float* __restrict__ bh,
                          const float* __restrict__ wiT,
                          const float* __restrict__ whT,
                          const float* __restrict__ ekT, float* x_out,
                          float* dp, float* dx, float* dhl,
                          float* dmsg_out, float* dh_out, int n_rows, int H,
                          int tile, int n_tiles, int bw, int row_tile) {
  extern __shared__ __align__(16) float smem[];
  const Tile t(H, 0, 1);
  const int r0 = blockIdx.x * row_tile;
  const int R = min(row_tile, n_rows - r0), ld = t.ld;
  const size_t off = static_cast<size_t>(r0) * H;
  float* stages = smem;                                     // [kStages][stage]
  float* rows = stages + kStages * group_stage_floats<kGR>(H);
  if constexpr (kPass == 0) {
    float* d_s = rows;                  // [R, ld] g, dhc, dhl
    float* h_s = d_s + row_tile * ld;   // [R, ld] h, then dx
    float* a_s = h_s + row_tile * ld;   // [R, ld] agg, then x
    float* rs_s = a_s + row_tile * ld;  // [R] row sums
    rows_to_shared(h_s, ld, h + off, R, H);
    rows_to_shared(d_s, ld, g + off, R, H);
    __syncthreads();
    tile_aggregate(vals, tile, n_tiles, bw, h, h_s, r0, R, ld, H, a_s, rs_s,
                   stages, kStages * group_stage_floats<kGR>(H));
    group_rows_times<false, kGR>(t, a_s, R, ek, stages,
                                 [&](int r, const float* acc) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a_s[r * ld + t.c0 + j] =
            edge_out(acc[j], rs_s[r], __ldg(eb + t.c0 + j));
    });
    rows_to_global(x_out + off, a_s, ld, R, H);
    float* dp_t = dp + 4 * off;
    group_gate<false, kGR>(t, a_s, h_s, R, wi, wh, stages,
               [&](int r, const float* pr, const float* pz, const float* gn,
                   const float* hn) {
                 float d[4][4];
#pragma unroll
                 for (int j = 0; j < 4; ++j) {
                   const int e = r * ld + t.c0 + j;
                   const GateGrads gg = gate_bwd_out(
                       pr[j], pz[j], gn[j], hn[j],
                       gate_bias(bi, bh, H, t.c0 + j), h_s[e], d_s[e]);
                   d[0][j] = gg.dr;
                   d[1][j] = gg.dz;
                   d[2][j] = gg.dn;
                   d[3][j] = gg.dhn;
                   d_s[e] = gg.dhc;
                 }
                 float* dprow = dp_t + static_cast<size_t>(r) * 4 * H;
#pragma unroll
                 for (int b = 0; b < 4; ++b)
                   *reinterpret_cast<float4*>(dprow + b * H + t.c0) =
                       make_float4(d[b][0], d[b][1], d[b][2], d[b][3]);
               });
    // dp (device memory) of every row of the tile is visible to the block.
    group_gate_bwd_b<kGR>(t, dp_t, R, wiT, whT, stages, h_s, d_s);
    rows_to_global(dx + off, h_s, ld, R, H);
    rows_to_global(dhl + off, d_s, ld, R, H);
  } else {
    float* x_s = rows;                  // [R, ld] dx of the tile
    float* a_s = x_s + row_tile * ld;   // [R, ld] dmsg
    float* rs_s = a_s + row_tile * ld;  // [R] row sums (unused)
    rows_to_shared(x_s, ld, dx + off, R, H);
    __syncthreads();
    tile_aggregate(tvals, tile, n_tiles, bw, dx, x_s, r0, R, ld, H, a_s,
                   rs_s, stages, kStages * group_stage_floats<kGR>(H));
    rows_to_global(dmsg_out + off, a_s, ld, R, H);
    const float* dhl_t = dhl + off;
    float* dh_t = dh_out + off;
    group_rows_times<false, kGR>(t, a_s, R, ekT, stages,
                                 [&](int r, const float* acc) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = dhl_t[r * H + t.c0 + j] + acc[j];
      *reinterpret_cast<float4*>(dh_t + r * H + t.c0) =
          make_float4(v[0], v[1], v[2], v[3]);
    });
  }
}

// The reverse sweep, one block a row group. Shared memory: kStages weight-slab
// stages, then dh_s (the resident cotangent), h_s (the step's input h,
// then dx: h is dead once the gate's cotangents are out) and a_s (the
// aggregate, then x, then dmsg), [max_rows, ld] each, then the row sums.
template <typename VT>
__global__ void __launch_bounds__(kGroupThreads, 2)
    persistent_bwd_kernel(const float* __restrict__ h0,
                          const float* __restrict__ hist,
                          const VT* __restrict__ vals,
                          const VT* __restrict__ tvals,
                          const float* __restrict__ g,
                          const float* __restrict__ ek,
                          const float* __restrict__ eb,
                          const float* __restrict__ wi,
                          const float* __restrict__ bi,
                          const float* __restrict__ wh,
                          const float* __restrict__ bh,
                          const float* __restrict__ wiT,
                          const float* __restrict__ whT,
                          const float* __restrict__ ekT,
                          const int* __restrict__ groups, float* xbuf,
                          float* dpbuf, float* dmsgbuf, float* dh_out,
                          int n_rows, int H, int tile, int n_tiles, int bw,
                          int n_steps, int max_rows) {
  extern __shared__ __align__(16) float smem[];
  const Tile t(H, 0, 1);
  const int g0 = groups[blockIdx.x], g1 = groups[blockIdx.x + 1];
  const int R = g1 - g0, ld = t.ld;
  if (R == 0) return;  // an empty (padded) group owns no rows
  float* stages = smem;                              // [kStages][stage]
  float* dh_s = stages + kStages * group_stage_floats(H);  // [R, ld] cotangent
  float* h_s = dh_s + max_rows * ld;                 // [R, ld] h, then dx
  float* a_s = h_s + max_rows * ld;                  // [R, ld] agg, x, dmsg
  float* rs_s = a_s + max_rows * ld;                 // [R] row sums
  const size_t goff = static_cast<size_t>(g0) * H;
  const size_t plane = static_cast<size_t>(n_rows) * H;
  rows_to_shared(dh_s, ld, g + goff, R, H);
  for (int s = n_steps - 1; s >= 0; --s) {
    const float* src = s == 0 ? h0 : hist + (s - 1) * plane;
    rows_to_shared(h_s, ld, src + goff, R, H);
    __syncthreads();
    group_aggregate(vals, tile, n_tiles, bw, h_s, ld, g0, g1, H, a_s, rs_s);
    __syncthreads();
    group_rows_times(t, a_s, R, ek, stages, [&](int r, const float* acc) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a_s[r * ld + t.c0 + j] =
            edge_out(acc[j], rs_s[r], __ldg(eb + t.c0 + j));
    });
    rows_to_global(xbuf + s * plane + goff, a_s, ld, R, H);
    float* dp_step = dpbuf + 4 * (s * plane + goff);
    group_gate(t, a_s, h_s, R, wi, wh, stages,
               [&](int r, const float* pr, const float* pz, const float* gn,
                   const float* hn) {
                 float d[4][4];
#pragma unroll
                 for (int j = 0; j < 4; ++j) {
                   const int e = r * ld + t.c0 + j;
                   const GateGrads gg = gate_bwd_out(
                       pr[j], pz[j], gn[j], hn[j],
                       gate_bias(bi, bh, H, t.c0 + j), h_s[e], dh_s[e]);
                   d[0][j] = gg.dr;
                   d[1][j] = gg.dz;
                   d[2][j] = gg.dn;
                   d[3][j] = gg.dhn;
                   dh_s[e] = gg.dhc;
                 }
                 float* dprow = dp_step + static_cast<size_t>(r) * 4 * H;
#pragma unroll
                 for (int b = 0; b < 4; ++b)
                   *reinterpret_cast<float4*>(dprow + b * H + t.c0) =
                       make_float4(d[b][0], d[b][1], d[b][2], d[b][3]);
               });
    // dp (device memory) of every row is visible to the block.
    group_gate_bwd_b(t, dp_step, R, wiT, whT, stages, h_s, dh_s);
    group_aggregate(tvals, tile, n_tiles, bw, h_s, ld, g0, g1, H, a_s, rs_s);
    __syncthreads();
    rows_to_global(dmsgbuf + s * plane + goff, a_s, ld, R, H);
    group_rows_times(t, a_s, R, ekT, stages, [&](int r, const float* acc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = r * ld + t.c0 + j;
        dh_s[e] = dh_s[e] + acc[j];
      }
    });
  }
  rows_to_global(dh_out + goff, dh_s, ld, R, H);
}

constexpr int kWTile = 128;     // output tile edge: all of H by 128 columns
constexpr int kWSlab = 32;      // rows a slab (the contraction's step)
constexpr int kWLd = kWTile + 8;  // row stride of a slab in shared memory
constexpr int kWThreads = 256;  // 8 warps, each a 32 x 64 piece of the tile
// Shared memory: L and R slabs in two stages, their lo parts, and half of
// the bias sums.
constexpr size_t kWSmem =
    sizeof(float) * (6 * kWSlab * kWLd + kWTile);

// Pass 1: one 128 x 128 tile of one weight gradient (every row a of it
// when H <= 128) for one step s = blockIdx.z over one split of the rows
// (rows_per_split, a multiple of kWSlab, from split blockIdx.y on):
// partial[split][s][out] = sum over the split's rows of L_s[r, a] R_s[r, b].
// Products: 0 dW_i (L = x, R = dpre_i), 1 dW_h (L = h, R = dpre_h), 2 dW_e
// (L = h, R = dmsg); blocks with a0 == 0 also sum their R columns (the
// bias gradients). Slabs of 32 rows stream in by cp.async, double buffered, and
// are split into TF32 hi and lo parts once, in place; the contraction over
// rows is 3xTF32 mma.sync (A = L^T read transposed from the row-major slab,
// B = R), each warp's 32 x 64 piece accumulated in registers in slab order.
// vec: every row of L and R starts 16-byte aligned (H % 4 == 0), so the
// slabs copy in 16-byte pieces.
__global__ void __launch_bounds__(kWThreads, 2)
    step_weight_grad_kernel(const float* __restrict__ h0,
                            const float* __restrict__ hist,
                            const float* __restrict__ xbuf,
                            const float* __restrict__ dpbuf,
                            const float* __restrict__ dmsgbuf,
                            float* __restrict__ partial, int n_rows, int H,
                            int n_steps, int rows_per_split, int vec) {
  extern __shared__ __align__(16) float wsmem[];
  float* Ls = wsmem;                      // [2][kWSlab * kWLd]
  float* Rs = Ls + 2 * kWSlab * kWLd;     // [2][kWSlab * kWLd]
  float* Llo = Rs + 2 * kWSlab * kWLd;    // [kWSlab * kWLd]
  float* Rlo = Llo + kWSlab * kWLd;       // [kWSlab * kWLd]
  float* bias_s = Rlo + kWSlab * kWLd;    // [kWTile]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_a = (H + kWTile - 1) / kWTile;
  const int tiles_g = tiles_a * ((3 * H + kWTile - 1) / kWTile);
  int tile = blockIdx.x, prod;
  if (tile < tiles_g) {
    prod = 0;
  } else if (tile < 2 * tiles_g) {
    prod = 1;
    tile -= tiles_g;
  } else {
    prod = 2;
    tile -= 2 * tiles_g;
  }
  const int s = blockIdx.z;
  const int width = prod == 2 ? H : 3 * H;
  const int a0 = (tile % tiles_a) * kWTile, b0 = (tile / tiles_a) * kWTile;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  const size_t plane = static_cast<size_t>(n_rows) * H;
  const float* hs = s == 0 ? h0 : hist + (s - 1) * plane;
  const float* L = prod == 0 ? xbuf + s * plane : hs;
  const float* Rm = prod == 2 ? dmsgbuf + s * plane : dpbuf + 4 * s * plane;
  const int rstride = prod == 2 ? H : 4 * H;
  // dpre_h's n block (prod 1) is dpre_hn, stored H columns on.
  auto rcol = [&](int b) { return (prod == 1 && b >= 2 * H) ? b + H : b; };

  // Slab i (rows r_begin + 32 i ..) into stage st, zeros past r_end, H or
  // width; not waited for.
  auto issue = [&](int i, int st) {
    const int r0 = r_begin + i * kWSlab;
    float* ld = Ls + st * kWSlab * kWLd;
    float* rd = Rs + st * kWSlab * kWLd;
    if (vec) {
      for (int e = tid; e < kWSlab * kWTile / 4; e += kWThreads) {
        const int rr = e / (kWTile / 4), c = (e % (kWTile / 4)) * 4;
        const size_t row = static_cast<size_t>(r0 + rr);
        const bool in_r = r0 + rr < r_end;
        const bool in_l = in_r && a0 + c < H, in_b = in_r && b0 + c < width;
        cp_async16(ld + rr * kWLd + c, in_l ? L + row * H + a0 + c : L, in_l);
        cp_async16(rd + rr * kWLd + c,
                   in_b ? Rm + row * rstride + rcol(b0 + c) : Rm, in_b);
      }
    } else {
      for (int e = tid; e < kWSlab * kWTile; e += kWThreads) {
        const int rr = e / kWTile, c = e % kWTile;
        const size_t row = static_cast<size_t>(r0 + rr);
        const bool in_r = r0 + rr < r_end;
        const bool in_l = in_r && a0 + c < H, in_b = in_r && b0 + c < width;
        cp_async4(ld + rr * kWLd + c, in_l ? L + row * H + a0 + c : L, in_l);
        cp_async4(rd + rr * kWLd + c,
                  in_b ? Rm + row * rstride + rcol(b0 + c) : Rm, in_b);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;
  // This thread's bias column (c = tid % 128) over its rows of each slab
  // (tid / 128, then every other).
  const int bc = tid & (kWTile - 1), brow = tid >> 7;
  float bias = 0.f;
  const int wa = (warp >> 1) * 32, wb = (warp & 1) * 64;
  const int n_slabs = (r_end - r_begin + kWSlab - 1) / kWSlab;
  if (n_slabs > 0) issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < n_slabs; ++i) {
    const int st = i & 1;
    cp_async_wait_all();
    __syncthreads();  // slab i landed; stage st ^ 1 and the lo parts free
    if (i + 1 < n_slabs) issue(i + 1, st ^ 1);  // overlaps this slab's work
    cp_async_commit();
    float* lh = Ls + st * kWSlab * kWLd;
    float* rh = Rs + st * kWSlab * kWLd;
    for (int rr = brow; rr < kWSlab; rr += 2) {
      const int e = rr * kWLd + bc;
      uint32_t hi, lo;
      tf32x3::split(lh[e], hi, lo);
      lh[e] = __uint_as_float(hi);
      Llo[e] = __uint_as_float(lo);
      const float rv = rh[e];
      bias += rv;
      tf32x3::split(rv, hi, lo);
      rh[e] = __uint_as_float(hi);
      Rlo[e] = __uint_as_float(lo);
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kWSlab / 8; ++kc) {
      // A(m, k) = L[8 kc + k][wa + 16 mi + m]: a0 (g, t), a1 (g + 8, t),
      // a2 (g, t + 4), a3 (g + 8, t + 4).
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = (8 * kc + t4 + 4 * (u >> 1)) * kWLd + wa + 16 * mi
                        + g + 8 * (u & 1);
          ahi[mi][u] = __float_as_uint(lh[e]);
          alo[mi][u] = __float_as_uint(Llo[e]);
        }
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        // B(k, n) = R[8 kc + k][wb + 8 nj + n]: b0 (t, g), b1 (t + 4, g).
        uint32_t bhi[2], blo[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = (8 * kc + t4 + 4 * u) * kWLd + wb + 8 * nj + g;
          bhi[u] = __float_as_uint(rh[e]);
          blo[u] = __float_as_uint(Rlo[e]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          tf32x3::mma3(acc[mi][nj], ahi[mi], alo[mi], bhi, blo);
      }
    }
  }
  const size_t n_out = 7 * static_cast<size_t>(H) * H + 7 * H;
  const size_t w_off = static_cast<size_t>(prod) * 3 * H * H;
  const size_t b_off = 7 * static_cast<size_t>(H) * H + prod * 3 * H;
  float* out = partial + (static_cast<size_t>(blockIdx.y) * n_steps + s) * n_out;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int a = a0 + wa + 16 * mi + g + 8 * (i >> 1);
        const int b = b0 + wb + 8 * nj + 2 * t4 + (i & 1);
        if (a < H && b < width)
          out[w_off + static_cast<size_t>(a) * width + b] = acc[mi][nj][i];
      }
  // The bias: the even rows' sum plus the odd rows'.
  if (brow == 1) bias_s[bc] = bias;
  __syncthreads();
  if (a0 == 0 && brow == 0 && b0 + bc < width)
    out[b_off + b0 + bc] = bias + bias_s[bc];
}

// Pass 2: each gradient entry = its per-step sums (splits added in
// order) added from step K-1 down to 0, the scan VJP's order. Output
// order: dW_i, dW_h, dW_e, then db_i, db_h, db_e.
__global__ void step_weight_grad_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dek,
    float* __restrict__ deb, float* __restrict__ dwi,
    float* __restrict__ dbi, float* __restrict__ dwh,
    float* __restrict__ dbh, int H, int n_steps, int n_splits) {
  const size_t n_out = 7 * static_cast<size_t>(H) * H + 7 * H;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  float total = 0.f;
  for (int s = n_steps - 1; s >= 0; --s) {
    float step = 0.f;
    for (int sp = 0; sp < n_splits; ++sp)
      step += partial[(static_cast<size_t>(sp) * n_steps + s) * n_out + idx];
    total += step;
  }
  const size_t g = 3 * static_cast<size_t>(H) * H, e = 7 * static_cast<size_t>(H) * H;
  if (idx < g) dwi[idx] = total;
  else if (idx < 2 * g) dwh[idx - g] = total;
  else if (idx < e) dek[idx - 2 * g] = total;
  else if (idx < e + 3 * H) dbi[idx - e] = total;
  else if (idx < e + 6 * H) dbh[idx - e - 3 * H] = total;
  else deb[idx - e - 6 * H] = total;
}

// Dynamic shared memory of fused_step_bwd_kernel's pass for tiles of
// row_tile rows (ops/fused_gnn.py:step_smem_bytes mirrors it).
size_t step_bwd_smem(int pass, int row_tile, int hidden, int slab_rows) {
  return sizeof(float) *
         (kStages * static_cast<size_t>(slab_rows) * 6 * group_hp(hidden) +
          (pass == 0 ? 3 : 2) * static_cast<size_t>(row_tile) *
              group_ld(hidden) +
          row_tile);
}

// The backward's cut of n_rows rows on a card of sms SMs
// (ops/fused_gnn.py:step_plan mirrors it): 32-row tiles (two blocks an SM
// with pass 0's three row arrays), 16 where those are fewer than sms
// blocks; gate slabs of 4 k rows. No clusters.
struct StepPlan {
  int row_tile, slab_rows, blocks;
};

StepPlan step_bwd_plan(int n_rows, int sms) {
  const int rt = (n_rows + 31) / 32 < sms ? 16 : 32;
  return {rt, kGateRows, (n_rows + rt - 1) / rt};
}

template <int kPass, typename VT>
int launch_bwd_pass(const void* h, const void* vals, const void* tvals,
                    const void* g, const void* ek, const void* eb,
                    const void* wi, const void* bi, const void* wh,
                    const void* bh, const void* wiT, const void* whT,
                    const void* ekT, void* x, void* dp, void* dx, void* dhl,
                    void* dmsg, void* dh, int n_rows, int hidden, int tile,
                    int n_tiles, int bw, const StepPlan& p, cudaStream_t st) {
  constexpr int kGR = kGateRows;
  const size_t smem = step_bwd_smem(kPass, p.row_tile, hidden, kGR);
  cudaError_t e = cudaFuncSetAttribute(
      fused_step_bwd_kernel<VT, kPass, kGR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_step_bwd_kernel<VT, kPass, kGR><<<p.blocks, kGroupThreads, smem,
                                          st>>>(
      static_cast<const float*>(h), static_cast<const VT*>(vals),
      static_cast<const VT*>(tvals), static_cast<const float*>(g),
      static_cast<const float*>(ek), static_cast<const float*>(eb),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<const float*>(wiT), static_cast<const float*>(whT),
      static_cast<const float*>(ekT), static_cast<float*>(x),
      static_cast<float*>(dp), static_cast<float*>(dx),
      static_cast<float*>(dhl), static_cast<float*>(dmsg),
      static_cast<float*>(dh), n_rows, hidden, tile, n_tiles, bw,
      p.row_tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT>
int launch_fused_bwd(const void* h, const void* vals, const void* tvals,
                     const void* g, const void* ek, const void* eb,
                     const void* wi, const void* bi, const void* wh,
                     const void* bh, const void* wiT, const void* whT,
                     const void* ekT, void* x, void* dp, void* dx, void* dhl,
                     void* dmsg, void* dh, int n_rows, int hidden, int tile,
                     int n_tiles, int bw, cudaStream_t st) {
  const StepPlan p = step_bwd_plan(n_rows, device_sms());
  const int e = launch_bwd_pass<0, VT>(h, vals, tvals, g, ek, eb, wi, bi, wh,
                                       bh, wiT, whT, ekT, x, dp, dx, dhl,
                                       dmsg, dh, n_rows, hidden, tile,
                                       n_tiles, bw, p, st);
  if (e != 0) return e;
  return launch_bwd_pass<1, VT>(h, vals, tvals, g, ek, eb, wi, bi, wh, bh,
                                wiT, whT, ekT, x, dp, dx, dhl, dmsg, dh,
                                n_rows, hidden, tile, n_tiles, bw, p, st);
}

template <int kPass, typename VT>
int bwd_pass_occupancy(const StepPlan& p, int hidden, int* blocks) {
  constexpr int kGR = kGateRows;
  const size_t smem = step_bwd_smem(kPass, p.row_tile, hidden, kGR);
  cudaError_t e = cudaFuncSetAttribute(
      fused_step_bwd_kernel<VT, kPass, kGR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_step_bwd_kernel<VT, kPass, kGR>, kGroupThreads, smem);
  return static_cast<int>(e);
}

// Dynamic shared memory of persistent_bwd_kernel for groups of up to
// max_rows rows (ops/fused_gnn.py:persistent_bwd_smem_bytes mirrors it).
size_t persistent_bwd_smem(int max_rows, int hidden) {
  return sizeof(float) *
         (kStages * static_cast<size_t>(group_stage_floats(hidden)) +
          3 * static_cast<size_t>(max_rows) * group_ld(hidden) + max_rows);
}

template <typename VT>
int launch_persistent_bwd(const void* h0, const void* hist, const void* vals,
                          const void* tvals, const void* g, const void* ek,
                          const void* eb, const void* wi, const void* bi,
                          const void* wh, const void* bh, const void* wiT,
                          const void* whT, const void* ekT,
                          const void* groups, int n_groups,
                          int max_group_rows, int n_steps, void* x, void* dp,
                          void* dmsg, void* dh, int hidden, int tile,
                          int n_tiles, int bw, cudaStream_t st) {
  const size_t smem = persistent_bwd_smem(max_group_rows, hidden);
  cudaError_t e = cudaFuncSetAttribute(
      persistent_bwd_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  persistent_bwd_kernel<VT><<<n_groups, kGroupThreads, smem, st>>>(
      static_cast<const float*>(h0), static_cast<const float*>(hist),
      static_cast<const VT*>(vals), static_cast<const VT*>(tvals),
      static_cast<const float*>(g), static_cast<const float*>(ek),
      static_cast<const float*>(eb), static_cast<const float*>(wi),
      static_cast<const float*>(bi), static_cast<const float*>(wh),
      static_cast<const float*>(bh), static_cast<const float*>(wiT),
      static_cast<const float*>(whT), static_cast<const float*>(ekT),
      static_cast<const int*>(groups), static_cast<float*>(x),
      static_cast<float*>(dp), static_cast<float*>(dmsg),
      static_cast<float*>(dh), n_tiles * tile, hidden, tile, n_tiles, bw,
      n_steps, max_group_rows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The bf16 instances: FlowGNN(dtype="bfloat16") training
// ---------------------------------------------------------------------------
//
// fused_step_bwd_kernel_bf16    replaces _bwd_kernel at dt = bfloat16 (the
//                               same Pallas kernel, generic over the
//                               dtype; its bf16 body, fused_gnn.py:
//                               405-476), down to the per-row cotangents.
// persistent_bwd_kernel_bf16    replaces _persist_bwd_kernel at dt =
//                               bfloat16: the reverse sweep.
// step_weight_grad_kernel_bf16  their weight-gradient accumulation at bf16.
//
// The reference rounds inside the step at bf16 (each message before the
// aggregate, x, each gate product before its bias, dpre before its
// products, dx and dmsg at the message dtype), and every one of its dense
// products multiplies two bf16 values and sums in f32. Both kernels run
// those products on the bf16 tensor cores through the device functions
// of gnn_bf16_mma.cuh (one bf16 mma.sync a 16-deep k-slice, f32 sums;
// with f32 band values dmsg's product with W_e^T takes dmsg split three
// ways), on the weights as bf16 copies (the wrapper rounds the f32
// masters once a call) and on bf16 row tiles; the epilogues are the f32
// gate code's bf16 twins (gated_step.cuh: edge_msg_bf16,
// gate_bwd_out_bf16: f32 cotangents from the gates, dp written out f32
// and unrounded). What bounds them: the bytes of the rows, dp and dmsg
// (0.025 ms a step at the training batch; ops/fused_gnn.py:kernel_cost),
// the products being 7.5 GFLOP a step at 989 TFLOP/s. What holds them
// above it (scripts/torch_gnn_bwd_bf16_layouts.py --ablations): the band
// aggregates (a warp a row), the gate's epilogue and the rows' traffic
// (dp out and back) more than the products, and each weight slab's load
// (one stage: a slab crosses L2 once a pass of up to 32 rows).
//
// fused_step_bwd_kernel_bf16 runs three passes over fixed row tiles
// (step_bwd_plan), one launch count, since a tile's halo needs other
// blocks' messages and dx: pass 0 writes every row's message at the
// message dtype (bf16 band values: bf16; f32: f32); pass 1 stages the
// tile's h, g and messages, aggregates the messages (the halo's from
// device memory) and rounds x (written out, bf16), runs the gate's six
// sums and its backward (dp out, dhc kept), then dx and the recurrent
// product with dp staged back rounded to bf16, and writes dx at the
// message dtype and dhl (f32); pass 2 aggregates A^T dx (dmsg written out
// unrounded) and ends with dh = round_bf16(dhl + dmsg_c W_e^T).
// persistent_bwd_kernel_bf16 does the three passes' work for one closed
// row group a block, steps K-1 down to 0 in one launch: no edge leaves a
// group, so the messages, dx and dhl stay in shared memory. Each element
// keeps one chain in both (the same device functions in the same k order;
// group_aggregate sums a row's senders as tile_aggregate does), so the
// sweep equals the scan of the per-step kernel bit for bit.
//
// The weight pass (step_weight_grad_kernel_bf16, its section below) runs
// its products on the bf16 tensor cores too, on the f32 pass's grid and
// fold (its own splits, from the row count and width alone): a K-step
// call equals the fold of K one-step calls bit for bit.

// Blocks an SM of the per-step passes and of the sweep (__launch_bounds__:
// at most 128 registers a thread). With one weight stage (kRingStages)
// the sweep fits two blocks an SM at the training batch's 48-row groups;
// scripts/torch_gnn_bwd_bf16_layouts.py times the other layouts.
constexpr int kStepBf16Blocks = 2;
constexpr int kPersistBf16Blocks = 2;

// Pointers and sizes of one bf16 backward step: the weights bf16 ([K, N]
// row-major: ek, wi, wh and their transposes ekT, wiT, whT), the biases
// f32 arrays of bf16 values; msg and dx scratch at the message dtype.
struct BwdBf16Args {
  const __nv_bfloat16* h;
  const void* vals;
  const void* tvals;
  const __nv_bfloat16* g;
  const __nv_bfloat16 *ek, *wi, *wh, *ekT, *wiT, *whT;
  const float *eb, *bi, *bh;
  void* msg;
  __nv_bfloat16* x;
  float* dp;
  void* dx;
  float *dhl, *dmsg;
  __nv_bfloat16* dh;
  int n_rows, H, tile, n_tiles, bw, row_tile;
};

// Bytes of the weight ring (gnnmma::kRingStages stages).
using gnnmma::ring_bytes;

// The gate's epilogue on one element pair (row r, columns c, c + 1) of
// the six sums v: dp's four blocks out (f32, unrounded, at dp_row), the
// carry cotangent dhc into cot (the tile's f32 cotangent, g on entry);
// hb: the step's h.
__device__ __forceinline__ void gate_epilogue(
    const float (&v)[6][2], int r, int c, int H, const float* bi,
    const float* bh, const __nv_bfloat16* hb, float* cot, float* dp_row) {
  const int ld = gnnmma::tile_ld(H);
  float d[4][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = r * ld + c + e;
    const GateGrads gg = gate_bwd_out_bf16(
        v[0][e], v[3][e], v[1][e], v[4][e], v[2][e], v[5][e],
        gate_bias_bf16(bi, bh, H, c + e), __bfloat162float(hb[i]), cot[i]);
    d[0][e] = gg.dr;
    d[1][e] = gg.dz;
    d[2][e] = gg.dn;
    d[3][e] = gg.dhn;
    cot[i] = gg.dhc;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    *reinterpret_cast<float2*>(dp_row + b * H + c) =
        make_float2(d[b][0], d[b][1]);
}

// Dynamic shared memory of fused_step_bwd_kernel_bf16's pass for tiles of
// row_tile rows (a multiple of 16; ops/fused_gnn.py:step_smem_bytes
// mirrors it): the ring, then pass 0: h; pass 1: the cotangent (f32),
// then h, x and the messages (sized f32) or, once the gate is done, the
// dp rows, then the row sums; pass 2: dx (sized f32), dmsg, the row sums.
size_t step_bwd_bf16_smem(int pass, int row_tile, int hidden) {
  const size_t ld = gnnmma::tile_ld(hidden), rows = row_tile * ld;
  size_t b = ring_bytes(hidden);
  if (pass == 0) return b + 2 * rows;
  if (pass == 2) return b + 8 * rows + 4 * row_tile;
  const size_t dp = static_cast<size_t>(gnnmma::dp_rows(hidden, row_tile)) *
                    gnnmma::dp_ld(hidden) * 2;
  return b + 4 * rows + std::max(8 * rows, dp) + 4 * row_tile;
}

template <typename VT, int kPass>
__global__ void __launch_bounds__(kGroupThreads, kStepBf16Blocks)
    fused_step_bwd_kernel_bf16(const BwdBf16Args a) {
  using namespace gnnmma;
  using MT = VT;  // the messages and dx at the message dtype (the band's)
  constexpr bool kRoundMsg = sizeof(VT) == 2;
  extern __shared__ __align__(16) char bsmem[];
  const int H = a.H, ld = tile_ld(H), rt = a.row_tile;
  const int r0 = blockIdx.x * rt, R = min(rt, a.n_rows - r0);
  const size_t off = static_cast<size_t>(r0) * H;
  char* stages = bsmem;
  char* rows = bsmem + ring_bytes(H);
  float* buf = reinterpret_cast<float*>(stages);  // the aggregate's staging
  const int buf_floats = ring_bytes(H) / 4;
  if constexpr (kPass == 0) {
    __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(rows);
    tile_in(hb, a.h + off, R, H);
    __syncthreads();
    MT* msg = static_cast<MT*>(a.msg) + off;
    messages(R, H, hb, a.ek, a.eb, kRoundMsg, stages,
             [&](int r, int c, const float(&m)[2]) {
               put2(msg + r * H + c, m[0], m[1]);
             });
  } else if constexpr (kPass == 1) {
    float* cot = reinterpret_cast<float*>(rows);  // [rt, ld] g, then dhc
    char* u = rows + 4 * rt * ld;
    __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(u);  // [rt, ld]
    __nv_bfloat16* xb = hb + rt * ld;                         // [rt, ld]
    MT* mt = reinterpret_cast<MT*>(xb + rt * ld);  // [rt, ld] own messages
    __nv_bfloat16* dpb = hb;  // after the gate: the dp rows
    float* rs = reinterpret_cast<float*>(
        u + max(8 * rt * ld, dp_rows(H, rt) * dp_ld(H) * 2));
    const MT* msg = static_cast<const MT*>(a.msg);
    tile_in(hb, a.h + off, R, H);
    tile_in(cot, a.g + off, R, H);
    tile_in(mt, msg + off, R, H);
    __syncthreads();
    tile_aggregate(static_cast<const VT*>(a.vals), a.tile, a.n_tiles, a.bw,
                   msg, static_cast<const MT*>(mt), r0, R, ld, H, xb, rs,
                   buf, buf_floats);
    zero_pad(xb, R, H);
    __syncthreads();
    tile_out(a.x + off, xb, R, H);
    float* dp_t = a.dp + 4 * off;
    gate_sums(R, H, xb, hb, a.wi, a.wh, stages,
              [&](int r, int c, const float(&v)[6][2]) {
                gate_epilogue(v, r, c, H, a.bi, a.bh, hb, cot,
                              dp_t + static_cast<size_t>(r) * 4 * H);
              });
    // dp (device memory) of every row of the tile is visible to the block.
    MT* dx = static_cast<MT*>(a.dx) + off;
    float* dhl = a.dhl + off;
    gate_bwd_products(R, H, dp_t, dpb, a.wiT, a.whT, stages,
                      [&](int r, int c, const float(&v)[2][2]) {
                        const float* hc = cot + r * ld + c;
                        put2(dx + r * H + c, v[0][0], v[0][1]);
                        put2(dhl + r * H + c, __fadd_rn(hc[0], v[1][0]),
                             __fadd_rn(hc[1], v[1][1]));
                      });
  } else {
    MT* dxt = reinterpret_cast<MT*>(rows);                 // [rt, ld] dx
    float* dm = reinterpret_cast<float*>(rows + 4 * rt * ld);  // dmsg
    float* rs = dm + rt * ld;
    const MT* dx = static_cast<const MT*>(a.dx);
    tile_in(dxt, dx + off, R, H);
    __syncthreads();
    tile_aggregate(static_cast<const VT*>(a.tvals), a.tile, a.n_tiles, a.bw,
                   dx, static_cast<const MT*>(dxt), r0, R, ld, H, dm, rs, buf,
                   buf_floats);
    zero_pad(dm, R, H);
    __syncthreads();
    // dmsg out unrounded (the weight pass sums db_e from it); the product
    // with W_e^T takes it at the message dtype.
    tile_out(a.dmsg + off, dm, R, H);
    const float* dhl = a.dhl + off;
    __nv_bfloat16* dh = a.dh + off;
    dmsg_times_ekT<kRoundMsg ? 1 : 3>(
        R, H, dm, a.ekT, stages, [&](int r, int c, const float(&v)[1][2]) {
          const float* l = dhl + r * H + c;
          put2(dh + r * H + c, __fadd_rn(l[0], v[0][0]),
               __fadd_rn(l[1], v[0][1]));
        });
  }
}

// Launches pass kPass over plan p (occupancy == nullptr) or queries its
// blocks an SM.
template <typename VT, int kPass>
int bwd_bf16_pass(const BwdBf16Args& a, const StepPlan& p, cudaStream_t st,
                  int* occupancy) {
  const auto kernel = fused_step_bwd_kernel_bf16<VT, kPass>;
  const size_t smem = step_bwd_bf16_smem(kPass, p.row_tile, a.H);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occupancy)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, kernel, kGroupThreads, smem));
  kernel<<<p.blocks, kGroupThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The three passes of one step (occupancy: the passes' blocks an SM).
template <typename VT>
int launch_fused_bwd_bf16(BwdBf16Args a, cudaStream_t st,
                          int* occupancy = nullptr) {
  const StepPlan p = step_bwd_plan(a.n_rows, device_sms());
  a.row_tile = p.row_tile;
  int e = bwd_bf16_pass<VT, 0>(a, p, st, occupancy);
  if (e != 0) return e;
  e = bwd_bf16_pass<VT, 1>(a, p, st, occupancy ? occupancy + 1 : nullptr);
  if (e != 0) return e;
  return bwd_bf16_pass<VT, 2>(a, p, st, occupancy ? occupancy + 2 : nullptr);
}

// ---------------------------------------------------------------------------
// persistent_bwd_kernel_bf16: the persistent lane's reverse sweep at bf16
// ---------------------------------------------------------------------------
//
// One block per closed row group, steps K-1 down to 0. Per step: h in (a
// bf16 tile), the messages (the per-step pass 0's product), their
// aggregate rounded to x (written out), the gate's six sums and its
// backward (dp written out, dhc into the resident cotangent), dx and dhl
// with dp staged back rounded (dx kept at the message dtype), dmsg = A^T
// dx (written out unrounded) and dh = round_bf16(dhl + dmsg_c W_e^T), the
// next step's cotangent.
//
// Shared memory (ops/fused_gnn.py:persistent_bwd_bf16_smem_bytes mirrors
// it; persistent_occupancy reports it): the ring, the cotangent (f32),
// then one region that holds h, x and the messages (sized f32) until the
// gate is done, then dx (sized f32) beside the dp rows, then dmsg; the row
// sums. 111,808 bytes for groups of 48 rows at H 128, two blocks an SM;
// 183,168 at the 92 rows that persistent_bwd_smem_ok admits (its count,
// 232,448 bytes for four f32 row arrays, stays the gate).
struct PersistBwdBf16Args {
  const __nv_bfloat16* h0;
  const __nv_bfloat16* hist;
  const void* vals;
  const void* tvals;
  const __nv_bfloat16* g;
  const __nv_bfloat16 *ek, *wi, *wh, *ekT, *wiT, *whT;
  const float *eb, *bi, *bh;
  const int* groups;
  __nv_bfloat16* x;
  float *dp, *dmsg;
  __nv_bfloat16* dh;
  int n_rows, H, tile, n_tiles, bw, n_steps, max_rows;
};

// The region's bytes for groups padded to rp rows.
__host__ __device__ inline int persist_region_bytes(int rp, int hidden) {
  const int rows = rp * gnnmma::tile_ld(hidden);
  const int dp = gnnmma::dp_rows(hidden, rp) * gnnmma::dp_ld(hidden) * 2;
  const int after = 4 * rows + (dp > 4 * rows ? dp : 4 * rows);
  return 8 * rows > after ? 8 * rows : after;
}

size_t persistent_bwd_bf16_smem(int max_rows, int hidden) {
  const int rp = (max_rows + 15) & ~15;
  return ring_bytes(hidden) +
         4 * static_cast<size_t>(rp) * gnnmma::tile_ld(hidden) +
         persist_region_bytes(rp, hidden) + 4 * static_cast<size_t>(rp);
}

template <typename VT>
__global__ void __launch_bounds__(kGroupThreads, kPersistBf16Blocks)
    persistent_bwd_kernel_bf16(const PersistBwdBf16Args a) {
  using namespace gnnmma;
  using MT = VT;
  constexpr bool kRoundMsg = sizeof(VT) == 2;
  extern __shared__ __align__(16) char bsmem[];
  const VT* vals = static_cast<const VT*>(a.vals);
  const VT* tvals = static_cast<const VT*>(a.tvals);
  const int H = a.H, ld = tile_ld(H), rp = (a.max_rows + 15) & ~15;
  const int g0 = a.groups[blockIdx.x], g1 = a.groups[blockIdx.x + 1];
  const int R = g1 - g0;
  if (R == 0) return;  // an empty (padded) group owns no rows
  char* stages = bsmem;
  float* cot = reinterpret_cast<float*>(bsmem + ring_bytes(H));  // [rp, ld]
  char* u = reinterpret_cast<char*>(cot + rp * ld);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(u);  // [rp, ld]
  __nv_bfloat16* xb = hb + rp * ld;                         // [rp, ld]
  MT* mt = reinterpret_cast<MT*>(xb + rp * ld);  // [rp, ld] the messages
  MT* dxt = reinterpret_cast<MT*>(u);            // [rp, ld] dx, after the gate
  char* v = u + 4 * rp * ld;
  __nv_bfloat16* dpb = reinterpret_cast<__nv_bfloat16*>(v);  // the dp rows
  float* dm = reinterpret_cast<float*>(v);                   // then dmsg
  float* rs = reinterpret_cast<float*>(u + persist_region_bytes(rp, H));
  const size_t goff = static_cast<size_t>(g0) * H;
  const size_t plane = static_cast<size_t>(a.n_rows) * H;
  tile_in(cot, a.g + goff, R, H);
  for (int s = a.n_steps - 1; s >= 0; --s) {
    const __nv_bfloat16* src = s == 0 ? a.h0 : a.hist + (s - 1) * plane;
    tile_in(hb, src + goff, R, H);
    __syncthreads();
    messages(R, H, hb, a.ek, a.eb, kRoundMsg, stages,
             [&](int r, int c, const float(&m)[2]) {
               put2(mt + r * ld + c, m[0], m[1]);
             });
    // The aggregate, rounded: x.
    group_aggregate(vals, a.tile, a.n_tiles, a.bw,
                    static_cast<const MT*>(mt), ld, g0, g1, H, xb, rs);
    zero_pad(xb, R, H);
    __syncthreads();
    tile_out(a.x + s * plane + goff, xb, R, H);
    float* dp_step = a.dp + 4 * (s * plane + goff);
    gate_sums(R, H, xb, hb, a.wi, a.wh, stages,
              [&](int r, int c, const float(&w)[6][2]) {
                gate_epilogue(w, r, c, H, a.bi, a.bh, hb, cot,
                              dp_step + static_cast<size_t>(r) * 4 * H);
              });
    // dp (device memory) of every row is visible to the block: dx into
    // dxt at the message dtype, dhl into the cotangent.
    gate_bwd_products(R, H, dp_step, dpb, a.wiT, a.whT, stages,
                      [&](int r, int c, const float(&w)[2][2]) {
                        float* hc = cot + r * ld + c;
                        put2(dxt + r * ld + c, w[0][0], w[0][1]);
                        hc[0] = __fadd_rn(hc[0], w[1][0]);
                        hc[1] = __fadd_rn(hc[1], w[1][1]);
                      });
    // dmsg = A^T dx, out unrounded; the product with W_e^T takes it at the
    // message dtype.
    group_aggregate(tvals, a.tile, a.n_tiles, a.bw,
                    static_cast<const MT*>(dxt), ld, g0, g1, H, dm, rs);
    zero_pad(dm, R, H);
    __syncthreads();
    tile_out(a.dmsg + s * plane + goff, dm, R, H);
    dmsg_times_ekT<kRoundMsg ? 1 : 3>(
        R, H, dm, a.ekT, stages, [&](int r, int c, const float(&w)[1][2]) {
          float* hc = cot + r * ld + c;
          hc[0] = round_bf16(__fadd_rn(hc[0], w[0][0]));
          hc[1] = round_bf16(__fadd_rn(hc[1], w[0][1]));
        });
  }
  rows_to_global(a.dh + goff, cot, ld, R, H, 0, H);
}

// Launches the sweep over n_groups groups (blocks == nullptr) or queries
// the blocks of it one SM holds.
template <typename VT>
int launch_persistent_bwd_bf16(const PersistBwdBf16Args& a, int n_groups,
                               cudaStream_t st, int* blocks = nullptr) {
  const auto kernel = persistent_bwd_kernel_bf16<VT>;
  const size_t smem = persistent_bwd_bf16_smem(a.max_rows, a.H);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kGroupThreads, smem));
  kernel<<<n_groups, kGroupThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// step_weight_grad_kernel_bf16: the weight pass on the bf16 tensor cores
// ---------------------------------------------------------------------------
//
// Pass 1 of step_weight_grad_launch at bf16, for the sums of _bwd_kernel's
// bf16 body (deepdfa_tpu/ops/fused_gnn.py:446-454) and of
// _persist_bwd_kernel's (:854-895): dW_i = x^T bf16(dpre_i), dW_h = h^T
// bf16(dpre_h), dW_e = h^T dmsg_c (dmsg rounded to bf16 when the messages
// are bf16), f32 sums; the bias gradients sum the unrounded f32 columns.
// L (h, hist, x) comes as bf16, R (dp, dmsg) as f32.
//
// What bounds it: bytes. At the training batch (N 16384, H 128, 5 steps)
// its operands are 250 MB (0.075 ms at 3.35 TB/s; ops/fused_gnn.py:
// kernel_cost), its products 18.8 GFLOP (0.019 ms at 989 TFLOP/s). The
// block, grid and fold are the f32 pass's (one 128 x 128 output tile of
// one gradient, one step, one split of the rows a block; 8 warps of 32 x
// 64), so a K-step call equals the fold of K one-step calls bit for bit.
// The design:
// * Every product is one bf16 mma.sync.m16n8k16 a 16-deep k-slice (rows),
//   f32 accumulators (bf16_mma.cuh: mma, ldsm4_t); each accumulator adds
//   its k-slices in ascending row order over its split.
// * L lands by cp.async as bf16 and is used as it lands: A(m, k) = L[k][m]
//   read by ldmatrix.trans. A slab row is kW16Ld = 136 bf16 (272 bytes),
//   so ldmatrix's 8 rows of 16 bytes hit 32 banks.
// * R lands by cp.async as f32 in a stage of its own; each thread rounds
//   the pieces it copied itself (4 floats, after its own wait_group: no
//   barrier) into a bf16 slab, B(k, n) = R[k][n] by ldmatrix.trans, and
//   sums the unrounded values into its 4 bias columns. With f32 messages
//   dW_e's R is split three ways there (split3: x = x1 + x2 + x3 exactly,
//   each part bf16; three mma.sync, the smallest part first), so each of
//   its products is exact too.
// * One barrier a slab: after it the slab's L and rounded R are whole,
//   the stage of slab i - 1 is free for slab i + kS - 1 (kS - 1 slabs in
//   flight) and the bf16 slab of i - 1 for i + 1 (double buffered).
// * Splits: as many as one step's tiles can take within one block an SM
//   (ops/fused_gnn.py:wgrad_bf16_rows_per_split, from the row count and
//   width alone; 18 of 928 rows, 126 blocks a step at the training
//   batch): a one-step call is one wave, a K-step call fills the two
//   blocks an SM, and the f32 partials (read back by the fold) stay few.
//   Measured against filling every resident block (37 splits) and 64-row
//   slabs at one block an SM: scripts/torch_wgrad_bf16_layouts.py.

// The layout (scripts/torch_wgrad_bf16_layouts.py times the others, with
// the mirrors WGRAD_BF16_* in ops/fused_gnn.py):
constexpr int kW16Slab = 32;        // rows a slab: kW16Slab / 16 k-slices
constexpr int kW16Stages = 3;       // the cp.async ring's slab stages
constexpr int kW16SplitStages = 2;  // with f32 messages (three R parts)
constexpr int kW16Blocks = 2;       // blocks an SM (__launch_bounds__)
constexpr int kW16Ld = kWTile + 8;  // a bf16 slab row: 272 bytes
// R pieces (4 floats) a thread copies and rounds a slab.
constexpr int kW16Pieces = kW16Slab * kWTile / 4 / kWThreads;

// Dynamic shared memory of the instance with kS stages and kP R parts:
// the f32 R stages, the bf16 L stages, two bf16 R slabs of kP parts.
__host__ __device__ constexpr size_t wgrad_bf16_smem(int kS, int kP) {
  return static_cast<size_t>(kS) * kW16Slab * (kWTile * 4 + kW16Ld * 2) +
         2 * static_cast<size_t>(kP) * kW16Slab * kW16Ld * 2;
}

template <int kS, int kP>
__global__ void __launch_bounds__(kWThreads, kW16Blocks)
    step_weight_grad_kernel_bf16(const __nv_bfloat16* __restrict__ h0,
                                 const __nv_bfloat16* __restrict__ hist,
                                 const __nv_bfloat16* __restrict__ xbuf,
                                 const float* __restrict__ dpbuf,
                                 const float* __restrict__ dmsgbuf,
                                 float* __restrict__ partial, int n_rows,
                                 int H, int n_steps, int rows_per_split,
                                 int vec) {
  extern __shared__ __align__(16) float wsmem[];
  float* Rf = wsmem;  // [kS][kW16Slab][kWTile] f32
  __nv_bfloat16* Lb = reinterpret_cast<__nv_bfloat16*>(
      Rf + kS * kW16Slab * kWTile);          // [kS][kW16Slab][kW16Ld]
  __nv_bfloat16* Rb = Lb + kS * kW16Slab * kW16Ld;  // [2][kP][..]
  constexpr int kSlabB = kW16Slab * kW16Ld;  // elements of a bf16 slab
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, q = lane >> 3;
  const int tiles_a = (H + kWTile - 1) / kWTile;
  const int tiles_g = tiles_a * ((3 * H + kWTile - 1) / kWTile);
  int tile = blockIdx.x, prod;
  if (tile < tiles_g) {
    prod = 0;
  } else if (tile < 2 * tiles_g) {
    prod = 1;
    tile -= tiles_g;
  } else {
    prod = 2;
    tile -= 2 * tiles_g;
  }
  const int s = blockIdx.z;
  const int width = prod == 2 ? H : 3 * H;
  // The instance with three R parts runs for f32 messages: dW_e splits.
  const bool split = kP == 3 && prod == 2;
  const int a0 = (tile % tiles_a) * kWTile, b0 = (tile / tiles_a) * kWTile;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  const size_t plane = static_cast<size_t>(n_rows) * H;
  const __nv_bfloat16* hs = s == 0 ? h0 : hist + (s - 1) * plane;
  const __nv_bfloat16* L = prod == 0 ? xbuf + s * plane : hs;
  const float* Rm = prod == 2 ? dmsgbuf + s * plane : dpbuf + 4 * s * plane;
  const int rstride = prod == 2 ? H : 4 * H;
  // dpre_h's n block (prod 1) is dpre_hn, stored H columns on.
  auto rcol = [&](int b) { return (prod == 1 && b >= 2 * H) ? b + H : b; };
  // This thread's R pieces: rows warp + 8 p, columns 4 lane .. 4 lane + 3.
  const int pc = 4 * lane;

  // Slab i (rows r_begin + kW16Slab i ..) into stage st, zeros past r_end,
  // H or width; not waited for.
  auto issue = [&](int i, int st) {
    const int r0 = r_begin + i * kW16Slab;
    __nv_bfloat16* ld = Lb + st * kSlabB;
    float* rd = Rf + st * kW16Slab * kWTile;
    const int lv = vec ? 8 : 2;  // L values a piece: 16 or 4 bytes
    for (int e = tid; e < kW16Slab * kWTile / lv; e += kWThreads) {
      const int rr = e / (kWTile / lv), c = (e % (kWTile / lv)) * lv;
      const bool in = r0 + rr < r_end && a0 + c < H;
      float* dst = reinterpret_cast<float*>(ld + rr * kW16Ld + c);
      const float* src = reinterpret_cast<const float*>(
          in ? L + static_cast<size_t>(r0 + rr) * H + a0 + c : L);
      if (vec)
        cp_async16(dst, src, in);
      else
        cp_async4(dst, src, in);
    }
#pragma unroll
    for (int p = 0; p < kW16Pieces; ++p) {
      const int rr = warp + p * (kWThreads / 32);
      const size_t row = static_cast<size_t>(r0 + rr) * rstride;
      const bool in_r = r0 + rr < r_end;
      float* dst = rd + rr * kWTile + pc;
      if (vec) {
        const bool in = in_r && b0 + pc < width;
        cp_async16(dst, in ? Rm + row + rcol(b0 + pc) : Rm, in);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = in_r && b0 + pc + j < width;
          cp_async4(dst + j, in ? Rm + row + rcol(b0 + pc + j) : Rm, in);
        }
      }
    }
  };

  // Slab i's R, this thread's pieces, rounded (or split) into bf16 slab
  // buf; the unrounded values into the bias sums.
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  auto convert = [&](int st, int buf) {
    const float* rs = Rf + st * kW16Slab * kWTile;
    __nv_bfloat16* rb = Rb + buf * kP * kSlabB;
#pragma unroll
    for (int p = 0; p < kW16Pieces; ++p) {
      const int rr = warp + p * (kWThreads / 32);
      const float4 v = *reinterpret_cast<const float4*>(rs + rr * kWTile + pc);
      bias[0] += v.x;
      bias[1] += v.y;
      bias[2] += v.z;
      bias[3] += v.w;
      uint2* d = reinterpret_cast<uint2*>(rb + rr * kW16Ld + pc);
      if (split) {
        uint32_t x0, x1, x2, y0, y1, y2;
        bf16mma::split3(v.x, v.y, x0, x1, x2);
        bf16mma::split3(v.z, v.w, y0, y1, y2);
        d[0] = make_uint2(x0, y0);
        d[kSlabB / 4] = make_uint2(x1, y1);
        d[2 * (kSlabB / 4)] = make_uint2(x2, y2);
      } else {
        d[0] = make_uint2(bf16mma::pack(v.x, v.y), bf16mma::pack(v.z, v.w));
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.f;
  const int wa = (warp >> 1) * 32, wb = (warp & 1) * 64;
  // ldmatrix addresses: lane l gives row l % 8 of matrix q = l / 8; A
  // takes matrices (m +8 q & 1, k +8 q >> 1), B (k +8 q & 1, n +8 q >> 1).
  const int a_frag =
      (((q >> 1) << 3) + (lane & 7)) * kW16Ld + wa + ((q & 1) << 3);
  const int b_frag =
      (((q & 1) << 3) + (lane & 7)) * kW16Ld + wb + ((q >> 1) << 3);

  // Slab i's products: 16-deep k-slices in row order.
  auto products = [&](int st, int buf) {
    const __nv_bfloat16* lb = Lb + st * kSlabB + a_frag;
    const __nv_bfloat16* rb = Rb + buf * kP * kSlabB + b_frag;
#pragma unroll
    for (int kk = 0; kk < kW16Slab / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        bf16mma::ldsm4_t(a[mi], lb + 16 * kk * kW16Ld + 16 * mi);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const __nv_bfloat16* bp = rb + 16 * kk * kW16Ld + 16 * jp;
        if (split) {
          uint32_t b[3][4];
#pragma unroll
          for (int part = 0; part < 3; ++part)
            bf16mma::ldsm4_t(b[part], bp + part * kSlabB);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int part = 2; part >= 0; --part) {
              bf16mma::mma(acc[mi][2 * jp], a[mi], b[part][0], b[part][1]);
              bf16mma::mma(acc[mi][2 * jp + 1], a[mi], b[part][2],
                           b[part][3]);
            }
        } else {
          uint32_t b[4];
          bf16mma::ldsm4_t(b, bp);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            bf16mma::mma(acc[mi][2 * jp], a[mi], b[0], b[1]);
            bf16mma::mma(acc[mi][2 * jp + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
  };

  const int n_slabs = (r_end - r_begin + kW16Slab - 1) / kW16Slab;
#pragma unroll
  for (int i = 0; i < kS - 1; ++i) {
    if (i < n_slabs) issue(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_slabs; ++i) {
    cp_async_wait_group<kS - 2>();  // this thread's copies of slab i
    convert(i % kS, i & 1);
    __syncthreads();  // slab i whole; stage (i - 1) % kS free
    if (i + kS - 1 < n_slabs) issue(i + kS - 1, (i + kS - 1) % kS);
    cp_async_commit();
    products(i % kS, i & 1);
  }
  cp_async_wait_all();
  __syncthreads();  // every warp's products done: the R stages are free

  const size_t n_out = 7 * static_cast<size_t>(H) * H + 7 * H;
  const size_t w_off = static_cast<size_t>(prod) * 3 * H * H;
  const size_t b_off = 7 * static_cast<size_t>(H) * H + prod * 3 * H;
  float* out =
      partial + (static_cast<size_t>(blockIdx.y) * n_steps + s) * n_out;
  // Columns b, b + 1 of rows a, a + 8 (H % 4 == 0: both or neither).
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int a = a0 + wa + 16 * mi + g;
      const int b = b0 + wb + 8 * nj + 2 * t4;
      if (b >= width) continue;
      if (a < H)
        *reinterpret_cast<float2*>(out + w_off + static_cast<size_t>(a) *
                                                     width + b) =
            make_float2(acc[mi][nj][0], acc[mi][nj][1]);
      if (a + 8 < H)
        *reinterpret_cast<float2*>(out + w_off + static_cast<size_t>(a + 8) *
                                                     width + b) =
            make_float2(acc[mi][nj][2], acc[mi][nj][3]);
    }
  // The bias: each warp's rows' sums, added in warp order.
  float* bias_s = Rf;  // [kWThreads / 32][kWTile]
  *reinterpret_cast<float4*>(bias_s + warp * kWTile + pc) =
      make_float4(bias[0], bias[1], bias[2], bias[3]);
  __syncthreads();
  if (a0 == 0 && tid < kWTile && b0 + tid < width) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWThreads / 32; ++w) sum += bias_s[w * kWTile + tid];
    out[b_off + b0 + tid] = sum;
  }
}

// Launches step_weight_grad_kernel_bf16's instance with kS stages and kP
// R parts over grid, or (blocks != nullptr) queries the blocks of it one
// SM holds.
template <int kS, int kP>
int launch_wgrad_bf16(const void* h0, const void* hist, const void* x,
                      const void* dp, const void* dmsg, void* partial,
                      int n_rows, int hidden, int n_steps, int rows_per_split,
                      int vec, dim3 grid, cudaStream_t st,
                      int* blocks = nullptr) {
  const auto kernel = step_weight_grad_kernel_bf16<kS, kP>;
  const size_t smem = wgrad_bf16_smem(kS, kP);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kWThreads, smem));
  kernel<<<grid, kWThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(h0),
      static_cast<const __nv_bfloat16*>(hist),
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dp),
      static_cast<const float*>(dmsg), static_cast<float*>(partial), n_rows,
      hidden, n_steps, rows_per_split, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One step's backward over n_rows = n_tiles * tile rows (two launches of
// fused_step_bwd_kernel, its passes). vals/tvals: A and A^T in block-band form,
// bf16 (vals_bf16 != 0) or f32; h, g, x, dx, dhl, dmsg, dh [n_rows, hidden]
// f32, dp [n_rows, 4 * hidden]; packed weights as the forward plus their
// transposes wiT, whT [3H, H] and ekT [H, H]. Returns the cudaError_t.
int fused_step_bwd_launch(const void* h, const void* vals, const void* tvals,
                          int vals_bf16, const void* g, const void* ek,
                          const void* eb, const void* wi, const void* bi,
                          const void* wh, const void* bh, const void* wiT,
                          const void* whT, const void* ekT, void* x,
                          void* dp, void* dx, void* dhl, void* dmsg,
                          void* dh, int n_rows, int hidden, int tile,
                          int n_tiles, int bandwidth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_fused_bwd<__nv_bfloat16>(
        h, vals, tvals, g, ek, eb, wi, bi, wh, bh, wiT, whT, ekT, x, dp, dx,
        dhl, dmsg, dh, n_rows, hidden, tile, n_tiles, bandwidth, st);
  return launch_fused_bwd<float>(h, vals, tvals, g, ek, eb, wi, bi, wh, bh,
                                 wiT, whT, ekT, x, dp, dx, dhl, dmsg, dh,
                                 n_rows, hidden, tile, n_tiles, bandwidth,
                                 st);
}

// The reverse sweep of n_steps steps in one launch: one block per closed
// row group, the cotangent resident in shared memory ((4 * hidden + 1) * 4
// bytes a row of the largest group). hist [n_steps - 1, n_rows, hidden]
// holds h_1..h_{K-1} (unread when n_steps == 1); x, dmsg [n_steps, n_rows,
// hidden] and dp [n_steps, n_rows, 4 * hidden] receive each step's per-row
// cotangents for step_weight_grad_launch.
int persistent_bwd_launch(const void* h0, const void* hist, const void* vals,
                          const void* tvals, int vals_bf16, const void* g,
                          const void* ek, const void* eb, const void* wi,
                          const void* bi, const void* wh, const void* bh,
                          const void* wiT, const void* whT, const void* ekT,
                          const void* groups, int n_groups,
                          int max_group_rows, int n_steps, void* x, void* dp,
                          void* dmsg, void* dh, int hidden, int tile,
                          int n_tiles, int bandwidth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_persistent_bwd<__nv_bfloat16>(
        h0, hist, vals, tvals, g, ek, eb, wi, bi, wh, bh, wiT, whT, ekT,
        groups, n_groups, max_group_rows, n_steps, x, dp, dmsg, dh, hidden,
        tile, n_tiles, bandwidth, st);
  return launch_persistent_bwd<float>(
      h0, hist, vals, tvals, g, ek, eb, wi, bi, wh, bh, wiT, whT, ekT, groups,
      n_groups, max_group_rows, n_steps, x, dp, dmsg, dh, hidden, tile,
      n_tiles, bandwidth, st);
}

// The weight gradients of n_steps steps from their per-row cotangents:
// dek [H, H], deb [H], dwi, dwh [H, 3H], dbi, dbh [3H], all f32, written
// (not accumulated). h0 [n_rows, H] and hist [n_steps - 1, n_rows, H] give
// each step's input h_s. The rows are cut into ceil(n_rows /
// rows_per_split) splits (rows_per_split a multiple of 32); partial is
// scratch of splits * n_steps * (7 H^2 + 7 H) floats.
int step_weight_grad_launch(const void* h0, const void* hist, const void* x,
                            const void* dp, const void* dmsg, int n_rows,
                            int hidden, int n_steps, int rows_per_split,
                            void* partial, void* dek, void* deb, void* dwi,
                            void* dbi, void* dwh, void* dbh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_per_split <= 0 || rows_per_split % kWSlab)
    return 1;  // invalid value
  const void* rows[] = {h0, hist, x, dp, dmsg};
  int vec = hidden % 4 == 0;
  for (const void* p : rows)
    vec &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  cudaError_t e = cudaFuncSetAttribute(
      step_weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_a = (hidden + kWTile - 1) / kWTile;
  const dim3 grid(tiles_a * (2 * ((3 * hidden + kWTile - 1) / kWTile) +
                             (hidden + kWTile - 1) / kWTile),
                  (n_rows + rows_per_split - 1) / rows_per_split, n_steps);
  step_weight_grad_kernel<<<grid, kWThreads, kWSmem, st>>>(
      static_cast<const float*>(h0), static_cast<const float*>(hist),
      static_cast<const float*>(x), static_cast<const float*>(dp),
      static_cast<const float*>(dmsg), static_cast<float*>(partial), n_rows,
      hidden, n_steps, rows_per_split, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_out = 7LL * hidden * hidden + 7LL * hidden;
  step_weight_grad_reduce_kernel<<<static_cast<int>((n_out + 255) / 256), 256,
                                   0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dek),
      static_cast<float*>(deb), static_cast<float*>(dwi),
      static_cast<float*>(dbi), static_cast<float*>(dwh),
      static_cast<float*>(dbh), hidden, n_steps, static_cast<int>(grid.y));
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry of fused_step_bwd_launch over n_rows rows: the row
// tile, the k rows of a gate slab, each pass's blocks, the blocks of pass
// 0's and pass 1's instances one SM holds, their blocks' dynamic shared
// memory, and the SMs the plan filled.
int fused_step_bwd_geometry(int vals_bf16, int n_rows, int hidden,
                            int* row_tile, int* slab_rows, int* blocks,
                            int* blocks_per_sm, int* blocks_per_sm_pass1,
                            int* smem_bytes, int* smem_bytes_pass1,
                            int* sms) {
  *sms = device_sms();
  const StepPlan p = step_bwd_plan(n_rows, *sms);
  *row_tile = p.row_tile;
  *slab_rows = p.slab_rows;
  *blocks = p.blocks;
  *smem_bytes =
      static_cast<int>(step_bwd_smem(0, p.row_tile, hidden, p.slab_rows));
  *smem_bytes_pass1 =
      static_cast<int>(step_bwd_smem(1, p.row_tile, hidden, p.slab_rows));
  int e = vals_bf16
              ? bwd_pass_occupancy<0, __nv_bfloat16>(p, hidden, blocks_per_sm)
              : bwd_pass_occupancy<0, float>(p, hidden, blocks_per_sm);
  if (e != 0) return e;
  return vals_bf16 ? bwd_pass_occupancy<1, __nv_bfloat16>(
                         p, hidden, blocks_per_sm_pass1)
                   : bwd_pass_occupancy<1, float>(p, hidden,
                                                  blocks_per_sm_pass1);
}

// Blocks of persistent_bwd_kernel that fit one SM for groups of up to
// max_group_rows rows, into *blocks.
int persistent_bwd_occupancy(int vals_bf16, int max_group_rows, int hidden,
                             int* blocks) {
  const size_t smem = persistent_bwd_smem(max_group_rows, hidden);
  cudaError_t e;
  if (vals_bf16) {
    e = cudaFuncSetAttribute(persistent_bwd_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, persistent_bwd_kernel<__nv_bfloat16>, kGroupThreads, smem);
  } else {
    e = cudaFuncSetAttribute(persistent_bwd_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, persistent_bwd_kernel<float>, kGroupThreads, smem);
  }
  return static_cast<int>(e);
}

// One bf16 step's backward (fused_step_bwd_kernel_bf16, three launches,
// its passes): h, g, x, dh [n_rows, hidden] bf16; msg and dx (scratch)
// [n_rows, hidden] at the message dtype (bf16 for bf16 band values, else
// f32), dhl (scratch) and dmsg [n_rows, hidden] f32, dp [n_rows, 4 *
// hidden] f32; the weights ek, wi, wh and their transposes ekT, wiT, whT
// bf16, the biases eb, bi, bh f32 arrays of bf16 values; otherwise as
// fused_step_bwd_launch.
int fused_step_bwd_bf16_launch(const void* h, const void* vals,
                               const void* tvals, int vals_bf16,
                               const void* g, const void* ek, const void* eb,
                               const void* wi, const void* bi, const void* wh,
                               const void* bh, const void* wiT,
                               const void* whT, const void* ekT, void* msg,
                               void* x, void* dp, void* dx, void* dhl,
                               void* dmsg, void* dh, int n_rows, int hidden,
                               int tile, int n_tiles, int bandwidth,
                               void* stream) {
  using B = const __nv_bfloat16*;
  const BwdBf16Args a{static_cast<B>(h),
                      vals,
                      tvals,
                      static_cast<B>(g),
                      static_cast<B>(ek),
                      static_cast<B>(wi),
                      static_cast<B>(wh),
                      static_cast<B>(ekT),
                      static_cast<B>(wiT),
                      static_cast<B>(whT),
                      static_cast<const float*>(eb),
                      static_cast<const float*>(bi),
                      static_cast<const float*>(bh),
                      msg,
                      static_cast<__nv_bfloat16*>(x),
                      static_cast<float*>(dp),
                      dx,
                      static_cast<float*>(dhl),
                      static_cast<float*>(dmsg),
                      static_cast<__nv_bfloat16*>(dh),
                      n_rows,
                      hidden,
                      tile,
                      n_tiles,
                      bandwidth,
                      0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vals_bf16 ? launch_fused_bwd_bf16<__nv_bfloat16>(a, st)
                   : launch_fused_bwd_bf16<float>(a, st);
}

// fused_step_bwd_bf16_launch's geometry over n_rows rows: the row tile,
// the gate's k rows a stage of the weight ring, the blocks of each pass,
// and for each pass the blocks of its instance one SM holds and its
// blocks' dynamic shared memory, and the SMs the plan filled.
int fused_step_bwd_bf16_geometry(int vals_bf16, int n_rows, int hidden,
                                 int* row_tile, int* slab_rows, int* blocks,
                                 int* blocks_per_sm, int* blocks_per_sm_pass1,
                                 int* blocks_per_sm_pass2, int* smem_bytes,
                                 int* smem_bytes_pass1, int* smem_bytes_pass2,
                                 int* sms) {
  *sms = device_sms();
  const StepPlan p = step_bwd_plan(n_rows, *sms);
  *row_tile = p.row_tile;
  *slab_rows = gnnmma::kKS;
  *blocks = p.blocks;
  *smem_bytes = static_cast<int>(step_bwd_bf16_smem(0, p.row_tile, hidden));
  *smem_bytes_pass1 =
      static_cast<int>(step_bwd_bf16_smem(1, p.row_tile, hidden));
  *smem_bytes_pass2 =
      static_cast<int>(step_bwd_bf16_smem(2, p.row_tile, hidden));
  BwdBf16Args a{};
  a.n_rows = n_rows;
  a.H = hidden;
  int occ[3] = {0, 0, 0};
  const int e = vals_bf16 ? launch_fused_bwd_bf16<__nv_bfloat16>(a, 0, occ)
                          : launch_fused_bwd_bf16<float>(a, 0, occ);
  *blocks_per_sm = occ[0];
  *blocks_per_sm_pass1 = occ[1];
  *blocks_per_sm_pass2 = occ[2];
  return e;
}

// step_weight_grad_launch at bf16 (step_weight_grad_kernel_bf16): h0,
// hist and x bf16, dp and dmsg f32 (rounded to bf16 on load: dp always,
// dmsg when round_msg; split three ways when not); the gradients and
// partial f32, as there. rows_per_split: a multiple of kW16Slab.
int step_weight_grad_bf16_launch(const void* h0, const void* hist,
                                 const void* x, const void* dp,
                                 const void* dmsg, int round_msg, int n_rows,
                                 int hidden, int n_steps, int rows_per_split,
                                 void* partial, void* dek, void* deb,
                                 void* dwi, void* dbi, void* dwh, void* dbh,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_per_split <= 0 || rows_per_split % kW16Slab || hidden % 4)
    return 1;  // invalid value
  const void* rows[] = {h0, hist, x, dp, dmsg};
  int vec = hidden % 8 == 0;
  for (const void* p : rows)
    vec &= reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const int tiles_a = (hidden + kWTile - 1) / kWTile;
  const dim3 grid(tiles_a * (2 * ((3 * hidden + kWTile - 1) / kWTile) +
                             (hidden + kWTile - 1) / kWTile),
                  (n_rows + rows_per_split - 1) / rows_per_split, n_steps);
  int e = round_msg
              ? launch_wgrad_bf16<kW16Stages, 1>(
                    h0, hist, x, dp, dmsg, partial, n_rows, hidden, n_steps,
                    rows_per_split, vec, grid, st)
              : launch_wgrad_bf16<kW16SplitStages, 3>(
                    h0, hist, x, dp, dmsg, partial, n_rows, hidden, n_steps,
                    rows_per_split, vec, grid, st);
  if (e != 0) return e;
  const long long n_out = 7LL * hidden * hidden + 7LL * hidden;
  step_weight_grad_reduce_kernel<<<static_cast<int>((n_out + 255) / 256), 256,
                                   0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dek),
      static_cast<float*>(deb), static_cast<float*>(dwi),
      static_cast<float*>(dbi), static_cast<float*>(dwh),
      static_cast<float*>(dbh), hidden, n_steps, static_cast<int>(grid.y));
  return static_cast<int>(cudaGetLastError());
}

// The instance step_weight_grad_bf16_launch runs for round_msg: the blocks
// of it one SM holds, its blocks' dynamic shared memory, the rows of a
// slab and the stages of its ring.
int step_weight_grad_bf16_geometry(int round_msg, int* blocks_per_sm,
                                   int* smem_bytes, int* slab_rows,
                                   int* stages) {
  *slab_rows = kW16Slab;
  *stages = round_msg ? kW16Stages : kW16SplitStages;
  *smem_bytes = static_cast<int>(round_msg ? wgrad_bf16_smem(kW16Stages, 1)
                                           : wgrad_bf16_smem(kW16SplitStages,
                                                             3));
  const dim3 none(1, 1, 1);
  return round_msg ? launch_wgrad_bf16<kW16Stages, 1>(
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         0, 0, 0, 0, 0, none, 0, blocks_per_sm)
                   : launch_wgrad_bf16<kW16SplitStages, 3>(
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         0, 0, 0, 0, 0, none, 0, blocks_per_sm);
}

// The bf16 reverse sweep (persistent_bwd_kernel_bf16) of n_steps steps in
// one launch, one block per closed row group: h0, g, dh [n_rows, hidden]
// and hist [n_steps - 1, n_rows, hidden] bf16 (hist unread when n_steps
// == 1); x [n_steps, n_rows, hidden] bf16, dp [n_steps, n_rows, 4 *
// hidden] and dmsg [n_steps, n_rows, hidden] f32 receive each step's
// per-row cotangents for step_weight_grad_bf16_launch; the weights and
// biases as fused_step_bwd_bf16_launch's; otherwise as
// persistent_bwd_launch.
int persistent_bwd_bf16_launch(const void* h0, const void* hist,
                               const void* vals, const void* tvals,
                               int vals_bf16, const void* g, const void* ek,
                               const void* eb, const void* wi, const void* bi,
                               const void* wh, const void* bh,
                               const void* wiT, const void* whT,
                               const void* ekT, const void* groups,
                               int n_groups, int max_group_rows, int n_steps,
                               void* x, void* dp, void* dmsg, void* dh,
                               int hidden, int tile, int n_tiles,
                               int bandwidth, void* stream) {
  using B = const __nv_bfloat16*;
  const PersistBwdBf16Args a{static_cast<B>(h0),
                             static_cast<B>(hist),
                             vals,
                             tvals,
                             static_cast<B>(g),
                             static_cast<B>(ek),
                             static_cast<B>(wi),
                             static_cast<B>(wh),
                             static_cast<B>(ekT),
                             static_cast<B>(wiT),
                             static_cast<B>(whT),
                             static_cast<const float*>(eb),
                             static_cast<const float*>(bi),
                             static_cast<const float*>(bh),
                             static_cast<const int*>(groups),
                             static_cast<__nv_bfloat16*>(x),
                             static_cast<float*>(dp),
                             static_cast<float*>(dmsg),
                             static_cast<__nv_bfloat16*>(dh),
                             n_tiles * tile,
                             hidden,
                             tile,
                             n_tiles,
                             bandwidth,
                             n_steps,
                             max_group_rows};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vals_bf16 ? launch_persistent_bwd_bf16<__nv_bfloat16>(a, n_groups, st)
                   : launch_persistent_bwd_bf16<float>(a, n_groups, st);
}

// Blocks of persistent_bwd_kernel_bf16 that fit one SM for groups of up to
// max_group_rows rows, into *blocks, and its blocks' dynamic shared memory,
// into *smem_bytes.
int persistent_bwd_bf16_occupancy(int vals_bf16, int max_group_rows,
                                  int hidden, int* blocks, int* smem_bytes) {
  PersistBwdBf16Args a{};
  a.H = hidden;
  a.max_rows = max_group_rows;
  *smem_bytes =
      static_cast<int>(persistent_bwd_bf16_smem(max_group_rows, hidden));
  return vals_bf16
             ? launch_persistent_bwd_bf16<__nv_bfloat16>(a, 0, 0, blocks)
             : launch_persistent_bwd_bf16<float>(a, 0, 0, blocks);
}

}  // extern "C"
