// Device functions shared by the gated-step kernels (fused_gnn.cu,
// fused_gnn_bwd.cu): the per-element epilogues (edge_out, gate_out,
// gate_bwd_out) and the per-step kernels' aggregate. Forward and backward
// call the same code for the same quantity, so a backward recomputes
// exactly the forward's f32 values, and the register-tiled products of
// group_step.cuh, which every gated-step kernel runs, end in these
// epilogues: nvcc contracts a*b+c into FMAs by expression, so one
// expression in one place keeps the persistent kernels bit for bit equal
// to the scan of the per-step ones.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_val(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The edge linear's epilogue: x = (a W_e)[col] + rowsum(A) b_e[col].
__device__ __forceinline__ float edge_out(float acc, float rs, float b) {
  return acc + rs * b;
}

// The gate biases of column col: r and z add the input and recurrent
// biases (the recurrent ones are 0 in the packed layout), n keeps them
// apart (b_hn sits inside r * (.)).
struct GateBias {
  float r, z, in, hn;
};

__device__ __forceinline__ GateBias gate_bias(const float* __restrict__ bi,
                                              const float* __restrict__ bh,
                                              int H, int col) {
  return {__ldg(bi + col) + __ldg(bh + col),
          __ldg(bi + H + col) + __ldg(bh + H + col), __ldg(bi + 2 * H + col),
          __ldg(bh + 2 * H + col)};
}

// h' of one element from its pre-activation sums and the carry hc. The
// blend is the FMA nvcc formed from (1 - z) n + z hc where the first port
// wrote it inline: written as an expression here, it may contract the
// other product and move h' by an ulp.
__device__ __forceinline__ float gate_out(float pr, float pz, float gn,
                                          float hn, const GateBias& b,
                                          float hc) {
  const float rg = sigmoidf_(pr + b.r);
  const float zg = sigmoidf_(pz + b.z);
  const float ng = tanhf(gn + b.in + rg * (hn + b.hn));
  return fmaf(1.0f - zg, ng, zg * hc);
}

// The bf16 instances (fused_step_kernel_bf16, persistent_fwd_kernel_bf16)
// round where the reference's _fwd_kernel rounds at dt = bfloat16: every
// product and sum in f32 (a product of two bf16 values is exact there),
// then round to bf16 (round to nearest even, as torch and XLA) at each of
// its points. The _rn intrinsics keep nvcc from contracting a product into
// the next add across a rounding point.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// jax.nn.sigmoid of a bf16 value as XLA computes it: 1 / (1 + exp(-x)),
// the exponential, the sum and the quotient each rounded to bf16;
// sigmoid_bf16_unrounded leaves the quotient f32.
__device__ __forceinline__ float sigmoid_bf16_unrounded(float x) {
  const float e = round_bf16(expf(-x));
  return __fdiv_rn(1.0f, round_bf16(__fadd_rn(1.0f, e)));
}

__device__ __forceinline__ float sigmoid_bf16(float x) {
  return round_bf16(sigmoid_bf16_unrounded(x));
}

// The message of one element at bf16 h: (h W_e)[col] (f32 sum acc) plus
// b_e[col]. bf16 band values (the message dtype is bf16): the product
// rounded, then the bias added in bf16. f32 band values (a multiplicity not
// bf16-exact): an f32 message, as the reference's upcast-only rule.
__device__ __forceinline__ float edge_msg_bf16(float acc, float b,
                                               bool round_msg) {
  return round_msg ? round_bf16(__fadd_rn(round_bf16(acc), b))
                   : __fadd_rn(acc, b);
}

// The gate biases of column col at bf16, input and recurrent apart (each
// product rounds before its bias is added).
struct GateBiasBf16 {
  float ir, iz, in, hr, hz, hn;
};

__device__ __forceinline__ GateBiasBf16 gate_bias_bf16(
    const float* __restrict__ bi, const float* __restrict__ bh, int H,
    int col) {
  return {__ldg(bi + col),     __ldg(bi + H + col), __ldg(bi + 2 * H + col),
          __ldg(bh + col),     __ldg(bh + H + col), __ldg(bh + 2 * H + col)};
}

// The bf16 gate's inputs of one element from the six f32 product sums (x
// w_ir, h w_hr, x w_iz, h w_hz, x w_in, h w_hn): gi = round(round(x w_i) +
// b_i), gh = round(round(h w_h) + b_h), then the r and z sigmoids'
// arguments round(gi + gh), gi_n and gh_n (pre_hn).
struct GatePreBf16 {
  float r, z, in, hn;
};

__device__ __forceinline__ GatePreBf16 gate_pre_bf16(float ir, float hr,
                                                     float iz, float hz,
                                                     float in, float hn,
                                                     const GateBiasBf16& b) {
  const float gir = round_bf16(__fadd_rn(round_bf16(ir), b.ir));
  const float giz = round_bf16(__fadd_rn(round_bf16(iz), b.iz));
  const float gin = round_bf16(__fadd_rn(round_bf16(in), b.in));
  const float ghr = round_bf16(__fadd_rn(round_bf16(hr), b.hr));
  const float ghz = round_bf16(__fadd_rn(round_bf16(hz), b.hz));
  const float ghn = round_bf16(__fadd_rn(round_bf16(hn), b.hn));
  return {round_bf16(__fadd_rn(gir, ghr)), round_bf16(__fadd_rn(giz, ghz)),
          gin, ghn};
}

// The n gate's tanh argument at bf16: round(gi_n + round(r gh_n)).
__device__ __forceinline__ float gate_n_arg_bf16(const GatePreBf16& p,
                                                 float rg) {
  return round_bf16(__fadd_rn(p.in, round_bf16(__fmul_rn(rg, p.hn))));
}

// h' of one element at bf16 from the six f32 product sums and the carry
// hc: the GRU gate with every op rounded to bf16 (the reference kernel's
// gate, op for op).
__device__ __forceinline__ float gate_out_bf16(float ir, float hr, float iz,
                                               float hz, float in, float hn,
                                               const GateBiasBf16& b,
                                               float hc) {
  const GatePreBf16 p = gate_pre_bf16(ir, hr, iz, hz, in, hn, b);
  const float rg = sigmoid_bf16(p.r);
  const float zg = sigmoid_bf16(p.z);
  const float ng = round_bf16(tanhf(gate_n_arg_bf16(p, rg)));
  const float keep =
      round_bf16(__fmul_rn(round_bf16(__fsub_rn(1.0f, zg)), ng));
  return round_bf16(__fadd_rn(keep, round_bf16(__fmul_rn(zg, hc))));
}

// The gate's backward for one element: the output cotangent gv through
// the recomputed gates gives the pre-activation cotangents (dp's four
// blocks: dpre_r, dpre_z, dpre_n, dpre_hn) and the direct carry
// cotangent dhc = gv * z.
struct GateGrads {
  float dr, dz, dn, dhn, dhc;
};

__device__ __forceinline__ GateGrads gate_bwd_out(float pr, float pz,
                                                  float gn, float hn,
                                                  const GateBias& b, float hc,
                                                  float gv) {
  const float rg = sigmoidf_(pr + b.r);
  const float zg = sigmoidf_(pz + b.z);
  const float pre_hn = hn + b.hn;
  const float ng = tanhf(gn + b.in + rg * pre_hn);
  const float dz = gv * (hc - ng);
  const float dn = gv * (1.0f - zg);
  const float dpre_n = dn * (1.0f - ng * ng);
  const float drg = dpre_n * pre_hn;
  return {drg * rg * (1.0f - rg), dz * zg * (1.0f - zg), dpre_n,
          dpre_n * rg, gv * zg};
}

// The gate's backward for one element at bf16 (fused_step_bwd_kernel_bf16):
// the forward recomputed as gate_out_bf16, then gate_bwd_out's f32
// cotangents, op for op, each product and difference rounded once in f32
// (the _rn intrinsics: no contraction, as torch and XLA compute them). The
// gates enter them as the reference computes its backward where its tests
// run it (the Pallas interpreter on XLA's CPU backend, whose excess
// precision elides the f32 -> bf16 -> f32 round trip of a gate's last op):
// r and z the sigmoid's f32 quotient, n the f32 tanh of its bf16
// argument; pre_hn, g and hc are bf16 values. ops/fused_gnn.py's
// _bwd_rows_bf16 computes the same.
__device__ __forceinline__ GateGrads gate_bwd_out_bf16(
    float ir, float hr, float iz, float hz, float in, float hn,
    const GateBiasBf16& b, float hc, float gv) {
  const GatePreBf16 p = gate_pre_bf16(ir, hr, iz, hz, in, hn, b);
  const float rg = sigmoid_bf16_unrounded(p.r);
  const float zg = sigmoid_bf16_unrounded(p.z);
  const float ng = tanhf(gate_n_arg_bf16(p, round_bf16(rg)));
  const float dz = __fmul_rn(gv, __fsub_rn(hc, ng));
  const float dn = __fmul_rn(gv, __fsub_rn(1.0f, zg));
  const float dpre_n = __fmul_rn(dn, __fsub_rn(1.0f, __fmul_rn(ng, ng)));
  const float drg = __fmul_rn(dpre_n, p.hn);
  return {__fmul_rn(__fmul_rn(drg, rg), __fsub_rn(1.0f, rg)),
          __fmul_rn(__fmul_rn(dz, zg), __fsub_rn(1.0f, zg)), dpre_n,
          __fmul_rn(dpre_n, rg), __fmul_rn(gv, zg)};
}

// Band values through a generic pointer (the per-step kernels read their
// tile's band rows from shared memory, staged, or device memory): one, or
// the 16 bytes at p (4 f32 or 8 bf16 values), as floats.
__device__ __forceinline__ float band_val(const float* p) { return *p; }
__device__ __forceinline__ float band_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void band_vec(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void band_vec(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(b[e]);
}

// A sum stored at an aggregate's output type: f32, or rounded to bf16
// (the bf16 backward's x).
__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// agg_row[:] = sum_s A[r, s] * hsrc[s][:] and *rs_out = sum_s A[r, s]
// over the senders s of receiver row r's band window (sender rows ST and
// output OT f32, or bf16 where the bf16 backward holds them so: a bf16
// value widens exactly, so the sums are the same). One warp. arow
// points at row r's band values of window tile d = 0, tile d at arow + d
// * d_step (device memory: the band's own layout; shared memory: the
// row's staged window). The warp adds the nonzeros' rows in ascending
// sender order, each element one fmaf after the other (the persistent
// kernels' group_aggregate_row adds the same senders in the same order).
// Out-of-range sender tiles are masked by index, as the TPU kernel masks
// them, not trusted to hold zero blocks. With the transposed band
// (band_transpose_vals) the same code gives A^T rows.
//
// Where a tile's values start 16-byte aligned, lane l reads 16 bytes, V =
// 4 f32 or 8 bf16 values, of each span of 32 V senders (a whole tile of
// 128 f32 values in one load), a ballot finds the lanes holding a
// nonzero, and each such lane's values are broadcast in order; else one
// value a lane of each 32-sender slice. rs sums each lane's values, then
// the lanes: integer multiplicities, exact in any order. The caller's row
// tile [r0, r0 + R) of hsrc is also in shared memory (hloc, stride ld):
// its senders are read there and only the halo's from device memory.
template <typename VT, typename ST, typename OT>
__device__ void warp_aggregate_row(const VT* arow, size_t d_step, int r,
                                   int tile, int n_tiles, int bw,
                                   const ST* __restrict__ hsrc,
                                   const ST* hloc, int r0, int R, int ld,
                                   int H, OT* agg_row, float* rs_out,
                                   int lane) {
  constexpr int V = 16 / sizeof(VT);
  const int tr = r / tile;
  // The window's sender tiles that exist: j = tr + d - bw, d in [d_lo, d_hi].
  const int d_lo = max(0, bw - tr), d_hi = min(2 * bw, n_tiles - 1 - tr + bw);
  const bool vec = tile % V == 0 && (d_step * sizeof(VT)) % 16 == 0 &&
                   reinterpret_cast<size_t>(arow) % 16 == 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float rs = 0.f;
  const auto add = [&](float av, int s) {  // sender s, value av != 0
    const ST* hs = s >= r0 && s < r0 + R
                       ? hloc + (s - r0) * ld
                       : hsrc + static_cast<size_t>(s) * H;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = lane + 32 * k;
      if (col < H) acc[k] = fmaf(av, band_val(hs + col), acc[k]);
    }
  };
  for (int d = d_lo; d <= d_hi; ++d) {
    const VT* seg = arow + d * d_step;
    const int s_first = (tr + d - bw) * tile;
    if (vec) {
      for (int c0 = 0; c0 < tile; c0 += 32 * V) {
        const int c = c0 + lane * V;
        float f[V];
#pragma unroll
        for (int e = 0; e < V; ++e) f[e] = 0.f;
        if (c < tile) band_vec(seg + c, f);
        bool any = false;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          rs += f[e];
          any |= f[e] != 0.f;
        }
        unsigned nz = __ballot_sync(kFull, any);
        while (nz) {
          const int src = __ffs(nz) - 1;
          nz &= nz - 1;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float av = __shfl_sync(kFull, f[e], src);
            if (av != 0.f) add(av, s_first + c0 + src * V + e);
          }
        }
      }
    } else {
      for (int c0 = 0; c0 < tile; c0 += 32) {
        const float a = c0 + lane < tile ? band_val(seg + c0 + lane) : 0.f;
        rs += a;
        unsigned nz = __ballot_sync(kFull, a != 0.f);
        while (nz) {
          const int src = __ffs(nz) - 1;
          nz &= nz - 1;
          add(__shfl_sync(kFull, a, src), s_first + c0 + src);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int col = lane + 32 * k;
    if (col < H) store_val(agg_row + col, acc[k]);
  }
  if (lane == 0) *rs_out = rs;
}

}  // namespace
