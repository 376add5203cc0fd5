// Device functions shared by the gated-step kernels (fused_gnn.cu,
// fused_gnn_bwd.cu). Forward and backward call the same code for the
// same quantity (the aggregate, the edge linear, the gate
// pre-activations), so a backward recomputes exactly the forward's f32
// values, and the persistent kernels equal their per-step counterparts
// bit for bit.
//
// Layout conventions: a block has kThreads threads; in the dense chunk
// products thread (col = tid % 128, half = tid / 128) owns hidden column
// col of rows half * 8 .. half * 8 + 7 of a 16-row chunk. Row operands
// are read as float4 broadcasts; weight columns coalesced.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 128;            // one thread per hidden column
constexpr int kChunk = 16;            // rows per dense-product chunk
constexpr int kRowsPerThread = 8;     // kChunk / 2 row halves
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_val(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// agg_row[:] = sum_s A[r, s] * hsrc[s - hbase][:] and *rs_out = sum_s A[r, s]
// over senders s in [lo, hi) of receiver row r's band window. One warp.
// With the transposed band (band_transpose_vals) the same code gives
// A^T rows.
template <typename VT>
__device__ void warp_aggregate_row(const VT* __restrict__ vals, int r,
                                   int tile, int n_tiles, int bw,
                                   const float* hsrc, int hbase, int lo,
                                   int hi, int H, float* agg_row,
                                   float* rs_out, int lane) {
  const int tr = r / tile, rr = r % tile;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float rs = 0.f;
  for (int d = 0; d <= 2 * bw; ++d) {
    const int j = tr + d - bw;
    if (j < 0 || j >= n_tiles) continue;  // sender tile out of range
    const VT* arow =
        vals + ((static_cast<size_t>(d) * n_tiles + tr) * tile + rr) * tile;
    const int base = j * tile;
    for (int c0 = 0; c0 < tile; c0 += 32) {
      const int c = c0 + lane;
      const int s = base + c;
      float a = 0.f;
      if (c < tile && s >= lo && s < hi) a = load_val(arow + c);
      rs += a;
      unsigned nz = __ballot_sync(kFull, a != 0.f);
      while (nz) {
        const int src = __ffs(nz) - 1;
        nz &= nz - 1;
        const float av = __shfl_sync(kFull, a, src);
        const float* hs =
            hsrc + static_cast<size_t>(base + c0 + src - hbase) * H;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = lane + 32 * q;
          if (col < H) acc[q] = fmaf(av, hs[col], acc[q]);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = lane + 32 * q;
    if (col < H) agg_row[col] = acc[q];
  }
  if (lane == 0) *rs_out = rs;
}

// acc[i] = sum_k a_s[row0 + half*8 + i][k] * w[k * H + col] for the
// thread's rows of the chunk (w is [H, H] row-major).
__device__ __forceinline__ void chunk_rows_times(const float* a_s, int row0,
                                                 int nrows,
                                                 const float* __restrict__ w,
                                                 int H, int col, int half,
                                                 float* acc) {
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  for (int k = 0; k < H; k += 4) {
    float wk[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wk[kk] = __ldg(w + (k + kk) * H + col);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int li = half * kRowsPerThread + i;
      if (li < nrows) {
        const float4 x =
            *reinterpret_cast<const float4*>(a_s + (row0 + li) * H + k);
        acc[i] = fmaf(x.x, wk[0], acc[i]);
        acc[i] = fmaf(x.y, wk[1], acc[i]);
        acc[i] = fmaf(x.z, wk[2], acc[i]);
        acc[i] = fmaf(x.w, wk[3], acc[i]);
      }
    }
  }
}

// In place on rows [row0, row0 + nrows) of a_s (nrows <= kChunk):
// a_s[r] <- a_s[r] @ ek + rs_s[r] * eb. Called by the whole block.
__device__ void chunk_edge_linear(float* a_s, const float* rs_s, int row0,
                                  int nrows, const float* __restrict__ ek,
                                  const float* __restrict__ eb, int H,
                                  int tid) {
  const int col = tid & (kMaxH - 1), half = tid / kMaxH;
  const bool active = col < H;
  float acc[kRowsPerThread];
  if (active) chunk_rows_times(a_s, row0, nrows, ek, H, col, half, acc);
  __syncthreads();
  if (active) {
    const float b = __ldg(eb + col);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int li = half * kRowsPerThread + i;
      if (li < nrows) {
        const int lr = row0 + li;
        a_s[lr * H + col] = acc[i] + rs_s[lr] * b;
      }
    }
  }
}

// The gate pre-activation sums of the thread's rows and column col:
// pr = (x wi + h wh)[:, col], pz = ...[:, H + col], gn = (x wi)[:, 2H + col],
// hn = (h wh)[:, 2H + col], without biases.
__device__ __forceinline__ void gate_preacts(
    const float* x_s, const float* h_s, int row0, int nrows,
    const float* __restrict__ wi, const float* __restrict__ wh, int H,
    int col, int half, float* pr, float* pz, float* gn, float* hn) {
  const int H3 = 3 * H;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) pr[i] = pz[i] = gn[i] = hn[i] = 0.f;
  for (int k = 0; k < H; k += 4) {
    float wir[4], wiz[4], win[4], whr[4], whz[4], whn[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wi_k = wi + (k + kk) * H3 + col;
      const float* wh_k = wh + (k + kk) * H3 + col;
      wir[kk] = __ldg(wi_k);
      wiz[kk] = __ldg(wi_k + H);
      win[kk] = __ldg(wi_k + 2 * H);
      whr[kk] = __ldg(wh_k);
      whz[kk] = __ldg(wh_k + H);
      whn[kk] = __ldg(wh_k + 2 * H);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int li = half * kRowsPerThread + i;
      if (li < nrows) {
        const int lr = row0 + li;
        const float4 x4 = *reinterpret_cast<const float4*>(x_s + lr * H + k);
        const float4 h4 = *reinterpret_cast<const float4*>(h_s + lr * H + k);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pr[i] = fmaf(xv[kk], wir[kk], pr[i]);
          pr[i] = fmaf(hv[kk], whr[kk], pr[i]);
          pz[i] = fmaf(xv[kk], wiz[kk], pz[i]);
          pz[i] = fmaf(hv[kk], whz[kk], pz[i]);
          gn[i] = fmaf(xv[kk], win[kk], gn[i]);
          hn[i] = fmaf(hv[kk], whn[kk], hn[i]);
        }
      }
    }
  }
}

// The GRU gate on rows [row0, row0 + nrows): x from x_s, the carry from
// h_s, h' into dst (same local row indexing; dst may alias h_s). Called by
// the whole block.
__device__ void chunk_gate(const float* x_s, const float* h_s, int row0,
                           int nrows, const float* __restrict__ wi,
                           const float* __restrict__ bi,
                           const float* __restrict__ wh,
                           const float* __restrict__ bh, int H, float* dst,
                           int tid) {
  const int col = tid & (kMaxH - 1), half = tid / kMaxH;
  const bool active = col < H;
  float pr[kRowsPerThread], pz[kRowsPerThread], gn[kRowsPerThread],
      hn[kRowsPerThread];
  if (active)
    gate_preacts(x_s, h_s, row0, nrows, wi, wh, H, col, half, pr, pz, gn, hn);
  __syncthreads();  // every read of this chunk's h rows is done
  if (active) {
    const float b_r = __ldg(bi + col) + __ldg(bh + col);
    const float b_z = __ldg(bi + H + col) + __ldg(bh + H + col);
    const float b_in = __ldg(bi + 2 * H + col);
    const float b_hn = __ldg(bh + 2 * H + col);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int li = half * kRowsPerThread + i;
      if (li < nrows) {
        const int lr = row0 + li;
        const float rg = sigmoidf_(pr[i] + b_r);
        const float zg = sigmoidf_(pz[i] + b_z);
        const float ng = tanhf(gn[i] + b_in + rg * (hn[i] + b_hn));
        const float hc = h_s[lr * H + col];
        dst[lr * H + col] = (1.0f - zg) * ng + zg * hc;
      }
    }
  }
}

// Gate backward, first half, on rows [row0, row0 + nrows): recompute the
// gates exactly as chunk_gate does, push the output cotangent g through
// them, and write the row's pre-activation cotangents
//   dp[lr] = [dpre_r | dpre_z | dpre_n | dpre_hn]   ([4H] a row)
// (dpre_i = [r|z|n], dpre_h = [r|z|hn]) and the direct carry cotangent
// dhc = g * z into dhc_dst. g may alias dhc_dst: each element is read and
// written by the same thread. Called by the whole block.
__device__ void chunk_gate_bwd_a(const float* x_s, const float* h_s,
                                 int row0, int nrows,
                                 const float* __restrict__ wi,
                                 const float* __restrict__ bi,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ bh, int H,
                                 const float* g, float* dp, float* dhc_dst,
                                 int tid) {
  const int col = tid & (kMaxH - 1), half = tid / kMaxH;
  const bool active = col < H;
  float pr[kRowsPerThread], pz[kRowsPerThread], gn[kRowsPerThread],
      hn[kRowsPerThread];
  if (active)
    gate_preacts(x_s, h_s, row0, nrows, wi, wh, H, col, half, pr, pz, gn, hn);
  if (active) {
    const float b_r = __ldg(bi + col) + __ldg(bh + col);
    const float b_z = __ldg(bi + H + col) + __ldg(bh + H + col);
    const float b_in = __ldg(bi + 2 * H + col);
    const float b_hn = __ldg(bh + 2 * H + col);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int li = half * kRowsPerThread + i;
      if (li < nrows) {
        const int lr = row0 + li;
        const float rg = sigmoidf_(pr[i] + b_r);
        const float zg = sigmoidf_(pz[i] + b_z);
        const float pre_hn = hn[i] + b_hn;
        const float ng = tanhf(gn[i] + b_in + rg * pre_hn);
        const float hc = h_s[lr * H + col];
        const float gv = g[lr * H + col];
        const float dz = gv * (hc - ng);
        const float dn = gv * (1.0f - zg);
        const float dpre_n = dn * (1.0f - ng * ng);
        const float drg = dpre_n * pre_hn;
        float* dprow = dp + static_cast<size_t>(lr) * 4 * H;
        dprow[col] = drg * rg * (1.0f - rg);
        dprow[H + col] = dz * zg * (1.0f - zg);
        dprow[2 * H + col] = dpre_n;
        dprow[3 * H + col] = dpre_n * rg;
        dhc_dst[lr * H + col] = gv * zg;
      }
    }
  }
}

// Gate backward, second half, on rows [row0, row0 + nrows): with dp from
// chunk_gate_bwd_a (visible to the block after a __syncthreads),
//   dx[lr]  = dpre_i[lr] @ wi^T          -> dx_dst
//   dh[lr] += dpre_h[lr] @ wh^T          (dh holds dhc: dhl = dhc + ...)
// wiT, whT are the transposed packed gate kernels, [3H, H]. dp is read
// with plain loads (it was written in this launch). Called by the whole
// block.
__device__ void chunk_gate_bwd_b(const float* dp, int row0, int nrows,
                                 const float* __restrict__ wiT,
                                 const float* __restrict__ whT, int H,
                                 float* dx_dst, float* dh, int tid) {
  const int col = tid & (kMaxH - 1), half = tid / kMaxH;
  if (col >= H) return;
  const int H2 = 2 * H, H3 = 3 * H;
  float ax[kRowsPerThread], ah[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) ax[i] = ah[i] = 0.f;
  for (int j = 0; j < H3; j += 4) {
    float wi4[4], wh4[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      wi4[jj] = __ldg(wiT + (j + jj) * H + col);
      wh4[jj] = __ldg(whT + (j + jj) * H + col);
    }
    // dpre_h equals dpre_i on the r|z columns; its n block is dpre_hn,
    // stored H columns further on.
    const int jh = j < H2 ? j : j + H;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int li = half * kRowsPerThread + i;
      if (li < nrows) {
        const float* dprow = dp + static_cast<size_t>(row0 + li) * 4 * H;
        const float4 di = *reinterpret_cast<const float4*>(dprow + j);
        const float4 dh4 = *reinterpret_cast<const float4*>(dprow + jh);
        ax[i] = fmaf(di.x, wi4[0], ax[i]);
        ax[i] = fmaf(di.y, wi4[1], ax[i]);
        ax[i] = fmaf(di.z, wi4[2], ax[i]);
        ax[i] = fmaf(di.w, wi4[3], ax[i]);
        ah[i] = fmaf(dh4.x, wh4[0], ah[i]);
        ah[i] = fmaf(dh4.y, wh4[1], ah[i]);
        ah[i] = fmaf(dh4.z, wh4[2], ah[i]);
        ah[i] = fmaf(dh4.w, wh4[3], ah[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int li = half * kRowsPerThread + i;
    if (li < nrows) {
      const int lr = row0 + li;
      dx_dst[lr * H + col] = ax[i];
      dh[lr * H + col] = dh[lr * H + col] + ah[i];
    }
  }
}

// Edge-linear backward on rows [row0, row0 + nrows):
//   dh_dst[lr] = dhl[lr] + dmsg_s[lr] @ ek^T
// with ekT = ek^T ([H, H]). dhl may alias dh_dst (same thread per
// element). Called by the whole block.
__device__ void chunk_edge_bwd(const float* dmsg_s, int row0, int nrows,
                               const float* __restrict__ ekT, int H,
                               const float* dhl, float* dh_dst, int tid) {
  const int col = tid & (kMaxH - 1), half = tid / kMaxH;
  if (col >= H) return;
  float acc[kRowsPerThread];
  chunk_rows_times(dmsg_s, row0, nrows, ekT, H, col, half, acc);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int li = half * kRowsPerThread + i;
    if (li < nrows) {
      const int lr = row0 + li;
      dh_dst[lr * H + col] = dhl[lr * H + col] + acc[i];
    }
  }
}

}  // namespace
