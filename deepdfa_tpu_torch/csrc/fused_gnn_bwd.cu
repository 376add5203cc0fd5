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
// gated_step.cuh.
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
// traffic a step: bound by f32 operations (67 TFLOP/s without tensor
// cores; TF32 is out, as the reference holds f32 to Precision.HIGHEST).
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
//   1: each block owns one 64 x 64 tile of one gradient (4 x 4 a thread)
//   and one 2048-row split of the rows, and writes the split's sum for
//   each step (32-row partial sums, in row order; the blocks of the first
//   row tile also sum the bias columns). Pass 2 adds, for every entry,
//   the splits in order into each step's sum and the steps from K-1 down
//   to 0 (the scan VJP's association). The order depends only on the row
//   count, so the gradients are deterministic and a K-step call equals
//   the fold of K one-step calls bit for bit; with it the persistent
//   backward equals the scan of fused_step_bwd_kernel.
// * A^T rows come from the block-band form of A^T
//   (ops/band_spmm.py:band_transpose_vals), read by the forward's own
//   warp-per-row aggregate.
// * The fused backward needs dx of neighbouring rows for A^T, which other
//   blocks compute, so it runs as two passes of the same kernel: pass 0
//   (gate backward; dx and dhl to device memory), pass 1 (dmsg = A^T dx,
//   dh = dhl + dmsg W_e^T).
// * Persistent: one block per closed row group (no edge leaves it, so
//   A^T does not either). The block keeps the group's cotangent dh, h_s,
//   the aggregate (then dmsg) and dx in shared memory, (4H + 1) * 4 bytes
//   a row, from step K-1 down to 0; h_s comes from the recompute sweep's
//   hist (persistent_fwd_hist_kernel) or h_0. ops/fused_gnn.py:
//   persistent_bwd_smem_ok gates it against 227 KB; a batch over the gate
//   runs fused_step_bwd_kernel K times instead.
// * This is the simple version: the same chunked CUDA-core products as
//   the forward, no tensor cores, no staging of weights.

#include "gated_step.cuh"

namespace {

// Pass 0: per 16-row chunk, recompute x, write x and the gate cotangents
// dp, then dx and dhl. Pass 1: dmsg = A^T dx (rows of the chunk), dh.
template <typename VT>
__global__ void __launch_bounds__(kThreads)
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
                          int tile, int n_tiles, int bw, int pass) {
  __shared__ __align__(16) float h_s[kChunk * kMaxH];
  __shared__ __align__(16) float a_s[kChunk * kMaxH];
  __shared__ __align__(16) float d_s[kChunk * kMaxH];
  __shared__ float rs_s[kChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kChunk;
  const int nrows = min(kChunk, n_rows - r0);
  const size_t off = static_cast<size_t>(r0) * H;
  if (pass == 0) {
    for (int i = tid; i < nrows * H; i += kThreads) h_s[i] = h[off + i];
    for (int lr = warp; lr < nrows; lr += kWarps)
      warp_aggregate_row(vals, r0 + lr, tile, n_tiles, bw, h, 0, 0, n_rows,
                         H, a_s + lr * H, rs_s + lr, lane);
    __syncthreads();
    chunk_edge_linear(a_s, rs_s, 0, nrows, ek, eb, H, tid);
    __syncthreads();
    for (int i = tid; i < nrows * H; i += kThreads) x_out[off + i] = a_s[i];
    chunk_gate_bwd_a(a_s, h_s, 0, nrows, wi, bi, wh, bh, H, g + off,
                     dp + 4 * off, d_s, tid);
    __syncthreads();  // dp (device memory) and dhc visible to the block
    chunk_gate_bwd_b(dp + 4 * off, 0, nrows, wiT, whT, H, dx + off, d_s,
                     tid);
    __syncthreads();
    for (int i = tid; i < nrows * H; i += kThreads) dhl[off + i] = d_s[i];
  } else {
    for (int lr = warp; lr < nrows; lr += kWarps)
      warp_aggregate_row(tvals, r0 + lr, tile, n_tiles, bw, dx, 0, 0,
                         n_rows, H, a_s + lr * H, rs_s + lr, lane);
    __syncthreads();
    for (int i = tid; i < nrows * H; i += kThreads) dmsg_out[off + i] = a_s[i];
    chunk_edge_bwd(a_s, 0, nrows, ekT, H, dhl + off, dh_out + off, tid);
  }
}

template <typename VT>
__global__ void __launch_bounds__(kThreads)
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
                          int n_steps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = groups[blockIdx.x], g1 = groups[blockIdx.x + 1];
  const int R = g1 - g0;
  float* dh_s = smem;            // [R, H] the resident cotangent
  float* h_s = dh_s + R * H;     // [R, H] h_s, the step's input
  float* a_s = h_s + R * H;      // [R, H] aggregate -> x, then dmsg
  float* dx_s = a_s + R * H;     // [R, H] dx
  float* rs_s = dx_s + R * H;    // [R] adjacency row sums
  const size_t goff = static_cast<size_t>(g0) * H;
  const size_t plane = static_cast<size_t>(n_rows) * H;
  for (int i = tid; i < R * H; i += kThreads) dh_s[i] = g[goff + i];
  for (int s = n_steps - 1; s >= 0; --s) {
    const float* src = s == 0 ? h0 : hist + (s - 1) * plane;
    for (int i = tid; i < R * H; i += kThreads) h_s[i] = src[goff + i];
    __syncthreads();
    for (int lr = warp; lr < R; lr += kWarps)
      warp_aggregate_row(vals, g0 + lr, tile, n_tiles, bw, h_s, g0, g0, g1,
                         H, a_s + lr * H, rs_s + lr, lane);
    __syncthreads();
    for (int c0 = 0; c0 < R; c0 += kChunk)
      chunk_edge_linear(a_s, rs_s, c0, min(kChunk, R - c0), ek, eb, H, tid);
    __syncthreads();
    float* x_step = xbuf + s * plane + goff;
    float* dp_step = dpbuf + 4 * (s * plane + goff);
    for (int i = tid; i < R * H; i += kThreads) x_step[i] = a_s[i];
    for (int c0 = 0; c0 < R; c0 += kChunk)
      chunk_gate_bwd_a(a_s, h_s, c0, min(kChunk, R - c0), wi, bi, wh, bh, H,
                       dh_s, dp_step, dh_s, tid);
    __syncthreads();
    for (int c0 = 0; c0 < R; c0 += kChunk)
      chunk_gate_bwd_b(dp_step, c0, min(kChunk, R - c0), wiT, whT, H, dx_s,
                       dh_s, tid);
    __syncthreads();
    for (int lr = warp; lr < R; lr += kWarps)
      warp_aggregate_row(tvals, g0 + lr, tile, n_tiles, bw, dx_s, g0, g0, g1,
                         H, a_s + lr * H, rs_s + lr, lane);
    __syncthreads();
    float* dmsg_step = dmsgbuf + s * plane + goff;
    for (int i = tid; i < R * H; i += kThreads) dmsg_step[i] = a_s[i];
    for (int c0 = 0; c0 < R; c0 += kChunk)
      chunk_edge_bwd(a_s, c0, min(kChunk, R - c0), ekT, H, dh_s, dh_s, tid);
    __syncthreads();
  }
  for (int i = tid; i < R * H; i += kThreads) dh_out[goff + i] = dh_s[i];
}

constexpr int kWTile = 64;      // output tile edge (4 x 4 a thread)
constexpr int kWSlab = 32;      // rows per partial sum

// Pass 1: one 64 x 64 tile of one weight gradient over one split of the
// rows (rows_per_split, a multiple of kWSlab, in order), for each step: partial[split][s][out] =
// sum over the split's rows of L_s[r, a] R_s[r, b]. Products: 0 dW_i
// (L = x, R = dpre_i), 1 dW_h (L = h, R = dpre_h), 2 dW_e (L = h, R =
// dmsg). Blocks with a0 == 0 also sum R's columns: the bias gradients.
// Rows add into 32-row partial sums, those into the split's sum.
__global__ void __launch_bounds__(kThreads)
    step_weight_grad_kernel(const float* __restrict__ h0,
                            const float* __restrict__ hist,
                            const float* __restrict__ xbuf,
                            const float* __restrict__ dpbuf,
                            const float* __restrict__ dmsgbuf,
                            float* __restrict__ partial, int n_rows, int H,
                            int n_steps, int rows_per_split) {
  __shared__ __align__(16) float l_s[kWSlab][kWTile];
  __shared__ __align__(16) float r_s[kWSlab][kWTile];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int tiles_a = (H + kWTile - 1) / kWTile;
  const int tiles_g = tiles_a * ((3 * H + kWTile - 1) / kWTile);
  int t = blockIdx.x, prod;
  if (t < tiles_g) {
    prod = 0;
  } else if (t < 2 * tiles_g) {
    prod = 1;
    t -= tiles_g;
  } else {
    prod = 2;
    t -= 2 * tiles_g;
  }
  const int width = prod == 2 ? H : 3 * H;
  const int a0 = (t % tiles_a) * kWTile, b0 = (t / tiles_a) * kWTile;
  const bool bias_block = a0 == 0;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n_rows, r_begin + rows_per_split);
  const size_t plane = static_cast<size_t>(n_rows) * H;
  const size_t n_out = 7 * static_cast<size_t>(H) * H + 7 * H;
  const size_t w_off = static_cast<size_t>(prod) * 3 * H * H;
  const size_t b_off = 7 * static_cast<size_t>(H) * H + prod * 3 * H;
  for (int s = 0; s < n_steps; ++s) {
    const float* hs = s == 0 ? h0 : hist + (s - 1) * plane;
    const float* L = prod == 0 ? xbuf + s * plane : hs;
    const float* Rm = prod == 2 ? dmsgbuf + s * plane : dpbuf + 4 * s * plane;
    const int rstride = prod == 2 ? H : 4 * H;
    float acc[4][4], bacc[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      bacc[u] = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    }
    for (int r0 = r_begin; r0 < r_end; r0 += kWSlab) {
      const int nr = min(kWSlab, r_end - r0);
      for (int i = tid; i < kWSlab * kWTile; i += kThreads) {
        const int rr = i / kWTile, c = i % kWTile;
        const int a = a0 + c, b = b0 + c;
        float lv = 0.f, rv = 0.f;
        if (rr < nr) {
          const size_t row = static_cast<size_t>(r0 + rr);
          if (a < H) lv = L[row * H + a];
          if (b < width) {
            // dpre_h's n block (prod 1) is dpre_hn, stored H columns on.
            const int bc = (prod == 1 && b >= 2 * H) ? b + H : b;
            rv = Rm[row * rstride + bc];
          }
        }
        l_s[rr][c] = lv;
        r_s[rr][c] = rv;
      }
      __syncthreads();
      float part[4][4], bpart[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bpart[u] = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) part[u][v] = 0.f;
      }
      for (int rr = 0; rr < nr; ++rr) {
        const float4 l4 = *reinterpret_cast<const float4*>(&l_s[rr][4 * ty]);
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[rr][4 * tx]);
        const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) part[u][v] = fmaf(lv[u], rv[v], part[u][v]);
        if (bias_block) {
#pragma unroll
          for (int v = 0; v < 4; ++v) bpart[v] += rv[v];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bacc[u] += bpart[u];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += part[u][v];
      }
      __syncthreads();
    }
    float* out = partial + (static_cast<size_t>(blockIdx.y) * n_steps + s) * n_out;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int b = b0 + 4 * tx + v;
      if (b >= width) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int a = a0 + 4 * ty + u;
        if (a < H) out[w_off + static_cast<size_t>(a) * width + b] = acc[u][v];
      }
      if (bias_block && ty == 0) out[b_off + b] = bacc[v];
    }
  }
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

template <typename VT>
int launch_fused_bwd(const void* h, const void* vals, const void* tvals,
                     const void* g, const void* ek, const void* eb,
                     const void* wi, const void* bi, const void* wh,
                     const void* bh, const void* wiT, const void* whT,
                     const void* ekT, void* x, void* dp, void* dx, void* dhl,
                     void* dmsg, void* dh, int n_rows, int hidden, int tile,
                     int n_tiles, int bw, cudaStream_t st) {
  const dim3 grid((n_rows + kChunk - 1) / kChunk);
  for (int pass = 0; pass < 2; ++pass) {
    fused_step_bwd_kernel<VT><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(h), static_cast<const VT*>(vals),
        static_cast<const VT*>(tvals), static_cast<const float*>(g),
        static_cast<const float*>(ek), static_cast<const float*>(eb),
        static_cast<const float*>(wi), static_cast<const float*>(bi),
        static_cast<const float*>(wh), static_cast<const float*>(bh),
        static_cast<const float*>(wiT), static_cast<const float*>(whT),
        static_cast<const float*>(ekT), static_cast<float*>(x),
        static_cast<float*>(dp), static_cast<float*>(dx),
        static_cast<float*>(dhl), static_cast<float*>(dmsg),
        static_cast<float*>(dh), n_rows, hidden, tile, n_tiles, bw, pass);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
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
  const size_t smem =
      static_cast<size_t>(max_group_rows) * (4 * hidden + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      persistent_bwd_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  persistent_bwd_kernel<VT><<<n_groups, kThreads, smem, st>>>(
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
      n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One step's backward over n_rows = n_tiles * tile rows (two launches of
// fused_step_bwd_kernel). vals/tvals: A and A^T in block-band form, bf16
// (vals_bf16 != 0) or f32; h, g, x, dx, dhl, dmsg, dh [n_rows, hidden]
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
  if (rows_per_split <= 0 || rows_per_split % kWSlab) return 1;  // invalid value
  const int tiles_a = (hidden + kWTile - 1) / kWTile;
  const dim3 grid(tiles_a * (2 * ((3 * hidden + kWTile - 1) / kWTile) +
                             (hidden + kWTile - 1) / kWTile),
                  (n_rows + rows_per_split - 1) / rows_per_split);
  step_weight_grad_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(h0), static_cast<const float*>(hist),
      static_cast<const float*>(x), static_cast<const float*>(dp),
      static_cast<const float*>(dmsg), static_cast<float*>(partial), n_rows,
      hidden, n_steps, rows_per_split);
  cudaError_t e = cudaGetLastError();
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

}  // extern "C"
