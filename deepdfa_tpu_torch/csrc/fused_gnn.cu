// Gated graph step kernels for Hopper (sm_90a): the forward of the
// FlowGNN message pass, h' = GRU(A @ (h W_e + b_e), h), with the GRU's
// r|z|n gate weights packed as [H, 3H] (recurrent bias [0, 0, b_hn]).
//
// fused_step_kernel     replaces deepdfa_tpu/ops/fused_gnn.py:_fwd_kernel
//                       (launched from _run_fwd): one gated step.
// persistent_fwd_kernel replaces deepdfa_tpu/ops/fused_gnn.py:
//                       _persist_fwd_kernel (launched from
//                       _run_persistent_fwd, emit_hist=False): all K steps
//                       in one launch, h resident on chip.
//
// Plain PyTorch versions: fused_step_reference / persistent_reference in
// deepdfa_tpu_torch/ops/fused_gnn.py. Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file.
//
// What bounds them. One step at the serving bucket (N = 1024 rows,
// H = 128, tile 128, bandwidth 1) is ~0.24 GFLOP of dense f32 work
// ((A h) W_e, x W_i, h W_h) plus a sparse aggregate over ~700 stored
// nonzeros, against ~2.3 MB of compulsory traffic (h in and out, bf16
// band values, packed weights). At the H100 SXM data-sheet peaks for a
// 700 W card (67 TFLOP/s f32 without tensor cores, 3.35 TB/s) the
// arithmetic takes ~3.5 us and the bytes ~0.7 us: the kernels are bound
// by f32 operations (ops/fused_gnn.py:kernel_cost counts them;
// chip_smoke.py prints the bound beside the measured time and the
// card's name and power limit). f32 is held to the reference's
// Precision.HIGHEST, so TF32 tensor cores are out; every product is an
// f32 FMA on the CUDA cores.
//
// Design.
// * Messages by reassociation (route (b) of the port plan):
//   A (h W_e + 1 b_e^T) = (A h) W_e + rowsum(A) b_e^T. The TPU kernel
//   streamed a rolling window of message tiles through one sequential
//   grid; here blocks run in parallel and a block owning a few receiver
//   rows would otherwise recompute the messages of its whole 2B+1 tile
//   window (3x the message FLOPs at B = 1). Aggregating h first costs no
//   extra FLOPs and no message buffer; it changes the f32 rounding order,
//   which the tests hold to 1e-5.
// * The aggregate skips zeros. A warp owns one receiver row: each lane
//   reads one band value per 32-wide slice (coalesced), a ballot finds
//   the nonzeros, and the warp adds those sender rows (128 floats, one
//   512-byte read) scaled by the shuffled value. Out-of-range sender
//   tiles are masked by index, as the TPU kernel masks them, not trusted
//   to hold zero blocks. CFG rows have a handful of in-edges, so this is
//   ~1% of the step's FLOPs.
// * The dense products run on 16-row chunks: thread (column c, half)
//   computes 8 rows of column c of x W_e, then of the r|z|n gates, with
//   the row operands read as float4 broadcasts from shared memory and the
//   weight columns read coalesced through L1 (all blocks read the same
//   460 KB of weights, which stay L2 resident).
// * Persistent: the TPU overwrote h rows in place along its sequential
//   grid. A Hopper block cannot see another block's rows mid-step, so the
//   host cuts the rows into groups that no edge crosses (whole graphs;
//   ops/band_spmm.py:closed_row_groups) and each block keeps its group's
//   h, and its aggregate, in shared memory for all K steps: h crosses
//   device memory once in and once out. A group needs (2H + 1) * 4 bytes
//   a row; ops/fused_gnn.py:persistent_smem_ok gates it against the
//   227 KB a block may opt into, and a batch over the gate runs
//   fused_step_kernel K times instead.
// * This is the simple version, and it runs far from the bound above:
//   PERF.md has the measured times and what a faster version changes
//   (weight slabs staged in shared memory, more rows per weight load,
//   large row groups spread over a thread-block cluster).

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
        const float* hs = hsrc + static_cast<size_t>(base + c0 + src - hbase) * H;
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

// In place on rows [row0, row0 + nrows) of a_s (nrows <= kChunk):
// a_s[r] <- a_s[r] @ ek + rs_s[r] * eb. Called by the whole block.
__device__ void chunk_edge_linear(float* a_s, const float* rs_s, int row0,
                                  int nrows, const float* __restrict__ ek,
                                  const float* __restrict__ eb, int H,
                                  int tid) {
  const int col = tid & (kMaxH - 1), half = tid / kMaxH;
  const bool active = col < H;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  if (active) {
    for (int k = 0; k < H; k += 4) {
      float w[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) w[kk] = __ldg(ek + (k + kk) * H + col);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int li = half * kRowsPerThread + i;
        if (li < nrows) {
          const float4 x =
              *reinterpret_cast<const float4*>(a_s + (row0 + li) * H + k);
          acc[i] = fmaf(x.x, w[0], acc[i]);
          acc[i] = fmaf(x.y, w[1], acc[i]);
          acc[i] = fmaf(x.z, w[2], acc[i]);
          acc[i] = fmaf(x.w, w[3], acc[i]);
        }
      }
    }
  }
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
  const int H3 = 3 * H;
  float pr[kRowsPerThread], pz[kRowsPerThread], gn[kRowsPerThread],
      hn[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) pr[i] = pz[i] = gn[i] = hn[i] = 0.f;
  if (active) {
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

template <typename VT>
__global__ void __launch_bounds__(kThreads)
    fused_step_kernel(const float* __restrict__ h,
                      const VT* __restrict__ vals,
                      const float* __restrict__ ek,
                      const float* __restrict__ eb,
                      const float* __restrict__ wi,
                      const float* __restrict__ bi,
                      const float* __restrict__ wh,
                      const float* __restrict__ bh, float* __restrict__ out,
                      int n_rows, int H, int tile, int n_tiles, int bw) {
  __shared__ __align__(16) float h_s[kChunk * kMaxH];
  __shared__ __align__(16) float a_s[kChunk * kMaxH];
  __shared__ float rs_s[kChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * kChunk;
  const int nrows = min(kChunk, n_rows - r0);
  const float* h_blk = h + static_cast<size_t>(r0) * H;
  for (int i = tid; i < nrows * H; i += kThreads) h_s[i] = h_blk[i];
  for (int lr = warp; lr < nrows; lr += kWarps)
    warp_aggregate_row(vals, r0 + lr, tile, n_tiles, bw, h, 0, 0, n_rows, H,
                       a_s + lr * H, rs_s + lr, lane);
  __syncthreads();
  chunk_edge_linear(a_s, rs_s, 0, nrows, ek, eb, H, tid);
  __syncthreads();
  chunk_gate(a_s, h_s, 0, nrows, wi, bi, wh, bh, H,
             out + static_cast<size_t>(r0) * H, tid);
}

template <typename VT>
__global__ void __launch_bounds__(kThreads)
    persistent_fwd_kernel(const float* __restrict__ h0,
                          const VT* __restrict__ vals,
                          const float* __restrict__ ek,
                          const float* __restrict__ eb,
                          const float* __restrict__ wi,
                          const float* __restrict__ bi,
                          const float* __restrict__ wh,
                          const float* __restrict__ bh,
                          const int* __restrict__ groups,
                          float* __restrict__ out, int H, int tile,
                          int n_tiles, int bw, int n_steps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = groups[blockIdx.x], g1 = groups[blockIdx.x + 1];
  const int R = g1 - g0;
  float* h_s = smem;           // [R, H] the resident hidden state
  float* a_s = smem + R * H;   // [R, H] aggregate, then x
  float* rs_s = a_s + R * H;   // [R] adjacency row sums
  const float* h_blk = h0 + static_cast<size_t>(g0) * H;
  for (int i = tid; i < R * H; i += kThreads) h_s[i] = h_blk[i];
  __syncthreads();
  for (int step = 0; step < n_steps; ++step) {
    for (int lr = warp; lr < R; lr += kWarps)
      warp_aggregate_row(vals, g0 + lr, tile, n_tiles, bw, h_s, g0, g0, g1,
                         H, a_s + lr * H, rs_s + lr, lane);
    __syncthreads();
    for (int c0 = 0; c0 < R; c0 += kChunk)
      chunk_edge_linear(a_s, rs_s, c0, min(kChunk, R - c0), ek, eb, H, tid);
    __syncthreads();
    for (int c0 = 0; c0 < R; c0 += kChunk)
      chunk_gate(a_s, h_s, c0, min(kChunk, R - c0), wi, bi, wh, bh, H, h_s,
                 tid);
    __syncthreads();
  }
  float* o_blk = out + static_cast<size_t>(g0) * H;
  for (int i = tid; i < R * H; i += kThreads) o_blk[i] = h_s[i];
}

template <typename VT>
int launch_fused(const void* h, const void* vals, const void* ek,
                 const void* eb, const void* wi, const void* bi,
                 const void* wh, const void* bh, void* out, int n_rows,
                 int hidden, int tile, int n_tiles, int bw,
                 cudaStream_t st) {
  const dim3 grid((n_rows + kChunk - 1) / kChunk);
  fused_step_kernel<VT><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(h), static_cast<const VT*>(vals),
      static_cast<const float*>(ek), static_cast<const float*>(eb),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<float*>(out), n_rows, hidden, tile, n_tiles, bw);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT>
int launch_persistent(const void* h0, const void* vals, const void* ek,
                      const void* eb, const void* wi, const void* bi,
                      const void* wh, const void* bh, const void* groups,
                      int n_groups, int max_group_rows, int n_steps,
                      void* out, int hidden, int tile, int n_tiles, int bw,
                      cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(max_group_rows) * (2 * hidden + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      persistent_fwd_kernel<VT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  persistent_fwd_kernel<VT><<<n_groups, kThreads, smem, st>>>(
      static_cast<const float*>(h0), static_cast<const VT*>(vals),
      static_cast<const float*>(ek), static_cast<const float*>(eb),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<const int*>(groups), static_cast<float*>(out), hidden, tile,
      n_tiles, bw, n_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One gated step over all n_rows = n_tiles * tile rows. vals is
// [2B+1, n_tiles, tile, tile] bf16 (vals_bf16 != 0) or f32; h, out
// [n_rows, hidden] f32 with hidden <= 128 and a multiple of 4.
// Returns the cudaError_t of the launch.
int fused_step_launch(const void* h, const void* vals, int vals_bf16,
                      const void* ek, const void* eb, const void* wi,
                      const void* bi, const void* wh, const void* bh,
                      void* out, int n_rows, int hidden, int tile,
                      int n_tiles, int bandwidth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_fused<__nv_bfloat16>(h, vals, ek, eb, wi, bi, wh, bh, out,
                                       n_rows, hidden, tile, n_tiles,
                                       bandwidth, st);
  return launch_fused<float>(h, vals, ek, eb, wi, bi, wh, bh, out, n_rows,
                             hidden, tile, n_tiles, bandwidth, st);
}

// n_steps gated steps in one launch: one block per row group
// groups[g]..groups[g+1] (int32, n_groups + 1 cut points, no edge crossing
// a cut), h resident in shared memory. max_group_rows sizes the dynamic
// shared memory ((2 * hidden + 1) * 4 bytes a row).
int persistent_fwd_launch(const void* h0, const void* vals, int vals_bf16,
                          const void* ek, const void* eb, const void* wi,
                          const void* bi, const void* wh, const void* bh,
                          const void* groups, int n_groups,
                          int max_group_rows, int n_steps, void* out,
                          int hidden, int tile, int n_tiles, int bandwidth,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_persistent<__nv_bfloat16>(
        h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
        n_steps, out, hidden, tile, n_tiles, bandwidth, st);
  return launch_persistent<float>(h0, vals, ek, eb, wi, bi, wh, bh, groups,
                                  n_groups, max_group_rows, n_steps, out,
                                  hidden, tile, n_tiles, bandwidth, st);
}

}  // extern "C"
