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
// persistent_fwd_hist_kernel (the kHist instance of persistent_fwd_kernel)
//                       replaces its emit_hist=True variant: K - 1 steps
//                       from h_0, writing h_1..h_{K-1} for the backward.
//
// The device functions they share with the backward kernels
// (fused_gnn_bwd.cu) are in gated_step.cuh.
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
// * The aggregate skips zeros. A warp owns one receiver row: its lanes
//   read 16 bytes each of the row's band window (a 128-sender tile of f32
//   values in one load), a ballot finds the lanes holding a nonzero, and
//   the warp adds those sender rows (128 floats, one 512-byte read)
//   scaled by the broadcast value, in ascending sender order. A warp
//   stages its rows' windows into shared memory by cp.async four rows
//   ahead of the one it scans. Out-of-range sender tiles are masked by
//   index, as the TPU kernel masks them, not trusted to hold zero blocks.
//   CFG rows have a handful of in-edges, so this is ~1% of the step's
//   FLOPs, but a scan of every row's window: 15 % of fused_step_kernel's
//   time at the training batch on an H100 (PERF.md).
// * fused_step_kernel gives each block a fixed tile of rows, with no gate: its
//   shared memory never grows with a graph, so it serves every batch the
//   persistent kernel's gate turns away. The tile's h and aggregate sit in
//   shared memory; the tile's senders are read there, the halo's from h. The
//   products are group_step.cuh's, the weights streamed in slabs by cp.async.
//   At the training and flagship batches (ops/fused_gnn.py: step_plan) a block
//   owns 64 rows, one block an SM, and a thread 8 rows by 4 columns (128 gate
//   accumulators, wide_gate): each loaded weight feeds 8 rows and the rows'
//   offsets are compile-time, so the gate's inner loop is 86 % FFMA; on an H100
//   it still issues at about half the FFMA rate (PERF.md says what was tried).
//   At the serving bucket (1024 rows, too few tiles for 132 SMs) two blocks of
//   a cluster share a 16-row tile, each owning half the product columns, x
//   crossing through distributed shared memory, as the persistent kernel's
//   clusters do.
// * Persistent: the TPU overwrote h rows in place along its sequential
//   grid. A Hopper block cannot see another block's rows mid-step, so the
//   host cuts the rows into groups that no edge crosses (whole graphs;
//   ops/band_spmm.py:closed_row_groups, 32 rows aimed for) and each block
//   keeps its group's h, and its aggregate, in shared memory for all K
//   steps: h crosses device memory once in and once out. The same bound
//   holds (f32 operations: 0.28 ms for 5 steps at the training batch,
//   N = 16384), and the simple kernel of the first port ran at 18 % of it:
//   every 16-row chunk re-read all 460 KB of weights from L2 with one
//   weight column and 8 rows a thread. This one (group_step.cuh) register
//   tiles the products (4 rows x 4 columns a thread, 32 rows a pass at
//   H 128, operands as float4), streams the weights through shared memory
//   in slabs by cp.async (three stages in flight, each slab crossing L2
//   once a pass), scans each row's senders within its group only, and
//   fits two blocks an SM (128 registers, 87,744 bytes of shared memory
//   for groups of 48 rows; ops/fused_gnn.py:persistent_smem_ok gates the
//   largest group against 227 KB, and a batch over the gate runs
//   fused_step_kernel K times instead). Where the groups are fewer than
//   the SMs (the serving bucket: 34 groups), kCS blocks of a thread-block
//   cluster share a group (ops/fused_gnn.py:persistent_cluster_size): each
//   owns 1/kCS of the product columns, and its x and h' slices reach the
//   other blocks' shared memory through distributed shared memory between
//   cluster barriers. Every element keeps fused_step_kernel's chain of
//   FMAs, so K steps here equal K fused_step_kernel launches bit for bit.
//   PERF.md has the measured times.

#include "group_step.cuh"

namespace {

// kHist = false: h_K into out. kHist = true (the backward's recompute
// sweep, replacing _persist_fwd_kernel's emit_hist variant): after each
// of the n_steps steps the group's h_{k+1} goes to hist[k] ([n_steps,
// n_rows, H]) and out is not written. Both instances run the same step
// code, so hist[k] equals persistent_fwd_kernel's h after k + 1 steps bit
// for bit. kCS blocks (a thread-block cluster) a row group, each owning
// 1/kCS of the product columns. Shared memory: kStages weight-slab
// stages, then [max_rows, ld] arrays: h_s (the resident h, all columns)
// and a_s (the aggregate; with kCS == 1 the edge linear turns it into x
// in place), and with kCS > 1 x_s (every block's x slice lands there
// while a_s is still read; a_s then holds the block's h' slice until
// every block's gate has read h_s); then the row sums.
template <typename VT, bool kHist, int kCS>
__global__ void __launch_bounds__(kGroupThreads, 2)
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
                          int n_tiles, int bw, int n_steps, int n_rows,
                          int max_rows) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  const int grp = blockIdx.x / kCS;
  const int rank = kCS > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                           : 0;
  const Tile t(H, rank, kCS);
  const int g0 = groups[grp], g1 = groups[grp + 1];
  const int R = g1 - g0, ld = t.ld, hi = min(t.hi, H);
  float* stages = smem;                                   // [kStages][stage]
  float* h_s = stages + kStages * group_stage_floats(H);  // [R, ld] h
  float* a_s = h_s + max_rows * ld;                       // [R, ld] agg (x)
  float* x_s = kCS > 1 ? a_s + max_rows * ld : a_s;       // [R, ld] x
  float* rs_s = x_s + max_rows * ld;                      // [R] row sums
  // The cluster's copies of x_s and h_s (distributed shared memory).
  float* x_at[kCS];
  float* h_at[kCS];
  if constexpr (kCS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int c = 0; c < kCS; ++c) {
      x_at[c] = cluster.map_shared_rank(x_s, c);
      h_at[c] = cluster.map_shared_rank(h_s, c);
    }
  }
  const size_t goff = static_cast<size_t>(g0) * H;
  rows_to_shared(h_s, ld, h0 + goff, R, H);
  __syncthreads();
  // Every block of the cluster has started before any writes another's
  // shared memory (the first step's x slices).
  if constexpr (kCS > 1) cg::this_cluster().sync();
  for (int step = 0; step < n_steps; ++step) {
    group_aggregate(vals, tile, n_tiles, bw, h_s, ld, g0, g1, H, a_s, rs_s);
    __syncthreads();
    group_rows_times<(kCS > 1)>(t, a_s, R, ek, stages, [&](int r,
                                                           const float* acc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = r * ld + t.c0 + j;
        const float x = edge_out(acc[j], rs_s[r], __ldg(eb + t.c0 + j));
        if constexpr (kCS == 1) {
          x_s[e] = x;
        } else {
#pragma unroll
          for (int c = 0; c < kCS; ++c) x_at[c][e] = x;
        }
      }
    });
    if constexpr (kCS > 1) cg::this_cluster().sync();  // every x slice in
    float* hn_s = kCS > 1 ? a_s : h_s;
    group_gate<(kCS > 1)>(t, x_s, h_s, R, wi, wh, stages,
               [&](int r, const float* pr, const float* pz, const float* gn,
                   const float* hn) {
#pragma unroll
                 for (int j = 0; j < 4; ++j) {
                   const int e = r * ld + t.c0 + j;
                   hn_s[e] = gate_out(pr[j], pz[j], gn[j], hn[j],
                                      gate_bias(bi, bh, H, t.c0 + j), h_s[e]);
                 }
               });
    if constexpr (kCS > 1) {
      cg::this_cluster().sync();  // every block's gate has read h_s
      const int q = (hi - t.lo) / 4;
      for (int e = threadIdx.x; e < R * q; e += kGroupThreads) {
        const int i = (e / q) * ld + t.lo + 4 * (e % q);
        const float4 v = *reinterpret_cast<const float4*>(a_s + i);
#pragma unroll
        for (int c = 0; c < kCS; ++c)
          *reinterpret_cast<float4*>(h_at[c] + i) = v;
      }
      cg::this_cluster().sync();  // every h' slice in
    }
    if (kHist)
      rows_to_global(out + (static_cast<size_t>(step) * n_rows + g0) * H,
                     h_s, ld, R, H, t.lo, hi);
  }
  if (!kHist) rows_to_global(out + goff, h_s, ld, R, H, t.lo, hi);
}

// Dynamic shared memory of persistent_fwd_kernel for groups of up to
// max_rows rows, cluster blocks a group (ops/fused_gnn.py:
// persistent_smem_bytes mirrors it).
size_t persistent_fwd_smem(int max_rows, int hidden, int cluster) {
  return sizeof(float) *
         (kStages * static_cast<size_t>(group_stage_floats(hidden)) +
          (cluster > 1 ? 3 : 2) * static_cast<size_t>(max_rows) *
              group_ld(hidden) +
          max_rows);
}

// A launch of grid blocks in clusters of cs blocks; attr holds the
// cluster dimension the config points at.
cudaLaunchConfig_t cluster_config(int grid, int cs, size_t smem,
                                  cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kGroupThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename VT, bool kHist, int kCS>
int launch_persistent_cs(const void* h0, const void* vals, const void* ek,
                         const void* eb, const void* wi, const void* bi,
                         const void* wh, const void* bh, const void* groups,
                         int n_groups, int max_group_rows, int n_steps,
                         void* out, int hidden, int tile, int n_tiles, int bw,
                         cudaStream_t st) {
  const size_t smem = persistent_fwd_smem(max_group_rows, hidden, kCS);
  cudaError_t e = cudaFuncSetAttribute(
      persistent_fwd_kernel<VT, kHist, kCS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (kCS == 1) {
    persistent_fwd_kernel<VT, kHist, 1><<<n_groups, kGroupThreads, smem, st>>>(
        static_cast<const float*>(h0), static_cast<const VT*>(vals),
        static_cast<const float*>(ek), static_cast<const float*>(eb),
        static_cast<const float*>(wi), static_cast<const float*>(bi),
        static_cast<const float*>(wh), static_cast<const float*>(bh),
        static_cast<const int*>(groups), static_cast<float*>(out), hidden,
        tile, n_tiles, bw, n_steps, n_tiles * tile, max_group_rows);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(n_groups * kCS, kCS, smem, st, &attr);
  e = cudaLaunchKernelEx(
      &cfg, persistent_fwd_kernel<VT, kHist, kCS>,
      static_cast<const float*>(h0), static_cast<const VT*>(vals),
      static_cast<const float*>(ek), static_cast<const float*>(eb),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<const int*>(groups), static_cast<float*>(out), hidden, tile,
      n_tiles, bw, n_steps, n_tiles * tile, max_group_rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT, bool kHist>
int launch_persistent(const void* h0, const void* vals, const void* ek,
                      const void* eb, const void* wi, const void* bi,
                      const void* wh, const void* bh, const void* groups,
                      int n_groups, int max_group_rows, int n_steps,
                      int cluster, void* out, int hidden, int tile,
                      int n_tiles, int bw, cudaStream_t st) {
  switch (cluster) {
    case 1:
      return launch_persistent_cs<VT, kHist, 1>(
          h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
          n_steps, out, hidden, tile, n_tiles, bw, st);
    case 2:
      return launch_persistent_cs<VT, kHist, 2>(
          h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
          n_steps, out, hidden, tile, n_tiles, bw, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One gated step over a fixed tile of row_tile rows a block. kWide (kCS == 1, H
// > 64): the wide products (kWideRows rows a thread, one block an SM). Else the
// 4 x 4 tiles (two blocks an SM); with kCS == 2 two blocks of a thread-block
// cluster share a tile, each owning half the product columns, and each block's
// x slice reaches its partner's shared memory through distributed shared
// memory. Shared memory: kStages weight-slab stages of kGR k rows, then
// [row_tile, ld] arrays: h_s (the tile's h, all columns) and a_s (the
// aggregate; with kCS == 1 the edge linear turns it into x in place), with kCS
// > 1 x_s (every x slice lands there while a_s is still read); then the row
// sums. The aggregate reads the tile's senders from h_s and the halo's from h;
// h' goes straight to out.
template <typename VT, int kCS, int kGR, bool kWide>
__global__ void __launch_bounds__(kGroupThreads, kWide ? 1 : 2)
    fused_step_kernel(const float* __restrict__ h,
                      const VT* __restrict__ vals,
                      const float* __restrict__ ek,
                      const float* __restrict__ eb,
                      const float* __restrict__ wi,
                      const float* __restrict__ bi,
                      const float* __restrict__ wh,
                      const float* __restrict__ bh, float* __restrict__ out,
                      int n_rows, int H, int tile, int n_tiles, int bw,
                      int row_tile) {
  namespace cg = cooperative_groups;
  static_assert(kCS == 1 || kCS == 2, "one block or a pair a tile");
  static_assert(!kWide || kCS == 1, "the wide products own every column");
  extern __shared__ __align__(16) float smem[];
  const int rank = kCS > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                           : 0;
  const Tile t(H, rank, kCS);
  const int r0 = (blockIdx.x / kCS) * row_tile;
  const int R = min(row_tile, n_rows - r0), ld = t.ld;
  float* stages = smem;  // [kStages][stage]
  float* h_s = stages + kStages * group_stage_floats<kGR>(H);  // [R, ld] h
  float* a_s = h_s + row_tile * ld;                  // [R, ld] agg (x)
  float* x_s = kCS > 1 ? a_s + row_tile * ld : a_s;  // [R, ld] x
  float* rs_s = x_s + row_tile * ld;                 // [R] row sums
  // The partner's x_s (distributed shared memory).
  float* x_peer = x_s;
  if constexpr (kCS > 1)
    x_peer = cg::this_cluster().map_shared_rank(x_s, rank ^ 1);
  const size_t off = static_cast<size_t>(r0) * H;
  rows_to_shared(h_s, ld, h + off, R, H);
  __syncthreads();
  tile_aggregate(vals, tile, n_tiles, bw, h, h_s, r0, R, ld, H, a_s, rs_s,
                 stages, kStages * group_stage_floats<kGR>(H));
  // Every block of the cluster has started before any writes another's
  // shared memory.
  if constexpr (kCS > 1) cg::this_cluster().sync();
  const auto edge = [&](int r, const float* acc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = r * ld + t.c0 + j;
      const float x = edge_out(acc[j], rs_s[r], __ldg(eb + t.c0 + j));
      x_s[e] = x;
      if constexpr (kCS > 1) x_peer[e] = x;
    }
  };
  float* dst = out + off;
  const auto gate = [&](int r, const float* pr, const float* pz,
                        const float* gn, const float* hn) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = gate_out(pr[j], pz[j], gn[j], hn[j],
                      gate_bias(bi, bh, H, t.c0 + j), h_s[r * ld + t.c0 + j]);
    *reinterpret_cast<float4*>(dst + r * H + t.c0) =
        make_float4(v[0], v[1], v[2], v[3]);
  };
  if constexpr (kWide) {
    wide_rows_times<kGR>(t, a_s, R, ek, stages, edge);
    wide_gate<kGR>(t, x_s, h_s, R, wi, wh, stages, gate);
  } else if constexpr (kCS == 1) {
    group_rows_times<false, kGR>(t, a_s, R, ek, stages, edge);
    group_gate<false, kGR>(t, x_s, h_s, R, wi, wh, stages, gate);
  } else {
    group_rows_times<true, kGR>(t, a_s, R, ek, stages, edge);
    // Every x slice in; no block touches another's shared memory after
    // this.
    cg::this_cluster().sync();
    group_gate<true, kGR>(t, x_s, h_s, R, wi, wh, stages, gate);
  }
}

// Dynamic shared memory of fused_step_kernel<., cluster, slab_rows> for
// tiles of row_tile rows (ops/fused_gnn.py:step_smem_bytes mirrors it).
size_t step_fwd_smem(int row_tile, int hidden, int cluster, int slab_rows) {
  return sizeof(float) *
         (kStages * static_cast<size_t>(slab_rows) * 6 * group_hp(hidden) +
          (cluster > 1 ? 3 : 2) * static_cast<size_t>(row_tile) *
              group_ld(hidden) +
          row_tile);
}

// The per-step forward's cut of n_rows rows on a card of sms SMs
// (ops/fused_gnn.py:step_plan mirrors it). Where 32-row tiles already make
// sms blocks, 64-row tiles, one block each: at H > 64 the wide products
// (one block an SM, gate slabs of 16 k rows where 16 divides H, else 4),
// else the 4 x 4 ones (slabs of 4). Else (the serving bucket) 2-block
// clusters over 16-row tiles split the product columns (while hp / 2 >=
// 32): slabs of 8 k rows where 8 divides H, else 4, two blocks an SM.
struct StepPlan {
  int row_tile, cluster, slab_rows, blocks;
  bool wide;
};

StepPlan step_fwd_plan(int n_rows, int hidden, int sms) {
  if ((n_rows + 31) / 32 >= sms || group_hp(hidden) / 2 < 32) {
    const bool wide = group_hp(hidden) == 128;
    return {kWideTile, 1, wide && hidden % 16 == 0 ? 16 : 4,
            (n_rows + kWideTile - 1) / kWideTile, wide};
  }
  return {16, 2, hidden % 8 == 0 ? 8 : 4, (n_rows + 15) / 16 * 2, false};
}

// Launches (occupancy == nullptr) or queries the occupancy of the
// instance of fused_step_kernel that plan p runs.
template <typename VT, int kCS, int kGR, bool kWide>
int step_instance(const void* h, const void* vals, const void* ek,
                  const void* eb, const void* wi, const void* bi,
                  const void* wh, const void* bh, void* out, int n_rows,
                  int hidden, int tile, int n_tiles, int bw,
                  const StepPlan& p, cudaStream_t st, int* occupancy) {
  const auto kernel = fused_step_kernel<VT, kCS, kGR, kWide>;
  const size_t smem = step_fwd_smem(p.row_tile, hidden, kCS, kGR);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occupancy)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, kernel, kGroupThreads, smem));
  if (kCS == 1) {
    kernel<<<p.blocks, kGroupThreads, smem, st>>>(
        static_cast<const float*>(h), static_cast<const VT*>(vals),
        static_cast<const float*>(ek), static_cast<const float*>(eb),
        static_cast<const float*>(wi), static_cast<const float*>(bi),
        static_cast<const float*>(wh), static_cast<const float*>(bh),
        static_cast<float*>(out), n_rows, hidden, tile, n_tiles, bw,
        p.row_tile);
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(p.blocks, kCS, smem, st, &attr);
    e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const float*>(h),
        static_cast<const VT*>(vals), static_cast<const float*>(ek),
        static_cast<const float*>(eb), static_cast<const float*>(wi),
        static_cast<const float*>(bi), static_cast<const float*>(wh),
        static_cast<const float*>(bh), static_cast<float*>(out), n_rows,
        hidden, tile, n_tiles, bw, p.row_tile);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// One step with the instance that step_fwd_plan picks for n_rows rows on
// this device (or that instance's occupancy query).
template <typename VT>
int launch_step(const void* h, const void* vals, const void* ek,
                const void* eb, const void* wi, const void* bi, const void* wh,
                const void* bh, void* out, int n_rows, int hidden, int tile,
                int n_tiles, int bw, cudaStream_t st,
                int* occupancy = nullptr) {
  const StepPlan p = step_fwd_plan(n_rows, hidden, device_sms());
#define STEP_INSTANCE(CS, GR, WIDE)                                         \
  return step_instance<VT, CS, GR, WIDE>(h, vals, ek, eb, wi, bi, wh, bh,   \
                                         out, n_rows, hidden, tile, n_tiles, \
                                         bw, p, st, occupancy)
  if (p.wide) {
    if (p.slab_rows == 16) STEP_INSTANCE(1, 16, true);
    STEP_INSTANCE(1, 4, true);
  }
  if (p.cluster == 1) STEP_INSTANCE(1, 4, false);
  if (p.slab_rows == 8) STEP_INSTANCE(2, 8, false);
  STEP_INSTANCE(2, 4, false);
#undef STEP_INSTANCE
}

template <typename VT, int kCS>
int fwd_occupancy(int max_group_rows, int hidden, int* blocks,
                  int* clusters) {
  const size_t smem = persistent_fwd_smem(max_group_rows, hidden, kCS);
  cudaError_t e = cudaFuncSetAttribute(
      persistent_fwd_kernel<VT, false, kCS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, persistent_fwd_kernel<VT, false, kCS>, kGroupThreads, smem);
  if (e == cudaSuccess && kCS > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(kCS, kCS, smem, 0, &attr);
    e = cudaOccupancyMaxActiveClusters(
        clusters, persistent_fwd_kernel<VT, false, kCS>, &cfg);
  }
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// The bf16 instances: FlowGNN(dtype="bfloat16"), serving
// ---------------------------------------------------------------------------
//
// fused_step_kernel_bf16     replaces _fwd_kernel at dt = bfloat16 (the
//                            same Pallas kernel, generic over the dtype).
// persistent_fwd_kernel_bf16 replaces _persist_fwd_kernel at dt = bfloat16
//                            (emit_hist=False).
// persistent_fwd_hist_kernel_bf16 (the kHist instance of
//                            persistent_fwd_kernel_bf16) replaces its
//                            emit_hist=True variant at bf16: the bf16
//                            backward's recompute sweep h_1..h_{K-1}.
//
// Unlike the f32 kernels, the reference rounds inside the step at bf16
// (gated_step.cuh: edge_msg_bf16, gate_out_bf16): the message h W_e + b_e
// is rounded to bf16 before it is aggregated when the band values are bf16,
// so the f32 kernels' reassociation (aggregate h first) would skip a
// rounding point. These instances compute each sender's message first,
// aggregate the messages (f32 sums, the same sender order as the f32
// kernels) and round the aggregate, then run the gate with the input and
// recurrent products apart (group_gate_split: each rounds before its bias).
// h is read and written as bf16; inside, every row array holds f32 (bf16
// values widened, exact) and the weights arrive as f32 arrays of bf16
// values (rounded once on the host, ops/fused_gnn.py:packed_weights). The
// products stay the f32 kernels' register-tiled SIMT FMAs, so the bound is
// theirs: f32 operations (kernel_cost counts the products of two bf16
// values at the bf16 tensor-core rate, the bound of the function, which
// these instances do not reach). The 96 gate accumulators a thread hold
// one block an SM.
//
// fused_step_kernel_bf16 runs in two passes over the same row tiles as
// fused_step_kernel (step_fwd_plan; a tile's kCS blocks split the product
// columns without a cluster: they share no shared memory): pass 0 writes
// every row's message into msg ([n_rows, H] f32) in device memory, since a
// tile's halo rows belong to other blocks; pass 1 stages the tile's h and
// messages in shared memory, aggregates (tile senders from there, the
// halo's from msg), rounds x and runs the gate. persistent_fwd_kernel_bf16
// keeps its group's h, messages and x in shared memory for all K steps
// (three row arrays, one more than the f32 kernel without a cluster:
// ops/fused_gnn.py:persistent_smem_bytes), the cluster exchanging message
// slices and h' slices as the f32 kernel exchanges x and h'. Both run the
// same device functions in the same order per element, so K steps of the
// persistent kernel equal K launches of the fused one bit for bit.

// Pass 0: msg[r] = edge_msg_bf16((h W_e)[r]); pass 1: the aggregate of the
// messages, rounded, and the gate; h' into out.
template <typename VT, int kPass, int kCS>
__global__ void __launch_bounds__(kGroupThreads, 1)
    fused_step_kernel_bf16(const __nv_bfloat16* __restrict__ h,
                           const VT* __restrict__ vals,
                           const float* __restrict__ ek,
                           const float* __restrict__ eb,
                           const float* __restrict__ wi,
                           const float* __restrict__ bi,
                           const float* __restrict__ wh,
                           const float* __restrict__ bh,
                           float* __restrict__ msg,
                           __nv_bfloat16* __restrict__ out, int n_rows, int H,
                           int tile, int n_tiles, int bw, int row_tile) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kRoundMsg = sizeof(VT) == 2;
  const int rank = static_cast<int>(blockIdx.x) % kCS;
  const Tile t(H, rank, kCS);
  const int r0 = (blockIdx.x / kCS) * row_tile;
  const int R = min(row_tile, n_rows - r0), ld = t.ld;
  float* stages = smem;  // [kStages][stage]
  float* h_s = stages + kStages * group_stage_floats(H);  // [R, ld] h
  const size_t off = static_cast<size_t>(r0) * H;
  rows_to_shared(h_s, ld, h + off, R, H);
  if constexpr (kPass == 0) {
    __syncthreads();
    float* dst = msg + off;
    group_rows_times<(kCS > 1)>(t, h_s, R, ek, stages,
                                [&](int r, const float* acc) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = edge_msg_bf16(acc[j], __ldg(eb + t.c0 + j), kRoundMsg);
      *reinterpret_cast<float4*>(dst + r * H + t.c0) =
          make_float4(v[0], v[1], v[2], v[3]);
    });
  } else {
    float* m_s = h_s + row_tile * ld;  // [R, ld] the tile's messages
    float* x_s = m_s + row_tile * ld;  // [R, ld] the aggregate, then x
    float* rs_s = x_s + row_tile * ld;  // [R] row sums (unused at bf16)
    rows_to_shared(m_s, ld, msg + off, R, H);
    __syncthreads();
    tile_aggregate(vals, tile, n_tiles, bw, msg, m_s, r0, R, ld, H, x_s, rs_s,
                   stages, kStages * group_stage_floats(H));
    for (int e = threadIdx.x; e < R * H; e += kGroupThreads) {
      const int i = (e / H) * ld + e % H;
      x_s[i] = round_bf16(x_s[i]);
    }
    __syncthreads();
    __nv_bfloat16* dst = out + off;
    group_gate_split<(kCS > 1)>(
        t, x_s, h_s, R, wi, wh, stages,
        [&](int r, const float* ir, const float* hr, const float* iz,
            const float* hz, const float* in, const float* hn) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = gate_out_bf16(ir[j], hr[j], iz[j], hz[j], in[j], hn[j],
                                 gate_bias_bf16(bi, bh, H, t.c0 + j),
                                 h_s[r * ld + t.c0 + j]);
          store_bf16x4(dst + r * H + t.c0, v[0], v[1], v[2], v[3]);
        });
  }
}

// Dynamic shared memory of fused_step_kernel_bf16's pass: the weight-slab
// stages, then the tile's h (pass 0), or its h, messages and x and the row
// sums (pass 1) (ops/fused_gnn.py:step_smem_bytes mirrors it).
size_t step_bf16_smem(int row_tile, int hidden, int pass) {
  return sizeof(float) *
         (kStages * static_cast<size_t>(group_stage_floats(hidden)) +
          (pass == 0 ? 1 : 3) * static_cast<size_t>(row_tile) *
              group_ld(hidden) +
          (pass == 0 ? 0 : row_tile));
}

// fused_step_kernel_bf16 takes fused_step_kernel's row tiles and blocks a
// tile, with slabs of kGateRows k rows and the 4 x 4 products everywhere.
StepPlan step_bf16_plan(int n_rows, int hidden, int sms) {
  StepPlan p = step_fwd_plan(n_rows, hidden, sms);
  p.slab_rows = kGateRows;
  p.wide = false;
  return p;
}

// Launches pass kPass (occupancy == nullptr) or queries its occupancy.
template <typename VT, int kPass, int kCS>
int step_bf16_pass(const void* h, const void* vals, const void* ek,
                   const void* eb, const void* wi, const void* bi,
                   const void* wh, const void* bh, void* msg, void* out,
                   int n_rows, int hidden, int tile, int n_tiles, int bw,
                   const StepPlan& p, cudaStream_t st, int* occupancy) {
  const auto kernel = fused_step_kernel_bf16<VT, kPass, kCS>;
  const size_t smem = step_bf16_smem(p.row_tile, hidden, kPass);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occupancy)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, kernel, kGroupThreads, smem));
  kernel<<<p.blocks, kGroupThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const VT*>(vals),
      static_cast<const float*>(ek), static_cast<const float*>(eb),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<float*>(msg), static_cast<__nv_bfloat16*>(out), n_rows,
      hidden, tile, n_tiles, bw, p.row_tile);
  return static_cast<int>(cudaGetLastError());
}

// Both passes of one step (occupancy: the two passes' blocks an SM).
template <typename VT, int kCS>
int launch_step_bf16_cs(const void* h, const void* vals, const void* ek,
                        const void* eb, const void* wi, const void* bi,
                        const void* wh, const void* bh, void* msg, void* out,
                        int n_rows, int hidden, int tile, int n_tiles, int bw,
                        const StepPlan& p, cudaStream_t st, int* occupancy) {
  int e = step_bf16_pass<VT, 0, kCS>(h, vals, ek, eb, wi, bi, wh, bh, msg,
                                      out, n_rows, hidden, tile, n_tiles, bw,
                                      p, st, occupancy);
  if (e != 0) return e;
  return step_bf16_pass<VT, 1, kCS>(h, vals, ek, eb, wi, bi, wh, bh, msg,
                                    out, n_rows, hidden, tile, n_tiles, bw, p,
                                    st, occupancy ? occupancy + 1 : nullptr);
}

template <typename VT>
int launch_step_bf16(const void* h, const void* vals, const void* ek,
                     const void* eb, const void* wi, const void* bi,
                     const void* wh, const void* bh, void* msg, void* out,
                     int n_rows, int hidden, int tile, int n_tiles, int bw,
                     cudaStream_t st, int* occupancy = nullptr) {
  const StepPlan p = step_bf16_plan(n_rows, hidden, device_sms());
  if (p.cluster == 1)
    return launch_step_bf16_cs<VT, 1>(h, vals, ek, eb, wi, bi, wh, bh, msg,
                                      out, n_rows, hidden, tile, n_tiles, bw,
                                      p, st, occupancy);
  return launch_step_bf16_cs<VT, 2>(h, vals, ek, eb, wi, bi, wh, bh, msg, out,
                                    n_rows, hidden, tile, n_tiles, bw, p, st,
                                    occupancy);
}

// K steps with the group resident: h_s (h), m_s (the messages; with kCS > 1
// every block's message slice lands there, and later the block's h' slice),
// x_s (the aggregate, then x), the row sums. kHist = true (the bf16
// backward's recompute sweep): after each of the n_steps steps each block
// writes its slice of the group's h_{k+1} (bf16) to hist[k] ([n_steps,
// n_rows, H]) and out is not written, as persistent_fwd_kernel's kHist
// instance; the step code is the same, so hist[k] equals this kernel's h
// after k + 1 steps bit for bit.
template <typename VT, bool kHist, int kCS>
__global__ void __launch_bounds__(kGroupThreads, 1)
    persistent_fwd_kernel_bf16(const __nv_bfloat16* __restrict__ h0,
                               const VT* __restrict__ vals,
                               const float* __restrict__ ek,
                               const float* __restrict__ eb,
                               const float* __restrict__ wi,
                               const float* __restrict__ bi,
                               const float* __restrict__ wh,
                               const float* __restrict__ bh,
                               const int* __restrict__ groups,
                               __nv_bfloat16* __restrict__ out, int H,
                               int tile, int n_tiles, int bw, int n_steps,
                               int n_rows, int max_rows) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  constexpr bool kRoundMsg = sizeof(VT) == 2;
  const int grp = blockIdx.x / kCS;
  const int rank = kCS > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                           : 0;
  const Tile t(H, rank, kCS);
  const int g0 = groups[grp], g1 = groups[grp + 1];
  const int R = g1 - g0, ld = t.ld, hi = min(t.hi, H);
  float* stages = smem;                                   // [kStages][stage]
  float* h_s = stages + kStages * group_stage_floats(H);  // [R, ld] h
  float* m_s = h_s + max_rows * ld;                       // [R, ld] messages
  float* x_s = m_s + max_rows * ld;                       // [R, ld] x
  float* rs_s = x_s + max_rows * ld;                      // [R] row sums
  // The cluster's copies of m_s and h_s (distributed shared memory).
  float* m_at[kCS];
  float* h_at[kCS];
  if constexpr (kCS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int c = 0; c < kCS; ++c) {
      m_at[c] = cluster.map_shared_rank(m_s, c);
      h_at[c] = cluster.map_shared_rank(h_s, c);
    }
  } else {
    m_at[0] = m_s;
    h_at[0] = h_s;
  }
  const size_t goff = static_cast<size_t>(g0) * H;
  rows_to_shared(h_s, ld, h0 + goff, R, H);
  __syncthreads();
  if constexpr (kCS > 1) cg::this_cluster().sync();
  for (int step = 0; step < n_steps; ++step) {
    group_rows_times<(kCS > 1)>(t, h_s, R, ek, stages, [&](int r,
                                                           const float* acc) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = r * ld + t.c0 + j;
        const float m =
            edge_msg_bf16(acc[j], __ldg(eb + t.c0 + j), kRoundMsg);
#pragma unroll
        for (int c = 0; c < kCS; ++c) m_at[c][e] = m;
      }
    });
    if constexpr (kCS > 1) cg::this_cluster().sync();  // every slice in
    group_aggregate(vals, tile, n_tiles, bw, m_s, ld, g0, g1, H, x_s, rs_s);
    __syncthreads();
    for (int e = threadIdx.x; e < R * H; e += kGroupThreads) {
      const int i = (e / H) * ld + e % H;
      x_s[i] = round_bf16(x_s[i]);
    }
    __syncthreads();
    float* hn_s = kCS > 1 ? m_s : h_s;
    group_gate_split<(kCS > 1)>(
        t, x_s, h_s, R, wi, wh, stages,
        [&](int r, const float* ir, const float* hr, const float* iz,
            const float* hz, const float* in, const float* hn) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = r * ld + t.c0 + j;
            hn_s[e] = gate_out_bf16(ir[j], hr[j], iz[j], hz[j], in[j], hn[j],
                                    gate_bias_bf16(bi, bh, H, t.c0 + j),
                                    h_s[e]);
          }
        });
    if constexpr (kCS > 1) {
      cg::this_cluster().sync();  // every block's gate has read h_s
      const int q = (hi - t.lo) / 4;
      for (int e = threadIdx.x; e < R * q; e += kGroupThreads) {
        const int i = (e / q) * ld + t.lo + 4 * (e % q);
        const float4 v = *reinterpret_cast<const float4*>(m_s + i);
#pragma unroll
        for (int c = 0; c < kCS; ++c)
          *reinterpret_cast<float4*>(h_at[c] + i) = v;
      }
      cg::this_cluster().sync();  // every h' slice in
    }
    if constexpr (kHist)
      rows_to_global(out + (static_cast<size_t>(step) * n_rows + g0) * H,
                     h_s, ld, R, H, t.lo, hi);
  }
  if constexpr (!kHist) rows_to_global(out + goff, h_s, ld, R, H, t.lo, hi);
}

template <typename VT, bool kHist, int kCS>
int persistent_bf16_instance(const void* h0, const void* vals, const void* ek,
                             const void* eb, const void* wi, const void* bi,
                             const void* wh, const void* bh,
                             const void* groups, int n_groups,
                             int max_group_rows, int n_steps, void* out,
                             int hidden, int tile, int n_tiles, int bw,
                             cudaStream_t st, int* blocks, int* clusters) {
  const auto kernel = persistent_fwd_kernel_bf16<VT, kHist, kCS>;
  // Three row arrays at any cluster size, as the f32 kernel's in a
  // cluster (ops/fused_gnn.py:persistent_smem_bytes mirrors it).
  const size_t smem = persistent_fwd_smem(max_group_rows, hidden, 2);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  if (blocks) {  // the occupancy query
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      kGroupThreads, smem);
    if (e == cudaSuccess && kCS > 1) {
      const cudaLaunchConfig_t cfg = cluster_config(kCS, kCS, smem, 0, &attr);
      e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    }
    return static_cast<int>(e);
  }
  if (kCS == 1) {
    kernel<<<n_groups, kGroupThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(h0), static_cast<const VT*>(vals),
        static_cast<const float*>(ek), static_cast<const float*>(eb),
        static_cast<const float*>(wi), static_cast<const float*>(bi),
        static_cast<const float*>(wh), static_cast<const float*>(bh),
        static_cast<const int*>(groups), static_cast<__nv_bfloat16*>(out),
        hidden, tile, n_tiles, bw, n_steps, n_tiles * tile, max_group_rows);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaLaunchConfig_t cfg =
      cluster_config(n_groups * kCS, kCS, smem, st, &attr);
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(h0),
      static_cast<const VT*>(vals), static_cast<const float*>(ek),
      static_cast<const float*>(eb), static_cast<const float*>(wi),
      static_cast<const float*>(bi), static_cast<const float*>(wh),
      static_cast<const float*>(bh), static_cast<const int*>(groups),
      static_cast<__nv_bfloat16*>(out), hidden, tile, n_tiles, bw, n_steps,
      n_tiles * tile, max_group_rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename VT, bool kHist>
int launch_persistent_bf16(const void* h0, const void* vals, const void* ek,
                           const void* eb, const void* wi, const void* bi,
                           const void* wh, const void* bh, const void* groups,
                           int n_groups, int max_group_rows, int n_steps,
                           int cluster, void* out, int hidden, int tile,
                           int n_tiles, int bw, cudaStream_t st,
                           int* blocks = nullptr, int* clusters = nullptr) {
  switch (cluster) {
    case 1:
      return persistent_bf16_instance<VT, kHist, 1>(
          h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
          n_steps, out, hidden, tile, n_tiles, bw, st, blocks, clusters);
    case 2:
      return persistent_bf16_instance<VT, kHist, 2>(
          h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
          n_steps, out, hidden, tile, n_tiles, bw, st, blocks, clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
    return launch_step<__nv_bfloat16>(h, vals, ek, eb, wi, bi, wh, bh, out,
                                      n_rows, hidden, tile, n_tiles,
                                      bandwidth, st);
  return launch_step<float>(h, vals, ek, eb, wi, bi, wh, bh, out, n_rows,
                            hidden, tile, n_tiles, bandwidth, st);
}

// The launch geometry of fused_step_launch over n_rows rows: the row tile,
// the blocks of a cluster that share it, the k rows of a gate slab, the
// grid's blocks, the blocks of that instance one SM holds, a block's
// dynamic shared memory, and the SMs the plan filled.
int fused_step_geometry(int vals_bf16, int n_rows, int hidden, int* row_tile,
                        int* cluster, int* slab_rows, int* blocks,
                        int* blocks_per_sm, int* smem_bytes, int* sms) {
  *sms = device_sms();
  const StepPlan p = step_fwd_plan(n_rows, hidden, *sms);
  *row_tile = p.row_tile;
  *cluster = p.cluster;
  *slab_rows = p.slab_rows;
  *blocks = p.blocks;
  *smem_bytes = static_cast<int>(
      step_fwd_smem(p.row_tile, hidden, p.cluster, p.slab_rows));
  return vals_bf16 ? launch_step<__nv_bfloat16>(
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, n_rows, hidden, 0, 0, 0,
                         nullptr, blocks_per_sm)
                   : launch_step<float>(nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nullptr,
                                        nullptr, n_rows, hidden, 0, 0, 0,
                                        nullptr, blocks_per_sm);
}

// n_steps gated steps in one launch: cluster (1 or 2; hidden / cluster
// >= 32 after rounding hidden up to 32, 64 or 128) blocks per row group
// groups[g]..groups[g+1] (int32, n_groups + 1 cut points, no edge crossing
// a cut), h resident in shared memory. max_group_rows sizes the dynamic
// shared memory (persistent_fwd_smem).
int persistent_fwd_launch(const void* h0, const void* vals, int vals_bf16,
                          const void* ek, const void* eb, const void* wi,
                          const void* bi, const void* wh, const void* bh,
                          const void* groups, int n_groups,
                          int max_group_rows, int n_steps, int cluster,
                          void* out, int hidden, int tile, int n_tiles,
                          int bandwidth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_persistent<__nv_bfloat16, false>(
        h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
        n_steps, cluster, out, hidden, tile, n_tiles, bandwidth, st);
  return launch_persistent<float, false>(
      h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
      n_steps, cluster, out, hidden, tile, n_tiles, bandwidth, st);
}

// The backward's recompute sweep: n_steps gated steps from h0 (the
// caller passes K - 1), writing each step's h into hist [n_steps, n_rows,
// hidden]. Otherwise as persistent_fwd_launch.
int persistent_fwd_hist_launch(const void* h0, const void* vals,
                               int vals_bf16, const void* ek, const void* eb,
                               const void* wi, const void* bi, const void* wh,
                               const void* bh, const void* groups,
                               int n_groups, int max_group_rows, int n_steps,
                               int cluster, void* hist, int hidden, int tile,
                               int n_tiles, int bandwidth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_persistent<__nv_bfloat16, true>(
        h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
        n_steps, cluster, hist, hidden, tile, n_tiles, bandwidth, st);
  return launch_persistent<float, true>(
      h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
      n_steps, cluster, hist, hidden, tile, n_tiles, bandwidth, st);
}

// The instance of persistent_fwd_kernel that a launch with cluster blocks
// a group and groups of up to max_group_rows rows runs: the blocks of it
// one SM holds into *blocks and, for cluster > 1, the clusters of it the
// card holds at once into *clusters (0 for cluster 1).
int persistent_fwd_occupancy(int vals_bf16, int max_group_rows, int hidden,
                             int cluster, int* blocks, int* clusters) {
  *clusters = 0;
  if (cluster != 1 && cluster != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vals_bf16)
    return cluster == 1
               ? fwd_occupancy<__nv_bfloat16, 1>(max_group_rows, hidden,
                                                 blocks, clusters)
               : fwd_occupancy<__nv_bfloat16, 2>(max_group_rows, hidden,
                                                 blocks, clusters);
  return cluster == 1
             ? fwd_occupancy<float, 1>(max_group_rows, hidden, blocks,
                                       clusters)
             : fwd_occupancy<float, 2>(max_group_rows, hidden, blocks,
                                       clusters);
}

// One bf16 gated step (fused_step_kernel_bf16, two passes): h, out
// [n_rows, hidden] bf16; msg [n_rows, hidden] f32 scratch (the messages);
// the weights f32 arrays of bf16 values; otherwise as fused_step_launch.
int fused_step_bf16_launch(const void* h, const void* vals, int vals_bf16,
                           const void* ek, const void* eb, const void* wi,
                           const void* bi, const void* wh, const void* bh,
                           void* msg, void* out, int n_rows, int hidden,
                           int tile, int n_tiles, int bandwidth,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_step_bf16<__nv_bfloat16>(h, vals, ek, eb, wi, bi, wh, bh,
                                           msg, out, n_rows, hidden, tile,
                                           n_tiles, bandwidth, st);
  return launch_step_bf16<float>(h, vals, ek, eb, wi, bi, wh, bh, msg, out,
                                 n_rows, hidden, tile, n_tiles, bandwidth, st);
}

// fused_step_bf16_launch's geometry: as fused_step_geometry, with each
// pass's blocks an SM and shared memory (pass 0: the messages; pass 1: the
// aggregate and the gate).
int fused_step_bf16_geometry(int vals_bf16, int n_rows, int hidden,
                             int* row_tile, int* cluster, int* slab_rows,
                             int* blocks, int* blocks_per_sm,
                             int* blocks_per_sm_pass1, int* smem_bytes,
                             int* smem_bytes_pass1, int* sms) {
  *sms = device_sms();
  const StepPlan p = step_bf16_plan(n_rows, hidden, *sms);
  *row_tile = p.row_tile;
  *cluster = p.cluster;
  *slab_rows = p.slab_rows;
  *blocks = p.blocks;
  *smem_bytes = static_cast<int>(step_bf16_smem(p.row_tile, hidden, 0));
  *smem_bytes_pass1 = static_cast<int>(step_bf16_smem(p.row_tile, hidden, 1));
  int occ[2] = {0, 0};
  const int e = vals_bf16 ? launch_step_bf16<__nv_bfloat16>(
                                nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, nullptr,
                                n_rows, hidden, 0, 0, 0, nullptr, occ)
                          : launch_step_bf16<float>(
                                nullptr, nullptr, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, nullptr,
                                n_rows, hidden, 0, 0, 0, nullptr, occ);
  *blocks_per_sm = occ[0];
  *blocks_per_sm_pass1 = occ[1];
  return e;
}

// n_steps bf16 gated steps in one launch (persistent_fwd_kernel_bf16): h0,
// out bf16; otherwise as persistent_fwd_launch.
int persistent_fwd_bf16_launch(const void* h0, const void* vals,
                               int vals_bf16, const void* ek, const void* eb,
                               const void* wi, const void* bi, const void* wh,
                               const void* bh, const void* groups,
                               int n_groups, int max_group_rows, int n_steps,
                               int cluster, void* out, int hidden, int tile,
                               int n_tiles, int bandwidth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_persistent_bf16<__nv_bfloat16, false>(
        h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
        n_steps, cluster, out, hidden, tile, n_tiles, bandwidth, st);
  return launch_persistent_bf16<float, false>(
      h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
      n_steps, cluster, out, hidden, tile, n_tiles, bandwidth, st);
}

// The bf16 backward's recompute sweep (persistent_fwd_hist_kernel_bf16):
// n_steps bf16 gated steps from h0 (the caller passes K - 1), writing each
// step's h into hist [n_steps, n_rows, hidden] bf16. Otherwise as
// persistent_fwd_bf16_launch.
int persistent_fwd_hist_bf16_launch(const void* h0, const void* vals,
                                    int vals_bf16, const void* ek,
                                    const void* eb, const void* wi,
                                    const void* bi, const void* wh,
                                    const void* bh, const void* groups,
                                    int n_groups, int max_group_rows,
                                    int n_steps, int cluster, void* hist,
                                    int hidden, int tile, int n_tiles,
                                    int bandwidth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16)
    return launch_persistent_bf16<__nv_bfloat16, true>(
        h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
        n_steps, cluster, hist, hidden, tile, n_tiles, bandwidth, st);
  return launch_persistent_bf16<float, true>(
      h0, vals, ek, eb, wi, bi, wh, bh, groups, n_groups, max_group_rows,
      n_steps, cluster, hist, hidden, tile, n_tiles, bandwidth, st);
}

// persistent_fwd_occupancy for the instance of persistent_fwd_kernel_bf16
// a launch runs (hist != 0: of its kHist instance,
// persistent_fwd_hist_kernel_bf16).
int persistent_fwd_bf16_occupancy(int vals_bf16, int max_group_rows,
                                  int hidden, int cluster, int hist,
                                  int* blocks, int* clusters) {
  *clusters = 0;
#define BF16_OCCUPANCY(VT, HIST)                                            \
  return launch_persistent_bf16<VT, HIST>(                                  \
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,       \
      nullptr, nullptr, 0, max_group_rows, 0, cluster, nullptr, hidden, 0, \
      0, 0, nullptr, blocks, clusters)
  if (vals_bf16) {
    if (hist) BF16_OCCUPANCY(__nv_bfloat16, true);
    BF16_OCCUPANCY(__nv_bfloat16, false);
  }
  if (hist) BF16_OCCUPANCY(float, true);
  BF16_OCCUPANCY(float, false);
#undef BF16_OCCUPANCY
}

}  // extern "C"
