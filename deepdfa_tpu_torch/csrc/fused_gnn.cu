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
// (fused_gnn_bwd.cu) are in gated_step.cuh; the bf16 instances' (below)
// products are gnn_bf16_mma.cuh's, shared with the bf16 backward.
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
//   A serving bucket launches on a static geometry (its CUDA graph is
//   captured once): its cut points are padded to a bound that holds for
//   any mix of graphs (63 groups of up to 64 rows at 16 slots; serve/
//   engine.py:bucket_batch), and the padded groups' blocks return at once.
//   PERF.md has the measured times.

#include "gnn_bf16_mma.cuh"  // group_step.cuh, bf16_mma.cuh

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
  // An empty group (a serving bucket's cut points are padded to a static
  // count, ops/band_spmm.py:pad_row_groups): the whole cluster shares it,
  // so every block returns here, before it stages a weight slab or meets
  // a cluster barrier.
  if (R == 0) return;
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
// kernels: tile_aggregate / group_aggregate) and round the aggregate to x,
// then run the gate's six sums apart (each rounds before its bias) and
// gate_out_bf16 op for op.
//
// Every dense product multiplies two bf16 values and sums in f32, so they
// run on the bf16 tensor cores through the device functions the bf16
// backward uses (gnn_bf16_mma.cuh: product, gate_sums; one bf16
// mma.sync.m16n8k16 a 16-deep k-slice, k padded to 16 with zeros), on
// bf16 copies of W_e, W_i and W_h ([K, N] side by side, rounded from the
// packed weights once a call by fwd_bf16_prep_kernel, every call's first
// launch; read by ldmatrix.trans) and on bf16 row tiles; the weights
// stream through a ring of kFwdRingStages stages of
// the gate's six [16, hp + 8] bf16 slabs. The messages are stored at the
// message dtype (bf16 band values: bf16; f32: f32). What bounds them:
// the products at the bf16 tensor-core rate (ops/fused_gnn.py:
// kernel_cost); what holds them above it at these sizes is each weight
// slab's trip from L2 (the whole of W_e, W_i and W_h a pass of up to 32
// rows), the band aggregate (a warp a row) and the gate's elementwise
// epilogue (PERF.md has the measured times; scripts/
// torch_gnn_fwd_bf16_layouts.py times other ring stages and blocks an SM).
//
// Exact at the rounding points. The tensor cores sum a 16-deep k-slice at
// a time, so a product's f32 sum differs in its last bits from the
// reference's order (one f32 FMA chain over k ascending from 0: the f32
// kernels' order, and cuBLAS's for the plain versions' products on the
// card). Only a sum's bf16 rounding reaches the output, except the f32
// messages, which the aggregate adds unrounded. So every bf16-rounded sum
// (the six gate sums; the messages with bf16 band values) that lies
// within kNear ||a|| ||b|| of a bf16 rounding midpoint (a the sum's row of
// h or x, b its weight column: ||a|| ||b|| bounds every partial sum of
// either order, whose f32 rounding errors set the gap between them) is
// recomputed as that chain (chain_col, from the transposed weights), one
// to three percent of them on the model's data; and with f32 band values
// every message is the chain (chain_messages). The rounded values are
// then the chain's, and a rounding flip next to an output near zero
// (which would put it far outside one bf16 step of the plain version)
// does not happen. The row norms come from the tiles, the column norms
// from fwd_bf16_prep_kernel.
//
// fused_step_kernel_bf16 runs two passes over fixed row tiles (32 rows, 16
// where 32-row tiles leave SMs idle: step_bf16_plan), one launch
// count, since a tile's halo needs other blocks' messages: pass 0 writes
// every row's message to device memory at the message dtype; pass 1
// stages the tile's h and messages, aggregates (the halo's messages from
// device memory), rounds x into a bf16 tile and runs the gate; h' goes
// straight out. persistent_fwd_kernel_bf16 does both passes' work for one
// closed row group a block, for all K steps: the group's h and x stay
// resident as bf16 tiles and its messages at the message dtype; the gate
// writes h' beside h (the chains still read h) and h' is copied over h
// after it. One block a group at any batch (no cluster): at the serving
// bucket its 34 groups' weight trips are latency-bound, which a cluster
// splitting the columns would not shorten. Each element keeps one chain
// in both kernels (the same device functions, k-slices in ascending order,
// the same tests and chains; group_aggregate sums a row's senders as
// tile_aggregate does), so K steps of the sweep equal K launches of the
// per-step kernel bit for bit, and hist[k] the sweep after k + 1 steps.

// The forward's weight ring stages (ops/fused_gnn.py:
// GNN_BF16_FWD_RING_STAGES mirrors it) and the blocks an SM that the
// per-step passes and the sweep are built for (__launch_bounds__: at most
// 128 registers a thread at two, 255 at one). The sweep runs messages,
// aggregate and gate in one body, which spills at 128 registers;
// scripts/torch_gnn_fwd_bf16_layouts.py times the other layouts.
constexpr int kFwdRingStages = 2;
constexpr int kFwdStepBlocks = 2;
constexpr int kFwdPersistBlocks = 1;

// A bf16-rounded sum within kNear ||a|| ||b|| of a rounding midpoint is
// recomputed as the reference's chain: 16 units of 2^-24 ||a|| ||b||,
// where the two orders' sums of random-signed rounding errors of partial
// sums under ||a|| ||b|| stay within about one such unit.
constexpr float kNear = 16.0f / 16777216.0f;

// Pointers and sizes of the bf16 forward: h (h_0) and out bf16, the
// weights as fwd_bf16_prep_kernel leaves them (columns [0, H) W_e's, [H,
// 4H) W_i's, [4H, 7H) W_h's), msg scratch at the message dtype (the
// per-step kernel's), groups the persistent kernel's row groups.
struct FwdBf16Args {
  const __nv_bfloat16* h;
  const void* vals;
  const __nv_bfloat16* w;   // [H, 7H]: W_e | W_i | W_h, bf16
  const __nv_bfloat16* wt;  // [7H, H]: w transposed
  const float* b;           // [7H]: b_e | b_i | b_h, bf16 values
  const float* cn;          // [7H]: the L2 norms of w's columns
  void* msg;
  const int* groups;
  __nv_bfloat16* out;
  int n_rows, H, tile, n_tiles, bw, row_tile, n_steps, max_rows;
};

__host__ __device__ inline int fwd_ring_bytes(int H) {
  return gnnmma::ring_bytes<kFwdRingStages>(H);
}

// Whether a bf16 rounding midpoint lies within e of v: v - e and v + e
// round apart (one packed conversion, the halves compared as bits).
__device__ __forceinline__ bool near_midpoint(float v, float e) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fsub_rn(v, e),
                                                 __fadd_rn(v, e));
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&r);
  return (u & 0xffffu) != (u >> 16);
}

// sum_k a[k] w[k * ncols] over k < H as the reference sums it: one f32
// FMA chain, k ascending from 0 (a: a bf16 tile row; w: a bf16 weight
// column in device memory). Where the threads of a warp take consecutive
// columns (chain_messages) their loads of a k row coalesce.
__device__ __forceinline__ float chain_dot(const __nv_bfloat16* a,
                                           const __nv_bfloat16* __restrict__ w,
                                           int ncols, int H) {
  float acc = 0.f;
#pragma unroll 8
  for (int k = 0; k < H; ++k)
    acc = __fmaf_rn(__bfloat162float(a[k]),
                    __bfloat162float(w[static_cast<size_t>(k) * ncols]), acc);
  return acc;
}

// The same chain with the weight column contiguous (wt: a row of the
// transposed weights, H % 4 == 0), for the near-midpoint sums, whose
// threads take scattered columns. kBatch (the sweep, built for 255
// registers; H % 8 == 0): 16 bytes a load, 8 loads in flight before their
// FMAs, out of line; else (the per-step passes, at 128 registers) 8 bytes
// a load, inlined.
__device__ __forceinline__ float chain_dot_t(
    const __nv_bfloat16* a, const __nv_bfloat16* __restrict__ wt, int H) {
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < H; k += 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(a + k);
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(wt + k));
    acc = __fmaf_rn(bf16mma::low(u.x), bf16mma::low(w.x), acc);
    acc = __fmaf_rn(bf16mma::high(u.x), bf16mma::high(w.x), acc);
    acc = __fmaf_rn(bf16mma::low(u.y), bf16mma::low(w.y), acc);
    acc = __fmaf_rn(bf16mma::high(u.y), bf16mma::high(w.y), acc);
  }
  return acc;
}

__device__ __noinline__ float chain_dot_t16(
    const __nv_bfloat16* a, const __nv_bfloat16* __restrict__ wt, int H) {
  float acc = 0.f;
  for (int k0 = 0; k0 < H; k0 += 64) {
    uint4 w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (k0 + 8 * q < H)
        w[q] = __ldg(reinterpret_cast<const uint4*>(wt + k0 + 8 * q));
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (k0 + 8 * q >= H) break;
      const uint4 u = *reinterpret_cast<const uint4*>(a + k0 + 8 * q);
      const uint32_t av[4] = {u.x, u.y, u.z, u.w};
      const uint32_t wv[4] = {w[q].x, w[q].y, w[q].z, w[q].w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        acc = __fmaf_rn(bf16mma::low(av[p]), bf16mma::low(wv[p]), acc);
        acc = __fmaf_rn(bf16mma::high(av[p]), bf16mma::high(wv[p]), acc);
      }
    }
  }
  return acc;
}

template <bool kBatch>
__device__ __forceinline__ float chain_col(const __nv_bfloat16* a,
                                          const __nv_bfloat16* wt, int H) {
  if (kBatch && H % 8 == 0) return chain_dot_t16(a, wt, H);
  return chain_dot_t(a, wt, H);
}

// The L2 norms of rows [0, R) of a bf16 tile (stride ld) into n[0, R),
// a warp a row. Ends with a barrier.
__device__ __forceinline__ void row_norms(const __nv_bfloat16* t, int R,
                                          int ld, int H, float* n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kGroupWarps) {
    float ss = 0.f;
    for (int c = lane; c < H; c += 32) {
      const float a = __bfloat162float(t[r * ld + c]);
      ss = fmaf(a, a, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) n[r] = sqrtf(ss);
  }
  __syncthreads();
}

// One value at p, of the array's type (bf16: rounded).
__device__ __forceinline__ void put1(float* p, float v) { *p = v; }
__device__ __forceinline__ void put1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The sums a pass leaves to the chain wait in the ring's stages (free
// after the pass's products) until the pass's post step, where each thread
// takes whole chains: a message's row, column and f32 sum; a gate
// element's row, column and six sums, and apart from them each flagged sum
// (the element's index times 8 plus the sum's). n[0], n[1] (and n[2], the
// gate's overflow list) count them (shared memory, zeroed by the kernel
// before its first product); past the stages' room a message takes the
// chain at once.
struct PendingMsg {
  int row, col;
  float acc;
};
struct PendingGate {
  short row, col;
  float v[6];
};

// The messages of rows [0, R) with f32 band values (the aggregate adds them
// unrounded): each the reference's chain, then the bias, into out(row,
// col, m) (ek: W_e's columns with rows of 7H, as fwd_bf16_prep_kernel
// lays them out). Ends with a barrier.
template <typename Out>
__device__ __forceinline__ void chain_messages(int R, int H,
                                               const __nv_bfloat16* hb,
                                               const __nv_bfloat16* ek,
                                               const float* __restrict__ eb,
                                               Out out) {
  const int ld = gnnmma::tile_ld(H);
  gnnmma::for_pieces(R, H, [&](int r, int c) {
    out(r, c, __fadd_rn(chain_dot(hb + r * ld, ek + c, 7 * H, H),
                        __ldg(eb + c)));
  });
  __syncthreads();
}

// The messages of rows [0, R) at the message dtype into out(row, col, m)
// (hb: h as a bf16 tile, nh its row norms, cn the weights' column norms
// in shared memory): bf16 band values, the
// product's sums with those near a rounding midpoint from the chain, then
// edge_msg_bf16; f32, chain_messages. Ends with a barrier.
template <bool kRoundMsg, bool kBatch, typename Out>
__device__ __forceinline__ void step_messages(int R, int H,
                                              const __nv_bfloat16* hb,
                                              const float* nh,
                                              const float* cn,
                                              const FwdBf16Args& a,
                                              char* stages, int* n,
                                              Out out) {
  const int ld = gnnmma::tile_ld(H);
  if constexpr (kRoundMsg) {
    PendingMsg* pend = reinterpret_cast<PendingMsg*>(stages);
    const int cap = fwd_ring_bytes(H) / static_cast<int>(sizeof(PendingMsg));
    const auto finish = [&](int r, int c, float acc) {
      out(r, c, edge_msg_bf16(acc, __ldg(a.b + c), true));
    };
    gnnmma::product<1, 1, 1, kFwdRingStages>(
        R, H, gnnmma::hp16(H), gnnmma::stage_k_rows(H, 1), {{{a.w, 7 * H, 0}}},
        stages, [](int, int) {},
        [&](int, int t0, int lt, int k0, uint32_t(&f)[1][4]) {
          gnnmma::frag_a(f[0], hb, ld, 16 * (t0 + lt), k0);
        },
        [&](int r, int c, const float(&v)[1][2]) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (!near_midpoint(v[0][e], kNear * nh[r] * cn[c + e])) {
              finish(r, c + e, v[0][e]);
              continue;
            }
            const int i = atomicAdd(n, 1);
            if (i < cap)
              pend[i] = {r, c + e, v[0][e]};
            else
              finish(r, c + e,
                     chain_col<kBatch>(hb + r * ld, a.wt + (c + e) * H, H));
          }
        },
        [&](int, int) {
          const int m = min(*n, cap);
          for (int i = threadIdx.x; i < m; i += kGroupThreads) {
            const PendingMsg p = pend[i];
            finish(p.row, p.col,
                   chain_col<kBatch>(hb + p.row * ld, a.wt + p.col * H, H));
          }
          __syncthreads();
          if (threadIdx.x == 0) *n = 0;
          __syncthreads();
        });
  } else {
    chain_messages(R, H, hb, a.w, a.b, out);
  }
}

// h' of one element from its six sums (gnnmma::gate_sums' order: ir, iz,
// in, hr, hz, hn) and its carry hc.
__device__ __forceinline__ float gate_one(const float* v, int col, int H,
                                          const float* bi, const float* bh,
                                          float hc) {
  return gate_out_bf16(v[0], v[3], v[1], v[4], v[2], v[5],
                       gate_bias_bf16(bi, bh, H, col), hc);
}

// The gate's six sums of rows [0, R) (gnnmma::gate_sums: x W_i, h W_h, the
// r, z and n blocks apart), those near a rounding midpoint from the chain
// (nx, nh: the rows' norms; cn the weights' column norms), then h' of each
// element into out(row, col, h') (hb: the carry h, unchanged here). A
// flagged element past the
// stages' room for its sums is listed by row and column alone (the list
// holds a pass's every element) and takes all six chains. No array of
// the epilogue is indexed at run time, so none leaves the registers.
// Ends with a barrier.
template <bool kBatch, typename Out>
__device__ __forceinline__ void step_gate(int R, int H,
                                          const __nv_bfloat16* xb,
                                          const __nv_bfloat16* hb,
                                          const float* nx, const float* nh,
                                          const float* cn,
                                          const FwdBf16Args& a, char* stages,
                                          int* n, Out out) {
  const int ld = gnnmma::tile_ld(H);
  // The stages: the overflow list (a pass's elements), then cap elements
  // and their flagged sums, six at most each.
  const int cap_o = 16 * gnnmma::pass_tiles(H) * H;
  int* ovf = reinterpret_cast<int*>(stages);
  const int cap = (fwd_ring_bytes(H) - 4 * cap_o) /
                  static_cast<int>(sizeof(PendingGate) + 6 * sizeof(int));
  PendingGate* pend = reinterpret_cast<PendingGate*>(ovf + cap_o);
  int* sums = reinterpret_cast<int*>(pend + cap);
  // Sum s of element (r, col) as the chain.
  const auto chain = [&](int r, int col, int s) {
    const bool in = s < 3;  // x W_i, else h W_h
    return chain_col<kBatch>(
        (in ? xb : hb) + r * ld,
        a.wt + ((in ? H : 4 * H) + (s % 3) * H + col) * H, H);
  };
  const auto finish = [&](int r, int col, const float* v) {
    out(r, col, gate_one(v, col, H, a.b + H, a.b + 4 * H,
                         __bfloat162float(hb[r * ld + col])));
  };
  gnnmma::gate_sums<kFwdRingStages>(
      R, H, xb, hb, a.w + H, a.w + 4 * H, stages,
      [&](int r, int c, const float(&v)[6][2]) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c + e;
          int flags = 0;
#pragma unroll
          for (int s = 0; s < 6; ++s) {
            const bool in = s < 3;
            const float near = kNear * (in ? nx[r] : nh[r]) *
                               cn[(in ? H : 4 * H) + (s % 3) * H + col];
            flags |= near_midpoint(v[s][e], near) << s;
          }
          if (flags == 0) {
            const float w[6] = {v[0][e], v[1][e], v[2][e],
                                v[3][e], v[4][e], v[5][e]};
            finish(r, col, w);
            continue;
          }
          const int i = atomicAdd(n, 1);
          if (i >= cap) {
            ovf[atomicAdd(n + 2, 1)] = r << 16 | col;
            continue;
          }
          PendingGate& p = pend[i];
          p.row = static_cast<short>(r);
          p.col = static_cast<short>(col);
#pragma unroll
          for (int s = 0; s < 6; ++s) p.v[s] = v[s][e];
          int j = atomicAdd(n + 1, __popc(flags));
#pragma unroll
          for (int s = 0; s < 6; ++s)
            if (flags >> s & 1) sums[j++] = 8 * i + s;
        }
      },
      [&](int, int) {
        const int m = n[1], no = n[2];
        for (int t = threadIdx.x; t < m; t += kGroupThreads) {
          const int i = sums[t] >> 3, s = sums[t] & 7;
          pend[i].v[s] = chain(pend[i].row, pend[i].col, s);
        }
        for (int t = threadIdx.x; t < no; t += kGroupThreads) {
          const int r = ovf[t] >> 16, col = ovf[t] & 0xffff;
          float w[6];
#pragma unroll
          for (int s = 0; s < 6; ++s) w[s] = chain(r, col, s);
          finish(r, col, w);
        }
        __syncthreads();
        const int ne = min(n[0], cap);
        for (int i = threadIdx.x; i < ne; i += kGroupThreads)
          finish(pend[i].row, pend[i].col, pend[i].v);
        __syncthreads();
        if (threadIdx.x == 0) n[0] = n[1] = n[2] = 0;
        __syncthreads();
      },
      7 * H);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The bf16 forward's weights, once a call (the first of its launches):
// the packed weights (the f32 masters, or bf16 ones) ek [H, H], wi, wh
// [H, 3H] rounded to bf16 side by side into w [H, 7H] (W_e | W_i | W_h)
// and transposed into wt [7H, H], the biases eb [H], bi, bh [3H] rounded
// into b [7H] (f32 arrays of bf16 values), and the L2 norms of w's
// columns into cn [7H]. A thread a column (H % 4 == 0). One launch in
// place of the dozen small torch operations that would do the same.
template <typename WT>
__global__ void __launch_bounds__(128)
    fwd_bf16_prep_kernel(const WT* __restrict__ ek, const WT* __restrict__ eb,
                         const WT* __restrict__ wi, const WT* __restrict__ bi,
                         const WT* __restrict__ wh, const WT* __restrict__ bh,
                         int H, __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ wt,
                         float* __restrict__ b, float* __restrict__ cn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x, H7 = 7 * H;
  if (j >= H7) return;
  const bool e = j < H, i = !e && j < 4 * H;
  const WT* src = e ? ek : i ? wi : wh;
  const WT* bias = e ? eb : i ? bi : bh;
  const int col = e ? j : i ? j - H : j - 4 * H, ld = e ? H : 3 * H;
  float ss = 0.f;
  for (int k = 0; k < H; k += 4) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = round_bf16(to_f32(src[static_cast<size_t>(k + q) * ld + col]));
      w[static_cast<size_t>(k + q) * H7 + j] = __float2bfloat16_rn(v[q]);
      ss = fmaf(v[q], v[q], ss);
    }
    store_bf16x4(wt + static_cast<size_t>(j) * H + k, v[0], v[1], v[2], v[3]);
  }
  cn[j] = sqrtf(ss);
  b[j] = round_bf16(to_f32(bias[col]));
}

// Launches fwd_bf16_prep_kernel on the packed weights p (f32 or bf16)
// into the workspace ws (bf16, 14 H^2: w then wt) and fs (f32, 14 H: b
// then cn); a holds the forward's pointers to them.
int launch_fwd_bf16_prep(const void* const* p, int weights_bf16, int H,
                         void* ws, void* fs, FwdBf16Args& a,
                         cudaStream_t st) {
  __nv_bfloat16* w = static_cast<__nv_bfloat16*>(ws);
  float* b = static_cast<float*>(fs);
  a.w = w;
  a.wt = w + 7 * H * H;
  a.b = b;
  a.cn = b + 7 * H;
  const int grid = (7 * H + 127) / 128;
#define PREP(T)                                                            \
  fwd_bf16_prep_kernel<T><<<grid, 128, 0, st>>>(                           \
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),            \
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),            \
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]), H, w,       \
      w + 7 * H * H, b, b + 7 * H)
  if (weights_bf16)
    PREP(__nv_bfloat16);
  else
    PREP(float);
#undef PREP
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of fused_step_kernel_bf16's pass for tiles of
// row_tile rows (ops/fused_gnn.py:step_smem_bytes mirrors it): the ring,
// then pass 0: h (bf16), its row norms; pass 1: h and x (bf16), the
// messages (sized f32), the row sums, x's and h's row norms; then the
// weights' column norms (f32, 7 hidden).
size_t step_bf16_smem(int row_tile, int hidden, int pass) {
  const size_t rows = static_cast<size_t>(row_tile) * gnnmma::tile_ld(hidden);
  const size_t rt = row_tile;
  return fwd_ring_bytes(hidden) +
         (pass == 0 ? 2 * rows + 4 * rt : 8 * rows + 12 * rt) +
         28 * static_cast<size_t>(hidden);
}

// Pass 0: msg[r] = edge_msg_bf16((h W_e)[r]) at the message dtype; pass 1:
// the aggregate of the messages rounded to x, the gate; h' into out.
template <typename VT, int kPass>
__global__ void __launch_bounds__(kGroupThreads, kFwdStepBlocks)
    fused_step_kernel_bf16(const FwdBf16Args a) {
  using namespace gnnmma;
  using MT = VT;  // the messages at the message dtype (the band's)
  constexpr bool kRoundMsg = sizeof(VT) == 2;
  extern __shared__ __align__(16) char fsmem[];
  __shared__ int pending[3];  // the pass's sums left to the chain
  const int H = a.H, ld = tile_ld(H), rt = a.row_tile;
  const int r0 = blockIdx.x * rt, R = min(rt, a.n_rows - r0);
  const size_t off = static_cast<size_t>(r0) * H;
  char* stages = fsmem;
  __nv_bfloat16* hb =
      reinterpret_cast<__nv_bfloat16*>(fsmem + fwd_ring_bytes(H));  // [rt, ld]
  tile_in(hb, a.h + off, R, H);
  if (threadIdx.x == 0) pending[0] = pending[1] = pending[2] = 0;
  if constexpr (kPass == 0) {
    float* nh = reinterpret_cast<float*>(hb + rt * ld);  // [rt] row norms
    float* cn = nh + rt;                                 // [7H] column norms
    for (int i = threadIdx.x; i < 7 * H; i += kGroupThreads) cn[i] = a.cn[i];
    __syncthreads();
    row_norms(hb, R, ld, H, nh);
    MT* msg = static_cast<MT*>(a.msg) + off;
    step_messages<kRoundMsg, false>(R, H, hb, nh, cn, a, stages, pending,
                                    [&](int r, int c, float m) {
                                      put1(msg + r * H + c, m);
                             });
  } else {
    __nv_bfloat16* xb = hb + rt * ld;               // [rt, ld] x
    MT* mt = reinterpret_cast<MT*>(xb + rt * ld);   // [rt, ld] own messages
    float* rs = reinterpret_cast<float*>(
        reinterpret_cast<char*>(xb + rt * ld) + 4 * rt * ld);  // [rt]
    float* nx = rs + rt;                                       // [rt]
    float* nh = nx + rt;                                       // [rt]
    float* cn = nh + rt;                                       // [7H]
    const MT* msg = static_cast<const MT*>(a.msg);
    tile_in(mt, msg + off, R, H);
    for (int i = threadIdx.x; i < 7 * H; i += kGroupThreads) cn[i] = a.cn[i];
    __syncthreads();
    tile_aggregate(static_cast<const VT*>(a.vals), a.tile, a.n_tiles, a.bw,
                   msg, static_cast<const MT*>(mt), r0, R, ld, H, xb, rs,
                   reinterpret_cast<float*>(stages), fwd_ring_bytes(H) / 4);
    zero_pad(xb, R, H);
    __syncthreads();
    row_norms(xb, R, ld, H, nx);
    row_norms(hb, R, ld, H, nh);
    __nv_bfloat16* out = a.out + off;
    step_gate<false>(R, H, xb, hb, nx, nh, cn, a, stages, pending,
                     [&](int r, int c, float o) { put1(out + r * H + c, o); });
  }
}

// The per-step bf16 forward's cut of n_rows rows on a card of sms SMs
// (ops/fused_gnn.py:step_plan mirrors it): 32-row tiles, 16 where those
// are fewer than sms blocks; one block a tile, slabs of kKS k rows.
StepPlan step_bf16_plan(int n_rows, int sms) {
  const int rt = (n_rows + 31) / 32 < sms ? 16 : 32;
  return {rt, 1, gnnmma::kKS, (n_rows + rt - 1) / rt, false};
}

// Launches pass kPass over plan p (occupancy == nullptr) or queries its
// blocks an SM.
template <typename VT, int kPass>
int step_bf16_pass(const FwdBf16Args& a, const StepPlan& p, cudaStream_t st,
                   int* occupancy) {
  const auto kernel = fused_step_kernel_bf16<VT, kPass>;
  const size_t smem = step_bf16_smem(p.row_tile, a.H, kPass);
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

// Both passes of one step (occupancy: the two passes' blocks an SM).
template <typename VT>
int launch_step_bf16(FwdBf16Args a, cudaStream_t st,
                     int* occupancy = nullptr) {
  const StepPlan p = step_bf16_plan(a.n_rows, device_sms());
  a.row_tile = p.row_tile;
  const int e = step_bf16_pass<VT, 0>(a, p, st, occupancy);
  if (e != 0) return e;
  return step_bf16_pass<VT, 1>(a, p, st, occupancy ? occupancy + 1 : nullptr);
}

// Dynamic shared memory of persistent_fwd_kernel_bf16 for groups of up to
// max_rows rows (ops/fused_gnn.py:persistent_fwd_bf16_smem_bytes mirrors
// it): the ring, then h and x (bf16) and the messages (sized f32; during
// the gate, h') of the group padded to 16 rows, the row sums, x's and h's
// row norms, the weights' column norms (f32, 7 hidden).
size_t persistent_fwd_bf16_smem(int max_rows, int hidden) {
  const size_t rp = (max_rows + 15) & ~15;
  return fwd_ring_bytes(hidden) + 8 * rp * gnnmma::tile_ld(hidden) + 12 * rp +
         28 * static_cast<size_t>(hidden);
}

// K steps with the group resident: hb (h), xb (x), mt (the messages at the
// message dtype; during the gate h', copied into hb after it, since the
// chains read h), the row sums and norms. kHist = true (the
// bf16 backward's recompute sweep): after each of the n_steps steps the
// group's h_{k+1} goes to hist[k] ([n_steps, n_rows, H] bf16, in out) and
// h_K is not written; the step code is the same, so hist[k] equals this
// kernel's h after k + 1 steps bit for bit.
template <typename VT, bool kHist>
__global__ void __launch_bounds__(kGroupThreads, kFwdPersistBlocks)
    persistent_fwd_kernel_bf16(const FwdBf16Args a) {
  using namespace gnnmma;
  using MT = VT;
  constexpr bool kRoundMsg = sizeof(VT) == 2;
  extern __shared__ __align__(16) char fsmem[];
  __shared__ int pending[3];  // a pass's sums left to the chain
  const VT* vals = static_cast<const VT*>(a.vals);
  const int H = a.H, ld = tile_ld(H), rp = (a.max_rows + 15) & ~15;
  const int g0 = a.groups[blockIdx.x], g1 = a.groups[blockIdx.x + 1];
  const int R = g1 - g0;
  if (R == 0) return;  // an empty (padded) group: nothing to stage
  char* stages = fsmem;
  __nv_bfloat16* hb =
      reinterpret_cast<__nv_bfloat16*>(fsmem + fwd_ring_bytes(H));  // [rp, ld]
  __nv_bfloat16* xb = hb + rp * ld;                                 // [rp, ld]
  MT* mt = reinterpret_cast<MT*>(xb + rp * ld);  // [rp, ld] the messages
  __nv_bfloat16* hn = reinterpret_cast<__nv_bfloat16*>(mt);  // h' (the gate)
  float* rs = reinterpret_cast<float*>(reinterpret_cast<char*>(xb + rp * ld) +
                                       4 * rp * ld);  // [rp]
  float* nx = rs + rp;                               // [rp]
  float* nh = nx + rp;                               // [rp]
  float* cn = nh + rp;                               // [7H]
  const size_t goff = static_cast<size_t>(g0) * H;
  const size_t plane = static_cast<size_t>(a.n_rows) * H;
  tile_in(hb, a.h + goff, R, H);
  zero_pad(xb, R, H);  // the aggregate writes columns below H only
  for (int i = threadIdx.x; i < 7 * H; i += kGroupThreads) cn[i] = a.cn[i];
  if (threadIdx.x == 0) pending[0] = pending[1] = pending[2] = 0;
  __syncthreads();
  for (int step = 0; step < a.n_steps; ++step) {
    row_norms(hb, R, ld, H, nh);
    step_messages<kRoundMsg, true>(R, H, hb, nh, cn, a, stages, pending,
                                   [&](int r, int c, float m) {
                                     put1(mt + r * ld + c, m);
                             });
    // The aggregate, rounded: x.
    group_aggregate(vals, a.tile, a.n_tiles, a.bw, static_cast<const MT*>(mt),
                    ld, g0, g1, H, xb, rs);
    __syncthreads();
    row_norms(xb, R, ld, H, nx);
    step_gate<true>(R, H, xb, hb, nx, nh, cn, a, stages, pending,
                    [&](int r, int c, float o) { put1(hn + r * ld + c, o); });
    for_pieces(R, H / 4, [&](int r, int i) {
      *reinterpret_cast<uint2*>(hb + r * ld + 4 * i) =
          *reinterpret_cast<const uint2*>(hn + r * ld + 4 * i);
    });
    __syncthreads();
    if constexpr (kHist) tile_out(a.out + step * plane + goff, hb, R, H);
  }
  if constexpr (!kHist) tile_out(a.out + goff, hb, R, H);
}

// Launches the sweep over n_groups groups (blocks == nullptr) or queries
// the blocks of it one SM holds.
template <typename VT, bool kHist>
int launch_persistent_bf16(const FwdBf16Args& a, int n_groups,
                           cudaStream_t st, int* blocks = nullptr) {
  const auto kernel = persistent_fwd_kernel_bf16<VT, kHist>;
  const size_t smem = persistent_fwd_bf16_smem(a.max_rows, a.H);
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

// The arguments of a bf16 forward call, but the weights'
// (launch_fwd_bf16_prep sets those).
FwdBf16Args fwd_bf16_args(const void* h, const void* vals, void* msg,
                          const void* groups, void* out, int n_rows,
                          int hidden, int tile, int n_tiles, int bw,
                          int n_steps, int max_rows) {
  FwdBf16Args a = {};
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.vals = vals;
  a.msg = msg;
  a.groups = static_cast<const int*>(groups);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.n_rows = n_rows;
  a.H = hidden;
  a.tile = tile;
  a.n_tiles = n_tiles;
  a.bw = bw;
  a.n_steps = n_steps;
  a.max_rows = max_rows;
  return a;
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

// One bf16 gated step (fused_step_kernel_bf16: the weights' prep, then
// two passes): h, out [n_rows, hidden] bf16; msg [n_rows, hidden] scratch
// at the message dtype (bf16 for bf16 band values, else f32); the packed
// weights ek, eb, wi, bi, wh, bh f32 (weights_bf16 == 0: the masters) or
// bf16; ws (bf16, 14 hidden^2) and fs (f32, 14 hidden) scratch for their
// prep; otherwise as fused_step_launch.
int fused_step_bf16_launch(const void* h, const void* vals, int vals_bf16,
                           const void* ek, const void* eb, const void* wi,
                           const void* bi, const void* wh, const void* bh,
                           int weights_bf16, void* ws, void* fs, void* msg,
                           void* out, int n_rows, int hidden, int tile,
                           int n_tiles, int bandwidth, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdBf16Args a = fwd_bf16_args(h, vals, msg, nullptr, out, n_rows, hidden,
                                tile, n_tiles, bandwidth, 1, 0);
  const void* p[6] = {ek, eb, wi, bi, wh, bh};
  const int e = launch_fwd_bf16_prep(p, weights_bf16, hidden, ws, fs, a, st);
  if (e != 0) return e;
  return vals_bf16 ? launch_step_bf16<__nv_bfloat16>(a, st)
                   : launch_step_bf16<float>(a, st);
}

// fused_step_bf16_launch's geometry: as fused_step_geometry (cluster
// always 1), with each pass's blocks an SM and shared memory (pass 0: the
// messages; pass 1: the aggregate and the gate).
int fused_step_bf16_geometry(int vals_bf16, int n_rows, int hidden,
                             int* row_tile, int* cluster, int* slab_rows,
                             int* blocks, int* blocks_per_sm,
                             int* blocks_per_sm_pass1, int* smem_bytes,
                             int* smem_bytes_pass1, int* sms) {
  *sms = device_sms();
  const StepPlan p = step_bf16_plan(n_rows, *sms);
  *row_tile = p.row_tile;
  *cluster = p.cluster;
  *slab_rows = p.slab_rows;
  *blocks = p.blocks;
  *smem_bytes = static_cast<int>(step_bf16_smem(p.row_tile, hidden, 0));
  *smem_bytes_pass1 = static_cast<int>(step_bf16_smem(p.row_tile, hidden, 1));
  int occ[2] = {0, 0};
  const FwdBf16Args a = fwd_bf16_args(nullptr, nullptr, nullptr, nullptr,
                                      nullptr, n_rows, hidden, 0, 0, 0, 1, 0);
  const int e = vals_bf16 ? launch_step_bf16<__nv_bfloat16>(a, 0, occ)
                          : launch_step_bf16<float>(a, 0, occ);
  *blocks_per_sm = occ[0];
  *blocks_per_sm_pass1 = occ[1];
  return e;
}

// n_steps bf16 gated steps (persistent_fwd_kernel_bf16; hist != 0, its
// kHist instance persistent_fwd_hist_kernel_bf16, the bf16 backward's
// recompute sweep: n_steps steps from h0, the caller passes K - 1, each
// step's h into out as hist [n_steps, n_rows, hidden] bf16) in one launch
// after the weights' prep, one block a row group (cluster must be 1): h0,
// out bf16; the weights and the scratch as fused_step_bf16_launch's;
// otherwise as persistent_fwd_launch.
int persistent_fwd_bf16_launch(const void* h0, const void* vals,
                               int vals_bf16, const void* ek, const void* eb,
                               const void* wi, const void* bi, const void* wh,
                               const void* bh, int weights_bf16, void* ws,
                               void* fs, const void* groups, int n_groups,
                               int max_group_rows, int n_steps, int cluster,
                               int hist, void* out, int hidden, int tile,
                               int n_tiles, int bandwidth, void* stream) {
  if (cluster != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FwdBf16Args a = fwd_bf16_args(h0, vals, nullptr, groups, out,
                                n_tiles * tile, hidden, tile, n_tiles,
                                bandwidth, n_steps, max_group_rows);
  const void* p[6] = {ek, eb, wi, bi, wh, bh};
  const int e = launch_fwd_bf16_prep(p, weights_bf16, hidden, ws, fs, a, st);
  if (e != 0) return e;
  if (vals_bf16)
    return hist ? launch_persistent_bf16<__nv_bfloat16, true>(a, n_groups, st)
                : launch_persistent_bf16<__nv_bfloat16, false>(a, n_groups,
                                                               st);
  return hist ? launch_persistent_bf16<float, true>(a, n_groups, st)
              : launch_persistent_bf16<float, false>(a, n_groups, st);
}

// The blocks of persistent_fwd_kernel_bf16 (hist != 0: of its kHist
// instance, persistent_fwd_hist_kernel_bf16) one SM holds for groups of
// up to max_group_rows rows, and their dynamic shared memory.
int persistent_fwd_bf16_occupancy(int vals_bf16, int max_group_rows,
                                  int hidden, int hist, int* blocks,
                                  int* smem_bytes) {
  *smem_bytes =
      static_cast<int>(persistent_fwd_bf16_smem(max_group_rows, hidden));
  const FwdBf16Args a = fwd_bf16_args(nullptr, nullptr, nullptr, nullptr,
                                      nullptr, 0, hidden, 0, 0, 0, 0,
                                      max_group_rows);
  if (vals_bf16)
    return hist ? launch_persistent_bf16<__nv_bfloat16, true>(a, 0, 0, blocks)
                : launch_persistent_bf16<__nv_bfloat16, false>(a, 0, 0,
                                                               blocks);
  return hist ? launch_persistent_bf16<float, true>(a, 0, 0, blocks)
              : launch_persistent_bf16<float, false>(a, 0, 0, blocks);
}

}  // extern "C"
