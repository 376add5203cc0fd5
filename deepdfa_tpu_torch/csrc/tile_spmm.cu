// Block-sparse tile SpMM for Hopper (sm_90a): agg = A @ msg, with A a
// row-sorted list of dense tile x tile blocks of edge multiplicities
// (deepdfa_tpu_torch/ops/tile_spmm.py: TileAdjacency).
//
// tile_spmm_kernel replaces deepdfa_tpu/ops/tile_spmm.py:_spmm_kernel
//                  (launched from _spmm_pallas). The VJP, d msg = A^T @ g,
//                  is the same kernel over the transposed tile lists, as
//                  the reference's _spmm_bwd runs its kernel again.
//
// Plain PyTorch version: tile_spmm_reference in ops/tile_spmm.py. Built
// by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file.
//
// What bounds it. The function is a sparse product: at the training
// batch (N = 16384 rows, H = 128, ~15k nonzeros, ~145 of the 128 x 128
// tiles hold an edge) it needs ~4 MFLOP against ~21 MB of compulsory
// traffic (the edge tiles' bf16 values, msg in, out): bound by bytes, a
// few microseconds at 3.35 TB/s (ops/tile_spmm.py:kernel_cost;
// chip_smoke.py prints the bound beside the measured time and the card's
// name and power limit). The dense-tile form does ~0.9 GFLOP of f32 FMAs
// there, nearly all on zeros: this simple kernel is bound by those
// operations, and PERF.md holds its time against the bound and against
// cuSPARSE.
//
// Design.
// * The TPU kernel walks one grid step per tile in sequence and keeps a
//   row tile's output block resident across its run (zeroed when the row
//   changes). Hopper blocks run in parallel and in no order, so here one
//   block owns one (row tile, 64-column chunk of H) and loops over its
//   row's run [row_ptr[r], row_ptr[r + 1]) itself: each output element
//   has one owner, no atomics, and the result does not depend on the
//   schedule.
// * row_ptr covers the built tiles only (the tiles with an edge and one
//   zero filler for each row tile no edge reaches). The reference pads
//   the list to a power-of-two budget with zero tiles on the last row
//   tile; at the training batch that is ~300 of 512 tiles, which a block
//   walking the stored list would multiply in series on one row. They
//   are zero by construction, so skipping them computes the same
//   function.
// * A block writes every row of its tile, so a row tile with no tiles
//   comes out zero; the fillers the reference needs to zero such rows
//   are multiplied like any tile (they are cheap).
// * Per tile, 32-column slabs of the tile's values (bf16 or f32, turned
//   into f32 as they are staged) and the matching 32 sender rows of msg
//   are staged in shared memory; each of 256 threads keeps an 8-row x
//   4-column block of the output in registers and accumulates with f32
//   FMAs: no TF32, as the reference runs f32 at Precision.HIGHEST. msg is
//   never rounded to bf16.
// * tile (<= 128) is a runtime argument; H is any width, its edge masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 128;
constexpr int kColChunk = 64;   // H columns a block owns
constexpr int kSlab = 32;       // tile columns staged at once
constexpr int kColThreads = kColChunk / 4;           // 16 threads across
constexpr int kRowThreads = kThreads / kColThreads;  // 16 threads down
constexpr int kRowsPerThread = kMaxTile / kRowThreads;  // 8

__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_val(const float* p) { return *p; }

template <typename VT>
__global__ void __launch_bounds__(kThreads)
    tile_spmm_kernel(const VT* __restrict__ vals,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ cols,
                     const float* __restrict__ msg, float* __restrict__ out,
                     int tile, int hidden) {
  __shared__ float sa[kMaxTile][kSlab + 1];
  __shared__ __align__(16) float sb[kSlab][kColChunk];
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kColChunk;
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  float acc[kRowsPerThread][4];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;

  const int begin = row_ptr[r];
  const int end = row_ptr[r + 1];
  for (int k = begin; k < end; ++k) {
    const VT* a = vals + static_cast<size_t>(k) * tile * tile;
    const float* b = msg + static_cast<size_t>(cols[k]) * tile * hidden;
    for (int j0 = 0; j0 < tile; j0 += kSlab) {
      const int width = min(kSlab, tile - j0);
      __syncthreads();  // the previous slab's reads are done
      // A[:, j0:j0+width], zero past the tile's rows and the slab's width.
      for (int e = threadIdx.x; e < kMaxTile * kSlab; e += kThreads) {
        const int i = e / kSlab, j = e % kSlab;
        sa[i][j] = (i < tile && j < width)
                       ? load_val(a + static_cast<size_t>(i) * tile + j0 + j)
                       : 0.f;
      }
      // msg rows j0..j0+width of the sender tile, this block's columns.
      for (int e = threadIdx.x; e < kSlab * kColChunk; e += kThreads) {
        const int j = e / kColChunk, c = e % kColChunk;
        sb[j][c] = (j < width && c0 + c < hidden)
                       ? b[static_cast<size_t>(j0 + j) * hidden + c0 + c]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < width; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(&sb[j][tx * 4]);
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const float av = sa[ty + kRowThreads * m][j];
          acc[m][0] = fmaf(av, bv.x, acc[m][0]);
          acc[m][1] = fmaf(av, bv.y, acc[m][1]);
          acc[m][2] = fmaf(av, bv.z, acc[m][2]);
          acc[m][3] = fmaf(av, bv.w, acc[m][3]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int row = ty + kRowThreads * m;
    if (row >= tile) continue;
    float* o = out + (static_cast<size_t>(r) * tile + row) * hidden;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = c0 + tx * 4 + q;
      if (col < hidden) o[col] = acc[m][q];
    }
  }
}

}  // namespace

extern "C" {

// out [n_row_tiles * tile, hidden] f32 = A @ msg, msg [n_row_tiles * tile,
// hidden] f32. vals [n_nz, tile, tile] is bf16 (vals_bf16 != 0) or f32;
// cols [n_nz] int32 sender tiles; row_ptr [n_row_tiles + 1] int32, row
// tile r's tiles at [row_ptr[r], row_ptr[r + 1]). 1 <= tile <= 128.
// Returns the cudaError_t of the launch.
int tile_spmm_launch(const void* vals, int vals_bf16, const void* row_ptr,
                     const void* cols, const void* msg, void* out,
                     int n_row_tiles, int tile, int hidden, void* stream) {
  if (tile < 1 || tile > kMaxTile || hidden < 1 || n_row_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_row_tiles, (hidden + kColChunk - 1) / kColChunk);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* cl = static_cast<const int*>(cols);
  const float* m = static_cast<const float*>(msg);
  float* o = static_cast<float*>(out);
  if (vals_bf16)
    tile_spmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(vals), rp, cl, m, o, tile, hidden);
  else
    tile_spmm_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(vals), rp, cl, m, o, tile, hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
