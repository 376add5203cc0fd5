// Sparse message aggregation for Hopper (sm_90a): agg = A @ msg, with A
// the batch's edge multiplicities as receiver-major nonzero lists
// (deepdfa_tpu_torch/ops/tile_spmm.py: CsrAdjacency).
//
// tile_spmm_kernel replaces deepdfa_tpu/ops/tile_spmm.py:_spmm_kernel
//                  (launched from _spmm_pallas). The VJP, d msg = A^T @ g,
//                  is the same kernel over the transposed lists, as the
//                  reference's _spmm_bwd runs its kernel again.
//
// Plain PyTorch version: tile_spmm_reference in ops/tile_spmm.py. Built
// by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a library with the plain C interface at the bottom of this file.
//
// What bounds it. At the training batch (N = 16384 rows, H = 128, ~15k
// nonzeros, under one a row) the product needs ~4 MFLOP against ~12 MB of
// compulsory traffic: the lists (8 bytes a nonzero, 4 a row), the distinct
// sender rows of msg, and out, which is written whole. It is bound by
// bytes, a few microseconds at 3.35 TB/s (ops/tile_spmm.py:kernel_cost;
// chip_smoke.py prints the bound beside the measured time and the card's
// name and power limit).
//
// Design.
// * The TPU kernel multiplies dense 128 x 128 tiles on its matrix unit,
//   one grid step a tile, with a row tile's output block resident across
//   its run. That is the TPU's schedule, not the function: here one warp
//   owns one receiver row and a 32 x VEC column slice of H, walks the
//   row's nonzeros [ptr[r], ptr[r + 1]) in list order (senders ascending)
//   and accumulates val * msg[src] with f32 FMAs: no TF32, as the
//   reference runs f32 at Precision.HIGHEST.
// * Each output element has one owner and a fixed order of summation: no
//   atomics, and the result does not depend on the schedule. A row with
//   no nonzero is written as zeros.
// * The warp loads up to 32 (src, val) pairs at once, one a lane, and
//   broadcasts them with shuffles; msg rows are read as float4 (16 bytes a
//   lane, coalesced along H) when H is a multiple of 4 and the pointers
//   are 16-byte aligned, else one float a lane (VEC 1), the ragged edge of
//   H masked. Nothing past ptr[N] is read.
//
// tile_spmm_kernel_bf16 replaces the same _spmm_kernel at a bf16 msg
//                  (FlowGNN(dtype="bfloat16") training on the tile lane,
//                  forward over A and the VJP over A^T). The reference's
//                  rule: bf16-exact multiplicities give a bf16 x bf16
//                  product, f32 ones upcast msg; either way each product
//                  is exact in f32 (or, for a multiplicity that is not
//                  bf16-exact, the f32 product the reference takes), the
//                  sums are f32 and the output is rounded once to bf16.
//                  The same warp-per-row walk in list order, msg read as
//                  4 bf16 values (8 bytes) a lane and widened, the output
//                  stored as 4 bf16 values a lane. Half the bytes of the
//                  f32 kernel's msg rows and output: bound by bytes
//                  (kernel_cost at 2 bytes a bf16 element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows a block

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static void fma(float v, T m, float* acc) {
    acc[0] = fmaf(v, m.x, acc[0]);
    acc[1] = fmaf(v, m.y, acc[1]);
    acc[2] = fmaf(v, m.z, acc[2]);
    acc[3] = fmaf(v, m.w, acc[3]);
  }
  __device__ static T pack(const float* acc) {
    return make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static void fma(float v, T m, float* acc) {
    acc[0] = fmaf(v, m, acc[0]);
  }
  __device__ static T pack(const float* acc) { return acc[0]; }
};

// bf16 rows: 4 values (8 bytes) a lane, widened (exact); the sums
// rounded once (nearest even) on the way out.
struct Bf16x4 {
  using T = uint2;
  __device__ static T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static void fma(float v, T m, float* acc) {
    acc[0] = fmaf(v, __uint_as_float(m.x << 16), acc[0]);
    acc[1] = fmaf(v, __uint_as_float(m.x & 0xffff0000u), acc[1]);
    acc[2] = fmaf(v, __uint_as_float(m.y << 16), acc[2]);
    acc[3] = fmaf(v, __uint_as_float(m.y & 0xffff0000u), acc[3]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* acc) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) =
        __floats2bfloat162_rn(acc[0], acc[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) =
        __floats2bfloat162_rn(acc[2], acc[3]);
    *reinterpret_cast<uint2*>(p) = u;
  }
};
struct Bf16x1 {
  using T = float;
  __device__ static T load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void fma(float v, T m, float* acc) {
    acc[0] = fmaf(v, m, acc[0]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* acc) {
    *p = __float2bfloat16_rn(acc[0]);
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    tile_spmm_kernel(const int* __restrict__ ptr, const int* __restrict__ src,
                     const float* __restrict__ val,
                     const float* __restrict__ msg, float* __restrict__ out,
                     int n_rows, int hidden) {
  using V = typename Vec<VEC>::T;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= n_rows) return;  // the whole warp: no block-wide barrier below
  const int col = (blockIdx.y * 32 + lane) * VEC;
  const bool live = col < hidden;  // VEC 4 needs hidden % 4 == 0
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;

  const int begin = ptr[r], end = ptr[r + 1];
  for (int e0 = begin; e0 < end; e0 += 32) {
    const int n = min(32, end - e0);
    int s_lane = 0;
    float v_lane = 0.f;
    if (lane < n) {
      s_lane = src[e0 + lane];
      v_lane = val[e0 + lane];
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(0xffffffffu, s_lane, j);
      const float v = __shfl_sync(0xffffffffu, v_lane, j);
      if (live) {
        const V m = __ldg(reinterpret_cast<const V*>(
            msg + static_cast<size_t>(s) * hidden + col));
        Vec<VEC>::fma(v, m, acc);
      }
    }
  }
  if (live)
    *reinterpret_cast<V*>(out + static_cast<size_t>(r) * hidden + col) =
        Vec<VEC>::pack(acc);
}

// The bf16 instance: as tile_spmm_kernel, bf16 msg and out, VEC values a
// lane (Bf16x4 or Bf16x1).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    tile_spmm_kernel_bf16(const int* __restrict__ ptr,
                          const int* __restrict__ src,
                          const float* __restrict__ val,
                          const __nv_bfloat16* __restrict__ msg,
                          __nv_bfloat16* __restrict__ out, int n_rows,
                          int hidden) {
  using B = typename std::conditional<VEC == 4, Bf16x4, Bf16x1>::type;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= n_rows) return;  // the whole warp: no block-wide barrier below
  const int col = (blockIdx.y * 32 + lane) * VEC;
  const bool live = col < hidden;  // VEC 4 needs hidden % 4 == 0
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;

  const int begin = ptr[r], end = ptr[r + 1];
  for (int e0 = begin; e0 < end; e0 += 32) {
    const int n = min(32, end - e0);
    int s_lane = 0;
    float v_lane = 0.f;
    if (lane < n) {
      s_lane = src[e0 + lane];
      v_lane = val[e0 + lane];
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int s = __shfl_sync(0xffffffffu, s_lane, j);
      const float v = __shfl_sync(0xffffffffu, v_lane, j);
      if (live)
        B::fma(v, B::load(msg + static_cast<size_t>(s) * hidden + col), acc);
    }
  }
  if (live) B::store(out + static_cast<size_t>(r) * hidden + col, acc);
}

}  // namespace

extern "C" {

// out [n_rows, hidden] f32 = A @ msg, msg [n_rows, hidden] f32. ptr
// [n_rows + 1] int32, row r's nonzeros at [ptr[r], ptr[r + 1]); src [nnz]
// int32 sender rows; val [nnz] f32 multiplicities. Returns the
// cudaError_t of the launch.
int tile_spmm_launch(const void* ptr, const void* src, const void* val,
                     const void* msg, void* out, int n_rows, int hidden,
                     void* stream) {
  if (hidden < 1 || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* s = static_cast<const int*>(src);
  const float* v = static_cast<const float*>(val);
  const float* m = static_cast<const float*>(msg);
  float* o = static_cast<float*>(out);
  const bool vec4 = hidden % 4 == 0 &&
                    reinterpret_cast<size_t>(msg) % 16 == 0 &&
                    reinterpret_cast<size_t>(out) % 16 == 0;
  const int cols = vec4 ? 128 : 32;  // H columns a warp covers
  const dim3 grid((n_rows + kWarps - 1) / kWarps, (hidden + cols - 1) / cols);
  if (vec4)
    tile_spmm_kernel<4><<<grid, kThreads, 0, st>>>(p, s, v, m, o, n_rows,
                                                   hidden);
  else
    tile_spmm_kernel<1><<<grid, kThreads, 0, st>>>(p, s, v, m, o, n_rows,
                                                   hidden);
  return static_cast<int>(cudaGetLastError());
}

// tile_spmm_launch at bf16 (tile_spmm_kernel_bf16): msg and out [n_rows,
// hidden] bf16; otherwise the same.
int tile_spmm_bf16_launch(const void* ptr, const void* src, const void* val,
                          const void* msg, void* out, int n_rows, int hidden,
                          void* stream) {
  if (hidden < 1 || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* s = static_cast<const int*>(src);
  const float* v = static_cast<const float*>(val);
  const __nv_bfloat16* m = static_cast<const __nv_bfloat16*>(msg);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const bool vec4 = hidden % 4 == 0 &&
                    reinterpret_cast<size_t>(msg) % 8 == 0 &&
                    reinterpret_cast<size_t>(out) % 8 == 0;
  const int cols = vec4 ? 128 : 32;  // H columns a warp covers
  const dim3 grid((n_rows + kWarps - 1) / kWarps, (hidden + cols - 1) / cols);
  if (vec4)
    tile_spmm_kernel_bf16<4><<<grid, kThreads, 0, st>>>(
        p, s, v, m, o, n_rows, hidden);
  else
    tile_spmm_kernel_bf16<1><<<grid, kThreads, 0, st>>>(
        p, s, v, m, o, n_rows, hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
