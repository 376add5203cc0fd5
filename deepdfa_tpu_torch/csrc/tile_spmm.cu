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
//                  Half the bytes of the f32 kernel's msg rows and
//                  output: bound by bytes (kernel_cost at 2 bytes a bf16
//                  element). Its rows hold under one nonzero each on
//                  average, so a row's work is two ptr reads, a pair or
//                  none and one output row: the launch and the issue of
//                  many near-empty rows, not the bytes, set its time. So
//                  a row takes a group of lanes, as few as its width
//                  needs at 8 bf16 values (16 bytes) a lane (H 128: 16
//                  lanes, two rows a warp, 16 rows a block, one wave of
//                  blocks at the training batch); the warp's row pointers
//                  come in one load, its rows' (src, val) pairs, which
//                  are contiguous in the lists, in one more (32 at a
//                  time), and each group takes its row's pairs from their
//                  lanes by shuffles. The sum is the f32 kernel's: list
//                  order, f32 FMAs, one rounding, so the output is its
//                  plain version's bit for bit.
//                  Widths that are no multiple of 8, or unaligned rows,
//                  take 4 values (8 bytes) or one a lane, 32 lanes a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

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

// bf16 rows: VEC values a lane (8: 16 bytes, 4: 8 bytes, or 1), widened
// (exact); the sums rounded once (nearest even) on the way out.
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_pair(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int VEC>
struct Bf16Vec;
template <>
struct Bf16Vec<8> {
  using T = uint4;
  __device__ static T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void fma(float v, T m, float* acc) {
    const uint32_t w[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[2 * q] = fmaf(v, bf16_lo(w[q]), acc[2 * q]);
      acc[2 * q + 1] = fmaf(v, bf16_hi(w[q]), acc[2 * q + 1]);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* acc) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pair(acc[0], acc[1]), bf16_pair(acc[2], acc[3]),
                   bf16_pair(acc[4], acc[5]), bf16_pair(acc[6], acc[7]));
  }
};
template <>
struct Bf16Vec<4> {
  using T = uint2;
  __device__ static T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ static void fma(float v, T m, float* acc) {
    acc[0] = fmaf(v, bf16_lo(m.x), acc[0]);
    acc[1] = fmaf(v, bf16_hi(m.x), acc[1]);
    acc[2] = fmaf(v, bf16_lo(m.y), acc[2]);
    acc[3] = fmaf(v, bf16_hi(m.y), acc[3]);
  }
  __device__ static void store(__nv_bfloat16* p, const float* acc) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_pair(acc[0], acc[1]), bf16_pair(acc[2], acc[3]));
  }
};
template <>
struct Bf16Vec<1> {
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

// tile_spmm_kernel_bf16's layout (scripts/torch_wgrad_bf16_layouts.py
// times others): row sets a warp takes (each 32 / lanes rows), threads a
// block.
constexpr int kRowSets = 1;
constexpr int kBf16Threads = 256;
constexpr int kBf16Warps = kBf16Threads / 32;
static_assert(kRowSets >= 1 && kRowSets <= 16, "a warp's rows: at most 16");

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

// The bf16 instance: bf16 msg and out, VEC values a lane (Bf16Vec), a
// group of 2^lanes_log2 lanes a row (2..32), 32 >> lanes_log2 rows a set,
// kRowSets sets a warp; blockIdx.y picks the columns. The warp's rows'
// pairs are contiguous in the lists: it loads them 32 at a time, one a
// lane, and each group takes its row's from their lanes by shuffles; the
// sets' msg rows load together before their FMAs.
template <int VEC>
__global__ void __launch_bounds__(kBf16Threads)
    tile_spmm_kernel_bf16(const int* __restrict__ ptr,
                          const int* __restrict__ src,
                          const float* __restrict__ val,
                          const __nv_bfloat16* __restrict__ msg,
                          __nv_bfloat16* __restrict__ out, int n_rows,
                          int hidden, int lanes_log2) {
  using B = Bf16Vec<VEC>;
  constexpr unsigned kAll = 0xffffffffu;
  const int lanes = 1 << lanes_log2, per_set = 32 >> lanes_log2;
  const int lane = threadIdx.x % 32;
  const int w0 =
      (blockIdx.x * kBf16Warps + threadIdx.x / 32) * kRowSets * per_set;
  if (w0 >= n_rows) return;  // the whole warp: no block-wide barrier below
  // The warp's row pointers, ptr[w0 + j] in lane j (j <= its rows).
  const int rows = min(kRowSets * per_set, n_rows - w0);
  const int pj = lane <= rows ? ptr[w0 + lane] : 0;
  const int base = __shfl_sync(kAll, pj, 0);
  const int total = __shfl_sync(kAll, pj, rows) - base;
  const int col = (blockIdx.y * lanes + (lane & (lanes - 1))) * VEC;
  // Each set's row: its pairs [b, e) counted from base.
  int b[kRowSets], e[kRowSets];
  bool live[kRowSets];
#pragma unroll
  for (int set = 0; set < kRowSets; ++set) {
    const int j = set * per_set + (lane >> lanes_log2);
    b[set] = __shfl_sync(kAll, pj, j) - base;
    e[set] = __shfl_sync(kAll, pj, j + 1) - base;
    live[set] = j < rows && col < hidden;  // VEC 4, 8: H % VEC == 0
    if (j >= rows) e[set] = b[set];
  }
  float acc[kRowSets][VEC];
#pragma unroll
  for (int set = 0; set < kRowSets; ++set)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[set][q] = 0.f;
  for (int c0 = 0; c0 < total; c0 += 32) {
    int s_lane = 0;
    float v_lane = 0.f;
    if (c0 + lane < total) {
      s_lane = src[base + c0 + lane];
      v_lane = val[base + c0 + lane];
    }
    // Each set's pairs in this chunk: lanes lo .. lo + cnt - 1.
    int lo[kRowSets], cnt[kRowSets], most = 0;
#pragma unroll
    for (int set = 0; set < kRowSets; ++set) {
      lo[set] = max(b[set], c0) - c0;
      cnt[set] = max(0, min(e[set], c0 + 32) - c0 - lo[set]);
      most = max(most, cnt[set]);
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      most = max(most, __shfl_xor_sync(kAll, most, o));
    for (int k = 0; k < most; ++k) {
      typename B::T m[kRowSets];
      float v[kRowSets];
      bool on[kRowSets];
#pragma unroll
      for (int set = 0; set < kRowSets; ++set) {
        const int idx = min(lo[set] + k, 31);
        const int s = __shfl_sync(kAll, s_lane, idx);
        v[set] = __shfl_sync(kAll, v_lane, idx);
        on[set] = live[set] && k < cnt[set];
        if (on[set])
          m[set] = B::load(msg + static_cast<size_t>(s) * hidden + col);
      }
#pragma unroll
      for (int set = 0; set < kRowSets; ++set)
        if (on[set]) B::fma(v[set], m[set], acc[set]);
    }
  }
#pragma unroll
  for (int set = 0; set < kRowSets; ++set)
    if (live[set]) {
      const int r = w0 + set * per_set + (lane >> lanes_log2);
      B::store(out + static_cast<size_t>(r) * hidden + col, acc[set]);
    }
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
  auto aligned = [&](size_t a) {
    return reinterpret_cast<size_t>(msg) % a == 0 &&
           reinterpret_cast<size_t>(out) % a == 0;
  };
  const int vec = hidden % 8 == 0 && aligned(16)  ? 8
                  : hidden % 4 == 0 && aligned(8) ? 4
                                                  : 1;
  // Lanes a row: 16-byte lanes as few as cover H, else 32; enough that a
  // warp's rows are at most 16 (their 17 pointers in one load).
  int lanes_log2 = 5;
  if (vec == 8) {
    lanes_log2 = 1;
    while (lanes_log2 < 5 && ((8 << lanes_log2) < hidden ||
                              kRowSets * (32 >> lanes_log2) > 16))
      ++lanes_log2;
  }
  const int rows = kBf16Warps * kRowSets * (32 >> lanes_log2);  // a block
  const int cols = vec << lanes_log2;  // H columns a group covers
  const dim3 grid((n_rows + rows - 1) / rows, (hidden + cols - 1) / cols);
  const auto kernel = vec == 8   ? tile_spmm_kernel_bf16<8>
                      : vec == 4 ? tile_spmm_kernel_bf16<4>
                                 : tile_spmm_kernel_bf16<1>;
  kernel<<<grid, kBf16Threads, 0, st>>>(p, s, v, m, o, n_rows, hidden,
                                        lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
