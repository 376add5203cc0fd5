// Segment sums in row order: out[s, c] = the rows of bucket s, in row
// order, added into a running sum at the data's dtype (bf16: rounded to
// bf16 after each add, as the reference's jax.ops.segment_sum adds bf16
// data on XLA's CPU backend). The port's own kernel: it replaces no
// Pallas kernel (the reference leaves the segment sum to XLA). It serves
// two callers on the card, the segment message lane's aggregate and the
// attention pooling's per-graph sums, and it exists so that both keep
// one order of adds whatever the threads do (index_add_ adds with
// atomics in the order they arrive) and read nothing back to the host
// (the level loop of graphs/segment.py reads each level's size), so a
// CUDA graph can capture them.
//
// The plan comes from the wrapper (graphs/segment.py:segment_sum_plan),
// on the device: order, the rows sorted by bucket by a stable sort, and
// offsets, bucket s owning order[offsets[s] .. offsets[s + 1]). One
// thread a (bucket, column), walking its bucket's rows: the chain of
// roundings is sequential per (bucket, column), so it is neither an
// elementwise pass nor a tree reduction. Consecutive threads take
// consecutive columns of one bucket, so a warp reads a row's columns in
// one coalesced pass. Bound by the bytes it reads: each row once, the
// plan and the output once (a few rows a bucket).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float add_at(float acc, float x) { return acc + x; }
__device__ __forceinline__ void set_zero(float& acc) { acc = 0.0f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& acc) {
  acc = __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ __nv_bfloat16 add_at(__nv_bfloat16 acc,
                                                __nv_bfloat16 x) {
  return __float2bfloat16_rn(__bfloat162float(acc) + __bfloat162float(x));
}

template <typename T>
__device__ __forceinline__ void segment_sum_body(
    const T* __restrict__ data, const long long* __restrict__ order,
    const long long* __restrict__ offsets, T* __restrict__ out, int n_seg,
    int cols) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(n_seg) * cols) return;
  const int s = static_cast<int>(i / cols);
  const int c = static_cast<int>(i % cols);
  T acc;
  set_zero(acc);
  const long long end = offsets[s + 1];
  for (long long k = offsets[s]; k < end; ++k)
    acc = add_at(acc, data[order[k] * cols + c]);
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const float* __restrict__ data,
                       const long long* __restrict__ order,
                       const long long* __restrict__ offsets,
                       float* __restrict__ out, int n_seg, int cols) {
  segment_sum_body(data, order, offsets, out, n_seg, cols);
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel_bf16(const __nv_bfloat16* __restrict__ data,
                            const long long* __restrict__ order,
                            const long long* __restrict__ offsets,
                            __nv_bfloat16* __restrict__ out, int n_seg,
                            int cols) {
  segment_sum_body(data, order, offsets, out, n_seg, cols);
}

}  // namespace

extern "C" {

// data [n, cols] (f32, or bf16 with bf16 != 0), order [n] and offsets
// [n_seg + 1] (int64), out [n_seg, cols] at the data's dtype; every
// element of out is written (a bucket with no rows gets 0).
int segment_sum_launch(const void* data, const void* order,
                       const void* offsets, void* out, int n_seg, int cols,
                       int bf16, cudaStream_t st) {
  const long long n = static_cast<long long>(n_seg) * cols;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (bf16) {
    segment_sum_kernel_bf16<<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(data),
        static_cast<const long long*>(order),
        static_cast<const long long*>(offsets),
        static_cast<__nv_bfloat16*>(out), n_seg, cols);
  } else {
    segment_sum_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(data), static_cast<const long long*>(order),
        static_cast<const long long*>(offsets), static_cast<float*>(out),
        n_seg, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
