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
// The kernel reads its buckets' row ranges from sorted keys: bucket s
// owns the rows [lower_bound(s), lower_bound(s + 1)) of the keys, which
// are either the ids themselves, keyed by the mask (a masked row takes
// the id n_seg, which names no bucket), when the caller says they are
// non-decreasing, or a plan's keys (graphs/segment.py:segment_sum_plan:
// the keyed ids sorted by one stable sort, with the rows in that order).
// No histogram, offsets or host read.
//
// Its bytes bound is far under a launch at the port's shapes; what it
// waits on is latency: the search, then the chain of each (bucket,
// column), whose adds are sequential (neither an elementwise pass nor a
// tree reduction). So: one warp a (bucket, column slab). The warp finds
// both bounds at once by a 32-way search (each round, every lane probes
// one key of each range and a ballot keeps the part that holds the
// bound: 4096 keys take 3 rounds of loads). It then walks its rows 32 at
// a time: one coalesced load of their indices (plan mode), handed out by
// shuffle, and the rows' loads issued ahead of their adds, so a chain
// waits on one latency a group of rows rather than one a row. The adds
// stay in row order, one rounding each (no fast-math in the build).
//
// Two lane widths, by what the call needs (host ints only, so a CUDA
// graph's replays keep the launch). Wide lanes, 16 bytes (f32 4 columns
// a lane, bf16 8), 8 rows ahead of the adds, double-buffered: few warps,
// for many buckets (the segment lane's aggregate, a bucket a node).
// Narrow lanes, 4 bytes (f32 one column, bf16 a pair), a whole group of
// 32 rows in flight at once: columns split finely, for few buckets with
// many rows (the pooling: 16 graphs of up to ~50 nodes, two rounds of
// loads where wide lanes take seven). A width or base that is not
// aligned takes one column a lane. Up to two operands share the rows
// (the pooling's weighted rows and its softmax denominators): one
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// Wide lanes when the call has at least this many (bucket, wide slab)
// warps: enough to hold every SM with a few, each walking few rows.
constexpr long long kWideWarps = 512;

enum LaneKind { kScalar = 0, kNarrow = 1, kWide = 2 };

struct SegArgs {
  const int* keys;            // [n_rows] sorted (after keying by mask)
  const unsigned char* mask;  // [n_rows] or null: key = mask ? id : n_seg
  const long long* order;     // [n_rows] or null: row k is k
  int n_rows;
  int n_seg;
  const void* data[2];  // [n_rows, cols[i]] at the dtype
  void* out[2];         // [n_seg, cols[i]]
  int cols[2];
  int lanes[2];  // LaneKind of operand i
  int slabs[2];  // column slabs of operand i a bucket
};

__device__ __forceinline__ int key_at(const SegArgs& a, int p) {
  const int id = __ldg(a.keys + p);
  return (a.mask != nullptr && __ldg(a.mask + p) == 0) ? a.n_seg : id;
}

// lo and hi: the first row whose key is >= s, and >= s + 1, both by a
// 32-way search of the warp. The range [lo_i, hi_i] always holds the
// bound: each round a lane probes lo_i + lane * step_i, the ballot counts
// the probes under the target (a prefix of the lanes, keys being sorted),
// and the bound lies past the last of them and at or before the next.
__device__ __forceinline__ void bucket_rows(const SegArgs& a, int s, int lane,
                                            int& lo, int& hi) {
  int lo0 = 0, hi0 = a.n_rows, lo1 = 0, hi1 = a.n_rows;
  while (lo0 < hi0 || lo1 < hi1) {
    const int st0 = (hi0 - lo0 + 31) >> 5;
    const int st1 = (hi1 - lo1 + 31) >> 5;
    const int p0 = lo0 + lane * st0;
    const int p1 = lo1 + lane * st1;
    const bool v0 = p0 < hi0;
    const bool v1 = p1 < hi1;
    const int k0 = v0 ? key_at(a, p0) : 0;
    const int k1 = v1 ? key_at(a, p1) : 0;
    const int c0 = __popc(__ballot_sync(kFull, v0 && k0 < s));
    const int c1 = __popc(__ballot_sync(kFull, v1 && k1 < s + 1));
    if (c0 == 0) {
      hi0 = lo0;
    } else {
      hi0 = min(lo0 + c0 * st0, hi0);
      lo0 += (c0 - 1) * st0 + 1;
    }
    if (c1 == 0) {
      hi1 = lo1;
    } else {
      hi1 = min(lo1 + c1 * st1, hi1);
      lo1 += (c1 - 1) * st1 + 1;
    }
  }
  lo = lo0;
  hi = lo1;
}

// A lane's VEC columns of one row, as one load gives them: f32 values,
// or bf16 values kept packed in 32-bit words until their add.
template <typename T, int VEC>
struct Lane {
  float v[VEC];
  __device__ __forceinline__ float at(int i) const { return v[i]; }
};

template <int VEC>
struct BfLane {
  unsigned w[VEC / 2];
  // The low half is the lower column (little-endian bf16 pairs).
  __device__ __forceinline__ float at(int i) const {
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                   : (w[i >> 1] << 16));
  }
};

template <>
struct Lane<__nv_bfloat16, 8> : BfLane<8> {};
template <>
struct Lane<__nv_bfloat16, 2> : BfLane<2> {};

__device__ __forceinline__ void load_lane(Lane<float, 4>& x, const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  x.v[0] = q.x;
  x.v[1] = q.y;
  x.v[2] = q.z;
  x.v[3] = q.w;
}

__device__ __forceinline__ void load_lane(Lane<float, 1>& x, const float* p) {
  x.v[0] = __ldg(p);
}

__device__ __forceinline__ void load_lane(Lane<__nv_bfloat16, 8>& x,
                                          const __nv_bfloat16* p) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  x.w[0] = q.x;
  x.w[1] = q.y;
  x.w[2] = q.z;
  x.w[3] = q.w;
}

__device__ __forceinline__ void load_lane(Lane<__nv_bfloat16, 2>& x,
                                          const __nv_bfloat16* p) {
  x.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ void load_lane(Lane<__nv_bfloat16, 1>& x,
                                          const __nv_bfloat16* p) {
  x.v[0] = __bfloat162float(p[0]);
}

// One add of the chain at the data's dtype: f32 as is; bf16 rounded to
// bf16 after each add (the running sum holds bf16 values in f32).
template <typename T>
__device__ __forceinline__ float add_at(float acc, float x);

template <>
__device__ __forceinline__ float add_at<float>(float acc, float x) {
  return acc + x;
}

template <>
__device__ __forceinline__ float add_at<__nv_bfloat16>(float acc, float x) {
  return __bfloat162float(__float2bfloat16_rn(acc + x));
}

__device__ __forceinline__ void store_lane(float* p, const float* acc,
                                           Lane<float, 4>*) {
  *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

__device__ __forceinline__ void store_lane(float* p, const float* acc,
                                           Lane<float, 1>*) {
  *p = acc[0];
}

// Each bf16 running sum holds a bf16 value: its high half is exact.
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xffff0000u);
}

__device__ __forceinline__ void store_lane(__nv_bfloat16* p, const float* acc,
                                           Lane<__nv_bfloat16, 8>*) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(bf16_pair(acc[0], acc[1]), bf16_pair(acc[2], acc[3]),
                 bf16_pair(acc[4], acc[5]), bf16_pair(acc[6], acc[7]));
}

__device__ __forceinline__ void store_lane(__nv_bfloat16* p, const float* acc,
                                           Lane<__nv_bfloat16, 2>*) {
  *reinterpret_cast<unsigned*>(p) = bf16_pair(acc[0], acc[1]);
}

__device__ __forceinline__ void store_lane(__nv_bfloat16* p, const float* acc,
                                           Lane<__nv_bfloat16, 1>*) {
  *p = __float2bfloat16_rn(acc[0]);
}

// The warp's slab of one operand: rows [lo, hi) of its bucket in row
// order, their loads U rows ahead of the adds (U < 32: the next group
// loads while this one adds; U = 32: a whole group of indices at once).
template <typename T, int VEC, int U>
__device__ __forceinline__ void walk(const T* __restrict__ data,
                                     T* __restrict__ out, int cols,
                                     const long long* __restrict__ order,
                                     int slab, int s, int lo, int hi,
                                     int lane) {
  const int col = (slab * 32 + lane) * VEC;
  const bool active = col < cols;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
  int next_row = 0;
  if (order != nullptr && lo + lane < hi)
    next_row = static_cast<int>(__ldg(order + lo + lane));
  for (int base = lo; base < hi; base += 32) {
    const int cnt = min(32, hi - base);
    const int my_row = order != nullptr ? next_row : base + lane;
    // The next 32 rows' indices, loaded while these are summed.
    if (order != nullptr && base + 32 + lane < hi)
      next_row = static_cast<int>(__ldg(order + base + 32 + lane));
    Lane<T, VEC> cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = __shfl_sync(kFull, my_row, u);
      if (u < cnt && active)
        load_lane(cur[u], data + static_cast<long long>(r) * cols + col);
    }
    for (int g = 0; g < cnt; g += U) {
      Lane<T, VEC> nxt[U];
      if constexpr (U < 32) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int r = __shfl_sync(kFull, my_row, (g + U + u) & 31);
          if (g + U + u < cnt && active)
            load_lane(nxt[u], data + static_cast<long long>(r) * cols + col);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g + u < cnt) {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = add_at<T>(acc[v], cur[u].at(v));
        }
        if constexpr (U < 32) cur[u] = nxt[u];
      }
    }
  }
  if (active)
    store_lane(out + static_cast<long long>(s) * cols + col, acc,
               static_cast<Lane<T, VEC>*>(nullptr));
}

// Columns a lane of each kind: f32 wide 4, narrow 1; bf16 wide 8,
// narrow 2 (a packed pair); scalar 1.
template <typename T>
struct Width;
template <>
struct Width<float> {
  static constexpr int kWide = 4, kNarrow = 1;
};
template <>
struct Width<__nv_bfloat16> {
  static constexpr int kWide = 8, kNarrow = 2;
};

template <typename T>
__device__ __forceinline__ void segment_sum_body(const SegArgs& a) {
  const int lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  const int per_bucket = a.slabs[0] + a.slabs[1];
  if (w >= static_cast<long long>(a.n_seg) * per_bucket) return;  // warp
  const int s = static_cast<int>(w / per_bucket);
  int slab = static_cast<int>(w % per_bucket);
  // Operand 0's slabs first, then operand 1's (selects, not an index
  // into the parameters, which would copy them to local memory).
  const bool second = slab >= a.slabs[0];
  if (second) slab -= a.slabs[0];
  const T* data = static_cast<const T*>(second ? a.data[1] : a.data[0]);
  T* out = static_cast<T*>(second ? a.out[1] : a.out[0]);
  const int cols = second ? a.cols[1] : a.cols[0];
  const int lanes = second ? a.lanes[1] : a.lanes[0];
  int lo, hi;
  bucket_rows(a, s, lane, lo, hi);
  if (lanes == kWide)
    walk<T, Width<T>::kWide, 8>(data, out, cols, a.order, slab, s, lo, hi,
                                lane);
  else if (lanes == kNarrow)
    walk<T, Width<T>::kNarrow, 32>(data, out, cols, a.order, slab, s, lo, hi,
                                   lane);
  else
    walk<T, 1, 32>(data, out, cols, a.order, slab, s, lo, hi, lane);
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const SegArgs a) {
  segment_sum_body<float>(a);
}

__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel_bf16(const SegArgs a) {
  segment_sum_body<__nv_bfloat16>(a);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// Each operand's lane kind and slabs a bucket, from host ints and the
// pointers' alignment only (a CUDA graph's replays keep the launch).
void choose_lanes(SegArgs& a, int bf16) {
  const int elem = bf16 ? 2 : 4;
  const int wide = 16 / elem, narrow = 4 / elem;
  for (int i = 0; i < 2; ++i) {
    const int c = a.cols[i];
    // A lane's columns are contiguous in each row and in the output when
    // the width is a multiple of them and both bases are aligned.
    const auto fits = [&](int vec) {
      return c % vec == 0 && aligned(a.data[i], vec * elem) &&
             aligned(a.out[i], vec * elem);
    };
    const long long wide_warps =
        static_cast<long long>(a.n_seg) * ((c + 32 * wide - 1) / (32 * wide));
    a.lanes[i] = fits(wide) && wide_warps >= kWideWarps ? kWide
                 : fits(narrow)                          ? kNarrow
                                                         : kScalar;
    const int vec =
        a.lanes[i] == kWide ? wide : a.lanes[i] == kNarrow ? narrow : 1;
    a.slabs[i] = (c + 32 * vec - 1) / (32 * vec);
  }
}

SegArgs operands(const void* data0, void* out0, int cols0, const void* data1,
                 void* out1, int cols1, int n_seg, int bf16) {
  SegArgs a = {};
  a.n_seg = n_seg;
  a.data[0] = data0;
  a.data[1] = data1;
  a.out[0] = out0;
  a.out[1] = out1;
  a.cols[0] = cols0;
  a.cols[1] = cols1;
  choose_lanes(a, bf16);
  return a;
}

}  // namespace

extern "C" {

// keys [n_rows] int32, sorted once keyed by mask ([n_rows] bool, or
// null); order [n_rows] int64 (the rows in the keys' order) or null (row
// k is k); data_i [n_rows, cols_i] (f32, or bf16 with bf16 != 0) and
// out_i [n_seg, cols_i] at the data's dtype, operand 1 absent where
// cols_1 is 0. Every element of out_i is written (a bucket with no rows
// gets +0).
int segment_sum_launch(const void* keys, const void* mask, const void* order,
                       int n_rows, const void* data0, void* out0, int cols0,
                       const void* data1, void* out1, int cols1, int n_seg,
                       int bf16, cudaStream_t st) {
  if (n_rows < 0 || n_seg < 0 || cols0 < 0 || cols1 < 0 ||
      (n_rows > 0 && keys == nullptr) || (mask != nullptr && order != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  SegArgs a = operands(data0, out0, cols0, data1, out1, cols1, n_seg, bf16);
  a.keys = static_cast<const int*>(keys);
  a.mask = static_cast<const unsigned char*>(mask);
  a.order = static_cast<const long long*>(order);
  a.n_rows = n_rows;
  const long long warps =
      static_cast<long long>(n_seg) * (a.slabs[0] + a.slabs[1]);
  if (warps == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  if (bf16)
    segment_sum_kernel_bf16<<<blocks, kThreads, 0, st>>>(a);
  else
    segment_sum_kernel<<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The lane kind (0 scalar, 1 narrow, 2 wide) that segment_sum_launch
// gives each operand on these arguments, into lanes[2]; launches
// nothing.
int segment_sum_lanes(const void* data0, void* out0, int cols0,
                      const void* data1, void* out1, int cols1, int n_seg,
                      int bf16, int* lanes) {
  if (n_seg < 0 || cols0 < 0 || cols1 < 0 || lanes == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const SegArgs a =
      operands(data0, out0, cols0, data1, out1, cols1, n_seg, bf16);
  lanes[0] = a.lanes[0];
  lanes[1] = a.lanes[1];
  return 0;
}

}  // extern "C"
