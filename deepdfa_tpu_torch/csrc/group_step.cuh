// The building blocks of every gated-step kernel (fused_gnn.cu:
// fused_step_kernel, persistent_fwd_kernel and its hist instance;
// fused_gnn_bwd.cu: fused_step_bwd_kernel, persistent_bwd_kernel). A
// persistent block owns one closed row group
// (ops/band_spmm.py:closed_row_groups) and keeps its rows in shared
// memory for all K steps; a per-step block owns a fixed tile of rows for
// one step. Either way the rows sit at row stride ld = hp + 4 floats (hp:
// H rounded up to 32, 64 or 128).
//
// The dense products are register tiled: thread (column group cg, row
// lane rl) holds 4 adjacent columns c0 = 4 cg .. c0 + 3 of kTR rows
// (rl, rl + RL, ..), so one pass covers RL * kTR rows (32 at H 128) and
// every weight value a thread loads feeds kTR rows. A warp is 8 column
// groups by 4 consecutive row lanes: the weight reads are 8 float4 the
// warp shares, the row reads 4 rows whose stride (ld = 4 mod 32) puts
// them on distinct banks. The weights stream through shared memory in
// slabs by cp.async, three stages in flight: each slab crosses L2
// once a pass, and every row of the pass consumes it before the next one
// lands (the first port's kernels re-read all 460 KB of weights from L2
// for every 16-row chunk). A slab holds kGR k rows of [w_i | w_h] (the
// persistent kernels: kGateRows); the narrower products fit more.
//
// Every output element keeps one chain in every kernel: the accumulator
// starts at 0, k runs ascending over all H inputs one fmaf at a time, the
// gate interleaves x w_i and h w_h per k (pr += x wir, pr += h whr, pz
// likewise, gn += x win, hn += h whn), the dx/dh pair runs j ascending
// over 3H, and the epilogues are the shared edge_out, gate_out and
// gate_bwd_out (gated_step.cuh). Which rows a thread holds, and how the
// weights reach it, change no chain. So a persistent kernel equals the
// scan of its per-step counterpart bit for bit.
//
// The bf16 instances (fused_gnn.cu, fused_gnn_bwd.cu) run their products
// on the bf16 tensor cores (gnn_bf16_mma.cuh) and take from here the
// aggregates, which also read and write bf16 rows there, and the cp.async
// helpers.

#pragma once

#include <cooperative_groups.h>

#include "gated_step.cuh"

namespace {

constexpr int kTR = 4;             // rows a thread holds in a pass
constexpr int kStages = 3;         // weight-slab stages in flight
constexpr int kGateRows = 4;       // k rows a [w_i | w_h] slab
constexpr int kGroupThreads = 256;
constexpr int kGroupWarps = kGroupThreads / 32;

// SMs of the current device: the per-step launchers plan their grids to
// fill them (ops/fused_gnn.py:step_plan takes the same count).
inline int device_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// H rounded up so the column groups fill whole warps; the row stride.
__host__ __device__ inline int group_hp(int H) {
  return H <= 32 ? 32 : (H <= 64 ? 64 : 128);
}
__host__ __device__ inline int group_ld(int H) { return group_hp(H) + 4; }
// Floats of one slab stage: kGR k rows of [w_i | w_h] (6 hp floats a
// row). The narrower products fit more k rows a stage (slab_rows).
template <int kGR = kGateRows>
__host__ __device__ inline int group_stage_floats(int H) {
  return kGR * 6 * group_hp(H);
}

// k rows a slab of a product whose k rows are row_floats wide: as many as
// a stage holds, a multiple of 4 (at kGR = 4 and H 128: 24 for w_e, 12
// for [w_i^T | w_h^T], 4 for [w_i | w_h]).
template <int kGR = kGateRows>
__device__ __forceinline__ int slab_rows(int H, int row_floats) {
  return (group_stage_floats<kGR>(H) / row_floats) & ~3;
}

// Thread (column group, row lane) of a block that owns columns [lo, hi)
// of the products: all hp of them, or a 1/cs slice when cs blocks of a
// thread-block cluster share a row group (hp / cs >= 32).
struct Tile {
  int H, ld, lo, hi, c0, rl, RL;
  bool active;  // c0 < H (columns past H are padding)
  __device__ Tile(int H_, int rank, int cs) : H(H_), ld(group_ld(H_)) {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int hc = group_hp(H) / cs;
    const int cgw = hc / 32;  // warps across the columns
    lo = rank * hc;
    hi = lo + hc;
    c0 = lo + 4 * ((warp % cgw) * 8 + (lane & 7));
    rl = (warp / cgw) * 4 + (lane >> 3);
    RL = 4 * (kGroupWarps / cgw);
    active = c0 < H;
  }
  __device__ int pass_rows() const { return RL * kTR; }
};

// agg_row[:] = sum_s A[r, s] * hsrc[s - g0][:] and *rs_out = sum_s A[r, s]
// over the senders s of the closed group [g0, g1) (hsrc holds its rows at
// stride ld). One warp. Slices of 32 senders aligned to 32, lane l on the
// senders s = l mod 32, in ascending order: the sums equal
// warp_aggregate_row's, whose lanes take the same senders in the same
// order when the tile is a multiple of 32 (and any order adds integer
// multiplicities exactly). Senders outside the band are no edge.
template <typename VT, typename ST, typename OT>
__device__ void group_aggregate_row(const VT* __restrict__ vals, int r,
                                    int tile, int n_tiles, int bw,
                                    const ST* hsrc, int ld, int g0, int g1,
                                    int H, OT* agg_row, float* rs_out,
                                    int lane) {
  const int tr = r / tile, rr = r % tile;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float rs = 0.f;
  for (int s0 = g0 & ~31; s0 < g1; s0 += 32) {
    const int s = s0 + lane;
    float a = 0.f;
    if (s >= g0 && s < g1) {
      const int d = s / tile - tr + bw;
      if (d >= 0 && d <= 2 * bw)
        a = load_val(vals + ((static_cast<size_t>(d) * n_tiles + tr) * tile +
                             rr) * tile + s % tile);
    }
    rs += a;
    unsigned nz = __ballot_sync(kFull, a != 0.f);
    while (nz) {
      const int src = __ffs(nz) - 1;
      nz &= nz - 1;
      const float av = __shfl_sync(kFull, a, src);
      const ST* hs = hsrc + (s0 + src - g0) * ld;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = lane + 32 * q;
        if (col < H) acc[q] = fmaf(av, band_val(hs + col), acc[q]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = lane + 32 * q;
    if (col < H) store_val(agg_row + col, acc[q]);
  }
  if (lane == 0) *rs_out = rs;
}

// Rows a warp of tile_aggregate stages ahead of the one it scans.
constexpr int kAggSlots = 4;

// Every warp aggregates rows lr = warp, warp + kGroupWarps, .. of a
// per-step block's row tile [r0, r0 + R) (warp_aggregate_row: the tile's
// senders from hloc, at stride ld, the halo's from hsrc, [n_rows, H]);
// agg and rs as group_aggregate's. Each warp stages its rows' band windows
// into its own ring of kAggSlots rows in buf (buf_floats floats of shared
// memory that the products use later: the weight-slab stages) by
// cp.async, that many rows ahead of the one it scans, so the scans read
// shared memory and the rows' device-memory round trips overlap. Where
// the ring does not fit a warp's share or a window's tiles are no
// multiple of 16 bytes, the warps read the band in device memory instead.
// Not inlined: its registers stay apart from the products'. Ends with a
// barrier.
template <typename VT, typename ST, typename OT>
__device__ __noinline__ void tile_aggregate(
    const VT* __restrict__ vals, int tile, int n_tiles, int bw,
    const ST* __restrict__ hsrc, const ST* hloc, int r0, int R, int ld,
    int H, OT* agg, float* rs, float* buf, int buf_floats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = 2 * bw + 1, seg = tile * static_cast<int>(sizeof(VT));
  const int row_bytes = W * seg;
  const int share = buf_floats * static_cast<int>(sizeof(float)) /
                    kGroupWarps / 16 * 16;
  const size_t plane = static_cast<size_t>(n_tiles) * tile * tile;
  const auto row_vals = [&](int lr) {  // row lr's window tile d = 0
    const int r = r0 + lr;
    return vals + (static_cast<size_t>(r / tile) * tile + r % tile) * tile;
  };
  if (kAggSlots * row_bytes > share || seg % 16) {
    for (int lr = warp; lr < R; lr += kGroupWarps)
      warp_aggregate_row(row_vals(lr), plane, r0 + lr, tile, n_tiles, bw,
                         hsrc, hloc, r0, R, ld, H, agg + lr * ld, rs + lr,
                         lane);
    __syncthreads();
    return;
  }
  char* ring = reinterpret_cast<char*>(buf) + warp * share;
  const int mine = warp < R ? (R - warp + kGroupWarps - 1) / kGroupWarps : 0;
  // The warp's k-th row into slot k % kAggSlots, one commit group a row
  // (empty past the warp's rows, so every wait counts the same groups).
  const auto stage = [&](int k) {
    if (k < mine) {
      const char* src = reinterpret_cast<const char*>(
          row_vals(warp + k * kGroupWarps));
      char* dst = ring + (k % kAggSlots) * row_bytes;
      for (int d = 0; d < W; ++d)
        for (int p = 16 * lane; p < seg; p += 16 * 32)
          cp_async16(reinterpret_cast<float*>(dst + d * seg + p),
                     reinterpret_cast<const float*>(
                         src + d * plane * sizeof(VT) + p),
                     true);
    }
    cp_async_commit();
  };
  for (int k = 0; k < kAggSlots; ++k) stage(k);
  for (int k = 0; k < mine; ++k) {
    cp_async_wait_group<kAggSlots - 1>();  // row k landed
    __syncwarp();
    const int lr = warp + k * kGroupWarps;
    warp_aggregate_row(
        reinterpret_cast<const VT*>(ring + (k % kAggSlots) * row_bytes),
        static_cast<size_t>(tile), r0 + lr, tile, n_tiles, bw, hsrc, hloc,
        r0, R, ld, H, agg + lr * ld, rs + lr, lane);
    __syncwarp();  // every lane has read slot k % kAggSlots
    stage(k + kAggSlots);
  }
  cp_async_wait_group<0>();
  __syncthreads();  // the rows are in; buf is free again
}

// Every warp aggregates the group's rows, one row at a time.
template <typename VT, typename ST, typename OT>
__device__ void group_aggregate(const VT* __restrict__ vals, int tile,
                                int n_tiles, int bw, const ST* hsrc,
                                int ld, int g0, int g1, int H, OT* agg,
                                float* rs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int lr = warp; lr < g1 - g0; lr += kGroupWarps)
    group_aggregate_row(vals, g0 + lr, tile, n_tiles, bw, hsrc, ld, g0, g1,
                        H, agg + lr * ld, rs + lr, lane);
}

// Queues k rows [k0, k0 + kn) of a ([K, width] row-major, width a
// multiple of H) and, when b is given, of b beside it: stage row kk = [a
// row | b row]. Only the pieces of columns [t.lo, t.hi) of each H-wide
// block are copied. 16-byte pieces: H % 4 == 0 and 16-byte aligned bases.
__device__ __forceinline__ void issue_slab(const Tile& t, float* stage,
                                           int k0, int kn,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int width) {
  const int q = width / 4, per = (b ? 2 : 1) * q;
  for (int p = threadIdx.x; p < per; p += kGroupThreads) {
    const bool in_a = p < q;
    const int piece = in_a ? p : p - q, col = (4 * piece) % t.H;
    if (col < t.lo || col >= t.hi) continue;
    const float* src =
        (in_a ? a : b) + static_cast<size_t>(k0) * width + 4 * piece;
    float* dst = stage + 4 * p;
    for (int kk = 0; kk < kn; ++kk)
      cp_async16(dst + kk * 4 * per, src + static_cast<size_t>(kk) * width,
                 true);
  }
}

// The slab loop of one product over n_slabs slabs: slabs s + 1 and s + 2
// are in flight while slab s is consumed; ends with a barrier, so every
// read of the operands is done.
template <typename Issue, typename Compute>
__device__ __forceinline__ void slab_pipeline(int n_slabs, float* stages,
                                              int stage_floats, Issue issue,
                                              Compute compute) {
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_slabs) issue(p, stages + p * stage_floats);
    cp_async_commit();
  }
  for (int s = 0; s < n_slabs; ++s) {
    cp_async_wait_group<kStages - 2>();
    __syncthreads();  // slab s landed; slab s - 1's stage is free
    const int next = s + kStages - 1;
    if (next < n_slabs) issue(next, stages + (next % kStages) * stage_floats);
    cp_async_commit();
    compute(s, static_cast<const float*>(stages + (s % kStages) *
                                                     stage_floats));
  }
  __syncthreads();
}

template <int N>
struct Rows {
  static constexpr int value = N;
};

// kExact: calls f(Rows<n>{}) for the pass's row iterations n = 1..kTR
// (block uniform), so a pass computes only the iterations that hold rows;
// else f(Rows<kTR>{}), the clamped rows computed and dropped. The
// dispatch pays where passes are short (the cluster's 64-row passes
// over groups of 32-48 rows: -8 % at the serving bucket on an H100) and
// costs 7 % where every pass is full (the training batch's 32-row
// groups).
template <bool kExact, typename F>
__device__ __forceinline__ void with_rows(int n, F f) {
  static_assert(kTR == 4, "with_rows dispatches 1..4 row iterations");
  if constexpr (!kExact) {
    f(Rows<kTR>{});
  } else {
    switch (n) {
      case 1: f(Rows<1>{}); break;
      case 2: f(Rows<2>{}); break;
      case 3: f(Rows<3>{}); break;
      default: f(Rows<4>{}); break;
    }
  }
}

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Rows [0, R) of a_s (stride ld) times w ([H, H]): for each pass, acc[i][j]
// = sum_k a_s[row_i][k] w[k][c0 + j], then epi(row, acc[i]) for the
// thread's rows below R (after a barrier: epi may write a_s in place).
// Ends with a barrier.
template <bool kExact = false, int kGR = kGateRows, typename Epi>
__device__ void group_rows_times(const Tile& t, const float* a_s, int R,
                                 const float* __restrict__ w, float* stages,
                                 Epi epi) {
  const int H = t.H, sf = group_stage_floats<kGR>(H);
  for (int base = 0; base < R; base += t.pass_rows()) {
    const int nri = min(kTR, (R - base + t.RL - 1) / t.RL);
    int row[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) row[i] = min(base + t.rl + t.RL * i, R - 1);
    float acc[kTR][4];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const int ks = slab_rows<kGR>(H, H);
    slab_pipeline(
        (H + ks - 1) / ks, stages, sf,
        [&](int s, float* st) {
          issue_slab(t, st, s * ks, min(ks, H - s * ks), w, nullptr, H);
        },
        [&](int s, const float* st) {
          if (!t.active) return;
          const int k0 = s * ks, kn = min(ks, H - k0);
          with_rows<kExact>(nri, [&](auto nr) {
            for (int kq = 0; kq < kn; kq += 4) {
              float4 wk[4];
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wk[kk] =
                    *reinterpret_cast<const float4*>(st + (kq + kk) * H + t.c0);
#pragma unroll
              for (int i = 0; i < decltype(nr)::value; ++i) {
                const float4 a4 = *reinterpret_cast<const float4*>(
                    a_s + row[i] * t.ld + k0 + kq);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                  const float av = f4(a4, kk);
#pragma unroll
                  for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av, f4(wk[kk], j), acc[i][j]);
                }
              }
            }
          });
        });
    if (t.active) {
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int r = base + t.rl + t.RL * i;
        if (r < R) epi(r, acc[i]);
      }
    }
  }
  __syncthreads();
}

// The gate pre-activation sums of rows [0, R) (x_s, h_s at stride ld)
// against the packed w_i, w_h ([H, 3H]): per pass, for each of the
// thread's rows and 4 columns, pr = (x w_i + h w_h)[:, c], pz = [:, H + c],
// gn = (x w_i)[:, 2H + c], hn = (h w_h)[:, 2H + c], in the interleaved
// chain; then epi(row, pr, pz, gn, hn) for the rows below R after a
// barrier (epi may write h_s in place). Slabs of kGR k rows: kGR divides
// H. Ends with a barrier.
template <bool kExact = false, int kGR = kGateRows, typename Epi>
__device__ void group_gate(const Tile& t, const float* x_s, const float* h_s,
                           int R, const float* __restrict__ wi,
                           const float* __restrict__ wh, float* stages,
                           Epi epi) {
  const int H = t.H, H3 = 3 * H, sf = group_stage_floats<kGR>(H);
  for (int base = 0; base < R; base += t.pass_rows()) {
    const int nri = min(kTR, (R - base + t.RL - 1) / t.RL);
    int row[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i) row[i] = min(base + t.rl + t.RL * i, R - 1);
    float pr[kTR][4], pz[kTR][4], gn[kTR][4], hn[kTR][4];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pr[i][j] = pz[i][j] = gn[i][j] = hn[i][j] = 0.f;
    const int ks = kGR;  // divides H
    slab_pipeline(
        H / ks, stages, sf,
        [&](int s, float* st) { issue_slab(t, st, s * ks, ks, wi, wh, H3); },
        [&](int s, const float* st) {
          if (!t.active) return;
          const int k0 = s * ks;
          with_rows<kExact>(nri, [&](auto nr) {
            constexpr int NR = decltype(nr)::value;
#pragma unroll
            for (int kq = 0; kq < kGR; kq += 4) {
              float4 xv[NR], hv[NR];
#pragma unroll
              for (int i = 0; i < NR; ++i) {
                xv[i] = *reinterpret_cast<const float4*>(x_s + row[i] * t.ld +
                                                         k0 + kq);
                hv[i] = *reinterpret_cast<const float4*>(h_s + row[i] * t.ld +
                                                         k0 + kq);
              }
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                const float* wrow = st + (kq + kk) * 2 * H3 + t.c0;
                const float4 wir = *reinterpret_cast<const float4*>(wrow);
                const float4 wiz = *reinterpret_cast<const float4*>(wrow + H);
                const float4 win =
                    *reinterpret_cast<const float4*>(wrow + 2 * H);
                const float4 whr = *reinterpret_cast<const float4*>(wrow + H3);
                const float4 whz =
                    *reinterpret_cast<const float4*>(wrow + H3 + H);
                const float4 whn =
                    *reinterpret_cast<const float4*>(wrow + H3 + 2 * H);
#pragma unroll
                for (int i = 0; i < NR; ++i) {
                  const float x = f4(xv[i], kk), h = f4(hv[i], kk);
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    pr[i][j] = fmaf(x, f4(wir, j), pr[i][j]);
                    pr[i][j] = fmaf(h, f4(whr, j), pr[i][j]);
                    pz[i][j] = fmaf(x, f4(wiz, j), pz[i][j]);
                    pz[i][j] = fmaf(h, f4(whz, j), pz[i][j]);
                    gn[i][j] = fmaf(x, f4(win, j), gn[i][j]);
                    hn[i][j] = fmaf(h, f4(whn, j), hn[i][j]);
                  }
                }
              }
            }
          });
        });
    if (t.active) {
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int r = base + t.rl + t.RL * i;
        if (r < R) epi(r, pr[i], pz[i], gn[i], hn[i]);
      }
    }
  }
  __syncthreads();
}

// The per-step forward's products at H > 64 (hp = 128, one block an SM:
// 128 gate accumulators a thread) over a tile of exactly one pass: thread
// (column group, row lane rl) holds kWideRows rows rl + kWideRL * i, so
// one weight value feeds 8 rows, and the rows' offsets are compile-time
// constants (the 4 x 4 tile's clamped, runtime-strided row indices cost
// as many address instructions as its FMAs' third). Rows past R in the
// last tile compute on stale rows and are dropped. The rows' operands are
// scalar loads (4 rows a warp on 4 banks), the weights float4 from the
// slab. Each element keeps the chain of group_rows_times and group_gate.
constexpr int kWideRows = 8;
constexpr int kWideRL = 8;               // row lanes at hp = 128
constexpr int kWideLd = 128 + 4;         // group_ld at hp = 128
constexpr int kWideTile = kWideRows * kWideRL;  // rows a wide tile

template <int kGR, typename Epi>
__device__ void wide_rows_times(const Tile& t, const float* a_s, int R,
                                const float* __restrict__ w, float* stages,
                                Epi epi) {
  const int H = t.H, sf = group_stage_floats<kGR>(H);
  const float* ar = a_s + t.rl * kWideLd;
  float acc[kWideRows][4];
#pragma unroll
  for (int i = 0; i < kWideRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int ks = slab_rows<kGR>(H, H);
  slab_pipeline(
      (H + ks - 1) / ks, stages, sf,
      [&](int s, float* st) {
        issue_slab(t, st, s * ks, min(ks, H - s * ks), w, nullptr, H);
      },
      [&](int s, const float* st) {
        if (!t.active) return;
        const int k0 = s * ks, kn = min(ks, H - k0);
#pragma unroll 4
        for (int kk = 0; kk < kn; ++kk) {
          const float4 wk =
              *reinterpret_cast<const float4*>(st + kk * H + t.c0);
#pragma unroll
          for (int i = 0; i < kWideRows; ++i) {
            const float av = ar[i * kWideRL * kWideLd + k0 + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av, f4(wk, j), acc[i][j]);
          }
        }
      });
  if (t.active) {
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      const int r = t.rl + kWideRL * i;
      if (r < R) epi(r, acc[i]);
    }
  }
  __syncthreads();
}

template <int kGR, typename Epi>
__device__ void wide_gate(const Tile& t, const float* x_s, const float* h_s,
                          int R, const float* __restrict__ wi,
                          const float* __restrict__ wh, float* stages,
                          Epi epi) {
  const int H = t.H, H3 = 3 * H, sf = group_stage_floats<kGR>(H);
  const float* xr = x_s + t.rl * kWideLd;
  const float* hr = h_s + t.rl * kWideLd;
  float pr[kWideRows][4], pz[kWideRows][4], gn[kWideRows][4],
      hn[kWideRows][4];
#pragma unroll
  for (int i = 0; i < kWideRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) pr[i][j] = pz[i][j] = gn[i][j] = hn[i][j] = 0.f;
  slab_pipeline(
      H / kGR, stages, sf,
      [&](int s, float* st) { issue_slab(t, st, s * kGR, kGR, wi, wh, H3); },
      [&](int s, const float* st) {
        if (!t.active) return;
        const int k0 = s * kGR;
#pragma unroll 2
        for (int kk = 0; kk < kGR; ++kk) {
          const float* wrow = st + kk * 2 * H3 + t.c0;
          const float4 wir = *reinterpret_cast<const float4*>(wrow);
          const float4 wiz = *reinterpret_cast<const float4*>(wrow + H);
          const float4 win = *reinterpret_cast<const float4*>(wrow + 2 * H);
          const float4 whr = *reinterpret_cast<const float4*>(wrow + H3);
          const float4 whz = *reinterpret_cast<const float4*>(wrow + H3 + H);
          const float4 whn =
              *reinterpret_cast<const float4*>(wrow + H3 + 2 * H);
#pragma unroll
          for (int i = 0; i < kWideRows; ++i) {
            const float x = xr[i * kWideRL * kWideLd + k0 + kk];
            const float h = hr[i * kWideRL * kWideLd + k0 + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pr[i][j] = fmaf(x, f4(wir, j), pr[i][j]);
              pr[i][j] = fmaf(h, f4(whr, j), pr[i][j]);
              pz[i][j] = fmaf(x, f4(wiz, j), pz[i][j]);
              pz[i][j] = fmaf(h, f4(whz, j), pz[i][j]);
              gn[i][j] = fmaf(x, f4(win, j), gn[i][j]);
              hn[i][j] = fmaf(h, f4(whn, j), hn[i][j]);
            }
          }
        }
      });
  if (t.active) {
#pragma unroll
    for (int i = 0; i < kWideRows; ++i) {
      const int r = t.rl + kWideRL * i;
      if (r < R) epi(r, pr[i], pz[i], gn[i], hn[i]);
    }
  }
  __syncthreads();
}

// The gate backward's second half on rows [0, R): with dp (device memory,
// [R, 4H] from row 0, written by this block: plain loads, no read-only
// path) dx[r] = dpre_i[r] w_i^T -> dx_s, dh_s[r] += dpre_h[r] w_h^T, each
// a chain over j ascending (wiT, whT: [3H, H]). Ends with a barrier.
template <int kGR = kGateRows>
__device__ void group_gate_bwd_b(const Tile& t, const float* dp, int R,
                                 const float* __restrict__ wiT,
                                 const float* __restrict__ whT,
                                 float* stages, float* dx_s, float* dh_s) {
  const int H = t.H, H2 = 2 * H, sf = group_stage_floats<kGR>(H);
  for (int base = 0; base < R; base += t.pass_rows()) {
    const float* dprow[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
      dprow[i] = dp + static_cast<size_t>(min(base + t.rl + t.RL * i, R - 1)) *
                          4 * H;
    float ax[kTR][4], ah[kTR][4];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ax[i][j] = ah[i][j] = 0.f;
    const int ks = slab_rows<kGR>(H, H2), J = 3 * H;
    slab_pipeline(
        (J + ks - 1) / ks, stages, sf,
        [&](int s, float* st) {
          issue_slab(t, st, s * ks, min(ks, J - s * ks), wiT, whT, H);
        },
        [&](int s, const float* st) {
          if (!t.active) return;
          const int j0 = s * ks, jn = min(ks, J - j0);
          for (int jq = 0; jq < jn; jq += 4) {
            // dpre_h equals dpre_i on the r|z columns; its n block is
            // dpre_hn, stored H columns further on.
            const int j = j0 + jq, jh = j < H2 ? j : j + H;
            float4 di[kTR], dh4[kTR];
#pragma unroll
            for (int i = 0; i < kTR; ++i) {
              di[i] = *reinterpret_cast<const float4*>(dprow[i] + j);
              dh4[i] = *reinterpret_cast<const float4*>(dprow[i] + jh);
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float* wrow = st + (jq + jj) * H2 + t.c0;
              const float4 wi4 = *reinterpret_cast<const float4*>(wrow);
              const float4 wh4 = *reinterpret_cast<const float4*>(wrow + H);
#pragma unroll
              for (int i = 0; i < kTR; ++i) {
                const float dv = f4(di[i], jj), hv = f4(dh4[i], jj);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  ax[i][q] = fmaf(dv, f4(wi4, q), ax[i][q]);
                  ah[i][q] = fmaf(hv, f4(wh4, q), ah[i][q]);
                }
              }
            }
          }
        });
    if (t.active) {
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int r = base + t.rl + t.RL * i;
        if (r < R) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = r * t.ld + t.c0 + j;
            dx_s[e] = ax[i][j];
            dh_s[e] = dh_s[e] + ah[i][j];
          }
        }
      }
    }
  }
  __syncthreads();
}

// Rows [0, R) of a [.., H] row-major global array <-> a shared array at
// stride ld, in float4 pieces (H % 4 == 0).
__device__ __forceinline__ void rows_to_shared(float* dst, int ld,
                                               const float* src, int R,
                                               int H) {
  const int q = H / 4;
  for (int e = threadIdx.x; e < R * q; e += kGroupThreads) {
    const int r = e / q, c = 4 * (e % q);
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * H + c);
  }
}

// 4 floats as 4 bf16 values at p (8 bytes, rounded to nearest even).
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* p, float a,
                                             float b, float c, float d) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = u;
}

// Columns [lo, hi) of rows [0, R) of a shared f32 array at stride ld into a
// [.., H] row-major bf16 global array (lo, hi multiples of 4, hi <= H).
__device__ __forceinline__ void rows_to_global(__nv_bfloat16* dst,
                                               const float* src, int ld,
                                               int R, int H, int lo, int hi) {
  const int q = (hi - lo) / 4;
  for (int e = threadIdx.x; e < R * q; e += kGroupThreads) {
    const int r = e / q, c = lo + 4 * (e % q);
    const float4 v = *reinterpret_cast<const float4*>(src + r * ld + c);
    store_bf16x4(dst + static_cast<size_t>(r) * H + c, v.x, v.y, v.z, v.w);
  }
}

// Columns [lo, hi) of rows [0, R) of a shared array at stride ld into a
// [.., H] row-major global array (lo, hi multiples of 4, hi <= H).
__device__ __forceinline__ void rows_to_global(float* dst, const float* src,
                                               int ld, int R, int H,
                                               int lo = 0, int hi = -1) {
  if (hi < 0) hi = H;
  const int q = (hi - lo) / 4;
  for (int e = threadIdx.x; e < R * q; e += kGroupThreads) {
    const int r = e / q, c = lo + 4 * (e % q);
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * H + c) =
        *reinterpret_cast<const float4*>(src + r * ld + c);
  }
}

}  // namespace
