#pragma once

// Nearest-centroid assignment for a batch of independent k-means lanes:
// the kernel and its launcher, built by three units (kmeans_assign.cu,
// kmeans_assign_wide.cu, kmeans_assign_128.cu), each instantiating its
// share of the widths.
//
// Replaces the TPU kernel `_assign_kernel` / `kmeans_assign_padded` in
// src/repro/kernels/kmeans_assign/kmeans_assign.py. For lane b and point i
// it writes argmin_k (|x|^2 - 2 x.c_k + |c_k|^2) as an int32 label (ties go
// to the lowest k, as jnp.argmin does) and max(min d2, 0).
//
// What bounds it on an H100: bytes. At the main path's BBV shape (10 lanes
// of 120000 points, d = 15, k = 20) it reads 72 MB of points and writes
// 9.6 MB of labels and distances: 82 MB / 3.35 TB/s is about 25 us, against
// 720 M float32 multiply-adds, about 11 us at 67 TFLOP/s. So the design
// streams the points through shared memory in whole tiles and keeps
// everything else on chip:
//   * persistent blocks, about as many as fit on the card at once, each
//     walking a contiguous run of (lane, point tile) items. A block loads
//     a lane's k x d centroids into shared memory (rows padded to a
//     multiple of 4 floats, read 16 bytes at a time), and computes their
//     squared norms once, when its run enters the lane -- not once per
//     tile;
//   * one producer thread brings each tile's contiguous rows into a
//     double-buffered shared-memory ring with one TMA bulk copy
//     (cp.async.bulk, completion on an mbarrier); tiles hold a multiple
//     of 4 rows, so every tile of a lane starts at the same offset mod 16
//     bytes, and the copy takes the tile's 16-byte aligned interior (at
//     most 3 floats at each end are read from global memory instead);
//   * eight consumer warps read their points from shared memory (odd
//     strides such as 15 words hit no bank twice), two points a thread,
//     so that each centroid load serves both, and scan the centroids;
//     where a launch has too few points to fill the card (the RFV fit: 10
//     x 6861 points) `split` threads share a point, each scanning a
//     contiguous share of the centroids, and a shuffle minimum on (d2,
//     index) picks the winner -- the serial argmin, ties to the lowest
//     index;
//   * distances use the expanded form in float32 (no TF32, no (x - c)^2
//     rewrite), accumulated in the plain version's order (the order the
//     reference's compiled float32 programs use, see core/ordered.py):
//     squared norms as one multiply-add chain up to 32 terms, else in
//     windows of 32, except the leading rows of a lane (points) or of its
//     centroids that the reference adds in its vector body at d = 5 to 8
//     (core.ordered.norm_vector_rows, passed in as `xvec` and `cvec`):
//     there, the rounded products in order; dot products in the order
//     the reference's distance einsum takes at the launch's shape
//     (core.ordered.reference_dot_order, passed in as `chain` and
//     `swap`): interleaved multiply-add accumulators -- four, (a0 + a1) +
//     (a2 + a3), plus a tail of plain products, or two where d is 1 or 2
//     mod 4, a0 + a1, plus an odd last product; with `swap` the other
//     interleave (four where d is 1 or 2 mod 4, two elsewhere: a run-time
//     choice in every interleaved instantiation, which holds both); or
//     one multiply-add chain over d, in order. The kernel therefore agrees
//     with its plain version bitwise, and a fit on the card follows the
//     same path as one on the CPU. The one chain is d dependent FMAs a
//     point-centroid pair, where four chains are about d / 4 deep; two
//     points a thread and the two-centroid unroll keep four such chains
//     in flight.
// The TPU's 128-wide padding of d and k is gone: rows, centroids and
// features are read at their real sizes, and no padded centroid exists
// that could win.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 32;
constexpr int kConsumers = 256;            // 8 consumer warps
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;
constexpr int kTileFloats = 8192;          // 32 KB a stage at most
constexpr int kTargetThreads = 2048;       // resident threads an SM
constexpr int kMaxSplit = 32;

// sum of v[j]^2 over j < d in the plain version's order (core.ordered.sum_sq):
// one multiply-add chain up to 32 terms; above, windows of 32 over the row
// padded symmetrically with zeros, each summed in order from 0, then the
// window sums in order (rounded products, no contraction). The window of
// element j is (j + lo) / 32 with lo = (32 m - d) / 2, m = ceil(d / 32).
__device__ float sum_sq_row(const float* v, int d) {
  if (d <= kWindow) {
    float acc = 0.f;
    for (int j = 0; j < d; ++j) acc = fmaf(v[j], v[j], acc);
    return acc;
  }
  const int lo = ((d + kWindow - 1) / kWindow * kWindow - d) / 2;
  float acc = 0.f, part = 0.f;
  int w = lo / kWindow;
  for (int j = 0; j < d; ++j) {
    if ((j + lo) / kWindow != w) {
      acc = __fadd_rn(acc, part);
      part = 0.f;
      w = (j + lo) / kWindow;
    }
    part = __fadd_rn(part, __fmul_rn(v[j], v[j]));
  }
  return __fadd_rn(acc, part);
}

// sum of v[j]^2 over j < d as rounded products added in order (no
// contraction): the reference's order for the rows of a norm in its
// vector body (core.ordered.sum_sq_rows)
__device__ float sum_prod_row(const float* v, int d) {
  float acc = 0.f;
  for (int j = 0; j < d; ++j) acc = __fadd_rn(acc, __fmul_rn(v[j], v[j]));
  return acc;
}

template <int DMAX>
__device__ float sum_prod_reg(const float (&v)[DMAX], int d) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) acc = __fadd_rn(acc, __fmul_rn(v[j], v[j]));
  }
  return acc;
}

// a point's squared norm in the order of its row's place: rounded
// products in order for the first `vec` rows of a lane, else sum_sq_reg.
// Only d = 5 to 8 has such rows (core.ordered.norm_vector_rows), so only
// the instantiations that serve those widths (DMAX 8, and 16 for the
// one-chain order) compile the first form
template <int DMAX>
__device__ __forceinline__ float norm_reg(const float (&v)[DMAX], int d,
                                          bool vec);

// the same on a point held in registers (compile-time indices only); the
// order follows d, not DMAX, since a one-chain instantiation serves every
// d up to its DMAX
template <int DMAX>
__device__ float sum_sq_reg(const float (&v)[DMAX], int d) {
  constexpr int kChain = DMAX < kWindow ? DMAX : kWindow;
  float acc = 0.f;
  if (DMAX <= kWindow || d <= kWindow) {
#pragma unroll
    for (int j = 0; j < kChain; ++j) {
      if (j < d) acc = fmaf(v[j], v[j], acc);
    }
    return acc;
  }
  const int lo = ((d + kWindow - 1) / kWindow * kWindow - d) / 2;
  float part = 0.f;
  int w = lo / kWindow;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j < d) {
      if ((j + lo) / kWindow != w) {
        acc = __fadd_rn(acc, part);
        part = 0.f;
        w = (j + lo) / kWindow;
      }
      part = __fadd_rn(part, __fmul_rn(v[j], v[j]));
    }
  }
  return __fadd_rn(acc, part);
}

template <int DMAX>
__device__ __forceinline__ float norm_reg(const float (&v)[DMAX], int d,
                                          bool vec) {
  if constexpr (DMAX <= 16) {
    if (vec) return sum_prod_reg<DMAX>(v, d);
  }
  return sum_sq_reg<DMAX>(v, d);
}

// x . c and y . c with two interleaved multiply-add accumulators (j mod
// 2), a0 + a1, and an odd last term's rounded product added after: the
// plain version's order where d is 1 or 2 mod 4 (core.ordered.dot_nt), and
// with `swap` where it is 0 or 3 mod 4 (core.ordered.dot_swapped). Below
// 64, DMAX is ceil4(d), so every group of 4 columns but the last is whole;
// at 128 each column is guarded. Columns at or past d are skipped.
template <int DMAX>
__device__ __forceinline__ float2 dot2_two(const float (&x)[DMAX],
                                           const float (&y)[DMAX],
                                           const float4* c, int d) {
  const int main = d & ~1;
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f, tx = 0.f, ty = 0.f;
#pragma unroll
  for (int q = 0; q < DMAX / 4; ++q) {
    const bool whole = DMAX <= 64 ? q + 1 < DMAX / 4 : 4 * q + 4 <= main;
    if (!whole && 4 * q >= d) continue;
    const float4 v = c[q];
    const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * q + r;
      if (whole || j < main) {
        if (r & 1) {
          a1 = fmaf(x[j], cv[r], a1);
          b1 = fmaf(y[j], cv[r], b1);
        } else {
          a0 = fmaf(x[j], cv[r], a0);
          b0 = fmaf(y[j], cv[r], b0);
        }
      } else if (j == main && main < d) {
        tx = __fmul_rn(x[j], cv[r]);
        ty = __fmul_rn(y[j], cv[r]);
      }
    }
  }
  float ox = __fadd_rn(a0, a1), oy = __fadd_rn(b0, b1);
  if (main < d) ox = __fadd_rn(ox, tx), oy = __fadd_rn(oy, ty);
  return make_float2(ox, oy);
}

// x . c and y . c over j < d in the plain version's order
// (core.ordered.dot_nt): a multiply-add chain below 4 terms; two
// interleaved chains where d is 1 or 2 mod 4 (dot2_two); else four
// interleaved multiply-add accumulators over the largest multiple of 4,
// (a0 + a1) + (a2 + a3), plus the tail's rounded products added in
// order. With `swap` (core.ordered.dot_swapped) the two interleaves
// trade places: four where d is 1 or 2 mod 4, two elsewhere. c is a centroid row padded to a multiple of 4 floats, read 4 at a
// time and used for both points. DMAX is ceil4(d) for d up to 64, so the
// tail (d % 4 terms) sits in the last 4 columns; 128 covers the rest, the
// tail found at run time. With CHAIN, both dots are one multiply-add
// chain over j < d, in order (core.ordered.dot_chain); padding columns are
// skipped, not added as zeros, so a -0 sum stays -0 as the plain version
// keeps it.
template <int DMAX, bool CHAIN>
__device__ __forceinline__ float2 dot2(const float (&x)[DMAX],
                                       const float (&y)[DMAX],
                                       const float4* c, int d, bool swap) {
  if (CHAIN) {
    float ax = 0.f, ay = 0.f;
#pragma unroll
    for (int q = 0; q < DMAX / 4; ++q) {
      if (4 * q < d) {
        const float4 v = c[q];
        const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * q + r < d) {
            ax = fmaf(x[4 * q + r], cv[r], ax);
            ay = fmaf(y[4 * q + r], cv[r], ay);
          }
        }
      }
    }
    return make_float2(ax, ay);
  }
  if (DMAX == 4 && d < 4) {
    const float4 v = c[0];
    float ax = fmaf(x[0], v.x, 0.f), ay = fmaf(y[0], v.x, 0.f);
    if (d > 1) ax = fmaf(x[1], v.y, ax), ay = fmaf(y[1], v.y, ay);
    if (d > 2) ax = fmaf(x[2], v.z, ax), ay = fmaf(y[2], v.z, ay);
    return make_float2(ax, ay);
  }
  if (((d & 3) == 1 || (d & 3) == 2) != swap)
    return dot2_two<DMAX>(x, y, c, d);
  const int main = d & ~3;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  float b0 = 0.f, b1 = 0.f, b2 = 0.f, b3 = 0.f;
  auto group = [&](int q, const float4& v) {
    a0 = fmaf(x[4 * q], v.x, a0);
    a1 = fmaf(x[4 * q + 1], v.y, a1);
    a2 = fmaf(x[4 * q + 2], v.z, a2);
    a3 = fmaf(x[4 * q + 3], v.w, a3);
    b0 = fmaf(y[4 * q], v.x, b0);
    b1 = fmaf(y[4 * q + 1], v.y, b1);
    b2 = fmaf(y[4 * q + 2], v.z, b2);
    b3 = fmaf(y[4 * q + 3], v.w, b3);
  };
  // the tail's terms, q = main / 4, added in order to the sums of the rest
  auto tail = [&](int q, const float4& v, float2 o) {
    float tx = __fmul_rn(x[4 * q], v.x), ty = __fmul_rn(y[4 * q], v.x);
    if (d > main + 1) {
      tx = __fadd_rn(tx, __fmul_rn(x[4 * q + 1], v.y));
      ty = __fadd_rn(ty, __fmul_rn(y[4 * q + 1], v.y));
    }
    if (d > main + 2) {
      tx = __fadd_rn(tx, __fmul_rn(x[4 * q + 2], v.z));
      ty = __fadd_rn(ty, __fmul_rn(y[4 * q + 2], v.z));
    }
    return make_float2(__fadd_rn(o.x, tx), __fadd_rn(o.y, ty));
  };
  auto sums = [&] {
    return make_float2(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)),
                       __fadd_rn(__fadd_rn(b0, b1), __fadd_rn(b2, b3)));
  };
  if (DMAX <= 64) {
    // every load first (padding columns hold 0), then the arithmetic
    float4 v[DMAX / 4];
#pragma unroll
    for (int q = 0; q < DMAX / 4; ++q) v[q] = c[q];
#pragma unroll
    for (int q = 0; q + 1 < DMAX / 4; ++q) group(q, v[q]);
    if (main == DMAX) {
      group(DMAX / 4 - 1, v[DMAX / 4 - 1]);
      return sums();
    }
    return tail(DMAX / 4 - 1, v[DMAX / 4 - 1], sums());
  }
#pragma unroll
  for (int q = 0; q < DMAX / 4; ++q)
    if (4 * q < main) group(q, c[q]);
  if (main == d) return sums();
  float2 out = sums();
#pragma unroll
  for (int q = 0; q < DMAX / 4; ++q)
    if (4 * q == main) out = tail(q, c[q], out);
  return out;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait that
// outlasts 2^26 polls (far beyond any real one) traps, so that a fault
// ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}
// One TMA bulk copy of `bytes` (a multiple of 16) contiguous bytes from
// global to shared memory (both 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// barrier 1, among the consumer warps only
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

struct Tile {
  long long f0;   // first float of the tile in x
  long long a0;   // first float of its 16-byte aligned interior
  int rows;       // points of the tile
  int floats;     // floats of the aligned interior (a multiple of 4)
};

__device__ __forceinline__ Tile tile_of(int item, int tiles, int tile_rows,
                                        int n, int d) {
  const int lane = item / tiles, t = item - lane * tiles;
  const int row0 = t * tile_rows;
  Tile tl;
  tl.rows = min(tile_rows, n - row0);
  tl.f0 = ((long long)lane * n + row0) * d;
  const long long f1 = tl.f0 + (long long)tl.rows * d;
  tl.a0 = (tl.f0 + 3) & ~3LL;
  const long long a1 = f1 & ~3LL;
  tl.floats = a1 > tl.a0 ? (int)(a1 - tl.a0) : 0;
  return tl;
}

// Block g walks items [g * items / G, (g + 1) * items / G) of the list of
// (lane, tile) items, lane-major; a tile is tile_rows points of one lane.
// CHAIN and `swap` pick the dot product's order (dot2).
template <int DMAX, bool CHAIN>
__global__ void __launch_bounds__(kThreads, 2)
    assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  int n, int k, int d, int tiles, int tile_rows, int items,
                  int split, int stage_floats, int xvec, int cvec,
                  int swap, int* __restrict__ labels,
                  float* __restrict__ mind2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + (size_t)kStages * stage_floats * sizeof(float));
  const int dp = (d + 3) & ~3;                    // padded centroid row
  float* cs = reinterpret_cast<float*>(bars + 2 * kStages);  // k * dp
  float* c2 = cs + k * dp;                                    // k norms
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + kStages * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + s * 8, 1);
      mbar_init(empty0 + s * 8, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int first = (int)((long long)blockIdx.x * items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues every copy of the block's run
    if (threadIdx.x == kConsumers) {
      for (int i = first; i < last; ++i) {
        const int u = (i - first) % kStages;
        mbar_wait(empty0 + u * 8, (((i - first) / kStages) & 1) ^ 1);
        const Tile tl = tile_of(i, tiles, tile_rows, n, d);
        mbar_expect_tx(full0 + u * 8, (uint32_t)tl.floats * 4);
        if (tl.floats > 0)
          bulk_load(smem_addr(ring + u * stage_floats), x + tl.a0,
                    (uint32_t)tl.floats * 4, full0 + u * 8);
      }
    }
    return;
  }

  const unsigned all = 0xffffffffu;
  const int share = threadIdx.x % split;       // this thread's centroids:
  const int lo = share * k / split;            // [lo, hi)
  const int hi = (share + 1) * k / split;
  const int half = kConsumers / split;         // points of half a tile
  int cur = -1;                                // lane in shared memory
  for (int i = first; i < last; ++i) {
    const int lane = i / tiles;
    if (lane != cur) {
      consumers_sync();                        // the old lane is done
      const float* cl = c + (size_t)lane * k * d;
      for (int t = threadIdx.x; t < k * dp; t += kConsumers) {
        const int kk = t / dp, j = t - kk * dp;
        cs[t] = j < d ? cl[kk * d + j] : 0.f;
      }
      consumers_sync();
      for (int kk = threadIdx.x; kk < k; kk += kConsumers)
        c2[kk] = kk < cvec ? sum_prod_row(cs + kk * dp, d)
                           : sum_sq_row(cs + kk * dp, d);
      consumers_sync();
      cur = lane;
    }
    const int u = (i - first) % kStages;
    mbar_wait(full0 + u * 8, ((i - first) / kStages) & 1);
    const Tile tl = tile_of(i, tiles, tile_rows, n, d);
    const float* st = ring + u * stage_floats;
    const int head = (int)(tl.a0 - tl.f0);     // floats before the copy
    const float4* cs4 = reinterpret_cast<const float4*>(cs);
    // points p[0] and p[1] of the tile share each centroid load
    int p[2];
    float xr[2][DMAX];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p[h] = h * half + threadIdx.x / split;
      const int at = p[h] * d - head;          // its place in the copy
      const float* xp = x + tl.f0 + (long long)p[h] * d;
#pragma unroll
      for (int j = 0; j < DMAX; ++j) xr[h][j] = 0.f;
      if (p[h] >= tl.rows) continue;
      if (at >= 0 && at + d <= tl.floats) {   // all of it in the copy
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          if (j < d) xr[h][j] = st[at + j];
      } else {
#pragma unroll
        for (int j = 0; j < DMAX; ++j)
          if (j < d) xr[h][j] = xp[j];
      }
    }
    // a point's norm takes its order from its row in the lane
    const int row0 = (i - lane * tiles) * tile_rows;
    const float x2a = norm_reg<DMAX>(xr[0], d, row0 + p[0] < xvec);
    const float x2b = norm_reg<DMAX>(xr[1], d, row0 + p[1] < xvec);
    float best[2] = {INFINITY, INFINITY};
    int arg[2] = {lo, lo};
    auto take = [&](int kk, float2 dots, float norm) {
      const float da = __fadd_rn(__fsub_rn(x2a, 2.0f * dots.x), norm);
      const float db = __fadd_rn(__fsub_rn(x2b, 2.0f * dots.y), norm);
      if (da < best[0]) {
        best[0] = da;
        arg[0] = kk;
      }
      if (db < best[1]) {
        best[1] = db;
        arg[1] = kk;
      }
    };
#pragma unroll 2
    for (int kk = lo; kk < hi; ++kk)
      take(kk, dot2<DMAX, CHAIN>(xr[0], xr[1], cs4 + kk * (dp / 4), d,
                                 swap != 0),
           c2[kk]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the shares of one point are `split` neighbouring lanes; the
      // lowest (d2, index) is the serial scan's strict-< winner
      for (int m = split >> 1; m > 0; m >>= 1) {
        const float ob = __shfl_xor_sync(all, best[h], m);
        const int oa = __shfl_xor_sync(all, arg[h], m);
        if (ob < best[h] || (ob == best[h] && oa < arg[h])) {
          best[h] = ob;
          arg[h] = oa;
        }
      }
      if (p[h] < tl.rows && share == 0) {
        const size_t at = (size_t)lane * n +
                          (size_t)(i - lane * tiles) * tile_rows + p[h];
        labels[at] = arg[h];
        mind2[at] = fmaxf(best[h], 0.f);
      }
    }
    mbar_arrive(empty0 + u * 8);
  }
}

constexpr int kDevices = 64;

// The current device, its SM count and shared-memory limit (queried once
// per device).
cudaError_t card_of(int* device_out, int* sms, int* max_smem) {
  static int cached[kDevices][2];
  int device = 0;
  if (cudaError_t e = cudaGetDevice(&device)) return e;
  if (device >= kDevices) return cudaErrorInvalidDevice;
  if (cached[device][0] == 0) {
    if (cudaError_t e = cudaDeviceGetAttribute(
            &cached[device][1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
            device))
      return e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &cached[device][0], cudaDevAttrMultiProcessorCount, device))
      return e;
  }
  *device_out = device;
  *sms = cached[device][0];
  *max_smem = cached[device][1];
  return cudaSuccess;
}

template <int DMAX, bool CHAIN>
cudaError_t launch(const float* x, const float* c, int b, int n, int k, int d,
                   int xvec, int cvec, int swap, int* labels, float* mind2,
                   int* geometry,
                   cudaStream_t stream) {
  int device = 0, sms = 0, max_smem = 0;
  if (cudaError_t e = card_of(&device, &sms, &max_smem)) return e;
  // threads that share a point: enough for the card's resident threads,
  // a power of two no larger than k
  int split = 1;
  while (split * 2 <= k && split < kMaxSplit &&
         (long long)b * n * split < (long long)sms * kTargetThreads)
    split *= 2;
  // a tile: two points for each consumer thread (fewer where 32 KB or the
  // shared memory left by the centroids cannot hold them), a multiple of 4
  const size_t fixed = 2 * kStages * sizeof(uint64_t) +
                       (size_t)(k * ((d + 3) & ~3) + k) * sizeof(float);
  int tile_rows = kTileFloats / d;
  if (tile_rows > 2 * kConsumers / split) tile_rows = 2 * kConsumers / split;
  tile_rows -= tile_rows % 4;
  auto stage_floats = [&] { return (tile_rows * d + 3) & ~3; };
  while (tile_rows > 4 && fixed + (size_t)kStages * stage_floats() *
                                      sizeof(float) > (size_t)max_smem)
    tile_rows = (tile_rows / 2) & ~3;
  const size_t smem = fixed + (size_t)kStages * stage_floats() * sizeof(float);
  if (tile_rows < 4 || smem > (size_t)max_smem) return cudaErrorInvalidValue;
  // per device: the limit raised and the occupancy found for the last
  // shared-memory size this instantiation ran with (host calls cost
  // microseconds, and a fit launches the kernel once a step)
  static size_t set_smem[kDevices], occupancy_smem[kDevices];
  static int blocks_per_sm[kDevices];
  if (smem > set_smem[device]) {
    if (cudaError_t e = cudaFuncSetAttribute(
            assign_kernel<DMAX, CHAIN>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem))
      return e;
    set_smem[device] = smem;
  }
  if (smem != occupancy_smem[device]) {
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks_per_sm[device], assign_kernel<DMAX, CHAIN>, kThreads,
            smem))
      return e;
    occupancy_smem[device] = smem;
  }
  const int per_sm = blocks_per_sm[device];
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  const long long items64 = (long long)b * tiles;
  if (items64 > (1LL << 30)) return cudaErrorInvalidValue;
  const int items = (int)items64;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  if (geometry != nullptr) {
    geometry[0] = grid;
    geometry[1] = items;
    geometry[2] = split;
  }
  assign_kernel<DMAX, CHAIN><<<grid, kThreads, smem, stream>>>(
      x, c, n, k, d, tiles, tile_rows, items, split, stage_floats(), xvec,
      cvec, swap, labels, mind2);
  return cudaGetLastError();
}


// A build unit's launch function for one order and width, or nullptr
// where the unit has no instantiation for them. Each unit defines `pick`;
// its C entries below report and launch what it picks, so the widths a
// unit serves are written in that unit alone.
using Launch = cudaError_t (*)(const float*, const float*, int, int, int,
                               int, int, int, int, int*, float*, int*,
                               cudaStream_t);
Launch pick(int d, bool chain);

}  // namespace

// 1 if this unit serves width d in the dot order `order`
// (core.ordered.DOT_ORDER_NAMES: 0 the interleaved chains, 1 one chain, 2
// the swapped interleave, which every interleaved instantiation serves),
// else 0.
extern "C" int kmeans_assign_serves(int d, int order) {
  return d > 0 && order >= 0 && order <= 2 && pick(d, order == 1) != nullptr;
}

// x (b, n, d), c (b, k, d) float32, contiguous, x 16-byte aligned; order:
// the dot order as kmeans_assign_serves takes it; xvec /
// cvec: the leading rows of each lane's points / centroids whose norms
// add rounded products in order (core.ordered.norm_vector_rows of n / k
// and d); labels (b, n) int32 and mind2 (b, n) float32 out; geometry (3
// ints, out): the persistent grid, the (lane, tile) items and the threads
// a point. Returns the CUDA error of the launch (0 = ok);
// cudaErrorInvalidValue where the unit does not serve d in that order.
extern "C" int kmeans_assign_f32(const float* x, const float* c, int b, int n,
                                 int k, int d, int order, int xvec, int cvec,
                                 int* labels, float* mind2, int* geometry,
                                 void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (k <= 0 || d <= 0 || order < 0 || order > 2 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Launch launch_fn = pick(d, order == 1);
  if (launch_fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_fn(x, c, b, n, k, d, xvec, cvec, order == 2, labels,
                        mind2, geometry, static_cast<cudaStream_t>(stream));
}
