// Build unit of the nearest-centroid assignment kernel: the tiled path,
// which replaces the TPU kernel `_assign_kernel` / `kmeans_assign_padded`
// in src/repro/kernels/kmeans_assign/kmeans_assign.py at every width and
// dot order, beside the register-resident kernel of kmeans_assign.cuh
// (whose unit, kmeans_assign.cu, holds a point's row in registers and
// so stops at d = 40 in the one-chain order and d = 48 in any). The
// wrapper asks the units in order (kernels/kmeans_assign/ops.py,
// `_UNITS`); this one is last and serves every d >= 1 in all five orders of
// core.ordered.DOT_ORDER_NAMES: the interleaved chains (four or two), one
// chain restarted every 512 columns, the swapped interleave, and with one
// centroid the one-lane vector loop and the several-lane matrix-vector
// loop.
//
// For lane b and point i it writes argmin_k (|x|^2 - 2 x.c_k + |c_k|^2) as
// an int32 label (ties to the lowest k, as the serial scan and jnp.argmin)
// and max(min d2, 0), every sum in the plain version's order
// (kernels/kmeans_assign/ref.py, core/ordered.py), so the two agree bit for
// bit:
//   * `assign_kernel_norms` writes each point's and centroid's squared norm
//     into the wrapper's scratch (`work`), one thread a row, the rows
//     staged through shared memory: a multiply-add chain up to 32 terms;
//     above, the rounded squares in windows of 32, the window sums again
//     in windows until at most 32 are left (core.ordered.tree_sum); the
//     vector body's rows at d = 5 to 8 (core.ordered.norm_vector_form) as
//     rounded squares in order;
//   * `assign_kernel_tiled<LANES>` (k >= 2, and one chain at k = 1): a
//     block takes 64 points of one lane against the centroids 32 at a
//     time, and streams the depth through shared memory 32 columns at a
//     time; each of its 256 threads carries 4 points x 2 centroids'
//     LANES accumulators across the chunks, reading four columns at once
//     (four or two interleaved multiply-add chains, the tail's rounded
//     products after them, or one chain that starts again at every 512th
//     column), keeps its points' best (d2, index) across the centroid
//     tiles, and a shuffle minimum over the 16 threads of a point picks
//     the winner;
//   * `assign_kernel_one_centroid` (k = 1 in the vector and matrix-vector
//     orders): one thread a point, its row read in the order the
//     reference's loop takes it (core.ordered.dot_vector, dot_gemv).
// Float32 multiply-adds on the CUDA cores only: TF32, wgmma or a library
// product would change the bits.
//
// What bounds it on an H100: at the bank's raw BBVs (10 lanes of 120000
// points, d = 256, k = 20) it reads 1.23 GB of points, 0.37 ms at 3.35
// TB/s, against 1.2e10 float32 operations, 0.18 ms at 67 TFLOP/s: bytes;
// at gcc's projected BBVs (120000 points, d = 64, k = 64) operations. This
// first version reads the points twice (norms, then tiles; each point
// once per 32 centroids), stages without overlapping copies and compute,
// and keeps 8 pairs a thread: it is right before it is fast.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 32;
constexpr int kChainBlock = 512;       // core.ordered._CHAIN_BLOCK
constexpr int kLevels = 4;             // window levels of a norm (d < 2^25)
constexpr int kNormRows = 128;         // rows of a norms block
constexpr int kThreads = 256;
constexpr int kTileP = 64;             // points of a block
constexpr int kTileK = 32;             // centroids of a tile
constexpr int kChunk = 32;             // columns staged at a time
constexpr int kRP = 4;                 // a thread's points
constexpr int kRK = 2;                 // and centroids
constexpr int kVectorFrom = 60;        // core.ordered._VECTOR_FROM
constexpr int kVectorUnrolledBelow = 18;

// core.ordered.DOT_ORDER_NAMES
enum Order { kFour = 0, kChain = 1, kSwapped = 2, kVector = 3, kGemv = 4 };

// core.ordered._VECTOR_EPILOGUE: the vector epilogue's width by the
// columns the main loop leaves
__constant__ int kEpilogue[32] = {0, 0, 2, 2, 4, 4, 2, 2, 8, 8, 8, 8, 4, 4,
                                  4, 4, 8, 8, 8, 8, 4, 4, 4, 4, 8, 8, 8, 8,
                                  4, 4, 4, 4};

// The window tree of core.ordered.tree_sum over a stream of values: level
// l groups its values into windows of 32 (the first one short by the left
// pad lo[l]), and each finished window's sum is the next level's value;
// the top level (at most 32 values) is summed in order.
struct Tree {
  int top;
  int lo[kLevels];
  int seen[kLevels];
  int win[kLevels];
  float acc[kLevels + 1];

  __device__ explicit Tree(int d) : top(0) {
    int m = d;
    while (m > kWindow && top < kLevels) {
      const int up = (m + kWindow - 1) / kWindow;
      lo[top] = (up * kWindow - m) / 2;
      seen[top] = 0;
      win[top] = 0;
      acc[top] = 0.f;
      m = up;
      ++top;
    }
    acc[top] = 0.f;
  }

  // v into level l: added to its window's sum or, where it opens the
  // next window, the finished window's sum carried up a level
  __device__ void add(int l, float v) {
    for (;; ++l) {
      if (l == top) {
        acc[l] = __fadd_rn(acc[l], v);
        return;
      }
      const int w = (seen[l]++ + lo[l]) / kWindow;
      if (w == win[l]) {
        acc[l] = __fadd_rn(acc[l], v);
        return;
      }
      const float done = acc[l];
      acc[l] = __fadd_rn(0.f, v);
      win[l] = w;
      v = done;
    }
  }

  __device__ void push(float v) { add(0, v); }

  // the last window of each level goes up, lowest level first
  __device__ float sum() {
    for (int l = 0; l < top; ++l) add(l + 1, acc[l]);
    return acc[top];
  }
};

// Squared norms of `rows` rows of width d (core.ordered.sum_sq_rows),
// 128 rows a block, the rows staged through shared memory 32 columns at a
// time (coalesced reads), one thread a row: a row's place is its index in
// its lane of `per` rows, or with one row a lane (per = 1) its lane; the
// first `vec` places take the vector body's order (rounded squares in
// order; `last`: the fifth by a multiply-add). Up to d = 1024 the window
// tree has one level (window sums added in order); deeper trees keep their
// levels in a Tree.
__global__ void __launch_bounds__(kNormRows)
    assign_kernel_norms(const float* __restrict__ v, long long rows,
                        int per, int d, int vec, int last,
                        float* __restrict__ out) {
  __shared__ float vs[kNormRows][kWindow + 1];
  const long long r0 = (long long)blockIdx.x * kNormRows;
  const long long r = r0 + threadIdx.x;
  const bool prods = (per == 1 ? r : r % per) < vec;
  const bool deep = d > kWindow * kWindow;
  const int lo = ((d + kWindow - 1) / kWindow * kWindow - d) / 2;
  Tree tree(deep ? d : 1);
  float acc = 0.f, part = 0.f;
  int win = 0;
  for (int j0 = 0; j0 < d; j0 += kWindow) {
    const int w = min(kWindow, d - j0);
    __syncthreads();                   // the last chunk is read
    for (int t = threadIdx.x; t < kNormRows * kWindow; t += kNormRows) {
      const int i = t / kWindow, j = t % kWindow;
      vs[i][j] = (r0 + i < rows && j < w) ? v[(r0 + i) * d + j0 + j] : 0.f;
    }
    __syncthreads();
    if (r >= rows) continue;
    for (int j = 0; j < w; ++j) {
      const float e = vs[threadIdx.x][j];
      const int col = j0 + j;
      if (prods) {
        acc = last && col == d - 1 ? fmaf(e, e, acc)
                                   : __fadd_rn(acc, __fmul_rn(e, e));
      } else if (d <= kWindow) {
        acc = fmaf(e, e, acc);
      } else if (deep) {
        tree.push(__fmul_rn(e, e));
      } else {
        if ((col + lo) / kWindow != win) {
          acc = __fadd_rn(acc, part);
          part = 0.f;
          win = (col + lo) / kWindow;
        }
        part = __fadd_rn(part, __fmul_rn(e, e));
      }
    }
  }
  if (r >= rows) return;
  if (!prods && d > kWindow) acc = deep ? tree.sum() : __fadd_rn(acc, part);
  out[r] = acc;
}

// The (d2, index) pair that wins: the lower d2, on a tie the lower index
// (the serial scan's strict-< winner).
__device__ __forceinline__ bool wins(float d2, int i, float best, int arg) {
  return d2 < best || (d2 == best && i < arg);
}

// One lane's points p0 .. p0 + 63 against all its centroids with LANES
// multiply-add chains (4 or 2 interleaved, 1: one chain restarted every
// 512 columns). Thread (ty, tx) takes points 4 ty .. 4 ty + 3 and, of each
// 32-centroid tile, centroids tx and tx + 16 (rising, so a thread's ties
// keep the lower index; neighbouring rows of the tile, so its 16-byte
// reads of four columns hit distinct banks). The columns after the chains
// (at most 3) are read from global memory at the end. Grid: (point tiles,
// lanes lane0 ..), 65,535 lanes a launch at most.
template <int LANES>
__global__ void __launch_bounds__(kThreads, 2)
    assign_kernel_tiled(const float* __restrict__ x,
                        const float* __restrict__ c,
                        const float* __restrict__ x2,
                        const float* __restrict__ c2, int n, int k, int d,
                        int lane0, int* __restrict__ labels,
                        float* __restrict__ mind2) {
  __shared__ __align__(16) float xs[kTileP][kChunk + 4];
  __shared__ __align__(16) float cs[kTileK][kChunk + 4];
  const int lane = lane0 + blockIdx.y;
  const int p0 = blockIdx.x * kTileP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int main = d - d % LANES;
  const float* xl = x + (size_t)lane * n * d;
  const float* cl = c + (size_t)lane * k * d;

  float best[kRP];
  int arg[kRP];
#pragma unroll
  for (int i = 0; i < kRP; ++i) best[i] = INFINITY, arg[i] = 0;

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    // per pair: acc the chains (acc[0] the current 512-column block of
    // one chain), total the one chain's finished blocks
    float acc[kRP][kRK][LANES], total[kRP][kRK];
#pragma unroll
    for (int i = 0; i < kRP; ++i)
#pragma unroll
      for (int q = 0; q < kRK; ++q) {
#pragma unroll
        for (int l = 0; l < LANES; ++l) acc[i][q][l] = 0.f;
        total[i][q] = 0.f;
      }
    for (int j0 = 0; j0 < main; j0 += kChunk) {
      const int w = min(kChunk, main - j0);
      for (int t = threadIdx.x; t < kTileP * kChunk; t += kThreads) {
        const int r = t / kChunk, j = t % kChunk;
        xs[r][j] = (p0 + r < n && j < w)
                       ? xl[(size_t)(p0 + r) * d + j0 + j] : 0.f;
      }
      for (int t = threadIdx.x; t < kTileK * kChunk; t += kThreads) {
        const int r = t / kChunk, j = t % kChunk;
        cs[r][j] = (k0 + r < k && j < w)
                       ? cl[(size_t)(k0 + r) * d + j0 + j] : 0.f;
      }
      __syncthreads();
      if (LANES == 1 && j0 > 0 && j0 % kChainBlock == 0) {
        // a 512-column block of one chain is done: add it to the others
#pragma unroll
        for (int i = 0; i < kRP; ++i)
#pragma unroll
          for (int q = 0; q < kRK; ++q) {
            total[i][q] = j0 == kChainBlock
                              ? acc[i][q][0]
                              : __fadd_rn(total[i][q], acc[i][q][0]);
            acc[i][q][0] = 0.f;
          }
      }
      for (int j4 = 0; j4 < w; j4 += 4) {
        float xv[kRP][4], cv[kRK][4];
#pragma unroll
        for (int i = 0; i < kRP; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(&xs[ty * kRP + i][j4]);
          xv[i][0] = v.x, xv[i][1] = v.y, xv[i][2] = v.z, xv[i][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < kRK; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(&cs[q * 16 + tx][j4]);
          cv[q][0] = v.x, cv[q][1] = v.y, cv[q][2] = v.z, cv[q][3] = v.w;
        }
        // chunks start at multiples of 4: a column's chain is its index
        // mod LANES; with four chains every group of 4 is whole
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (LANES != 4 && j4 + r >= w) break;
#pragma unroll
          for (int i = 0; i < kRP; ++i)
#pragma unroll
            for (int q = 0; q < kRK; ++q)
              acc[i][q][r % LANES] =
                  fmaf(xv[i][r], cv[q][r], acc[i][q][r % LANES]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const int p = p0 + ty * kRP + i;
#pragma unroll
      for (int q = 0; q < kRK; ++q) {
        const int kk = k0 + q * 16 + tx;
        if (p >= n || kk >= k) continue;
        float dot;
        if (LANES == 1) {
          dot = d > kChainBlock ? __fadd_rn(total[i][q], acc[i][q][0])
                                : acc[i][q][0];
        } else {
          dot = __fadd_rn(acc[i][q][0], acc[i][q][1]);
          if (LANES == 4)
            dot = __fadd_rn(dot, __fadd_rn(acc[i][q][2], acc[i][q][3]));
          if (main < d) {
            // the tail's rounded products, in order, after the chains
            const float* xp = xl + (size_t)p * d;
            const float* cp = cl + (size_t)kk * d;
            float tail = __fmul_rn(xp[main], cp[main]);
            for (int j = main + 1; j < d; ++j)
              tail = __fadd_rn(tail, __fmul_rn(xp[j], cp[j]));
            dot = __fadd_rn(dot, tail);
          }
        }
        const float d2 = __fadd_rn(
            __fsub_rn(x2[(size_t)lane * n + p], 2.0f * dot),
            c2[(size_t)lane * k + kk]);
        if (d2 < best[i]) {            // a thread's centroids rise: ties
          best[i] = d2;                // keep the lowest index
          arg[i] = kk;
        }
      }
    }
  }
  // the 16 threads of a row of points are neighbouring lanes of a warp
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], m);
      const int oa = __shfl_xor_sync(0xffffffffu, arg[i], m);
      if (wins(ob, oa, best[i], arg[i])) {
        best[i] = ob;
        arg[i] = oa;
      }
    }
    const int p = p0 + ty * kRP + i;
    if (tx == 0 && p < n) {
      labels[(size_t)lane * n + p] = arg[i];
      mind2[(size_t)lane * n + p] = fmaxf(best[i], 0.f);
    }
  }
}

// the upper half of the first `width` lanes onto the lower, until one is
// left (core.ordered._halves)
__device__ __forceinline__ float halves(float (&v)[8], int width) {
#pragma unroll
  for (int h = 4; h > 0; h >>= 1) {
    if (2 * h > width) continue;
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (l < h) v[l] = __fadd_rn(v[l], v[l + h]);
  }
  return v[0];
}

// neighbouring lanes first (core.ordered._pairs)
__device__ __forceinline__ float pairs(const float (&v)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

// x . c with one centroid over one lane (core.ordered.dot_vector)
__device__ float dot_vector(const float* __restrict__ x,
                            const float* __restrict__ c, int d) {
  float out = 0.f;
  if (d < kVectorFrom) {
    for (int j = 0; j < d; ++j) out = fmaf(x[j], c[j], out);
    return out;
  }
  const int parts = d < 64 ? 2 : 4;
  const int trips = d / (8 * parts);
  float acc[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) acc[l] = 0.f;
  if (trips < kVectorUnrolledBelow) {
    // one eight-lane chain, part by part, a later part's first two
    // chunks swapped
    for (int p = 0; p < parts; ++p)
      for (int i = 0; i < trips; ++i) {
        const int ii = (p > 0 && trips >= 2 && i < 2) ? 1 - i : i;
        const int at = 8 * (p + parts * ii);
#pragma unroll
        for (int l = 0; l < 8; ++l) acc[l] = fmaf(x[at + l], c[at + l], acc[l]);
      }
  } else {
    // each part its own eight-lane chain, the parts added in order
    float part[4][8];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int l = 0; l < 8; ++l) part[p][l] = 0.f;
    for (int i = 0; i < trips; ++i) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= parts) break;
        const int at = 8 * (p + parts * i);
#pragma unroll
        for (int l = 0; l < 8; ++l)
          part[p][l] = fmaf(x[at + l], c[at + l], part[p][l]);
      }
    }
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      acc[l] = part[0][l];
#pragma unroll
      for (int p = 1; p < 4; ++p)
        if (p < parts) acc[l] = __fadd_rn(acc[l], part[p][l]);
    }
  }
  out = halves(acc, 8);
  int at = 8 * parts * trips;
  const int width = kEpilogue[d - at];
  if (width > 0) {
    float lanes[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) lanes[l] = 0.f;
    lanes[0] = out;
    for (int e = (d - at) / width; e > 0; --e, at += width) {
#pragma unroll
      for (int l = 0; l < 8; ++l)
        if (l < width) lanes[l] = fmaf(x[at + l], c[at + l], lanes[l]);
    }
    out = halves(lanes, width);
  }
  for (int j = at; j < d; ++j) out = fmaf(x[j], c[j], out);
  return out;
}

// x . c with one centroid over several lanes (core.ordered.dot_gemv): the
// row's place in its lane picks the eight lanes' sum
__device__ float dot_gemv(const float* __restrict__ x,
                          const float* __restrict__ c, int d, bool whole) {
  const int main = d - d % 8;
  float acc[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) acc[l] = 0.f;
  for (int j = 0; j < main; j += 8) {
#pragma unroll
    for (int l = 0; l < 8; ++l) acc[l] = fmaf(x[j + l], c[j + l], acc[l]);
  }
  const float out = whole ? pairs(acc) : halves(acc, 8);
  if (main == d) return out;
  float tail = 0.f;
  for (int j = main; j < d; ++j) tail = fmaf(x[j], c[j], tail);
  return __fadd_rn(out, tail);
}

// k = 1 in the vector or matrix-vector order: one thread a point.
__global__ void assign_kernel_one_centroid(const float* __restrict__ x,
                                    const float* __restrict__ c,
                                    const float* __restrict__ x2,
                                    const float* __restrict__ c2, int b,
                                    int n, int d, int order,
                                    int* __restrict__ labels,
                                    float* __restrict__ mind2) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)b * n) return;
  const int lane = (int)(g / n), row = (int)(g % n);
  const float* xp = x + g * d;
  const float* cp = c + (size_t)lane * d;
  const float dot = order == kVector ? dot_vector(xp, cp, d)
                                     : dot_gemv(xp, cp, d, row < n - n % 8);
  const float d2 = __fadd_rn(__fsub_rn(x2[g], 2.0f * dot), c2[lane]);
  labels[g] = 0;
  mind2[g] = fmaxf(d2, 0.f);
}

}  // namespace

// 1 if this unit serves width d in the dot order `order`
// (core.ordered.DOT_ORDER_NAMES) with k centroids a lane: every d >= 1 and
// k >= 1 in every order.
extern "C" int kmeans_assign_serves(int d, int order, int k) {
  return d > 0 && k > 0 && order >= 0 && order <= 4;
}

// Floats of scratch a launch needs in `work`: the points' and the
// centroids' squared norms.
extern "C" long long kmeans_assign_work(int b, int n, int k, int d,
                                        int order) {
  return (long long)b * n + (long long)b * k;
}

// The entry of kmeans_assign.cuh's units, with the same arguments: x (b, n,
// d), c (b, k, d) float32, contiguous; order as kmeans_assign_serves takes
// it; xvec / cvec and xlast / clast the norms' vector rows
// (core.ordered.norm_vector_form of n / k, with one row a lane counted by
// lane); work: kmeans_assign_work floats; labels (b, n) int32 and mind2 (b,
// n) float32 out; geometry (3 ints, out): the point tiles' blocks (or the
// one-centroid kernel's), the (lane, tile) items and the threads a point.
// Returns the first CUDA error of the launches (0 = ok).
extern "C" int kmeans_assign_f32(const float* x, const float* c, int b, int n,
                                 int k, int d, int order, int xvec, int cvec,
                                 int xlast, int clast, float* work,
                                 int* labels, float* mind2, int* geometry,
                                 void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (k <= 0 || d <= 0 || order < 0 || order > 4 || work == nullptr ||
      ((order == kVector || order == kGemv) && k != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* x2 = work;
  float* c2 = work + (long long)b * n;
  const long long xr = (long long)b * n, cr = (long long)b * k;
  assign_kernel_norms<<<(unsigned)((xr + kNormRows - 1) / kNormRows),
                        kNormRows, 0, s>>>(x, xr, n, d, xvec, xlast, x2);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  assign_kernel_norms<<<(unsigned)((cr + kNormRows - 1) / kNormRows),
                        kNormRows, 0, s>>>(c, cr, k, d, cvec, clast, c2);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (order == kVector || order == kGemv) {
    const unsigned blocks = (unsigned)((xr + 255) / 256);
    if (geometry != nullptr) {
      geometry[0] = (int)blocks;
      geometry[1] = (int)blocks;
      geometry[2] = 1;
    }
    assign_kernel_one_centroid<<<blocks, 256, 0, s>>>(x, c, x2, c2, b, n, d,
                                                       order, labels, mind2);
    return (int)cudaGetLastError();
  }
  const int tiles = (n + kTileP - 1) / kTileP;
  if (geometry != nullptr) {
    geometry[0] = tiles;
    geometry[1] = (int)min((long long)tiles * b, 0x7fffffffLL);
    geometry[2] = 16;
  }
  // the interleave's chains: 4 or 2 (dot_nt's by d mod 4, dot_swapped's the
  // other way), one for the one-chain order and below d = 4
  const bool two = (d % 4 == 1 || d % 4 == 2) != (order == kSwapped);
  const int lanes = order == kChain || d < 4 ? 1 : two ? 2 : 4;
  const auto kernel = lanes == 4   ? assign_kernel_tiled<4>
                      : lanes == 2 ? assign_kernel_tiled<2>
                                   : assign_kernel_tiled<1>;
  // gridDim.y takes 65,535 lanes: more go to further launches
  for (int lane0 = 0; lane0 < b; lane0 += 65535) {
    kernel<<<dim3(tiles, min(65535, b - lane0)), kThreads, 0, s>>>(
        x, c, x2, c2, n, k, d, lane0, labels, mind2);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  return 0;
}
