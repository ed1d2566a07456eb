// Per-segment sums, sums of squares and counts, batched over lanes.
//
// Replaces the TPU kernel `_segment_kernel` / `segment_stats_padded` in
// src/repro/kernels/segment_stats/segment_stats.py. For lane b, segment s
// and feature j it sums x[b, i, j] and x[b, i, j]^2 over the rows i whose
// int32 label is s, and counts those rows. A label of -1, or one >= k,
// matches no segment: its values are never read, so a NaN in a dead row
// cannot reach any sum.
//
// The TPU kernel carried its accumulators across a sequential grid. On an
// H100 blocks run in parallel and in no order, and float atomicAdd would
// add in an order that changes from run to run. Here every output adds
// its segment's rows in row order, in float32, one rounding per add: the
// order of the plain version (which accumulates in index order on the CPU
// and on CUDA) and of the reference's segment_sum. Two launches are
// therefore bitwise equal, the kernel agrees with its plain version
// bitwise, and counts are exact. Adding only a segment's members in row
// order gives the same sum as walking every row and adding +0 for the
// others, so the rows are first partitioned by label, stably:
//
//   1. count:   one block per (256-row tile, lane) counts each segment's
//               rows in the tile;
//   2. scan:    one block per lane turns the (segment, tile) counts into
//               the place of each tile's first member of each segment in
//               the lane's permutation (segments in order, then tiles);
//   3. scatter: one block per (tile, lane) writes each valid row's index
//               to its place, warp by warp in row order, a row's rank
//               among the warp's rows of its label from __match_any_sync;
//   4. sum:     one block per (segment, lane, 128-column chunk) gathers
//               its members' rows in chunks through shared memory, and
//               one thread per column adds them in order; the loads of
//               the next chunk are in flight while a chunk is added.
//
// No float atomics anywhere; the partition uses no atomics at all.
//
// What bounds it on an H100: bytes, in principle (at the main path's BBV
// centroid update, 10 x 120000 x 16 floats and the labels, 82 MB, 25 us at
// 3.35 TB/s). Here each segment's sum is still a serial chain of adds, as
// long as the segment has members (about n / k rows when the segments are
// even, most of a lane when one cluster holds most points), so the sum
// pass is bound by that chain and by the gathers that feed it: the grid
// scales with lanes x segments x column chunks, each block keeps 32 loads
// per thread in flight behind the adds, and each chain reads its rows from
// shared memory in batches so that only the adds are serial. The
// partition passes read the labels twice and write the permutation once.

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 256;       // rows per partition tile (8 warps)
constexpr int kSumThreads = 256;     // threads per block of the sum pass
constexpr int kColChunk = 128;       // columns per block of the sum pass
constexpr int kPerThread = 32;       // values each thread stages per chunk
constexpr int kChunkFloats = kSumThreads * kPerThread;  // 32 KB
constexpr int kMaxChunkRows = 2048;
constexpr int kIdxPerThread = kMaxChunkRows / kSumThreads;
constexpr int kBatch = 8;            // rows whose loads issue together
constexpr int kMaxSegments = 12288;  // places of one tile in 48 KB of smem

// Walks one tile's rows warp by warp in row order. place[s] holds the
// next place of segment s on entry and one past the tile's last member on
// exit; with perm set, each valid row's index is written to its place.
// Every thread of the block must call it (it synchronises the block).
__device__ void place_tile(const int* __restrict__ lab, int r0, int n, int k,
                           int* place, int* __restrict__ perm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = r0 + threadIdx.x;
  int l = r < n ? lab[r] : -1;
  const bool valid = l >= 0 && l < k;
  if (!valid) l = -1;
  const unsigned same = __match_any_sync(0xffffffffu, l);
  const int rank = __popc(same & ((1u << lane) - 1u));
  for (int w = 0; w < kTileRows / 32; ++w) {
    if (warp == w) {
      const int at = valid ? place[l] + rank : 0;
      __syncwarp();
      if (valid) {
        if (perm != nullptr) perm[at] = r;
        if (rank == 0) place[l] = at + __popc(same);
      }
    }
    __syncthreads();
  }
}

// offsets (b, k, tiles): members of segment s in tile t of each lane
__global__ void count_kernel(const int* __restrict__ labels, int n, int k,
                             int tiles, int* __restrict__ offsets) {
  extern __shared__ int place[];
  const int lb = blockIdx.y, tile = blockIdx.x;
  for (int s = threadIdx.x; s < k; s += blockDim.x) place[s] = 0;
  __syncthreads();
  place_tile(labels + (size_t)lb * n, tile * kTileRows, n, k, place,
             nullptr);
  for (int s = threadIdx.x; s < k; s += blockDim.x)
    offsets[((size_t)lb * k + s) * tiles + tile] = place[s];
}

// offsets (b, k, tiles) counts -> first place of each (segment, tile);
// starts (b, k + 1): segment s of a lane holds places [starts[s],
// starts[s + 1]) of its permutation.
__global__ void scan_kernel(int* __restrict__ offsets, int k, int tiles,
                            int* __restrict__ starts) {
  const unsigned all = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int* off = offsets + (size_t)blockIdx.x * k * tiles;
  int* st = starts + (size_t)blockIdx.x * (k + 1);
  for (int s = warp; s < k; s += warps) {
    int total = 0;
    for (int t = lane; t < tiles; t += 32) total += off[(size_t)s * tiles + t];
    for (int m = 16; m > 0; m >>= 1) total += __shfl_xor_sync(all, total, m);
    if (lane == 0) st[s + 1] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    st[0] = 0;
    for (int s = 0; s < k; ++s) st[s + 1] += st[s];
  }
  __syncthreads();
  for (int s = warp; s < k; s += warps) {
    int run = st[s];
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const int t = t0 + lane;
      const int v = t < tiles ? off[(size_t)s * tiles + t] : 0;
      int inc = v;
      for (int m = 1; m < 32; m <<= 1) {
        const int u = __shfl_up_sync(all, inc, m);
        if (lane >= m) inc += u;
      }
      if (t < tiles) off[(size_t)s * tiles + t] = run + inc - v;
      run += __shfl_sync(all, inc, 31);
    }
  }
}

// perm (b, n): each lane's valid row indices, by segment, in row order
__global__ void scatter_kernel(const int* __restrict__ labels, int n, int k,
                               int tiles, const int* __restrict__ offsets,
                               int* __restrict__ perm) {
  extern __shared__ int place[];
  const int lb = blockIdx.y, tile = blockIdx.x;
  for (int s = threadIdx.x; s < k; s += blockDim.x)
    place[s] = offsets[((size_t)lb * k + s) * tiles + tile];
  __syncthreads();
  place_tile(labels + (size_t)lb * n, tile * kTileRows, n, k, place,
             perm + (size_t)lb * n);
}

// Gathers one chunk's values (rows idx[0 .. rows) of the lane, columns
// j0 .. j0 + dc) into registers: every load issues before any is used.
__device__ __forceinline__ void gather_chunk(const float* __restrict__ xl,
                                             const int* idx, int rows,
                                             int dc, int d,
                                             float (&v)[kPerThread]) {
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int t = threadIdx.x + u * kSumThreads;
    if (t < rows * dc) {
      const int r = t / dc;
      v[u] = xl[(size_t)idx[r] * d + (t - r * dc)];
    }
  }
}

__device__ __forceinline__ void load_index(const int* __restrict__ pl,
                                           int rows,
                                           int (&q)[kIdxPerThread]) {
#pragma unroll
  for (int u = 0; u < kIdxPerThread; ++u) {
    const int t = threadIdx.x + u * kSumThreads;
    if (t < rows) q[u] = pl[t];
  }
}

// One block per (segment, lane, column chunk). The segment's places
// [begin, end) of the permutation are walked in chunks; while the column
// threads add chunk i from shared memory, every thread already has the
// loads of chunk i + 1's values and chunk i + 2's row indices in flight.
__global__ void sum_kernel(const float* __restrict__ x,
                           const int* __restrict__ perm,
                           const int* __restrict__ starts, int n, int k,
                           int d, int chunk_rows, float* __restrict__ sums,
                           float* __restrict__ sumsq,
                           float* __restrict__ counts) {
  __shared__ int sidx[2][kMaxChunkRows];
  __shared__ float sx[kChunkFloats];
  const int s = blockIdx.x, lb = blockIdx.y;
  const int j0 = blockIdx.z * kColChunk;
  const int dc = min(kColChunk, d - j0);   // columns of this block
  const int c = threadIdx.x;
  const int begin = starts[(size_t)lb * (k + 1) + s];
  const int end = starts[(size_t)lb * (k + 1) + s + 1];
  const int* pl = perm + (size_t)lb * n + begin;
  const float* xl = x + (size_t)lb * n * d + j0;
  const int chunks = (end - begin + chunk_rows - 1) / chunk_rows;
  auto rows_of = [&](int i) {
    return min(chunk_rows, end - begin - i * chunk_rows);
  };
  auto stage_index = [&](int buf, const int (&q)[kIdxPerThread]) {
#pragma unroll
    for (int u = 0; u < kIdxPerThread; ++u)
      sidx[buf][threadIdx.x + u * kSumThreads] = q[u];
  };
  auto stage_values = [&](const float (&v)[kPerThread]) {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u)
      sx[threadIdx.x + u * kSumThreads] = v[u];
  };
  float v[kPerThread] = {};
  int q[kIdxPerThread] = {};
  if (chunks > 0) {
    load_index(pl, rows_of(0), q);
    stage_index(0, q);
    if (chunks > 1) {
      load_index(pl + chunk_rows, rows_of(1), q);
      stage_index(1, q);
    }
    __syncthreads();
    gather_chunk(xl, sidx[0], rows_of(0), dc, d, v);
    stage_values(v);
    __syncthreads();
  }
  float acc = 0.f, acc2 = 0.f;
  for (int i = 0; i < chunks; ++i) {
    const int rows = rows_of(i);
    if (i + 1 < chunks)
      gather_chunk(xl, sidx[(i + 1) & 1], rows_of(i + 1), dc, d, v);
    if (i + 2 < chunks)
      load_index(pl + (size_t)(i + 2) * chunk_rows, rows_of(i + 2), q);
    if (c < dc) {
      // rows go in batches: a batch's shared-memory loads all issue before
      // its adds, so only the add chain is serial
      int r = 0;
      for (; r + kBatch <= rows; r += kBatch) {
        float vb[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) vb[u] = sx[(r + u) * dc + c];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          acc = __fadd_rn(acc, vb[u]);
          acc2 = __fadd_rn(acc2, __fmul_rn(vb[u], vb[u]));
        }
      }
      for (; r < rows; ++r) {
        const float w = sx[r * dc + c];
        acc = __fadd_rn(acc, w);
        acc2 = __fadd_rn(acc2, __fmul_rn(w, w));
      }
    }
    __syncthreads();
    if (i + 1 < chunks) stage_values(v);
    // chunk i's indices are spent: chunk i + 2 takes their buffer
    if (i + 2 < chunks) stage_index(i & 1, q);
    __syncthreads();
  }
  if (c < dc) {
    sums[((size_t)lb * k + s) * d + j0 + c] = acc;
    sumsq[((size_t)lb * k + s) * d + j0 + c] = acc2;
  }
  if (blockIdx.z == 0 && threadIdx.x == 0)
    counts[(size_t)lb * k + s] = (float)(end - begin);
}

int tiles_of(int n) { return (n + kTileRows - 1) / kTileRows; }

}  // namespace

// int32 workspace that segment_stats_f32 needs for (b, n, k): the
// permutation (b, n), the (segment, tile) places (b, k, tiles) and the
// segment starts (b, k + 1).
extern "C" long long segment_stats_workspace(int b, int n, int k) {
  return (long long)b * n + (long long)b * k * tiles_of(n) +
         (long long)b * (k + 1);
}

// x (b, n, d) float32 and labels (b, n) int32, contiguous; outputs
// sums/sumsq (b, k, d) and counts (b, k); work: segment_stats_workspace
// int32s. Returns the CUDA error of the launches (0 = ok).
extern "C" int segment_stats_f32(const float* x, const int* labels, int b,
                                 int n, int k, int d, float* sums,
                                 float* sumsq, float* counts, int* work,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || k <= 0 || d <= 0) return 0;
  if (b > 65535 || n < 0 || k > kMaxSegments)
    return (int)cudaErrorInvalidValue;
  const int tiles = tiles_of(n);
  int* perm = work;
  int* offsets = perm + (size_t)b * n;
  int* starts = offsets + (size_t)b * k * tiles;
  const size_t smem = (size_t)k * sizeof(int);
  if (tiles > 0) {
    count_kernel<<<dim3(tiles, b), kTileRows, smem, st>>>(labels, n, k, tiles,
                                                          offsets);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  scan_kernel<<<b, 256, 0, st>>>(offsets, k, tiles, starts);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (tiles > 0) {
    scatter_kernel<<<dim3(tiles, b), kTileRows, smem, st>>>(
        labels, n, k, tiles, offsets, perm);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  const int cols = d < kColChunk ? d : kColChunk;
  int chunk_rows = kChunkFloats / cols;
  chunk_rows = chunk_rows > kMaxChunkRows ? kMaxChunkRows : chunk_rows;
  const int col_chunks = (d + kColChunk - 1) / kColChunk;
  if (col_chunks > 65535) return (int)cudaErrorInvalidValue;
  sum_kernel<<<dim3(k, b, col_chunks), kSumThreads, 0, st>>>(
      x, perm, starts, n, k, d, chunk_rows, sums, sumsq, counts);
  return (int)cudaGetLastError();
}
