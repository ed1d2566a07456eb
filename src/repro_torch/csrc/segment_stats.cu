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
// others, so the rows are first partitioned by label, stably, and
// gathered:
//
//   1. count:   one block per (256-row tile, lane) counts each segment's
//               rows in the tile;
//   2. scan:    one block per lane turns the (segment, tile) counts into
//               the place of each tile's first member of each segment in
//               the lane's gathered rows: segments in order, each padded
//               to a multiple of 32 rows, then tiles;
//   3. scatter: one block per (tile, lane) gives each valid row its place,
//               warp by warp in row order (a row's rank among the warp's
//               rows of its label from __match_any_sync), puts the tile's
//               rows in place order, and copies each row to its place, in
//               the layout the sum pass reads;
//   4. order:   only when the sum pass has more blocks than fit on the
//               card at once: one block lists the sum pass's work items
//               longest segment first (by the power of two of its length,
//               stably), so that the longest chains start in the first
//               wave;
//   5. sum:     a work item is (lane, segment, 16-column chunk). Its
//               chains -- a sum and a sum of squares for each column --
//               are the threads of one consumer warp, each adding its
//               column's values in row order. A producer warp streams the
//               item's gathered rows, 128 a stage, into a 4-stage
//               shared-memory ring with one TMA bulk copy a stage; full
//               and empty mbarriers, not block barriers, hand the stages
//               over. The consumer loads 32 rows into registers before it
//               adds the previous 32, so only the dependent FADD chain is
//               serial.
//
// No float atomics anywhere; the partition uses no atomics at all.
//
// Passes 1-3 keep one int place per segment in a block's shared memory,
// which holds 11,264 of them (kRange) beside a tile's order. Above that k
// the partition is ranged, and the places sit in a (lane, tile, segment)
// table in device memory instead:
//
//   1. count:   one block per (tile, range of 11,264 segments, lane): a
//               tile is 256 ceil(k / 8192) rows, walked 256 at a time
//               (place_tile carries the places from one to the next), so
//               the table holds about 32 ints a row whatever k is; a
//               block sees only the labels in its range;
//   2. scan:    one thread per (lane, segment) turns its column of the
//               table into the place of each tile's first member within
//               the segment, and its size; one block per lane then lays
//               the segments out in order, each padded to a multiple of 4
//               rows (16-byte TMA sources, and 4n rows of padding at most
//               where k is near n, not 32n);
//   3. scatter: as the count, each row copied straight to its place.
//
// Passes 4-5 are the same on both partitions. Ranges keep the row order
// (a segment's members in one tile are placed in row order, and tiles in
// order), and cost one read of the labels per range. Lanes beyond 65,535
// go to further launches of the grid's y axis, 65,535 lanes each.
//
// What bounds it on an H100: at the main path's BBV centroid update (10 x
// 120000 rows of 16 floats and the labels) bytes take 25 us at 3.35 TB/s,
// but each output is a serial chain of float32 adds as long as its
// segment: a launch lasts at least its longest segment times the add
// latency (about 4.2 cycles), 0.13 ms for a 61,000-row cluster. The sum
// pass is built to run at that chain's speed: each chain has its own
// thread; a column's rows sit four to a 16-byte word, so a thread reads
// 32 rows with 8 shared-memory loads; the stages arrive whole, far ahead.
// Gathering the rows one by one in the sum pass held a producer warp to
// 16-30 cycles a row, well above the chain, so the scatter pass, which
// runs on the whole card at once, moves them instead. Where k is near n
// (the ranged partition) the chains are a few rows long and the bytes
// few; what leads there is work a segment: the item order, one block
// scanning every item once for each length class present, and the sum
// pass's set-up of a warp pair an item.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 256;       // rows per partition tile (8 warps)
constexpr int kRange = 11264;        // places of one tile, and its order,
                                     // in the 48 KB of smem of a block
constexpr int kRangedRows = 8192;    // segments per 256 rows of a ranged
                                     // partition's tile
constexpr int kMaxLanes = 65535;     // lanes of one launch (gridDim.y)
constexpr int kCols = 16;            // columns of one work item
constexpr int kRows = 32;            // rows a consumer loads at once
constexpr int kBatches = 4;          // loads of one stage
constexpr int kRing = 4;             // stages of one work item's ring
constexpr int kPairs = 2;            // (consumer, producer) warps a block
constexpr int kStageFloats = kBatches * kRows * kCols;
constexpr int kSumThreads = 64 * kPairs;
constexpr size_t kSumSmem =
    (size_t)kPairs * kRing * (kStageFloats * sizeof(float) + 16);

// Gathered rows: for lane b and 16-column chunk h of width w (16, or what
// is left of d), a region of `pad` rows; place p, column c of the region
// holds its value at (p / 4) 4 w + 4 c + p % 4, so that four rows of a
// column are one 16-byte word. Every segment starts at a multiple of 32.
__device__ __forceinline__ size_t gathered_at(int lane, int chunk, int pad,
                                              int d, int w, int p, int c) {
  return (size_t)lane * pad * d + (size_t)pad * kCols * chunk +
         ((size_t)(p >> 2) * w + c) * 4 + (p & 3);
}

// Copies row r of lane lb (d values) to place p of the gathered rows.
__device__ __forceinline__ void copy_row(const float* __restrict__ x, int lb,
                                         int n, int d, int pad, int r, int p,
                                         float* __restrict__ gathered) {
  const float* row = x + ((size_t)lb * n + r) * d;
  for (int j = 0; j < d; ++j) {
    const int chunk = j / kCols, c = j - chunk * kCols;
    const int w = min(kCols, d - chunk * kCols);
    gathered[gathered_at(lb, chunk, pad, d, w, p, c)] = row[j];
  }
}

// Walks 256 rows warp by warp in row order. place[s - lo] holds the next
// place of segment s in [lo, hi) on entry and one past the rows' last
// member on exit. Returns the thread's row's place, or -1 for a dead row,
// one outside [lo, hi) or none. Every thread of the block must call it
// (it synchronises the block).
__device__ int place_tile(const int* __restrict__ lab, int r0, int n, int lo,
                          int hi, int* place) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = r0 + threadIdx.x;
  int l = r < n ? lab[r] : -1;
  const bool valid = l >= lo && l < hi;
  l = valid ? l - lo : -1;
  const unsigned same = __match_any_sync(0xffffffffu, l);
  const int rank = __popc(same & ((1u << lane) - 1u));
  int at = -1;
  for (int w = 0; w < kTileRows / 32; ++w) {
    if (warp == w) {
      if (valid) at = place[l] + rank;
      __syncwarp();
      if (valid && rank == 0) place[l] = at + __popc(same);
    }
    __syncthreads();
  }
  return at;
}

// offsets (b, k, tiles): members of segment s in tile t of each lane
__global__ void count_kernel(const int* __restrict__ labels, int n, int k,
                             int tiles, int lane0, int* __restrict__ offsets) {
  extern __shared__ int place[];
  const int lb = lane0 + blockIdx.y, tile = blockIdx.x;
  for (int s = threadIdx.x; s < k; s += blockDim.x) place[s] = 0;
  __syncthreads();
  place_tile(labels + (size_t)lb * n, tile * kTileRows, n, 0, k, place);
  for (int s = threadIdx.x; s < k; s += blockDim.x)
    offsets[((size_t)lb * k + s) * tiles + tile] = place[s];
}

// offsets (b, k, tiles) counts -> place of each (segment, tile)'s first
// member; starts (b, k): segment s of a lane holds places [starts[s],
// starts[s] + sizes[s]) of its gathered rows, starts[s] a multiple of 32.
__global__ void scan_kernel(int* __restrict__ offsets, int k, int tiles,
                            int* __restrict__ starts,
                            int* __restrict__ sizes) {
  const unsigned all = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int* off = offsets + (size_t)blockIdx.x * k * tiles;
  int* st = starts + (size_t)blockIdx.x * k;
  int* sz = sizes + (size_t)blockIdx.x * k;
  for (int s = warp; s < k; s += warps) {
    int total = 0;
    for (int t = lane; t < tiles; t += 32) total += off[(size_t)s * tiles + t];
    for (int m = 16; m > 0; m >>= 1) total += __shfl_xor_sync(all, total, m);
    if (lane == 0) sz[s] = total;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int s = 0; s < k; ++s) {
      st[s] = run;
      run += (sz[s] + kRows - 1) / kRows * kRows;
    }
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

// gathered: each lane's valid rows at their places (see gathered_at).
// The tile's valid rows are first put in place order, so that neighbouring
// threads write neighbouring places (four rows of a column are one 16-byte
// word) whatever the labels' order.
__global__ void scatter_kernel(const float* __restrict__ x,
                               const int* __restrict__ labels, int n, int k,
                               int d, int tiles, int pad, int lane0,
                               const int* __restrict__ offsets,
                               float* __restrict__ gathered) {
  extern __shared__ int place[];
  __shared__ int row_of[kTileRows], place_of[kTileRows];
  __shared__ int valid_rows;
  const int lb = lane0 + blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * kTileRows;
  const int* first = offsets + (size_t)lb * k * tiles + tile;  // [s * tiles]
  const int* lab = labels + (size_t)lb * n;
  for (int s = threadIdx.x; s < k; s += blockDim.x)
    place[s] = first[(size_t)s * tiles];
  __syncthreads();
  const int at = place_tile(lab, r0, n, 0, k, place);
  // place[s]: the tile's members of segment s, then of the segments
  // before s (one warp scans k counts)
  for (int s = threadIdx.x; s < k; s += blockDim.x)
    place[s] -= first[(size_t)s * tiles];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = (k + 31) / 32;
    const int lo = min(k, lane * per), hi = min(k, lo + per);
    int sum = 0;
    for (int s = lo; s < hi; ++s) sum += place[s];
    int inc = sum;
    for (int m = 1; m < 32; m <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, m);
      if (lane >= m) inc += u;
    }
    int run = inc - sum;
    for (int s = lo; s < hi; ++s) {
      const int v = place[s];
      place[s] = run;
      run += v;
    }
    if (lane == 31) valid_rows = inc;
  }
  __syncthreads();
  if (at >= 0) {
    const int l = lab[r0 + threadIdx.x];
    const int i = place[l] + at - first[(size_t)l * tiles];
    row_of[i] = threadIdx.x;
    place_of[i] = at;
  }
  __syncthreads();
  if (threadIdx.x >= valid_rows) return;
  copy_row(x, lb, n, d, pad, r0 + row_of[threadIdx.x], place_of[threadIdx.x],
           gathered);
}

// Ranged partition, pass 1. table (b, tiles, k): members of segment s in
// tile t of each lane. Block (tile + tiles range, lane - lane0); a tile
// is `sub` runs of 256 rows.
__global__ void count_ranged_kernel(const int* __restrict__ labels, int n,
                                    int k, int tiles, int sub, int lane0,
                                    int* __restrict__ table) {
  extern __shared__ int place[];
  const int lb = lane0 + blockIdx.y, tile = blockIdx.x % tiles;
  const int lo = blockIdx.x / tiles * kRange, hi = min(k, lo + kRange);
  for (int s = threadIdx.x; s < hi - lo; s += blockDim.x) place[s] = 0;
  __syncthreads();
  const int* lab = labels + (size_t)lb * n;
  for (int j = 0; j < sub; ++j)
    place_tile(lab, (tile * sub + j) * kTileRows, n, lo, hi, place);
  int* row = table + ((size_t)lb * tiles + tile) * k + lo;
  for (int s = threadIdx.x; s < hi - lo; s += blockDim.x) row[s] = place[s];
}

// Ranged partition, pass 2a: per (lane, segment), the table's column
// becomes each tile's first member's place within the segment (an
// exclusive prefix over tiles); sizes (b, k) the segment's members.
__global__ void sizes_ranged_kernel(int* __restrict__ table, int b, int k,
                                    int tiles, int* __restrict__ sizes) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)b * k) return;
  const long long lb = g / k, s = g - lb * k;
  int* col = table + lb * tiles * k + s;
  int run = 0;
  for (int t = 0; t < tiles; ++t) {
    const int v = col[(size_t)t * k];
    col[(size_t)t * k] = run;
    run += v;
  }
  sizes[g] = run;
}

// Ranged partition, pass 2b: one block of 1024 threads per lane lays the
// segments out in order, each padded to a multiple of 4 rows; thread i
// takes segments [i per, (i + 1) per).
__global__ void starts_ranged_kernel(const int* __restrict__ sizes, int k,
                                     int* __restrict__ starts) {
  __shared__ int warp_sums[32];
  const unsigned all = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* sz = sizes + (size_t)blockIdx.x * k;
  int* st = starts + (size_t)blockIdx.x * k;
  const int per = (k + blockDim.x - 1) / blockDim.x;
  const int lo = min(k, (int)threadIdx.x * per), hi = min(k, lo + per);
  int sum = 0;
  for (int s = lo; s < hi; ++s) sum += (sz[s] + 3) & ~3;
  int inc = sum;
  for (int m = 1; m < 32; m <<= 1) {
    const int u = __shfl_up_sync(all, inc, m);
    if (lane >= m) inc += u;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    int wi = w;
    for (int m = 1; m < 32; m <<= 1) {
      const int u = __shfl_up_sync(all, wi, m);
      if (lane >= m) wi += u;
    }
    warp_sums[lane] = wi - w;              // warps before this one
  }
  __syncthreads();
  int run = warp_sums[warp] + inc - sum;
  for (int s = lo; s < hi; ++s) {
    st[s] = run;
    run += (sz[s] + 3) & ~3;
  }
}

// Ranged partition, pass 3: the grid of the count; each valid row in the
// block's range is copied to its place.
__global__ void scatter_ranged_kernel(
    const float* __restrict__ x, const int* __restrict__ labels, int n, int k,
    int d, int tiles, int sub, int pad, int lane0,
    const int* __restrict__ table, const int* __restrict__ starts,
    float* __restrict__ gathered) {
  extern __shared__ int place[];
  const int lb = lane0 + blockIdx.y, tile = blockIdx.x % tiles;
  const int lo = blockIdx.x / tiles * kRange, hi = min(k, lo + kRange);
  const int* row = table + ((size_t)lb * tiles + tile) * k;
  const int* st = starts + (size_t)lb * k;
  for (int s = lo + threadIdx.x; s < hi; s += blockDim.x)
    place[s - lo] = st[s] + row[s];
  __syncthreads();
  const int* lab = labels + (size_t)lb * n;
  for (int j = 0; j < sub; ++j) {
    const int r0 = (tile * sub + j) * kTileRows;
    const int at = place_tile(lab, r0, n, lo, hi, place);
    if (at >= 0) copy_row(x, lb, n, d, pad, r0 + threadIdx.x, at, gathered);
  }
}

// Rank class of a work item: 32 for an empty segment, else 31 minus the
// power of two of its length, so that the longest come first.
__device__ __forceinline__ int length_class(const int* sizes, int chunks,
                                            int item) {
  const int len = sizes[item / chunks];
  return len > 0 ? __clz(len) - 1 : 32;
}

// order (items): the work items, by length class, stably. One block of
// 1024 threads: one block-wide scan of the items for each class present.
__global__ void order_kernel(const int* __restrict__ sizes, int chunks,
                             int items, int* __restrict__ order) {
  __shared__ int present[33];
  __shared__ int warp_sums[32];
  __shared__ int base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < 33) present[threadIdx.x] = 0;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += blockDim.x)
    present[length_class(sizes, chunks, i)] = 1;  // benign same value
  __syncthreads();
  for (int c = 0; c < 33; ++c) {
    if (!present[c]) continue;                    // uniform
    for (int i0 = 0; i0 < items; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      const int hit = i < items && length_class(sizes, chunks, i) == c;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_sums[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        before += w < warp ? warp_sums[w] : 0;
        total += warp_sums[w];
      }
      if (hit) order[base + before + __popc(ballot & ((1u << lane) - 1u))] =
          i;
      __syncthreads();
      if (threadIdx.x == 0) base += total;
      __syncthreads();
    }
  }
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

// Adds the first `rows` of one batch's values to a chain: v (kRows x 1)
// of this thread's column, squared first by the sum-of-squares threads (a
// predicated multiply: the warp does not diverge); one rounding for the
// product, one for the add.
__device__ __forceinline__ void add_stage(float& acc, const float (&v)[kRows],
                                          int rows, bool squares) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    float t = v[u];
    if (squares) t = __fmul_rn(t, t);
    if (u < rows) acc = __fadd_rn(acc, t);
  }
}

// One work item per (consumer, producer) warp pair; item p of block i is
// order[kPairs i + p] (or kPairs i + p without an order). Consumers are
// warps 0 .. kPairs - 1, their producers the next kPairs warps.
__global__ void __launch_bounds__(kSumThreads)
    sum_kernel(const float* __restrict__ gathered,
               const int* __restrict__ starts, const int* __restrict__ sizes,
               const int* __restrict__ order, int k, int d, int pad,
               int chunks, int items, float* __restrict__ sums,
               float* __restrict__ sumsq, float* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = warp % kPairs;
  const bool producer = warp >= kPairs;
  float* ring = reinterpret_cast<float*>(smem) +
                (size_t)pair * kRing * kStageFloats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + (size_t)kPairs * kRing * kStageFloats * sizeof(float));
  const uint32_t full0 = smem_addr(bars + pair * 2 * kRing);
  const uint32_t empty0 = full0 + kRing * 8;
  if (threadIdx.x == 0) {
    for (int p = 0; p < kPairs; ++p) {
      for (int u = 0; u < kRing; ++u) {
        mbar_init(smem_addr(bars + p * 2 * kRing + u), 1);  // the producer
        mbar_init(smem_addr(bars + p * 2 * kRing + kRing + u),
                  32);                                      // every reader
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int slot = blockIdx.x * kPairs + pair;
  if (slot >= items) return;
  const int item = order != nullptr ? order[slot] : slot;
  const int chunk = item % chunks;
  const int seg = item / chunks;                 // lane * k + segment
  const int lb = seg / k;
  const int cols = min(kCols, d - chunk * kCols);
  const int rows = sizes[seg];
  const int batches_all = (rows + kRows - 1) / kRows;
  const int stages = (batches_all + kBatches - 1) / kBatches;

  if (producer) {
    // stage t: the item's gathered rows 128 t .. 128 t + 127, contiguous
    // (the last one up to its segment's padding)
    if (lane == 0) {
      const float* src =
          gathered + gathered_at(lb, chunk, pad, d, cols, starts[seg], 0);
      for (int t = 0; t < stages; ++t) {
        const int u = t % kRing;
        const int batches = min(kBatches, batches_all - t * kBatches);
        const uint32_t bytes = batches * kRows * cols * sizeof(float);
        mbar_wait(empty0 + u * 8, ((t / kRing) & 1) ^ 1);
        mbar_expect_tx(full0 + u * 8, bytes);
        bulk_load(smem_addr(ring + u * kStageFloats),
                  src + (size_t)t * kBatches * kRows * cols, bytes,
                  full0 + u * 8);
      }
    }
    return;
  }

  // consumer: lanes 0-15 sum columns 16 chunk + lane, lanes 16-31 sum
  // their squares; a lane past the last column reads a valid address and
  // writes nothing
  const int c = lane & (kCols - 1);
  const bool squares = lane >= kCols;
  const int cr = min(c, cols - 1);
  // batch q: rows 32 q .. 32 q + 31, in stage q / kBatches; a stage is
  // waited for before its first batch and released after its last
  auto load = [&](int q, float(&v)[kRows]) {
    const int t = q / kBatches, u = t % kRing;
    if (q % kBatches == 0) mbar_wait(full0 + u * 8, (t / kRing) & 1);
    const float4* st = reinterpret_cast<const float4*>(ring +
                                                       u * kStageFloats) +
                       (q % kBatches) * (kRows / 4) * cols + cr;
#pragma unroll
    for (int m = 0; m < kRows / 4; ++m) {
      const float4 w = st[m * cols];
      v[4 * m] = w.x;
      v[4 * m + 1] = w.y;
      v[4 * m + 2] = w.z;
      v[4 * m + 3] = w.w;
    }
  };
  auto release = [&](int q) {
    if (q % kBatches == kBatches - 1 || q == batches_all - 1)
      mbar_arrive(empty0 + (q / kBatches % kRing) * 8);
  };
  auto rows_of = [&](int q) { return min(kRows, rows - q * kRows); };
  float acc = 0.f;
  float va[kRows], vb[kRows];
  if (batches_all > 0) {
    load(0, va);
    release(0);
    for (int q = 0;; q += 2) {
      // va holds batch q
      if (q + 1 >= batches_all) {
        add_stage(acc, va, rows_of(q), squares);
        break;
      }
      load(q + 1, vb);
      add_stage(acc, va, kRows, squares);
      release(q + 1);
      // vb holds batch q + 1
      if (q + 2 >= batches_all) {
        add_stage(acc, vb, rows_of(q + 1), squares);
        break;
      }
      load(q + 2, va);
      add_stage(acc, vb, kRows, squares);
      release(q + 2);
    }
  }
  if (c < cols) {
    float* out = squares ? sumsq : sums;
    out[(size_t)seg * d + chunk * kCols + c] = acc;
  }
  if (chunk == 0 && lane == 0) counts[seg] = (float)rows;
}

// Partition geometry of (n, k): rows of a tile, and segments of a range
// (k itself up to kRange; kRange above it, the ranged partition).
bool ranged(int k) { return k > kRange; }
int subtiles_of(int k) {
  return ranged(k) ? (k + kRangedRows - 1) / kRangedRows : 1;
}
int tiles_of(int n, int k) {
  const long long rows = (long long)kTileRows * subtiles_of(k);
  return (int)((n + rows - 1) / rows);
}
int ranges_of(int k) { return (k + kRange - 1) / kRange; }

// rows of one lane's gathered region: every segment padded to 32 (to 4,
// and 32 rows after the last for the sum pass's whole-batch reads, where
// the partition is ranged)
long long pad_of(int n, int k) {
  if (ranged(k)) return ((long long)n + 3LL * k + 3) / 4 * 4 + kRows;
  return ((long long)n + (long long)(kRows - 1) * k + kRows - 1) / kRows *
         kRows;
}

__global__ void add_latency_kernel(float seed, int adds, long long* cycles,
                                   float* out) {
  float acc = seed + threadIdx.x;
  const float v = seed * 1e-7f;
  const long long t0 = clock64();
  for (int i = 0; i < adds; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

}  // namespace

// 4-byte words of workspace that segment_stats_f32 needs for (b, n, k,
// d): the gathered rows (b, pad, d) float32, then the int32 (segment,
// tile) places (b, k, tiles), segment starts and sizes (b, k) each, and
// the sum pass's item order.
extern "C" long long segment_stats_workspace(int b, int n, int k, int d) {
  const long long chunks = (d + kCols - 1) / kCols;
  return (long long)b * pad_of(n, k) * d +
         (long long)b * k * tiles_of(n, k) + 2LL * b * k +
         (long long)b * k * chunks;
}

// x (b, n, d) float32 and labels (b, n) int32, contiguous; outputs
// sums/sumsq (b, k, d) and counts (b, k); work: segment_stats_workspace
// words, 16-byte aligned. passes: bit mask of the passes to launch (1
// count, 2 scan, 4 scatter, 8 sum with its order; 15 = all), so that each
// can be timed on its own. geometry (5 ints, out): partition tiles,
// sum-pass blocks, 1 if the order pass ran, rows of a partition tile,
// segment ranges. Returns the CUDA error of the launches (0 = ok).
extern "C" int segment_stats_f32(const float* x, const int* labels, int b,
                                 int n, int k, int d, float* sums,
                                 float* sumsq, float* counts, int* work,
                                 int passes, int* geometry, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || k <= 0 || d <= 0) return 0;
  const long long pad = pad_of(n, k);
  if (n < 0 || pad * d > (1LL << 31)) return (int)cudaErrorInvalidValue;
  const bool wide = ranged(k);
  const int sub = subtiles_of(k), tiles = tiles_of(n, k);
  const int ranges = ranges_of(k);
  const int chunks = (d + kCols - 1) / kCols;
  const long long items64 = (long long)b * k * chunks;
  if (items64 > (1LL << 30) || (long long)tiles * ranges > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int items = (int)items64;
  const int blocks = (items + kPairs - 1) / kPairs;
  float* gathered = reinterpret_cast<float*>(work);
  int* offsets = work + (size_t)b * pad * d;
  int* starts = offsets + (size_t)b * k * tiles;
  int* sizes = starts + (size_t)b * k;
  int* order = sizes + (size_t)b * k;
  const size_t smem = (size_t)min(k, kRange) * sizeof(int);
  for (int lane0 = 0; tiles > 0 && (passes & 1) && lane0 < b;
       lane0 += kMaxLanes) {
    const dim3 grid(tiles * ranges, min(kMaxLanes, b - lane0));
    if (wide)
      count_ranged_kernel<<<grid, kTileRows, smem, st>>>(
          labels, n, k, tiles, sub, lane0, offsets);
    else
      count_kernel<<<grid, kTileRows, smem, st>>>(labels, n, k, tiles, lane0,
                                                  offsets);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  if (passes & 2) {
    if (wide) {
      sizes_ranged_kernel<<<(unsigned)(((long long)b * k + 255) / 256), 256,
                            0, st>>>(offsets, b, k, tiles, sizes);
      if (cudaError_t e = cudaGetLastError()) return (int)e;
      starts_ranged_kernel<<<b, 1024, 0, st>>>(sizes, k, starts);
    } else {
      scan_kernel<<<b, 256, 0, st>>>(offsets, k, tiles, starts, sizes);
    }
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  for (int lane0 = 0; tiles > 0 && (passes & 4) && lane0 < b;
       lane0 += kMaxLanes) {
    const dim3 grid(tiles * ranges, min(kMaxLanes, b - lane0));
    if (wide)
      scatter_ranged_kernel<<<grid, kTileRows, smem, st>>>(
          x, labels, n, k, d, tiles, sub, (int)pad, lane0, offsets, starts,
          gathered);
    else
      scatter_kernel<<<grid, kTileRows, smem, st>>>(
          x, labels, n, k, d, tiles, (int)pad, lane0, offsets, gathered);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  // the sum pass's blocks that fit on the card at once, found once per
  // device (host calls cost microseconds, a fit launches once a step)
  constexpr int kDevices = 64;
  static int wave[kDevices];
  int device = 0;
  if (cudaError_t e = cudaGetDevice(&device)) return (int)e;
  if (device >= kDevices) return (int)cudaErrorInvalidDevice;
  if (wave[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaError_t e = cudaFuncSetAttribute(
            sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kSumSmem))
      return (int)e;
    if (cudaError_t e = cudaDeviceGetAttribute(
            &sms, cudaDevAttrMultiProcessorCount, device))
      return (int)e;
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sum_kernel, kSumThreads, kSumSmem))
      return (int)e;
    wave[device] = sms * per_sm;
  }
  const bool ordered = blocks > wave[device];
  if (geometry != nullptr) {
    geometry[0] = tiles;
    geometry[1] = blocks;
    geometry[2] = ordered;
    geometry[3] = kTileRows * sub;
    geometry[4] = ranges;
  }
  if (!(passes & 8)) return 0;
  if (ordered) {
    order_kernel<<<1, 1024, 0, st>>>(sizes, chunks, items, order);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  sum_kernel<<<blocks, kSumThreads, kSumSmem, st>>>(
      gathered, starts, sizes, ordered ? order : nullptr, k, d, (int)pad,
      chunks, items, sums, sumsq, counts);
  return (int)cudaGetLastError();
}

// One warp adds `adds` (a multiple of 8) float32 values in one dependent
// chain, as the sum pass does; cycles[0] gets the SM clock cycles the
// chain took (clock64), out[0..32) the sums. The sum pass's order bound
// is its longest chain times cycles / adds over the SM clock.
extern "C" int segment_stats_add_latency(int adds, long long* cycles,
                                         float* out, void* stream) {
  add_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      1.0f, adds, cycles, out);
  return (int)cudaGetLastError();
}
