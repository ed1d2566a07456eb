// Nearest-centroid assignment for a batch of independent k-means lanes.
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
// reads each point once and keeps everything else on chip:
//   * one block per (point tile, lane); the lane's k x d centroids and
//     their squared norms sit in shared memory (20 x 38 x 4 B = 3 KB);
//   * one thread per point holds the point in registers (DMAX is the
//     padded width, a template parameter) and scans the centroids;
//   * distances use the expanded form in float32 (no TF32, no (x - c)^2
//     rewrite), accumulated in the plain version's order (the order the
//     reference's compiled float32 programs use, see core/ordered.py):
//     squared norms as one multiply-add chain up to 32 terms, else in
//     windows of 32; dot products with four interleaved multiply-add
//     accumulators, (a0 + a1) + (a2 + a3), plus a tail of plain products.
//     The kernel therefore agrees with its plain version bitwise, and a
//     fit on the card follows the same path as one on the CPU.
// The TPU's 128-wide padding of d and k is gone: rows, centroids and
// features are read at their real sizes, and no padded centroid exists
// that could win.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWindow = 32;

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

// the same on a point held in registers (compile-time indices only)
template <int DMAX>
__device__ float sum_sq_reg(const float (&v)[DMAX], int d) {
  float acc = 0.f;
  if (DMAX <= kWindow) {
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
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

// x . c over j < d in the plain version's order (core.ordered.dot_nt): a
// multiply-add chain below 4 terms; else four interleaved multiply-add
// accumulators over the largest multiple of 4, (a0 + a1) + (a2 + a3), plus
// the tail's rounded products added in order
template <int DMAX>
__device__ float dot(const float (&x)[DMAX], const float* c, int d) {
  if (d < 4) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 4 && j < DMAX; ++j) {
      if (j < d) acc = fmaf(x[j], c[j], acc);
    }
    return acc;
  }
  const int main = d - d % 4;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int j = 0; j + 3 < DMAX; j += 4) {
    if (j < main) {
      a0 = fmaf(x[j], c[j], a0);
      a1 = fmaf(x[j + 1], c[j + 1], a1);
      a2 = fmaf(x[j + 2], c[j + 2], a2);
      a3 = fmaf(x[j + 3], c[j + 3], a3);
    }
  }
  const float out = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
  if (main == d) return out;
  float tail = 0.f;
  bool first = true;
#pragma unroll
  for (int j = 0; j < DMAX; ++j) {
    if (j >= main && j < d) {
      const float p = __fmul_rn(x[j], c[j]);
      tail = first ? p : __fadd_rn(tail, p);
      first = false;
    }
  }
  return __fadd_rn(out, tail);
}

template <int DMAX>
__global__ void assign_kernel(const float* __restrict__ x,
                              const float* __restrict__ c, int n, int k,
                              int d, int* __restrict__ labels,
                              float* __restrict__ mind2) {
  extern __shared__ float smem[];
  float* cs = smem;           // k * d centroids of this lane
  float* c2 = smem + k * d;   // k squared norms
  const int lane = blockIdx.y;
  const float* cl = c + (size_t)lane * k * d;
  for (int t = threadIdx.x; t < k * d; t += blockDim.x) cs[t] = cl[t];
  __syncthreads();
  for (int kk = threadIdx.x; kk < k; kk += blockDim.x)
    c2[kk] = sum_sq_row(cs + kk * d, d);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* xi = x + ((size_t)lane * n + i) * d;
  float xr[DMAX];
#pragma unroll
  for (int j = 0; j < DMAX; ++j) xr[j] = j < d ? xi[j] : 0.f;
  const float x2 = sum_sq_reg<DMAX>(xr, d);
  float best = INFINITY;
  int arg = 0;
  for (int kk = 0; kk < k; ++kk) {
    const float d2 = __fadd_rn(__fsub_rn(x2, 2.0f * dot<DMAX>(xr, cs + kk * d,
                                                              d)),
                               c2[kk]);
    if (d2 < best) {
      best = d2;
      arg = kk;
    }
  }
  labels[(size_t)lane * n + i] = arg;
  mind2[(size_t)lane * n + i] = fmaxf(best, 0.f);
}

template <int DMAX>
cudaError_t launch(const float* x, const float* c, int b, int n, int k, int d,
                   int* labels, float* mind2, cudaStream_t stream) {
  const size_t smem = (size_t)(k * d + k) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        assign_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((n + kThreads - 1) / kThreads, b);
  assign_kernel<DMAX><<<grid, kThreads, smem, stream>>>(x, c, n, k, d, labels,
                                                         mind2);
  return cudaGetLastError();
}

}  // namespace

// x (b, n, d), c (b, k, d) float32, contiguous; labels (b, n) int32 and
// mind2 (b, n) float32 out. Returns the CUDA error of the launch (0 = ok).
extern "C" int kmeans_assign_f32(const float* x, const float* c, int b, int n,
                                 int k, int d, int* labels, float* mind2,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n <= 0) return 0;
  if (k <= 0 || d <= 0 || b > 65535) return (int)cudaErrorInvalidValue;
  if (d <= 16) return (int)launch<16>(x, c, b, n, k, d, labels, mind2, s);
  if (d <= 32) return (int)launch<32>(x, c, b, n, k, d, labels, mind2, s);
  if (d <= 64) return (int)launch<64>(x, c, b, n, k, d, labels, mind2, s);
  if (d <= 128) return (int)launch<128>(x, c, b, n, k, d, labels, mind2, s);
  return (int)cudaErrorInvalidValue;
}
