// Flash attention (online softmax) in float32, forward only, causal or
// bidirectional.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_padded` in
// src/repro/kernels/flash_attention/flash_attention.py (wrapper ops.py) for
// float32 inputs; bf16 inputs take the tensor-core kernel of
// flash_attention_sm90.cu. For
// every (batch, query head) and query row i it writes
//   o[i] = sum_j softmax_j(q_i . k_j * scale) v_j
// over the visible key columns: j <= i + skv - sq with `causal` (end-aligned,
// so the same kernel serves sq == skv prefill and short appends to a cache),
// every column j < skv without it (the reference's causal=False branch). GQA:
// query head h reads kv head h / (hq / hkv); K and V are never repeated.
// Every product, sum, max and exp is float32. q, k, v and o are read and
// written through their batch, head and row strides (d contiguous).
//
// What bounds it on an H100: operations. At the main path's prefill shape
// (b = 4, hq = 24, hkv = 8, sq = skv = 4096, d = 128) the visible pairs need
// 4 * b * hq * d * sq (sq + 1) / 2 = 4.1e11 FLOP, 6.1 ms at the 67 TFLOP/s
// of float32 FMAs, against 0.54 GB of q, k, v and o, 0.16 ms at 3.35 TB/s.
// It stays off the tensor cores on purpose (TF32 would change the float32
// numbers). What it does:
//   * one block per (b * hq, 64-row query tile); tiles are issued heaviest
//     first (the last query tile sees the most columns);
//   * 64-row K and V tiles staged in shared memory as float32 (64 KB at
//     d = 128, above the 48 KB default, so the launch raises the limit);
//   * four threads per query row: each holds a quarter of q and of the
//     float32 accumulator in registers (d / 4 values each). A score is four
//     partial dots joined by two shuffles; the thread (j mod 4) of the row
//     keeps score j, and the row's max and sum come from two more shuffles;
//   * at most 128 registers a thread, so that two blocks share an SM;
//   * a thread's columns are the float4 chunks t, t + 4, t + 8, ... of a row,
//     so the four threads of a row read 64 contiguous bytes of shared memory
//     at a time (no bank conflicts) while the row groups of a warp broadcast;
//   * causal: key tiles wholly above the diagonal are never loaded or
//     computed (half the work at sq == skv); not causal: every tile is, and
//     sq > skv is allowed. The ragged edge of the last tile reads zeros and
//     is masked, so nothing is padded in memory;
//   * masked scores are the finite -1e30 of the reference, never -inf, so
//     the running max never computes -inf - (-inf).
// d is padded (in registers and shared memory only) to 32, 64 or 128, a
// template parameter; the wrapper accepts d <= 128 that is a multiple of 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                  // query rows per block
constexpr int kKeys = 64;                  // key rows per tile
constexpr int kPerRow = 4;                 // threads per query row
constexpr int kThreads = kRows * kPerRow;  // 256
constexpr float kNegInf = -1e30f;          // the reference's NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinBlocks = 2;              // blocks that share an SM

// batch, head and row strides of a (b, h, s, d) tensor, in elements
struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Stage rows [row0, row0 + kKeys) of a (rows, d) matrix with row stride
// `ld` into shared memory (kKeys, DP); rows past `rows` and columns past d
// are zeros.
template <int DP>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long ld, int row0, int rows,
                                           int d) {
  constexpr int kChunks = kKeys * DP / 4;  // float4 chunks in the tile
#pragma unroll
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / (DP / 4);
    const int col = (c % (DP / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows && col < d) {
      v = load4(src + (row0 + r) * ld + col);
    }
    *reinterpret_cast<float4*>(dst + r * DP + col) = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, Strides qs,
          Strides ks, Strides vs, Strides os, int hq, int hkv, int sq,
          int skv, int d, int causal, float scale) {
  constexpr int kChunks = DP / 16;  // float4 chunks of a row per thread
  extern __shared__ float4 smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kKeys * DP;

  const int bh = blockIdx.x;
  const int batch = bh / hq;
  const int head = bh % hq;
  const int kv_head = head / (hq / hkv);
  const int q_tile = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int q0 = q_tile * kRows;
  const int row = threadIdx.x / kPerRow;  // 0..63
  const int part = threadIdx.x % kPerRow;
  const int qrow = q0 + row;              // row in [0, sq) when valid
  const int offset = skv - sq;            // end alignment

  const float* qb = q + batch * qs.b + head * qs.h;
  const float* kb = k + batch * ks.b + kv_head * ks.h;
  const float* vb = v + batch * vs.b + kv_head * vs.h;

  // this thread's quarter of its query row: chunks part, part + 4, ...
  float4 qr[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int col = (part + 4 * i) * 4;
    qr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qrow < sq && col < d) qr[i] = load4(qb + qrow * qs.s + col);
  }
  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.f;

  // key columns any valid row of this tile can see
  const int last_row = min(q0 + kRows, sq) - 1;
  const int kv_end = causal ? min(skv, last_row + offset + 1) : skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kKeys;
    __syncthreads();  // the previous tile's readers are done
    stage_tile<DP>(sk, kb, ks.s, kv0, skv, d);
    stage_tile<DP>(sv, vb, vs.s, kv0, skv, d);
    __syncthreads();

    // scores: thread `part` keeps s[jj] for key column kv0 + 4 jj + part
    float s[kKeys / kPerRow];
#pragma unroll
    for (int jj = 0; jj < kKeys / kPerRow; ++jj) s[jj] = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(sk + j * DP);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = kr[part + 4 * i];
        dot = fmaf(qr[i].x, kk.x, dot);
        dot = fmaf(qr[i].y, kk.y, dot);
        dot = fmaf(qr[i].z, kk.z, dot);
        dot = fmaf(qr[i].w, kk.w, dot);
      }
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      const int col = kv0 + j;
      const bool visible = col < skv && (!causal || col <= qrow + offset);
      if ((j % kPerRow) == part) s[j / kPerRow] = visible ? dot * scale
                                                          : kNegInf;
    }

    // online softmax over the tile (the row's four threads agree exactly)
    float mt = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kKeys / kPerRow; ++jj) mt = fmaxf(mt, s[jj]);
    mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < kKeys / kPerRow; ++jj) {
      s[jj] = expf(s[jj] - m_new);
      ls += s[jj];
    }
    ls += __shfl_xor_sync(kFull, ls, 1);
    ls += __shfl_xor_sync(kFull, ls, 2);
    l = l * alpha + ls;
    m = m_new;

#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = __shfl_sync(kFull, s[j / kPerRow], j % kPerRow,
                                  kPerRow);
      const float4* vr = reinterpret_cast<const float4*>(sv + j * DP);
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = vr[part + 4 * i];
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
  }

  if (qrow >= sq) return;
  const float denom = fmaxf(l, 1e-30f);
  float* ob = o + batch * os.b + head * os.h + qrow * os.s;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int col = (part + 4 * i) * 4;
    if (col < d) {
      store4(ob + col, make_float4(acc[i].x / denom, acc[i].y / denom,
                                   acc[i].z / denom, acc[i].w / denom));
    }
  }
}

template <int DP>
int launch_dp(const float* q, const float* k, const float* v, float* o,
              const Strides& qs, const Strides& ks, const Strides& vs,
              const Strides& os, int b, int hq, int hkv, int sq, int skv,
              int d, int causal, float scale, cudaStream_t stream) {
  const size_t smem = 2u * kKeys * DP * sizeof(float);
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid(b * hq, (sq + kRows - 1) / kRows);
  flash_fwd<DP><<<grid, kThreads, smem, stream>>>(q, k, v, o, qs, ks, vs, os,
                                                  hq, hkv, sq, skv, d, causal,
                                                  scale);
  return (int)cudaGetLastError();
}

Strides strides(const long long* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

// q: (b, hq, sq, d); k, v: (b, hkv, skv, d); o: (b, hq, sq, d); float32,
// d contiguous, each read and written through its batch, head and row
// strides in elements (qs, ks, vs, os: three each, multiples of 4 so that
// rows stay 16-byte aligned), bases 16-byte aligned; causal: 1 for the
// end-aligned causal mask (sq <= skv), 0 for none. Returns a cudaError_t as
// int.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* qs, const long long* ks,
                                   const long long* vs, const long long* os,
                                   int b, int hq, int hkv, int sq, int skv,
                                   int d, int causal, float scale,
                                   void* stream) {
  if (b < 0 || hq < 1 || hkv < 1 || hq % hkv || d < 8 || d > 128 || d % 8 ||
      sq < 1 || skv < 1 || (causal && sq > skv) ||
      (sq + kRows - 1) / kRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  for (const void* p : {q, k, v, static_cast<const void*>(o)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  for (const long long* st : {qs, ks, vs, os}) {
    for (int i = 0; i < 3; ++i) {
      if (st[i] % 4 != 0) return (int)cudaErrorInvalidValue;
    }
  }
  if (b == 0) return 0;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides a = strides(qs), bk = strides(ks), c = strides(vs),
                e = strides(os);
  const int cz = causal != 0;
  if (d <= 32) return launch_dp<32>(qt, kt, vt, ot, a, bk, c, e, b, hq, hkv,
                                    sq, skv, d, cz, scale, s);
  if (d <= 64) return launch_dp<64>(qt, kt, vt, ot, a, bk, c, e, b, hq, hkv,
                                    sq, skv, d, cz, scale, s);
  return launch_dp<128>(qt, kt, vt, ot, a, bk, c, e, b, hq, hkv, sq, skv, d,
                        cz, scale, s);
}
