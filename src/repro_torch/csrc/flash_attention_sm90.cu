// Flash attention in bf16 for Hopper (sm_90a): TMA + wgmma, causal or
// bidirectional.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_padded` in
// src/repro/kernels/flash_attention/flash_attention.py (wrapper ops.py) for
// bf16 inputs; float32 inputs take the SIMT kernel of flash_attention.cu.
// For every (batch, query head) and query row i it writes
//   o[i] = sum_j softmax_j(q_i . k_j * scale) v_j
// over the visible key columns: j <= i + skv - sq with `causal` (end
// aligned), every column j < skv without it (the reference's causal=False
// branch: the enc-dec model's encoder and cross-attention). GQA: query
// head h reads kv head h / (hq / hkv). Softmax statistics and the
// accumulator are float32; the output is bf16.
//
// What bounds it on an H100: operations. At the LM's prefill shape
// (b = 4, hq = 24, hkv = 8, sq = skv = 4096, d = 128) the visible pairs need
// 4 d FLOP each, 4.1e11 FLOP, 0.42 ms at the 989 TFLOP/s of the bf16 tensor
// cores, against 0.27 GB of q, k, v and o, 0.08 ms at 3.35 TB/s. Design:
//   * one block per (batch, query head, 128-row query tile), heaviest tiles
//     first; the hq / hkv query heads of one kv head are neighbours in the
//     launch order, so their K and V tiles come from L2;
//   * warpgroup 0 is the producer: one thread issues every TMA load, the
//     others leave; `setmaxnreg` hands their registers to the consumers;
//   * warpgroups 1 and 2 are consumers, 64 query rows each;
//   * the Q tile (128 x d) is loaded once; K and V tiles of 128 keys pass
//     through a ring of kStages stages with mbarrier full/empty pairs (K and
//     V have their own full barriers, so S starts before V lands);
//   * TMA reads q, k and v through 4-D tensor maps (d, h, s, b) built on the
//     host from the tensors' strides, so the projections' (b, s, h, d)
//     layout is read in place; rows and columns past the tensor's edge are
//     zero-filled by TMA and nothing is padded in memory;
//   * S = Q K^T is `wgmma` m64n128k16 with both operands in shared memory
//     (K-major, 128- or 64-byte swizzle as TMA wrote them), f32 accumulate;
//     products of bf16 values are exact in f32, so only the order of the
//     sums differs from the plain version;
//   * the online softmax runs on the accumulator fragment in registers
//     (exp2 with log2(e) folded into the scale; quad shuffles for row max);
//   * P . V keeps P at float32 accuracy: P = hi + lo with hi = bf16(P) and
//     lo = bf16(P - hi), residual at most 2^-18 of P, as two `wgmma` chains
//     with A from registers (the S fragment re-packed) and B = V in shared
//     memory, MN-major (d contiguous). l sums the float32 P. This costs 1.5x
//     the MMA work of a single-rounded P, which FA2/3 and SDPA use and which
//     would need a looser tolerance (-DFLASH_SINGLE_P builds that variant
//     for kernels/flash_attention/variants.py only);
//   * causal: key tiles wholly above the diagonal are never loaded; the
//     diagonal and ragged tiles are masked at the finite -1e30. Not causal:
//     every tile is loaded, only the ragged edge col >= skv is masked (so
//     sq > skv is allowed);
//   * the epilogue divides by max(l, 1e-30), rounds to bf16, stages the tile
//     in the consumer's own part of the Q buffer and writes 16-byte chunks.
// d is padded (in shared memory only, by TMA's zero fill) to 32, 64 or 128,
// a template parameter. Wider heads take flash_fwd_sm90_wide (below): one
// block per 128 output columns, S over the whole d in 128-column chunks.
// The kernels take d that is a multiple of 8 (16-byte TMA strides); the
// wrapper copies other widths once into a buffer padded with zeros.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;           // query rows per block
constexpr int kKeys = 128;           // keys per K / V tile
constexpr int kStages = 2;           // K / V ring depth
constexpr int kThreads = 384;        // producer warpgroup + 2 consumers
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Tile {
  static constexpr int kBoxCols = DP < 64 ? DP : 64;  // TMA box width
  static constexpr int kRowBytes = kBoxCols * 2;      // = swizzle span
  static constexpr int kBoxes = DP / kBoxCols;
  static constexpr int kBoxBytes = kKeys * kRowBytes; // 128 rows of a box
  static constexpr int kBytes = kBoxes * kBoxBytes;   // a Q, K or V tile
  static constexpr int kAtom = 8 * kRowBytes;         // 8 swizzled rows
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks a row
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 1024 + 256;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
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
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --------------------------------------------------------------------- TMA
// One box of a 4-D tensor map (d, h, s, b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving a register that an asynchronous wgmma
// reads or writes across the wait that completes it.
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// wgmma_ss: S (64 x 128 keys) = Q K^T, A and B from shared-memory
// descriptors, both K-major (trans-a = trans-b = 0); `accumulate` = 0
// overwrites d. wgmma_rs: O (64 x DP) += P V with A = P from registers
// (4 x bf16x2 a thread) and B = V MN-major (trans-b = 1), accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------- consumer steps
// One S tile of a consumer (64 rows x 128 keys, the wgmma fragment: row
// row_a and row_a + 8, columns 8 (i / 4) + 2 quad + i % 2): scaled to the
// log2 domain, the diagonal and ragged tiles masked, then the online
// softmax: sc becomes P (float32), acc (the O fragment) is rescaled, the
// running maxima and this thread's partial sums move on.
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[64], float (&acc)[N], float& m_a, float& m_b, float& l_a,
    float& l_b, int kv0, int first_row, int row_a, int quad, int offset,
    int skv, int causal, float scale_log2) {
  const bool masked =
      (causal && kv0 + kKeys - 1 > first_row + offset) || kv0 + kKeys > skv;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = sc[i] * scale_log2;
    if (masked) {
      const int col = kv0 + 8 * (i / 4) + 2 * quad + (i % 2);
      const int row = row_a + 8 * ((i % 4) / 2);
      if ((causal && col > row + offset) || col >= skv) x = kNegInf;
    }
    sc[i] = x;
  }
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if ((i % 4) < 2) mx_a = fmaxf(mx_a, sc[i]);
    else mx_b = fmaxf(mx_b, sc[i]);
  }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float alpha_a = exp2f(m_a - mx_a);
  const float alpha_b = exp2f(m_b - mx_b);
  m_a = mx_a;
  m_b = mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const bool top = (i % 4) < 2;
    const float p = exp2f(sc[i] - (top ? mx_a : mx_b));
    sc[i] = p;
    if (top) sum_a += p;
    else sum_b += p;
  }
  l_a = l_a * alpha_a + sum_a;
  l_b = l_b * alpha_b + sum_b;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= (i % 4) < 2 ? alpha_a : alpha_b;
}

// P as the A fragment of k-step kk (keys 16 kk ..): registers 4 kk + r
// hold the pair (sc[8 kk + 2 r], sc[8 kk + 2 r + 1]), as bf16 hi and, but
// with FLASH_SINGLE_P, lo = bf16(P - hi).
__device__ __forceinline__ void split_p(const float (&sc)[64],
                                        uint32_t (&hi)[32],
                                        uint32_t (&lo)[32]) {
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const float p0 = sc[2 * r], p1 = sc[2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
#ifndef FLASH_SINGLE_P
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 w = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
    lo[r] = *reinterpret_cast<const uint32_t*>(&w);
#endif
  }
}

// O += hi . V (+ lo . V) over the V tile at v_tile (Tile<DP>'s layout:
// rows are keys, d contiguous, so B is MN-major), then waits for it.
template <int DP>
__device__ __forceinline__ void pv_tile(float (&acc)[DP / 2],
                                        uint32_t (&hi)[32],
                                        uint32_t (&lo)[32], uint32_t v_tile) {
  using T = Tile<DP>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    wgmma_rs(acc, hi + 4 * kk,
             gmma_desc(v_tile + kk * 16 * T::kRowBytes, T::kBoxBytes,
                       T::kAtom, T::kLayout));
  }
#ifndef FLASH_SINGLE_P
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    wgmma_rs(acc, lo + 4 * kk,
             gmma_desc(v_tile + kk * 16 * T::kRowBytes, T::kBoxBytes,
                       T::kAtom, T::kLayout));
  }
#endif
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) fence_reg(acc[i]);
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    fence_reg(hi[r]);
#ifndef FLASH_SINGLE_P
    fence_reg(lo[r]);
#endif
  }
}

// ------------------------------------------------------------------ kernel
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, long long o_sb, long long o_sh,
               long long o_ss, int batches, int hq, int hkv, int sq, int skv,
               int d, int causal, float scale_log2) {
  using T = Tile<DP>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the swizzle atoms
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t s_q = base;
  const uint32_t s_k = base + T::kBytes;                  // kStages tiles
  const uint32_t s_v = s_k + kStages * T::kBytes;         // kStages tiles
  const uint32_t bars = s_v + kStages * T::kBytes;
  const uint32_t q_full = bars;
  // k_full[s], v_full[s], empty[s]
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  // block -> (query tile, batch, kv head, query head in its group); the
  // group's query heads are adjacent, the heaviest tiles come first
  const int group = hq / hkv;
  const int n_qtiles = (sq + kRows - 1) / kRows;
  int idx = blockIdx.x;
  const int g = idx % group;
  idx /= group;
  const int kv_head = idx % hkv;
  idx /= hkv;
  const int batch = idx % batches;
  const int q_tile = n_qtiles - 1 - idx / batches;
  const int head = kv_head * group + g;
  const int q0 = q_tile * kRows;
  const int offset = skv - sq;  // end alignment
  const int last_row = min(q0 + kRows, sq) - 1;
  const int kv_end = causal ? min(skv, last_row + offset + 1) : skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kBytes);
      for (int bx = 0; bx < T::kBoxes; ++bx) {
        tma_load(s_q + bx * T::kBoxBytes, &tq, q_full, bx * T::kBoxCols,
                 head, q0, batch);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full(s), T::kBytes);
        for (int bx = 0; bx < T::kBoxes; ++bx) {
          tma_load(s_k + s * T::kBytes + bx * T::kBoxBytes, &tk, k_full(s),
                   bx * T::kBoxCols, kv_head, t * kKeys, batch);
        }
        mbar_expect_tx(v_full(s), T::kBytes);
        for (int bx = 0; bx < T::kBoxes; ++bx) {
          tma_load(s_v + s * T::kBytes + bx * T::kBoxBytes, &tv, v_full(s),
                   bx * T::kBoxCols, kv_head, t * kKeys, batch);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;                 // consumer 0 or 1: 64 rows each
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int row_a = q0 + 64 * c + 16 * warp + lane / 4;  // and row_a + 8
    const int first_row = q0 + 64 * c;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;   // running max (log2 domain)
    float l_a = 0.f, l_b = 0.f;           // this thread's partial sums

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const uint32_t k_tile = s_k + s * T::kBytes;
      const uint32_t v_tile = s_v + s * T::kBytes;

      // S = Q K^T over d in steps of 16 (32 bytes along a swizzled row)
      float sc[64];
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t bx = (kk * 16) / T::kBoxCols;
        const uint32_t in_row = ((kk * 16) % T::kBoxCols) * 2;
        const uint64_t da = gmma_desc(
            s_q + bx * T::kBoxBytes + 64 * c * T::kRowBytes + in_row, 16,
            T::kAtom, T::kLayout);
        const uint64_t db = gmma_desc(k_tile + bx * T::kBoxBytes + in_row,
                                      16, T::kAtom, T::kLayout);
        wgmma_ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_reg(sc[i]);

      softmax_tile(sc, acc, m_a, m_b, l_a, l_b, t * kKeys, first_row,
                   row_a, quad, offset, skv, causal, scale_log2);
      uint32_t hi[32], lo[32];
      split_p(sc, hi, lo);
      mbar_wait(v_full(s), parity);
      pv_tile<DP>(acc, hi, lo, v_tile);
      mbar_arrive(empty(s));
    }

    // ------------------------------------------------------------ epilogue
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
    // this consumer's 64 rows of the Q buffer (no longer read) take the
    // bf16 tile; 16-byte chunk k of row r sits at chunk k ^ (r % kChunks)
    asm volatile("bar.sync %0, 128;\n" ::"r"(c + 1) : "memory");
    auto chunk_ptr = [&](int r, int col) {
      const int bx = col / T::kBoxCols;
      const int ch = (col % T::kBoxCols) / 8;
      return smem + bx * T::kBoxBytes + (64 * c + r) * T::kRowBytes +
             ((ch ^ (r % T::kChunks)) * 16);
    };
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int r = 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
      const int col = 8 * (i / 4) + 2 * quad;
      const float inv = (i % 4) < 2 ? inv_a : inv_b;
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(chunk_ptr(r, col) + (col % 8) * 2) =
          pair;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(c + 1) : "memory");
    constexpr int kRowChunks = DP / 8;
    const int d_chunks = d / 8;
    for (int id = tid; id < 64 * kRowChunks; id += 128) {
      const int r = id / kRowChunks, ch = id % kRowChunks;
      const int row = first_row + r;
      if (row < sq && ch < d_chunks) {
        const uint4 val = *reinterpret_cast<const uint4*>(chunk_ptr(r, ch * 8));
        *reinterpret_cast<uint4*>(o + batch * o_sb + head * o_sh +
                                  row * o_ss + ch * 8) = val;
      }
    }
  }
}


// --------------------------------------------------------- wide kernel
// d > 128: a consumer's O fragment holds 128 columns (64 floats a
// thread, as at d = 128), so each block takes one 128-column slice of
// the output (column block cb) and computes S over the whole d: per key
// tile, ceil(d / 128) steps each bring a 128-column chunk of Q and of K
// (two 64-column boxes each; a box wholly past d is not loaded, and its
// k-steps are skipped) into one slot of a kSlots ring, accumulating one
// S fragment; then V's slice of the tile comes through the next slot.
// Every column block computes the same S in the same order, so all see
// the same P. S costs ceil(d / 128) times the MMA work of the unsplit
// product; Q is read again for every key tile (from L2).
constexpr int kSlots = 3;
using Wide = Tile<128>;
constexpr int kSlotBytes = 2 * Wide::kBytes;  // a Q chunk and a K chunk
constexpr int kWideSmem = kSlots * kSlotBytes + 1024 + 256;

// S += Q K^T over the first STEPS k-steps (16 columns each) of a
// 128-column chunk: Q's 64 rows of this consumer at q_part, K at k_part,
// both two 64-column boxes as TMA wrote them.
template <int STEPS>
__device__ __forceinline__ void s_steps(float (&sc)[64], uint32_t q_part,
                                        uint32_t k_part) {
  using T = Wide;
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint32_t at = (kk / 4) * T::kBoxBytes + (kk % 4) * 32;
    wgmma_ss(sc, gmma_desc(q_part + at, 16, T::kAtom, T::kLayout),
             gmma_desc(k_part + at, 16, T::kAtom, T::kLayout), 1);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_wide(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, long long o_sb,
                    long long o_sh, long long o_ss, int batches, int hq,
                    int hkv, int sq, int skv, int d, int causal,
                    float scale_log2) {
  using T = Wide;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + kSlots * kSlotBytes;
  auto slot = [&](int u) { return base + (uint32_t)(u * kSlotBytes); };
  auto full = [&](int u) { return bars + 8u * u; };
  auto empty = [&](int u) { return bars + 8u * (kSlots + u); };

  // block -> (query tile, batch, kv head, query head, column block); the
  // column blocks of a head, then its group's heads, are neighbours
  const int chunks = (d + 127) / 128;
  const int group = hq / hkv;
  const int n_qtiles = (sq + kRows - 1) / kRows;
  int idx = blockIdx.x;
  const int cb = idx % chunks;
  idx /= chunks;
  const int g = idx % group;
  idx /= group;
  const int kv_head = idx % hkv;
  idx /= hkv;
  const int batch = idx % batches;
  const int q_tile = n_qtiles - 1 - idx / batches;
  const int head = kv_head * group + g;
  const int q0 = q_tile * kRows;
  const int offset = skv - sq;
  const int last_row = min(q0 + kRows, sq) - 1;
  const int kv_end = causal ? min(skv, last_row + offset + 1) : skv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;
  // 64-column boxes of column chunk c that hold columns below d
  auto boxes = [&](int c) { return min(2, (d - 128 * c + 63) / 64); };

  if (threadIdx.x == 0) {
    for (int u = 0; u < kSlots; ++u) {
      mbar_init(full(u), 1);
      mbar_init(empty(u), 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int use = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int c = 0; c <= chunks; ++c, ++use) {
          const int u = use % kSlots;
          mbar_wait(empty(u), ((use / kSlots) & 1) ^ 1);
          if (c < chunks) {              // Q and K, columns 128 c ..
            const int nb = boxes(c);
            mbar_expect_tx(full(u), 2 * nb * T::kBoxBytes);
            for (int bx = 0; bx < nb; ++bx) {
              tma_load(slot(u) + bx * T::kBoxBytes, &tq, full(u),
                       128 * c + bx * 64, head, q0, batch);
              tma_load(slot(u) + T::kBytes + bx * T::kBoxBytes, &tk,
                       full(u), 128 * c + bx * 64, kv_head, t * kKeys,
                       batch);
            }
          } else {                       // V, columns 128 cb ..
            const int nb = boxes(cb);
            mbar_expect_tx(full(u), nb * T::kBoxBytes);
            for (int bx = 0; bx < nb; ++bx) {
              tma_load(slot(u) + bx * T::kBoxBytes, &tv, full(u),
                       128 * cb + bx * 64, kv_head, t * kKeys, batch);
            }
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;                 // consumer 0 or 1: 64 rows each
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int row_a = q0 + 64 * c + 16 * warp + lane / 4;  // and row_a + 8
    const int first_row = q0 + 64 * c;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf;
    float l_a = 0.f, l_b = 0.f;

    int use = 0;
    for (int t = 0; t < n_tiles; ++t) {
      // S = Q K^T, chunk by chunk, k-steps of 16 columns below d
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      for (int ch = 0; ch < chunks; ++ch, ++use) {
        const int u = use % kSlots;
        const uint32_t q_part = slot(u) + 64 * c * T::kRowBytes;
        const uint32_t k_part = slot(u) + T::kBytes;
        mbar_wait(full(u), (use / kSlots) & 1);
        wgmma_fence();
        switch (min(8, (d - 128 * ch + 15) / 16)) {
          case 8: s_steps<8>(sc, q_part, k_part); break;
          case 7: s_steps<7>(sc, q_part, k_part); break;
          case 6: s_steps<6>(sc, q_part, k_part); break;
          case 5: s_steps<5>(sc, q_part, k_part); break;
          case 4: s_steps<4>(sc, q_part, k_part); break;
          case 3: s_steps<3>(sc, q_part, k_part); break;
          case 2: s_steps<2>(sc, q_part, k_part); break;
          default: s_steps<1>(sc, q_part, k_part); break;
        }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_reg(sc[i]);
        mbar_arrive(empty(u));
      }

      softmax_tile(sc, acc, m_a, m_b, l_a, l_b, t * kKeys, first_row,
                   row_a, quad, offset, skv, causal, scale_log2);
      uint32_t hi[32], lo[32];
      split_p(sc, hi, lo);
      const int u = use % kSlots;
      mbar_wait(full(u), (use / kSlots) & 1);
      pv_tile<128>(acc, hi, lo, slot(u));
      mbar_arrive(empty(u));
      ++use;
    }

    // epilogue: bf16 pairs straight from the fragment to o (columns past
    // d are never written; a V box wholly past d left them undefined)
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = row_a + 8 * ((i % 4) / 2);
      const int col = 128 * cb + 8 * (i / 4) + 2 * quad;
      if (row < sq && col < d) {
        const float inv = (i % 4) < 2 ? inv_a : inv_b;
        *reinterpret_cast<__nv_bfloat162*>(o + batch * o_sb + head * o_sh +
                                           row * o_ss + col) =
            __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
      }
    }
  }
}

// -------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda the process has
// already loaded (no link-time dependency on the driver).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

// A 4-D map (d, h, s, b) from the wrapper's words: dims[4], byte strides of
// h, s and b, box[4]. Returns false on a map the kernel cannot read: a box
// other than (kBoxCols, 1, kKeys, 1), strides not multiples of 16 bytes, or
// dims that disagree with the call.
template <int DP>
bool make_map(CUtensorMap* map, const void* ptr, const long long* w, int d,
              int h, int s, int b) {
  using T = Tile<DP>;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  if (w[0] != d || w[1] != h || w[2] != s || w[3] != b) return false;
  for (int i = 4; i < 7; ++i) {
    if (w[i] <= 0 || w[i] % 16 != 0 || w[i] >= (1ll << 40)) return false;
  }
  if (w[7] != T::kBoxCols || w[8] != 1 || w[9] != kKeys || w[10] != 1) {
    return false;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)w[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)w[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)w[7 + i];
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS;
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o,
              const long long* qm, const long long* km, const long long* vm,
              const long long* os, int b, int hq, int hkv, int sq, int skv,
              int d, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<DP>(&tq, q, qm, d, hq, sq, b) ||
      !make_map<DP>(&tk, k, km, d, hkv, skv, b) ||
      !make_map<DP>(&tv, v, vm, d, hkv, skv, b)) {
    return (int)cudaErrorInvalidValue;
  }
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<DP>::kSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const long long blocks = (long long)((sq + kRows - 1) / kRows) * b * hq;
  flash_fwd_sm90<DP><<<(unsigned)blocks, kThreads, Tile<DP>::kSmem,
                       stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os[0], os[1], os[2], b, hq,
      hkv, sq, skv, d, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

// d > 128: flash_fwd_sm90_wide, ceil(d / 128) column blocks a query tile.
int launch_wide(const void* q, const void* k, const void* v, void* o,
                const long long* qm, const long long* km, const long long* vm,
                const long long* os, int b, int hq, int hkv, int sq, int skv,
                int d, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<128>(&tq, q, qm, d, hq, sq, b) ||
      !make_map<128>(&tk, k, km, d, hkv, skv, b) ||
      !make_map<128>(&tv, v, vm, d, hkv, skv, b)) {
    return (int)cudaErrorInvalidValue;
  }
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWideSmem);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const long long blocks =
      (long long)((sq + kRows - 1) / kRows) * b * hq * ((d + 127) / 128);
  flash_fwd_sm90_wide<<<(unsigned)blocks, kThreads, kWideSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os[0], os[1], os[2], b, hq,
      hkv, sq, skv, d, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, sq, d), k and v (b, hkv, skv, d), o (b, hq, sq, d), all bf16
// with d contiguous, read and written through their strides. qm, km, vm:
// the tensor-map words of ops.tensor_map_args (dims (d, h, s, b), byte
// strides of h, s, b, box); os: o's strides of b, h, s in elements (each a
// multiple of 8, o 16-byte aligned); causal: 1 for the end-aligned causal
// mask (sq <= skv), 0 for none. d: a multiple of 8 (the wrapper pads
// other widths): d <= 32, 64 and 128 take flash_fwd_sm90<32, 64, 128>,
// wider heads flash_fwd_sm90_wide. Returns a cudaError_t as int.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const long long* qm, const long long* km,
                                    const long long* vm, const long long* os,
                                    int b, int hq, int hkv, int sq, int skv,
                                    int d, int causal, float scale,
                                    void* stream) {
  if (b < 0 || hq < 1 || hkv < 1 || hq % hkv || d < 8 || d % 8 ||
      sq < 1 || skv < 1 || (causal && sq > skv) ||
      (long long)((sq + kRows - 1) / kRows) * b * hq * ((d + 127) / 128) >
          0x7fffffffll ||
      reinterpret_cast<uintptr_t>(o) % 16 != 0 || os[0] % 8 || os[1] % 8 ||
      os[2] % 8) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0;
  if (d <= 32) return launch_dp<32>(q, k, v, o, qm, km, vm, os, b, hq, hkv,
                                    sq, skv, d, c, scale, s);
  if (d <= 64) return launch_dp<64>(q, k, v, o, qm, km, vm, os, b, hq, hkv,
                                    sq, skv, d, c, scale, s);
  if (d <= 128) return launch_dp<128>(q, k, v, o, qm, km, vm, os, b, hq,
                                      hkv, sq, skv, d, c, scale, s);
  return launch_wide(q, k, v, o, qm, km, vm, os, b, hq, hkv, sq, skv, d, c,
                     scale, s);
}
