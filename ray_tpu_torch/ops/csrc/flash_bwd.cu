// Flash-attention backward for Hopper (sm_90a), plain CUDA C++: two entries.
//
//   flash_bwd_dq  replaces ray_tpu/ops/attention.py:_bwd_dq_kernel
//                 (launched by _flash_pallas_bwd_kernels, pallas_call at :347);
//   flash_bwd_dkv replaces ray_tpu/ops/attention.py:_bwd_dkv_kernel
//                 (same function, pallas_call at :370).
//
// Both recompute the attention probabilities from the forward's logsumexp,
// P = exp(scale * Q K^T - lse) under the same causal mask, and with
// dP = dO V^T and dS = P o (dP - delta), delta = rowsum(dO o O) (computed by
// the caller in f32, as the JAX package leaves it to XLA):
//   dq = scale * dS K           (one CTA per (B*H row, 64-row q-tile))
//   dv = P^T dO, dk = scale * dS^T Q   (one CTA per (B*H row, 64-row k-tile))
// On the TPU, dq and dk/dv are carried in VMEM scratch across a sequential
// grid axis. Here blocks run in no order, so each CTA owns its output tile and
// loops over the other axis itself, with the sums in f32 registers: no atomics
// and no second pass, so two launches give the same bits. Each CTA loads its
// own tile (q and dO, or k and v) once.
//
// Masking, as flash_fwd.cu: the causal mask is bottom-right aligned (query
// row i sees key column j when j <= i + (Sk - Sq)); tiles wholly above the
// diagonal are skipped (the dq kernel stops its k loop at the last column its
// rows can see, the dkv kernel starts its q loop at the first q-tile that can
// see its columns); ragged tails are zero-filled and never stored. A row with
// no live column has lse = +inf, which gives P = 0 and no NaN. Query rows past
// Sq in the last tile get P = 0 and dO = 0, so they add nothing to dk and dv.
//
// What bounds it on an H100: at the training shape (B*H 192, S 1024, D 64,
// causal, bf16) the dq kernel moves ~127 MB against ~39 GFLOP and the dkv
// kernel ~153 MB against ~52 GFLOP; at 3.35 TB/s and 989 TFLOP/s both are
// bound by operations at the bf16 tensor-core peak (0.039 and 0.052 ms).
//
// Two designs, chosen by the element type in launch_one:
//   - f16 and bf16: the tensor-core kernels (flash_bwd_*_mma_kernel). Four
//     warps per CTA, each owning 16 rows of the 64-row output tile (the M of
//     mma.sync m16n8k16, f32 accumulate). Tiles sit in shared memory in the
//     input type, rows padded by 8 elements so ldmatrix is free of bank
//     conflicts; the streamed tiles (K and V for dq; Q, dO, lse and delta for
//     dk/dv) are double-buffered with 16-byte cp.async, the next one loading
//     while the current one computes. Every product runs on the tensor cores
//     from ldmatrix fragments (.trans where the reduction runs along the
//     tile's rows: K in dS K, dO in P^T dO, Q in dS^T Q). P and dS never
//     leave registers: the f32 accumulator fragment of S goes through exp2
//     and the mask and becomes, rounded to T, the A fragment of the next
//     product (the dk/dv kernel computes S^T = K Q^T and dP^T = V dO^T with
//     the k rows as M, so P^T and dS^T are A fragments too). P and dS must
//     be in T for those products, and one rounding costs too much: its error
//     is absolute on the scale of the summed terms, so an element whose terms
//     cancel misses the bf16 limit (atol 1e-3, rtol 1.6e-2) on causal inputs
//     (tests/test_torch_attention_grad.py emulates it), and f16 (atol 1e-3,
//     rtol 2e-3) came close to its own on the card. So P and dS go in as two
//     fragments, hi = T(x) and lo = T(x - hi), and each of their products
//     runs twice into the same f32 sum: about twice T's significant bits for
//     1/3 (dq) or 1/2 (dk/dv) more tensor-core work. Masks run only on tiles
//     that cross the diagonal or a ragged edge. S is computed 32 columns at
//     a time (64 at D 16 and 32; 16 for dk/dv at D 128), which measured
//     faster at D 64 than 64 columns. The fragments of the CTA's own tile
//     are loaded once into registers up to D 64 (but for bf16 dk/dv at D 64,
//     see dkv_min_ctas); at D 128 they are read from shared memory at each
//     use, which keeps the f32 accumulators in registers.
//   - f32: the CUDA-core kernels of the first port (flash_bwd_*_kernel),
//     plain f32 FMAs from tiles staged as f32 in shared memory. TF32 mma
//     would not meet f32's 1e-4 limit.
// The tensor-core kernels use mma.sync, not Hopper's wgmma with TMA and warp
// specialisation: mma.sync is what FlashAttention-2 (the design behind
// torch's SDPA backward) uses, so it can reach that yardstick with a simple
// kernel; wgmma, TMA and a producer warp are what can take it past, later.
//
// Layout: q, dO, dq (B*H, Sq, D); k, v, dk, dv (B*H, Sk, D), all contiguous in
// one dtype (f32, f16 or bf16), 16-byte aligned for f16 and bf16; lse and
// delta (B*H, Sq) f32. Head dims 16, 32, 64, 128. Each C entry returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int TPR = 4;          // threads per owned row (consecutive lanes)
constexpr int NT = 64 * TPR;    // 256 threads per CTA: one row of 64 per 4 lanes
constexpr int NJ = 64 / TPR;    // score columns each thread computes per tile
constexpr int PAD = 4;          // row stride 68 of score tiles: the 8 rows x 4
                                // lanes of a warp hit 32 different banks
// Launch bounds (NT threads, at least 1 CTA per SM): with the thread count
// alone ptxas held the D = 32 kernels to 32-48 registers and spilled; with
// this it takes 79-128 registers at every D and spills nothing. Shared memory
// already limits both kernels to 2 CTAs per SM at D = 64, which 95 registers
// still allow.
#define BWD_LAUNCH_BOUNDS __launch_bounds__(NT, 1)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Stage rows [g0, g0 + 64) of a (rows, D) matrix into shared memory as f32
// with row stride D + 1 (a warp's 8 rows fall in different banks), times
// `scale`; rows past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int g0, int rows, float scale) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int row = i / D, col = i % D;
    const int g = g0 + row;
    dst[row * (D + 1) + col] =
        g < rows ? to_f32(src[(size_t)g * D + col]) * scale : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// ---------------------------------------------------------------- dq

template <int D>
constexpr int dq_smem_floats() {
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + PAD);
}

template <typename T, int D>
__global__ void BWD_LAUNCH_BOUNDS
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int causal, float sm_scale) {
  constexpr int ND = D / TPR;   // dq columns each thread accumulates
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][D + 1], pre-scaled by sm_scale
  float* dos = qs + BQ * (D + 1);      // [BQ][D + 1]
  float* ks = dos + BQ * (D + 1);      // [BK][D + 1]
  float* vs = ks + BK * (D + 1);       // [BK][D + 1]
  float* dss = vs + BK * (D + 1);      // [BQ][BK + PAD]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;             // this thread's query row in the tile
  const int c = tid % TPR;             // its lane within the row's group
  const int gq = q0 + r;
  const int offset = sk - sq;          // bottom-right causal alignment
  const size_t qbase = (size_t)bh * sq;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;

  stage<T, D>(qs, q + qbase * D, q0, sq, sm_scale);
  stage<T, D>(dos, dout + qbase * D, q0, sq, 1.f);
  // rows past Sq: lse = +inf gives P = 0
  const float row_lse = gq < sq ? lse[qbase + gq] : INFINITY;
  const float row_delta = gq < sq ? delta[qbase + gq] : 0.f;

  // k columns any row of this tile can see: the causal skip of dead k-tiles
  int kend = sk;
  if (causal) kend = min(sk, min(q0 + BQ, sq) - 1 + offset + 1);

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  const float* qr = qs + r * (D + 1);
  const float* dor = dos + r * (D + 1);
  float* dsr = dss + r * (BK + PAD);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; q and dO are staged
    stage<T, D>(ks, kb, k0, sk, 1.f);
    stage<T, D>(vs, vb, k0, sk, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = c + TPR * jj;
      const int g = k0 + j;
      const float s = dot<D>(qr, ks + j * (D + 1));
      const float dp = dot<D>(dor, vs + j * (D + 1));
      const bool live = g < sk && (!causal || g <= gq + offset);
      const float p = live ? expf(s - row_lse) : 0.f;
      dsr[j] = p * (dp - row_delta);
    }
    __syncwarp();  // a row's four threads share one warp

    for (int j = 0; j < BK; ++j) {
      const float ds = dsr[j];
      const float* kr = ks + j * (D + 1) + c;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = fmaf(ds, kr[TPR * i], acc[i]);
    }
  }

  if (gq < sq) {
    T* row = dq + (qbase + gq) * D + c;
#pragma unroll
    for (int i = 0; i < ND; ++i) row[TPR * i] = from_f32<T>(acc[i] * sm_scale);
  }
}

// ---------------------------------------------------------------- dk, dv

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + PAD) + 2 * BQ;
}

template <typename T, int D>
__global__ void BWD_LAUNCH_BOUNDS
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int causal,
                     float sm_scale) {
  constexpr int ND = D / TPR;   // dk and dv columns each thread accumulates
  extern __shared__ float smem[];
  float* ks = smem;                    // [BK][D + 1]
  float* vs = ks + BK * (D + 1);       // [BK][D + 1]
  float* qs = vs + BK * (D + 1);       // [BQ][D + 1], pre-scaled by sm_scale
  float* dos = qs + BQ * (D + 1);      // [BQ][D + 1]
  float* ps = dos + BQ * (D + 1);      // [BK][BQ + PAD]: P transposed
  float* dss = ps + BK * (BQ + PAD);   // [BK][BQ + PAD]: dS transposed
  float* lses = dss + BK * (BQ + PAD); // [BQ]
  float* deltas = lses + BQ;           // [BQ]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int r = tid / TPR;             // this thread's key row in the tile
  const int c = tid % TPR;
  const int gk = k0 + r;
  const int offset = sk - sq;
  const size_t qbase = (size_t)bh * sq;
  const size_t kbase = (size_t)bh * sk;
  const T* qb = q + qbase * D;
  const T* dob = dout + qbase * D;

  stage<T, D>(ks, k + kbase * D, k0, sk, 1.f);
  stage<T, D>(vs, v + kbase * D, k0, sk, 1.f);

  // the first q-tile with a row that sees column k0: the causal skip
  int qbeg = 0;
  if (causal) qbeg = max(0, k0 - offset) / BQ * BQ;

  float dka[ND], dva[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) dka[i] = dva[i] = 0.f;
  const float* kr = ks + r * (D + 1);
  const float* vr = vs + r * (D + 1);
  float* pr = ps + r * (BQ + PAD);
  float* dsr = dss + r * (BQ + PAD);

  for (int q0 = qbeg; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous tile is consumed; k and v are staged
    stage<T, D>(qs, qb, q0, sq, sm_scale);
    stage<T, D>(dos, dob, q0, sq, 1.f);
    for (int i = tid; i < BQ; i += NT) {
      const int g = q0 + i;
      lses[i] = g < sq ? lse[qbase + g] : INFINITY;
      deltas[i] = g < sq ? delta[qbase + g] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < NJ; ++jj) {
      const int i = c + TPR * jj;
      const int g = q0 + i;
      const float s = dot<D>(qs + i * (D + 1), kr);
      const float dp = dot<D>(dos + i * (D + 1), vr);
      const bool live = gk < sk && g < sq && (!causal || gk <= g + offset);
      const float p = live ? expf(s - lses[i]) : 0.f;
      pr[i] = p;
      dsr[i] = p * (dp - deltas[i]);
    }
    __syncwarp();

    for (int i = 0; i < BQ; ++i) {
      const float p = pr[i];
      const float ds = dsr[i];
      const float* qi = qs + i * (D + 1) + c;   // already times sm_scale
      const float* doi = dos + i * (D + 1) + c;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        dva[n] = fmaf(p, doi[TPR * n], dva[n]);
        dka[n] = fmaf(ds, qi[TPR * n], dka[n]);
      }
    }
  }

  if (gk < sk) {
    T* dkr = dk + (kbase + gk) * D + c;
    T* dvr = dv + (kbase + gk) * D + c;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      dkr[TPR * n] = from_f32<T>(dka[n]);
      dvr[TPR * n] = from_f32<T>(dva[n]);
    }
  }
}

// ---------------------------------------------------------------- tensor cores
// f16 and bf16: mma.sync m16n8k16 from ldmatrix fragments, f32 accumulate.
// Fragment layouts (PTX ISA, mma.m16n8k16), lane = 4 * g + t:
//   A (16 x 16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                a3 = (g+8, 2t+8..);
//   B (16 x 8):  b0 = (2t..2t+1, g), b1 = (2t+8.., g);
//   C (16 x 8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// So the C fragments of two neighbouring 8-column tiles are, packed in
// pairs, the A fragment of one 16-deep step.

constexpr int MT = 128;                // threads per CTA: 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to T, lo in the low half (the lower column)
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What rounding to T dropped from (lo, hi) when pack2 gave `packed`, rounded
// to T in turn: packed + rest carries about twice T's significant bits.
template <typename T> __device__ __forceinline__ uint32_t rest2(float lo, float hi, uint32_t packed);
template <> __device__ __forceinline__ uint32_t rest2<__nv_bfloat16>(float lo, float hi, uint32_t packed) {
  return pack2<__nv_bfloat16>(lo - __uint_as_float(packed << 16),
                              hi - __uint_as_float(packed & 0xffff0000u));
}
template <> __device__ __forceinline__ uint32_t rest2<__half>(float lo, float hi, uint32_t packed) {
  return pack2<__half>(lo - __half2float(__ushort_as_half(packed & 0xffffu)),
                       hi - __half2float(__ushort_as_half(packed >> 16)));
}

// Rows [g0, g0 + 64) of a (rows, D) matrix into a [64][D + 8] tile with
// 16-byte cp.async; rows past `rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int g0, int rows) {
  constexpr int CH = D / 8;           // 16-byte chunks per row
  static_assert(64 * CH % MT == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < 64 * CH / MT; ++j) {
    const int i = threadIdx.x + j * MT;
    const int r = i / CH, c = (i % CH) * 8;
    const bool in = g0 + r < rows;
    cp_async16(smem_u32(dst + r * (D + 8) + c),
               src + (size_t)(in ? g0 + r : 0) * D + c, in ? 16 : 0);
  }
}

// Rows [g0, g0 + 64) of lse and delta into stats[0..63] and stats[64..127];
// rows past `rows` are zero and masked where they are read.
__device__ __forceinline__ void load_stats(float* stats,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int g0, int rows) {
  const int i = threadIdx.x;
  if (i < 64) {
    const bool in = g0 + i < rows;
    const int g = in ? g0 + i : 0;
    cp_async4(smem_u32(stats + i), lse + g, in ? 4 : 0);
    cp_async4(smem_u32(stats + 64 + i), delta + g, in ? 4 : 0);
  }
}

// This warp's 16 x D accumulator, times `scale` and rounded to T, into its
// 16 rows of a [64][D + 8] tile.
template <typename T, int D>
__device__ __forceinline__ void acc_to_tile(T* tile, const float (&acc)[D / 8][4],
                                            float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* r0 = tile + (warp * 16 + (lane >> 2)) * (D + 8) + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    *reinterpret_cast<uint32_t*>(r0 + nt * 8) =
        pack2<T>(acc[nt][0] * scale, acc[nt][1] * scale);
    *reinterpret_cast<uint32_t*>(r0 + 8 * (D + 8) + nt * 8) =
        pack2<T>(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

// A [64][D + 8] tile to rows [g0, g0 + 64) of a (rows, D) matrix in 16-byte
// stores, rows past `rows` not stored.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const T* tile,
                                           int g0, int rows) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int j = 0; j < 64 * CH / MT; ++j) {
    const int i = threadIdx.x + j * MT;
    const int r = i / CH, c = (i % CH) * 8;
    if (g0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(g0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(tile + r * (D + 8) + c);
  }
}

// Per-lane offsets (in elements, for a tile of row stride rs) of the ldmatrix
// x4 addresses. a_off: matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15) give a0..a3 of a 16 x 16 A fragment, and with .trans b0, b1 of
// two 8-column B tiles whose reduction runs along the rows. b_off: (0-7, 0-7),
// (0-7, 8-15), (8-15, 0-7), (8-15, 8-15) give b0, b1 of two 8-row B tiles
// whose reduction runs along the columns (B = rows^T).
__device__ __forceinline__ int a_off(int lane, int rs) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * rs + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int rs) {
  return ((lane & 7) + (lane >> 4) * 8) * rs + ((lane >> 3) & 1) * 8;
}

template <int D>
constexpr int dq_mma_smem_bytes() {   // Q, dO; K and V twice; in T (2 bytes)
  return 6 * 64 * (D + 8) * 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(MT)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int sq, int sk, int causal, float sm_scale) {
  constexpr int RS = D + 8;             // shared row stride, elements
  constexpr int TILE = 64 * RS;
  constexpr bool KEEP = D <= 64;        // Q and dO fragments in registers
  constexpr int NK = D <= 32 ? 64 : 32; // key columns of S per pass
  // passes unrolled; at D 128 one at a time, or ptxas spills hoisting loads
  constexpr int UNROLL = D <= 64 ? BK / NK : 1;
  constexpr int KS = D / 16;            // 16-deep steps over the head dim
  constexpr int ND = D / 8;             // 8-column tiles of dq
  extern __shared__ __align__(16) unsigned char smem_mma[];
  T* qs = reinterpret_cast<T*>(smem_mma);   // [64][RS]
  T* dos = qs + TILE;                       // [64][RS]
  T* kvs = dos + TILE;                      // [2][K, V][64][RS]

  const int bh = blockIdx.x;
  // the last q-tiles see the most keys under the causal mask: run them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const T* qb = q + (size_t)bh * sq * D;
  const T* dob = dout + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;

  int kend = sk;   // k columns any row of this tile can see
  if (causal) kend = min(sk, min(q0 + BQ, sq) + offset);
  const int n = kend > 0 ? (kend + BK - 1) / BK : 0;

  load_tile<T, D>(qs, qb, q0, sq);
  load_tile<T, D>(dos, dob, q0, sq);
  cp_commit();
  if (n > 0) {
    load_tile<T, D>(kvs, kb, 0, sk);
    load_tile<T, D>(kvs + TILE, vb, 0, sk);
  }
  cp_commit();

  // this thread's rows warp*16 + g and + 8: lse in log2 units (+inf past Sq)
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gq = q0 + warp * 16 + g + 8 * h;
    lse2[h] = gq < sq ? lse[(size_t)bh * sq + gq] * LOG2E : INFINITY;
    dlt[h] = gq < sq ? delta[(size_t)bh * sq + gq] : 0.f;
  }
  const float c2 = sm_scale * LOG2E;
  const int aoff = a_off(lane, RS), boff = b_off(lane, RS);
  const T* qw = qs + warp * 16 * RS;
  const T* dow = dos + warp * 16 * RS;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  cp_wait<1>();       // Q and dO have landed
  __syncthreads();
  uint32_t qf[KEEP ? KS : 1][4], dof[KEEP ? KS : 1][4];
  if constexpr (KEEP) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldsm_x4(qf[ks], smem_u32(qw + ks * 16 + aoff));
      ldsm_x4(dof[ks], smem_u32(dow + ks * 16 + aoff));
    }
  }

  for (int it = 0; it < n; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n) {
      T* nb = kvs + ((it + 1) & 1) * 2 * TILE;
      load_tile<T, D>(nb, kb, k0 + BK, sk);
      load_tile<T, D>(nb + TILE, vb, k0 + BK, sk);
    }
    cp_commit();
    cp_wait<1>();     // tile `it` has landed
    __syncthreads();
    const T* kt = kvs + (it & 1) * 2 * TILE;
    const T* vt = kt + TILE;
    const bool masked = (causal && k0 + BK - 1 > q0 + offset) || k0 + BK > sk;

#pragma unroll UNROLL
    for (int kc = 0; kc < BK; kc += NK) {
      float s[NK / 8][4], dp[NK / 8][4];
#pragma unroll
      for (int i = 0; i < NK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
      // S = Q K^T and dP = dO V^T for this warp's 16 rows x NK columns
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t aq[4], ado[4];
        if constexpr (KEEP) {
#pragma unroll
          for (int e = 0; e < 4; ++e) aq[e] = qf[ks][e], ado[e] = dof[ks][e];
        } else {
          ldsm_x4(aq, smem_u32(qw + ks * 16 + aoff));
          ldsm_x4(ado, smem_u32(dow + ks * 16 + aoff));
        }
#pragma unroll
        for (int np = 0; np < NK / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, smem_u32(kt + (kc + np * 16) * RS + ks * 16 + boff));
          mma16816<T>(s[2 * np], aq, b[0], b[1]);
          mma16816<T>(s[2 * np + 1], aq, b[2], b[3]);
          ldsm_x4(b, smem_u32(vt + (kc + np * 16) * RS + ks * 16 + boff));
          mma16816<T>(dp[2 * np], ado, b[0], b[1]);
          mma16816<T>(dp[2 * np + 1], ado, b[2], b[3]);
        }
      }
      // P = exp(scale s - lse), dS = P o (dP - delta), as A fragments in T
      uint32_t dsf[NK / 16][4], dsl[NK / 16][4];   // dS as hi + lo
#pragma unroll
      for (int nt = 0; nt < NK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float p = exp2f(fmaf(s[nt][e], c2, -lse2[h]));
          if (masked) {
            const int gk = k0 + kc + nt * 8 + 2 * t + (e & 1);
            const int gq = q0 + warp * 16 + g + 8 * h;
            if (gk >= sk || (causal && gk > gq + offset)) p = 0.f;
          }
          s[nt][e] = p * (dp[nt][e] - dlt[h]);
        }
        uint32_t* f = dsf[nt / 2] + (nt & 1) * 2;
        uint32_t* r = dsl[nt / 2] + (nt & 1) * 2;
        f[0] = pack2<T>(s[nt][0], s[nt][1]);
        f[1] = pack2<T>(s[nt][2], s[nt][3]);
        r[0] = rest2<T>(s[nt][0], s[nt][1], f[0]);
        r[1] = rest2<T>(s[nt][2], s[nt][3], f[1]);
      }
      // dq += dS K: K's rows are the reduction, so its fragments are .trans
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(kt + (kc + kk * 16) * RS + np * 16 + aoff));
          mma16816<T>(acc[2 * np], dsf[kk], b[0], b[1]);
          mma16816<T>(acc[2 * np + 1], dsf[kk], b[2], b[3]);
          mma16816<T>(acc[2 * np], dsl[kk], b[0], b[1]);
          mma16816<T>(acc[2 * np + 1], dsl[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // tile `it` is consumed before it is loaded again
  }

  // dq = scale * acc, through the q tile in shared memory
  __syncthreads();
  acc_to_tile<T, D>(qs, acc, sm_scale);
  __syncthreads();
  store_tile<T, D>(dq + (size_t)bh * sq * D, qs, q0, sq);
}

template <int D>
constexpr int dkv_mma_smem_bytes() {  // K, V; Q and dO twice; lse, delta twice
  return 6 * 64 * (D + 8) * 2 + 2 * 128 * 4;
}

// CTAs per SM that dk/dv asks ptxas to fit. bf16 at D 64 (the training
// path): 3, so at most 168 registers, with K and V read from shared memory;
// it measured faster than 2 CTAs with them in registers (~245 registers). In
// f16 the same bound spills, so f16 keeps the looser one.
template <typename T, int D>
__host__ __device__ constexpr int dkv_min_ctas() {
  return D == 64 && std::is_same<T, __nv_bfloat16>::value ? 3 : 1;
}

template <typename T, int D>
__global__ void __launch_bounds__(MT, dkv_min_ctas<T, D>())
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int sq, int sk, int causal,
                         float sm_scale) {
  constexpr int RS = D + 8;
  constexpr int TILE = 64 * RS;
  // K and V fragments in registers
  constexpr bool KEEP = D <= 32 || (D == 64 && dkv_min_ctas<T, D>() == 1);
  constexpr int NQ = D <= 32 ? 64 : D <= 64 ? 32 : 16;  // q columns per pass
  constexpr int UNROLL = D <= 64 ? BQ / NQ : 1;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  T* ks = reinterpret_cast<T*>(smem_mma);   // [64][RS]
  T* vs = ks + TILE;                        // [64][RS]
  T* qdo = vs + TILE;                       // [2][Q, dO][64][RS]
  float* stats = reinterpret_cast<float*>(qdo + 4 * TILE);  // [2][lse, delta][64]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int offset = sk - sq;
  const T* qb = q + (size_t)bh * sq * D;
  const T* dob = dout + (size_t)bh * sq * D;
  const float* lseb = lse + (size_t)bh * sq;
  const float* deltab = delta + (size_t)bh * sq;

  // the first q-tile with a row that sees column k0: the causal skip
  int qbeg = 0;
  if (causal) qbeg = max(0, k0 - offset) / BQ * BQ;
  const int n = qbeg < sq ? (sq - qbeg + BQ - 1) / BQ : 0;

  load_tile<T, D>(ks, k + (size_t)bh * sk * D, k0, sk);
  load_tile<T, D>(vs, v + (size_t)bh * sk * D, k0, sk);
  cp_commit();
  if (n > 0) {
    load_tile<T, D>(qdo, qb, qbeg, sq);
    load_tile<T, D>(qdo + TILE, dob, qbeg, sq);
    load_stats(stats, lseb, deltab, qbeg, sq);
  }
  cp_commit();

  const float c2 = sm_scale * LOG2E;
  const int aoff = a_off(lane, RS), boff = b_off(lane, RS);
  const T* kw = ks + warp * 16 * RS;
  const T* vw = vs + warp * 16 * RS;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  cp_wait<1>();       // K and V have landed
  __syncthreads();
  uint32_t kf[KEEP ? KS : 1][4], vf[KEEP ? KS : 1][4];
  if constexpr (KEEP) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      ldsm_x4(kf[s], smem_u32(kw + s * 16 + aoff));
      ldsm_x4(vf[s], smem_u32(vw + s * 16 + aoff));
    }
  }

  for (int it = 0; it < n; ++it) {
    const int q0 = qbeg + it * BQ;
    if (it + 1 < n) {
      const int nb = (it + 1) & 1;
      load_tile<T, D>(qdo + nb * 2 * TILE, qb, q0 + BQ, sq);
      load_tile<T, D>(qdo + nb * 2 * TILE + TILE, dob, q0 + BQ, sq);
      load_stats(stats + nb * 128, lseb, deltab, q0 + BQ, sq);
    }
    cp_commit();
    cp_wait<1>();     // tile `it` has landed
    __syncthreads();
    const T* qt = qdo + (it & 1) * 2 * TILE;
    const T* dos = qt + TILE;
    const float* lst = stats + (it & 1) * 128;
    const float* dlt = lst + 64;
    const bool masked = (causal && q0 + offset < k0 + BK - 1) || q0 + BQ > sq;

#pragma unroll UNROLL
    for (int qc = 0; qc < BQ; qc += NQ) {
      float s[NQ / 8][4], dp[NQ / 8][4];
#pragma unroll
      for (int i = 0; i < NQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 k rows x NQ q
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        uint32_t ak[4], av[4];
        if constexpr (KEEP) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ak[e] = kf[st][e], av[e] = vf[st][e];
        } else {
          ldsm_x4(ak, smem_u32(kw + st * 16 + aoff));
          ldsm_x4(av, smem_u32(vw + st * 16 + aoff));
        }
#pragma unroll
        for (int np = 0; np < NQ / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, smem_u32(qt + (qc + np * 16) * RS + st * 16 + boff));
          mma16816<T>(s[2 * np], ak, b[0], b[1]);
          mma16816<T>(s[2 * np + 1], ak, b[2], b[3]);
          ldsm_x4(b, smem_u32(dos + (qc + np * 16) * RS + st * 16 + boff));
          mma16816<T>(dp[2 * np], av, b[0], b[1]);
          mma16816<T>(dp[2 * np + 1], av, b[2], b[3]);
        }
      }
      // P^T and dS^T, column j being query row q0 + j, as A fragments in T
      uint32_t pf[NQ / 16][4], pl[NQ / 16][4];     // P^T as hi + lo
      uint32_t dsf[NQ / 16][4], dsl[NQ / 16][4];   // dS^T as hi + lo
#pragma unroll
      for (int nt = 0; nt < NQ / 8; ++nt) {
        const int col = qc + nt * 8 + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(lst + col);
        const float2 d = *reinterpret_cast<const float2*>(dlt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = e & 1;
          float p = exp2f(fmaf(s[nt][e], c2, -(j ? l.y : l.x) * LOG2E));
          if (masked) {
            const int gq = q0 + col + j;
            const int gk = k0 + warp * 16 + g + 8 * (e >> 1);
            if (gq >= sq || (causal && gk > gq + offset)) p = 0.f;
          }
          dp[nt][e] = p * (dp[nt][e] - (j ? d.y : d.x));
          s[nt][e] = p;
        }
        uint32_t* fp = pf[nt / 2] + (nt & 1) * 2;
        uint32_t* fd = dsf[nt / 2] + (nt & 1) * 2;
        fp[0] = pack2<T>(s[nt][0], s[nt][1]);
        fp[1] = pack2<T>(s[nt][2], s[nt][3]);
        fd[0] = pack2<T>(dp[nt][0], dp[nt][1]);
        fd[1] = pack2<T>(dp[nt][2], dp[nt][3]);
        uint32_t* rp = pl[nt / 2] + (nt & 1) * 2;
        uint32_t* rd = dsl[nt / 2] + (nt & 1) * 2;
        rp[0] = rest2<T>(s[nt][0], s[nt][1], fp[0]);
        rp[1] = rest2<T>(s[nt][2], s[nt][3], fp[1]);
        rd[0] = rest2<T>(dp[nt][0], dp[nt][1], fd[0]);
        rd[1] = rest2<T>(dp[nt][2], dp[nt][3], fd[1]);
      }
      // dV += P^T dO and dK += dS^T Q: the q rows are the reduction (.trans)
#pragma unroll
      for (int kk = 0; kk < NQ / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, smem_u32(dos + (qc + kk * 16) * RS + np * 16 + aoff));
          mma16816<T>(dva[2 * np], pf[kk], b[0], b[1]);
          mma16816<T>(dva[2 * np + 1], pf[kk], b[2], b[3]);
          mma16816<T>(dva[2 * np], pl[kk], b[0], b[1]);
          mma16816<T>(dva[2 * np + 1], pl[kk], b[2], b[3]);
          ldsm_x4_t(b, smem_u32(qt + (qc + kk * 16) * RS + np * 16 + aoff));
          mma16816<T>(dka[2 * np], dsf[kk], b[0], b[1]);
          mma16816<T>(dka[2 * np + 1], dsf[kk], b[2], b[3]);
          mma16816<T>(dka[2 * np], dsl[kk], b[0], b[1]);
          mma16816<T>(dka[2 * np + 1], dsl[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // tile `it` is consumed before it is loaded again
  }

  // dk = scale * dka and dv = dva, through the k and v tiles
  __syncthreads();
  acc_to_tile<T, D>(ks, dka, sm_scale);
  acc_to_tile<T, D>(vs, dva, 1.f);
  __syncthreads();
  store_tile<T, D>(dk + (size_t)bh * sk * D, ks, k0, sk);
  store_tile<T, D>(dv + (size_t)bh * sk * D, vs, k0, sk);
}

// ---------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *g0, *g1;   // dq; or dk and dv
  int bh, sq, sk, causal;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const int smem = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.bh, (a.sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.g0), a.sq, a.sk, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.bh, (a.sk + BK - 1) / BK);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.sq, a.sk, a.causal,
      a.sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_mma(const Args& a) {
  const int smem = dq_mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.bh, (a.sq + BQ - 1) / BQ);
  flash_bwd_dq_mma_kernel<T, D><<<grid, MT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.g0), a.sq, a.sk, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_mma(const Args& a) {
  const int smem = dkv_mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.bh, (a.sk + BK - 1) / BK);
  flash_bwd_dkv_mma_kernel<T, D><<<grid, MT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.sq, a.sk, a.causal,
      a.sm_scale);
  return cudaGetLastError();
}

// The design for f16 and bf16: true runs the tensor-core kernels, false the
// CUDA-core ones. tools/bwd_ab.py builds a copy with this line set to false.
// A build compiles only the kernels it runs.
constexpr bool kTensorCores = true;  // design switch (bwd_ab.py)

template <bool DKV, typename T, int D>
cudaError_t launch_one(const Args& a) {
  if constexpr (kTensorCores && !std::is_same<T, float>::value)
    return DKV ? launch_dkv_mma<T, D>(a) : launch_dq_mma<T, D>(a);
  else
    return DKV ? launch_dkv<T, D>(a) : launch_dq<T, D>(a);
}

template <bool DKV, typename T>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch_one<DKV, T, 16>(a);
    case 32: return launch_one<DKV, T, 32>(a);
    case 64: return launch_one<DKV, T, 64>(a);
    case 128: return launch_one<DKV, T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int launch(int d, int dtype, const Args& a) {
  if (a.bh < 1 || a.sq < 1 || a.sk < 1 || (a.sq + BQ - 1) / BQ > 65535 ||
      (a.sk + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)launch_d<DKV, float>(d, a);
    case 1: return (int)launch_d<DKV, __half>(d, a);
    case 2: return (int)launch_d<DKV, __nv_bfloat16>(d, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int d, int dtype, int causal,
                            float sm_scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, sq, sk, causal,
               sm_scale, static_cast<cudaStream_t>(stream)};
  return launch<false>(d, dtype, a);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int d, int dtype, int causal,
                             float sm_scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, causal,
               sm_scale, static_cast<cudaStream_t>(stream)};
  return launch<true>(d, dtype, a);
}

// 1 when this build runs dtype on the tensor-core kernels, else 0.
extern "C" int flash_bwd_tensor_cores(int dtype) {
  return (dtype == 1 || dtype == 2) && kTensorCores ? 1 : 0;
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
