// Flash-attention backward for Hopper (sm_90a), plain CUDA C++: two kernels.
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
// and no second pass. Each CTA loads its own tile (q and dO, or k and v) once.
//
// Masking, as flash_fwd.cu: the causal mask is bottom-right aligned (query
// row i sees key column j when j <= i + (Sk - Sq)); tiles wholly above the
// diagonal are skipped (the dq kernel stops its k loop at the last column its
// rows can see, the dkv kernel starts its q loop at the first q-tile that can
// see its columns); ragged tails are zero-filled and never stored. A row with
// no live column has lse = +inf, which gives P = 0 and no NaN. Query rows past
// Sq in the last tile are treated as lse = +inf with dO = 0, so they add
// nothing to dk and dv.
//
// What bounds it on an H100: at the training shape (B*H 192, S 1024, D 64,
// causal, bf16) the dq kernel moves ~127 MB against ~39 GFLOP, about balanced
// between bytes and operations at the bf16 tensor-core peak; the dkv kernel
// moves ~153 MB against ~52 GFLOP, bound by operations. This first design does
// the products as plain f32 FMAs on the CUDA cores with the operands staged as
// f32 in shared memory (no mma/wgmma, no TMA), so its rate is the CUDA-core f32
// rate, bounded in practice by shared-memory loads; device-memory traffic stays
// near the bound because every tile is read once per CTA that needs it. A
// tensor-core version is later work.
//
// Layout: q, dO, dq (B*H, Sq, D); k, v, dk, dv (B*H, Sk, D), all contiguous in
// one dtype (f32, f16 or bf16); lse and delta (B*H, Sq) f32. Head dims 16, 32,
// 64, 128. Each C entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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

template <bool DKV, typename T>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 16: return DKV ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32: return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
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

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
