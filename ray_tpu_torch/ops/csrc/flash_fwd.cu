// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces ray_tpu/ops/attention.py:_fwd_kernel (the Pallas TPU kernel that
// _flash_pallas launches). Same function: O = softmax(scale * Q K^T + causal
// mask) V by online softmax (running max m, running sum l, f32 accumulator),
// plus the per-row logsumexp lse = m + log(l). Differences from the TPU kernel,
// each on purpose:
//   - one CTA per (batch*head row, q-tile); the TPU's sequential kv grid axis
//     becomes a loop over k-tiles inside the CTA (blocks run in no order here);
//   - ragged tails are masked for any Sq and Sk (the TPU version asserted
//     Sq % block_q == 0 and Sk % block_k == 0), so decode lengths 129, 130, ...
//     work;
//   - lse is stored as (B*H, Sq) f32, without the TPU's 128-lane broadcast;
//   - rows with no live column give out = 0 and lse = +inf, as on the TPU.
// The causal mask is bottom-right aligned: query row i sees key column j when
// j <= i + (Sk - Sq). k-tiles wholly above the diagonal are never loaded.
//
// What bounds it on an H100: at decode-sized Sq (and at the serving shapes,
// S <= 1024, D = 64) the work is a few hundred MFLOP per call, well below the
// ~295 FLOP/byte at which bf16 tensor cores stop waiting on memory, so the
// least time is set by the bytes of Q, K, V and O. Only long prefill is
// compute-bound. This first design is simple on purpose: tiles are staged as
// f32 in shared memory and both products are plain FMAs on the CUDA cores
// (no mma/wgmma, no TMA, no warp specialisation). It reads each K/V tile once
// per q-tile and keeps S/P for one tile in shared memory only, so device
// memory traffic stays near the bound; its arithmetic rate is the CUDA-core
// f32 rate, which is what a later tensor-core version improves on.
//
// Layout: q (B*H, Sq, D), k and v (B*H, Sk, D), o like q, all contiguous in
// one dtype (f32, f16 or bf16); lse (B*H, Sq) f32. Head dims 16, 32, 64, 128.
// The C entry returns cudaGetLastError() after the launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // key rows per k-tile
constexpr int TPR = 4;          // threads per query row (consecutive lanes)
constexpr int NT = BQ * TPR;    // 256 threads per CTA
constexpr int NJ = BK / TPR;    // score columns each thread computes per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Shared memory, in floats: Q tile and K tile padded by one column so that the
// 8 rows a warp reads fall in different banks; V tile; P tile padded likewise.
template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int causal,
                 float sm_scale) {
  constexpr int ND = D / TPR;   // output columns each thread accumulates
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][D + 1], pre-scaled by sm_scale
  float* ks = qs + BQ * (D + 1);       // [BK][D + 1]
  float* vs = ks + BK * (D + 1);       // [BK][D]
  float* ps = vs + BK * D;             // [BQ][BK + 1]

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;             // this thread's query row in the tile
  const int c = tid % TPR;             // its lane within the row's group
  const int gq = q0 + r;
  const int offset = sk - sq;          // bottom-right causal alignment
  const T* qb = q + (size_t)bh * sq * D;
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int row = i / D, col = i % D;
    const int g = q0 + row;
    qs[row * (D + 1) + col] =
        g < sq ? to_f32(qb[(size_t)g * D + col]) * sm_scale : 0.f;
  }

  // k columns any row of this tile can see: the causal skip of dead k-tiles
  int kend = sk;
  if (causal) kend = min(sk, min(q0 + BQ, sq) - 1 + offset + 1);

  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const float* qr = qs + r * (D + 1);
  float* pr = ps + r * (BK + 1);

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; the Q tile is written
    for (int i = tid; i < BK * D; i += NT) {
      const int row = i / D, col = i % D;
      const int g = k0 + row;
      const bool in = g < sk;
      ks[row * (D + 1) + col] = in ? to_f32(kb[(size_t)g * D + col]) : 0.f;
      vs[row * D + col] = in ? to_f32(vb[(size_t)g * D + col]) : 0.f;
    }
    __syncthreads();

    // scores for columns c, c + TPR, ...: neighbouring lanes read other rows
    float s[NJ];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int j = c + TPR * jj;
      const int g = k0 + j;
      const float* kr = ks + j * (D + 1);
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const bool live = g < sk && (!causal || g <= gq + offset);
      s[jj] = live ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);

    // fully-masked-row guards: a row with no live column so far keeps
    // m = -inf, p = 0 and l = 0 instead of exp(-inf - (-inf)) = NaN
    float alpha = 0.f, psum = 0.f;
    if (m_new == -INFINITY) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s[jj] = 0.f;
    } else {
      alpha = m == -INFINITY ? 0.f : expf(m - m_new);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        psum += s[jj];
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;

#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) pr[c + TPR * jj] = s[jj];
    __syncwarp();  // a row's four threads share one warp

#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * D + c;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = fmaf(p, vr[TPR * i], acc[i]);
    }
  }

  if (gq < sq) {
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = o + ((size_t)bh * sq + gq) * D + c;
#pragma unroll
    for (int i = 0; i < ND; ++i) orow[TPR * i] = from_f32<T>(acc[i] / l_safe);
    if (c == 0) lse[(size_t)bh * sq + gq] = l == 0.f ? INFINITY : m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, int causal,
                   float sm_scale, cudaStream_t stream) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      sq, sk, causal, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* o, void* lse, int bh, int sq, int sk, int causal,
                     float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, sq, sk, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, sq, sk, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, sq, sk, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, sq, sk, causal, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int sq, int sk, int d, int dtype,
                         int causal, float sm_scale, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float>(d, q, k, v, o, lse, bh, sq, sk, causal, sm_scale, st);
    case 1: return (int)launch_d<__half>(d, q, k, v, o, lse, bh, sq, sk, causal, sm_scale, st);
    case 2: return (int)launch_d<__nv_bfloat16>(d, q, k, v, o, lse, bh, sq, sk, causal, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
