// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces ray_tpu/ops/attention.py:_fwd_kernel (the Pallas TPU kernel that
// _flash_pallas launches, pallas_call at :309). Same function: O = softmax(
// scale * Q K^T + causal mask) V by online softmax (running max m, running sum
// l, f32 accumulator), plus the per-row logsumexp lse = m + log(l).
// Differences from the TPU kernel, each on purpose:
//   - one CTA per (batch*head row, q-tile); the TPU's sequential kv grid axis
//     becomes a loop over k-tiles inside the CTA (blocks run in no order here);
//   - ragged tails are masked for any Sq and Sk (the TPU version asserted
//     Sq % block_q == 0 and Sk % block_k == 0), so decode lengths 129, 130, ...
//     work;
//   - lse is stored as (B*H, Sq) f32, without the TPU's 128-lane broadcast;
//   - rows with no live column give out = 0 and lse = +inf, as on the TPU.
// The causal mask is bottom-right aligned: query row i sees key column j when
// j <= i + (Sk - Sq). k-tiles wholly above the diagonal are never loaded.
// An optional live key length k_len, a device int read by each CTA (never by
// the host), makes keys j >= k_len dead and takes Sk's place in the causal
// alignment: query i sees key j iff j < k_len and j <= i + (k_len - Sq). The
// k-tile loop ends at k_len, so a decode over a whole static cache of Sk rows
// reads only its live part. Each kernel is built twice, on the template flag
// LIVE: without a k_len (null) the length is Sk, a kernel parameter, and the
// code is that of the kernel before k_len existed (one build choosing at run
// time cost 13-33 % at every shape, PERF.md); with one, thread 0 reads it and
// the CTA takes it from shared memory after a barrier, which costs nothing
// measurable, where a read by every thread cost 17-20 % at the Llama decode
// and prefill shapes (tools/live_ab.py).
//
// What bounds it on an H100: at the training shape (B*H 192, S 1024, D 64,
// causal, bf16) the kernel must move ~51 MB (q, k, v read once, out and lse
// written once) and do 4*d FLOPs per live (query, key) pair, 25.8 GFLOP: at
// 3.35 TB/s and 989 TFLOP/s that is 0.030 ms by bytes against 0.026 ms by
// operations, so it sits near the ridge (0.039 ms by operations counting the
// hi + lo products of P V that bf16 runs, below). At the serving shape (B*H
// 12, S 512) and at decode lengths the bytes bound it.
//
// Two designs, chosen by the element type in launch_one:
//   - f16 and bf16: flash_fwd_mma_kernel, on the tensor cores. Four warps per
//     CTA, each owning 16 rows of a 64-row q tile (the M of mma.sync
//     m16n8k16, f32 accumulate). The Q tile is loaded once; up to D 64 its A
//     fragments stay in registers, at D 128 they are read from shared memory
//     at each use so that the 16 x 128 f32 accumulator fits. K and V tiles
//     sit in shared memory in the input type, rows padded by 8 elements
//     (ldmatrix without bank conflicts), double-buffered with 16-byte
//     cp.async: the next k-tile loads while this one computes; rows past Sk
//     are zero-filled. S = Q K^T runs on the tensor cores with K's B
//     fragments from ldmatrix; the online softmax runs on the accumulator
//     fragments (each lane holds two rows; row max over the quad with
//     shuffles; exp2 with scale * log2(e) folded in; the f32 O accumulator
//     rescaled by exp2(m_old - m_new)); l is summed from the f32 P before any
//     rounding. P never leaves registers: its accumulator fragment, packed in
//     pairs, is the A fragment of P V, with V's B fragments from
//     ldmatrix.trans. In bf16 one rounding of P misses the bf16 limit on
//     causal inputs (its error is absolute on the scale of the summed terms;
//     tests/test_torch_attention.py emulates it), so bf16 P goes in as hi =
//     T(p) and lo = T(p - hi), two products into the same f32 sum; f16's 11
//     bits hold the f16 limit with one rounding. Masks run only on k-tiles
//     that cross the diagonal or the ragged edge, and the last q-tiles (the
//     most keys) launch first. O = acc / l leaves through shared memory in
//     16-byte rows. No atomics and a fixed order of sums: two launches give
//     the same bits.
//   - f32: flash_fwd_kernel, the CUDA-core kernel of the first port: tiles
//     staged as f32 in shared memory and both products as f32 FMAs. TF32
//     mma would not meet f32's 1e-4 limit.
// mma.sync and not Hopper's wgmma: mma.sync keeps the whole tile loop in
// one warp's registers and shares its fragment code with flash_bwd.cu, so
// the first tensor-core design stays simple. It is not the design of the
// yardstick: torch's SDPA forward on this card dispatches to cuDNN, whose
// kernel (named by chip_smoke.py phase 9) is a wgmma kernel, and it rounds P
// once to bf16, a less exact function than this one computes. wgmma with TMA
// and a producer warp is what can bring this kernel to that speed, later.
//
// Layout: q (B*H, Sq, D), k and v (B*H, Sk, D), o like q, all contiguous in
// one dtype (f32, f16 or bf16), 16-byte aligned for f16 and bf16; lse
// (B*H, Sq) f32; k_len, where given, one int32 on the device. Head dims 16, 32, 64, 128. The C entry returns
// cudaGetLastError() after the launch; 0 is success.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

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

// The live key length: *k_len clamped to [0, sk] when LIVE, else sk. All
// threads of the CTA call it, once, before any other barrier.
template <bool LIVE>
__device__ __forceinline__ int live_keys(const int* k_len, int sk) {
  if constexpr (LIVE) {
    __shared__ int live;
    if (threadIdx.x == 0) live = __ldg(k_len);
    __syncthreads();
    return min(max(live, 0), sk);
  } else {
    return sk;
  }
}

// Shared memory, in floats: Q tile and K tile padded by one column so that the
// 8 rows a warp reads fall in different banks; V tile; P tile padded likewise.
template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D, bool LIVE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int causal,
                 float sm_scale, const int* __restrict__ k_len) {
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
  const int skl = live_keys<LIVE>(k_len, sk);
  const int offset = skl - sq;         // bottom-right causal alignment
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
  int kend = skl;
  if (causal) kend = min(skl, min(q0 + BQ, sq) - 1 + offset + 1);

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
      const bool in = g < skl;
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
      const bool live = g < skl && (!causal || g <= gq + offset);
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

// ---------------------------------------------------------------- tensor cores

// Four warps of 16 query rows (a 64-row q tile, MT threads). A 128-row tile
// of 8 warps, half the K/V traffic per row, measured 1.28x slower at the
// training shape and 1.37x at the serving shape (PERF.md): at 135 registers
// a thread only one such CTA fits on an SM.
constexpr int BM = 64;                  // query rows per CTA

template <int D>
constexpr int fwd_mma_smem_bytes() {  // the Q tile; K and V twice; in T
  return (BM + 4 * BK) * (D + 8) * 2;
}

template <typename T, int D, bool LIVE>
__global__ void __launch_bounds__(MT)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int sq, int sk, int causal,
                     float sm_scale, const int* __restrict__ k_len) {
  constexpr int RS = D + 8;             // shared row stride, elements
  constexpr int KV = BK * RS;           // one K or V tile
  constexpr bool KEEP = D <= 64;        // Q fragments in registers
  constexpr bool SPLIT = std::is_same<T, __nv_bfloat16>::value;  // P hi + lo
  constexpr int KS = D / 16;            // 16-deep steps over the head dim
  constexpr int ND = D / 8;             // 8-column tiles of O
  constexpr int NS = BK / 8;            // 8-column tiles of S per k-tile
  extern __shared__ __align__(16) unsigned char smem_mma[];
  T* qs = reinterpret_cast<T*>(smem_mma);   // [BM][RS], later O
  T* kvs = qs + BM * RS;                    // [2][K, V][BK][RS]

  const int bh = blockIdx.x;
  // the last q-tiles see the most keys under the causal mask: run them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int skl = live_keys<LIVE>(k_len, sk);
  const int offset = skl - sq;              // bottom-right causal alignment
  const int gq0 = q0 + warp * 16 + g;       // this thread's rows: gq0, gq0 + 8
  const T* kb = k + (size_t)bh * sk * D;
  const T* vb = v + (size_t)bh * sk * D;

  int kend = skl;  // k columns any row of this tile can see
  if (causal) kend = min(skl, min(q0 + BM, sq) + offset);
  const int n = kend > 0 ? (kend + BK - 1) / BK : 0;

  load_tile<T, D>(qs, q + (size_t)bh * sq * D, q0, sq);
  cp_commit();
  if (n > 0) {
    load_tile<T, D>(kvs, kb, 0, skl);
    load_tile<T, D>(kvs + KV, vb, 0, skl);
  }
  cp_commit();

  const float c2 = sm_scale * LOG2E;        // scores in log2 units
  const int aoff = a_off(lane, RS), boff = b_off(lane, RS);
  const T* qw = qs + warp * 16 * RS;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // running max (log2 units) of rows gq0 and gq0 + 8; this lane's share of
  // their running sums, summed over the quad at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  cp_wait<1>();       // Q has landed
  __syncthreads();
  uint32_t qf[KEEP ? KS : 1][4];
  if constexpr (KEEP) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], smem_u32(qw + ks * 16 + aoff));
  }

  for (int it = 0; it < n; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n) {
      T* nb = kvs + ((it + 1) & 1) * 2 * KV;
      load_tile<T, D>(nb, kb, k0 + BK, skl);
      load_tile<T, D>(nb + KV, vb, k0 + BK, skl);
    }
    cp_commit();
    cp_wait<1>();     // tile `it` has landed
    __syncthreads();
    const T* kt = kvs + (it & 1) * 2 * KV;
    const T* vt = kt + KV;
    const bool masked = (causal && k0 + BK - 1 > q0 + offset) || k0 + BK > skl;

    // S = Q K^T for this warp's 16 rows x BK columns
    float s[NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aq[4];
      if constexpr (KEEP) {
#pragma unroll
        for (int e = 0; e < 4; ++e) aq[e] = qf[ks][e];
      } else {
        ldsm_x4(aq, smem_u32(qw + ks * 16 + aoff));
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(kt + np * 16 * RS + ks * 16 + boff));
        mma16816<T>(s[2 * np], aq, b[0], b[1]);
        mma16816<T>(s[2 * np + 1], aq, b[2], b[3]);
      }
    }

    // online softmax on the fragments: scale to log2 units, mask, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * c2;
        if (masked) {
          const int gk = k0 + nt * 8 + 2 * t + (e & 1);
          if (gk >= skl || (causal && gk > gq0 + 8 * (e >> 1) + offset)) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with no live column so far keeps m = -inf, and p = alpha = 0
      // instead of exp2(-inf - (-inf)) = NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - m_use);
      neg_m[h] = -m_use;
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] + neg_m[e >> 1]);
        s[nt][e] = p;
        l[e >> 1] += p;      // from the f32 P, before any rounding
      }
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= alpha[0], acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1], acc[i][3] *= alpha[1];
    }

    // O += P V: P's fragments, packed in pairs, are the A fragments; V's
    // rows are the reduction, so its fragments are .trans
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t ph[4], pl[4];   // P as hi (+ lo in bf16)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ph[2 * j] = pack2<T>(s[2 * kk + j][0], s[2 * kk + j][1]);
        ph[2 * j + 1] = pack2<T>(s[2 * kk + j][2], s[2 * kk + j][3]);
        if constexpr (SPLIT) {
          pl[2 * j] = rest2<T>(s[2 * kk + j][0], s[2 * kk + j][1], ph[2 * j]);
          pl[2 * j + 1] = rest2<T>(s[2 * kk + j][2], s[2 * kk + j][3], ph[2 * j + 1]);
        }
      }
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(vt + kk * 16 * RS + np * 16 + aoff));
        mma16816<T>(acc[2 * np], ph, b[0], b[1]);
        mma16816<T>(acc[2 * np + 1], ph, b[2], b[3]);
        if constexpr (SPLIT) {
          mma16816<T>(acc[2 * np], pl, b[0], b[1]);
          mma16816<T>(acc[2 * np + 1], pl, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // tile `it` is consumed before it is loaded again
  }

  // O = acc / l (0 where no column is live), lse = m + log(l) (+inf there)
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] == 0.f ? 0.f : 1.f / l[h];
    const int gq = gq0 + 8 * h;
    if (t == 0 && gq < sq)
      lse[(size_t)bh * sq + gq] =
          l[h] == 0.f ? INFINITY : m[h] * 0.6931471805599453f + logf(l[h]);
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    acc[i][0] *= inv[0], acc[i][1] *= inv[0];
    acc[i][2] *= inv[1], acc[i][3] *= inv[1];
  }
  __syncthreads();    // every warp is done reading Q
  acc_to_tile<T, D>(qs, acc, 1.f);
  __syncthreads();
  store_tile<T, D>(o + (size_t)bh * sq * D, qs, q0, sq);
}

// ---------------------------------------------------------------- launchers

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int bh, sq, sk, causal;
  float sm_scale;
  const int* k_len;   // device pointer or null
  cudaStream_t stream;
};

template <typename T, int D, bool LIVE>
cudaError_t launch_cuda_cores(const Args& a) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, LIVE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.bh, (a.sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D, LIVE><<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.sq, a.sk, a.causal, a.sm_scale, a.k_len);
  return cudaGetLastError();
}

template <typename T, int D, bool LIVE>
cudaError_t launch_mma(const Args& a) {
  const int smem = fwd_mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, D, LIVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(a.bh, (a.sq + BM - 1) / BM);
  flash_fwd_mma_kernel<T, D, LIVE><<<grid, MT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.sq, a.sk, a.causal, a.sm_scale, a.k_len);
  return cudaGetLastError();
}

// The design for f16 and bf16: true runs the tensor-core kernel, false the
// CUDA-core one. tools/fwd_ab.py builds a copy with this line set to false.
// A build compiles only the kernels it runs.
constexpr bool kTensorCores = true;  // design switch (fwd_ab.py)

template <typename T, int D, bool LIVE>
cudaError_t launch_design(const Args& a) {
  if constexpr (kTensorCores && !std::is_same<T, float>::value)
    return launch_mma<T, D, LIVE>(a);
  else
    return launch_cuda_cores<T, D, LIVE>(a);
}

template <typename T, int D>
cudaError_t launch_one(const Args& a) {
  return a.k_len ? launch_design<T, D, true>(a) : launch_design<T, D, false>(a);
}

template <typename T>
cudaError_t launch_d(int d, const Args& a) {
  switch (d) {
    case 16: return launch_one<T, 16>(a);
    case 32: return launch_one<T, 32>(a);
    case 64: return launch_one<T, 64>(a);
    case 128: return launch_one<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. k_len: a device pointer to
// one int32, the live key length, or null.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int sq, int sk, int d, int dtype,
                         int causal, float sm_scale, const void* k_len,
                         void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, bh, sq, sk, causal, sm_scale,
               static_cast<const int*>(k_len),
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return (int)launch_d<float>(d, a);
    case 1: return (int)launch_d<__half>(d, a);
    case 2: return (int)launch_d<__nv_bfloat16>(d, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 1 when this build runs dtype on the tensor-core kernel, else 0.
extern "C" int flash_fwd_tensor_cores(int dtype) {
  return (dtype == 1 || dtype == 2) && kTensorCores ? 1 : 0;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
