// Tensor-core building blocks shared by flash_fwd.cu and flash_bwd.cu (sm_90a).
//
// f16 and bf16: mma.sync m16n8k16 from ldmatrix fragments, f32 accumulate.
// Fragment layouts (PTX ISA, mma.m16n8k16), lane = 4 * g + t:
//   A (16 x 16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//                a3 = (g+8, 2t+8..);
//   B (16 x 8):  b0 = (2t..2t+1, g), b1 = (2t+8.., g);
//   C (16 x 8):  c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// So the C fragments of two neighbouring 8-column tiles are, packed in
// pairs, the A fragment of one 16-deep step.
//
// Tiles sit in shared memory in the input type as [rows][D + 8]: the 8
// elements of padding put the 8 rows an ldmatrix phase reads in different
// banks. The build key of ops/_build.py covers this header, so an edit here
// rebuilds every source that includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

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

}  // namespace
