// Device helpers the port's kernels share: cp.async copies into shared
// memory, and f32 products on the tensor cores as 3xTF32 on
// mma.sync.m16n8k8 (ff_dense.cu, mamba2_ssd.cu).
//
// 3xTF32: each f32 operand is split a_hi = tf32(a), a_lo = tf32(a - a_hi)
// and a.b is summed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; the dropped
// a_lo.b_lo and the rounding of a_lo are ~2^-22 relative.
//
// The tensor cores do not round their sums to nearest: an mma's result
// is truncated toward zero, a bias that a long chain of mma into one
// accumulator adds up in proportion to its depth (8e-6 of the output's
// scale over a 1024-deep chain on an H100; tests/tf32_emulation.py models
// it). So mma3_tile multiplies each 8-deep step into a fresh fragment,
// where the truncation is relative to the step's own sum, and adds that
// to the caller's accumulator with round-to-nearest f32 adds.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, zero-filled when !in (src is then unread).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// TF32 rounding of cvt.rna.tf32.f32 (nearest, ties away from zero) in
// two integer operations: add half a unit of the kept 10 mantissa bits to
// the magnitude, then clear the 13 dropped bits. The split runs for every
// fragment element a warp loads.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// A 16 x 8 (rows m, depth k) and an 8 x 8 (depth k, columns n) operand of
// mma.m16n8k8, each element split into TF32 hi and lo.
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

template <int NV>
__device__ __forceinline__ void split(const float (&v)[NV], uint32_t (&hi)[NV],
                                      uint32_t (&lo)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    hi[i] = tf32(v[i]);
    lo[i] = tf32(v[i] - __uint_as_float(hi[i]));
  }
}

// d (16 x 8) += a (16 x 8, row) . b (8 x 8, col), TF32 in, f32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d = a . b, TF32 in, f32 out, from a zero accumulator (no register of
// zeros to set up).
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}
// acc[mi][n0 + j] += a[mi] . b[n0 + j] for every mi and j < NJ, as
// 3xTF32: each pair's 8-deep step into a fresh fragment (the two small
// cross products first, then hi . hi), then one round-to-nearest add per
// element. The products issue by kind across the pairs (every lo . hi,
// then every hi . lo, then every hi . hi), so no mma waits on the one
// just before it; NJ bounds the fresh fragments alive at once (MI * NJ).
template <int MI, int NI, int NJ>
__device__ __forceinline__ void mma3_tile(float (&acc)[MI][NI][4],
                                          const FragA (&a)[MI],
                                          const FragB (&b)[NI], int n0) {
  float f[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mma_tf32_first(f[mi][j], a[mi].lo, b[n0 + j].hi);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(f[mi][j], a[mi].hi, b[n0 + j].lo);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(f[mi][j], a[mi].hi, b[n0 + j].hi);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][n0 + j][i] += f[mi][j][i];
}

}  // namespace
