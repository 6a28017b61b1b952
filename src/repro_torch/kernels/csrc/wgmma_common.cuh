// Device helpers of the bf16 attention kernels (flash_attention.cu's
// forward, flash_attention_bwd.cu's backward): bf16 tiles in shared memory
// in wgmma's 128-byte swizzle, filled by cp.async, and Hopper's warpgroup
// products (wgmma) on them with f32 accumulation.
//
// A tile of ROWS rows is kept as 64-column panels; a panel is both the
// K-major operand (rows = M or N, 64 contiguous k) and the MN-major one
// (rows = k, 64 contiguous n). An m64nNk16 accumulator holds, in thread
// (warp w, lane 4 g + tig), element d[4 j + e] at row 16 w + g + 8 (e / 2)
// and column 8 j + 2 tig + e % 2; over 16 columns that is wgmma's A
// fragment layout, so a product's result feeds the next product from
// registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tc_common.cuh"

namespace {
namespace wg {

using bf16 = __nv_bfloat16;

// hd rounded up to whole 64-column groups (120 -> 128): rows are kept in
// shared memory padded with zero columns, which add nothing to a product
// over hd and give output columns that are not stored.
template <int HD>
__host__ __device__ constexpr int padded() {
  return (HD + 63) / 64 * 64;
}

// Element (r, c) of a ROWS-row tile kept as 64-column panels, each in
// wgmma's 128-byte-swizzle layout: 128-byte rows whose 16-byte chunks are
// XORed with r % 8 (the bank groups of 8 rows differ).
template <int ROWS>
__device__ __forceinline__ int sw(int r, int c) {
  return (c >> 6) * (ROWS * 64) + r * 64 +
         ((((c & 63) >> 3) ^ (r & 7)) << 3) + (c & 7);
}

// 16 bytes global -> shared (a shared-space address: the panels are
// swizzled), zero-filled when !in (src is then unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
// Makes this thread's landed copies visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A ROWS x HD tile from rows row0.. of src (stride elements apart) into
// swizzled panels padded to padded<HD>() columns, by NT threads; rows at
// or past `rows` and the pad columns are zero-filled.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int rows,
                                          int tid) {
  constexpr int CPR = padded<HD>() / 8;   // 16-byte chunks a padded row
#pragma unroll
  for (int e = tid; e < ROWS * CPR; e += NT) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool in = row0 + r < rows && c < HD;
    const bf16* g = in ? src + (size_t)(row0 + r) * stride + c : src;
    cp_async16(smem_u32(dst + sw<ROWS>(r, c)), g, in);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (K-major: sbo = 1024 between 8-row
// groups, lbo unused; MN-major: sbo = 1024 between 8-k groups, lbo
// between 64-column panels).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem, K-major).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// d (64 x 128) += A (64 x 16, registers) . B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// o (64 x HP) += A (64 x 16, registers) . B (rows 16kk.. of a ROWS-row
// tile, smem, MN-major): one m64n64k16 at HP 64, one m64n128k16 per 128
// columns above (two at HP 256, each on its half of o and of B's panels).
template <int HP, int ROWS>
__device__ __forceinline__ void wgmma_pv(float (&o)[HP / 2],
                                         const uint32_t (&a)[4],
                                         const bf16* Bt, int kk) {
  if constexpr (HP == 64) {
    wgmma_rs_n64(o, a, desc(Bt + sw<ROWS>(kk * 16, 0), ROWS * 128, 1024));
  } else {
    static_assert(HP % 128 == 0, "P.V takes 64 or a multiple of 128 columns");
#pragma unroll
    for (int n0 = 0; n0 < HP; n0 += 128)
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + n0 / 2), a,
                    desc(Bt + sw<ROWS>(kk * 16, n0), ROWS * 128, 1024));
  }
}

// 2^x on the MUFU unit (relative error ~2^-22; -inf gives +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> the bf16 pairs hi = bf16(x, y) and lo = bf16((x, y) - hi).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// The A fragments (hi, lo) of the 16 columns 16kk.. of a 64 x 64
// accumulator: fragment j holds row g + 8 (j % 2), columns 16kk + 8 (j / 2)
// + 2 tig and + 1.
__device__ __forceinline__ void split_frag(const float (&s)[32], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    split_pair(s[4 * (2 * kk + j / 2) + 2 * (j % 2)],
               s[4 * (2 * kk + j / 2) + 2 * (j % 2) + 1], hi[j], lo[j]);
}

}  // namespace wg
}  // namespace
