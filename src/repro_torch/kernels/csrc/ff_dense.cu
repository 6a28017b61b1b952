// Fused Forward-Forward dense layer for Hopper (sm_90a), on the tensor
// cores as 3xTF32.
//
//   y = relu(x @ w + b)   accumulated in f32, stored in x's dtype
//   g = sum_n y^2         f32, from the f32 y before the store
//   norm != 0:  y <- y / (sqrtf(g) + 1e-8), g stays the raw goodness
//
// x (M, K), w (K, N), b (N,): contiguous, row-major, all f32 or all bf16.
//
// Replaces repro/kernels/ff_dense.py::ff_dense (the Pallas `_kernel` and
// `_kernel_norm`, sharing `_tile_y_g`). That TPU kernel walks N in order
// and carries g across the N steps in a resident output block; with
// norm it keeps the whole (bm, N) row of y in VMEM and divides it on the
// last step. Neither carries over: Hopper blocks run in parallel and in
// no order. And at the training M (64 or 128 rows) an (M/128) x (N/64)
// grid of output tiles is 32 blocks for 132 SMs. So the work is split in
// two launches:
//
//   1. gemm_split: K is cut into S slices of L (a multiple of the stage
//      depth; the wrapper picks S so that tiles x S comes near 256
//      blocks: S = 8 at (128, 2000, 2000), 3 at M = 640). Each block
//      multiplies one 128 x BN output tile over its slice and writes the
//      f32 product into part[s] of an (S, M, N) scratch (8 MB at the
//      training shape, which stays in the 50 MB L2). BN is 64, or 128
//      where the 64-wide tiles alone number 128 or more (M = 640): the
//      wider tile reads each x tile half as often. Warps of 64 x 32, four
//      or eight (a warp whose rows all lie past M multiplies nothing); x
//      and w tiles land in shared memory through a 3-stage cp.async ring
//      of 16-byte copies (32 deep in K).
//   2. finish_rows: one block per row sums the S partials in slice order,
//      adds b, applies relu, stores y, reduces y^2 into g in a fixed
//      order, and with norm divides the row. No atomics anywhere: a
//      second call gives bit-identical outputs.
//
// The products run on the tensor cores, mma.sync.m16n8k8 with TF32
// operands and f32 accumulation, as 3xTF32 (tc_common.cuh): each f32
// operand is split a_hi = tf32(a), a_lo = tf32(a - a_hi) and a.b is
// summed as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, ~2^-22 relative. The
// tensor cores truncate each mma's sum toward zero; chained into one
// accumulator over a 1024-deep slice that bias reached 8e-6 of y's scale
// on an H100, so each 8-deep step is multiplied into a fresh fragment
// and added to the accumulator to nearest. bf16 operands are exact in
// TF32 (8 bits of mantissa inside 10), so they take the a_hi.b_hi
// product alone, straight into the accumulator: their tolerance is the
// bf16 rounding of y. mma.sync, not wgmma: TF32 wgmma needs both
// operands K-major in shared memory, and w (K, N) is N-major.
//
// Bound: the function does 2*M*K*N products; as 3xTF32 at the H100's
// 495 TFLOP/s of dense TF32 that is 0.0062 ms at (128, 2000, 2000)
// (0.031 ms at M = 640), against 18 MB of operands at 3.35 TB/s
// (0.0054 ms), so operations bound it; at the f32 FMA rate (67 TFLOP/s)
// it would be 0.0153 ms.
//
// The ragged edges of M, N and K are zero-filled in the loads and
// masked in the stores. Tiles move as 16-byte cp.async copies when x and
// w are f32, K and N are multiples of 4 and every pointer is 16-byte
// aligned; otherwise (bf16, ragged shapes) each thread loads single
// elements through registers, widened to f32 in shared memory.
//
// bf16 with norm: phase 2 rereads the already rounded bf16 y and rounds
// the quotient again. The reference does the same (ff_dense_norm_ref
// divides y.astype(x.dtype); the Pallas kernel rereads its y output
// block), so this double rounding is the reference's own op order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tc_common.cuh"

namespace {

constexpr int BM = 128;     // rows of x per block
constexpr int BK = 32;      // depth (k) of one ring stage
constexpr int NS = 3;       // cp.async ring depth
constexpr int WM = 64;      // rows of a warp's tile
constexpr int WN = 32;      // columns of a warp's tile
constexpr int WARPS_M = BM / WM;
constexpr int MI = WM / 16;   // m16 fragments of a warp's tile
constexpr int NI = WN / 8;    // n8 fragments of a warp's tile
constexpr int FRESH_NJ = 2;   // n8 fragments a 3xTF32 step spans at once
constexpr int LDA = BK + 4;   // x tile row: 36 = 4 mod 32, so a fragment
                              // read (8 rows x 4 k) hits 32 banks
constexpr int A_TILE = BM * LDA;
constexpr int FINISH_THREADS = 256;
constexpr float NORM_EPS = 1e-8f;

// gemm_split's shape for a block tile BN columns wide (64 or 128).
template <int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int THREADS = 32 * WARPS_M * (BN / WN);
  // blocks an SM holds: two of four warps (registers, smem); one of
  // eight, since two would cap a thread at 128 registers, which spills
  static constexpr int MIN_BLOCKS = BN == 64 ? 2 : 1;
  static constexpr int LDB = BN + 8;   // w tile row: 72 or 136 = 8 mod 32
                                       // (a fragment reads 4 k x 8 n)
  static constexpr int STAGE = A_TILE + BK * LDB;
  static constexpr size_t SMEM = (size_t)NS * STAGE * sizeof(float);
  static_assert(BM * BK / 4 % THREADS == 0 && BK * BN / 4 % THREADS == 0,
                "16-byte tile copies must divide evenly among the threads");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Launch 1: part[z] (M, N) = x[:, slice z] @ w[slice z, :], slice z =
// [z * L, min((z + 1) * L, K)). VEC: f32 tiles by 16-byte cp.async.
template <typename T, bool VEC, int BN>
__global__ void __launch_bounds__(Tile<BN>::THREADS, Tile<BN>::MIN_BLOCKS)
gemm_split(const T* __restrict__ x, const T* __restrict__ w,
           float* __restrict__ part, int M, int K, int N, int L) {
  using TL = Tile<BN>;
  constexpr int THREADS = TL::THREADS, LDB = TL::LDB, STAGE = TL::STAGE;
  constexpr bool SPLIT = std::is_same<T, float>::value;   // 3xTF32
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;      // the mma fragment coordinates
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;   // warp tile: rows
                                                      // wm * WM, columns
                                                      // wn * WN
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * L;
  const int k_end = min(K, k_begin + L);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  // a warp whose rows all lie past M (M = 64 leaves half the tile) loads
  // its share of the tiles but multiplies nothing
  const bool active = m0 + wm * WM < M;

  auto load = [&](int t) {
    float* As = smem + (t % NS) * STAGE;
    float* Bs = As + A_TILE;
    const int k0 = k_begin + t * BK;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const bool in = m0 + r < M && k0 + c < k_end;
        cp_async16(As + r * LDA + c,
                   in ? x + (size_t)(m0 + r) * K + k0 + c : x, in);
      }
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        const bool in = k0 + r < k_end && n0 + c < N;
        cp_async16(Bs + r * LDB + c,
                   in ? w + (size_t)(k0 + r) * N + n0 + c : w, in);
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        As[r * LDA + c] = m0 + r < M && k0 + c < k_end
                              ? to_f32(x[(size_t)(m0 + r) * K + k0 + c])
                              : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        Bs[r * LDB + c] = k0 + r < k_end && n0 + c < N
                              ? to_f32(w[(size_t)(k0 + r) * N + n0 + c])
                              : 0.f;
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }

  float acc[MI][NI][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NS - 2>();   // stage t has landed ...
    __syncthreads();           // ... for every thread; stage t - 1 is done
    if (t + NS - 1 < n_tiles) load(t + NS - 1);
    cp_async_commit();
    if (!active) continue;
    const float* As = smem + (t % NS) * STAGE;
    const float* Bs = As + A_TILE;
    // unrolled by two, not four: a full unroll hoists all four steps'
    // fragments and spills
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 8) {
      FragA a[MI];
      FragB b[NI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        // a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
        const float* p = As + (wm * WM + mi * 16 + g) * LDA + kk + q;
        const float v[4] = {p[0], p[8 * LDA], p[4], p[8 * LDA + 4]};
        if constexpr (SPLIT) {
          split(v, a[mi].hi, a[mi].lo);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[mi].hi[i] = __float_as_uint(v[i]);   // exact: from bf16
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        // b0 (k q, n g), b1 (k q + 4, n g)
        const float* p = Bs + (kk + q) * LDB + wn * WN + ni * 8 + g;
        const float v[2] = {p[0], p[4 * LDB]};
        if constexpr (SPLIT) {
          split(v, b[ni].hi, b[ni].lo);
        } else {
          b[ni].hi[0] = __float_as_uint(v[0]);
          b[ni].hi[1] = __float_as_uint(v[1]);
        }
      }
      if constexpr (SPLIT) {
#pragma unroll
        for (int n0 = 0; n0 < NI; n0 += FRESH_NJ)
          mma3_tile<MI, NI, FRESH_NJ>(acc, a, b, n0);
      } else {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            mma_tf32(acc[mi][ni], a[mi].hi, b[ni].hi);
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (!active) return;

  // c0, c1 at (row g, columns 2q, 2q + 1); c2, c3 at row g + 8.
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + mi * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = n0 + wn * WN + ni * 8 + 2 * q;
        float* dst = out + (size_t)m * N + n;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (VEC) {   // N even: n < N means n + 1 < N too
          if (n < N) *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (n < N) dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        }
      }
    }
}

// Launch 2: one block per row. VEC: four columns a thread at a time.
template <typename T, int VEC>
__global__ void __launch_bounds__(FINISH_THREADS)
finish_rows(const float* __restrict__ part, const T* __restrict__ b,
            T* __restrict__ y, float* __restrict__ g, int M, int N, int S,
            int norm) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  __shared__ float warp_sums[FINISH_THREADS / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const size_t MN = (size_t)M * N;
  const float* p = part + (size_t)row * N;
  T* yr = y + (size_t)row * N;

  float sq = 0.f;
  for (int n = tid * VEC; n < N; n += FINISH_THREADS * VEC) {
    if constexpr (VEC == 4) {
      float4 v = *reinterpret_cast<const V*>(p + n);
      for (int s = 1; s < S; ++s) {
        const float4 u = *reinterpret_cast<const V*>(p + s * MN + n);
        v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
      }
      const float4 bv = *reinterpret_cast<const float4*>(b + n);
      v = make_float4(fmaxf(v.x + bv.x, 0.f), fmaxf(v.y + bv.y, 0.f),
                      fmaxf(v.z + bv.z, 0.f), fmaxf(v.w + bv.w, 0.f));
      sq += v.x * v.x;
      sq += v.y * v.y;
      sq += v.z * v.z;
      sq += v.w * v.w;
      *reinterpret_cast<float4*>(yr + n) = v;
    } else {
      float v = p[n];
      for (int s = 1; s < S; ++s) v += p[s * MN + n];
      v = fmaxf(v + to_f32(b[n]), 0.f);
      sq += v * v;
      yr[n] = from_f32<T>(v);
    }
  }
  // fixed-order block sum: an xor tree in each warp, then the warp sums
  // in warp order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (tid % 32 == 0) warp_sums[tid / 32] = sq;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < FINISH_THREADS / 32; ++i) total += warp_sums[i];
  if (tid == 0) g[row] = total;

  if (norm) {
    // A dead row (g == 0) divides 0 by NORM_EPS: zeros, never NaN. Each
    // thread rereads only what it wrote.
    const float denom = sqrtf(total) + NORM_EPS;
    for (int n = tid * VEC; n < N; n += FINISH_THREADS * VEC) {
      if constexpr (VEC == 4) {
        float4 v = *reinterpret_cast<const float4*>(yr + n);
        *reinterpret_cast<float4*>(yr + n) =
            make_float4(v.x / denom, v.y / denom, v.z / denom, v.w / denom);
      } else {
        yr[n] = from_f32<T>(to_f32(yr[n]) / denom);
      }
    }
  }
}

template <typename T, bool VEC, int BN>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   void* g, void* part, int M, int K, int N, int S, int L,
                   int norm, int parts, cudaStream_t stream) {
  cudaError_t err;
  if (parts & 1) {
    using TL = Tile<BN>;
    err = cudaFuncSetAttribute(gemm_split<T, VEC, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(TL::SMEM));
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, S);
    gemm_split<T, VEC, BN><<<grid, TL::THREADS, TL::SMEM, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<float*>(part), M, K, N, L);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 2) {
    finish_rows<T, VEC ? 4 : 1><<<M, FINISH_THREADS, 0, stream>>>(
        static_cast<const float*>(part), static_cast<const T*>(b),
        static_cast<T*>(y), static_cast<float*>(g), M, N, S, norm);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, bool VEC>
cudaError_t launch_bn(int bn, const void* x, const void* w, const void* b,
                      void* y, void* g, void* part, int M, int K, int N,
                      int S, int L, int norm, int parts, cudaStream_t stream) {
  return bn == 128 ? launch<T, VEC, 128>(x, w, b, y, g, part, M, K, N, S, L,
                                         norm, parts, stream)
                   : launch<T, VEC, 64>(x, w, b, y, g, part, M, K, N, S, L,
                                        norm, parts, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. part holds S * M * N floats; K is cut
// into S slices of L (a multiple of 32; non-empty, covering K exactly);
// bn (64 or 128) is gemm_split's block width. Launches the parts whose
// bit is set (1 gemm_split, 2 finish_rows; the wrapper passes 3) on
// `stream` and returns cudaGetLastError() after them (0 = success). Does
// not synchronise.
int ff_dense_launch(const void* x, const void* w, const void* b, void* y,
                    void* g, void* part, int M, int K, int N, int S, int L,
                    int bn, int norm, int dtype, int parts, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || M > 65535 * BM || S <= 0 || S > 65535 ||
      L <= 0 || L % BK || (long long)(S - 1) * L >= K ||
      (long long)S * L < K || (bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const void* ptrs[] = {x, w, b, y, part};
      bool vec = K % 4 == 0 && N % 4 == 0;
      for (const void* p : ptrs) vec = vec && aligned16(p);
      return static_cast<int>(
          vec ? launch_bn<float, true>(bn, x, w, b, y, g, part, M, K, N, S,
                                       L, norm, parts, s)
              : launch_bn<float, false>(bn, x, w, b, y, g, part, M, K, N, S,
                                        L, norm, parts, s));
    }
    case 1:
      return static_cast<int>(launch_bn<__nv_bfloat16, false>(
          bn, x, w, b, y, g, part, M, K, N, S, L, norm, parts, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ff_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
