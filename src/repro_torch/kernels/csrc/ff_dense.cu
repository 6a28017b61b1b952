// Fused Forward-Forward dense layer for Hopper (sm_90a), f32 FMA.
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
// no order, and an f32 row at N = 2000 fits in 227 KB of shared memory
// only for bm <= ~16, which at the serving M = 640 leaves 40 blocks for
// 132 SMs. So the work is split in two launches:
//
//   1. gemm_relu_gpart: a shared-memory tiled GEMM over (N/64, M/64)
//      blocks, 256 threads each computing a 4x4 patch with f32 FMA. The
//      epilogue adds b, applies relu, stores y, and reduces each row's y^2
//      over the block's 64 columns into gpart[n_block][row]. No atomics:
//      every partial has one writer, so g is deterministic.
//   2. finish_rows: one warp per row sums gpart in a fixed order into g
//      and, with norm, divides its row of y in place.
//
// The ragged edges of M, N and K are masked in the loads and stores.
//
// Bound: at the serving shapes (M = 640, K in {784, 2000}, N = 2000) the
// GEMM does 2*M*K*N flops on ~26 MB of operands, so it is bound by the
// card's f32 FMA rate (67 TFLOP/s on an H100 SXM), not by memory. This
// first version uses no tensor cores, no TF32, no wgmma and no TMA: f32
// inputs are multiplied in full f32. Those are later work.
//
// bf16: operands are widened to f32 in shared memory, so products are
// exact and sums are f32, as jnp.dot(preferred_element_type=f32) does.
// With norm, phase 2 rereads the already rounded bf16 y and rounds the
// quotient again. The reference does the same (ff_dense_norm_ref divides
// y.astype(x.dtype); the Pallas kernel rereads its y output block), so
// this double rounding is the reference's own op order, not an error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;   // rows of x per block
constexpr int BN = 64;   // columns of w per block
constexpr int BK = 16;   // depth of one shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int APAD = 4;  // keeps As rows 16-byte aligned, eases bank conflicts
constexpr int FINISH_THREADS = 256;              // 8 rows per block
constexpr float NORM_EPS = 1e-8f;

static_assert(BN / TN == 16, "the row reduction shuffles across 16 lanes");
static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
              "tile loads must divide evenly among the threads");

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_relu_gpart(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ b, T* __restrict__ y,
                float* __restrict__ gpart, int M, int K, int N) {
  __shared__ __align__(16) float As[BK][BM + APAD];   // x tile, As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];          // w tile, Bs[k][n]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // column group: 16 per row group
  const int ty = tid / (BN / TN);   // row group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: consecutive threads read consecutive k of one row.
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    // w tile: consecutive threads read consecutive n of one row.
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f32(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue. Columns past N hold 0 (w and b masked to 0), so relu keeps
  // them at 0 and they add nothing to the row sums.
  float bias[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    bias[j] = gn < N ? to_f32(b[gn]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      const float v = fmaxf(acc[i][j] + bias[j], 0.f);
      sq += v * v;
      if (gm < M && gn < N) y[(size_t)gm * N + gn] = from_f32<T>(v);
    }
    // The 16 threads of one row group are 16 consecutive lanes of one
    // warp; a fixed xor tree sums their partials.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (tx == 0 && gm < M) gpart[(size_t)blockIdx.x * M + gm] = sq;
  }
}

template <typename T>
__global__ void __launch_bounds__(FINISH_THREADS)
finish_rows(T* __restrict__ y, const float* __restrict__ gpart,
            float* __restrict__ g, int M, int N, int n_blocks, int norm) {
  const int row = (blockIdx.x * FINISH_THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;   // whole warps leave together

  float s = 0.f;
  for (int j = lane; j < n_blocks; j += 32) s += gpart[(size_t)j * M + row];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) g[row] = s;

  if (norm) {
    // A dead row (g == 0) divides 0 by NORM_EPS: zeros, never NaN.
    const float denom = sqrtf(s) + NORM_EPS;
    T* yr = y + (size_t)row * N;
    for (int n = lane; n < N; n += 32) yr[n] = from_f32<T>(to_f32(yr[n]) / denom);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   void* g, void* gpart, int M, int K, int N, int norm,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_relu_gpart<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(gpart), M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows_per_block = FINISH_THREADS / 32;
  finish_rows<T><<<(M + rows_per_block - 1) / rows_per_block, FINISH_THREADS,
                   0, stream>>>(static_cast<T*>(y),
                                static_cast<const float*>(gpart),
                                static_cast<float*>(g), M, N, grid.x, norm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns of w per phase-1 block: gpart must hold ceil(N / this) x M f32.
int ff_dense_block_n() { return BN; }

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// two launches on `stream` (0 = success). Does not synchronise.
int ff_dense_launch(const void* x, const void* w, const void* b, void* y,
                    void* g, void* gpart, int M, int K, int N, int norm,
                    int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, w, b, y, g, gpart, M, K, N, norm, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, w, b, y, g, gpart, M, K, N, norm, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* ff_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
