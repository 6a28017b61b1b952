// Fused backward of the Forward-Forward dense layer for Hopper (sm_90a),
// f32 FMA.
//
// With y = relu(x @ w + b) and g = sum_n y^2, the cotangents (dy_out, dg)
// of (y, g) combine into one post-activation gradient
//
//   dy = dy_out + 2 * y * dg[:, None]   where y > 0, else exactly 0
//
// and the layer's gradients are
//
//   dx = dy @ w^T  (M, K)     dw = x^T @ dy  (K, N)     db = sum_m dy  (N,)
//
// x (M, K), w (K, N), y and dy_out (M, N), dg (M,): contiguous, row-major,
// all f32.
//
// Replaces repro/kernels/ff_dense_vjp.py::ff_dense_bwd (the Pallas
// `_bwd_kernel`). Like it, this kernel never writes dy to device memory:
// every tile loader rebuilds its dy tile from y, dy_out and dg. The mask
// is a select, not a product: in the norm backward an all-dead row has
// g = 0 and a folded dg of 0/0 = NaN, and only a select drops it (the
// reference's jnp.where does the same).
//
// The TPU kernel walks a sequential (K/bk, M/bm) grid and carries dw and
// db across the inner M steps in resident output blocks. Hopper blocks
// run in parallel and in no order, so nothing carries over between them;
// and the two products reduce over different axes (dx over N, dw over M),
// so one block cannot hold both sums. Hence two launches:
//
//   1. grad_x: blocks over (K/64, M/64) output tiles of dx, each looping
//      over all of N. Its A tile is dy (rebuilt), its B tile is w read
//      transposed.
//   2. grad_w: blocks over (N/64, K/64) output tiles of dw, each looping
//      over all M rows in order (M <= 128 in training, so the loop is
//      short). Its A tile is x read transposed, its B tile is dy
//      (rebuilt). The blocks of K-tile 0 also sum their dy tiles'
//      columns, in row order, into db.
//
// Every output element has exactly one writer and every sum runs in a
// fixed order: no atomics, so the result is deterministic run to run.
// Ragged M, K and N edges are masked to zero in the loads and skipped in
// the stores; zero rows and columns add nothing to any product.
//
// Bound: at the training shapes (M in {64, 128}, K in {784, 2000},
// N = 2000) the two products do 4*M*K*N flops on ~36 MB at most, so the
// kernel is bound by the card's f32 FMA rate (67 TFLOP/s on an H100 SXM),
// not by memory. This first version multiplies in full f32 with FMA: no
// TF32, no tensor cores, no wgmma, no TMA. grad_x has only
// (M/64) * (K/64) blocks at training M (64 at M = 128, K = 2000), fewer
// than the 132 SMs; splitting its N loop is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // depth of one shared-memory stage (reduction)
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int PAD = 4;   // keeps tile rows 16-byte aligned, eases bank conflicts

static_assert((BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
              "tile loads must divide evenly among the threads");
static_assert(BN <= THREADS, "db needs one thread per tile column");

// dy at (m, n), rebuilt from y, dy_out and dg. A select, never a product
// with the mask: dg may be NaN on an all-dead row.
__device__ __forceinline__ float rebuild_dy(const float* __restrict__ y,
                                            const float* __restrict__ dy_out,
                                            const float* __restrict__ dg,
                                            int m, int n, int N) {
  const size_t i = (size_t)m * N + n;
  const float yv = y[i];
  return yv > 0.f ? dy_out[i] + 2.f * yv * dg[m] : 0.f;
}

// acc[i][j] += sum_kk As[kk][ty*TM + i] * Bs[kk][tx*TN + j]
__device__ __forceinline__ void tile_fma(const float (*As)[BM + PAD],
                                         const float (*Bs)[BN + PAD],
                                         float (&acc)[TM][TN], int ty,
                                         int tx) {
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
}

// dx (M, K) = dy (M, N) @ w^T. Block tile: rows m0.., columns k0..
__global__ void __launch_bounds__(THREADS)
grad_x(const float* __restrict__ w, const float* __restrict__ y,
       const float* __restrict__ dy_out, const float* __restrict__ dg,
       float* __restrict__ dx, int M, int K, int N) {
  __shared__ __align__(16) float As[BK][BM + PAD];   // dy tile, As[n][m]
  __shared__ __align__(16) float Bs[BK][BN + PAD];   // w tile,  Bs[n][k]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BN;

  float acc[TM][TN] = {};
  for (int n0 = 0; n0 < N; n0 += BK) {
    // Both operands have the reduction axis n contiguous: consecutive
    // threads read consecutive n of one row, stored transposed.
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gn = n0 + c;
      As[c][r] = (gm < M && gn < N) ? rebuild_dy(y, dy_out, dg, gm, gn, N)
                                    : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gk = k0 + r, gn = n0 + c;
      Bs[c][r] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gk = k0 + tx * TN + j;
      if (gm < M && gk < K) dx[(size_t)gm * K + gk] = acc[i][j];
    }
  }
}

// dw (K, N) = x^T @ dy; blocks of K-tile 0 also write db (N,) = sum_m dy.
// Block tile: rows k0.., columns n0..
__global__ void __launch_bounds__(THREADS)
grad_w(const float* __restrict__ x, const float* __restrict__ y,
       const float* __restrict__ dy_out, const float* __restrict__ dg,
       float* __restrict__ dw, float* __restrict__ db, int M, int K, int N) {
  __shared__ __align__(16) float As[BK][BM + PAD];   // x tile,  As[m][k]
  __shared__ __align__(16) float Bs[BK][BN + PAD];   // dy tile, Bs[m][n]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int k0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bool writes_db = blockIdx.y == 0;

  float acc[TM][TN] = {};
  float colsum = 0.f;   // db for column n0 + tid (tid < BN)
  for (int mb = 0; mb < M; mb += BK) {
    // The reduction axis m is the row: consecutive threads read
    // consecutive k (x) or n (dy) of one row, stored as they are.
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BM, c = idx % BM;
      const int gm = mb + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gm = mb + r, gn = n0 + c;
      Bs[r][c] = (gm < M && gn < N) ? rebuild_dy(y, dy_out, dg, gm, gn, N)
                                    : 0.f;
    }
    __syncthreads();
    if (writes_db && tid < BN) {
#pragma unroll
      for (int r = 0; r < BK; ++r) colsum += Bs[r][tid];
    }
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gk = k0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gk < K && gn < N) dw[(size_t)gk * N + gn] = acc[i][j];
    }
  }
  if (writes_db && tid < BN && n0 + tid < N) db[n0 + tid] = colsum;
}

}  // namespace

extern "C" {

// Two launches on `stream`: grad_x, then grad_w (which also writes db).
// Returns cudaGetLastError() after them (0 = success). Does not
// synchronise.
int ff_dense_bwd_launch(const void* x, const void* w, const void* y,
                        const void* dy_out, const void* dg, void* dx,
                        void* dw, void* db, int M, int K, int N,
                        void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* yf = static_cast<const float*>(y);
  const float* dyo = static_cast<const float*>(dy_out);
  const float* dgf = static_cast<const float*>(dg);

  const dim3 grid_x((K + BN - 1) / BN, (M + BM - 1) / BM);
  grad_x<<<grid_x, THREADS, 0, s>>>(wf, yf, dyo, dgf, static_cast<float*>(dx),
                                    M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid_w((N + BN - 1) / BN, (K + BM - 1) / BM);
  grad_w<<<grid_w, THREADS, 0, s>>>(xf, yf, dyo, dgf, static_cast<float*>(dw),
                                    static_cast<float*>(db), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
