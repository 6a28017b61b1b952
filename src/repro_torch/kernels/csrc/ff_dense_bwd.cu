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
// raw y and dy_out tiles arrive in shared memory, and dy is rebuilt there
// from them and dg before the products read it. The mask is a select, not
// a product: in the norm backward an all-dead row has g = 0 and a folded
// dg of 0/0 = NaN, and only a select drops it (the reference's jnp.where
// does the same).
//
// The TPU kernel walks a sequential (K/bk, M/bm) grid and carries dw and
// db across the inner M steps in resident output blocks. Hopper blocks
// run in parallel and in no order, so nothing carries over between them;
// and the two products reduce over different axes (dx over N, dw over M),
// so one block cannot hold both sums. Hence three launches:
//
//   1. grad_x: dx's N reduction split into S slices of L columns, so that
//      (K/64) * (M/128) * S blocks fill the card (the wrapper picks S:
//      256 blocks at M 128, K 2000, N 2000; the unsplit loop had 64 blocks
//      for 132 SMs). Each block writes its 128 x 64 partial into a scratch
//      of shape (S, M, K), 8 MB at that shape, which stays in the 50 MB L2.
//      Both operands have the reduction axis n contiguous, so each thread
//      reads 4 n at a time as float4s from rows of dy and of w and forms
//      its 8 x 8 outputs as dot products.
//   2. sum_slices: dx = the S partials summed in slice order.
//   3. grad_w: blocks over (N/64, K/128) tiles of dw, each looping over
//      all M rows in order (M <= 128 in training, so the loop is short).
//      x and dy tiles have the outputs' axes contiguous, so each thread
//      forms an 8 x 8 outer product per row from two float4s of each. The
//      blocks of K-tile 0 also sum their dy tiles' columns, in row order,
//      into db.
//
// Both products run 128 threads a block, 8 x 8 outputs a thread, and a
// 2-stage cp.async ring: the next stage's tiles are in flight while the
// current one is rebuilt and multiplied (a third stage timed no faster).
// grad_x fits three blocks on an SM (168 registers), grad_w four (128).
// Every output element has
// exactly one writer and every sum runs in a fixed order: no atomics, so
// the result is deterministic run to run. Ragged M, K and N edges are
// zero-filled in the loads and skipped in the stores; zero rows and
// columns add nothing to any product (a zero y gives dy = 0). Rows of 16
// bytes are copied as float4s when N and K are multiples of 4 and every
// such pointer is 16-byte aligned, else one float at a time.
//
// Bound: at the training shapes (M in {64, 128}, K in {784, 2000},
// N = 2000) the two products do 4*M*K*N flops on ~36 MB at most, so the
// kernel is bound by the card's f32 FMA rate (67 TFLOP/s on an H100 SXM,
// 0.031 ms at (128, 2000, 2000)), not by memory. It multiplies in full
// f32 with FMA: no TF32 or 3xTF32 tensor cores yet.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 128;   // 16 row groups x 8 column groups
constexpr int NS = 2;          // cp.async ring depth

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC floats global -> shared, zero-filled when !in (src is then unread).
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A ROWS x COLS tile at (row0, col0) of src (ld floats a row) into shared
// memory with SLD floats a row; what lies at or past (row_end, col_end) is
// zero-filled. With VEC = 4, col0 and col_end are multiples of 4.
template <int ROWS, int COLS, int SLD, int VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t ld, int row0, int row_end,
                                          int col0, int col_end, int tid) {
  constexpr int CPR = COLS / VEC;   // copies a row
#pragma unroll
  for (int e = tid; e < ROWS * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * VEC;
    const bool in = row0 + r < row_end && col0 + c < col_end;
    const float* g = in ? src + (size_t)(row0 + r) * ld + col0 + c : src;
    cp_async<VEC>(dst + r * SLD + c, g, in);
  }
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// dy from y, dy_out and dg. A select, never a product with the mask: dg
// may be NaN on an all-dead row.
__device__ __forceinline__ float rebuild_dy(float yv, float dyo, float dgv) {
  return yv > 0.f ? dyo + 2.f * yv * dgv : 0.f;
}

// ---------------------------------------------------------------------
// 1. grad_x: part[s] (M, K) = dy[:, slice s] @ w[:, slice s]^T.
namespace gx {
constexpr int BM = 128;     // rows of dx (m) a block
constexpr int BN = 64;      // columns of dx (k) a block
constexpr int BK = 16;      // depth (n) of one stage
constexpr int LD = BK + 4;  // LD / 4 odd: the 8 rows one float4 phase
                            // reads lie in 8 different bank groups
constexpr int STAGE = (2 * BM + BN) * LD;   // y, dy (over dy_out), w
constexpr size_t SMEM = (size_t)(NS * STAGE + BM) * sizeof(float);  // + dg
}  // namespace gx

template <int VEC>
__global__ void __launch_bounds__(THREADS, 3)
grad_x(const float* __restrict__ w, const float* __restrict__ y,
       const float* __restrict__ dy_out, const float* __restrict__ dg,
       float* __restrict__ part, int M, int K, int N, int L) {
  using namespace gx;
  extern __shared__ __align__(16) float smem[];
  float* dgs = smem + NS * STAGE;

  const int tid = threadIdx.x;
  const int tx = tid % 8;   // columns k0 + tx + 8j, j < 8
  const int ty = tid / 8;   // rows m0 + 8ty + i, i < 8
  const int m0 = blockIdx.y * BM;
  const int k0 = blockIdx.x * BN;
  const int n_begin = blockIdx.z * L;
  const int n_end = min(N, n_begin + L);
  const int n_tiles = (n_end - n_begin + BK - 1) / BK;

  for (int r = tid; r < BM; r += THREADS)
    dgs[r] = m0 + r < M ? dg[m0 + r] : 0.f;

  auto load = [&](int t) {
    float* st = smem + (t % NS) * STAGE;
    const int n0 = n_begin + t * BK;
    load_tile<BM, BK, LD, VEC>(st, y, N, m0, M, n0, n_end, tid);
    load_tile<BM, BK, LD, VEC>(st + BM * LD, dy_out, N, m0, M, n0, n_end,
                               tid);
    load_tile<BN, BK, LD, VEC>(st + 2 * BM * LD, w, N, k0, K, n0, n_end,
                               tid);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_async_commit();
  }

  float acc[8][8] = {};
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NS - 2>();   // stage t has landed ...
    __syncthreads();           // ... for every thread; stage t - 1 is done
    if (t + NS - 1 < n_tiles) load(t + NS - 1);
    cp_async_commit();
    float* st = smem + (t % NS) * STAGE;
    const float* Ys = st;
    float* Ds = st + BM * LD;
    const float* Ws = st + 2 * BM * LD;
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      Ds[r * LD + c] = rebuild_dy(Ys[r * LD + c], Ds[r * LD + c], dgs[r]);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BK; c += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Ds[(ty * 8 + i) * LD + c]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            &Ws[(tx + 8 * j) * LD + c]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float s = acc[i][j];
          s = fmaf(a[i].x, b.x, s);
          s = fmaf(a[i].y, b.y, s);
          s = fmaf(a[i].z, b.z, s);
          acc[i][j] = fmaf(a[i].w, b.w, s);
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block

  float* out = part + (size_t)blockIdx.z * M * K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + tx + 8 * j;
      if (k < K) out[(size_t)m * K + k] = acc[i][j];
    }
  }
}

// 2. dx = sum_s part[s], in slice order; VEC elements a thread.
template <int VEC>
__global__ void sum_slices(const float* __restrict__ part,
                           float* __restrict__ dx, int S, size_t MK) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const V* p = reinterpret_cast<const V*>(part);
  const size_t n = MK / VEC;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    V acc = p[i];
#pragma unroll 4
    for (int s = 1; s < S; ++s) acc = add(acc, p[s * n + i]);
    reinterpret_cast<V*>(dx)[i] = acc;
  }
}

// ---------------------------------------------------------------------
// 3. grad_w: dw (K, N) = x^T @ dy; blocks of K-tile 0 also write
//    db (N,) = sum_m dy.
namespace gw {
constexpr int BM = 128;   // rows of dw (k) a block
constexpr int BN = 64;    // columns of dw (n) a block
constexpr int BK = 16;    // rows of x and dy (m) a stage
constexpr int STAGE = BK * (BM + 2 * BN) + BK;   // x, y, dy (over dy_out), dg
constexpr size_t SMEM = (size_t)NS * STAGE * sizeof(float);
}  // namespace gw

template <int VEC>
__global__ void __launch_bounds__(THREADS, 4)
grad_w(const float* __restrict__ x, const float* __restrict__ y,
       const float* __restrict__ dy_out, const float* __restrict__ dg,
       float* __restrict__ dw, float* __restrict__ db, int M, int K, int N) {
  using namespace gw;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int tx = tid % 8;   // columns n0 + {4tx, 32 + 4tx} + j, j < 4
  const int ty = tid / 8;   // rows k0 + {4ty, 64 + 4ty} + i, i < 4
  const int k0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bool writes_db = blockIdx.y == 0;
  const int m_tiles = (M + BK - 1) / BK;

  auto load = [&](int t) {
    float* st = smem + (t % NS) * STAGE;
    const int mb = t * BK;
    load_tile<BK, BM, BM, VEC>(st, x, K, mb, M, k0, K, tid);
    load_tile<BK, BN, BN, VEC>(st + BK * BM, y, N, mb, M, n0, N, tid);
    load_tile<BK, BN, BN, VEC>(st + BK * (BM + BN), dy_out, N, mb, M, n0, N,
                               tid);
    load_tile<BK, 1, 1, 1>(st + BK * (BM + 2 * BN), dg, 1, mb, M, 0, 1, tid);
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < m_tiles) load(s);
    cp_async_commit();
  }

  float acc[8][8] = {};
  float colsum = 0.f;   // db for column n0 + tid (tid < BN)
  for (int t = 0; t < m_tiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (t + NS - 1 < m_tiles) load(t + NS - 1);
    cp_async_commit();
    float* st = smem + (t % NS) * STAGE;
    const float* Xs = st;
    const float* Ys = st + BK * BM;
    float* Ds = st + BK * (BM + BN);
    const float* dgs = st + BK * (BM + 2 * BN);
    for (int e = tid; e < BK * BN; e += THREADS)
      Ds[e] = rebuild_dy(Ys[e], Ds[e], dgs[e / BN]);
    __syncthreads();
    if (writes_db && tid < BN) {
#pragma unroll
      for (int r = 0; r < BK; ++r) colsum += Ds[r * BN + tid];
    }
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[r * BM + 4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Xs[r * BM + 64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ds[r * BN + 4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Ds[r * BN + 32 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (k >= K) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = n0 + hf * 32 + 4 * tx;
      float* dst = dw + (size_t)k * N + n;
      if (VEC == 4) {
        if (n < N)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][4 * hf], acc[i][4 * hf + 1],
                          acc[i][4 * hf + 2], acc[i][4 * hf + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) dst[j] = acc[i][4 * hf + j];
      }
    }
  }
  if (writes_db && tid < BN && n0 + tid < N) db[n0 + tid] = colsum;
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int VEC>
cudaError_t launch(const float* x, const float* w, const float* y,
                   const float* dyo, const float* dg, float* dx, float* dw,
                   float* db, float* part, int M, int K, int N, int S, int L,
                   int parts, cudaStream_t s) {
  cudaError_t err;
  if (parts & 1) {
    if ((err = allow_smem(grad_x<VEC>, gx::SMEM)) != cudaSuccess) return err;
    const dim3 grid((K + gx::BN - 1) / gx::BN, (M + gx::BM - 1) / gx::BM, S);
    grad_x<VEC><<<grid, THREADS, gx::SMEM, s>>>(w, y, dyo, dg, part, M, K, N,
                                                L);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 2) {
    // K % 4 == 0 with VEC = 4, so M * K is a multiple of 4 too
    const size_t MK = (size_t)M * K, n = (MK / VEC + 255) / 256;
    const int blocks = static_cast<int>(n < 132 * 8 ? n : 132 * 8);
    sum_slices<VEC><<<blocks, 256, 0, s>>>(part, dx, S, MK);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 4) {
    if ((err = allow_smem(grad_w<VEC>, gw::SMEM)) != cudaSuccess) return err;
    const dim3 grid((N + gw::BN - 1) / gw::BN, (K + gw::BM - 1) / gw::BM);
    grad_w<VEC><<<grid, THREADS, gw::SMEM, s>>>(x, y, dyo, dg, dw, db, M, K,
                                                N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Three launches on `stream`, those whose bit is set in `parts`: 1
// grad_x (into part, S slices of L columns of N), 2 sum_slices (part ->
// dx), 4 grad_w (dw and db); the wrapper passes 7. part holds S * M * K
// floats. Returns cudaGetLastError() after them (0 = success). Does not
// synchronise.
int ff_dense_bwd_launch(const void* x, const void* w, const void* y,
                        const void* dy_out, const void* dg, void* dx,
                        void* dw, void* db, void* part, int M, int K, int N,
                        int S, int L, int parts, void* stream) {
  // the slices must be non-empty, stage-aligned and cover N exactly
  if (M <= 0 || K <= 0 || N <= 0 || S <= 0 || S > 65535 || L <= 0 ||
      L % gx::BK || (long long)(S - 1) * L >= N || (long long)S * L < N)
    return static_cast<int>(cudaErrorInvalidValue);
  // the operands read, and dw, dx and part written, as float4s
  const void* ptrs[] = {x, w, y, dy_out, dw, dx, part};
  bool vec4 = N % 4 == 0 && K % 4 == 0;
  for (const void* p : ptrs) vec4 = vec4 && aligned16(p);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec4 ? launch<4>(f(x), f(w), f(y), f(dy_out), f(dg), o(dx), o(dw),
                       o(db), o(part), M, K, N, S, L, parts, s)
           : launch<1>(f(x), f(w), f(y), f(dy_out), f(dg), o(dx), o(dw),
                       o(db), o(part), M, K, N, S, L, parts, s);
  return static_cast<int>(err);
}

}  // extern "C"
