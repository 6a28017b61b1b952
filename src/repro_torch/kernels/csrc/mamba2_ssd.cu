// Chunked Mamba-2 SSD scan for Hopper (sm_90a), f32 FMA.
//
// Per chunk of L steps of one sequence and head (cums = cumsum(dA)):
//   y[i]  = sum_{j<=i} (c_i . b_j) exp(cums_i - cums_j) xbar_j
//           + (c_i . h) exp(cums_i)                  (carried state h)
//   h    <- h exp(cums_{L-1}) + sum_j exp(cums_{L-1} - cums_j) b_j xbar_j
//
// xbar (B, S, H, hd), dA (B, S, H), b and c (B, S, N): contiguous f32.
// Outputs y (B, S, H, hd) and the final state hT (B, H, hd, N), f32.
//
// Replaces repro/kernels/mamba2_ssd.py::mamba2_ssd (the Pallas
// `_kernel`). That TPU kernel runs a sequential (B, nc) grid and keeps
// the whole (H, hd, N) state of a sequence in VMEM across the chunk
// steps, forming the (L, L, H) decay in VMEM. Neither carries over: at
// mamba2-780m's H 48, hd 64, N 128 the state is 1.5 MB and the decay
// 12 MB, against 227 KB of shared memory per block, and Hopper blocks
// run in parallel in no order. What the design uses instead:
//
//   * Heads are independent (dA, xbar and the state are per head; b and
//     c are shared, n_groups = 1), and so are the rows of a head's state
//     along hd (y[., d] reads only h[d, :]). Launch 2 runs one block per
//     (16-wide slice of hd, head, sequence): 4 x 48 x 4 = 768 blocks at
//     the mamba2-780m prefill for 132 SMs. Each carries its (16, N) f32
//     slice of the state (8 KB at N = 128) across the chunks in order,
//     in registers, with a copy in shared memory for the c . h products.
//   * The scores c_i . b_j are the same for every head and slice, so
//     launch 1 forms them once per (sequence, chunk): a 64 x 64-tile f32
//     GEMM over N into a (B * nc, L, L) scratch, lower-triangle tiles
//     only (8 MB at B 4, S 2048, L 256; read back from L2).
//   * The (L, L) decay is never stored: launch 2 forms
//     W = scores * exp(cums_i - cums_j) for j <= i in 32-column tiles in
//     shared memory and multiplies them into the block's 16 columns of
//     xbar; k tiles of W wholly above the diagonal are not formed.
//   * b and c stream through shared memory in 32-wide tiles.
//   * cums is a warp scan in shared memory; every sum runs in a fixed
//     order, with no atomics, so the results are deterministic.
//   * A ragged last chunk (S % L != 0) is read as zero rows (dA = 0,
//     xbar = b = c = 0), which add nothing to y or the state: the padding
//     the reference's model path applies (dt = 0 rows are inert).
//
// Bound: at the mamba2-780m prefill (B 4, S 2048, H 48, hd 64, N 128,
// L 256) the work is ~19.6 GFLOP (inter-chunk and state products
// 2 * 2 * B*S*H*hd*N = 12.9, intra-chunk 2 * B*H*nc * L(L+1)/2 * hd = 6.5,
// scores 2 * B*nc * L(L+1)/2 * N = 0.3) on ~218 MB of xbar, y and the
// rest, so operations bound it: 0.29 ms at the H100's 67 TFLOP/s of f32
// FMA. This first version uses f32 FMA only: no tensor cores, no TMA, no
// cp.async pipelining.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int DS = 16;        // hd slice per block of launch 2
constexpr int JT = 32;        // width of the streamed W, c and b tiles
constexpr int WLD = JT + 1;   // padded row of the W and c tiles
constexpr int CB_TILE = 64;   // launch 1: scores tile
constexpr int CB_K = 16;      // launch 1: depth of one N stage
constexpr unsigned FULL = 0xffffffffu;

// Launch 1: cb[bc, i, j] = sum_n c[b, t0 + i, n] * b[b, t0 + j, n] for the
// 64 x 64 tiles with j-tile <= i-tile (bc = b * nc + chunk, t0 = chunk * L).
__global__ void __launch_bounds__(THREADS)
ssd_scores(const float* __restrict__ bm, const float* __restrict__ cm,
           float* __restrict__ cb, int S, int N, int L, int nc) {
  const int jt = blockIdx.x, it = blockIdx.y;
  if (jt > it) return;
  const int bc = blockIdx.z;
  const int bb = bc / nc;
  const int t0 = (bc % nc) * L;
  __shared__ __align__(16) float Ct[CB_K][CB_TILE + 4];
  __shared__ __align__(16) float Bt[CB_K][CB_TILE + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = it * CB_TILE, j0 = jt * CB_TILE;
  const float* cbase = cm + (size_t)bb * S * N;
  const float* bbase = bm + (size_t)bb * S * N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int n0 = 0; n0 < N; n0 += CB_K) {
    for (int e = tid; e < CB_TILE * CB_K; e += THREADS) {
      const int r = e / CB_K, nn = e % CB_K;
      const int ti = t0 + i0 + r, tj = t0 + j0 + r;
      Ct[nn][r] = ti < S ? cbase[(size_t)ti * N + n0 + nn] : 0.f;
      Bt[nn][r] = tj < S ? bbase[(size_t)tj * N + n0 + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < CB_K; ++nn) {
      const float4 a = *reinterpret_cast<const float4*>(&Ct[nn][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&Bt[nn][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = cb + (size_t)bc * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&out[(size_t)(i0 + ty * 4 + i) * L + j0 + tx * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

template <int L, int N>
constexpr size_t scan_smem_floats() {
  return 3 * L          // cums, exp(cums), exp(cums_last - cums)
         + L * DS       // Xs: the block's xbar columns of the chunk
         + L * WLD      // Ws: a W tile, then a c tile
         + JT * N       // Bs: a b tile
         + N * DS;      // Ht: the state slice, transposed (n, d)
}

// Launch 2: one block per (hd slice, head, sequence), the chunks in order.
template <int L, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan(const float* __restrict__ xbar, const float* __restrict__ dA,
         const float* __restrict__ bm, const float* __restrict__ cm,
         const float* __restrict__ cb, float* __restrict__ y,
         float* __restrict__ hT, int S, int H, int hd, int nc) {
  constexpr int RPT = L / 64;            // y rows per thread
  constexpr int NG = N / 4;              // float4 groups along n
  constexpr int DPT = DS * NG / THREADS; // state rows (along hd) per thread
  static_assert(RPT >= 1 && DPT >= 1 && DS * NG == DPT * THREADS,
                "the thread maps must cover the tiles exactly");
  extern __shared__ float4 smem4[];
  float* cums = reinterpret_cast<float*>(smem4);
  float* dec_in = cums + L;
  float* dec_out = dec_in + L;
  float* Xs = dec_out + L;
  float* Ws = Xs + L * DS;
  float* Bs = Ws + L * WLD;
  float* Ht = Bs + JT * N;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d0 = blockIdx.x * DS, h = blockIdx.y, bb = blockIdx.z;
  const int rg = tid / 4, cg = tid % 4;      // y: rows rg*RPT.., cols cg*4..
  const int ng = tid % NG, dg = tid / NG;    // state: n ng*4.., d dg*DPT..
  const size_t row0 = (size_t)bb * S;        // first position of the sequence

  float hreg[DPT][4];
#pragma unroll
  for (int q = 0; q < DPT; ++q)
#pragma unroll
    for (int m = 0; m < 4; ++m) hreg[q][m] = 0.f;
  for (int e = tid; e < N * DS; e += THREADS) Ht[e] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * L;
    __syncthreads();   // the previous chunk is consumed
    for (int i = tid; i < L; i += THREADS)
      cums[i] = t0 + i < S ? dA[(row0 + t0 + i) * H + h] : 0.f;
    for (int e = tid; e < L * DS; e += THREADS) {
      const int i = e / DS, dd = e % DS;
      Xs[e] = t0 + i < S ? xbar[((row0 + t0 + i) * H + h) * hd + d0 + dd] : 0.f;
    }
    __syncthreads();
    if (warp == 0) {   // inclusive cumsum: per-lane runs, then a lane scan
      constexpr int PER = L / 32;
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        run += cums[lane * PER + e];
        cums[lane * PER + e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += o;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) cums[lane * PER + e] += excl;
    }
    __syncthreads();
    const float last = cums[L - 1];
    for (int i = tid; i < L; i += THREADS) {
      dec_in[i] = expf(cums[i]);
      dec_out[i] = expf(last - cums[i]);
    }

    // Intra-chunk: acc[i] = sum_{j<=i} W[i, j] xbar[j], W formed by tiles.
    float acc[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[r][m] = 0.f;
    const float* cbc = cb + ((size_t)bb * nc + ci) * L * L;
    for (int j0 = 0; j0 < L; j0 += JT) {
      for (int e = tid; e < (L - j0) * JT; e += THREADS) {
        const int i = j0 + e / JT, j = j0 + e % JT;
        Ws[i * WLD + e % JT] =
            j <= i ? cbc[(size_t)i * L + j] * expf(cums[i] - cums[j]) : 0.f;
      }
      __syncthreads();
      if (rg * RPT + RPT - 1 >= j0) {   // rows above the tile see none of it
#pragma unroll 8
        for (int jj = 0; jj < JT; ++jj) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&Xs[(j0 + jj) * DS + cg * 4]);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float w = Ws[(rg * RPT + r) * WLD + jj];
            acc[r][0] = fmaf(w, xv.x, acc[r][0]);
            acc[r][1] = fmaf(w, xv.y, acc[r][1]);
            acc[r][2] = fmaf(w, xv.z, acc[r][2]);
            acc[r][3] = fmaf(w, xv.w, acc[r][3]);
          }
        }
      }
      __syncthreads();
    }

    // Inter-chunk: acc[i] += exp(cums_i) (c_i . h); h = 0 in chunk 0.
    if (ci > 0) {
      float tmp[RPT][4];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) tmp[r][m] = 0.f;
      for (int n0 = 0; n0 < N; n0 += JT) {
        for (int e = tid; e < L * JT; e += THREADS) {
          const int i = e / JT, nn = e % JT;
          Ws[i * WLD + nn] = t0 + i < S ? cm[(row0 + t0 + i) * N + n0 + nn] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int nn = 0; nn < JT; ++nn) {
          const float4 hv =
              *reinterpret_cast<const float4*>(&Ht[(n0 + nn) * DS + cg * 4]);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float cv = Ws[(rg * RPT + r) * WLD + nn];
            tmp[r][0] = fmaf(cv, hv.x, tmp[r][0]);
            tmp[r][1] = fmaf(cv, hv.y, tmp[r][1]);
            tmp[r][2] = fmaf(cv, hv.z, tmp[r][2]);
            tmp[r][3] = fmaf(cv, hv.w, tmp[r][3]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float di = dec_in[rg * RPT + r];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[r][m] += di * tmp[r][m];
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = rg * RPT + r;
      if (t0 + i < S)
        *reinterpret_cast<float4*>(&y[((row0 + t0 + i) * H + h) * hd + d0 + cg * 4]) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }

    // State: h <- h exp(cums_last) + sum_j exp(cums_last - cums_j) xbar_j b_j.
    float st[DPT][4];
#pragma unroll
    for (int q = 0; q < DPT; ++q)
#pragma unroll
      for (int m = 0; m < 4; ++m) st[q][m] = 0.f;
    for (int j0 = 0; j0 < L; j0 += JT) {
      for (int e = tid; e < JT * N; e += THREADS) {
        const int jj = e / N, n = e % N;
        Bs[e] = t0 + j0 + jj < S ? bm[(row0 + t0 + j0 + jj) * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < JT; ++jj) {
        const int j = j0 + jj;
        const float dout = dec_out[j];
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[jj * N + ng * 4]);
#pragma unroll
        for (int q = 0; q < DPT; ++q) {
          const float xv = dout * Xs[j * DS + dg * DPT + q];
          st[q][0] = fmaf(xv, bv.x, st[q][0]);
          st[q][1] = fmaf(xv, bv.y, st[q][1]);
          st[q][2] = fmaf(xv, bv.z, st[q][2]);
          st[q][3] = fmaf(xv, bv.w, st[q][3]);
        }
      }
      __syncthreads();
    }
    const float dlast = expf(last);
#pragma unroll
    for (int q = 0; q < DPT; ++q)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        hreg[q][m] = hreg[q][m] * dlast + st[q][m];
        Ht[(ng * 4 + m) * DS + dg * DPT + q] = hreg[q][m];
      }
  }

#pragma unroll
  for (int q = 0; q < DPT; ++q)
    *reinterpret_cast<float4*>(
        &hT[(((size_t)bb * H + h) * hd + d0 + dg * DPT + q) * N + ng * 4]) =
        make_float4(hreg[q][0], hreg[q][1], hreg[q][2], hreg[q][3]);
}

template <int L, int N>
cudaError_t launch(const float* xbar, const float* dA, const float* b,
                   const float* c, float* y, float* hT, float* cb, int B,
                   int S, int H, int hd, cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  const dim3 g1(L / CB_TILE, L / CB_TILE, B * nc);
  ssd_scores<<<g1, THREADS, 0, stream>>>(b, c, cb, S, N, L, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = scan_smem_floats<L, N>() * sizeof(float);
  err = cudaFuncSetAttribute(ssd_scan<L, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 g2(hd / DS, H, B);
  ssd_scan<L, N><<<g2, THREADS, smem, stream>>>(xbar, dA, b, c, cb, y, hT, S,
                                                H, hd, nc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// chunk: 128 or 256; N: 128; hd a multiple of 16. cb is
// scratch of B * ceil(S / chunk) * chunk^2 floats. Returns
// cudaGetLastError() after the two launches on `stream` (0 = success).
// Does not synchronise.
int mamba2_ssd_launch(const void* xbar, const void* dA, const void* b,
                      const void* c, void* y, void* hT, void* cb, int B, int S,
                      int H, int hd, int N, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd % DS || N != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xb = static_cast<const float*>(xbar);
  const float* da = static_cast<const float*>(dA);
  const float* bp = static_cast<const float*>(b);
  const float* cp = static_cast<const float*>(c);
  float* yp = static_cast<float*>(y);
  float* hp = static_cast<float*>(hT);
  float* cbp = static_cast<float*>(cb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (chunk == 256) err = launch<256, 128>(xb, da, bp, cp, yp, hp, cbp, B, S, H, hd, s);
  if (chunk == 128) err = launch<128, 128>(xb, da, bp, cp, yp, hp, cbp, B, S, H, hd, s);
  return static_cast<int>(err);
}

const char* mamba2_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
