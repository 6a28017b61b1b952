// Chunked Mamba-2 SSD scan for Hopper (sm_90a), chunk-parallel, on the
// tensor cores as 3xTF32.
//
// Per chunk of L steps of one sequence and head (cums = cumsum(dA)):
//   y[i]  = sum_{j<=i} (c_i . b_j) exp(cums_i - cums_j) xbar_j
//           + (c_i . h) exp(cums_i)                  (carried state h)
//   h    <- h exp(cums_{L-1}) + sum_j exp(cums_{L-1} - cums_j) b_j xbar_j
//
// xbar (B, S, H, 64), dA (B, S, H), b and c (B, S, 128): contiguous f32.
// Outputs y (B, S, H, 64) and the final state hT (B, H, 64, 128), f32.
//
// Replaces repro/kernels/mamba2_ssd.py::mamba2_ssd (the Pallas
// `_kernel`). That TPU kernel runs a sequential (B, nc) grid and keeps
// the whole (H, hd, N) state of a sequence in VMEM across the chunk
// steps, forming the (L, L, H) decay in VMEM. Neither carries over: at
// mamba2-780m's H 48, hd 64, N 128 the state is 1.5 MB and the decay
// 12 MB, against 227 KB of shared memory per block, and Hopper blocks
// run in parallel in no order. Only the state recurrence is sequential
// in the chunks, and it is elementwise; so the scan is cut into the
// chunk-parallel SSD decomposition (arXiv:2405.21060 section 6), four
// launches, the same algebra as the reference model's ssd_chunked:
//
//   1. ssd_scores: cb[i, j] = c_i . b_j once per (sequence, chunk), the
//      same for every head (n_groups = 1): 64 x 64 tiles on or below the
//      diagonal into a (B * nc, L, L) scratch (8 MB at B 4, S 2048,
//      L 256; read back from L2).
//   2. ssd_states: one block per (head, chunk, sequence), 1536 at the
//      mamba2-780m prefill: the chunk's own state
//      S_c = (exp(cums_L - cums_j) xbar_j)^T . b_j, a (64 x L).(L x 128)
//      product over 32-step stages of a 2-stage cp.async ring, into a
//      (B, nc, H, 64, 128) scratch (50 MB), plus cums_L.
//   3. ssd_state_pass: for each (sequence, head, four state elements),
//      h <- h exp(cums_L(c)) + S_c over the chunks in order, storing in
//      place the state that ENTERS each chunk, and hT. Elementwise: the
//      scratch is read and written once.
//   4. ssd_output: one block per (head, 64-row tile, chunk, sequence),
//      6144 at the prefill, four warps of 32 x 32: y_i = sum_{j<=i}
//      W_ij xbar_j + exp(cums_i) (c_i . h_in), W = cb * exp(cums_i -
//      cums_j) formed once per 64 x 64 tile in shared memory for all 64
//      columns of hd, the cb and xbar tiles through a 2-stage cp.async
//      ring; tiles wholly above the diagonal are neither formed nor
//      multiplied, and on the diagonal each warp stops at its own last
//      row.
//
// Every product runs on the tensor cores, mma.sync.m16n8k8 with TF32
// operands and f32 accumulation, as 3xTF32 (tc_common.cuh: each f32
// operand split a_hi = tf32(a), a_lo = tf32(a - a_hi), a.b summed as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, ~2^-22 relative per product, each
// 8-deep step in a fresh fragment added to the accumulator to nearest);
// the reference's SSD tolerance (2e-4 scaled) holds with margin. One TF32
// product alone (~2^-11 per operand rounding) would not be safe at that
// gate. cums is a warp scan that launches 2 and 4 both run, so they
// agree bit for bit; every sum runs in a fixed order, with no atomics,
// so the results are deterministic. A ragged last chunk (S % L != 0) is
// read as zero rows (dA = 0, xbar = b = c = 0), which add nothing to y
// or the state: the padding the reference's model path applies (dt = 0
// rows are inert).
//
// Bound: at the mamba2-780m prefill (B 4, S 2048, H 48, hd 64, N 128,
// L 256) the function is ~19.6 GFLOP of products (inter-chunk and state
// 2 * 2 * B*S*H*hd*N = 12.9, intra-chunk 2 * B*H*nc * L(L+1)/2 * hd =
// 6.5, scores 2 * B*nc * L(L+1)/2 * N = 0.3); as 3xTF32 at the H100's
// 495 TFLOP/s that is 0.119 ms, against ~218 MB of xbar, y and the rest
// at 3.35 TB/s (0.065 ms), so operations bound it; at the f32 FMA rate
// (67 TFLOP/s) it would be 0.293 ms. The design moves more than the
// bound's bytes: the 50 MB state scratch is written twice and read
// twice, and launch 4 rereads xbar tiles.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tc_common.cuh"

namespace {

constexpr int THREADS = 256;   // eight warps
constexpr int HD = 64;         // head dim: one block covers all of it
constexpr int NST = 128;       // state size N
constexpr int TI = 64;         // row (i) and column (j) tile of launches 1, 4
constexpr int JS = 32;         // j stage of launch 2
constexpr int PASS_BATCH = 8;  // chunks launch 3 loads at a time
constexpr int FRESH_NJ = 2;    // n8 fragments a 3xTF32 step spans at once
constexpr unsigned FULL = 0xffffffffu;

// A(m, k) = p[m * SM + k * SK], p at the fragment's (row g, depth q):
// a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4).
template <int SM, int SK>
__device__ __forceinline__ void load_a(FragA& f, const float* p) {
  const float v[4] = {p[0], p[8 * SM], p[4 * SK], p[8 * SM + 4 * SK]};
  split(v, f.hi, f.lo);
}
// B(k, n) with k stride SK, p at the fragment's (depth q, column g):
// b0 (q, g), b1 (q + 4, g).
template <int SK>
__device__ __forceinline__ void load_b(FragB& f, const float* p) {
  const float v[2] = {p[0], p[4 * SK]};
  split(v, f.hi, f.lo);
}

// cums[i] = sum_{i' <= i} dA[t0 + i'] of head h over the chunk's L steps
// (0 past S): per-lane runs of L / 32 steps, then a lane scan, in warp 0.
// Launches 2 and 4 both run this code, so their cums agree bit for bit.
// Ends with a barrier: cums is then visible to the block.
template <int L, int NT>
__device__ void chunk_cumsum(float* cums, const float* __restrict__ dA,
                             size_t row0, int t0, int S, int H, int h) {
  const int tid = threadIdx.x;
  for (int i = tid; i < L; i += NT)
    cums[i] = t0 + i < S ? dA[(row0 + t0 + i) * H + h] : 0.f;
  __syncthreads();
  if (tid < 32) {
    constexpr int PER = L / 32;
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      run += cums[tid * PER + e];
      cums[tid * PER + e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, incl, off);
      if (tid >= off) incl += o;
    }
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (tid == 0) excl = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) cums[tid * PER + e] += excl;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------
// 1. cb[bc, i, j] = c[b, t0 + i] . b[b, t0 + j] for the 64 x 64 tiles with
//    j-tile <= i-tile (bc = b * nc + chunk, t0 = chunk * L).
namespace sc {
constexpr int LD = NST + 4;   // 132 = 4 mod 32: c and b rows read as [m][k]
constexpr size_t SMEM = (size_t)2 * TI * LD * sizeof(float);
}  // namespace sc

template <int L>
__global__ void __launch_bounds__(THREADS)
ssd_scores(const float* __restrict__ bm, const float* __restrict__ cm,
           float* __restrict__ cb, int S, int nc) {
  using namespace sc;
  const int jt = blockIdx.x, it = blockIdx.y;
  if (jt > it) return;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;
  float* Bs = smem + TI * LD;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wi = warp % 4, wj = warp / 4;   // warp tile: 16 i x 32 j
  const int bc = blockIdx.z, bb = bc / nc, t0 = (bc % nc) * L;
  const int i0 = it * TI, j0 = jt * TI;
  const size_t row0 = (size_t)bb * S;

#pragma unroll
  for (int k = 0; k < TI * NST / 4 / THREADS; ++k) {
    const int e = tid + k * THREADS;
    const int r = e / (NST / 4), col = (e % (NST / 4)) * 4;
    const int ti = t0 + i0 + r, tj = t0 + j0 + r;
    cp_async16(Cs + r * LD + col, ti < S ? cm + (row0 + ti) * NST + col : cm,
               ti < S);
    cp_async16(Bs + r * LD + col, tj < S ? bm + (row0 + tj) * NST + col : bm,
               tj < S);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[1][4][4] = {};
#pragma unroll 4
  for (int kk = 0; kk < NST; kk += 8) {
    FragA a[1];
    load_a<LD, 1>(a[0], Cs + (wi * 16 + g) * LD + kk + q);
    FragB f[4];   // B(k = n, column j) = b[j][n]
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      load_b<1>(f[ni], Bs + (wj * 32 + ni * 8 + g) * LD + kk + q);
    mma3_tile<1, 4, 4>(acc, a, f, 0);
  }
  float* out = cb + (size_t)bc * L * L;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = i0 + wi * 16 + g + 8 * h2;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      *reinterpret_cast<float2*>(out + (size_t)i * L + j0 + wj * 32 + ni * 8 +
                                 2 * q) =
          make_float2(acc[0][ni][2 * h2], acc[0][ni][2 * h2 + 1]);
  }
}

// ---------------------------------------------------------------------
// 2. states[b, chunk, h] (64 x 128) = sum_j (exp(cums_L - cums_j) xbar_j)
//    b_j^T, and dlast[b, chunk, h] = cums_L.
namespace st {
constexpr int LDX = HD + 8;    // 72 = 8 mod 32: xbar read as [k][m]
constexpr int LDB = NST + 8;   // 136 = 8 mod 32: b read as [k][n]
constexpr int STAGE = JS * (LDX + LDB);
constexpr int NS = 2;          // cp.async ring depth
template <int L>
constexpr size_t smem() { return (size_t)(2 * L + NS * STAGE) * sizeof(float); }
}  // namespace st

template <int L>
__global__ void __launch_bounds__(THREADS)
ssd_states(const float* __restrict__ xbar, const float* __restrict__ dA,
           const float* __restrict__ bm, float* __restrict__ states,
           float* __restrict__ dlast, int S, int H, int nc) {
  using namespace st;
  extern __shared__ __align__(16) float smem[];
  float* cums = smem;
  float* dec = smem + L;   // exp(cums_L - cums_j)
  float* ring = smem + 2 * L;
  const int h = blockIdx.x, ci = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wd = warp % 2, wn = warp / 2;   // warp tile: 32 d x 32 n
  const size_t row0 = (size_t)bb * S;
  const int t0 = ci * L;
  constexpr int n_tiles = L / JS;

  auto load = [&](int t) {
    float* Xs = ring + (t % NS) * STAGE;
    float* Bs = Xs + JS * LDX;
    const int j0 = t0 + t * JS;
#pragma unroll
    for (int k = 0; k < JS * HD / 4 / THREADS; ++k) {
      const int e = tid + k * THREADS;
      const int r = e / (HD / 4), col = (e % (HD / 4)) * 4;
      const bool in = j0 + r < S;
      cp_async16(Xs + r * LDX + col,
                 in ? xbar + ((row0 + j0 + r) * H + h) * HD + col : xbar, in);
    }
#pragma unroll
    for (int k = 0; k < JS * NST / 4 / THREADS; ++k) {
      const int e = tid + k * THREADS;
      const int r = e / (NST / 4), col = (e % (NST / 4)) * 4;
      const bool in = j0 + r < S;
      cp_async16(Bs + r * LDB + col,
                 in ? bm + (row0 + j0 + r) * NST + col : bm, in);
    }
  };
  load(0);
  cp_async_commit();
  chunk_cumsum<L, THREADS>(cums, dA, row0, t0, S, H, h);   // under tile 0's
                                                          // copies
  const float last = cums[L - 1];
  for (int i = tid; i < L; i += THREADS) dec[i] = expf(last - cums[i]);

  float acc[2][4][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();   // tile t has landed ...
    __syncthreads();       // ... for every thread; tile t - 1 is consumed
    if (t + 1 < n_tiles) load(t + 1);
    cp_async_commit();
    const float* Xs = ring + (t % NS) * STAGE;
    const float* Bs = Xs + JS * LDX;
    // unrolled by two, not four: at four the fresh fragments took 141
    // registers, one block an SM
#pragma unroll 2
    for (int kk = 0; kk < JS; kk += 8) {
      const float d0 = dec[t * JS + kk + q], d1 = dec[t * JS + kk + q + 4];
      FragA a[2];   // A(m = d, k = j) = dec_j xbar[j][d]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* p = Xs + (kk + q) * LDX + wd * 32 + mi * 16 + g;
        const float v[4] = {p[0] * d0, p[8] * d0, p[4 * LDX] * d1,
                            p[4 * LDX + 8] * d1};
        split(v, a[mi].hi, a[mi].lo);
      }
      FragB f[4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        load_b<LDB>(f[ni], Bs + (kk + q) * LDB + wn * 32 + ni * 8 + g);
#pragma unroll
      for (int n0 = 0; n0 < 4; n0 += FRESH_NJ)
        mma3_tile<2, 4, FRESH_NJ>(acc, a, f, n0);
    }
  }

  const size_t slot = ((size_t)bb * nc + ci) * H + h;
  float* out = states + slot * HD * NST;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int d = wd * 32 + mi * 16 + g + 8 * h2;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(out + d * NST + wn * 32 + ni * 8 + 2 * q) =
            make_float2(acc[mi][ni][2 * h2], acc[mi][ni][2 * h2 + 1]);
    }
  if (tid == 0) dlast[slot] = last;
}

// ---------------------------------------------------------------------
// 3. h <- h exp(dlast) + S_c over the chunks in order; states[b, chunk, h]
//    becomes the state entering the chunk; hT gets the last h.
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ dlast,
               float* __restrict__ hT, int H, int nc) {
  const int e = blockIdx.x * THREADS + threadIdx.x;   // float4 of (64, 128)
  const int h = blockIdx.y, bb = blockIdx.z;
  if (e >= HD * NST / 4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // PASS_BATCH chunks' loads are issued before any of their stores, so a
  // thread waits on memory once a batch, not once a chunk
  for (int c0 = 0; c0 < nc; c0 += PASS_BATCH) {
    float4 s[PASS_BATCH];
    float a[PASS_BATCH];
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c0 + k >= nc) break;
      const size_t slot = ((size_t)bb * nc + c0 + k) * H + h;
      s[k] = reinterpret_cast<const float4*>(states + slot * HD * NST)[e];
      a[k] = expf(dlast[slot]);
    }
#pragma unroll
    for (int k = 0; k < PASS_BATCH; ++k) {
      if (c0 + k >= nc) break;
      const size_t slot = ((size_t)bb * nc + c0 + k) * H + h;
      reinterpret_cast<float4*>(states + slot * HD * NST)[e] = acc;
      // h * exp(last) + S, rounded as the reference's two ops
      acc = make_float4(__fadd_rn(__fmul_rn(acc.x, a[k]), s[k].x),
                        __fadd_rn(__fmul_rn(acc.y, a[k]), s[k].y),
                        __fadd_rn(__fmul_rn(acc.z, a[k]), s[k].z),
                        __fadd_rn(__fmul_rn(acc.w, a[k]), s[k].w));
    }
  }
  reinterpret_cast<float4*>(hT + ((size_t)bb * H + h) * HD * NST)[e] = acc;
}

// ---------------------------------------------------------------------
// 4. y for 64 rows of one (sequence, chunk, head): W . xbar over the
//    j-tiles up to the diagonal, plus exp(cums_i) (c_i . h_in).
namespace ys {
constexpr int LDW = TI + 4;    // 68 = 4 mod 32: W read as [m][k]
constexpr int LDX = HD + 8;    // 72 = 8 mod 32: xbar read as [k][n]
constexpr int STAGE = TI * (LDW + LDX);
constexpr int LDC = NST + 4;   // 132 = 4 mod 32: c as [m][k], h_in as [n][k]
constexpr int RING = 2 * STAGE;
static_assert(2 * TI * LDC <= RING, "c and h_in fit in the ring");
static_assert(HD == TI, "one loop loads the TI rows of c and the HD rows "
                        "of h_in");
constexpr int WI = 32;   // rows (i) of a warp's tile
constexpr int WD = 32;   // columns (d) of a warp's tile
constexpr int WARPS_I = TI / WI;
constexpr int NT = 32 * WARPS_I * (HD / WD);   // threads a block
constexpr int MI = WI / 16, NI = WD / 8;
static_assert(TI * TI / 4 % NT == 0 && TI * NST / 4 % NT == 0,
              "16-byte tile copies must divide evenly among the threads");
template <int L>
constexpr size_t smem() { return (size_t)(L + RING) * sizeof(float); }
}  // namespace ys

template <int L>
__global__ void __launch_bounds__(ys::NT)
ssd_output(const float* __restrict__ xbar, const float* __restrict__ dA,
           const float* __restrict__ cm, const float* __restrict__ cb,
           const float* __restrict__ states, float* __restrict__ y, int S,
           int H, int nc) {
  using namespace ys;
  extern __shared__ __align__(16) float smem[];
  float* cums = smem;
  float* ring = smem + L;
  const int h = blockIdx.x;
  const int it = L / TI - 1 - blockIdx.y;   // the longest rows first
  const int bc = blockIdx.z, bb = bc / nc, ci = bc % nc;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int wi = warp % WARPS_I, wd = warp / WARPS_I;   // warp tile: WI i
                                                        // x WD d
  const size_t row0 = (size_t)bb * S;
  const int t0 = ci * L, i0 = it * TI;
  const float* cbc = cb + (size_t)bc * L * L;
  const int n_tiles = it + 1;

  auto load = [&](int t) {
    float* Ws = ring + (t % 2) * STAGE;
    float* Xs = Ws + TI * LDW;
    const int j0 = t * TI;
#pragma unroll
    for (int k = 0; k < TI * TI / 4 / NT; ++k) {
      const int e = tid + k * NT;
      const int r = e / (TI / 4), col = (e % (TI / 4)) * 4;
      cp_async16(Ws + r * LDW + col, cbc + (size_t)(i0 + r) * L + j0 + col,
                 true);
      const bool in = t0 + j0 + r < S;
      cp_async16(Xs + r * LDX + col,
                 in ? xbar + ((row0 + t0 + j0 + r) * H + h) * HD + col : xbar,
                 in);
    }
  };
  load(0);
  cp_async_commit();
  chunk_cumsum<L, NT>(cums, dA, row0, t0, S, H, h);   // under tile 0's copies

  float acc[MI][NI][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) load(t + 1);
    cp_async_commit();
    float* Ws = ring + (t % 2) * STAGE;
    const float* Xs = Ws + TI * LDW;
    const int j0 = t * TI;
    // W = cb * exp(cums_i - cums_j) for j <= i, else 0, in place
    for (int e = tid; e < TI * TI; e += NT) {
      const int r = e / TI, col = e % TI;
      const int i = i0 + r, j = j0 + col;
      float* wp = Ws + r * LDW + col;
      *wp = j <= i ? *wp * expf(cums[i] - cums[j]) : 0.f;
    }
    __syncthreads();
    // on the diagonal tile, the warp's rows see no column past its last
    const int k_end = t == it ? (wi + 1) * WI : TI;
    for (int kk = 0; kk < k_end; kk += 8) {
      FragA a[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        load_a<LDW, 1>(a[mi], Ws + (wi * WI + mi * 16 + g) * LDW + kk + q);
      FragB f[NI];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        load_b<LDX>(f[ni], Xs + (kk + q) * LDX + wd * WD + ni * 8 + g);
#pragma unroll
      for (int n0 = 0; n0 < NI; n0 += FRESH_NJ)
        mma3_tile<MI, NI, FRESH_NJ>(acc, a, f, n0);
    }
  }

  // the carried state's term; the state entering chunk 0 is zero
  float acc2[MI][NI][4] = {};
  if (ci > 0) {
    __syncthreads();   // the ring's last tile is consumed
    float* Cs = ring;
    float* Hs = ring + TI * LDC;
    const float* hin = states + (((size_t)bb * nc + ci) * H + h) * HD * NST;
#pragma unroll
    for (int k = 0; k < TI * NST / 4 / NT; ++k) {
      const int e = tid + k * NT;
      const int r = e / (NST / 4), col = (e % (NST / 4)) * 4;
      const bool in = t0 + i0 + r < S;
      cp_async16(Cs + r * LDC + col,
                 in ? cm + (row0 + t0 + i0 + r) * NST + col : cm, in);
      cp_async16(Hs + r * LDC + col, hin + r * NST + col, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < NST; kk += 8) {
      FragA a[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        load_a<LDC, 1>(a[mi], Cs + (wi * WI + mi * 16 + g) * LDC + kk + q);
      FragB f[NI];   // B(k = n, column d) = h_in[d][n]
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        load_b<1>(f[ni], Hs + (wd * WD + ni * 8 + g) * LDC + kk + q);
#pragma unroll
      for (int n0 = 0; n0 < NI; n0 += FRESH_NJ)
        mma3_tile<MI, NI, FRESH_NJ>(acc2, a, f, n0);
    }
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int i = i0 + wi * WI + mi * 16 + g + 8 * h2;
      if (t0 + i >= S) continue;
      const float dec_in = expf(cums[i]);
      float* yr = y + ((row0 + t0 + i) * H + h) * HD + wd * WD + 2 * q;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* a1 = acc[mi][ni];
        const float* a2 = acc2[mi][ni];
        *reinterpret_cast<float2*>(yr + ni * 8) =
            make_float2(a1[2 * h2] + a2[2 * h2] * dec_in,
                        a1[2 * h2 + 1] + a2[2 * h2 + 1] * dec_in);
      }
    }
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int L>
cudaError_t launch(const float* xbar, const float* dA, const float* b,
                   const float* c, float* y, float* hT, float* cb,
                   float* states, float* dlast, int B, int S, int H,
                   int parts, cudaStream_t s) {
  const int nc = (S + L - 1) / L;
  cudaError_t err;
  if (parts & 1) {
    if ((err = allow_smem(ssd_scores<L>, sc::SMEM)) != cudaSuccess) return err;
    ssd_scores<L><<<dim3(L / TI, L / TI, B * nc), THREADS, sc::SMEM, s>>>(
        b, c, cb, S, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 2) {
    if ((err = allow_smem(ssd_states<L>, st::smem<L>())) != cudaSuccess)
      return err;
    ssd_states<L><<<dim3(H, nc, B), THREADS, st::smem<L>(), s>>>(
        xbar, dA, b, states, dlast, S, H, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 4) {
    ssd_state_pass<<<dim3(HD * NST / 4 / THREADS, H, B), THREADS, 0, s>>>(
        states, dlast, hT, H, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 8) {
    if ((err = allow_smem(ssd_output<L>, ys::smem<L>())) != cudaSuccess)
      return err;
    ssd_output<L><<<dim3(H, L / TI, B * nc), ys::NT, ys::smem<L>(), s>>>(
        xbar, dA, c, cb, states, y, S, H, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// chunk: 128 or 256; hd: 64; N: 128. Scratch: cb B * ceil(S / chunk) *
// chunk^2 floats, states B * ceil(S / chunk) * H * hd * N floats, dlast
// B * ceil(S / chunk) * H floats. Launches the parts whose bit is set (1
// scores, 2 chunk states, 4 state pass, 8 output; the wrapper passes 15)
// on `stream` and returns cudaGetLastError() after them (0 = success).
// Does not synchronise.
int mamba2_ssd_launch(const void* xbar, const void* dA, const void* b,
                      const void* c, void* y, void* hT, void* cb,
                      void* states, void* dlast, int B, int S, int H, int hd,
                      int N, int chunk, int parts, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H > 65535 || hd != HD || N != NST)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (chunk == 256)
    err = launch<256>(f(xbar), f(dA), f(b), f(c), o(y), o(hT), o(cb),
                      o(states), o(dlast), B, S, H, parts, s);
  if (chunk == 128)
    err = launch<128>(f(xbar), f(dA), f(b), f(c), o(y), o(hT), o(cb),
                      o(states), o(dlast), B, S, H, parts, s);
  return static_cast<int>(err);
}

const char* mamba2_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
