// Chunked Mamba-2 SSD scan for Hopper (sm_90a), chunk-parallel, on the
// tensor cores as 3xTF32.
//
// Per chunk of L steps of one sequence and head (cums = cumsum(dA)):
//   y[i]  = sum_{j<=i} (c_i . b_j) exp(cums_i - cums_j) xbar_j
//           + (c_i . h) exp(cums_i)                  (carried state h)
//   h    <- h exp(cums_{L-1}) + sum_j exp(cums_{L-1} - cums_j) b_j xbar_j
//
// xbar (B, S, H, HD), dA (B, S, H), b and c (B, S, NST): contiguous f32.
// Outputs y (B, S, H, HD) and the final state hT (B, H, HD, NST), f32.
// (L, HD, NST) are template parameters of all four launches, compiled for
// (256, 64, 128) and (128, 64, 128), mamba2-780m's sizes, and (32, 32, 16),
// its reduced config's.
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
//      same for every head (n_groups = 1): TI x TI tiles (TI = min(L, 64))
//      on or below the diagonal into a (B * nc, L, L) scratch (8 MB at
//      B 4, S 2048, L 256; read back from L2).
//   2. ssd_states: one block per (head, chunk, sequence), 1536 at the
//      mamba2-780m prefill: the chunk's own state
//      S_c = (exp(cums_L - cums_j) xbar_j)^T . b_j, an (HD x L).(L x NST)
//      product over 32-step stages of a 2-stage cp.async ring, into a
//      (B, nc, H, HD, NST) scratch (50 MB), plus cums_L.
//   3. ssd_state_pass: for each (sequence, head, four state elements),
//      h <- h exp(cums_L(c)) + S_c over the chunks in order, storing in
//      place the state that ENTERS each chunk, and hT. Elementwise: the
//      scratch is read and written once.
//   4. ssd_output: one block per (head, TI-row tile, chunk, sequence),
//      6144 at the prefill, four warps of TI/2 x HD/2 (32 x 32 there,
//      16 x 16 at the reduced sizes): y_i = sum_{j<=i} W_ij xbar_j +
//      exp(cums_i) (c_i . h_in), W = cb * exp(cums_i - cums_j) formed once
//      per TI x TI tile in shared memory for all HD columns, the cb and
//      xbar tiles through a 2-stage cp.async ring; tiles wholly above the
//      diagonal are neither formed nor multiplied, and on the diagonal
//      each warp stops at its own last row.
//
// At chunk 32 a 64-row tile would be larger than the chunk, so TI is the
// chunk there, and every warp tile is cut from 16-row mma.sync fragments
// down to N 16. The tiles of each launch are picked from (L, HD, NST) by
// the traits below; at the two mamba2-780m sizes they are the ones the
// kernel had before it took other sizes.
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

constexpr int THREADS = 256;   // launches 1 and 3: eight warps
constexpr int JS = 32;         // j stage of launch 2
constexpr int PASS_BATCH = 8;  // chunks launch 3 loads at a time
constexpr int FRESH_NJ = 2;    // n8 fragments a 3xTF32 step spans at once
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The tiles of each launch for one compiled (L, HD, NST).
template <int L, int HD, int NST>
struct Tiles {
  static constexpr int TI = cmin(L, 64);   // row (i) and column (j) tile of
                                           // launches 1 and 4
  // launch 1: eight warps of 16 i x SC_WJ j over a TI x TI tile
  static constexpr int SC_WARPS_I = TI / 16;
  static constexpr int SC_WJ = TI / (8 / SC_WARPS_I);
  // launch 2: warps of ST_WD d x ST_WN n over the HD x NST state
  static constexpr int ST_WD = HD / 2;
  static constexpr int ST_WN = cmin(32, NST / 2);
  static constexpr int ST_WARPS_D = HD / ST_WD;
  static constexpr int ST_NT = 32 * ST_WARPS_D * (NST / ST_WN);
  // launch 4: four warps of Y_WI i x Y_WD d over a TI x HD tile of y
  static constexpr int Y_WI = TI / 2;
  static constexpr int Y_WD = HD / 2;
  static constexpr int Y_NT = 128;
  static_assert(L % 32 == 0 && L % TI == 0, "chunk: a multiple of 32 and TI");
  static_assert(TI % 16 == 0 && 8 % SC_WARPS_I == 0 && SC_WJ % 8 == 0,
                "launch 1's warp tiles");
  static_assert(ST_WD % 16 == 0 && ST_WN % 8 == 0 && NST % ST_WN == 0,
                "launch 2's warp tiles");
  static_assert(Y_WI % 16 == 0 && Y_WD % 8 == 0, "launch 4's warp tiles");
  static_assert(HD % 4 == 0 && NST % 8 == 0, "16-byte rows, 8-deep steps");
};

// Calls f(row, col) for every 16-byte piece (4 floats) of a ROWS x COLS
// tile, spread over the NT threads of a block.
template <int ROWS, int COLS, int NT, typename F>
__device__ __forceinline__ void for_each_vec4(int tid, F&& f) {
  constexpr int V = ROWS * COLS / 4;
#pragma unroll
  for (int k = 0; k < (V + NT - 1) / NT; ++k) {
    const int e = tid + k * NT;
    if (V % NT == 0 || e < V) f(e / (COLS / 4), (e % (COLS / 4)) * 4);
  }
}

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
// 1. cb[bc, i, j] = c[b, t0 + i] . b[b, t0 + j] for the TI x TI tiles with
//    j-tile <= i-tile (bc = b * nc + chunk, t0 = chunk * L).
template <int L, int HD, int NST>
struct Scores {
  using T = Tiles<L, HD, NST>;
  static constexpr int LD = NST + 4;   // = 4 mod 32 (132, 20): c and b rows
                                       // read as [m][k]
  static constexpr size_t SMEM = (size_t)2 * T::TI * LD * sizeof(float);
};

template <int L, int HD, int NST>
__global__ void __launch_bounds__(THREADS)
ssd_scores(const float* __restrict__ bm, const float* __restrict__ cm,
           float* __restrict__ cb, int S, int nc) {
  using T = Tiles<L, HD, NST>;
  constexpr int TI = T::TI, LD = Scores<L, HD, NST>::LD;
  constexpr int NI = T::SC_WJ / 8;
  const int jt = blockIdx.x, it = blockIdx.y;
  if (jt > it) return;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;
  float* Bs = smem + TI * LD;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  // warp tile: 16 i x SC_WJ j
  const int wi = warp % T::SC_WARPS_I, wj = warp / T::SC_WARPS_I;
  const int bc = blockIdx.z, bb = bc / nc, t0 = (bc % nc) * L;
  const int i0 = it * TI, j0 = jt * TI;
  const size_t row0 = (size_t)bb * S;

  for_each_vec4<TI, NST, THREADS>(tid, [&](int r, int col) {
    const int ti = t0 + i0 + r, tj = t0 + j0 + r;
    cp_async16(Cs + r * LD + col, ti < S ? cm + (row0 + ti) * NST + col : cm,
               ti < S);
    cp_async16(Bs + r * LD + col, tj < S ? bm + (row0 + tj) * NST + col : bm,
               tj < S);
  });
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[1][NI][4] = {};
#pragma unroll 4
  for (int kk = 0; kk < NST; kk += 8) {
    FragA a[1];
    load_a<LD, 1>(a[0], Cs + (wi * 16 + g) * LD + kk + q);
    FragB f[NI];   // B(k = n, column j) = b[j][n]
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      load_b<1>(f[ni], Bs + (wj * T::SC_WJ + ni * 8 + g) * LD + kk + q);
    mma3_tile<1, NI, NI>(acc, a, f, 0);
  }
  float* out = cb + (size_t)bc * L * L;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = i0 + wi * 16 + g + 8 * h2;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      *reinterpret_cast<float2*>(out + (size_t)i * L + j0 + wj * T::SC_WJ +
                                 ni * 8 + 2 * q) =
          make_float2(acc[0][ni][2 * h2], acc[0][ni][2 * h2 + 1]);
  }
}

// ---------------------------------------------------------------------
// 2. states[b, chunk, h] (HD x NST) = sum_j (exp(cums_L - cums_j) xbar_j)
//    b_j^T, and dlast[b, chunk, h] = cums_L.
template <int L, int HD, int NST>
struct States {
  static constexpr int LDX = HD + 8;    // = 8 mod 32 (72, 40): xbar read as
                                        // [k][m]
  static constexpr int LDB = NST + 8;   // = 8 mod 32 (136, 24): b read as
                                        // [k][n]
  static constexpr int STAGE = JS * (LDX + LDB);
  static constexpr int NS = 2;          // cp.async ring depth
  static constexpr size_t SMEM = (size_t)(2 * L + NS * STAGE) * sizeof(float);
};

template <int L, int HD, int NST>
__global__ void __launch_bounds__(Tiles<L, HD, NST>::ST_NT)
ssd_states(const float* __restrict__ xbar, const float* __restrict__ dA,
           const float* __restrict__ bm, float* __restrict__ states,
           float* __restrict__ dlast, int S, int H, int nc) {
  using T = Tiles<L, HD, NST>;
  using P = States<L, HD, NST>;
  constexpr int NT = T::ST_NT, LDX = P::LDX, LDB = P::LDB;
  constexpr int MI = T::ST_WD / 16, NI = T::ST_WN / 8, NJ = cmin(FRESH_NJ, NI);
  extern __shared__ __align__(16) float smem[];
  float* cums = smem;
  float* dec = smem + L;   // exp(cums_L - cums_j)
  float* ring = smem + 2 * L;
  const int h = blockIdx.x, ci = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  // warp tile: ST_WD d x ST_WN n
  const int wd = warp % T::ST_WARPS_D, wn = warp / T::ST_WARPS_D;
  const size_t row0 = (size_t)bb * S;
  const int t0 = ci * L;
  constexpr int n_tiles = L / JS;

  auto load = [&](int t) {
    float* Xs = ring + (t % P::NS) * P::STAGE;
    float* Bs = Xs + JS * LDX;
    const int j0 = t0 + t * JS;
    for_each_vec4<JS, HD, NT>(tid, [&](int r, int col) {
      const bool in = j0 + r < S;
      cp_async16(Xs + r * LDX + col,
                 in ? xbar + ((row0 + j0 + r) * H + h) * HD + col : xbar, in);
    });
    for_each_vec4<JS, NST, NT>(tid, [&](int r, int col) {
      const bool in = j0 + r < S;
      cp_async16(Bs + r * LDB + col,
                 in ? bm + (row0 + j0 + r) * NST + col : bm, in);
    });
  };
  load(0);
  cp_async_commit();
  chunk_cumsum<L, NT>(cums, dA, row0, t0, S, H, h);   // under tile 0's
                                                      // copies
  const float last = cums[L - 1];
  for (int i = tid; i < L; i += NT) dec[i] = expf(last - cums[i]);

  float acc[MI][NI][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();   // tile t has landed ...
    __syncthreads();       // ... for every thread; tile t - 1 is consumed
    if (t + 1 < n_tiles) load(t + 1);
    cp_async_commit();
    const float* Xs = ring + (t % P::NS) * P::STAGE;
    const float* Bs = Xs + JS * LDX;
    // unrolled by two, not four: at four the fresh fragments took 141
    // registers, one block an SM
#pragma unroll 2
    for (int kk = 0; kk < JS; kk += 8) {
      const float d0 = dec[t * JS + kk + q], d1 = dec[t * JS + kk + q + 4];
      FragA a[MI];   // A(m = d, k = j) = dec_j xbar[j][d]
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* p = Xs + (kk + q) * LDX + wd * T::ST_WD + mi * 16 + g;
        const float v[4] = {p[0] * d0, p[8] * d0, p[4 * LDX] * d1,
                            p[4 * LDX + 8] * d1};
        split(v, a[mi].hi, a[mi].lo);
      }
      FragB f[NI];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        load_b<LDB>(f[ni], Bs + (kk + q) * LDB + wn * T::ST_WN + ni * 8 + g);
#pragma unroll
      for (int n0 = 0; n0 < NI; n0 += NJ)
        mma3_tile<MI, NI, NJ>(acc, a, f, n0);
    }
  }

  const size_t slot = ((size_t)bb * nc + ci) * H + h;
  float* out = states + slot * HD * NST;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int d = wd * T::ST_WD + mi * 16 + g + 8 * h2;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        *reinterpret_cast<float2*>(out + d * NST + wn * T::ST_WN + ni * 8 +
                                   2 * q) =
            make_float2(acc[mi][ni][2 * h2], acc[mi][ni][2 * h2 + 1]);
    }
  if (tid == 0) dlast[slot] = last;
}

// ---------------------------------------------------------------------
// 3. h <- h exp(dlast) + S_c over the chunks in order; states[b, chunk, h]
//    becomes the state entering the chunk; hT gets the last h.
template <int HD, int NST>
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ dlast,
               float* __restrict__ hT, int H, int nc) {
  const int e = blockIdx.x * THREADS + threadIdx.x;   // float4 of (HD, NST)
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
// 4. y for TI rows of one (sequence, chunk, head): W . xbar over the
//    j-tiles up to the diagonal, plus exp(cums_i) (c_i . h_in).
template <int L, int HD, int NST>
struct Output {
  static constexpr int TI = Tiles<L, HD, NST>::TI;
  static constexpr int LDW = TI + 4;    // = 4 mod 32 (68, 36): W read as
                                        // [m][k]
  static constexpr int LDX = HD + 8;    // = 8 mod 32 (72, 40): xbar read as
                                        // [k][n]
  static constexpr int STAGE = TI * (LDW + LDX);
  static constexpr int LDC = NST + 4;   // = 4 mod 32 (132, 20): c as [m][k],
                                        // h_in as [n][k]
  static constexpr int RING = 2 * STAGE;
  static_assert((TI + HD) * LDC <= RING, "c and h_in fit in the ring");
  static constexpr size_t SMEM = (size_t)(L + RING) * sizeof(float);
};

template <int L, int HD, int NST>
__global__ void __launch_bounds__(Tiles<L, HD, NST>::Y_NT)
ssd_output(const float* __restrict__ xbar, const float* __restrict__ dA,
           const float* __restrict__ cm, const float* __restrict__ cb,
           const float* __restrict__ states, float* __restrict__ y, int S,
           int H, int nc) {
  using T = Tiles<L, HD, NST>;
  using P = Output<L, HD, NST>;
  constexpr int TI = T::TI, NT = T::Y_NT, WI = T::Y_WI, WD = T::Y_WD;
  constexpr int LDW = P::LDW, LDX = P::LDX, LDC = P::LDC;
  constexpr int WARPS_I = TI / WI;
  constexpr int MI = WI / 16, NI = WD / 8, NJ = cmin(FRESH_NJ, NI);
  static_assert(NT == 32 * WARPS_I * (HD / WD), "four warps tile TI x HD");
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
    float* Ws = ring + (t % 2) * P::STAGE;
    float* Xs = Ws + TI * LDW;
    const int j0 = t * TI;
    for_each_vec4<TI, TI, NT>(tid, [&](int r, int col) {
      cp_async16(Ws + r * LDW + col, cbc + (size_t)(i0 + r) * L + j0 + col,
                 true);
    });
    for_each_vec4<TI, HD, NT>(tid, [&](int r, int col) {
      const bool in = t0 + j0 + r < S;
      cp_async16(Xs + r * LDX + col,
                 in ? xbar + ((row0 + t0 + j0 + r) * H + h) * HD + col : xbar,
                 in);
    });
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
    float* Ws = ring + (t % 2) * P::STAGE;
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
      for (int n0 = 0; n0 < NI; n0 += NJ)
        mma3_tile<MI, NI, NJ>(acc, a, f, n0);
    }
  }

  // the carried state's term; the state entering chunk 0 is zero
  float acc2[MI][NI][4] = {};
  if (ci > 0) {
    __syncthreads();   // the ring's last tile is consumed
    float* Cs = ring;
    float* Hs = ring + TI * LDC;
    const float* hin = states + (((size_t)bb * nc + ci) * H + h) * HD * NST;
    for_each_vec4<TI, NST, NT>(tid, [&](int r, int col) {
      const bool in = t0 + i0 + r < S;
      cp_async16(Cs + r * LDC + col,
                 in ? cm + (row0 + t0 + i0 + r) * NST + col : cm, in);
    });
    for_each_vec4<HD, NST, NT>(tid, [&](int r, int col) {
      cp_async16(Hs + r * LDC + col, hin + r * NST + col, true);
    });
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
      for (int n0 = 0; n0 < NI; n0 += NJ)
        mma3_tile<MI, NI, NJ>(acc2, a, f, n0);
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

template <int L, int HD, int NST>
cudaError_t launch(const float* xbar, const float* dA, const float* b,
                   const float* c, float* y, float* hT, float* cb,
                   float* states, float* dlast, int B, int S, int H,
                   int parts, cudaStream_t s) {
  using T = Tiles<L, HD, NST>;
  constexpr size_t sc_smem = Scores<L, HD, NST>::SMEM;
  constexpr size_t st_smem = States<L, HD, NST>::SMEM;
  constexpr size_t y_smem = Output<L, HD, NST>::SMEM;
  const int nc = (S + L - 1) / L;
  cudaError_t err;
  if (parts & 1) {
    if ((err = allow_smem(ssd_scores<L, HD, NST>, sc_smem)) != cudaSuccess)
      return err;
    ssd_scores<L, HD, NST>
        <<<dim3(L / T::TI, L / T::TI, B * nc), THREADS, sc_smem, s>>>(
            b, c, cb, S, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 2) {
    if ((err = allow_smem(ssd_states<L, HD, NST>, st_smem)) != cudaSuccess)
      return err;
    ssd_states<L, HD, NST><<<dim3(H, nc, B), T::ST_NT, st_smem, s>>>(
        xbar, dA, b, states, dlast, S, H, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 4) {
    constexpr int blocks = (HD * NST / 4 + THREADS - 1) / THREADS;
    ssd_state_pass<HD, NST><<<dim3(blocks, H, B), THREADS, 0, s>>>(
        states, dlast, hT, H, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (parts & 8) {
    if ((err = allow_smem(ssd_output<L, HD, NST>, y_smem)) != cudaSuccess)
      return err;
    ssd_output<L, HD, NST>
        <<<dim3(H, L / T::TI, B * nc), T::Y_NT, y_smem, s>>>(
            xbar, dA, c, cb, states, y, S, H, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// (chunk, hd, N): (256, 64, 128), (128, 64, 128) or (32, 32, 16). Scratch:
// cb B * ceil(S / chunk) * chunk^2 floats, states B * ceil(S / chunk) * H *
// hd * N floats, dlast B * ceil(S / chunk) * H floats. Launches the parts
// whose bit is set (1 scores, 2 chunk states, 4 state pass, 8 output; the
// wrapper passes 15) on `stream` and returns cudaGetLastError() after them
// (0 = success). Does not synchronise.
int mamba2_ssd_launch(const void* xbar, const void* dA, const void* b,
                      const void* c, void* y, void* hT, void* cb,
                      void* states, void* dlast, int B, int S, int H, int hd,
                      int N, int chunk, int parts, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (chunk == 256 && hd == 64 && N == 128)
    err = launch<256, 64, 128>(f(xbar), f(dA), f(b), f(c), o(y), o(hT), o(cb),
                               o(states), o(dlast), B, S, H, parts, s);
  if (chunk == 128 && hd == 64 && N == 128)
    err = launch<128, 64, 128>(f(xbar), f(dA), f(b), f(c), o(y), o(hT), o(cb),
                               o(states), o(dlast), B, S, H, parts, s);
  if (chunk == 32 && hd == 32 && N == 16)
    err = launch<32, 32, 16>(f(xbar), f(dA), f(b), f(c), o(y), o(hT), o(cb),
                             o(states), o(dlast), B, S, H, parts, s);
  return static_cast<int>(err);
}

const char* mamba2_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
