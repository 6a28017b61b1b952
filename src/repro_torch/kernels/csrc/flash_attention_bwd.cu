// The backward of causal bf16 attention for Hopper (sm_90a), on the tensor
// cores: dq, dk and dv of
//
//   out[b, i, h] = sum_j p_ij v[b, j, h / G],  p_ij = softmax_j(s_ij),
//   s_ij = hd^-0.5 q[b, i, h] . k[b, j, h / G]   over visible j
//
// for self-attention (Sq = Sk = S, both offsets 0), causal, with or without
// a window: j visible to i when j <= i and i - j < window. q, dout (B, S,
// H, hd) and k, v (B, S, KV, hd) are contiguous bf16, G = H / KV; the
// forward's residuals are its output before the rounding to bf16 (o, f32)
// and each row's log-sum-exp of the scaled scores (lse, f32, (B, H, S)),
// which flash_fwd_tc writes when asked. hd is 64 (qwen2, tinyllama) or 128
// (qwen3, deepseek, llama-vision).
//
// Replaces none: the reference's Pallas flash_attention has no VJP, so the
// reference differentiates its pure-JAX chunked route, and so did the port
// (models/attention.py::_chunked under autograd), holding every chunk's f32
// P for the backward. This computes the same gradient from q, k, v, o, lse
// and dout, keeping S, P, dP and dS on chip:
//
//   p_ij = exp(s_ij - lse_i),  dp_ij = dout_i . v_j,  D_i = dout_i . o_i,
//   ds_ij = p_ij (dp_ij - D_i),
//   dv_j = sum_i p_ij dout_i,  dk_j = hd^-0.5 sum_i ds_ij q_i,
//   dq_i = hd^-0.5 sum_j ds_ij k_j
//
// with dk and dv summed over the G query heads of their kv head.
//
// Three launches:
//
//   * flash_bwd_prep: D = rowsum(dout * o) in f32, and lse * log2 e, both
//     into (B, H, Sp) buffers (Sp: S rounded up to 128, the pad zero), so
//     that the two kernels below copy whole aligned 64-row tiles of them.
//     o is the f32 output: D from the bf16 output would move ds by one bf16
//     rounding of o, ~1e-3 of the gradient.
//   * flash_bwd_tc: one block per (batch, kv head, 128-key tile), two
//     warpgroups of 64 keys. K and V stay in shared memory; the block walks
//     the G query heads of its kv head and, for each, the 64-row q tiles
//     that see some of its keys (the causal triangle and the window band:
//     no tile all of whose pairs are masked), q, dout, lse and D streaming
//     through a 2-stage cp.async ring. Per tile, from registers: S^T = K.Q^T
//     and dP^T = V.dout^T (wgmma, both operands from shared memory), P^T and
//     dS^T (elementwise in f32, masked pairs 0), then dV += P^T.dout and
//     dK += dS^T.Q, each as two bf16 products (below) with P^T and dS^T
//     from registers. The block owns its keys, so dK and dV need no
//     atomics and two runs give the same bits.
//   * flash_bwd_dq_tc: one block per (batch, head, 128-row q tile), as the
//     forward: Q and dout stay, k and v tiles of the visible keys stream
//     through the ring; S = Q.K^T, dP = dout.V^T, dS, then dQ += dS.K as
//     two bf16 products. A separate pass rather than f32 atomics from the
//     dK/dV kernel, so dq is the same bits every run.
//
// Precision, as the forward keeps it: Q.K^T and dout.V^T run on the bf16
// inputs, whose products are exact in f32; every product whose operand the
// plain route holds in f32 takes it as the two-term split bf16(x) +
// bf16(x - bf16(x)) (P in dV, dS in dK and dQ), ~2^-17 relative, never one
// bf16 rounding (the reference's pv_bf16 option). The tensor cores
// truncate each product's sum toward zero (tc_common.cuh), a bias that
// grows with the number of products chained into one accumulator: dK and
// dV of a block sum G x S / 16 x 2 of them (14336 at qwen2-0.5b's S 4096),
// so the chain is cut at each query head: the head's sums are added into
// the f32 dk and dv with round-to-nearest adds (each thread its own
// elements, in the output buffers, which the last head rounds to bf16).
// dQ's chain is S / 16 x 2 long at most, as the forward's P.V.
//
// Bound: at qwen2-0.5b's training call (B 8, S 4096, H 14, KV 2, hd 64,
// causal) each of the five products is 2 B H hd S (S + 1) / 2 = 120 GFLOP
// over the visible pairs. The function needs S and dP once and dV, dK and
// dQ as two bf16 products each (their f32 operand split): 8 of those, 0.96
// TFLOP, 0.97 ms at 989 TFLOP/s; its bytes (q, k, v, dout, dq, dk, dv in
// bf16, o and lse in f32, ~0.35 GB) take 0.1 ms at 3.35 TB/s, so
// operations bound it. The kernels run 12 (S and dP in both passes).
//
// Not yet: TMA under mbarriers from a producer warp, and letting the two
// warpgroups drift apart; S and dP are recomputed in both kernels (the
// price of a deterministic dQ).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tc_common.cuh"
#include "wgmma_common.cuh"

namespace {
namespace bwd {

using namespace wg;

constexpr int WARPGROUPS = 2;
constexpr int THREADS = 128 * WARPGROUPS;
constexpr int BR = 64 * WARPGROUPS;   // resident rows: keys (dK/dV), q (dQ)
constexpr int BT = 64;                // streamed rows: q (dK/dV), keys (dQ)
constexpr int NSTAGE = 2;             // ring depth
constexpr float LOG2E = 1.4426950408889634f;

// Both kernels: two resident BR-row tiles and NSTAGE pairs of BT-row
// tiles, bf16; the dK/dV kernel's lse and D tiles; 1024 for alignment.
template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BR + 2 * NSTAGE * BT) * HD * sizeof(bf16) +
         2 * NSTAGE * BT * sizeof(float) + 1024;
}

// One warp a row of (B, H, Sp): D = dout . o (f32), lse2 = lse * log2 e;
// rows at or past S get 0.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const bf16* __restrict__ dout, const float* __restrict__ o,
               const float* __restrict__ lse, float* __restrict__ lse2,
               float* __restrict__ dsum, int S, int Sp, int H) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;   // b * H * Sp + ...
  const int lane = threadIdx.x % 32;
  const int s = row % Sp, bh = row / Sp;
  const int b = bh / H, h = bh % H;
  float acc = 0.f;
  if (s < S) {
    const size_t off = (((size_t)b * S + s) * H + h) * HD;
#pragma unroll
    for (int c = 2 * lane; c < HD; c += 64) {
      const float2 d = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
      const float2 x = *reinterpret_cast<const float2*>(o + off + c);
      acc = fmaf(d.x, x.x, acc);
      acc = fmaf(d.y, x.y, acc);
    }
  }
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  if (lane == 0) {
    dsum[row] = acc;
    lse2[row] = s < S ? lse[(size_t)bh * S + s] * LOG2E : 0.f;
  }
}

// Adds a warpgroup's 64 x HD head sum `a` (rows kr[0], kr[1] of this
// thread) into the f32 rows of `acc32` (row stride `stride`); `first`
// stores instead, `last` also writes `scale` times the total, in f32 to
// acc32 and in bf16 to `out`. Zeroes `a`. All loads go out before the
// first add, so a flush waits on memory once.
template <int HD>
__device__ __forceinline__ void flush(float (&a)[HD / 2],
                                      float* __restrict__ acc32,
                                      bf16* __restrict__ out, size_t stride,
                                      const int (&kr)[2], int S, int tig,
                                      bool first, bool last, float scale) {
  if (!first) {
    float2 prev[2][HD / 8];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        prev[hf][j] = kr[hf] < S ? *reinterpret_cast<const float2*>(
                                       acc32 + (size_t)kr[hf] * stride +
                                       2 * tig + 8 * j)
                                 : make_float2(0.f, 0.f);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        a[4 * j + 2 * hf] = prev[hf][j].x + a[4 * j + 2 * hf];
        a[4 * j + 2 * hf + 1] = prev[hf][j].y + a[4 * j + 2 * hf + 1];
      }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (kr[hf] >= S) continue;
    float* w = acc32 + (size_t)kr[hf] * stride + 2 * tig;
    bf16* o = out + (size_t)kr[hf] * stride + 2 * tig;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float x = a[4 * j + 2 * hf], y = a[4 * j + 2 * hf + 1];
      if (last) {
        x *= scale;
        y *= scale;
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) =
            __floats2bfloat162_rn(x, y);
      }
      *reinterpret_cast<float2*>(w + 8 * j) = make_float2(x, y);
    }
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) a[i] = 0.f;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse2, const float* __restrict__ dsum,
             bf16* __restrict__ dk, bf16* __restrict__ dv,
             float* __restrict__ dk32, float* __restrict__ dv32, int S,
             int Sp, int H, int KV, int has_window, int window, float scale,
             float scale_log2) {
  constexpr int NS = NSTAGE;
  constexpr int KD = HD / 16;   // k steps over hd
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the swizzle acts on address bits 4-9
  bf16* Ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Vs = Ks + BR * HD;
  bf16* Qs = Vs + BR * HD;         // NS tiles
  bf16* Os = Qs + NS * BT * HD;    // dout, NS tiles
  float* Ls = reinterpret_cast<float*>(Os + NS * BT * HD);
  float* Ds = Ls + NS * BT;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * BR;   // the heaviest (lowest) keys first
  const size_t q_stride = (size_t)H * HD, k_stride = (size_t)KV * HD;
  const size_t kv_off = ((size_t)b * S * KV + kvh) * HD;

  // The q tiles that see some key of this block: rows from k0 (causal) to
  // the last key + window - 1.
  const int k_last = min(k0 + BR - 1, S - 1);
  const int qt_lo = k0 / BT;
  const int qt_hi = (has_window ? min(S - 1, k_last + window - 1) : S - 1) /
                    BT;
  const int nqt = qt_hi - qt_lo + 1;
  const int n = G * nqt;

  // Tile t: head kvh * G + t / nqt, q tile qt_lo + t % nqt, into stage st.
  auto load_stage = [&](int t, int st) {
    const int h = kvh * G + t / nqt;
    const int q0 = (qt_lo + t % nqt) * BT;
    const size_t off = ((size_t)b * S * H + h) * HD;
    load_tile<HD, BT, THREADS>(Qs + st * BT * HD, q + off, q_stride, q0, S,
                               tid);
    load_tile<HD, BT, THREADS>(Os + st * BT * HD, dout + off, q_stride, q0,
                               S, tid);
    if (tid < 2 * BT / 4) {   // 16-byte chunks of the lse and D tiles
      const int c = 4 * (tid % (BT / 4));
      const bool is_l = tid < BT / 4;
      const float* src = (is_l ? lse2 : dsum) + ((size_t)b * H + h) * Sp +
                         q0 + c;
      cp_async16(smem_u32((is_l ? Ls : Ds) + st * BT + c), src, true);
    }
  };

  // Prologue: K and V with the first NS - 1 tiles, one group each.
  load_tile<HD, BR, THREADS>(Ks, k + kv_off, k_stride, k0, S, tid);
  load_tile<HD, BR, THREADS>(Vs, v + kv_off, k_stride, k0, S, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n) load_stage(s, s);
    cp_async_commit();
  }

  // This thread's keys: rows g and g + 8 (hf = 0, 1) of its warp's 16.
  const int kw0 = k0 + wgi * 64 + warp * 16;
  const int kr[2] = {kw0 + g, kw0 + g + 8};
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int st = t % NS;
    const int q0 = (qt_lo + t % nqt) * BT;
    cp_async_wait<NS - 2>();   // tile t has landed ...
    fence_proxy_async();       // ... for wgmma ...
    __syncthreads();           // ... of every warpgroup; tile t - 1 is done
    {
      const int tn = t + NS - 1;
      if (tn < n) load_stage(tn, tn % NS);
      cp_async_commit();
    }
    const bf16* Qt = Qs + st * BT * HD;
    const bf16* Ot = Os + st * BT * HD;
    const float* Lt = Ls + st * BT;
    const float* Dt = Ds + st * BT;

    // S^T = K.Q^T and dP^T = V.dout^T over the warpgroup's 64 keys; s[4j +
    // e] holds q column 8j + 2tig + e % 2 of key row g + 8 (e / 2).
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = (kd >> 2) * 64 + (kd & 3) * 16;   // panel, 32-byte step
      wgmma_ss_n64(s, desc(Ks + sw<BR>(wgi * 64, c), 16, 1024),
                   desc(Qt + sw<BT>(0, c), 16, 1024), kd > 0);
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = (kd >> 2) * 64 + (kd & 3) * 16;
      wgmma_ss_n64(dp, desc(Vs + sw<BR>(wgi * 64, c), 16, 1024),
                   desc(Ot + sw<BT>(0, c), 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in f32; masked pairs (and q rows past S) are 0. A tile
    // every pair of which the warp's keys see needs no mask.
    const bool whole = q0 >= kw0 + 15 && q0 + BT - 1 < S &&
                       (!has_window || q0 + BT - 1 - kw0 < window);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + 8 * j + 2 * tig);
      const float2 dd = *reinterpret_cast<const float2*>(Dt + 8 * j + 2 * tig);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          float p = ex2(s[i] * scale_log2 - (e ? l2.y : l2.x));
          if (!whole) {
            const int qi = q0 + 8 * j + 2 * tig + e;
            const bool vis = qi >= kr[hf] && qi < S &&
                             (!has_window || qi - kr[hf] < window);
            p = vis ? p : 0.f;
          }
          s[i] = p;
          dp[i] = p * (dp[i] - (e ? dd.y : dd.x));
        }
    }

    // dV += P^T.dout and dK += dS^T.Q, 16 q rows a step, each operand
    // split in two bf16 terms; the accumulators' registers are the A
    // fragments.
    uint32_t ph[BT / 16][4], pl[BT / 16][4], sh[BT / 16][4], sl[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      split_frag(s, kk, ph[kk], pl[kk]);
      split_frag(dp, kk, sh[kk], sl[kk]);
    }
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wgmma_pv<HD, BT>(dva, ph[kk], Ot, kk);
      wgmma_pv<HD, BT>(dva, pl[kk], Ot, kk);
    }
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wgmma_pv<HD, BT>(dka, sh[kk], Qt, kk);
      wgmma_pv<HD, BT>(dka, sl[kk], Qt, kk);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dva);
    fence_regs(dka);

    if ((t + 1) % nqt == 0) {   // the head's last tile: cut the chain
      const int head = t / nqt;
      flush<HD>(dka, dk32 + kv_off, dk + kv_off, k_stride, kr, S, tig,
                head == 0, head == G - 1, scale);
      flush<HD>(dva, dv32 + kv_off, dv + kv_off, k_stride, kr, S, tig,
                head == 0, head == G - 1, 1.f);
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse2,
                const float* __restrict__ dsum, bf16* __restrict__ dq,
                float* __restrict__ dq32, int S, int Sp, int H, int KV,
                int has_window, int window, float scale, float scale_log2) {
  constexpr int NS = NSTAGE;
  constexpr int KD = HD / 16;
  constexpr int ND = HD / 8;   // 8-column groups of dq
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Os = Qs + BR * HD;         // dout
  bf16* Ks = Os + BR * HD;         // NS tiles
  bf16* Vs = Ks + NS * BT * HD;    // NS tiles

  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;   // heaviest first
  const size_t q_stride = (size_t)H * HD, k_stride = (size_t)KV * HD;
  const size_t q_off = ((size_t)b * S * H + h) * HD;
  const bf16* kb = k + ((size_t)b * S * KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * S * KV + kvh) * HD;

  // The k tiles some row of this block sees.
  const int q_last = min(q0 + BR - 1, S - 1);
  const int kt_begin = (has_window ? max(q0 - window + 1, 0) : 0) / BT;
  const int n = q_last / BT - kt_begin + 1;

  load_tile<HD, BR, THREADS>(Qs, q + q_off, q_stride, q0, S, tid);
  load_tile<HD, BR, THREADS>(Os, dout + q_off, q_stride, q0, S, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n) {
      const int kn = (kt_begin + s) * BT;
      load_tile<HD, BT, THREADS>(Ks + s * BT * HD, kb, k_stride, kn, S, tid);
      load_tile<HD, BT, THREADS>(Vs + s * BT * HD, vb, k_stride, kn, S, tid);
    }
    cp_async_commit();
  }

  // This thread's rows: g and g + 8 (hf = 0, 1) of its warp's 16.
  const int w0 = q0 + wgi * 64 + warp * 16;
  const int qr[2] = {w0 + g, w0 + g + 8};
  const size_t lrow = ((size_t)b * H + h) * Sp;   // rows < q0 + BR <= Sp
  const float l2[2] = {lse2[lrow + qr[0]], lse2[lrow + qr[1]]};
  const float dd[2] = {dsum[lrow + qr[0]], dsum[lrow + qr[1]]};
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;

  for (int t = 0; t < n; ++t) {
    const int k0 = (kt_begin + t) * BT;
    cp_async_wait<NS - 2>();
    fence_proxy_async();
    __syncthreads();
    {
      const int tn = t + NS - 1;
      if (tn < n) {
        const int sn = tn % NS, kn = (kt_begin + tn) * BT;
        load_tile<HD, BT, THREADS>(Ks + sn * BT * HD, kb, k_stride, kn, S,
                                   tid);
        load_tile<HD, BT, THREADS>(Vs + sn * BT * HD, vb, k_stride, kn, S,
                                   tid);
      }
      cp_async_commit();
    }
    const bf16* Kt = Ks + (t % NS) * BT * HD;
    const bf16* Vt = Vs + (t % NS) * BT * HD;

    // S = Q.K^T and dP = dout.V^T over the warpgroup's 64 rows.
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = (kd >> 2) * 64 + (kd & 3) * 16;
      wgmma_ss_n64(s, desc(Qs + sw<BR>(wgi * 64, c), 16, 1024),
                   desc(Kt + sw<BT>(0, c), 16, 1024), kd > 0);
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = (kd >> 2) * 64 + (kd & 3) * 16;
      wgmma_ss_n64(dp, desc(Os + sw<BR>(wgi * 64, c), 16, 1024),
                   desc(Vt + sw<BT>(0, c), 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool whole = k0 + BT - 1 <= w0 && w0 + 15 < S &&
                       (!has_window || w0 + 15 - k0 < window);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hf + e;
          float p = ex2(s[i] * scale_log2 - l2[hf]);
          if (!whole) {
            const int kj = k0 + 8 * j + 2 * tig + e;
            const bool vis = kj <= qr[hf] && qr[hf] < S &&
                             (!has_window || qr[hf] - kj < window);
            p = vis ? p : 0.f;
          }
          dp[i] = p * (dp[i] - dd[hf]);
        }

    // dQ += dS.K, dS split in two bf16 terms.
    uint32_t sh[BT / 16][4], sl[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) split_frag(dp, kk, sh[kk], sl[kk]);
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wgmma_pv<HD, BT>(dqa, sh[kk], Kt, kk);
      wgmma_pv<HD, BT>(dqa, sl[kk], Kt, kk);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dqa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (qr[hf] >= S) continue;
    const size_t at = q_off + (size_t)qr[hf] * q_stride + 2 * tig;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const float x = dqa[4 * j + 2 * hf] * scale;
      const float y = dqa[4 * j + 2 * hf + 1] * scale;
      *reinterpret_cast<__nv_bfloat162*>(dq + at + 8 * j) =
          __floats2bfloat162_rn(x, y);
      if (dq32 != nullptr)
        *reinterpret_cast<float2*>(dq32 + at + 8 * j) = make_float2(x, y);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* o, const void* lse,
                   void* lse2, void* dsum, void* dq, void* dk, void* dv,
                   void* dq32, void* dk32, void* dv32, int B, int S, int Sp,
                   int H, int KV, int has_window, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nr = (S + BR - 1) / BR;
  if (nr > 65535) return cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  float* l2 = static_cast<float*>(lse2);
  float* ds = static_cast<float*>(dsum);
  flash_bwd_prep<HD><<<B * H * Sp / 8, 256, 0, stream>>>(
      ob, static_cast<const float*>(o), static_cast<const float*>(lse), l2,
      ds, S, Sp, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_tc<HD><<<dim3(B * KV, nr), THREADS, smem, stream>>>(
      qb, kb, vb, ob, l2, ds, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dk32), static_cast<float*>(dv32), S, Sp, H, KV,
      has_window, window, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc<HD><<<dim3(B * H, nr), THREADS, smem, stream>>>(
      qb, kb, vb, ob, l2, ds, static_cast<bf16*>(dq),
      static_cast<float*>(dq32), S, Sp, H, KV, has_window, window, scale,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace bwd
}  // namespace

extern "C" {

// q, dout (B, S, H, hd), k, v (B, S, KV, hd): bf16, contiguous; o (B, S, H,
// hd) and lse (B, H, S): f32, the forward's residuals. Scratch: lse2 and
// dsum, (B, H, Sp) f32, Sp a multiple of 128 >= S. Out: dq, dk, dv in bf16
// and dk32, dv32 (B, S, KV, hd) in f32; dq32 (B, S, H, hd) f32 where not
// null. hd 64 or 128. Three launches on `stream`; returns
// cudaGetLastError() after the last (0 = success). Does not synchronise.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* o,
                               const void* lse, void* lse2, void* dsum,
                               void* dq, void* dk, void* dv, void* dq32,
                               void* dk32, void* dv32, int B, int S, int Sp,
                               int H, int KV, int hd, int has_window,
                               int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV || Sp < S ||
      Sp % bwd::BR || (has_window && window < 1) || B * H >= 65536 ||
      B * KV >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return static_cast<int>(bwd::launch<64>(
          q, k, v, dout, o, lse, lse2, dsum, dq, dk, dv, dq32, dk32, dv32, B,
          S, Sp, H, KV, has_window, window, scale, s));
    case 128:
      return static_cast<int>(bwd::launch<128>(
          q, k, v, dout, o, lse, lse2, dsum, dq, dk, dv, dq32, dk32, dv32, B,
          S, Sp, H, KV, has_window, window, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
