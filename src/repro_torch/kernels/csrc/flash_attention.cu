// Blockwise online-softmax attention for Hopper (sm_90a): a bf16 kernel
// on the tensor cores and an f32 kernel on the FMA pipe.
//
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / G],
//   s_ij = (q[b, i, h] * hd^-0.5) . k[b, j, h / G]   over visible j
//
// q (B, Sq, H, hd), k and v (B, Sk, KV, hd): contiguous, all f32 or all
// bf16; G = H / KV. Visible: j < Sk, and j <= i when causal, and
// i - j < window when a window is given. The output is in q's dtype.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// `_kernel`). That TPU kernel walks a (B, H, nq, nk) grid with nk
// innermost, keeping the running max m, sum l and the (bq, hd)
// accumulator in VMEM scratch across the nk steps, executes every k
// block (masked ones too) and needs Sq % bq == Sk % bk == 0. It widens
// q, k and v to f32, forms s and p = exp(s - m) in f32, and accumulates
// p . v in f32. Both kernels here keep that function; in both, a
// block's k loop takes the place of the sequential nk grid axis, m, l
// and the accumulator stay in f32 registers, and:
//
//   * k tiles that no row of the block can see (above the causal
//     diagonal, below the window's band) are skipped; ragged Sq and Sk
//     are masked, so prompt lengths are arbitrary.
//   * Masked scores are left out of the softmax (p = 0). The reference
//     sets them to -1e30 instead; for every row that sees at least one
//     key the two agree (a -1e30 score gives exp(...) = 0, and a block
//     processed before the row's first visible key is wiped by the
//     correction exp(-1e30 - m) = 0). A row that sees no key at all
//     averages v over every key in the reference (softmax of equal
//     scores), and does so here: such rows are known from the positions
//     alone, and read every k tile with a score of 0.
//   * l is clamped at 1e-30 before the division, as in the reference.
//
// Head widths: 64 (qwen2, tinyllama), 120 (h2o-danube), 128 (qwen3) and
// 256 (recurrentgemma), each a template instance of both kernels. Rows
// are kept in shared memory padded to whole 64-column groups (120 ->
// 128): the pad columns of q, k and v are zero-filled, add nothing to
// Q.K^T, and give output columns that are never stored, so hd 120 runs
// the hd-128 arithmetic on 128 / 120 of its work. At hd 256 the bf16
// kernel's output accumulator is 128 f32 registers a thread and its
// shared memory 193 KB (the f32 kernel's 217 KB): one block an SM, up
// to 255 registers a thread; P.V is two m64n128k16 products per 16 keys,
// one on each half of v's panels.
//
// Bound: at the qwen2-0.5b prefill (B 4, S 2048, H 14, KV 2, hd 64,
// causal) Q.K^T and P.V each do 2 * B * H * hd * S^2 / 2 = 15 GFLOP on
// ~34 MB of q, k, v and out (bf16), so operations bound both kernels.
//
// bf16 (flash_fwd_tc): the tensor cores, through wgmma (Hopper's
// warpgroup products) with f32 accumulation. Its bound is 45 GFLOP at
// 989 TFLOP/s, 0.046 ms:
//
//   * Q.K^T on bf16 operands. Products of bf16 values are exact in f32,
//     so the scores are the reference's up to summation order; hd^-0.5
//     (with log2 e folded in, for exp2) multiplies the f32 scores after
//     the product instead of q before it: one f32 rounding apart, at hd
//     128 as well, where the scale is not a power of two.
//   * P.V with P split in two: p_hi = bf16(p), p_lo = bf16(p - p_hi),
//     two bf16 products into one f32 accumulator. p_hi + p_lo matches the
//     f32 p to about 2^-17 relative, far below one bf16 rounding of the
//     output; p rounded to bf16 alone (what SDPA does) is a different
//     function and misses the bf16 elementwise gate several-fold. The
//     split makes P.V two products: 15 + 2 * 15 GFLOP in all.
//   * Layout (FlashAttention-3 style, without its producer warp): two
//     warpgroups a block, each owning 64 q rows. Q.K^T is one wgmma
//     m64n64k16 per 16 of hd with both operands read from shared memory; P.V
//     is two m64n{hd}k16 per 16 keys (hi, lo) with P from registers (wgmma's
//     accumulator layout over 16 keys is its A-fragment layout, so P never
//     leaves registers) and v read transposed from shared memory through its
//     descriptor. q, k and v tiles are stored in wgmma's 128-byte swizzle,
//     in 64-column panels. k and v arrive in 64-key tiles through a 2-stage
//     cp.async ring, the next tile in flight while the current one is
//     multiplied; one __syncthreads() per k tile. The online softmax runs in
//     f32 registers; each row lives in one quad of lanes and is reduced with
//     a fixed xor tree, so all four agree bit for bit. Masks are applied
//     only on tiles some row of the warp cannot fully see. Two blocks share
//     an SM (128 registers a thread) up to hd 128.
//   * Grid (B * H, q tiles) with the q tiles in the slow axis, last
//     first: under a causal mask the heaviest tiles of every head are
//     issued before any light one.
//   * Residuals for the backward (flash_attention_bwd.cu), written only
//     where the caller passes their buffers (a null pointer otherwise, so
//     the no-grad calls store what they did): each row's log-sum-exp of
//     the scaled scores, (m + log2 l) ln 2 from the online softmax's own
//     max and sum, and the output in f32 before its rounding to bf16, from
//     which the backward's rowsum(dout * o) is taken.
//   * Not yet: TMA copies under mbarriers from a producer warp (which
//     would let the two warpgroups drift apart instead of meeting at every
//     tile, and make room for FlashAttention-3's ping-pong of one
//     warpgroup's softmax under the other's products), and packing the G
//     q heads that share a kv head into one block.
//
// f32 (flash_fwd): the first version of this kernel, on the FMA pipe, kept
// as it was; it serves the f32 token and logits gates. One block of 256
// threads per (64-row q tile, b * H + h); q is widened and scaled by hd^-0.5
// in f32 as the reference does; k and v of kv head h / G stream through
// shared memory in 64-row tiles, q and k stored transposed so that each
// thread reads 4 rows of q and 4 keys as one float4 each; each thread owns a
// 4 x 4 patch of the 64 x 64 score tile (16 threads per row group, reduced
// with a fixed xor tree), then 4 rows x hd/16 columns of the output for P @
// V, P going through shared memory. Its bound is 30 GFLOP at the f32 FMA
// rate (67 TFLOP/s), 0.45 ms; no tensor cores, no cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "tc_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // keys per k/v tile
constexpr int THREADS = 256;  // 16 row groups x 16 key/column groups
constexpr int TPAD = 4;       // pads transposed rows, keeps float4 alignment
constexpr float L_MIN = 1e-30f;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// Visible keys of query row i are [key_lo(i), key_hi(i)]; empty when
// key_lo > key_hi. Both are non-decreasing in i, and so is emptiness.
__device__ __forceinline__ int key_lo(int i, int has_window, int window) {
  return has_window ? max(i - window + 1, 0) : 0;
}
__device__ __forceinline__ int key_hi(int i, int Sk, int causal) {
  return causal ? min(i, Sk - 1) : Sk - 1;
}

// hd rounded up to whole 64-column groups (wgmma_common.cuh): the kernels
// keep v (and, in bf16, q and k) in shared memory padded with zero columns.
using wg::padded;

// Blocks an SM holds: at hd 256 one, so that a thread may use up to 255
// registers (the output alone takes 128 in bf16).
template <int HD>
__host__ __device__ constexpr int min_blocks() {
  return HD > 128 ? 1 : 2;
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * (BQ + TPAD)             // Qt: q tile, transposed, scaled
         + (size_t)HD * (BKV + TPAD)          // Kt: k tile, transposed
         + (size_t)BKV * padded<HD>()         // Vs: v tile, zero-padded
         + (size_t)BKV * (BQ + TPAD);         // Pt: probabilities, transposed
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, min_blocks<HD>())
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
          int KV, int causal, int has_window, int window, float scale) {
  constexpr int HP = padded<HD>();
  constexpr int NC = HP / 64;   // 4-wide output column groups per thread
  constexpr int QLD = BQ + TPAD;
  constexpr int KLD = BKV + TPAD;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + HD * QLD;
  float* Vs = Kt + HD * KLD;
  float* Pt = Vs + BKV * HP;

  const int tid = threadIdx.x;
  const int ty = tid / 16;      // row group: rows ty*4 .. ty*4+3
  const int tx = tid % 16;      // key group / output column group
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const size_t q_stride = (size_t)H * HD;    // between positions
  const size_t k_stride = (size_t)KV * HD;
  const T* qb = q + ((size_t)b * Sq * H + h) * HD;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  T* ob = out + ((size_t)b * Sq * H + h) * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int s = q0 + r;
    Qt[d * QLD + r] = s < Sq ? to_f32(qb[(size_t)s * q_stride + d]) * scale : 0.f;
  }

  int lo[4], hi[4];
  bool empty[4];
  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lo[i] = key_lo(qi, has_window, window);
    hi[i] = key_hi(qi, Sk, causal);
    empty[i] = lo[i] > hi[i];
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // The k tiles some row of this block can see.
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  int kt_begin = 0, kt_end = (Sk - 1) / BKV;
  if (key_lo(q_last, has_window, window) <= key_hi(q_last, Sk, causal)) {
    kt_begin = key_lo(q0, has_window, window) / BKV;
    kt_end = key_hi(q_last, Sk, causal) / BKV;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();   // the previous tile's Kt, Vs and Pt are consumed
    for (int e = tid; e < BKV * HP; e += THREADS) {
      const int r = e / HP, d = e % HP;
      const int s = k0 + r;
      const bool in = s < Sk && d < HD;
      if (d < HD)
        Kt[d * KLD + r] = in ? to_f32(kb[(size_t)s * k_stride + d]) : 0.f;
      Vs[r * HP + d] = in ? to_f32(vb[(size_t)s * k_stride + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * QLD + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * KLD + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }

    // Online softmax, one row at a time; the 16 lanes of a row group
    // reduce with the same xor tree, so they agree bit for bit.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        const bool vis = empty[i] ? kj < Sk : (kj >= lo[i] && kj <= hi[i]);
        sc[i][j] = vis ? (empty[i] ? 0.f : sc[i][j]) : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float corr = 1.f, rs = 0.f;
      if (m_new == -INFINITY) {
        // nothing visible to this row yet: it takes no weight
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      } else {
        corr = expf(m[i] - m_new);       // 0 while m is still -inf
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = expf(sc[i][j] - m_new);   // masked: exp(-inf) = 0
          rs += sc[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * QLD + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

    // acc += P @ V over the tile's keys (masked and ragged keys have
    // p = 0 and v = 0).
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[c * QLD + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NC; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[c * HP + g * 64 + tx * 4]);
        const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(pv[i], vw[j], acc[i][g * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], L_MIN);
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g * 64 + tx * 4 + j < HD)   // padded columns are not stored
          ob[(size_t)s * q_stride + g * 64 + tx * 4 + j] =
              from_f32<T>(acc[i][g * 4 + j] / denom);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int has_window, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd<float, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KV,
      causal, has_window, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores.
namespace tc {

using namespace wg;

constexpr int WARPGROUPS = 2;            // each owns 64 q rows
constexpr int THREADS = 128 * WARPGROUPS;
constexpr int BQ = 64 * WARPGROUPS;      // q rows a block
constexpr int BKV = 64;                  // keys a k/v tile
constexpr int NSTAGE = 2;                // k/v ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
constexpr size_t smem_bytes() {          // + 1024 for the alignment below
  return (size_t)(BQ + 2 * NSTAGE * BKV) * padded<HD>() * sizeof(bf16) +
         1024;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, min_blocks<HD>())
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out,
             float* __restrict__ lse, float* __restrict__ out32, int Sq,
             int Sk, int H, int KV, int causal, int has_window, int window,
             float scale_log2) {
  constexpr int NS = NSTAGE;
  constexpr int HP = padded<HD>();   // shared-memory row width
  constexpr int KD = HP / 16;    // k steps of Q.K^T
  constexpr int ND = HP / 8;     // 8-column groups of the output
  constexpr int NK = BKV / 8;    // 8-key groups of the scores
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the swizzle acts on address bits 4-9
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* Ks = Qs + BQ * HP;
  bf16* Vs = Ks + NS * BKV * HP;

  const int tid = threadIdx.x;
  const int wg = tid / 128;                  // this thread's warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;    // fragment row, column pair
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t q_stride = (size_t)H * HD;    // between positions
  const size_t k_stride = (size_t)KV * HD;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * HD;
  const bf16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  bf16* ob = out + ((size_t)b * Sq * H + h) * HD;

  // The k tiles some row of this block can see.
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  int kt_begin = 0, kt_end = (Sk - 1) / BKV;
  if (key_lo(q_last, has_window, window) <= key_hi(q_last, Sk, causal)) {
    kt_begin = key_lo(q0, has_window, window) / BKV;
    kt_end = key_hi(q_last, Sk, causal) / BKV;
  }
  const int n_tiles = kt_end - kt_begin + 1;

  // Prologue: q with the first NS - 1 k/v tiles, one group each.
  load_tile<HD, BQ, THREADS>(Qs, qb, q_stride, q0, Sq, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) {
      const int k0 = (kt_begin + s) * BKV;
      load_tile<HD, BKV, THREADS>(Ks + s * BKV * HP, kb, k_stride, k0, Sk, tid);
      load_tile<HD, BKV, THREADS>(Vs + s * BKV * HP, vb, k_stride, k0, Sk, tid);
    }
    cp_async_commit();
  }

  // This thread's rows: g and g + 8 (hf = 0, 1) of its warp's 16.
  const int w0 = q0 + wg * 64 + warp * 16;   // the warp's first row
  const int w_lo_last = key_lo(w0 + 15, has_window, window);
  const int w_hi_first = key_hi(w0, Sk, causal);
  int lo[2], hi[2];
  bool empty[2];
  float m[2], l[2], o[HP / 2];   // o[4j + e]: column 8j + 2tig + e % 2
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qi = w0 + g + 8 * hf;
    lo[hf] = key_lo(qi, has_window, window);
    hi[hf] = key_hi(qi, Sk, causal);
    empty[hf] = lo[hf] > hi[hf];
    m[hf] = -INFINITY;
    l[hf] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < HP / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = (kt_begin + t) * BKV;
    cp_async_wait<NS - 2>();   // tile t has landed ...
    fence_proxy_async();       // ... for wgmma ...
    __syncthreads();           // ... of every warpgroup; tile t - 1 is done
    {
      const int tn = t + NS - 1;
      if (tn < n_tiles) {
        const int st = tn % NS, kn = (kt_begin + tn) * BKV;
        load_tile<HD, BKV, THREADS>(Ks + st * BKV * HP, kb, k_stride, kn, Sk, tid);
        load_tile<HD, BKV, THREADS>(Vs + st * BKV * HP, vb, k_stride, kn, Sk, tid);
      }
      cp_async_commit();
    }
    const bf16* Kt = Ks + (t % NS) * BKV * HP;
    const bf16* Vt = Vs + (t % NS) * BKV * HP;

    // S = Q . K^T over the warpgroup's 64 rows; s[4j + e] holds key
    // 8j + 2tig + e % 2 of row g + 8 (e / 2).
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = (kd >> 2) * 64 + (kd & 3) * 16;   // panel, 32-byte step
      wgmma_ss_n64(s, desc(Qs + sw<BQ>(wg * 64, c), 16, 1024),
                   desc(Kt + sw<BKV>(0, c), 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // Online softmax in the log2 domain, one row at a time. A tile that
    // every row of the warp sees whole needs no mask.
    const bool whole = k0 >= w_lo_last && k0 + BKV - 1 <= w_hi_first;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * hf + e] * scale_log2;
          if (!whole) {
            const int kj = k0 + j * 8 + 2 * tig + e;
            const bool vis =
                empty[hf] ? kj < Sk : (kj >= lo[hf] && kj <= hi[hf]);
            x = vis ? (empty[hf] ? 0.f : x) : -INFINITY;
          }
          s[4 * j + 2 * hf + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      float corr = 1.f, rs = 0.f;
      if (m_new == -INFINITY) {
        // nothing visible to this row yet: it takes no weight
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) s[4 * j + 2 * hf + e] = 0.f;
      } else {
        corr = ex2(m[hf] - m_new);   // 0 while m is still -inf
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(s[4 * j + 2 * hf + e] - m_new);
            s[4 * j + 2 * hf + e] = p;
            rs += p;
          }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hf] = l[hf] * corr + rs;
      m[hf] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[4 * j + 2 * hf] *= corr;
        o[4 * j + 2 * hf + 1] *= corr;
      }
    }

    // O += P_hi . V + P_lo . V, 16 keys a step (masked and ragged keys
    // have p = 0 and v = 0). The score registers are P's A fragments:
    // wgmma's accumulator layout over 16 keys is its A layout.
    uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) split_frag(s, kk, ph[kk], pl[kk]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wgmma_pv<HP, BKV>(o, ph[kk], Vt, kk);
      wgmma_pv<HP, BKV>(o, pl[kk], Vt, kk);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
  }
  cp_async_wait<0>();   // no copy outlives the block

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = w0 + g + 8 * hf;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[hf], L_MIN);
    bf16* orow = ob + (size_t)row * q_stride + 2 * tig;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      if (j * 8 < HD)   // padded columns are not stored
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2 * hf] / denom,
                                  o[4 * j + 2 * hf + 1] / denom);
    // The backward's residuals, where asked for: the output before its
    // rounding to bf16, and the row's log-sum-exp of the scaled scores
    // (natural log: m and l are kept in the log2 domain).
    if (out32 != nullptr) {
      float* frow = out32 + ((size_t)b * Sq * H + h) * HD +
                    (size_t)row * q_stride + 2 * tig;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        if (j * 8 < HD)
          *reinterpret_cast<float2*>(frow + j * 8) =
              make_float2(o[4 * j + 2 * hf] / denom,
                          o[4 * j + 2 * hf + 1] / denom);
    }
    if (lse != nullptr && tig == 0)
      lse[((size_t)b * H + h) * Sq + row] = (m[hf] + log2f(denom)) * LN2;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, void* out32, int B, int Sq, int Sk, int H,
                   int KV, int causal, int has_window, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int nq = (Sq + BQ - 1) / BQ;
  if (nq > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * H, nq);
  flash_fwd_tc<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), static_cast<float*>(out32), Sq, Sk, H, KV,
      causal, has_window, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32 (flash_fwd), 1 = bfloat16 (flash_fwd_tc); hd: 64,
// 120, 128 or 256. lse (B, H, Sq) and out32 (B, Sq, H, hd), both f32, are
// written where not null (bf16 only). One launch on `stream`; returns
// cudaGetLastError() after it (0 = success). Does not synchronise.
template <int HD>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* out, void* lse, void* out32, int B, int Sq,
                         int Sk, int H, int KV, int causal, int has_window,
                         int window, float scale, int dtype, cudaStream_t s) {
  if (dtype == 0 && lse == nullptr && out32 == nullptr)
    return launch<HD>(q, k, v, out, B, Sq, Sk, H, KV, causal, has_window,
                      window, scale, s);
  if (dtype == 1)
    return tc::launch<HD>(q, k, v, out, lse, out32, B, Sq, Sk, H, KV, causal,
                          has_window, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, void* out32, int B, int Sq,
                           int Sk, int H, int KV, int hd, int causal,
                           int has_window, int window, float scale, int dtype,
                           void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return static_cast<int>(launch_dtype<64>(q, k, v, out, lse, out32, B,
                                               Sq, Sk, H, KV, causal,
                                               has_window, window, scale,
                                               dtype, s));
    case 120:
      return static_cast<int>(launch_dtype<120>(q, k, v, out, lse, out32, B,
                                                Sq, Sk, H, KV, causal,
                                                has_window, window, scale,
                                                dtype, s));
    case 128:
      return static_cast<int>(launch_dtype<128>(q, k, v, out, lse, out32, B,
                                                Sq, Sk, H, KV, causal,
                                                has_window, window, scale,
                                                dtype, s));
    case 256:
      return static_cast<int>(launch_dtype<256>(q, k, v, out, lse, out32, B,
                                                Sq, Sk, H, KV, causal,
                                                has_window, window, scale,
                                                dtype, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
