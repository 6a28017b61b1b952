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

// hd rounded up to whole 64-column groups (120 -> 128): the kernels keep
// v (and, in bf16, q and k) in shared memory padded with zero columns,
// which add nothing to Q.K^T and give output columns that are not
// stored.
template <int HD>
__host__ __device__ constexpr int padded() {
  return (HD + 63) / 64 * 64;
}

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

using bf16 = __nv_bfloat16;

constexpr int WARPGROUPS = 2;            // each owns 64 q rows
constexpr int THREADS = 128 * WARPGROUPS;
constexpr int BQ = 64 * WARPGROUPS;      // q rows a block
constexpr int BKV = 64;                  // keys a k/v tile
constexpr int NSTAGE = 2;                // k/v ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr size_t smem_bytes() {          // + 1024 for the alignment below
  return (size_t)(BQ + 2 * NSTAGE * BKV) * padded<HD>() * sizeof(bf16) +
         1024;
}

// Element (r, c) of a ROWS-row tile kept as 64-column panels, each in
// wgmma's 128-byte-swizzle layout: 128-byte rows whose 16-byte chunks are
// XORed with r % 8 (the bank groups of 8 rows differ). A panel is both
// the K-major operand (rows = M or N, 64 contiguous k) and, for v, the
// MN-major one (rows = k, 64 contiguous n).
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
// swizzled panels padded to padded<HD>() columns; rows at or past `rows`
// and the pad columns are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int rows,
                                          int tid) {
  constexpr int CPR = padded<HD>() / 8;   // 16-byte chunks a padded row
#pragma unroll
  for (int e = tid; e < ROWS * CPR; e += THREADS) {
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

// o (64 x HP) += A (64 x 16 keys, registers) . V (keys 16kk.., smem,
// MN-major): one m64n64k16 at HP 64, one m64n128k16 per 128 columns
// above (two at HP 256, each on its half of o and of v's panels).
template <int HP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HP / 2],
                                         const uint32_t (&a)[4],
                                         const bf16* Vt, int kk) {
  if constexpr (HP == 64) {
    wgmma_rs_n64(o, a, desc(Vt + sw<BKV>(kk * 16, 0), BKV * 128, 1024));
  } else {
    static_assert(HP % 128 == 0, "P.V takes 64 or a multiple of 128 columns");
#pragma unroll
    for (int n0 = 0; n0 < HP; n0 += 128)
      wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + n0 / 2), a,
                    desc(Vt + sw<BKV>(kk * 16, n0), BKV * 128, 1024));
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

template <int HD>
__global__ void __launch_bounds__(THREADS, min_blocks<HD>())
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
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
  load_tile<HD, BQ>(Qs, qb, q_stride, q0, Sq, tid);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) {
      const int k0 = (kt_begin + s) * BKV;
      load_tile<HD, BKV>(Ks + s * BKV * HP, kb, k_stride, k0, Sk, tid);
      load_tile<HD, BKV>(Vs + s * BKV * HP, vb, k_stride, k0, Sk, tid);
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
        load_tile<HD, BKV>(Ks + st * BKV * HP, kb, k_stride, kn, Sk, tid);
        load_tile<HD, BKV>(Vs + st * BKV * HP, vb, k_stride, kn, Sk, tid);
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
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)   // fragment j: keys 16kk + 8 (j / 2)..
        split_pair(s[4 * (2 * kk + j / 2) + 2 * (j % 2)],
                   s[4 * (2 * kk + j / 2) + 2 * (j % 2) + 1], ph[kk][j],
                   pl[kk][j]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wgmma_pv<HP>(o, ph[kk], Vt, kk);
      wgmma_pv<HP>(o, pl[kk], Vt, kk);
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
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int has_window, int window, float scale,
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
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, KV,
      causal, has_window, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32 (flash_fwd), 1 = bfloat16 (flash_fwd_tc); hd: 64,
// 120, 128 or 256. One launch on `stream`; returns cudaGetLastError()
// after it (0 = success). Does not synchronise.
template <int HD>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int KV,
                         int causal, int has_window, int window, float scale,
                         int dtype, cudaStream_t s) {
  if (dtype == 0)
    return launch<HD>(q, k, v, out, B, Sq, Sk, H, KV, causal, has_window,
                      window, scale, s);
  if (dtype == 1)
    return tc::launch<HD>(q, k, v, out, B, Sq, Sk, H, KV, causal, has_window,
                          window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int KV,
                           int hd, int causal, int has_window, int window,
                           float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return static_cast<int>(launch_dtype<64>(q, k, v, out, B, Sq, Sk, H,
                                               KV, causal, has_window, window,
                                               scale, dtype, s));
    case 120:
      return static_cast<int>(launch_dtype<120>(q, k, v, out, B, Sq, Sk, H,
                                                KV, causal, has_window,
                                                window, scale, dtype, s));
    case 128:
      return static_cast<int>(launch_dtype<128>(q, k, v, out, B, Sq, Sk, H,
                                                KV, causal, has_window,
                                                window, scale, dtype, s));
    case 256:
      return static_cast<int>(launch_dtype<256>(q, k, v, out, B, Sq, Sk, H,
                                                KV, causal, has_window,
                                                window, scale, dtype, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
