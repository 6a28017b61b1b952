// Blockwise online-softmax attention for Hopper (sm_90a), f32 FMA.
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
// block (masked ones too) and needs Sq % bq == Sk % bk == 0. Here:
//
//   * One block of 256 threads per (64-row q tile, b * H + h). Its k loop
//     takes the place of the sequential nk grid axis; m, l and the
//     accumulator stay in registers, in f32. Blocks are issued heaviest
//     first (the last q tiles see the most keys under a causal mask).
//   * The q tile is loaded once, widened to f32 and scaled by hd^-0.5 in
//     f32, as the reference does. k and v of kv head h / G stream through
//     shared memory in 64-row tiles; q and k are stored transposed, so
//     that each thread reads 4 rows of q and 4 keys as one float4 each.
//   * Each thread owns a 4 x 4 patch of the 64 x 64 score tile (16
//     threads per row group, reduced with a fixed xor tree, so every lane
//     of a row holds the same m and l), then 4 rows x hd/16 columns of
//     the output for P @ V, P going through shared memory.
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
// Bound: at the qwen2-0.5b prefill (B 4, S 2048, H 14, KV 2, hd 64,
// causal) the two products are 4 * B * H * hd * S^2 / 2 = 30 GFLOP on
// ~34 MB of q, k, v and out (bf16), so operations bound it. In bf16 at
// hd 64 the q scale 1/8 is exact, so Q.K^T (15 GFLOP) could run on the
// tensor cores at 989 TFLOP/s, while P.V (15 GFLOP, f32 P) needs 67
// TFLOP/s of f32 FMA: 0.24 ms (0.45 ms in f32). This first version uses
// f32 FMA only: no tensor cores (wgmma), no TMA, no cp.async pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BKV = 64;       // keys per k/v tile
constexpr int THREADS = 256;  // 16 row groups x 16 key/column groups
constexpr int TPAD = 4;       // pads transposed rows, keeps float4 alignment
constexpr float L_MIN = 1e-30f;

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

// Visible keys of query row i are [key_lo(i), key_hi(i)]; empty when
// key_lo > key_hi. Both are non-decreasing in i, and so is emptiness.
__device__ __forceinline__ int key_lo(int i, int has_window, int window) {
  return has_window ? max(i - window + 1, 0) : 0;
}
__device__ __forceinline__ int key_hi(int i, int Sk, int causal) {
  return causal ? min(i, Sk - 1) : Sk - 1;
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * (BQ + TPAD)       // Qt: q tile, transposed, scaled
         + (size_t)HD * (BKV + TPAD)    // Kt: k tile, transposed
         + (size_t)BKV * HD             // Vs: v tile
         + (size_t)BKV * (BQ + TPAD);   // Pt: probabilities, transposed
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int H,
          int KV, int causal, int has_window, int window, float scale) {
  constexpr int NC = HD / 64;   // 4-wide output column groups per thread
  constexpr int QLD = BQ + TPAD;
  constexpr int KLD = BKV + TPAD;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + HD * QLD;
  float* Vs = Kt + HD * KLD;
  float* Pt = Vs + BKV * HD;

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
    for (int e = tid; e < BKV * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      const int s = k0 + r;
      const bool in = s < Sk;
      Kt[d * KLD + r] = in ? to_f32(kb[(size_t)s * k_stride + d]) : 0.f;
      Vs[r * HD + d] = in ? to_f32(vb[(size_t)s * k_stride + d]) : 0.f;
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
            *reinterpret_cast<const float4*>(&Vs[c * HD + g * 64 + tx * 4]);
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
        ob[(size_t)s * q_stride + g * 64 + tx * 4 + j] =
            from_f32<T>(acc[i][g * 4 + j] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int has_window, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, causal,
      has_window, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; hd: 64 or 128. Returns
// cudaGetLastError() after the launch on `stream` (0 = success). Does not
// synchronise.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int KV,
                           int hd, int causal, int has_window, int window,
                           float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return static_cast<int>(launch<float, 64>(q, k, v, out, B, Sq, Sk, H, KV,
                                              causal, has_window, window,
                                              scale, s));
  if (dtype == 0 && hd == 128)
    return static_cast<int>(launch<float, 128>(q, k, v, out, B, Sq, Sk, H, KV,
                                               causal, has_window, window,
                                               scale, s));
  if (dtype == 1 && hd == 64)
    return static_cast<int>(launch<__nv_bfloat16, 64>(
        q, k, v, out, B, Sq, Sk, H, KV, causal, has_window, window, scale, s));
  if (dtype == 1 && hd == 128)
    return static_cast<int>(launch<__nv_bfloat16, 128>(
        q, k, v, out, B, Sq, Sk, H, KV, causal, has_window, window, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
