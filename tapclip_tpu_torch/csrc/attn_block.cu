// K2: fused attention half-block,
//   out = x + out_proj(softmax_masked(q k^T / sqrt(Dh)) v),  q, k, v = qkv_proj(LN(x)).
//
// Replaces tapclip_tpu/ops/fused_mha.py::_attn_block_kernel (the pallas_call in
// _attn_block_fwd_impl).  Two launches inside one wrapper
// (tapclip_tpu_torch/ops/fused_mha.py::fused_attn_block):
//
//   (i)  attn_block_core: one block per (batch row, head).  LayerNorm
//        statistics of the batch row's T tokens in f32; the head's q, k and v
//        column slices of the QKV product for all T tokens (LN applied on the
//        fly as the [64, 32] operand tiles are staged in shared memory); then
//        masked softmax attention over 64-row query tiles (attn_tile.cuh).
//        q and k stay in f32 and v is rounded to the compute dtype, as in the
//        JAX kernel.  The head's q, k, v go to an f32 workspace [B, H, 3, T, Dh]
//        that the wrapper allocates and the same block reads back; the
//        [B, H, T, T] scores never leave the chip.  Output: attn [B, T, W].
//   (ii) gemm_bias_residual: out = attn @ w_out + b_out + x, a tiled GEMM with
//        the bias and residual in its epilogue.
//
// What bounds it on the card: the serial work of each (i) block, from a
// block-count probe (no profiler trace yet).  Most of its operations are in
// the QKV and output projections (2 x B x T x W x 4W flops; the attention
// core is 4 x B x T^2 x W), but it reaches 9.1 TFLOP/s, 14% of the f32 FMA
// peak.  On an H100 80GB HBM3 at 700 W, 48 to 132 blocks for (i) (B = 4 to
// 11 at the image shape) take 0.87 to 1.00 ms and 144 blocks 1.31 ms: the
// time is that of one block's pass over its head (all T tokens' QKV slice,
// the LayerNorm statistics of its batch row, the attention), with one block
// per SM, and the grid (B x H = 96 at the image shape, 64 at the text
// shape) does not fill the 132 SMs.  Splitting (i) over query-row tiles and
// tensor-core MMA are the next steps.  A
// Hopper block has at most 227 KB of shared memory, so the JAX kernel's
// full [T, T] score tile (160 KB at T = 200 in f32) is replaced by 64 x 64
// tiles with an online softmax; T = 200 and T = 88 are not multiples of 64,
// so every tile masks its ragged edge.  Products run on the FMA units in f32
// for both dtypes (tensor-core MMA is later work).
// Padded query rows (valid <= t < T) are computed like any other row, so
// they stay finite through every layer.
// The core's device code (LN statistics, the head's QKV slice, the attention
// tiles) lives in attn_core.cuh, which the A/B variants (attn_variants_*.cu)
// and the fused layer (fused_layer.cu) share; K2 instantiates its default
// configuration.
#include "attn_core.cuh"
#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kThreads = kCoreThreads;
constexpr int kKTile = 32;  // reduction depth per staged tile of the GEMM below

// out[M, N] = a[M, K] @ w[K, N] + bias[N] + res[M, N]; 64 x 64 tiles, 4 x 4 per thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_bias_residual_kernel(const T* __restrict__ a, const T* __restrict__ w,
                          const float* __restrict__ bias, const T* __restrict__ res,
                          T* __restrict__ out, int M, int N, int K) {
  __shared__ float a_s[64][kKTile + 1];
  __shared__ float w_s[kKTile][64];
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKTile) {
    for (int e = tid; e < 64 * kKTile; e += kThreads) {
      const int r = e / kKTile, kk = e % kKTile;
      const int m = m0 + r, k = k0 + kk;
      a_s[r][kk] = (m < M && k < K) ? to_f(a[static_cast<size_t>(m) * K + k]) : 0.f;
    }
    for (int e = tid; e < kKTile * 64; e += kThreads) {
      const int kk = e / 64, c = e % 64;
      const int k = k0 + kk, n = n0 + c;
      w_s[kk][c] = (k < K && n < N) ? to_f(w[static_cast<size_t>(k) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKTile; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[rg + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w_s[kk][cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + rg + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + cg + 16 * j;
      if (n >= N) continue;
      const size_t off = static_cast<size_t>(m) * N + n;
      out[off] = from_f<T>((acc[i][j] + bias[n]) + to_f(res[off]));
    }
  }
}

template <typename T, int DH>
cudaError_t launch_core(const void* x, const float* gamma, const float* beta,
                        const void* w_qkv, const float* b_qkv, float* ws, void* attn,
                        int B, int T_, int W, int H, int valid, float eps,
                        cudaStream_t stream) {
  using Cfg = CoreCfg<>;
  const size_t smem = CoreSmem<DH, Cfg>::bytes(T_);
  auto kernel = attn_core_kernel<T, DH, Cfg>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const CoreArgs<T> a{static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w_qkv), b_qkv, ws,
                      attn, nullptr, nullptr, B, H, T_, W, valid, eps};
  launch_attn_core<T, DH, Cfg>(a, CoreSwitches{0, 0, 0, 0, 1}, B * H, smem, stream);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_core_dh(const void* x, const float* gamma, const float* beta,
                           const void* w_qkv, const float* b_qkv, float* ws, void* attn,
                           int B, int T_, int W, int H, int valid, float eps,
                           cudaStream_t s) {
  switch (W / H) {
    case 16: return launch_core<T, 16>(x, gamma, beta, w_qkv, b_qkv, ws, attn, B, T_, W, H, valid, eps, s);
    case 32: return launch_core<T, 32>(x, gamma, beta, w_qkv, b_qkv, ws, attn, B, T_, W, H, valid, eps, s);
    case 64: return launch_core<T, 64>(x, gamma, beta, w_qkv, b_qkv, ws, attn, B, T_, W, H, valid, eps, s);
    case 128: return launch_core<T, 128>(x, gamma, beta, w_qkv, b_qkv, ws, attn, B, T_, W, H, valid, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch (i) of K2.  dtype: 0 float32, 1 bfloat16.  Head dim W / n_heads in
// {16, 32, 64, 128}; ws is an f32 workspace of B * n_heads * 3 * T * Dh.
extern "C" int tapclip_attn_block_core(const void* x, const void* gamma,
                                       const void* beta, const void* w_qkv,
                                       const void* b_qkv, void* ws, void* attn,
                                       int B, int T, int W, int n_heads, int valid,
                                       float eps, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bq = static_cast<const float*>(b_qkv);
  auto* w = static_cast<float*>(ws);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_core_dh<float>(x, g, bt, w_qkv, bq, w, attn, B, T, W, n_heads, valid, eps, s);
  if (dtype == 1)
    return launch_core_dh<__nv_bfloat16>(x, g, bt, w_qkv, bq, w, attn, B, T, W, n_heads, valid, eps, s);
  return cudaErrorInvalidValue;
}

// Launch (ii) of K2: out = a @ w + bias + res.  dtype: 0 float32, 1 bfloat16.
extern "C" int tapclip_gemm_bias_residual(const void* a, const void* w, const void* bias,
                                          const void* res, void* out, int M, int N, int K,
                                          int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* bs = static_cast<const float*>(bias);
  if (dtype == 0) {
    gemm_bias_residual_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), bs,
        static_cast<const float*>(res), static_cast<float*>(out), M, N, K);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    gemm_bias_residual_kernel<bf><<<grid, kThreads, 0, s>>>(
        static_cast<const bf*>(a), static_cast<const bf*>(w), bs,
        static_cast<const bf*>(res), static_cast<bf*>(out), M, N, K);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
