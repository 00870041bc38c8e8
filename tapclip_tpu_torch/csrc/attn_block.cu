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
#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kThreads = 256;
constexpr int kRowTile = 64;  // token rows per projection tile
constexpr int kKTile = 32;    // reduction depth per staged tile

template <int DH>
struct CoreSmem {
  static constexpr int kCols = 3 * DH;  // q, k, v columns of one head
  static constexpr int kProj = kRowTile * (kKTile + 1) + kKTile * kCols;
  static constexpr int kAttn = AttnTile<float, DH>::kSmemFloats;
  static constexpr int kUnion = kProj > kAttn ? kProj : kAttn;
  static size_t bytes(int T) { return (kUnion + 2 * T) * sizeof(float); }
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_block_core_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const T* __restrict__ w_qkv,
                       const float* __restrict__ b_qkv,
                       float* ws,  // written, then read back by this block: no __restrict__
                       T* __restrict__ attn, int H, int T_, int W, int valid,
                       float eps) {
  using Tile = AttnTile<T, DH>;
  constexpr int kCols = CoreSmem<DH>::kCols;
  constexpr int kNj = kCols / 16;
  extern __shared__ __align__(16) float smem[];
  float* mean_s = smem + CoreSmem<DH>::kUnion;  // [T]
  float* rstd_s = mean_s + T_;                  // [T]
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const T* xb = x + static_cast<size_t>(b) * T_ * W;
  float* ws_q = ws + static_cast<size_t>(blockIdx.x) * 3 * T_ * DH;
  float* ws_k = ws_q + static_cast<size_t>(T_) * DH;
  float* ws_v = ws_k + static_cast<size_t>(T_) * DH;

  // LayerNorm statistics, one warp per token.
  for (int t = warp; t < T_; t += kThreads / 32) {
    const T* xr = xb + static_cast<size_t>(t) * W;
    float s = 0.f;
    for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
    const float mean = warp_sum(s) / W;
    float v = 0.f;
    for (int c = lane; c < W; c += 32) {
      const float d = to_f(xr[c]) - mean;
      v += d * d;
    }
    const float var = warp_sum(v) / W;
    if (lane == 0) {
      mean_s[t] = mean;
      rstd_s[t] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  // q, k, v of head h for all tokens: [T, 3 DH] = LN(x) @ w_qkv[:, head cols].
  float* y_s = smem;                                // [kRowTile][kKTile + 1]
  float* w_s = smem + kRowTile * (kKTile + 1);      // [kKTile][kCols]
  for (int t0 = 0; t0 < T_; t0 += kRowTile) {
    float acc[4][kNj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNj; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < W; k0 += kKTile) {
      for (int e = tid; e < kRowTile * kKTile; e += kThreads) {
        const int r = e / kKTile, kk = e % kKTile;
        const int t = t0 + r, k = k0 + kk;
        float val = 0.f;
        if (t < T_ && k < W)
          val = round_to<T>((to_f(xb[static_cast<size_t>(t) * W + k]) - mean_s[t]) *
                                rstd_s[t] * gamma[k] + beta[k]);
        y_s[r * (kKTile + 1) + kk] = val;
      }
      for (int e = tid; e < kKTile * kCols; e += kThreads) {
        const int kk = e / kCols, c = e % kCols;
        const int k = k0 + kk;
        const int col = (c / DH) * W + h * DH + (c % DH);
        w_s[kk * kCols + c] = k < W ? to_f(w_qkv[static_cast<size_t>(k) * 3 * W + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKTile; ++kk) {
        float a[4], bv[kNj];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = y_s[(rg + 16 * i) * (kKTile + 1) + kk];
#pragma unroll
        for (int j = 0; j < kNj; ++j) bv[j] = w_s[kk * kCols + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kNj; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + rg + 16 * i;
      if (t >= T_) continue;
#pragma unroll
      for (int j = 0; j < kNj; ++j) {
        const int c = cg + 16 * j;
        const int part = c / DH, d = c % DH;
        float val = acc[i][j] + b_qkv[part * W + h * DH + d];
        if (part == 2) val = round_to<T>(val);  // v in the compute dtype
        ws_q[static_cast<size_t>(part) * T_ * DH + static_cast<size_t>(t) * DH + d] = val;
      }
    }
  }
  __syncthreads();  // makes the workspace writes visible to the whole block

  // Attention over 64-row query tiles.
  float* Q_s = smem;
  float* K_s = Q_s + Tile::kRows * Tile::kLd;
  float* V_s = K_s + Tile::kKeys * Tile::kLd;
  float* P_s = V_s + Tile::kKeys * Tile::kLd;
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;
  for (int q0 = 0; q0 < T_; q0 += Tile::kRows) {
    for (int e = tid; e < Tile::kRows * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      Q_s[r * Tile::kLd + d] = q0 + r < T_ ? ws_q[static_cast<size_t>(q0 + r) * DH + d] : 0.f;
    }
    Tile tile;
    tile.init();
    for (int kt0 = 0; kt0 < T_; kt0 += Tile::kKeys) {
      for (int e = tid; e < Tile::kKeys * DH; e += kThreads) {
        const int r = e / DH, d = e % DH;
        const bool in = kt0 + r < T_;
        const size_t off = static_cast<size_t>(kt0 + r) * DH + d;
        K_s[r * Tile::kLd + d] = in ? ws_k[off] : 0.f;
        V_s[r * Tile::kLd + d] = in ? ws_v[off] : 0.f;
      }
      __syncthreads();
      tile.step(Q_s, K_s, V_s, P_s, kt0, T_, valid, scale_log2, rg, cg);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + rg + 16 * i;
      if (t >= T_) continue;
      const float inv_l = 1.f / tile.l[i];
#pragma unroll
      for (int j = 0; j < Tile::kDj; ++j) {
        const int d = cg + 16 * j;
        attn[(static_cast<size_t>(b) * T_ + t) * W + h * DH + d] = from_f<T>(tile.o[i][j] * inv_l);
      }
    }
  }
}

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
  const size_t smem = CoreSmem<DH>::bytes(T_);
  auto kernel = attn_block_core_kernel<T, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w_qkv), b_qkv, ws,
      static_cast<T*>(attn), H, T_, W, valid, eps);
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
