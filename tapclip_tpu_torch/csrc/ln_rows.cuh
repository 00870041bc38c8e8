// LayerNorm rows of K1 (fused_mlp.cu), K2 (attn_block.cu), B4
// (attn_block_bwd.cu), B5 (mlp_bwd.cu), S1 (fused_layer.cu) and S2
// (fused_mlp_variants.cu), one warp a row, with the statistics of the JAX
// kernels: two passes in f32 (mean, then the mean square of x - mean),
// rstd = rsqrt(var + eps); S2's ln1pass takes one (var = E[x^2] - mean^2).
#pragma once

#include "common.cuh"

namespace tapclip {

constexpr int kLnThreads = 256;
constexpr int kLnWarps = kLnThreads / 32;
constexpr int kLnBwdRows = 16;                 // rows of a block of ln_bwd_rows_kernel, one a warp
constexpr int kLnBwdThreads = 32 * kLnBwdRows;
constexpr int kLnMaxSplits = 4;                // partials of dy ln_bwd_rows_kernel sums

// Row r of y = LN(x) rounded to TO, by one warp (x of TI: S1's LN2 reads its
// f32 mid); mean and rstd (f32) too where mean_out is not null.
template <typename TI, typename TO, bool ONE_PASS = false>
__device__ __forceinline__ void ln_row(const TI* __restrict__ x, const float* __restrict__ gamma,
                                       const float* __restrict__ beta, TO* __restrict__ y,
                                       float* __restrict__ mean_out, float* __restrict__ rstd_out, int r, int W,
                                       float eps, int lane) {
  const TI* xr = x + static_cast<size_t>(r) * W;
  float mean, rstd;
  if constexpr (ONE_PASS) {
    float s = 0.f, q = 0.f;
    for (int c = lane; c < W; c += 32) {
      const float v = to_f(xr[c]);
      s += v;
      q += v * v;
    }
    mean = warp_sum(s) / W;
    rstd = rsqrtf(warp_sum(q) / W - mean * mean + eps);
  } else {
    float s = 0.f;
    for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
    mean = warp_sum(s) / W;
    float v = 0.f;
    for (int c = lane; c < W; c += 32) {
      const float d = to_f(xr[c]) - mean;
      v += d * d;
    }
    rstd = rsqrtf(warp_sum(v) / W + eps);
  }
  TO* yr = y + static_cast<size_t>(r) * W;
  for (int c = lane; c < W; c += 32) yr[c] = from_f<TO>((to_f(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
  if (lane == 0 && mean_out != nullptr) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// y = LN(x) rounded to T; mean and rstd (f32, per row) too where not null.
// Launch: ceil(R / kLnWarps) blocks of kLnThreads.
template <typename T, bool ONE_PASS = false>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
               T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rstd_out, int R, int W,
               float eps) {
  const int r = blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  ln_row<T, T, ONE_PASS>(x, gamma, beta, y, mean_out, rstd_out, r, W, eps, threadIdx.x & 31);
}

// dx = g + LN backward of dy, one warp a row, where dy is the sum, in order,
// of `splits` (1 to kLnMaxSplits) f32 partials [R, W] split_stride elements
// apart (one for B4, a split of the product's depth for B5).  A block owns
// kLnBwdRows rows and, with want_w, writes its partial column sums of dy * n
// and dy to part[block, 2W].  The column loops are unrolled so that a warp
// keeps several rows' worth of loads in flight (at the text shape, 704 rows,
// the kernel is a latency chain of one warp a row).  Launch:
// ceil(R / kLnBwdRows) blocks of kLnBwdThreads.
template <typename T>
__global__ void __launch_bounds__(kLnBwdThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ dy, int splits,
                   size_t split_stride, const float* __restrict__ gamma, const float* __restrict__ mean,
                   const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ part, int R, int W,
                   int want_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kLnBwdRows;
  auto dy_at = [&](size_t off) {
    float d = dy[off];
#pragma unroll
    for (int s = 1; s < kLnMaxSplits; ++s)
      if (s < splits) d += dy[s * split_stride + off];
    return d;
  };
  const int row = row0 + warp;
  if (row < R) {
    const T* xr = x + static_cast<size_t>(row) * W;
    const size_t r_off = static_cast<size_t>(row) * W;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int c = lane; c < W; c += 32) {
      const float n = (to_f(xr[c]) - mu) * rs;
      const float dn = dy_at(r_off + c) * gamma[c];
      s1 += dn;
      s2 += dn * n;
    }
    s1 = warp_sum(s1) / W;
    s2 = warp_sum(s2) / W;
#pragma unroll 4
    for (int c = lane; c < W; c += 32) {
      const size_t off = r_off + c;
      const float n = (to_f(xr[c]) - mu) * rs;
      const float dn = dy_at(off) * gamma[c];
      dx[off] = from_f<T>(to_f(g[off]) + rs * (dn - s1 - n * s2));
    }
  }
  if (!want_w) return;
  float* pb = part + static_cast<size_t>(blockIdx.x) * 2 * W;
  for (int c = threadIdx.x; c < W; c += kLnBwdThreads) {
    float pg = 0.f, pbeta = 0.f;
    for (int r = row0; r < min(R, row0 + kLnBwdRows); ++r) {
      const size_t off = static_cast<size_t>(r) * W + c;
      const float n = (to_f(x[off]) - mean[r]) * rstd[r];
      const float d = dy_at(off);
      pg += d * n;
      pbeta += d;
    }
    pb[c] = pg;
    pb[W + c] = pbeta;
  }
}

}  // namespace tapclip
