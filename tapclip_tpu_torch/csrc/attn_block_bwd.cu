// B4: backward of the fused attention half-block K2,
//   out = x + out_proj(softmax_masked(q k^T / sqrt(Dh)) v),  q, k, v = qkv_proj(LN(x)).
//
// Replaces tapclip_tpu/ops/fused_mha.py::_attn_block_bwd_kernel (the
// pallas_call in _attn_block_bwd_impl), its serial per-head schedule.  Like
// the TPU kernel it recomputes LN, the QKV projection and the probabilities
// from x; it never receives the forward's attention map.
//
// The TPU kernel holds a batch block's [T, 3W] tensors in VMEM and carries
// the f32 weight-gradient sums across its sequential grid.  On the card the
// wrapper (tapclip_tpu_torch/ops/fused_mha.py::_attn_block_bwd_cuda) runs
// the same math as a chain of launches, the products by gemm.cu:
//
//   1. ln_rows (here): LayerNorm statistics per row in f32 and
//      y = LN(x) rounded to the compute dtype.
//   2. gemm: qkv = y . w_qkv + b_qkv (f32), and the cotangent of the
//      attention output gh = g . w_out^T (f32).
//   3. attn_bwd_core (here): one block per (batch row, head).  It holds the
//      head's whole [T, T] probability tile in f32 in shared memory (31 KB
//      at T = 88, 160 KB at T = 200) beside one [T, Dh] operand tile, and
//      runs the TPU kernel's per-head chain
//        s = q k^T * scale log2 e (keys >= valid: -1e30), p = exp2(s - max) / sum,
//        o = p v,  dv = p^T gh,  dp = gh v^T,  ds = p (dp - sum(dp p)) scale,
//        dq = ds k,  dk = ds^T q,
//      overwriting p with ds in place.  It writes o into attn [B, T, W] and
//      dq, dk, dv into dqkv [B, T, 3W], both in the compute dtype.  A T whose
//      tile does not fit is refused by the wrapper, never run another way.
//   4. gemm: dy = dqkv . w_qkv^T (f32).
//   5. ln_bwd_rows (here): dx = g + LN backward of dy; with weight gradients
//      wanted, per-block partial column sums of dy * n and dy.
//   6. with weight gradients wanted (not on the prompt-tuning path, where
//      the CLIP weights are frozen): dW_qkv = y^T . dqkv, dW_out = o^T . g,
//      and the column sums for db_qkv, db_out, dgamma, dbeta (gemm.cu).
//
// bfloat16 rounds where the TPU kernel rounds: y, the cotangent g, v and p
// for o, p and gh for dv, and o and dqkv on their way out; q, k, gh for dp,
// dp and ds stay f32, and LN statistics are f32 everywhere.
//
// What bounds it on the card: inferred, not measured (no profile yet).  The
// core (step 3) is the serial part: per (batch row, head) it does
// 6 x T^2 x Dh FMAs on the FMA units with one block of 8 warps; the grid is B x H blocks (64 at the text shape, 96 at
// the image shape), under one per SM, the pattern a block-count probe found
// holding K2's core back.  At T = 200 the [T, T] tile leaves room for one
// operand tile only, so q and gh rows are read from L1/L2 in the s and dp
// phases.  Splitting over query tiles and tensor-core MMA are later work.
#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKeyGroups = 8;  // keys per lane in the row phases: T <= 256

template <int DH>
size_t core_smem_bytes(int T) {
  return (static_cast<size_t>(T) * T + static_cast<size_t>(T) * (DH + 1)) * sizeof(float);
}

// LayerNorm statistics and y = LN(x) rounded to T, one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ y,
               float* __restrict__ mean_out, float* __restrict__ rstd_out, int R,
               int W, float eps) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const T* xr = x + static_cast<size_t>(r) * W;
  float s = 0.f;
  for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / W;
  float v = 0.f;
  for (int c = lane; c < W; c += 32) {
    const float d = to_f(xr[c]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / W + eps);
  for (int c = lane; c < W; c += 32)
    y[static_cast<size_t>(r) * W + c] = from_f<T>((to_f(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
  if (lane == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// X_s[t][d] (row stride DH + 1) = src[t * ld + d] for t < T, optionally
// rounded to the compute dtype.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* X_s, const float* src, int ld, int T_, bool rnd) {
  for (int e = threadIdx.x; e < T_ * DH; e += kThreads) {
    const int t = e / DH, d = e % DH;
    const float v = src[static_cast<size_t>(t) * ld + d];
    X_s[t * (DH + 1) + d] = rnd ? round_to<T>(v) : v;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_core_kernel(const float* __restrict__ qkv, const float* __restrict__ gh,
                     T* __restrict__ attn, T* __restrict__ dqkv, int H, int T_,
                     int W, int valid) {
  constexpr int kLd = DH + 1;
  constexpr int kDPer = (DH + 31) / 32;  // head columns per lane
  extern __shared__ __align__(16) float smem[];
  float* P_s = smem;                             // [T][T]: p, then ds
  float* X_s = P_s + static_cast<size_t>(T_) * T_;  // [T][DH + 1] operand tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int ld3 = 3 * W;
  const float* q = qkv + static_cast<size_t>(b) * T_ * ld3 + h * DH;
  const float* k = q + W;
  const float* v = q + 2 * W;
  const float* g = gh + static_cast<size_t>(b) * T_ * W + h * DH;
  T* attn_b = attn + static_cast<size_t>(b) * T_ * W + h * DH;
  T* dq = dqkv + static_cast<size_t>(b) * T_ * ld3 + h * DH;
  T* dk = dq + W;
  T* dv = dq + 2 * W;
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;

  // a. p = softmax of the masked, log2-scaled scores, row by row.
  stage<T, DH>(X_s, k, ld3, T_, false);
  __syncthreads();
  for (int i = warp; i < T_; i += kWarps) {
    float s[kMaxKeyGroups];
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) s[jt] = 0.f;
    const float* qi = q + static_cast<size_t>(i) * ld3;
    for (int d = 0; d < DH; ++d) {
      const float qd = qi[d];
#pragma unroll
      for (int jt = 0; jt < kMaxKeyGroups; ++jt) {
        const int j = lane + 32 * jt;
        if (j < T_) s[jt] = fmaf(qd, X_s[j * kLd + d], s[jt]);
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) {
      const int j = lane + 32 * jt;
      s[jt] = j >= T_ ? -INFINITY : (j >= valid ? kNegBig : s[jt] * scale_log2);
      m = fmaxf(m, s[jt]);
    }
    m = warp_max(m);
    float l = 0.f;
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) {
      s[jt] = exp2f(s[jt] - m);  // 0 for keys past T
      l += s[jt];
    }
    l = warp_sum(l);
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) {
      const int j = lane + 32 * jt;
      if (j < T_) P_s[i * T_ + j] = s[jt] / l;
    }
  }
  __syncthreads();

  // b. o = p v, with p and v rounded to the compute dtype.
  stage<T, DH>(X_s, v, ld3, T_, true);
  __syncthreads();
  for (int i = warp; i < T_; i += kWarps) {
    float acc[kDPer];
#pragma unroll
    for (int u = 0; u < kDPer; ++u) acc[u] = 0.f;
    for (int j = 0; j < T_; ++j) {
      const float p = round_to<T>(P_s[i * T_ + j]);
#pragma unroll
      for (int u = 0; u < kDPer; ++u) {
        const int d = lane + 32 * u;
        if (d < DH) acc[u] = fmaf(p, X_s[j * kLd + d], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDPer; ++u) {
      const int d = lane + 32 * u;
      if (d < DH) attn_b[static_cast<size_t>(i) * W + d] = from_f<T>(acc[u]);
    }
  }
  __syncthreads();

  // c. dv = p^T gh, with p and gh rounded to the compute dtype.
  stage<T, DH>(X_s, g, W, T_, true);
  __syncthreads();
  for (int j = warp; j < T_; j += kWarps) {
    float acc[kDPer];
#pragma unroll
    for (int u = 0; u < kDPer; ++u) acc[u] = 0.f;
    for (int i = 0; i < T_; ++i) {
      const float p = round_to<T>(P_s[i * T_ + j]);
#pragma unroll
      for (int u = 0; u < kDPer; ++u) {
        const int d = lane + 32 * u;
        if (d < DH) acc[u] = fmaf(p, X_s[i * kLd + d], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDPer; ++u) {
      const int d = lane + 32 * u;
      if (d < DH) dv[static_cast<size_t>(j) * ld3 + d] = from_f<T>(acc[u]);
    }
  }
  __syncthreads();

  // d. dp = gh v^T (f32), ds = p (dp - sum(dp p)) scale, in place of p.
  stage<T, DH>(X_s, v, ld3, T_, false);
  __syncthreads();
  for (int i = warp; i < T_; i += kWarps) {
    float dp[kMaxKeyGroups];
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) dp[jt] = 0.f;
    const float* gi = g + static_cast<size_t>(i) * W;
    for (int d = 0; d < DH; ++d) {
      const float gd = gi[d];
#pragma unroll
      for (int jt = 0; jt < kMaxKeyGroups; ++jt) {
        const int j = lane + 32 * jt;
        if (j < T_) dp[jt] = fmaf(gd, X_s[j * kLd + d], dp[jt]);
      }
    }
    float p[kMaxKeyGroups];
    float r = 0.f;
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) {
      const int j = lane + 32 * jt;
      p[jt] = j < T_ ? P_s[i * T_ + j] : 0.f;
      r += dp[jt] * p[jt];
    }
    r = warp_sum(r);
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) {
      const int j = lane + 32 * jt;
      if (j < T_) P_s[i * T_ + j] = p[jt] * (dp[jt] - r) * scale;
    }
  }
  __syncthreads();

  // e. dq = ds k.
  stage<T, DH>(X_s, k, ld3, T_, false);
  __syncthreads();
  for (int i = warp; i < T_; i += kWarps) {
    float acc[kDPer];
#pragma unroll
    for (int u = 0; u < kDPer; ++u) acc[u] = 0.f;
    for (int j = 0; j < T_; ++j) {
      const float ds = P_s[i * T_ + j];
#pragma unroll
      for (int u = 0; u < kDPer; ++u) {
        const int d = lane + 32 * u;
        if (d < DH) acc[u] = fmaf(ds, X_s[j * kLd + d], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDPer; ++u) {
      const int d = lane + 32 * u;
      if (d < DH) dq[static_cast<size_t>(i) * ld3 + d] = from_f<T>(acc[u]);
    }
  }
  __syncthreads();

  // f. dk = ds^T q.
  stage<T, DH>(X_s, q, ld3, T_, false);
  __syncthreads();
  for (int j = warp; j < T_; j += kWarps) {
    float acc[kDPer];
#pragma unroll
    for (int u = 0; u < kDPer; ++u) acc[u] = 0.f;
    for (int i = 0; i < T_; ++i) {
      const float ds = P_s[i * T_ + j];
#pragma unroll
      for (int u = 0; u < kDPer; ++u) {
        const int d = lane + 32 * u;
        if (d < DH) acc[u] = fmaf(ds, X_s[i * kLd + d], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kDPer; ++u) {
      const int d = lane + 32 * u;
      if (d < DH) dk[static_cast<size_t>(j) * ld3 + d] = from_f<T>(acc[u]);
    }
  }
}

// dx = g + LN backward of dy, one warp per row; a block owns kLnRows rows and,
// with want_w, writes its partial column sums of dy * n and dy to
// part[block, 2W].
constexpr int kLnRows = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ dy, const float* __restrict__ gamma,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   T* __restrict__ dx, float* __restrict__ part, int R, int W,
                   int want_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kLnRows;
  for (int r = row0 + warp; r < min(R, row0 + kLnRows); r += kWarps) {
    const T* xr = x + static_cast<size_t>(r) * W;
    const float* dr = dy + static_cast<size_t>(r) * W;
    const float mu = mean[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < W; c += 32) {
      const float n = (to_f(xr[c]) - mu) * rs;
      const float dn = dr[c] * gamma[c];
      s1 += dn;
      s2 += dn * n;
    }
    s1 = warp_sum(s1) / W;
    s2 = warp_sum(s2) / W;
    for (int c = lane; c < W; c += 32) {
      const size_t off = static_cast<size_t>(r) * W + c;
      const float n = (to_f(xr[c]) - mu) * rs;
      const float dn = dr[c] * gamma[c];
      dx[off] = from_f<T>(to_f(g[off]) + rs * (dn - s1 - n * s2));
    }
  }
  if (!want_w) return;
  float* pb = part + static_cast<size_t>(blockIdx.x) * 2 * W;
  for (int c = threadIdx.x; c < W; c += kThreads) {
    float pg = 0.f, pbeta = 0.f;
    for (int r = row0; r < min(R, row0 + kLnRows); ++r) {
      const size_t off = static_cast<size_t>(r) * W + c;
      const float n = (to_f(x[off]) - mean[r]) * rstd[r];
      pg += dy[off] * n;
      pbeta += dy[off];
    }
    pb[c] = pg;
    pb[W + c] = pbeta;
  }
}

template <typename T, int DH>
cudaError_t launch_core(const float* qkv, const float* gh, void* attn, void* dqkv,
                        int B, int T_, int W, int H, int valid, cudaStream_t s) {
  const size_t smem = core_smem_bytes<DH>(T_);
  auto kernel = attn_bwd_core_kernel<T, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, s>>>(qkv, gh, static_cast<T*>(attn),
                                       static_cast<T*>(dqkv), H, T_, W, valid);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_core_dh(const float* qkv, const float* gh, void* attn, void* dqkv,
                           int B, int T_, int W, int H, int valid, cudaStream_t s) {
  switch (W / H) {
    case 16: return launch_core<T, 16>(qkv, gh, attn, dqkv, B, T_, W, H, valid, s);
    case 32: return launch_core<T, 32>(qkv, gh, attn, dqkv, B, T_, W, H, valid, s);
    case 64: return launch_core<T, 64>(qkv, gh, attn, dqkv, B, T_, W, H, valid, s);
    case 128: return launch_core<T, 128>(qkv, gh, attn, dqkv, B, T_, W, H, valid, s);
    default: return cudaErrorInvalidValue;
  }
}

constexpr size_t kMaxSmem = 227 * 1024;

size_t core_smem_dh(int T, int Dh) {
  switch (Dh) {
    case 16: return core_smem_bytes<16>(T);
    case 32: return core_smem_bytes<32>(T);
    case 64: return core_smem_bytes<64>(T);
    case 128: return core_smem_bytes<128>(T);
    default: return 0;
  }
}

}  // namespace

// Largest sequence length the core holds at head dim Dh (its [T, T] f32 tile
// and one [T, Dh] operand tile in shared memory, at most 32 x 8 keys per
// row), 0 for an unsupported head dim.
extern "C" int tapclip_attn_bwd_max_seq(int Dh) {
  if (core_smem_dh(1, Dh) == 0) return 0;
  int t = 0;
  while (t < 32 * kMaxKeyGroups && core_smem_dh(t + 1, Dh) <= kMaxSmem) ++t;
  return t;
}

// Step 1 of B4: y = LN(x) (dtype of x) and f32 mean / rstd per row.
extern "C" int tapclip_ln_rows(const void* x, const void* gamma, const void* beta,
                               void* y, void* mean, void* rstd, int R, int W,
                               float eps, int dtype, void* stream) {
  if (R <= 0 || W <= 0) return cudaErrorInvalidValue;
  const int blocks = (R + kWarps - 1) / kWarps;
  const auto* gm = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  auto* mu = static_cast<float*>(mean);
  auto* rs = static_cast<float*>(rstd);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ln_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), gm, bt, static_cast<float*>(y), mu, rs, R, W, eps);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    ln_rows_kernel<bf><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(x), gm, bt, static_cast<bf*>(y), mu, rs, R, W, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Step 3 of B4: qkv [B, T, 3W] f32 and gh [B, T, W] f32 in; attn [B, T, W] and
// dqkv [B, T, 3W] (compute dtype) out.  Head dim W / n_heads in {16, 32, 64,
// 128}; T at most tapclip_attn_bwd_max_seq(Dh).
extern "C" int tapclip_attn_bwd_core(const void* qkv, const void* gh, void* attn,
                                     void* dqkv, int B, int T, int W, int n_heads,
                                     int valid, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  if (T > tapclip_attn_bwd_max_seq(W / n_heads)) return cudaErrorInvalidValue;
  const auto* q = static_cast<const float*>(qkv);
  const auto* g = static_cast<const float*>(gh);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_core_dh<float>(q, g, attn, dqkv, B, T, W, n_heads, valid, s);
  if (dtype == 1) return launch_core_dh<__nv_bfloat16>(q, g, attn, dqkv, B, T, W, n_heads, valid, s);
  return cudaErrorInvalidValue;
}

// Step 5 of B4: dx = g + LN backward of dy (f32); with want_w, part
// [ceil(R / 16), 2W] f32 gets the partial sums of dy * n and dy.
extern "C" int tapclip_ln_bwd_rows(const void* x, const void* g, const void* dy,
                                   const void* gamma, const void* mean,
                                   const void* rstd, void* dx, void* part, int R,
                                   int W, int want_w, int dtype, void* stream) {
  if (R <= 0 || W <= 0) return cudaErrorInvalidValue;
  const int blocks = (R + kLnRows - 1) / kLnRows;
  const auto* d = static_cast<const float*>(dy);
  const auto* gm = static_cast<const float*>(gamma);
  const auto* mu = static_cast<const float*>(mean);
  const auto* rs = static_cast<const float*>(rstd);
  auto* pt = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ln_bwd_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), d, gm, mu, rs,
        static_cast<float*>(dx), pt, R, W, want_w);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    ln_bwd_rows_kernel<bf><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(g), d, gm, mu, rs,
        static_cast<bf*>(dx), pt, R, W, want_w);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
