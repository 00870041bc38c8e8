// Backward of softmax attention for one (batch row, head), shared by B4 (the
// fused attention block's backward, attn_block_bwd.cu, step 3 of its chain)
// and B7 (the packed-QKV attention core's backward, mha_bwd.cu).
//
// One block of 8 warps per (batch row, head).  It holds the head's whole
// [T, T] probability tile in f32 in shared memory (31 KB at T = 88, 160 KB at
// T = 200) beside one [T, Dh] operand tile, and runs the TPU kernels'
// per-head chain
//   s = q k^T * scale log2 e (keys >= valid, and keys > query when causal:
//   -1e30), p = exp2(s - max) / sum,
//   [o = p v,]  dv = p^T g,  dp = g v^T,  ds = p (dp - sum(dp p)) scale,
//   dq = ds k,  dk = ds^T q,
// overwriting p with ds in place and restaging the operand tile for each
// phase.  q, k, v are read from the packed [B, T, 3W] rows at their head's
// column offset and g from [B, T, W]; o goes to [B, T, W] and dq, dk, dv to
// the packed [B, T, 3W] gradient, both in the compute dtype T.  The inputs
// are f32 (B4: the f32 products of its GEMMs) or T (B7: the saved qkv and the
// cotangent); bfloat16 rounds where the TPU kernels round (v and p for o, p
// and g for dv, the outputs), f32 elsewhere.  The products skip the entries
// whose probability is exactly 0 (keys >= valid, and above the diagonal when
// causal); adding them would change no bit.  A T whose tile does not fit in
// shared memory (bwd_core_max_seq) is refused here; the callers' wrappers
// then run the blockwise flash chain (flash_bwd.cu) instead.
#pragma once

#include "common.cuh"

// In an anonymous namespace at file scope, as every kernel of this package
// is: each including source gets its own copies, and nvcc's registration
// stubs cannot name a kernel in an anonymous namespace nested in a named one.
namespace {

using namespace tapclip;

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxKeyGroups = 8;  // keys per lane in the row phases: T <= 256
constexpr size_t kMaxSmem = 227 * 1024;

template <int DH>
size_t bwd_core_smem_bytes(int T) {
  return (static_cast<size_t>(T) * T + static_cast<size_t>(T) * (DH + 1)) * sizeof(float);
}

inline size_t bwd_core_smem_bytes_dh(int T, int Dh) {
  switch (Dh) {
    case 16: return bwd_core_smem_bytes<16>(T);
    case 32: return bwd_core_smem_bytes<32>(T);
    case 64: return bwd_core_smem_bytes<64>(T);
    case 128: return bwd_core_smem_bytes<128>(T);
    default: return 0;
  }
}

// Largest sequence length the core holds at head dim Dh, 0 for an
// unsupported head dim.
inline int bwd_core_max_seq(int Dh) {
  if (bwd_core_smem_bytes_dh(1, Dh) == 0) return 0;
  int t = 0;
  while (t < 32 * kMaxKeyGroups && bwd_core_smem_bytes_dh(t + 1, Dh) <= kMaxSmem) ++t;
  return t;
}

// X_s[t][d] (row stride DH + 1) = src[t * ld + d] for t < T, optionally
// rounded to the compute dtype.
template <typename T, typename In, int DH>
__device__ __forceinline__ void bwd_stage(float* X_s, const In* src, int ld, int T_, bool rnd) {
  for (int e = threadIdx.x; e < T_ * DH; e += kBwdThreads) {
    const int t = e / DH, d = e % DH;
    const float v = to_f(src[static_cast<size_t>(t) * ld + d]);
    X_s[t * (DH + 1) + d] = rnd ? round_to<T>(v) : v;
  }
}

// kCausal is a template parameter: B4's non-causal instance carries no causal
// test in its loops (a runtime flag cost it 2-4% in f32 on an H100).
template <typename T, typename In, int DH, bool kWithO, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_core_kernel(const In* __restrict__ qkv, const In* __restrict__ gh,
                     T* __restrict__ attn, T* __restrict__ dqkv, int H, int T_, int W,
                     int valid) {
  constexpr int kLd = DH + 1;
  constexpr int kDPer = (DH + 31) / 32;  // head columns per lane
  extern __shared__ __align__(16) float smem[];
  float* P_s = smem;                                // [T][T]: p, then ds
  float* X_s = P_s + static_cast<size_t>(T_) * T_;  // [T][DH + 1] operand tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int ld3 = 3 * W;
  const In* q = qkv + static_cast<size_t>(b) * T_ * ld3 + h * DH;
  const In* k = q + W;
  const In* v = q + 2 * W;
  const In* g = gh + static_cast<size_t>(b) * T_ * W + h * DH;
  T* dq = dqkv + static_cast<size_t>(b) * T_ * ld3 + h * DH;
  T* dk = dq + W;
  T* dv = dq + 2 * W;
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;
  // Row i has nonzero probabilities at keys [0, key_end(i)); key column j at
  // rows [row_begin(j), T) (none when j >= valid).
#define KEY_END(i) (kCausal ? min(valid, (i) + 1) : valid)
#define ROW_BEGIN(j) ((j) >= valid ? T_ : (kCausal ? (j) : 0))

  // a. p = softmax of the masked, log2-scaled scores, row by row.
  bwd_stage<T, In, DH>(X_s, k, ld3, T_, false);
  __syncthreads();
  for (int i = warp; i < T_; i += kBwdWarps) {
    float s[kMaxKeyGroups];
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) s[jt] = 0.f;
    const In* qi = q + static_cast<size_t>(i) * ld3;
    for (int d = 0; d < DH; ++d) {
      const float qd = to_f(qi[d]);
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
      s[jt] = j >= T_ ? -INFINITY
                      : ((j >= valid || (kCausal && j > i)) ? kNegBig : s[jt] * scale_log2);
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

  // b. o = p v, with p and v rounded to the compute dtype (B4 only).
  if constexpr (kWithO) {
    T* attn_b = attn + static_cast<size_t>(b) * T_ * W + h * DH;
    bwd_stage<T, In, DH>(X_s, v, ld3, T_, true);
    __syncthreads();
    for (int i = warp; i < T_; i += kBwdWarps) {
      float acc[kDPer];
#pragma unroll
      for (int u = 0; u < kDPer; ++u) acc[u] = 0.f;
      for (int j = 0; j < KEY_END(i); ++j) {
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
  }

  // c. dv = p^T g, with p and g rounded to the compute dtype.
  bwd_stage<T, In, DH>(X_s, g, W, T_, true);
  __syncthreads();
  for (int j = warp; j < T_; j += kBwdWarps) {
    float acc[kDPer];
#pragma unroll
    for (int u = 0; u < kDPer; ++u) acc[u] = 0.f;
    for (int i = ROW_BEGIN(j); i < T_; ++i) {
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

  // d. dp = g v^T (f32), ds = p (dp - sum(dp p)) scale, in place of p.
  bwd_stage<T, In, DH>(X_s, v, ld3, T_, false);
  __syncthreads();
  for (int i = warp; i < T_; i += kBwdWarps) {
    float dp[kMaxKeyGroups];
#pragma unroll
    for (int jt = 0; jt < kMaxKeyGroups; ++jt) dp[jt] = 0.f;
    const In* gi = g + static_cast<size_t>(i) * W;
    for (int d = 0; d < DH; ++d) {
      const float gd = to_f(gi[d]);
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
  bwd_stage<T, In, DH>(X_s, k, ld3, T_, false);
  __syncthreads();
  for (int i = warp; i < T_; i += kBwdWarps) {
    float acc[kDPer];
#pragma unroll
    for (int u = 0; u < kDPer; ++u) acc[u] = 0.f;
    for (int j = 0; j < KEY_END(i); ++j) {
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
  bwd_stage<T, In, DH>(X_s, q, ld3, T_, false);
  __syncthreads();
  for (int j = warp; j < T_; j += kBwdWarps) {
    float acc[kDPer];
#pragma unroll
    for (int u = 0; u < kDPer; ++u) acc[u] = 0.f;
    for (int i = ROW_BEGIN(j); i < T_; ++i) {
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
#undef KEY_END
#undef ROW_BEGIN
}

template <typename T, typename In, int DH, bool kWithO>
cudaError_t launch_bwd_core(const In* qkv, const In* gh, void* attn, void* dqkv, int B,
                            int T_, int W, int H, int valid, int causal, cudaStream_t s) {
  const size_t smem = bwd_core_smem_bytes<DH>(T_);
  auto kernel = causal ? attn_bwd_core_kernel<T, In, DH, kWithO, true>
                       : attn_bwd_core_kernel<T, In, DH, kWithO, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kBwdThreads, smem, s>>>(qkv, gh, static_cast<T*>(attn), static_cast<T*>(dqkv),
                                       H, T_, W, valid);
  return cudaGetLastError();
}

// Checks the shape and dispatches on the head dim W / H.
template <typename T, typename In, bool kWithO>
cudaError_t launch_bwd_core_dh(const In* qkv, const In* gh, void* attn, void* dqkv, int B,
                               int T_, int W, int H, int valid, int causal, cudaStream_t s) {
  if (B <= 0 || T_ <= 0 || H <= 0 || W % H || valid < 1 || valid > T_)
    return cudaErrorInvalidValue;
  if (T_ > bwd_core_max_seq(W / H)) return cudaErrorInvalidValue;
  switch (W / H) {
    case 16:
      return launch_bwd_core<T, In, 16, kWithO>(qkv, gh, attn, dqkv, B, T_, W, H, valid,
                                                causal, s);
    case 32:
      return launch_bwd_core<T, In, 32, kWithO>(qkv, gh, attn, dqkv, B, T_, W, H, valid,
                                                causal, s);
    case 64:
      return launch_bwd_core<T, In, 64, kWithO>(qkv, gh, attn, dqkv, B, T_, W, H, valid,
                                                causal, s);
    case 128:
      return launch_bwd_core<T, In, 128, kWithO>(qkv, gh, attn, dqkv, B, T_, W, H, valid,
                                                 causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
