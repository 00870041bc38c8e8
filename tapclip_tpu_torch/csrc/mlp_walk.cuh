// The FMA walk of the fused MLP half-block: the device code of its A/B
// variants S2 (fused_mlp_variants.cu) and of the one-launch fused layer S1
// (fused_layer.cu).  K1 (fused_mlp.cu) ran on it before it moved to the
// tensor cores.
//
// A block owns ROWS rows.  ln_row() normalises one row in f32 into y_s
// (rounded to the compute dtype) and starts its accumulator at x + b_proj;
// walk() then runs the hidden dimension in chunks of 256 columns: each thread
// owns one hidden column, computes fc + bias + exact GELU for the ROWS rows
// into the chunk h_s [ROWS, 256] (rounded), and the threads add the chunk's
// partial projection into the f32 accumulator acc_s [ROWS, W].
//
// S2's flags-off configuration is MlpWalk<T, 16, false, false>.  The switches of
// scripts/mlp_kernel_ab.py, each as its nearest counterpart here:
//   ROWS 8   row_tile (rt512): fewer rows a block, so more blocks per SM
//            (64 KB of shared memory a block at W 768 instead of 112 KB);
//            32 rows do not fit (2 x 32 x 768 x 4 + 32 x 256 x 4 = 229 KB);
//   ERF3     the A&S 3-term erf (common.cuh) in place of erff;
//   ILV      ilv_chunks: the next chunk's fc (its w_fc loads) is issued
//            before this chunk's projection, into a second h_s buffer, one
//            barrier a chunk instead of two (a software pipeline over the
//            hidden chunks; ilv2 and ilv4 are the same schedule here);
//   ln_row's one_pass: ln1pass, var = E[x^2] - mean^2.
// ROWS and ILV change only the schedule: every row's arithmetic is the
// flags-off configuration's.
#pragma once

#include "common.cuh"

namespace tapclip {

template <typename T, int ROWS, bool ERF3, bool ILV>
struct MlpWalk {
  static constexpr int kThreads = 256;
  static constexpr int kChunk = 256;  // hidden columns per chunk: one per thread
  static constexpr int kHBufs = ILV ? 2 : 1;

  // Floats of shared memory: y_s [ROWS, W], acc_s [ROWS, W], h_s [kHBufs][ROWS, kChunk].
  __host__ __device__ static size_t floats(int W) {
    return 2 * static_cast<size_t>(ROWS) * W + kHBufs * ROWS * kChunk;
  }

  __device__ __forceinline__ static float gelu(float z) {
    return 0.5f * z * (1.f + (ERF3 ? erf3(z * 0.70710678118654752f) : erff(z * 0.70710678118654752f)));
  }

  // LayerNorm of one row xr (by one warp): yr = LN(x) rounded to T, ar = x + b_proj.
  // xr and ar may be the same row of shared memory.
  template <typename Src>
  __device__ __forceinline__ static void ln_row(const Src* xr, float* yr, float* ar,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta,
                                                const float* __restrict__ b_proj, int W, float eps,
                                                bool one_pass, int lane) {
    float mean, var;
    if (one_pass) {
      float s = 0.f, q = 0.f;
      for (int c = lane; c < W; c += 32) {
        const float v = to_f(xr[c]);
        s += v;
        q += v * v;
      }
      mean = warp_sum(s) / W;
      var = warp_sum(q) / W - mean * mean;
    } else {
      float s = 0.f;
      for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
      mean = warp_sum(s) / W;
      float v = 0.f;
      for (int c = lane; c < W; c += 32) {
        const float d = to_f(xr[c]) - mean;
        v += d * d;
      }
      var = warp_sum(v) / W;
    }
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < W; c += 32) {
      const float xv = to_f(xr[c]);
      yr[c] = round_to<T>((xv - mean) * rstd * gamma[c] + beta[c]);
      ar[c] = xv + b_proj[c];
    }
  }

  // fc + bias + GELU of hidden column j0 + tid for the ROWS rows, rounded, into h.
  __device__ __forceinline__ static void fc(const float* y_s, float* h, const T* __restrict__ w_fc,
                                            const float* __restrict__ b_fc, int j0, int W, int H) {
    const int tid = threadIdx.x;
    const int hcol = j0 + tid;
    float a[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) a[r] = 0.f;
    if (hcol < H) {
      const T* wc = w_fc + hcol;
#pragma unroll 2
      for (int k = 0; k < W; k += 4) {
        const float w0 = to_f(wc[static_cast<size_t>(k) * H]);
        const float w1 = to_f(wc[static_cast<size_t>(k + 1) * H]);
        const float w2 = to_f(wc[static_cast<size_t>(k + 2) * H]);
        const float w3 = to_f(wc[static_cast<size_t>(k + 3) * H]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 yv = *reinterpret_cast<const float4*>(y_s + r * W + k);
          a[r] = fmaf(yv.x, w0, a[r]);
          a[r] = fmaf(yv.y, w1, a[r]);
          a[r] = fmaf(yv.z, w2, a[r]);
          a[r] = fmaf(yv.w, w3, a[r]);
        }
      }
      const float bias = b_fc[hcol];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) h[r * kChunk + tid] = round_to<T>(gelu(a[r] + bias));
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) h[r * kChunk + tid] = 0.f;
    }
  }

  // acc_s += h . w_proj[j0 : j0 + 256, :] (the chunk's partial projection).
  __device__ __forceinline__ static void proj(const float* h, float* acc_s, const T* __restrict__ w_proj,
                                              int j0, int W, int H) {
    const int kmax = min(kChunk, H - j0);
    for (int c = threadIdx.x; c < W; c += kThreads) {
      float p[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) p[r] = 0.f;
      const T* wc = w_proj + static_cast<size_t>(j0) * W + c;
#pragma unroll 2
      for (int k = 0; k < kmax; k += 4) {
        const float w0 = to_f(wc[static_cast<size_t>(k) * W]);
        const float w1 = to_f(wc[static_cast<size_t>(k + 1) * W]);
        const float w2 = to_f(wc[static_cast<size_t>(k + 2) * W]);
        const float w3 = to_f(wc[static_cast<size_t>(k + 3) * W]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(h + r * kChunk + k);
          p[r] = fmaf(hv.x, w0, p[r]);
          p[r] = fmaf(hv.y, w1, p[r]);
          p[r] = fmaf(hv.z, w2, p[r]);
          p[r] = fmaf(hv.w, w3, p[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc_s[r * W + c] += p[r];
    }
  }

  // The walk over the hidden dimension; y_s and acc_s ready, visible to all.
  __device__ __forceinline__ static void walk(const float* y_s, float* acc_s, float* h_s,
                                              const T* __restrict__ w_fc, const float* __restrict__ b_fc,
                                              const T* __restrict__ w_proj, int W, int H) {
    if (!ILV) {
      for (int j0 = 0; j0 < H; j0 += kChunk) {
        fc(y_s, h_s, w_fc, b_fc, j0, W, H);
        __syncthreads();
        proj(h_s, acc_s, w_proj, j0, W, H);
        __syncthreads();
      }
      return;
    }
    fc(y_s, h_s, w_fc, b_fc, 0, W, H);
    __syncthreads();
    int cur = 0;
    for (int j0 = 0; j0 < H; j0 += kChunk) {
      // h_s[1 - cur] was last read by the projection before the barrier above.
      if (j0 + kChunk < H) fc(y_s, h_s + (1 - cur) * ROWS * kChunk, w_fc, b_fc, j0 + kChunk, W, H);
      proj(h_s + cur * ROWS * kChunk, acc_s, w_proj, j0, W, H);
      __syncthreads();
      cur = 1 - cur;
    }
  }
};

}  // namespace tapclip
