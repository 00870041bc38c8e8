// K1: fused MLP half-block, out = x + (gelu(LN(x) @ w_fc + b_fc) @ w_proj + b_proj).
//
// Replaces tapclip_tpu/ops/fused_mlp.py::_mlp_kernel (the pallas_call in
// _fused_mlp_fwd_impl).
//
// What bounds it on the card: latency inside each SM, from a block-count
// probe (no profiler trace yet).  By its shape the work is arithmetic: at
// ViT-B/16 serving shapes (R = 8 x 200 rows, W = 768, H = 3072) it does
// 2 x 2 x R x W x H = 15 GFLOP against 19 MB of weights (f32).  But it
// reaches 9.1 TFLOP/s, 14% of the f32 FMA peak, and on an H100 80GB HBM3 at
// 700 W, 200 blocks (B = 16) take only 1.24x the time of 100 (B = 8): a
// block uses 112 KiB of shared memory, two fit on an SM, and a second
// block's 8 warps raise the SM's throughput 1.6x.  So one 8-warp block
// per SM, which is what the image shape's 100 blocks (the text shape's 44)
// on 132 SMs give, cannot hide the latency of its weight reads (every block
// reads all of w_fc and w_proj from L2, one scalar load per thread per
// reduction step).  More warps per SM and tensor-core MMA are the next
// steps.  The unfused form also moves the [R, 4W] hidden activation through
// device memory twice; keeping it on chip is the point of the TPU kernel,
// and of this one.
//
// Design: a block owns 16 rows.  It normalises them in f32 (LayerNorm
// statistics as in the JAX kernel) into shared memory, then walks the
// hidden dimension in chunks of 256 columns: each thread owns one hidden
// column, computes fc + bias + exact GELU (erff) for the 16 rows, and the
// chunk [16, 256] stays in shared memory; then the threads add the chunk's
// partial projection into an f32 [16, W] accumulator in shared memory.  The
// accumulator starts as x + b_proj and is stored once at the end.  The
// hidden activation never reaches device memory.  Products run on the FMA
// units in f32 for both dtypes (tensor-core MMA is later work); the inner
// loops read four reduction steps per 16-byte shared-memory load.
// Rows past R (the ragged last tile) are computed on zeros and not stored.
#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kRows = 16;     // rows per block
constexpr int kThreads = 256; // threads per block
constexpr int kChunk = 256;   // hidden columns per chunk: one per thread

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ w_fc,
                 const float* __restrict__ b_fc, const T* __restrict__ w_proj,
                 const float* __restrict__ b_proj, T* __restrict__ out, int R,
                 int W, int H, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* y_s = smem;                   // [kRows][W] LN(x), rounded to T
  float* acc_s = y_s + kRows * W;      // [kRows][W] f32 accumulator
  float* h_s = acc_s + kRows * W;      // [kRows][kChunk] GELU(fc), rounded to T
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;

  // LayerNorm, one warp per row; the accumulator starts as x + b_proj.
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* yr = y_s + r * W;
    float* ar = acc_s + r * W;
    const int gr = row0 + r;
    if (gr < R) {
      const T* xr = x + static_cast<size_t>(gr) * W;
      float s = 0.f;
      for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
      const float mean = warp_sum(s) / W;
      float v = 0.f;
      for (int c = lane; c < W; c += 32) {
        const float d = to_f(xr[c]) - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) / W + eps);
      for (int c = lane; c < W; c += 32) {
        const float xv = to_f(xr[c]);
        yr[c] = round_to<T>((xv - mean) * rstd * gamma[c] + beta[c]);
        ar[c] = xv + b_proj[c];
      }
    } else {
      for (int c = lane; c < W; c += 32) {
        yr[c] = 0.f;
        ar[c] = 0.f;
      }
    }
  }
  __syncthreads();

  for (int j0 = 0; j0 < H; j0 += kChunk) {
    // fc + bias + GELU: thread tid owns hidden column j0 + tid.
    const int hcol = j0 + tid;
    float a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = 0.f;
    if (hcol < H) {
      const T* wc = w_fc + hcol;
#pragma unroll 2
      for (int k = 0; k < W; k += 4) {
        const float w0 = to_f(wc[static_cast<size_t>(k) * H]);
        const float w1 = to_f(wc[static_cast<size_t>(k + 1) * H]);
        const float w2 = to_f(wc[static_cast<size_t>(k + 2) * H]);
        const float w3 = to_f(wc[static_cast<size_t>(k + 3) * H]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 yv = *reinterpret_cast<const float4*>(y_s + r * W + k);
          a[r] = fmaf(yv.x, w0, a[r]);
          a[r] = fmaf(yv.y, w1, a[r]);
          a[r] = fmaf(yv.z, w2, a[r]);
          a[r] = fmaf(yv.w, w3, a[r]);
        }
      }
      const float bias = b_fc[hcol];
#pragma unroll
      for (int r = 0; r < kRows; ++r) h_s[r * kChunk + tid] = round_to<T>(gelu_erf(a[r] + bias));
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) h_s[r * kChunk + tid] = 0.f;
    }
    __syncthreads();

    // Partial projection of the chunk into the accumulator.
    const int kmax = min(kChunk, H - j0);
    for (int c = tid; c < W; c += kThreads) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = 0.f;
      const T* wc = w_proj + static_cast<size_t>(j0) * W + c;
#pragma unroll 2
      for (int k = 0; k < kmax; k += 4) {
        const float w0 = to_f(wc[static_cast<size_t>(k) * W]);
        const float w1 = to_f(wc[static_cast<size_t>(k + 1) * W]);
        const float w2 = to_f(wc[static_cast<size_t>(k + 2) * W]);
        const float w3 = to_f(wc[static_cast<size_t>(k + 3) * W]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(h_s + r * kChunk + k);
          p[r] = fmaf(hv.x, w0, p[r]);
          p[r] = fmaf(hv.y, w1, p[r]);
          p[r] = fmaf(hv.z, w2, p[r]);
          p[r] = fmaf(hv.w, w3, p[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc_s[r * W + c] += p[r];
    }
    __syncthreads();
  }

  for (int r = 0; r < kRows; ++r) {
    const int gr = row0 + r;
    if (gr >= R) break;
    for (int c = tid; c < W; c += kThreads)
      out[static_cast<size_t>(gr) * W + c] = from_f<T>(acc_s[r * W + c]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   const void* w_fc, const float* b_fc, const void* w_proj,
                   const float* b_proj, void* out, int R, int W, int H,
                   float eps, cudaStream_t stream) {
  const size_t smem = (2 * kRows * W + kRows * kChunk) * sizeof(float);
  auto kernel = fused_mlp_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<const T*>(w_fc), b_fc,
      static_cast<const T*>(w_proj), b_proj, static_cast<T*>(out), R, W, H, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  W and H must be multiples of 4.
extern "C" int tapclip_fused_mlp(const void* x, const void* gamma, const void* beta,
                                 const void* w_fc, const void* b_fc,
                                 const void* w_proj, const void* b_proj, void* out,
                                 int R, int W, int H, float eps, int dtype,
                                 void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || W % 4 || H % 4) return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  const auto* bf = static_cast<const float*>(b_fc);
  const auto* bp = static_cast<const float*>(b_proj);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, g, b, w_fc, bf, w_proj, bp, out, R, W, H, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, b, w_fc, bf, w_proj, bp, out, R, W, H, eps, s);
  return cudaErrorInvalidValue;
}
