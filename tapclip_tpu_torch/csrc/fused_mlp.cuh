// The FMA-walk kernel of the fused MLP half-block as a template over
// mlp_walk.cuh's switches, and its launcher: instantiated at the S2
// variants' configurations by fused_mlp_variants.cu.
#pragma once

#include "common.cuh"
#include "mlp_walk.cuh"

namespace tapclip {

struct MlpCall {
  const void* x;
  const float *gamma, *beta;
  const void* w_fc;
  const float* b_fc;
  const void* w_proj;
  const float* b_proj;
  void* out;
  int R, W, H;
  float eps;
  int ln1pass;
  cudaStream_t stream;
};

template <typename T, int ROWS, bool ERF3, bool ILV>
__global__ void __launch_bounds__(256)
fused_mlp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ w_fc,
                 const float* __restrict__ b_fc, const T* __restrict__ w_proj,
                 const float* __restrict__ b_proj, T* __restrict__ out, int R,
                 int W, int H, float eps, int ln1pass) {
  using Walk = MlpWalk<T, ROWS, ERF3, ILV>;
  extern __shared__ __align__(16) float smem[];
  float* y_s = smem;                   // [ROWS][W] LN(x), rounded to T
  float* acc_s = y_s + ROWS * W;       // [ROWS][W] f32 accumulator
  float* h_s = acc_s + ROWS * W;       // [kHBufs][ROWS][kChunk] GELU(fc), rounded to T
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;

  // LayerNorm, one warp per row; the accumulator starts as x + b_proj.
  for (int r = warp; r < ROWS; r += Walk::kThreads / 32) {
    float* yr = y_s + r * W;
    float* ar = acc_s + r * W;
    const int gr = row0 + r;
    if (gr < R) {
      Walk::ln_row(x + static_cast<size_t>(gr) * W, yr, ar, gamma, beta, b_proj, W, eps, ln1pass != 0, lane);
    } else {
      for (int c = lane; c < W; c += 32) {
        yr[c] = 0.f;
        ar[c] = 0.f;
      }
    }
  }
  __syncthreads();

  Walk::walk(y_s, acc_s, h_s, w_fc, b_fc, w_proj, W, H);

  for (int r = 0; r < ROWS; ++r) {
    const int gr = row0 + r;
    if (gr >= R) break;
    for (int c = threadIdx.x; c < W; c += Walk::kThreads)
      out[static_cast<size_t>(gr) * W + c] = from_f<T>(acc_s[r * W + c]);
  }
}

template <typename T, int ROWS, bool ERF3, bool ILV>
cudaError_t launch_mlp(const MlpCall& c) {
  const size_t smem = MlpWalk<T, ROWS, ERF3, ILV>::floats(c.W) * sizeof(float);
  auto kernel = fused_mlp_kernel<T, ROWS, ERF3, ILV>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (c.R + ROWS - 1) / ROWS;
  kernel<<<blocks, 256, smem, c.stream>>>(
      static_cast<const T*>(c.x), c.gamma, c.beta, static_cast<const T*>(c.w_fc), c.b_fc,
      static_cast<const T*>(c.w_proj), c.b_proj, static_cast<T*>(c.out), c.R, c.W, c.H, c.eps, c.ln1pass);
  return cudaGetLastError();
}

}  // namespace tapclip
