// Shared helpers of the tapclip_tpu_torch CUDA kernels.
//
// Every kernel takes float32 or bfloat16 tensors, converts each element to
// float on load and accumulates in float32.  Where the JAX kernel rounds an
// intermediate to the compute dtype (`.astype(x.dtype)`), the CUDA kernel
// rounds the same intermediate with `round_to<T>`, so both see the same
// values in bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace tapclip {

constexpr float kLog2e = 1.4426950408889634f;
// The finite mask value of the JAX kernels (fused_mha.py, flash_attention.py).
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// v rounded to T and widened back to float.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// Reductions over the 32 lanes of a warp.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Reductions over the 16 lanes of a half warp (lanes 0-15 and 16-31 apart).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The A&S 7.1.25 3-term erf of scripts/_bench_util.py::erf3 (|err| <= 2.5e-5),
// the erf3 switch of the A/B variants (int8_mlp.cu's S5, fused_mlp's S2),
// written step by step so nvcc fuses nothing the plain versions round twice.
__device__ __forceinline__ float erf3(float x) {
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.47047f, ax)));
  const float poly =
      __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(0.7478556f, t), -0.0958798f), t), 0.3480242f), t);
  const float y = __fsub_rn(1.f, __fmul_rn(poly, expf(-__fmul_rn(ax, ax))));
  return x < 0.f ? -y : (x > 0.f ? y : 0.f);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tapclip
