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
// The device code (LayerNorm rows, the chunk walk) lives in mlp_walk.cuh,
// shared with the A/B variants S2 (fused_mlp_variants.cu) and the fused layer
// S1 (fused_layer.cu); K1 is its 16-row configuration.
#include "common.cuh"
#include "fused_mlp.cuh"

using namespace tapclip;

// dtype: 0 float32, 1 bfloat16.  W and H must be multiples of 4.
extern "C" int tapclip_fused_mlp(const void* x, const void* gamma, const void* beta,
                                 const void* w_fc, const void* b_fc,
                                 const void* w_proj, const void* b_proj, void* out,
                                 int R, int W, int H, float eps, int dtype,
                                 void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || W % 4 || H % 4) return cudaErrorInvalidValue;
  const MlpCall c{x, static_cast<const float*>(gamma), static_cast<const float*>(beta), w_fc,
                  static_cast<const float*>(b_fc), w_proj, static_cast<const float*>(b_proj), out,
                  R, W, H, eps, 0, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_mlp<float, 16, false, false>(c);
  if (dtype == 1) return launch_mlp<__nv_bfloat16, 16, false, false>(c);
  return cudaErrorInvalidValue;
}
