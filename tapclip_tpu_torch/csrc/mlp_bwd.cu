// B5: backward of the fused MLP half-block K1,
//   out = x + (gelu(LN(x) @ w_fc + b_fc) @ w_proj + b_proj).
//
// Replaces tapclip_tpu/ops/fused_mlp.py::_mlp_bwd_kernel (the pallas_call in
// _fused_mlp_bwd_impl).  Like the TPU kernel it never receives the forward's
// hidden tensor: it recomputes LN -> fc -> GELU from x.  bfloat16 rounds
// where the TPU kernel rounds: y, the cotangent g, h (for dW_proj) and
// dh_pre (for dy and dW_fc); the LN statistics, z = h_pre, dh and dy stay
// f32; db_fc sums the unrounded dh_pre.
//
// What bounds it on the card: the products.  dx takes three, each 2 R W H
// (the fc recompute z = y . w_fc, dh = g . w_proj^T, dy = dh_pre . w_fc^T):
// at the text tower's shape (R 8 x 88, W 512, H 2,048) 4.4 GFLOP, 0.066 ms
// at the f32 FMA peak, 0.027 ms as the six bf16 MMAs a product f32 takes
// here, 0.005 ms in bf16.  The earlier B5 walked H in 256-column chunks on
// the FMA units, 16 rows a block (44 blocks at that shape), every block
// reading all of w_fc twice and w_proj once: 1.60 ms.
//
// Design: five launches on the tensor cores behind one wrapper call
// (tapclip_tpu_torch/ops/fused_mlp.py::_fused_mlp_bwd_cuda, which allocates
// the f32 workspace [z | dy partials | mean | rstd] and the dtype scratch
// [dh_pre | y]):
//   1. LayerNorm rows (ln_rows.cuh): y = LN(x) rounded, mean and rstd.
//   2. z = y . w_fc + b_fc, K1's tiled GEMM (gemm_mma.cuh), f32 out (kBias).
//   3. dh = g . w_proj^T (w_proj [H, W] read as the [N, K] B operand), whose
//      epilogue (kDgelu) reads z and writes dh_pre = dh (Phi(z) + z phi(z))
//      rounded (erff, expf, as the plain version); with weight gradients
//      also h = round(z Phi(z)) and the unrounded dh_pre over z (for db_fc).
//   4. dy = dh_pre . w_fc^T (w_fc [W, H] as the [N, K] B operand, depth H),
//      split over the depth into S f32 partials [S, R, W] when the [R, W]
//      tiles alone would not give every SM two blocks in bf16, four in f32
//      (S from tapclip_mlp_bwd_split: 4 at the text shape, 88 tiles of
//      64 x 64 to 352 blocks; at the image shape, 300 tiles, 2 in f32 and 1
//      in bf16).
//   5. dx = g + LN backward of dy (ln_rows.cuh's ln_bwd_rows_kernel, B4's,
//      summing the S partials in order); with weight gradients also its
//      per-16-row partial column sums of dy * n and dy.
// The products take the GEMM's numerics: bf16 operands exact, one MMA a
// product; f32 operands split into three bf16 terms, six MMAs a product with
// a rounded f32 add per 16-deep step.  z and dh_pre (R x H, 5.8 MB in f32 at
// the text shape) pass through the card's L2 between launches; two passes of
// K1's GEMM, each holding one accumulator and two blocks an SM, stand where
// one launch with both accumulators would hold one block an SM in f32.
// Measured on an H100 80GB HBM3 at 700 W (time_half_blocks.py,
// profile_kernels.py), dx alone at the text shape: 0.161 ms in f32 (z 47 us,
// dh_pre 52, dy 42, the LayerNorm rows 4 + 8) and 0.061 ms in bf16 (15, 19,
// 13, 3 + 6), against 1.59 and 1.54 for the FMA design: four launch gaps
// of a few us each are a fifth of it in bf16.
// Weight gradients (only with want_w; off the training path, where the CLIP
// weights are frozen and only the prompt context trains) stay on gemm.cu's
// A^T . B products and column sums, run by the wrapper.  No atomics: a call
// repeats bit for bit.  Emulated error of the split products: python -m
// tapclip_tpu_torch.scripts.split_error.
#include <stdint.h>

#include "common.cuh"
#include "gemm_mma.cuh"
#include "ln_rows.cuh"

namespace {

using namespace tapclip;
using gemm::Epi;

constexpr int kMaxSplit = 4;
static_assert(kMaxSplit <= kLnMaxSplits, "ln_bwd_rows_kernel sums every partial");

// S: the split of dy's depth H (gemm::depth_split).
int dy_split(int R, int W, int H, int dtype) { return gemm::depth_split(R, W, H, dtype, kMaxSplit); }

template <typename T, int CE>
cudaError_t launch_bwd(const T* x, const T* g, const float* gamma, const float* beta, const T* w_fc,
                       const float* b_fc, const T* w_proj, T* dx, float* ws, T* wsd, T* h_out, float* part, int R,
                       int W, int H, float eps, int S, int want_w, cudaStream_t s) {
  float* z = ws;                                                 // [R, H]
  float* dy = z + static_cast<size_t>(R) * H;                    // [S, R, W]
  float* mean = dy + static_cast<size_t>(S) * R * W;             // [R]
  float* rstd = mean + R;                                        // [R]
  T* dhp = wsd;                                                  // [R, H]
  T* y = wsd + static_cast<size_t>(R) * H;                       // [R, W]
  ln_rows_kernel<T><<<(R + kLnWarps - 1) / kLnWarps, kLnThreads, 0, s>>>(x, gamma, beta, y, mean, rstd, R, W,
                                                                          eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 128, CE, gemm::kBias, false, float>(
      y, w_fc, Epi<T>{b_fc, nullptr, nullptr, nullptr, 0}, z, R, H, W, s);
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 128, CE, gemm::kDgelu, true>(
      g, w_proj, Epi<T>{nullptr, nullptr, z, want_w ? h_out : nullptr, 0}, dhp, R, H, W, s);
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 64, CE, gemm::kStore, true, float>(dhp, w_fc, Epi<T>{}, dy, R, W, H, s, S);
  if (err != cudaSuccess) return err;
  ln_bwd_rows_kernel<T><<<(R + kLnBwdRows - 1) / kLnBwdRows, kLnBwdThreads, 0, s>>>(
      x, g, dy, S, static_cast<size_t>(R) * W, gamma, mean, rstd, dx, part, R, W, want_w);
  return cudaGetLastError();
}

}  // namespace

// The split S of dy's depth that tapclip_mlp_bwd takes at this shape and
// dtype (0 float32, 1 bfloat16; the wrapper sizes the workspace with it).
extern "C" int tapclip_mlp_bwd_split(int R, int W, int H, int dtype) {
  if (R <= 0 || W <= 0 || H <= 0) return 0;
  return dy_split(R, W, H, dtype);
}

// B5.  dtype: 0 float32, 1 bfloat16.  W and H multiples of 4; split S in
// 1..4 (tapclip_mlp_bwd_split's choice, or another); ws an f32 workspace of
// R H + S R W + 2 R, wsd a scratch of R (H + W) elements of the dtype (dh_pre
// then y: the operands of dW_fc with want_w).  With want_w, h_out [R, H]
// (dtype) gets round(gelu(z)), the first R H floats of ws the unrounded
// dh_pre and part [ceil(R / 16), 2W] (f32) the partial column sums of dy * n
// and dy; without, h_out and part are not touched (may be null).  x, g,
// w_fc, w_proj, ws and wsd 16-byte aligned in float32, 8-byte in bfloat16.
extern "C" int tapclip_mlp_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                               const void* w_fc, const void* b_fc, const void* w_proj, void* dx, void* ws,
                               void* wsd, void* h_out, void* part, int R, int W, int H, float eps, int split,
                               int want_w, int dtype, void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || W % 4 || H % 4 || split < 1 || split > kMaxSplit) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(w_fc) |
                         reinterpret_cast<uintptr_t>(w_proj) | reinterpret_cast<uintptr_t>(ws) |
                         reinterpret_cast<uintptr_t>(wsd);
  const auto* gm = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bf = static_cast<const float*>(b_fc);
  auto* w32 = static_cast<float*>(ws);
  auto* pt = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ptrs & 15) return cudaErrorMisalignedAddress;
    return launch_bwd<float, 4>(static_cast<const float*>(x), static_cast<const float*>(g), gm, bt,
                                static_cast<const float*>(w_fc), bf, static_cast<const float*>(w_proj),
                                static_cast<float*>(dx), w32, static_cast<float*>(wsd), static_cast<float*>(h_out),
                                pt, R, W, H, eps, split, want_w, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    if (ptrs & 7) return cudaErrorMisalignedAddress;
    const auto* X = static_cast<const bf16*>(x);
    const auto* G = static_cast<const bf16*>(g);
    const auto* Wf = static_cast<const bf16*>(w_fc);
    const auto* Wp = static_cast<const bf16*>(w_proj);
    auto* D = static_cast<bf16*>(dx);
    auto* Wd = static_cast<bf16*>(wsd);
    auto* Ho = static_cast<bf16*>(h_out);
    if ((ptrs & 15) == 0 && W % 8 == 0 && H % 8 == 0)
      return launch_bwd<bf16, 8>(X, G, gm, bt, Wf, bf, Wp, D, w32, Wd, Ho, pt, R, W, H, eps, split, want_w, s);
    return launch_bwd<bf16, 4>(X, G, gm, bt, Wf, bf, Wp, D, w32, Wd, Ho, pt, R, W, H, eps, split, want_w, s);
  }
  return cudaErrorInvalidValue;
}
