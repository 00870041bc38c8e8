// K1: fused MLP half-block, out = x + (gelu(LN(x) @ w_fc + b_fc) @ w_proj + b_proj).
//
// Replaces tapclip_tpu/ops/fused_mlp.py::_mlp_kernel (the pallas_call in
// _fused_mlp_fwd_impl), with its roundings: LayerNorm in f32 with two-pass
// statistics, y rounded to the compute dtype, f32 accumulation, exact GELU
// (erff), h rounded to the compute dtype before the projection, the residual
// and b_proj added in f32 and one rounding at the store.
//
// What bounds it on the card: the products.  At ViT-B/16's image shape
// (R = 8 x 200 rows, W = 768, H = 3,072) it does 2 x 2 R W H = 15 GFLOP
// against 19 MB of f32 weights: 0.225 ms at the f32 FMA peak, 0.092 ms as
// the six bf16 MMAs a product that f32 takes here (below), 0.015 ms in bf16.
//
// Design: three launches on the tensor cores, one K1 call (the wrapper
// allocates the scratch: h [R, H] then y [R, W], in the compute dtype).
//   1. LayerNorm, one warp a row: y = LN(x), rounded to the dtype.
//   2. fc: h = gelu(y . w_fc + b_fc), rounded, in 64 x 128 tiles of h.
//   3. proj: out = x + (h . w_proj + b_proj), in 64 x 64 tiles of out.
// Each product runs 8 warps a block, each a 32 x 32 sub-tile (32 x 16 in
// proj; 32-row tiles, 16-row sub-tiles, when 64-row tiles would not give
// every SM two blocks: the text shapes), the depth in 32-deep stages, zeros
// past every edge, mma.sync m16n8k16 bf16 with f32 accumulation from
// ldmatrix fragments (flash_mma.cuh; .trans for the weights, which are
// [depth, columns] row major).
//   * bf16 (gemm_bf16_kernel): y, h and the weights are exact bf16
//     operands, staged by a three-stage ring of 16-byte cp.async copies
//     (8-byte when a width is not a multiple of 8 or an operand is not
//     16-byte aligned); one MMA a product changes only the order of the f32
//     sums.
//   * f32 (gemm_f32_kernel): each operand splits into three bf16 terms, six
//     MMAs a product (mma::mma_split), and each 16-deep step's partial
//     products are summed from 0 and added with a rounded f32 add: the MMA's
//     own accumulation rounds toward zero, and the projection sums over
//     H = 3,072 (4,096 at ViT-L).  The next stage's f32 tiles are loaded
//     into registers while this stage's products run, and split once per
//     block into three bf16 planes in shared memory (two buffers), so no
//     warp repeats another's split and the fragments load by ldmatrix.
//     Emulated error: python -m tapclip_tpu_torch.scripts.split_error.
// The GEMM (tiles, stage ring, split, epilogues) lives in gemm_mma.cuh, which
// K2 (attn_block.cu) and B5 (mlp_bwd.cu) share; the LayerNorm rows in
// ln_rows.cuh.  Two tensor-core passes tile both dimensions of both products
// (600 and 300 blocks at the image shape) where one fused launch could spread
// only along rows; h makes one round trip through L2 (9.8 MB in bf16, 19.7 MB
// in f32).
// No atomics: every sum runs in one block in a fixed order, so a call
// repeats bit for bit.
//
// The FMA walk of the earlier K1 (mlp_walk.cuh, fused_mlp.cuh) stays as the
// A/B variants S2 (fused_mlp_variants.cu) and phase B of S1 (fused_layer.cu).
#include <stdint.h>

#include "common.cuh"
#include "gemm_mma.cuh"
#include "ln_rows.cuh"

namespace {

using namespace tapclip;
using gemm::Epi;

template <typename T, int CE>
cudaError_t launch_mlp(const T* x, const float* gamma, const float* beta, const T* w_fc, const float* b_fc,
                       const T* w_proj, const float* b_proj, T* out, T* ws, int R, int W, int H, float eps,
                       cudaStream_t s) {
  T* h = ws;
  T* y = ws + static_cast<size_t>(R) * H;
  ln_rows_kernel<T><<<(R + kLnWarps - 1) / kLnWarps, kLnThreads, 0, s>>>(x, gamma, beta, y, nullptr, nullptr,
                                                                          R, W, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 128, CE, gemm::kGelu>(y, w_fc, Epi<T>{b_fc, nullptr, nullptr, nullptr, 0}, h, R, H, W,
                                                    s);
  if (err != cudaSuccess) return err;
  return gemm::launch_pass<T, 64, CE, gemm::kResidual>(h, w_proj, Epi<T>{b_proj, x, nullptr, nullptr, 0}, out, R,
                                                       W, H, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  W and H multiples of 4; ws scratch of
// R * (H + W) elements of the dtype; every pointer of the dtype 16-byte
// aligned in float32, 8-byte aligned in bfloat16.
extern "C" int tapclip_fused_mlp(const void* x, const void* gamma, const void* beta,
                                 const void* w_fc, const void* b_fc,
                                 const void* w_proj, const void* b_proj, void* out, void* ws,
                                 int R, int W, int H, float eps, int dtype,
                                 void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || W % 4 || H % 4) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_fc) |
                         reinterpret_cast<uintptr_t>(w_proj) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(ws);
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bf = static_cast<const float*>(b_fc);
  const auto* bp = static_cast<const float*>(b_proj);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (ptrs & 15) return cudaErrorMisalignedAddress;
    return launch_mlp<float, 4>(static_cast<const float*>(x), g, bt, static_cast<const float*>(w_fc), bf,
                                static_cast<const float*>(w_proj), bp, static_cast<float*>(out),
                                static_cast<float*>(ws), R, W, H, eps, s);
  }
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    if (ptrs & 7) return cudaErrorMisalignedAddress;
    const auto* X = static_cast<const bf16*>(x);
    const auto* Wf = static_cast<const bf16*>(w_fc);
    const auto* Wp = static_cast<const bf16*>(w_proj);
    if ((ptrs & 15) == 0 && W % 8 == 0 && H % 8 == 0)
      return launch_mlp<bf16, 8>(X, g, bt, Wf, bf, Wp, bp, static_cast<bf16*>(out), static_cast<bf16*>(ws), R, W, H,
                                 eps, s);
    return launch_mlp<bf16, 4>(X, g, bt, Wf, bf, Wp, bp, static_cast<bf16*>(out), static_cast<bf16*>(ws), R, W, H,
                               eps, s);
  }
  return cudaErrorInvalidValue;
}
