// K2: fused attention half-block,
//   out = x + out_proj(softmax_masked(q k^T / sqrt(Dh)) v),  q, k, v = qkv_proj(LN(x)).
//
// Replaces tapclip_tpu/ops/fused_mha.py::_attn_block_kernel (the pallas_call in
// _attn_block_fwd_impl), with its roundings: LayerNorm in f32 with two-pass
// statistics, y rounded to the compute dtype; qkv = y . w_qkv + b_qkv in f32,
// q and k kept f32, v rounded to the compute dtype; scores q . k^T times
// Dh^-1/2 log2 e, keys at or past valid at -1e30, exp2, l summed over the
// unrounded p; p rounded to v's dtype before p . v, o / l rounded into attn;
// out = (attn . w_out + b_out) + x in f32 with one rounding at the store.
// Padded query rows (valid <= t < T) are computed like any other row, so they
// stay finite through every layer.
//
// What bounds it on the card: the products.  At ViT-B/16's image shape (8 x
// 200 rows, W 768, 12 heads, valid 197) the projections do 8 B T W^2 = 7.5
// GFLOP and the attention 4 W per (query, valid key) pair = 1.0 GFLOP:
// 0.127 ms at the f32 FMA peak, 0.052 ms as the bf16 MMAs f32 takes here
// (six a product), 0.009 ms in bf16.  The earlier K2 ran every product on
// the FMA units in one block per (batch row, head), 96 blocks on 132 SMs,
// each walking its head's whole [T, 3 Dh] slice of the QKV product and then
// the attention in order (9.1 TFLOP/s, 0.915 ms).
//
// Design: four launches on the tensor cores behind one wrapper call
// (tapclip_tpu_torch/ops/fused_mha.py::fused_attn_block; the wrapper
// allocates an f32 workspace qkv [R, 3W] and a scratch ya [R, W] of the
// dtype, R = B T):
//   1. LayerNorm rows (ln_rows.cuh): ya = y = LN(x), rounded.
//   2. qkv = y . w_qkv + b_qkv, K1's tiled GEMM (gemm_mma.cuh) with the kQkv
//      epilogue: f32 out, the v third of the columns rounded to the dtype;
//      450 blocks of 64 x 128 at the image shape.
//   3. attention (attn_core_mma.cuh, shared with B14): one block per (batch
//      row, head, ROWS-row query tile), K3's tile walk (flash_mma.cuh): 64-key
//      tiles with an online softmax in the log2 domain, K and V
//      double-buffered by 16-byte cp.async straight from the packed qkv
//      rows (row stride 3W), the score accumulator reused in registers as
//      p.  q . k^T splits q and k into three bf16 terms in both dtypes (six
//      MMAs: they are f32 values in bf16 too, as in the TPU kernel; only its
//      qk_cast variant, S4, rounds them); p . v is six MMAs in f32 and one
//      in bf16 (p rounded, v a bf16 value read from the f32 workspace as
//      one exact term).  attn goes into ya (y is spent).  ROWS is 16, 32 or
//      64 by T as in K3: 384 blocks at the image shape, 192 at the text
//      shape.
//   4. out = (attn . w_out + b_out) + x, the same GEMM with K1's kResidual
//      epilogue (also the out-projection of the A/B variants S3/S4,
//      tapclip_gemm_bias_residual).
// No atomics: a call repeats bit for bit.  Emulated error of the split
// products: python -m tapclip_tpu_torch.scripts.split_error.
//
// Measured on an H100 80GB HBM3 at 700 W (time_half_blocks.py,
// profile_kernels.py): at the image shape 0.274 ms in f32 (QKV 127 us,
// attention 74, out-projection 64, LayerNorm 6) and 0.108 ms in bf16
// (attention 47, QKV 34, out-projection 19), against 0.909 and 0.893 for
// the FMA design.  In f32 the GEMMs run at 45 (QKV) and 29 (out-projection,
// 300 tiles of 64 x 64: 1.14 waves of two blocks an SM) TFLOP/s of the
// function's products; in bf16 the attention leads, its q . k^T still six
// MMAs on f32 q and k split in registers for every key tile.
//
// K2's earlier FMA core (attn_core.cuh, attn_tile.cuh) stays as the device
// code of the A/B variants S3/S4 (attn_variants_*.cu) and of phase A of S1
// (fused_layer.cu).
#include <stdint.h>

#include "attn_core_mma.cuh"
#include "common.cuh"
#include "gemm_mma.cuh"
#include "ln_rows.cuh"

namespace {

using namespace tapclip;
using gemm::Epi;

template <typename T, int CE>
cudaError_t launch_block(const T* x, const float* gamma, const float* beta, const T* w_qkv, const float* b_qkv,
                         const T* w_out, const float* b_out, T* out, float* qkv, T* ya, int B, int T_, int W,
                         int H, int valid, float eps, cudaStream_t s) {
  const int R = B * T_;
  ln_rows_kernel<T><<<(R + kLnWarps - 1) / kLnWarps, kLnThreads, 0, s>>>(x, gamma, beta, ya, nullptr, nullptr,
                                                                          R, W, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm::launch_pass<T, 128, CE, gemm::kQkv, false, float>(
      ya, w_qkv, Epi<T>{b_qkv, nullptr, nullptr, nullptr, 2 * W}, qkv, R, 3 * W, W, s);
  if (err != cudaSuccess) return err;
  err = attn::launch_attn_core<float, T, T>(qkv, ya, nullptr, B, H, T_, W, valid, s);
  if (err != cudaSuccess) return err;
  return gemm::launch_pass<T, 64, CE, gemm::kResidual>(ya, w_out, Epi<T>{b_out, x, nullptr, nullptr, 0}, out, R,
                                                       W, W, s);
}

bool aligned(uintptr_t ptrs, int dtype) { return (ptrs & (dtype == 0 ? 15 : 7)) == 0; }

}  // namespace

// K2, all four launches.  dtype: 0 float32, 1 bfloat16.  Head dim
// W / n_heads in {16, 32, 64, 128}; valid in [1, T]; qkv an f32 workspace of
// B T 3W, ya a scratch of B T W elements of the dtype; x, w_qkv, w_out, out
// and ya 16-byte aligned in float32, 8-byte aligned in bfloat16.
extern "C" int tapclip_attn_block(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                  const void* b_qkv, const void* w_out, const void* b_out, void* out, void* qkv,
                                  void* ya, int B, int T, int W, int n_heads, int valid, float eps, int dtype,
                                  void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || W % 4 || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_qkv) |
                         reinterpret_cast<uintptr_t>(w_out) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(ya) | reinterpret_cast<uintptr_t>(qkv);
  if (!aligned(ptrs, dtype)) return cudaErrorMisalignedAddress;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bq = static_cast<const float*>(b_qkv);
  const auto* bo = static_cast<const float*>(b_out);
  auto* ws = static_cast<float*>(qkv);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_block<float, 4>(static_cast<const float*>(x), g, bt, static_cast<const float*>(w_qkv), bq,
                                  static_cast<const float*>(w_out), bo, static_cast<float*>(out), ws,
                                  static_cast<float*>(ya), B, T, W, n_heads, valid, eps, s);
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const auto* X = static_cast<const bf16*>(x);
    const auto* Wq = static_cast<const bf16*>(w_qkv);
    const auto* Wo = static_cast<const bf16*>(w_out);
    if ((ptrs & 15) == 0 && W % 8 == 0)
      return launch_block<bf16, 8>(X, g, bt, Wq, bq, Wo, bo, static_cast<bf16*>(out), ws, static_cast<bf16*>(ya), B,
                                   T, W, n_heads, valid, eps, s);
    return launch_block<bf16, 4>(X, g, bt, Wq, bq, Wo, bo, static_cast<bf16*>(out), ws, static_cast<bf16*>(ya), B, T,
                                 W, n_heads, valid, eps, s);
  }
  return cudaErrorInvalidValue;
}

// K2's out-projection alone, out = round((a . w + bias) + res), a [M, K],
// w [K, N] row major: the out-projection of the A/B variants S3/S4.  dtype:
// 0 float32, 1 bfloat16; N and K multiples of 4; a, w, res and out 16-byte
// aligned in float32, 8-byte aligned in bfloat16.
extern "C" int tapclip_gemm_bias_residual(const void* a, const void* w, const void* bias, const void* res,
                                          void* out, int M, int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 4 || K % 4) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(out);
  if (!aligned(ptrs, dtype)) return cudaErrorMisalignedAddress;
  const auto* bs = static_cast<const float*>(bias);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gemm::launch_pass<float, 64, 4, gemm::kResidual>(
        static_cast<const float*>(a), static_cast<const float*>(w),
        Epi<float>{bs, static_cast<const float*>(res), nullptr, nullptr, 0}, static_cast<float*>(out), M, N, K, s);
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const auto* A = static_cast<const bf16*>(a);
    const auto* Wt = static_cast<const bf16*>(w);
    const Epi<bf16> e{bs, static_cast<const bf16*>(res), nullptr, nullptr, 0};
    if ((ptrs & 15) == 0 && N % 8 == 0 && K % 8 == 0)
      return gemm::launch_pass<bf16, 64, 8, gemm::kResidual>(A, Wt, e, static_cast<bf16*>(out), M, N, K, s);
    return gemm::launch_pass<bf16, 64, 4, gemm::kResidual>(A, Wt, e, static_cast<bf16*>(out), M, N, K, s);
  }
  return cudaErrorInvalidValue;
}
