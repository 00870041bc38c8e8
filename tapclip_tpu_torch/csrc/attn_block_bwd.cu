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
//   1. ln_rows (ln_rows.cuh, shared with K1, K2 and B5): LayerNorm
//      statistics per row in f32 and y = LN(x) rounded to the compute dtype.
//   2. gemm: qkv = y . w_qkv + b_qkv (f32), and the cotangent of the
//      attention output gh = g . w_out^T (f32).
//   3. attn_bwd_core (here): one block per (batch row, head) runs the
//      shared backward core (attn_bwd_core.cuh, which B7 also runs): the
//      head's whole [T, T] probability tile in f32 in shared memory, and the
//      TPU kernel's per-head chain o, dv, dp, ds, dq, dk.  It writes o into
//      attn [B, T, W] and dq, dk, dv into dqkv [B, T, 3W], both in the
//      compute dtype.  Past the T whose tile fits, the autograd Function
//      differentiates the split composition instead (plain projections
//      around B6 and the flash chain), as the JAX _attn_block_bwd does.
//   4. gemm: dy = dqkv . w_qkv^T (f32).
//   5. ln_bwd_rows (ln_rows.cuh, shared with B5): dx = g + LN backward of
//      dy; with weight gradients wanted, per-block partial column sums of
//      dy * n and dy.
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
#include "attn_bwd_core.cuh"
#include "common.cuh"
#include "ln_rows.cuh"

using namespace tapclip;

// Largest sequence length the backward core (B4 and B7) holds at head dim
// Dh (its [T, T] f32 tile and one [T, Dh] operand tile in shared memory, at
// most 32 x 8 keys per row), 0 for an unsupported head dim.
extern "C" int tapclip_attn_bwd_max_seq(int Dh) { return bwd_core_max_seq(Dh); }

// Step 1 of B4: y = LN(x) (dtype of x) and f32 mean / rstd per row.
extern "C" int tapclip_ln_rows(const void* x, const void* gamma, const void* beta,
                               void* y, void* mean, void* rstd, int R, int W,
                               float eps, int dtype, void* stream) {
  if (R <= 0 || W <= 0) return cudaErrorInvalidValue;
  const int blocks = (R + kLnWarps - 1) / kLnWarps;
  const auto* gm = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  auto* mu = static_cast<float*>(mean);
  auto* rs = static_cast<float*>(rstd);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ln_rows_kernel<float><<<blocks, kLnThreads, 0, s>>>(
        static_cast<const float*>(x), gm, bt, static_cast<float*>(y), mu, rs, R, W, eps);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    ln_rows_kernel<bf><<<blocks, kLnThreads, 0, s>>>(
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
  const auto* q = static_cast<const float*>(qkv);
  const auto* g = static_cast<const float*>(gh);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_core_dh<float, float, true>(q, g, attn, dqkv, B, T, W, n_heads, valid, 0, s);
  if (dtype == 1) {
    return launch_bwd_core_dh<__nv_bfloat16, float, true>(q, g, attn, dqkv, B, T, W, n_heads,
                                                          valid, 0, s);
  }
  return cudaErrorInvalidValue;
}

// Step 5 of B4: dx = g + LN backward of dy (f32); with want_w, part
// [ceil(R / 16), 2W] f32 gets the partial sums of dy * n and dy.
extern "C" int tapclip_ln_bwd_rows(const void* x, const void* g, const void* dy,
                                   const void* gamma, const void* mean,
                                   const void* rstd, void* dx, void* part, int R,
                                   int W, int want_w, int dtype, void* stream) {
  if (R <= 0 || W <= 0) return cudaErrorInvalidValue;
  const int blocks = (R + kLnBwdRows - 1) / kLnBwdRows;
  const auto* d = static_cast<const float*>(dy);
  const auto* gm = static_cast<const float*>(gamma);
  const auto* mu = static_cast<const float*>(mean);
  const auto* rs = static_cast<const float*>(rstd);
  auto* pt = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    ln_bwd_rows_kernel<float><<<blocks, kLnBwdThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), d, 1, 0, gm, mu, rs,
        static_cast<float*>(dx), pt, R, W, want_w);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    ln_bwd_rows_kernel<bf><<<blocks, kLnBwdThreads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(g), d, 1, 0, gm, mu, rs,
        static_cast<bf*>(dx), pt, R, W, want_w);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
