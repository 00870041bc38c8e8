// B7: backward of the packed-QKV attention core B6,
//   dqkv [B, T, 3W] from the saved qkv [B, T, 3W] and the cotangent g [B, T, W],
// all in the compute dtype.
//
// Replaces tapclip_tpu/ops/fused_mha.py::_mha_bwd_kernel (the pallas_call in
// _fused_mha_bwd_impl).  The wrapper is the backward of the autograd Function
// tapclip_tpu_torch/ops/fused_mha.py::fused_mha; prompt tuning in the
// idiomatic text mode runs it once per text block of the encode pass.
//
// Per head, as the TPU kernel: recompute p = softmax(mask(q k^T scale)) in
// f32 from the saved qkv, then dv = p^T g (p rounded to g's dtype),
// dp = g v^T (f32), ds = p (dp - sum(dp p)) scale, dq = ds k, dk = ds^T q.
// One launch of the [T, T]-tile core (attn_bwd_core.cuh), which reads q, k, v straight
// out of the packed qkv rows and g out of [B, T, W], and writes dq, dk, dv
// straight into their column blocks of dqkv.  One block per (batch row,
// head) holds the head's whole [T, T] f32 probability tile in shared memory;
// past the T whose tile fits (210 at Dh 64) the wrapper runs the blockwise
// flash chain (flash_bwd.cu) on the packed strides instead, as the JAX
// kernel runs at any T.
//
// What bounds it on the card: inferred, not measured by a profile.  Per
// (batch row, head) the core does about 5 x T^2 x Dh FMAs on the FMA units
// with one block of 8 warps, over B x H blocks (64 at the idiomatic text
// shape of 8 classes x 8 heads): fewer blocks than SMs, so the time is one
// block's serial pass, not bandwidth (about 5 MB in and 4 MB out in f32 at
// T = 77, under 3 us at the card's memory rate).  Splitting over query tiles
// and tensor-core MMA are later work.
#include "attn_bwd_core.cuh"
#include "common.cuh"

// qkv [B, T, 3W], g [B, T, W] in; dqkv [B, T, 3W] out; all in the compute
// dtype (0 float32, 1 bfloat16).  Head dim W / n_heads in {16, 32, 64, 128};
// 1 <= valid <= T; T at most tapclip_attn_bwd_max_seq(Dh); causal 0 or 1.
extern "C" int tapclip_mha_bwd(const void* qkv, const void* g, void* dqkv, int B, int T,
                               int W, int n_heads, int valid, int causal, int dtype,
                               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd_core_dh<float, float, false>(static_cast<const float*>(qkv),
                                                   static_cast<const float*>(g), nullptr, dqkv,
                                                   B, T, W, n_heads, valid, causal, s);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return launch_bwd_core_dh<bf, bf, false>(static_cast<const bf*>(qkv),
                                             static_cast<const bf*>(g), nullptr, dqkv, B, T, W,
                                             n_heads, valid, causal, s);
  }
  return cudaErrorInvalidValue;
}
