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
// f32 from the saved qkv (keys >= valid masked, and keys > query when
// causal), then dv = p^T g (p rounded to g's dtype), dp = g v^T (f32),
// ds = p (dp - sum(dp p)) scale, dq = ds k, dk = ds^T q.
//
// Design: two launches on the tensor cores, B4's row and column kernels
// (attn_bwd_mma.cuh) on the packed strides, with In = the dtype: q, k, v
// straight out of the packed qkv rows, g out of [B, T, W], dq, dk, dv
// straight into their column blocks of dqkv.
//   1. rows_kernel, one block per (batch row, head, query tile): the row
//      LSE, delta = sum(dp p), dq; lse and delta into the wrapper's f32
//      scratch [B H, T] each.  Causal, its walk over the keys stops at the
//      tile holding the query tile's last row.
//   2. cols_kernel, one block per (batch row, head, key tile): dk and dv
//      over the queries, causal from the tile holding its first key.
// In f32 every operand is split into three bf16 terms (six MMAs a
// product); in bf16 q, k, v and g are bf16 values, one exact term each, and
// so is p's bf16 rounding for dv; ds stays f32 in three terms: the TPU
// kernel's rounding points.  The MMAs sum in another order than the FMA
// core this design replaced, whose [T, T] f32 tile one block per (batch
// row, head) held in shared memory.  No atomics: a call repeats bit for bit.
// The kernels take any T, and the wrapper sends every T to them: at
// ViT-L/14's T 257 and 584 (4 x 16 heads, not causal) they took 0.264 and
// 0.889 ms in f32, 0.058 and 0.190 in bf16, where the blockwise flash chain
// (flash_bwd.cu) on the same packed strides took 0.320 / 0.951 and
// 0.179 / 0.236 (time_half_blocks.py, H100 80GB HBM3, 700 W).
//
// What bounds it on the card: the bytes, barely.  Per (batch row, head) 5
// products of 2 Dh a (query, visible key) pair: at the idiomatic step's
// shape (8 classes x 8 heads, T 77, causal) 0.12 GFLOP, 0.0018 ms at the f32
// FMA peak; qkv and g in and dqkv out are 8.8 MB in f32, 0.0026 ms.  Traces
// on an H100 80GB HBM3 at 700 W (profile_kernels.py) at that shape: the
// FMA core, one block of 8 warps per (batch row, head), 64 blocks on 132
// SMs, took 0.120 ms in either dtype; this design 0.048 ms in f32 (rows 31
// us, columns 18) and 0.014 in bf16 (8 + 5), where q, k, v and g take one
// MMA term each (time_half_blocks.py: launches alone 0.050 / 0.015 ms).
// The rows kernel leads: it walks the keys three times and recomputes the
// scores in each.
#include <stdint.h>

#include "attn_bwd_mma.cuh"
#include "common.cuh"

// qkv [B, T, 3W], g [B, T, W] in; dqkv [B, T, 3W] out; all in the compute
// dtype (0 float32, 1 bfloat16), 16-byte aligned; ws an f32 scratch of
// 2 B n_heads T floats (lse, delta), 16-byte aligned.  Head dim W / n_heads
// in {16, 32, 64, 128}; 1 <= valid <= T; causal 0 or 1.
extern "C" int tapclip_mha_bwd(const void* qkv, const void* g, void* dqkv, void* ws, int B, int T, int W,
                               int n_heads, int valid, int causal, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || valid < 1 || valid > T) return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dqkv) | reinterpret_cast<uintptr_t>(ws);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  float* lse = static_cast<float*>(ws);
  float* delta = lse + static_cast<size_t>(B) * n_heads * T;
  auto s = static_cast<cudaStream_t>(stream);
  using namespace tapclip::attn_bwd;
  if (dtype == 0)
    return launch_attn_bwd<float, float, false>(static_cast<const float*>(qkv), static_cast<const float*>(g),
                                                static_cast<float*>(dqkv), nullptr, lse, delta, B, n_heads, T, W,
                                                valid, causal != 0, s);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return launch_attn_bwd<bf, bf, false>(static_cast<const bf*>(qkv), static_cast<const bf*>(g),
                                          static_cast<bf*>(dqkv), nullptr, lse, delta, B, n_heads, T, W, valid,
                                          causal != 0, s);
  }
  return cudaErrorInvalidValue;
}
