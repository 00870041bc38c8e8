// B6: the packed-QKV attention core,
//   out[b, t, h] = softmax_masked(q k^T / sqrt(Dh)) v   for every head h,
// with q, k, v the three W-wide column blocks of qkv [B, T, 3W] (bias already
// added) and out [B, T, W], both in the compute dtype.
//
// Replaces tapclip_tpu/ops/fused_mha.py::_mha_kernel (the pallas_call in
// _fused_mha_fwd_impl).  The wrapper is
// tapclip_tpu_torch/ops/fused_mha.py::fused_mha, whose backward is B7
// (mha_bwd.cu).  The CLIP text tower runs it in every causal block
// (attn_impl "auto" / "fused"), and attn_impl "fused_split" in every block.
//
// The TPU kernel holds a batch block's whole [Tp, 3W] rows and a [Tp, Tp]
// score tile in VMEM and loops over 128-lane head groups.  Here it is K2's
// attention walk on the tensor cores (attn_core_mma.cuh) with In = the dtype:
// one block of ROWS / 16 warps per (batch row, head, query tile of 16, 32 or
// 64 rows by T), 64-key tiles double-buffered by cp.async straight out of the
// packed rows (row stride 3W, column offset h Dh), an online softmax in the
// log2 domain, o written straight into [B, T, W]: no head-split copies, any
// T.  Causal, the walk stops at the key tile holding the query tile's last
// row.
//
// Numerics as the TPU kernel: scores q . k^T in f32 scaled by
// scale * log2 e and exp2'd, keys at or past `valid` and (causal) keys after
// the query at -1e30, l summed over the unrounded p, p rounded to v's dtype
// before p . v, normalisation deferred (o / l).  In f32 q, k, p and v take
// three bf16 terms each (six MMAs a product); in bf16 q, k and v are bf16
// values and p is rounded to bf16, one exact MMA a product.  The MMAs sum in
// another order than the TPU kernel.  No atomics: a call repeats bit for bit.
//
// What bounds it on the card: at the idiomatic step's shape (8 classes x 8
// heads, T 77, Dh 64, causal) a call moves 5.0 MB in f32 (qkv in, o out),
// 0.0015 ms at 3.35 TB/s, and does 49 MFLOP: launch latency and the serial
// walk of one block lead.  The FMA core this design replaced (one block of
// 256 threads per (batch row, head, 64-row query tile), products on the FMA
// units) took 0.038 ms there (H100 80GB HBM3, 700 W; PERF.md).
#include <stdint.h>

#include "attn_core_mma.cuh"
#include "common.cuh"

namespace {

template <typename T>
int launch(const void* qkv, void* out, int B, int T_, int W, int H, int valid, bool causal, cudaStream_t s) {
  using tapclip::attn::launch_attn_core;
  const auto* x = static_cast<const T*>(qkv);
  auto* y = static_cast<T*>(out);
  return causal ? launch_attn_core<T, T, T, true>(x, y, nullptr, B, H, T_, W, valid, s)
                : launch_attn_core<T, T, T, false>(x, y, nullptr, B, H, T_, W, valid, s);
}

}  // namespace

// qkv [B, T, 3W] and out [B, T, W] in the compute dtype (0 float32, 1
// bfloat16), 16-byte aligned.  Head dim W / n_heads in {16, 32, 64, 128};
// 1 <= valid <= T; causal 0 or 1.
extern "C" int tapclip_mha(const void* qkv, void* out, int B, int T, int W, int n_heads, int valid, int causal,
                           int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || valid < 1 || valid > T) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) & 15) return cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(qkv, out, B, T, W, n_heads, valid, causal != 0, s);
  if (dtype == 1) return launch<__nv_bfloat16>(qkv, out, B, T, W, n_heads, valid, causal != 0, s);
  return cudaErrorInvalidValue;
}
