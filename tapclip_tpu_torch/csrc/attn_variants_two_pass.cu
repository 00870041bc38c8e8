// S3: the walks of the attention half-block's A/B variants whose softmax
// takes two passes over the keys (attn_variants.cuh): the normalised form
// (exp, p / l before p is rounded and multiplied by v; the first pass carries
// m and l, the second recomputes q . k^T) and the "bf16" form (p =
// bf16(exp2(bf16(s - m))) against the row's final max; the first pass finds
// m), on K2's workspace with q and k in three terms or (qk_round in bf16)
// one, and the normalised form of perhead_qkv.
//
// Replaces scripts/attn_kernel_ab.py::make_variant_kernel.kernel with
// softmax_opt False or "bf16", with and without perhead_qkv, ln_1pass and
// group_heads, and the attention of
// scripts/attn_kernel_ab.py::make_interleaved_kernel.kernel (its
// out-projection partials are the launcher's split of the out-projection's
// depth, attn_variants.cu).  The launcher is attn_variants.cu's
// tapclip_attn_variant, the wrapper
// tapclip_tpu_torch/ops/fused_mha.py::attn_block_variant.
//
// What bounds it on the card: as K2, the products; the second pass adds the
// score products again (K2's attention is 1.0 of the 8.5 GFLOP at ViT-B/16
// batch 8, its q . k^T half of that).
#include "attn_variants.cuh"

namespace tapclip {
namespace attnv {

template <typename PT, int FORM>
cudaError_t two_pass(const WalkCall& c) {
  if (c.resident) {
    if constexpr (FORM == kNormalized) return launch_perhead<PT, kNormalized>(c);
    return cudaErrorInvalidValue;  // perhead_qkv takes the online and normalised forms
  }
  if constexpr (!kIsF32<PT> && FORM == kBf16Exp) {  // S3's "bf16" softmax rounds q and k in bf16
    return c.qk1 ? launch_walk<PT, FORM, 1, false>(c) : cudaErrorInvalidValue;
  } else {
    if constexpr (!kIsF32<PT>) {
      if (c.qk1) return launch_walk<PT, FORM, 1, false>(c);
    }
    return launch_walk<PT, FORM, kF32Terms, false>(c);
  }
}

template <typename PT>
cudaError_t two_pass_dtype(const WalkCall& c) {
  if (c.tail_split || c.k2) return cudaErrorInvalidValue;
  if (c.form == kNormalized) return two_pass<PT, kNormalized>(c);
  if (c.form == kBf16Exp) return two_pass<PT, kBf16Exp>(c);
  return cudaErrorInvalidValue;
}

cudaError_t launch_two_pass_walk(const WalkCall& c) {
  if (c.dtype == 0) return two_pass_dtype<float>(c);
  if (c.dtype == 1) return two_pass_dtype<bf16>(c);
  return cudaErrorInvalidValue;
}

}  // namespace attnv
}  // namespace tapclip
