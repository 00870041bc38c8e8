// S3 and S4: the walks of the attention half-block's A/B variants whose
// softmax is the online form (attn_variants.cuh): K2's tile function over a
// head group (group_heads alone, and the switches that change no value in the
// dtype), K2's walk with qk_cast / fold_q / zerokv / sum_mxu / tail_split,
// and perhead_qkv with S3's softmax_opt=True.
//
// Replaces scripts/attn_softmax_ab.py::make_kernel.kernel (S4: qk_cast,
// fold_q, mask_mode full / tail / zerokv, sum_mxu, tail_split, swpipe,
// group_heads) and the online forms of
// scripts/attn_kernel_ab.py::make_variant_kernel.kernel (S3 softmax_opt=True
// with and without perhead_qkv).  The launcher is attn_variants.cu's
// tapclip_attn_variant, the wrapper
// tapclip_tpu_torch/ops/fused_mha.py::attn_block_variant.
//
// What bounds it on the card: as K2, the products (7.5 GFLOP of projections
// and 1.0 of attention at ViT-B/16 batch 8: 0.052 ms as six bf16 MMAs a
// product in f32, 0.011 ms in bf16).  The switches change the walk's
// arithmetic, not its kind: one MMA a q . k^T product in bf16 with qk_cast
// (three terms of f32 q and k otherwise), the pad keys walked with zerokv,
// a second set of accumulators with tail_split, the heads of a group one
// after the other in one block.  swpipe and bB have no counterpart on this
// card (K2's double-buffered key tiles and its grid over the batch already
// are what they schedule): the driver names the variant they equal.
#include "attn_variants.cuh"

namespace tapclip {
namespace attnv {

template <typename PT, int QK>
cudaError_t online_walk(const WalkCall& c) {
  return c.tail_split ? launch_walk<PT, kOnline, QK, true>(c) : launch_walk<PT, kOnline, QK, false>(c);
}

template <typename PT>
cudaError_t online(const WalkCall& c) {
  if (c.k2) return launch_k2_group<PT>(c);
  if (c.resident) return launch_perhead<PT, kOnline>(c);
  if constexpr (!kIsF32<PT>) {
    if (c.qk1) return online_walk<PT, 1>(c);
  }
  return online_walk<PT, kF32Terms>(c);
}

cudaError_t launch_online_walk(const WalkCall& c) {
  if (c.dtype == 0) return online<float>(c);
  if (c.dtype == 1) return online<bf16>(c);
  return cudaErrorInvalidValue;
}

}  // namespace attnv
}  // namespace tapclip
