// S3 and S4: the A/B variants of the attention half-block whose softmax is
// the online form, as configurations of K2's earlier FMA core (attn_core.cuh).
//
// Replaces scripts/attn_softmax_ab.py::make_kernel.kernel (S4: qk_cast,
// fold_q, mask_mode full / tail / zerokv, sum_mxu, tail_split, swpipe,
// group_heads) and the online forms of
// scripts/attn_kernel_ab.py::make_variant_kernel.kernel (S3 softmax_opt=True
// with and without perhead_qkv).  The two-pass forms are in
// attn_variants_two_pass.cu.  The wrapper is
// tapclip_tpu_torch/ops/fused_mha.py::attn_block_variant.
//
// What bounds it on the card: as K2's earlier FMA core, the serial work of one
// block's pass over its head, one block per SM at the image shape, the
// products on the FMA units in f32; the variants move that work around
// (fewer blocks with group_heads, q, k, v kept in shared memory with
// perhead_qkv) but none changes its kind.  swpipe, bB and vmem_mb have no
// counterpart on this card (one block per (batch row, head) already overlaps
// with the others through the SM's warp scheduler): those variants run their
// parent's configuration and the driver names it.
#include "attn_variants.cuh"

using namespace tapclip;

// Arguments: variant_call (attn_variants.cuh) and form, sum_rounded, tail_split,
// smem_qkv, interleaved, dtype (0 float32, 1 bfloat16).
extern "C" int tapclip_attn_variant_online(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                            const void* b_qkv, const void* w_out, void* ws, void* attn, void* part,
                                            int B, int T, int W, int n_heads, int valid, float eps, int form,
                                            int sum_rounded, int tail_split, int smem_qkv, int interleaved,
                                            int ln1pass, int qk_round, int fold_q, int mask, int group, int dtype,
                                            void* stream) {
  if (!variant_args_ok(B, T, W, n_heads, valid) || form != kOnline || interleaved)
    return cudaErrorInvalidValue;
  const VariantCall c = variant_call(x, gamma, beta, w_qkv, b_qkv, w_out, ws, attn, part, B, T, W, n_heads, valid, eps,
                                       ln1pass, qk_round, fold_q, mask, group, stream);
  if (smem_qkv)
    return sum_rounded || tail_split ? cudaErrorInvalidValue
                                     : launch_variant_dtype<CoreCfg<kOnline, false, false, true, false, true>>(c, dtype);
  if (sum_rounded && tail_split) return cudaErrorInvalidValue;
  if (sum_rounded) return launch_variant_dtype<CoreCfg<kOnline, true, false, false, false, true>>(c, dtype);
  if (tail_split) return launch_variant_dtype<CoreCfg<kOnline, false, true, false, false, true>>(c, dtype);
  return launch_variant_dtype<CoreCfg<kOnline, false, false, false, false, true>>(c, dtype);
}

// Bytes of shared memory the core takes at T (head dim 64) with q, k, v kept
// in shared memory (smem_qkv) or in the workspace, interleaved or not.
extern "C" int tapclip_attn_variant_smem_bytes(int T, int smem_qkv, int interleaved) {
  if (smem_qkv) return static_cast<int>(CoreSmem<kVariantDh, CoreCfg<kOnline, false, false, true>>::bytes(T));
  if (interleaved)
    return static_cast<int>(CoreSmem<kVariantDh, CoreCfg<kNormalized, false, false, false, true>>::bytes(T));
  return static_cast<int>(CoreSmem<kVariantDh, CoreCfg<>>::bytes(T));
}
