// S3: the A/B variants of the attention half-block whose softmax takes two
// passes over the keys, as configurations of K2's earlier FMA core (attn_core.cuh), and
// the reduction of the interleaved form's per-group partials.
//
// Replaces scripts/attn_kernel_ab.py::make_variant_kernel.kernel with
// softmax_opt False (exp, p / l before rounding: the row sum is unknown until
// the last 64-key tile, so a first pass carries m and l) or "bf16" (p =
// bf16(exp2(bf16(s - m))) against the row's final max), with and without
// perhead_qkv, ln_1pass and group_heads; and
// scripts/attn_kernel_ab.py::make_interleaved_kernel.kernel (per head group:
// attention, its rows of the out-projection into an f32 partial; here the
// partials [groups, B, T, W] are summed in group order by a second launch,
// so the result repeats bit for bit).  The wrapper is
// tapclip_tpu_torch/ops/fused_mha.py::attn_block_variant.
//
// What bounds it on the card: as K2's earlier FMA core, the serial work of one
// block's pass over its head; the second pass over the keys adds the score
// products again (about a third more work in the core).  The interleaved
// form's partials are groups x B x T x W f32 (59 MB at ViT-B/16 batch 8,
// one head a group), written once and read once: bytes, not operations,
// bound its reduction.
#include "attn_variants.cuh"

namespace {

using namespace tapclip;

// out = (sum over g of part[g]) + b_out + x, the groups summed in order.
template <typename T>
__global__ void __launch_bounds__(256)
partials_reduce_kernel(const float* __restrict__ part, int groups, const float* __restrict__ b_out,
                       const T* __restrict__ x, T* __restrict__ out, int R, int W) {
  const size_t n = static_cast<size_t>(R) * W;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = part[e];
    for (int g = 1; g < groups; ++g) acc += part[static_cast<size_t>(g) * n + e];
    out[e] = from_f<T>((acc + b_out[e % W]) + to_f(x[e]));
  }
}

}  // namespace

// Arguments: variant_call (attn_variants.cuh) and form, sum_rounded, tail_split,
// smem_qkv, interleaved, dtype (0 float32, 1 bfloat16).
extern "C" int tapclip_attn_variant_two_pass(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                            const void* b_qkv, const void* w_out, void* ws, void* attn, void* part,
                                            int B, int T, int W, int n_heads, int valid, float eps, int form,
                                            int sum_rounded, int tail_split, int smem_qkv, int interleaved,
                                            int ln1pass, int qk_round, int fold_q, int mask, int group, int dtype,
                                            void* stream) {
  if (!variant_args_ok(B, T, W, n_heads, valid) || sum_rounded || tail_split) return cudaErrorInvalidValue;
  const VariantCall c = variant_call(x, gamma, beta, w_qkv, b_qkv, w_out, ws, attn, part, B, T, W, n_heads, valid, eps,
                                       ln1pass, qk_round, fold_q, mask, group, stream);
  if (form == kNormalized && interleaved)
    return smem_qkv ? cudaErrorInvalidValue
                    : launch_variant_dtype<CoreCfg<kNormalized, false, false, false, true, false, true>>(c, dtype);
  if (interleaved) return cudaErrorInvalidValue;
  if (form == kNormalized && smem_qkv)
    return launch_variant_dtype<CoreCfg<kNormalized, false, false, true, false, false, true>>(c, dtype);
  if (form == kNormalized) return launch_variant_dtype<CoreCfg<kNormalized, false, false, false, false, false, true>>(c, dtype);
  if (form == kBf16Exp && !smem_qkv)
    return launch_variant_dtype<CoreCfg<kBf16Exp, false, false, false, false, false, true>>(c, dtype);
  return cudaErrorInvalidValue;
}

// The interleaved form's second launch: out [R, W] = sum_g part[g] + b_out + x.
extern "C" int tapclip_attn_partials_reduce(const void* part, int groups, const void* b_out, const void* x,
                                            void* out, int R, int W, int dtype, void* stream) {
  if (R <= 0 || W <= 0 || groups <= 0) return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(R) * W;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(part);
  const auto* bo = static_cast<const float*>(b_out);
  if (dtype == 0) {
    partials_reduce_kernel<float><<<blocks, 256, 0, s>>>(p, groups, bo, static_cast<const float*>(x),
                                                         static_cast<float*>(out), R, W);
  } else if (dtype == 1) {
    using bf = __nv_bfloat16;
    partials_reduce_kernel<bf><<<blocks, 256, 0, s>>>(p, groups, bo, static_cast<const bf*>(x),
                                                      static_cast<bf*>(out), R, W);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
