// Launch glue of the attention half-block's A/B variants (S3, S4), shared by
// attn_variants_online.cu and attn_variants_two_pass.cu: one launch of K2's
// earlier FMA core (attn_core.cuh) in a given configuration, head dim 64
// (ViT-B/16 and ViT-L/14), with the runtime switches.  The out-projection
// follows in a second launch: K2's own on the tensor cores,
// tapclip_gemm_bias_residual (attn_block.cu), or for the interleaved form
// tapclip_attn_partials_reduce.
#pragma once

#include "attn_core.cuh"
#include "common.cuh"

namespace tapclip {

constexpr int kVariantDh = 64;

// The arguments of every variant launcher (see the extern "C" functions).
struct VariantCall {
  const void *x, *gamma, *beta, *w_qkv, *b_qkv, *w_out;
  void *ws, *attn, *part;
  int B, T, W, n_heads, valid;
  float eps;
  CoreSwitches sw;
  cudaStream_t stream;
};

template <typename T, typename Cfg>
cudaError_t launch_variant(const VariantCall& c) {
  if (c.W != c.n_heads * kVariantDh || c.sw.group < 1 || c.n_heads % c.sw.group) return cudaErrorInvalidValue;
  const size_t smem = CoreSmem<kVariantDh, Cfg>::bytes(c.T);
  auto kernel = attn_core_kernel<T, kVariantDh, Cfg>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const CoreArgs<T> a{static_cast<const T*>(c.x), static_cast<const float*>(c.gamma),
                      static_cast<const float*>(c.beta), static_cast<const T*>(c.w_qkv),
                      static_cast<const float*>(c.b_qkv), static_cast<float*>(c.ws), c.attn,
                      static_cast<const T*>(c.w_out), static_cast<float*>(c.part),
                      c.B, c.n_heads, c.T, c.W, c.valid, c.eps};
  launch_attn_core<T, kVariantDh, Cfg>(a, c.sw, c.B * (c.n_heads / c.sw.group), smem, c.stream);
  return cudaGetLastError();
}

template <typename Cfg>
cudaError_t launch_variant_dtype(const VariantCall& c, int dtype) {
  if (dtype == 0) return launch_variant<float, Cfg>(c);
  if (dtype == 1) return launch_variant<__nv_bfloat16, Cfg>(c);
  return cudaErrorInvalidValue;
}

inline bool variant_args_ok(int B, int T, int W, int n_heads, int valid) {
  return B > 0 && T > 0 && n_heads > 0 && W == n_heads * kVariantDh && valid >= 1 && valid <= T;
}

}  // namespace tapclip

// The arguments of the two extern "C" variant launchers, gathered.  form: 0
// online (K2's softmax), 1 normalised (exp, p / l before p.v), 2 bf16 exp2.
// sum_rounded, tail_split, smem_qkv, interleaved: the compile-time switches
// of attn_core.cuh; ln1pass, qk_round, fold_q, mask (0 full, 1 tail,
// 2 zerokv), group: the runtime ones.
inline tapclip::VariantCall variant_call(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                         const void* b_qkv, const void* w_out, void* ws, void* attn, void* part,
                                         int B, int T, int W, int n_heads, int valid, float eps, int ln1pass,
                                         int qk_round, int fold_q, int mask, int group, void* stream) {
  return tapclip::VariantCall{x, gamma, beta, w_qkv, b_qkv, w_out, ws, attn, part, B, T, W, n_heads, valid, eps,
                              tapclip::CoreSwitches{ln1pass, qk_round, fold_q, mask, group},
                              static_cast<cudaStream_t>(stream)};
}
