// B13: int8 W8A8 MLP half-block of the frozen-tower eval path,
//   out = x + dequant(int8(gelu(dequant(int8(LN(x)) . Wfc_q) + b_fc)) . Wproj_q) + b_proj,
// with per-row activation codes (stochastic or round-to-nearest) and exact
// int32 sums, on the int8 tensor cores.  Also S5: the erf3 / recipmul
// variants of scripts/int8_mlp_ab.py, as B13's own launches with the switches
// applied (tapclip_int8_mlp_variant).
//
// Replaces tapclip_tpu/ops/int8_mlp.py::_int8_mlp_kernel (the pallas_call in
// int8_mlp_block) and the round-to-nearest model _xla_int8_reference, which
// the JAX package runs under int8_deterministic: the wrapper
// (tapclip_tpu_torch/ops/int8_mlp.py::int8_mlp_cuda) launches it in both
// modes.  S5 replaces scripts/int8_mlp_ab.py's make_kernel.kernel in its
// three variants (ops/int8_mlp.py::int8_mlp_variant).  Quantization scheme
// and random bits: int8_common.cuh.
//
// What bounds it on the card: the products, 4 R W H int8 operations, at
// ViT-B/16 serving (R = 8 x 200 rows, W 768, H 3,072) 15.1 G, 0.0076 ms at
// the tensor cores' 1,979 TOP/s; the bytes (x in and out in f32, 4.7 MB of
// int8 weights) 0.004 ms.  Traces on an H100 80GB HBM3 at 700 W
// (profile_kernels.py), f32 stochastic at that shape: 0.105 ms, the
// LayerNorm rows 11 us, fc 40 (312 tiles of 128 x 128 over 264
// block slots, the GELU epilogue storing 19.7 MB of h), the hidden codes 10,
// proj 36 (150 tiles of 64 x 128, 48 stages deep), plus 8 for the wrapper's
// two weight transposes; launches alone 0.100 ms (time_half_blocks.py).
//
// Design: four launches behind one wrapper call, which lays the weights out
// K-major ([N, Kp], Kp = K rounded up to 64, zeros past K; S6's transpose
// kernel, int8_gemm.cu) where it quantizes them, and allocates the scratch:
// hidden rows h [R, H] f32, codes yq [R, Kp(W)] and hq [R, Kp(H)] int8,
// scales [3, R] f32 (t1, t2, amax of h).  The kernels are int8_tiles.cuh's,
// shared with B14:
//   1. ln_quant_kernel, one warp a row: LayerNorm into shared memory
//      (ln_row_warp), the row's codes and scale t1; zeroes the row's |h| max.
//   2. dequant_kernel<kGeluMax>: yq . Wfc^T on int8_mma.cuh's block tile
//      (mma.sync m16n8k32 s8, 128 x 128 tiles or 64 x 128), its epilogue
//      dequantizing (acc t1) s_fc + b_fc and applying exact GELU (erff),
//      storing h (19.7 MB at the image shape, in L2), and folding the tile's
//      |h| into the row's max: a max over the quad's lanes, then atomicMax
//      on the non-negative f32 bits, which no order of the blocks changes.
//   3. quant_rows_kernel, one block a row: the codes of h and its scale t2
//      from that max (code_of: the draws of (seed, quantizer, row, column),
//      so no tiling moves a draw).
//   4. proj_kernel: hq . Wproj^T on the same tile, its epilogue
//      dequantizing, adding b_proj and the residual with one rounding.
// S5's switches change one device function each, in the same place of the
// same launches: erf3 the fc epilogue's erf (dequant_kernel<kGeluErf3Max>),
// recipmul both row passes' scale and codes (RECIP: v * (127 / amax) in
// place of v / (amax / 127)).  On that card erf3 adds 12 us to the launches
// (an IEEE divide and an expf a value where erff is one polynomial) and
// recipmul takes 4 off (int8_mlp_ab.py).  Every float step is written with the
// round-to-nearest intrinsics and the int32 sums and the row maxima are
// exact, so a variant's output is fixed by its switches, whatever the
// tiling: it equals the earlier __dp4a walk's bit for bit (chip_smoke.py's
// B13_BITS and S5_BITS, digests read from the walk).
#include <stdint.h>

#include "int8_common.cuh"
#include "int8_tiles.cuh"

namespace {

using namespace tapclip;
using namespace tapclip::int8k;

// One call's operands (tapclip_int8_mlp's), cast once.
struct MlpCall {
  const float *gamma, *beta, *s_fc, *b_fc, *s_proj, *b_proj;
  const int8_t *w_fc, *w_proj;
  float *h, *scales;
  int8_t *yq, *hq;
  int R, W, H;
  float eps;
  uint32_t seed;
};

// The four launches.  SR: stochastic codes (else round to nearest); ERF3,
// RECIP: S5's switches.
template <typename T, bool SR, bool ERF3 = false, bool RECIP = false>
cudaError_t launch_mma(const MlpCall& c, const T* x, T* out, cudaStream_t s) {
  const int Wp = mma8::kp(c.W), Hp = mma8::kp(c.H);
  float* t1 = c.scales;
  float* t2 = c.scales + c.R;
  float* hmax = c.scales + 2 * c.R;
  cudaError_t err = launch_ln_quant<T, SR, RECIP>(x, c.gamma, c.beta, c.yq, t1, hmax, c.R, c.W, Wp, c.eps, c.seed,
                                                  kStreamMlpY, s);
  if (err != cudaSuccess) return err;
  err = launch_dequant<ERF3 ? kGeluErf3Max : kGeluMax, float>(c.yq, c.w_fc, t1, c.s_fc, c.b_fc, c.h, hmax, c.R,
                                                              c.H, Wp, c.H, s);
  if (err != cudaSuccess) return err;
  err = launch_quant_rows<SR, RECIP>(c.h, hmax, c.hq, t2, c.R, c.H, Hp, c.seed, kStreamMlpH, s);
  if (err != cudaSuccess) return err;
  return launch_proj<T>(c.hq, c.w_proj, t2, c.s_proj, c.b_proj, x, out, c.R, c.W, Hp, s);
}

// variant (stochastic only): bit 0 erf3, bit 1 recipmul; 0 is B13.
template <typename T>
cudaError_t launch_mode(int deterministic, int variant, const MlpCall& c, const void* x, void* out,
                        cudaStream_t s) {
  const auto* X = static_cast<const T*>(x);
  auto* O = static_cast<T*>(out);
  if (deterministic) return launch_mma<T, false>(c, X, O, s);
  switch (variant) {
    case 0: return launch_mma<T, true>(c, X, O, s);
    case 1: return launch_mma<T, true, true, false>(c, X, O, s);
    case 2: return launch_mma<T, true, false, true>(c, X, O, s);
    case 3: return launch_mma<T, true, true, true>(c, X, O, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* x, const void* gamma, const void* beta, const void* w_fc, const void* s_fc, const void* b_fc,
        const void* w_proj, const void* s_proj, const void* b_proj, void* out, void* h, void* yq, void* hq,
        void* scales, int R, int W, int H, float eps, unsigned int seed, int deterministic, int variant, int dtype,
        void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || variant < 0 || variant > 3 || (deterministic && variant))
    return cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(w_fc) | reinterpret_cast<uintptr_t>(w_proj) |
                         reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(yq) |
                         reinterpret_cast<uintptr_t>(hq) | reinterpret_cast<uintptr_t>(scales);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  const MlpCall c{static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<const float*>(s_fc),
                  static_cast<const float*>(b_fc), static_cast<const float*>(s_proj), static_cast<const float*>(b_proj),
                  static_cast<const int8_t*>(w_fc), static_cast<const int8_t*>(w_proj), static_cast<float*>(h),
                  static_cast<float*>(scales), static_cast<int8_t*>(yq), static_cast<int8_t*>(hq),
                  R, W, H, eps, seed};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_mode<float>(deterministic, variant, c, x, out, s);
  if (dtype == 1) return launch_mode<__nv_bfloat16>(deterministic, variant, c, x, out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// B13.  x, out [R, W] in the compute dtype (0 float32, 1 bfloat16); gamma,
// beta [W], s_fc, b_fc [H], s_proj, b_proj [W] f32; w_fc [H, kp(W)] and
// w_proj [W, kp(H)] int8, K-major with zeros past W and H (kp(K) =
// tapclip_int8_gemm_kp(K)); scratch h [R, H] f32, yq [R, kp(W)] and hq
// [R, kp(H)] int8, scales [3, R] f32, all 16-byte aligned.  deterministic 1:
// round to nearest; 0: stochastic with the draws of `seed`.
extern "C" int tapclip_int8_mlp(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                const void* s_fc, const void* b_fc, const void* w_proj, const void* s_proj,
                                const void* b_proj, void* out, void* h, void* yq, void* hq, void* scales, int R,
                                int W, int H, float eps, unsigned int seed, int deterministic, int dtype,
                                void* stream) {
  return run(x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, h, yq, hq, scales, R, W, H, eps, seed,
             deterministic, 0, dtype, stream);
}

// S5: B13's launches with the variant's switches.  The arguments of
// tapclip_int8_mlp, then variant: bit 0 erf3 (the fc epilogue's 3-term erf),
// bit 1 recipmul (both row passes quantize by v * (127 / amax)); 0 is B13
// itself.  The switches are stochastic-mode kernels: deterministic with a
// switch returns cudaErrorInvalidValue.
extern "C" int tapclip_int8_mlp_variant(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                        const void* s_fc, const void* b_fc, const void* w_proj, const void* s_proj,
                                        const void* b_proj, void* out, void* h, void* yq, void* hq, void* scales,
                                        int R, int W, int H, float eps, unsigned int seed, int deterministic,
                                        int variant, int dtype, void* stream) {
  return run(x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, h, yq, hq, scales, R, W, H, eps, seed,
             deterministic, variant, dtype, stream);
}
