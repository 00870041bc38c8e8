// S2: the A/B variants of the fused MLP half-block as configurations of its
// FMA-walk kernel (fused_mlp.cuh, mlp_walk.cuh; K1, fused_mlp.cu, ran on it
// before it moved to the tensor cores): rows per block
// 16 or 8, erff or the 3-term erf, two-pass or one-pass LayerNorm, the
// hidden chunks walked plainly or software-pipelined.
//
// Replaces scripts/mlp_kernel_ab.py::make_kernel.kernel (erf3, ln1pass,
// ilv_chunks, and run_variant's row_tile).  The wrapper is
// tapclip_tpu_torch/ops/fused_mlp.py::fused_mlp_variant.
//
// What bounds it on the card: latency inside each SM (every block
// reads all of w_fc and w_proj from L2, one scalar load a thread a reduction
// step, one 8-warp block per SM at the image shape).  The variants ask which
// lever moves it: more blocks per SM (8 rows), fewer exposed weight loads
// (the pipelined walk), cheaper GELU (erf3) or LayerNorm (one pass).
#include "common.cuh"
#include "fused_mlp.cuh"

using namespace tapclip;

// As tapclip_fused_mlp, with rows 16 or 8 and the erf3, ln1pass and ilv
// switches (0 or 1).  rows 16 with every switch 0 is the flags-off
// configuration, the parent of the A/B driver on the card.
extern "C" int tapclip_fused_mlp_variant(const void* x, const void* gamma, const void* beta,
                                         const void* w_fc, const void* b_fc, const void* w_proj,
                                         const void* b_proj, void* out, int R, int W, int H, float eps,
                                         int rows, int erf3, int ln1pass, int ilv, int dtype, void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || W % 4 || H % 4 || (rows != 16 && rows != 8)) return cudaErrorInvalidValue;
  const MlpCall c{x, static_cast<const float*>(gamma), static_cast<const float*>(beta), w_fc,
                  static_cast<const float*>(b_fc), w_proj, static_cast<const float*>(b_proj), out,
                  R, W, H, eps, ln1pass != 0, static_cast<cudaStream_t>(stream)};
#define TAPCLIP_MLP_VARIANT(T)                                                       \
  switch ((rows == 8 ? 4 : 0) | (erf3 ? 2 : 0) | (ilv ? 1 : 0)) {                     \
    case 0: return launch_mlp<T, 16, false, false>(c);                                \
    case 1: return launch_mlp<T, 16, false, true>(c);                                 \
    case 2: return launch_mlp<T, 16, true, false>(c);                                 \
    case 3: return launch_mlp<T, 16, true, true>(c);                                  \
    case 4: return launch_mlp<T, 8, false, false>(c);                                 \
    default: return cudaErrorInvalidValue;                                            \
  }
  if (dtype == 0) TAPCLIP_MLP_VARIANT(float)
  if (dtype == 1) TAPCLIP_MLP_VARIANT(__nv_bfloat16)
#undef TAPCLIP_MLP_VARIANT
  return cudaErrorInvalidValue;
}
