// B13: int8 W8A8 MLP half-block of the frozen-tower eval path,
//   out = x + dequant(int8(gelu(dequant(int8(LN(x)) . Wfc_q) + b_fc)) . Wproj_q) + b_proj,
// with per-row activation codes (stochastic or round-to-nearest) and exact
// int32 sums.  Also S5: the erf3 / recipmul variants of
// scripts/int8_mlp_ab.py, as template flags of the same kernel.
//
// Replaces tapclip_tpu/ops/int8_mlp.py::_int8_mlp_kernel (the pallas_call in
// int8_mlp_block) and the round-to-nearest model _xla_int8_reference, which
// the JAX package runs under int8_deterministic: the wrapper
// (tapclip_tpu_torch/ops/int8_mlp.py::int8_mlp_block) launches this kernel in
// both modes.  Quantization scheme and random bits: int8_common.cuh.
//
// Design.  The second quantizer needs max |h| over the whole hidden row
// (H = 3,072 at ViT-B/16, 4,096 at ViT-L/14) before any element of it is
// quantized, so the FMA walk over 256-column chunks (mlp_walk.cuh) cannot carry
// over.  A block owns 8 rows and keeps their hidden rows in shared memory as
// f32 (8 x 3,072 x 4 B = 96 KB; 128 KB at ViT-L/14):
//   1. one warp a row: LayerNorm into shared memory (the hidden buffer, not
//      yet in use), its row amax and the int8 codes;
//   2. every thread owns hidden columns t, t + 256 and walks the reduction
//      over packed int8 weights with __dp4a (rows_dot_packed); dequantize,
//      add b_fc, exact GELU (erff) into the hidden rows;
//   3. one warp a row: amax of the hidden row and its int8 codes;
//   4. the proj product the same way; dequantize, b_proj, the residual.
// The hidden activation never reaches device memory.  One launch a call.
//
// What bounds it on the card: by its shape, neither bytes nor operations.
// At ViT-B/16 serving (R = 8 x 200 rows, W 768, H 3,072) it does 4 R W H =
// 15.1 G int8 operations (0.008 ms at the tensor cores' 1,979 TOP/s) on
// about 5 MB of int8 weights and x; __dp4a runs on the integer units, not the
// tensor cores, and every block reads both weight matrices (4.7 MB) from L2.
// Tensor-core int8 MMA (mma.sync m16n8k32, then wgmma) is later work.
// Rows past R (the ragged last block) are computed on zeros and not stored.
#include "int8_common.cuh"

namespace {

using namespace tapclip;

// Exact GELU in the plain version's order: (0.5 v) (1 + erf(v / sqrt 2)).
template <bool ERF3>
__device__ __forceinline__ float gelu(float v) {
  const float z = __fmul_rn(v, 0.70710678118654752f);
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.f, ERF3 ? erf3(z) : erff(z)));
}

struct MlpSmem {
  int hld, wp, hp;
  __host__ __device__ MlpSmem(int W, int H) : hld(((H > W ? H : W) + 3) / 4 * 4), wp(pad16(W)), hp(pad16(H)) {}
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(kInt8Rows) * (hld * sizeof(float) + wp + hp) + 2 * kInt8Rows * sizeof(float);
  }
};

template <typename T, bool SR, bool ERF3, bool RECIP>
__global__ void __launch_bounds__(kInt8Threads)
int8_mlp_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                const int* __restrict__ w_fc, const float* __restrict__ s_fc, const float* __restrict__ b_fc,
                const int* __restrict__ w_proj, const float* __restrict__ s_proj,
                const float* __restrict__ b_proj, T* __restrict__ out, int R, int W, int H, float eps,
                uint32_t seed) {
  constexpr int RB = kInt8Rows;
  extern __shared__ __align__(16) unsigned char smem[];
  const MlpSmem lay(W, H);
  float* h_s = reinterpret_cast<float*>(smem);            // [RB][hld]: LN(x), then the hidden rows
  int8_t* yq_s = reinterpret_cast<int8_t*>(h_s + RB * lay.hld);  // [RB][wp] codes of LN(x)
  int8_t* hq_s = yq_s + RB * lay.wp;                      // [RB][hp] codes of the hidden rows
  float* t_s = reinterpret_cast<float*>(hq_s + RB * lay.hp);  // [2][RB] row scales
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * RB;

  // 1. LayerNorm and the first quantizer, one warp a row.
  for (int r = warp; r < RB; r += kInt8Warps) {
    const int row = row0 + r;
    float* yr = h_s + r * lay.hld;
    if (row < R) {
      ln_row_warp<T, !SR>(x + static_cast<size_t>(row) * W, gamma, beta, W, eps, yr, lane);
    } else {
      for (int c = lane; c < W; c += 32) yr[c] = 0.f;
    }
    __syncwarp();
    const float s = quantize_row_warp<SR, RECIP>(yr, W, lay.wp, yq_s + r * lay.wp,
                                                 row_key(seed, kStreamMlpY, row), lane);
    if (lane == 0) t_s[r] = s;
  }
  __syncthreads();

  // 2. The fc product, dequantized, + b_fc, GELU, into the hidden rows.
  rows_dot_packed<RB, 2>(reinterpret_cast<const int*>(yq_s), lay.wp / 4, w_fc, H,
                         [&](int r, int j, int acc) {
                           h_s[r * lay.hld + j] = gelu<ERF3>(dequant(acc, t_s[r], s_fc[j], b_fc[j]));
                         });
  __syncthreads();

  // 3. The second quantizer over each whole hidden row.
  for (int r = warp; r < RB; r += kInt8Warps) {
    const float s = quantize_row_warp<SR, RECIP>(h_s + r * lay.hld, H, lay.hp, hq_s + r * lay.hp,
                                                 row_key(seed, kStreamMlpH, row0 + r), lane);
    if (lane == 0) t_s[RB + r] = s;
  }
  __syncthreads();

  // 4. The proj product, dequantized, + b_proj, + the residual.
  rows_dot_packed<RB, 2>(reinterpret_cast<const int*>(hq_s), lay.hp / 4, w_proj, W,
                         [&](int r, int c, int acc) {
                           const int row = row0 + r;
                           if (row >= R) return;
                           const size_t off = static_cast<size_t>(row) * W + c;
                           out[off] = from_f<T>(__fadd_rn(dequant(acc, t_s[RB + r], s_proj[c], b_proj[c]),
                                                          to_f(x[off])));
                         });
}

template <typename T, bool SR, bool ERF3, bool RECIP>
cudaError_t launch(const void* x, const float* gamma, const float* beta, const int* w_fc,
                   const float* s_fc, const float* b_fc, const int* w_proj, const float* s_proj,
                   const float* b_proj, void* out, int R, int W, int H, float eps, uint32_t seed,
                   cudaStream_t stream) {
  const size_t smem = MlpSmem(W, H).bytes();
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = int8_mlp_kernel<T, SR, ERF3, RECIP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (R + kInt8Rows - 1) / kInt8Rows;
  kernel<<<blocks, kInt8Threads, smem, stream>>>(static_cast<const T*>(x), gamma, beta, w_fc, s_fc, b_fc,
                                                 w_proj, s_proj, b_proj, static_cast<T*>(out), R, W, H,
                                                 eps, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int deterministic, int variant, const void* x, const float* gamma,
                        const float* beta, const int* w_fc, const float* s_fc, const float* b_fc,
                        const int* w_proj, const float* s_proj, const float* b_proj, void* out, int R,
                        int W, int H, float eps, uint32_t seed, cudaStream_t s) {
#define TAPCLIP_INT8_MLP(SR, E3, RM) \
  launch<T, SR, E3, RM>(x, gamma, beta, w_fc, s_fc, b_fc, w_proj, s_proj, b_proj, out, R, W, H, eps, seed, s)
  if (deterministic) return variant == 0 ? TAPCLIP_INT8_MLP(false, false, false) : cudaErrorInvalidValue;
  switch (variant) {
    case 0: return TAPCLIP_INT8_MLP(true, false, false);
    case 1: return TAPCLIP_INT8_MLP(true, true, false);
    case 2: return TAPCLIP_INT8_MLP(true, false, true);
    case 3: return TAPCLIP_INT8_MLP(true, true, true);
    default: return cudaErrorInvalidValue;
  }
#undef TAPCLIP_INT8_MLP
}

}  // namespace

// x, out [R, W] in the compute dtype (0 float32, 1 bfloat16); gamma, beta
// [W], s_fc, b_fc [H], s_proj, b_proj [W] f32; w_fc [pad16(W) / 4, H] and
// w_proj [pad16(H) / 4, W] packed int8 (int32 words).  deterministic 1:
// round to nearest; 0: stochastic with the draws of `seed`.  variant (S5,
// stochastic only): bit 0 erf3, bit 1 recipmul.  Refuses (cudaErrorInvalidValue)
// shapes whose hidden rows do not fit in shared memory.
extern "C" int tapclip_int8_mlp(const void* x, const void* gamma, const void* beta, const void* w_fc,
                                const void* s_fc, const void* b_fc, const void* w_proj,
                                const void* s_proj, const void* b_proj, void* out, int R, int W, int H,
                                float eps, unsigned int seed, int deterministic, int variant, int dtype,
                                void* stream) {
  if (R <= 0 || W <= 0 || H <= 0) return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* wf = static_cast<const int*>(w_fc);
  const auto* sf = static_cast<const float*>(s_fc);
  const auto* bf = static_cast<const float*>(b_fc);
  const auto* wp = static_cast<const int*>(w_proj);
  const auto* sp = static_cast<const float*>(s_proj);
  const auto* bp = static_cast<const float*>(b_proj);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mode<float>(deterministic, variant, x, g, bt, wf, sf, bf, wp, sp, bp, out, R, W, H, eps, seed, s);
  if (dtype == 1)
    return launch_mode<__nv_bfloat16>(deterministic, variant, x, g, bt, wf, sf, bf, wp, sp, bp, out, R, W, H,
                                      eps, seed, s);
  return cudaErrorInvalidValue;
}

// Bytes of shared memory the kernel takes at width W and hidden width H
// (the launcher refuses more than 232,448).
extern "C" int tapclip_int8_mlp_smem_bytes(int W, int H) {
  return static_cast<int>(MlpSmem(W, H).bytes());
}
