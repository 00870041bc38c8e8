// S3 and S4, the attention half-block's A/B variants: K2's four launches
// (attn_block.cu) with the switches of scripts/attn_kernel_ab.py and
// scripts/attn_softmax_ab.py (the map is attn_variants.cuh):
//   1. LayerNorm rows into ya (ln1pass: one-pass statistics);
//   2. qkv = y . w_qkv + b_qkv into K2's f32 workspace, K2's kQkv product
//      (none with perhead_qkv);
//   3. the walk (attn_variants_online.cu, attn_variants_two_pass.cu) into ya,
//      or with perhead_qkv into the second half of ya (y is still read);
//   4. out = (attn . w_out + b_out) + x, K2's kResidual product; for the
//      interleaved form the product's depth split in H / group parts, one per
//      head group (gemm_mma.cuh's kStore partials, f32 [H / group, B T, W]),
//      and out = ((part_0 + part_1 ...) + b_out) + x, the TPU kernel's order.
// Every switch off, or only those that change no value (qk_round and
// sum_rounded in f32; mask "tail", which selects where K2's walk selects) is
// K2 itself, tapclip_attn_block, the A/B's parent; the same with group > 1
// is launches 1, 2 and 4 as K2 runs them around K2's tile function over the
// group's heads, so its output is K2's bit for bit.
//
// Replaces scripts/attn_kernel_ab.py::make_variant_kernel.kernel and
// make_interleaved_kernel.kernel (S3), scripts/attn_softmax_ab.py::
// make_kernel.kernel (S4).  The wrapper is
// tapclip_tpu_torch/ops/fused_mha.py::attn_block_variant.
#include <stdint.h>

#include <algorithm>

#include "attn_variants.cuh"
#include "common.cuh"
#include "gemm_mma.cuh"
#include "ln_rows.cuh"

// K2 (attn_block.cu), the parent.
extern "C" int tapclip_attn_block(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                  const void* b_qkv, const void* w_out, const void* b_out, void* out, void* qkv,
                                  void* ya, int B, int T, int W, int n_heads, int valid, float eps, int dtype,
                                  void* stream);

namespace {

using namespace tapclip;
using gemm::Epi;

// out = round(((part_0 + part_1 ...) + b_out) + x), the parts summed in order.
template <typename T>
__global__ void __launch_bounds__(256)
parts_sum_kernel(const float* __restrict__ part, int parts, const float* __restrict__ b_out,
                 const T* __restrict__ x, T* __restrict__ out, int R, int W) {
  const size_t n = static_cast<size_t>(R) * W;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = part[e];
    for (int g = 1; g < parts; ++g) acc += part[static_cast<size_t>(g) * n + e];
    out[e] = from_f<T>((acc + b_out[e % W]) + to_f(x[e]));
  }
}

struct Call {
  const void *x, *gamma, *beta, *w_qkv, *b_qkv, *w_out, *b_out;
  void *out, *qkv, *ya, *part;
  int B, T, W, H, valid;
  float eps;
  int ln1pass, interleaved;
};

template <typename T, int CE>
cudaError_t variant(const Call& a, attnv::WalkCall w, cudaStream_t s) {
  const int R = a.B * a.T, W = a.W;
  const auto* x = static_cast<const T*>(a.x);
  const auto* gamma = static_cast<const float*>(a.gamma);
  const auto* beta = static_cast<const float*>(a.beta);
  const auto* w_qkv = static_cast<const T*>(a.w_qkv);
  const auto* b_qkv = static_cast<const float*>(a.b_qkv);
  const auto* w_out = static_cast<const T*>(a.w_out);
  const auto* b_out = static_cast<const float*>(a.b_out);
  T* y = static_cast<T*>(a.ya);
  T* attn = w.resident ? y + static_cast<size_t>(R) * W : y;
  const int ln_blocks = (R + kLnWarps - 1) / kLnWarps;
  if (a.ln1pass) {
    ln_rows_kernel<T, true><<<ln_blocks, kLnThreads, 0, s>>>(x, gamma, beta, y, nullptr, nullptr, R, W, a.eps);
  } else {
    ln_rows_kernel<T><<<ln_blocks, kLnThreads, 0, s>>>(x, gamma, beta, y, nullptr, nullptr, R, W, a.eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* qkv = static_cast<float*>(a.qkv);
  if (!w.resident) {
    err = gemm::launch_pass<T, 128, CE, gemm::kQkv, false, float>(
        y, w_qkv, Epi<T>{b_qkv, nullptr, nullptr, nullptr, 2 * W}, qkv, R, 3 * W, W, s);
    if (err != cudaSuccess) return err;
  }
  w.qkv = qkv;
  w.y = y;
  w.w_qkv = w_qkv;
  w.b_qkv = b_qkv;
  w.out = attn;
  w.stream = s;
  err = w.form == attnv::kOnline ? attnv::launch_online_walk(w) : attnv::launch_two_pass_walk(w);
  if (err != cudaSuccess) return err;
  if (!a.interleaved)
    return gemm::launch_pass<T, 64, CE, gemm::kResidual>(attn, w_out, Epi<T>{b_out, x, nullptr, nullptr, 0},
                                                         static_cast<T*>(a.out), R, W, W, s);
  const int parts = a.H / w.group;
  auto* part = static_cast<float*>(a.part);
  err = gemm::launch_pass<T, 64, CE, gemm::kStore, false, float>(attn, w_out, Epi<T>{}, part, R, W, W, s, parts);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(R) * W;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4 * gemm::sm_count()));
  parts_sum_kernel<T><<<blocks, 256, 0, s>>>(part, parts, b_out, x, static_cast<T*>(a.out), R, W);
  return cudaGetLastError();
}

}  // namespace

// The variant of the switches: form 0 online, 1 normalised, 2 "bf16";
// sum_rounded, tail_split, smem_qkv (perhead_qkv), interleaved, ln1pass,
// qk_round, fold_q 0 or 1; mask 0 full, 1 tail (every pad key in the last
// 64-key tile: the wrapper checks it), 2 zerokv; group heads a block (a
// divisor of n_heads).  Head dim 64 (W = 64 n_heads); valid in [1, T].
// Scratch from the caller: qkv, K2's f32 workspace [B T, 3W] (unused with
// smem_qkv); ya, B T W elements of the dtype (2 B T W with smem_qkv); part,
// f32 [n_heads / group, B T, W] with interleaved.  Every pointer of the
// dtype and the workspaces 16-byte aligned.  dtype 0 float32, 1 bfloat16.
// The forms take: online every switch but interleaved; normalised
// interleaved (with group only), perhead_qkv, ln1pass and qk_round; "bf16"
// ln1pass and qk_round, which it needs in bfloat16 (no perhead_qkv).
extern "C" int tapclip_attn_variant(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                    const void* b_qkv, const void* w_out, const void* b_out, void* out, void* qkv,
                                    void* ya, void* part, int B, int T, int W, int n_heads, int valid, float eps,
                                    int form, int sum_rounded, int tail_split, int smem_qkv, int interleaved,
                                    int ln1pass, int qk_round, int fold_q, int mask, int group, int dtype,
                                    void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W != n_heads * attnv::kDh || valid < 1 || valid > T || group < 1 ||
      n_heads % group || form < 0 || form > 2 || mask < 0 || mask > 2 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const bool f32 = dtype == 0;
  // Switches that change no value here: rounding to f32, and tail's select.
  const int qk1 = qk_round && !f32;
  sum_rounded = sum_rounded && !f32;
  const bool zerokv = mask == 2;
  const bool online = form == attnv::kOnline;
  if ((!online && (sum_rounded || tail_split || fold_q || zerokv)) ||
      (interleaved && (form != attnv::kNormalized || smem_qkv || ln1pass || qk1)) ||
      (smem_qkv && (qk1 || fold_q || zerokv || tail_split || form == attnv::kBf16Exp)))
    return cudaErrorInvalidValue;
  const bool k2 = online && !sum_rounded && !tail_split && !smem_qkv && !ln1pass && !qk1 && !fold_q && !zerokv;
  if (k2 && group == 1)
    return tapclip_attn_block(x, gamma, beta, w_qkv, b_qkv, w_out, b_out, out, qkv, ya, B, T, W, n_heads, valid,
                              eps, dtype, stream);
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_qkv) |
                         reinterpret_cast<uintptr_t>(w_out) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(ya) |
                         reinterpret_cast<uintptr_t>(part);
  if (ptrs & 15) return cudaErrorMisalignedAddress;
  if ((!smem_qkv && qkv == nullptr) || (interleaved && part == nullptr)) return cudaErrorInvalidValue;
  const Call a{x, gamma, beta, w_qkv, b_qkv, w_out, b_out, out, qkv, ya, part, B, T, W, n_heads, valid, eps,
               ln1pass, interleaved};
  attnv::WalkCall w{};
  w.B = B;
  w.H = n_heads;
  w.T = T;
  w.W = W;
  w.valid = valid;
  w.group = group;
  w.form = form;
  w.qk1 = qk1;
  w.tail_split = tail_split;
  w.resident = smem_qkv;
  w.k2 = k2;
  w.sw = attnv::Switches{fold_q, zerokv, sum_rounded};
  w.dtype = dtype;
  auto s = static_cast<cudaStream_t>(stream);
  if (f32) return variant<float, 4>(a, w, s);
  return variant<__nv_bfloat16, 8>(a, w, s);
}

// Bytes of dynamic shared memory perhead_qkv's block takes at T (k and v rows
// for all T, then the projection's staging).  dtype 0 float32, 1 bfloat16.
extern "C" int tapclip_attn_variant_smem_bytes(int T, int dtype) {
  return static_cast<int>(dtype == 0 ? attnv::perhead_smem<float>(T) : attnv::perhead_smem<__nv_bfloat16>(T));
}
