// S1: a whole pre-LN ViT layer in one launch,
//   mid = x + out_proj(attention(LN1(x))),  out = mid + mlp(LN2(mid)),
// with the attention output and mid in f32 (only LN2's and GELU's outputs
// are rounded to the compute dtype, as in the TPU kernel).
//
// Replaces scripts/fused_layer_ab.py::make_layer_kernel.kernel (the
// pallas_call in run_fused_layer).  The wrapper is
// tapclip_tpu_torch/ops/fused_layer.py::fused_layer.
//
// The TPU kernel holds a whole sequence's mid in VMEM.  A Hopper block
// cannot (one ViT-B/16 sequence's mid is 200 x 768 x 4 = 614 KB against
// 227 KB of shared memory), so the layer is one cooperative launch of a
// persistent grid (as many blocks as fit on the SMs at once) in two phases:
//   A. for each (batch row, head) work item, K2's earlier FMA core
//      (attn_core.cuh): LN1 statistics, the head's q, k, v, 64-key online-softmax tiles; the
//      attention output goes, in f32, to a device workspace [B, T, W];
//   then cooperative_groups::this_grid().sync();
//   B. for each 16-row tile: the out-projection of its attention rows
//      + b_out + x into f32 shared memory (mid never leaves the chip), LN2
//      rounded, the 256-column FMA hidden walk (mlp_walk.cuh) with the
//      accumulator starting at mid + b_proj, one store.
// A launch the card cannot hold at once (the cooperative grid too large)
// is refused and the wrapper raises.
//
// What bounds it on the card: as K2's earlier core and the FMA walk, the
// serial work of each block (phase A has B x H items, 96 at ViT-B/16 batch
// 8, on 132 SMs; phase B one 16-row tile a block, each reading all of w_out,
// w_fc and w_proj from L2).
// The round trip the fusion removes, one [B, T, W] tensor written and read
// back (2 x 4.9 MB in f32 at batch 8, about 3 us at 3.35 TB/s, and it fits in
// the 50 MB L2), is small beside either phase.
#include <cooperative_groups.h>

#include "attn_core.cuh"
#include "common.cuh"
#include "mlp_walk.cuh"

namespace {

using namespace tapclip;

constexpr int kDh = 64;
constexpr int kRows = 16;
using CoreF32 = CoreCfg<kOnline, false, false, false, false, true>;

template <typename T>
size_t layer_smem_bytes(int T_, int W) {
  const size_t a = CoreSmem<kDh, CoreF32>::bytes(T_);
  const size_t b = MlpWalk<T, kRows, false, false>::floats(W) * sizeof(float);
  return a > b ? a : b;
}

// The pointers come as __restrict__ parameters, as K2's core takes them
// (attn_core.cuh): attn is the f32 attention workspace [B, T, W].
template <typename T>
__global__ void __launch_bounds__(kCoreThreads)
fused_layer_kernel(const T* __restrict__ x, const float* __restrict__ gamma1,
                   const float* __restrict__ beta1, const T* __restrict__ w_qkv,
                   const float* __restrict__ b_qkv, const T* __restrict__ w_out,
                   const float* __restrict__ b_out, const float* __restrict__ gamma2,
                   const float* __restrict__ beta2, const T* __restrict__ w_fc,
                   const float* __restrict__ b_fc, const T* __restrict__ w_proj,
                   const float* __restrict__ b_proj, float* ws, float* __restrict__ attn_ws,
                   T* __restrict__ out, int B, int H, int T_, int W, int hidden, int valid, float eps) {
  using Walk = MlpWalk<T, kRows, false, false>;
  extern __shared__ __align__(16) float smem[];
  const CoreArgs<T> c{x, gamma1, beta1, w_qkv, b_qkv, ws, attn_ws, w_out, nullptr, B, H, T_, W, valid, eps};
  const int R = B * T_;

  // Phase A: attention, one (batch row, head) item at a time.
  const CoreSwitches sw{0, 0, 0, kMaskFull, 1};
  for (int item = blockIdx.x; item < B * H; item += gridDim.x)
    attn_core_item<T, kDh, CoreF32>(c, sw, item / H, item % H, smem);
  cooperative_groups::this_grid().sync();

  // Phase B: out-projection, LN2 and the MLP, one 16-row tile at a time.
  const float* attn = attn_ws;
  float* y_s = smem;               // [kRows][W]: attention rows, then LN2(mid) rounded to T
  float* acc_s = y_s + kRows * W;  // [kRows][W]: mid, then the accumulator
  float* h_s = acc_s + kRows * W;  // [kRows][256]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int tile = blockIdx.x; tile * kRows < R; tile += gridDim.x) {
    const int row0 = tile * kRows;
    for (int e = tid; e < kRows * W; e += kCoreThreads) {
      const int r = e / W;
      y_s[e] = row0 + r < R ? attn[static_cast<size_t>(row0) * W + e] : 0.f;
    }
    __syncthreads();
    for (int col = tid; col < W; col += kCoreThreads) {
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = 0.f;
      const T* wc = w_out + col;
#pragma unroll 2
      for (int k = 0; k < W; k += 4) {
        const float w0 = to_f(wc[static_cast<size_t>(k) * W]);
        const float w1 = to_f(wc[static_cast<size_t>(k + 1) * W]);
        const float w2 = to_f(wc[static_cast<size_t>(k + 2) * W]);
        const float w3 = to_f(wc[static_cast<size_t>(k + 3) * W]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(y_s + r * W + k);
          p[r] = fmaf(av.x, w0, p[r]);
          p[r] = fmaf(av.y, w1, p[r]);
          p[r] = fmaf(av.z, w2, p[r]);
          p[r] = fmaf(av.w, w3, p[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int gr = row0 + r;
        acc_s[r * W + col] =
            gr < R ? (p[r] + b_out[col]) + to_f(x[static_cast<size_t>(gr) * W + col]) : 0.f;
      }
    }
    __syncthreads();
    for (int r = warp; r < kRows; r += kCoreThreads / 32) {
      float* ar = acc_s + r * W;
      float* yr = y_s + r * W;
      if (row0 + r < R) {
        Walk::ln_row(ar, yr, ar, gamma2, beta2, b_proj, W, eps, false, lane);
      } else {
        for (int col = lane; col < W; col += 32) yr[col] = 0.f;
      }
    }
    __syncthreads();
    Walk::walk(y_s, acc_s, h_s, w_fc, b_fc, w_proj, W, hidden);
    for (int r = 0; r < kRows && row0 + r < R; ++r)
      for (int col = tid; col < W; col += kCoreThreads)
        out[static_cast<size_t>(row0 + r) * W + col] = from_f<T>(acc_s[r * W + col]);
  }
}

template <typename T>
cudaError_t max_grid(int T_, int W, int* grid) {
  auto kernel = fused_layer_kernel<T>;
  const size_t smem = layer_smem_bytes<T>(T_, W);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCoreThreads, smem)) != cudaSuccess)
    return err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  *grid = per_sm * sms;
  return cudaSuccess;
}

// The kernel's arguments in order, for cudaLaunchCooperativeKernel.
template <typename E>  // the compute dtype
struct LayerCall {
  const E* x;
  const float *gamma1, *beta1;
  const E* w_qkv;
  const float* b_qkv;
  const E* w_out;
  const float *b_out, *gamma2, *beta2;
  const E* w_fc;
  const float* b_fc;
  const E* w_proj;
  const float* b_proj;
  float *ws, *attn;
  E* out;
  int B, H, T, W, hidden, valid;
  float eps;
};

template <typename T>
cudaError_t launch(LayerCall<T> c, int grid, cudaStream_t stream) {
  auto kernel = fused_layer_kernel<T>;
  const size_t smem = layer_smem_bytes<T>(c.T, c.W);
  int fit = 0;
  cudaError_t err = max_grid<T>(c.T, c.W, &fit);
  if (err != cudaSuccess) return err;
  if (grid <= 0) grid = fit;
  if (grid <= 0) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&c.x, &c.gamma1, &c.beta1, &c.w_qkv, &c.b_qkv, &c.w_out, &c.b_out, &c.gamma2,
                  &c.beta2, &c.w_fc, &c.b_fc, &c.w_proj, &c.b_proj, &c.ws, &c.attn, &c.out,
                  &c.B, &c.H, &c.T, &c.W, &c.hidden, &c.valid, &c.eps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kCoreThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, out [B, T, W] in the compute dtype (0 float32, 1 bfloat16); w_qkv
// [W, 3W], w_out [W, W], w_fc [W, H], w_proj [H, W] in it; LayerNorm
// parameters and biases f32.  ws: f32 [B, n_heads, 3, T, 64]; attn: f32
// [B, T, W].  Head dim 64, W and H multiples of 4.  grid 0: as many blocks as
// the card holds at once; a larger grid is refused
// (cudaErrorCooperativeLaunchTooLarge).
extern "C" int tapclip_fused_layer(const void* x, const void* gamma1, const void* beta1, const void* w_qkv,
                                   const void* b_qkv, const void* w_out, const void* b_out,
                                   const void* gamma2, const void* beta2, const void* w_fc, const void* b_fc,
                                   const void* w_proj, const void* b_proj, void* ws, void* attn, void* out,
                                   int B, int T, int W, int n_heads, int H, int valid, float eps, int grid,
                                   int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W != n_heads * kDh || H <= 0 || H % 4 || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
#define TAPCLIP_LAYER(TT)                                                                              \
  return launch<TT>(LayerCall<TT>{static_cast<const TT*>(x), f(gamma1), f(beta1), static_cast<const TT*>(w_qkv), \
                                  f(b_qkv), static_cast<const TT*>(w_out), f(b_out), f(gamma2), f(beta2),        \
                                  static_cast<const TT*>(w_fc), f(b_fc), static_cast<const TT*>(w_proj),         \
                                  f(b_proj), static_cast<float*>(ws), static_cast<float*>(attn),                 \
                                  static_cast<TT*>(out), B, n_heads, T, W, H, valid, eps},                      \
                    grid, s);
  if (dtype == 0) TAPCLIP_LAYER(float)
  if (dtype == 1) TAPCLIP_LAYER(__nv_bfloat16)
#undef TAPCLIP_LAYER
  return cudaErrorInvalidValue;
}

// Blocks of the persistent grid the card holds at once at (T, W), or 0 where
// not one fits; -1 on an error.
extern "C" int tapclip_fused_layer_max_grid(int T, int W, int dtype) {
  int grid = 0;
  cudaError_t err = dtype == 0 ? max_grid<float>(T, W, &grid)
                               : dtype == 1 ? max_grid<__nv_bfloat16>(T, W, &grid) : cudaErrorInvalidValue;
  return err == cudaSuccess ? grid : -1;
}
