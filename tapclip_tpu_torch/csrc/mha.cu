// B6: the packed-QKV attention core,
//   out[b, t, h] = softmax_masked(q k^T / sqrt(Dh)) v   for every head h,
// with q, k, v the three W-wide column blocks of qkv [B, T, 3W] (bias already
// added) and out [B, T, W], both in the compute dtype.
//
// Replaces tapclip_tpu/ops/fused_mha.py::_mha_kernel (the pallas_call in
// _fused_mha_fwd_impl).  The wrapper is
// tapclip_tpu_torch/ops/fused_mha.py::fused_mha, whose backward is B7
// (mha_bwd.cu).  The CLIP text tower runs it in every causal block
// (attn_impl "auto" / "fused"), and attn_impl "fused_split" in every block.
//
// The TPU kernel holds a batch block's whole [Tp, 3W] rows and a [Tp, Tp]
// score tile in VMEM and loops over 128-lane head groups.  Here one block of
// 256 threads owns one (batch row, head, 64-row query tile) and walks the keys
// in 64-key tiles with the online softmax of attn_tile.cuh (shared with the
// FMA core of S1, S3 and S4), so any T runs in the same 65 KB of shared memory: T = 77 (the
// idiomatic text mode, unpadded), 80 (encode_text), 200 (ViT-B/16 under
// fused_split), 584 (ViT-L/14 at 336 px).  The block reads its head's q, k
// and v straight out of the packed rows (row stride 3W, column offset
// h * Dh) and writes o straight into [B, T, W]: no head-split copies.
//
// Numerics as the TPU kernel: q and k in f32, scores scaled by
// scale * log2 e and exp2'd, keys at or past `valid` and (causal) keys after
// the query at -1e30, p rounded to v's dtype before p.v, normalisation
// deferred (o / l).  Key tiles whose keys are all masked for every row of the
// query tile (wholly above the diagonal when causal, or wholly at or past
// valid) are skipped: their probabilities are exactly 0.
//
// What bounds it on the card: inferred from the shape, not measured by a
// profile.  At the text shape (8 classes x 8 heads, T 77 or 80, Dh 64) a call
// moves about 5 MB in f32 (qkv in, o out) and does about 0.1 GFLOP: both
// bounds are under 2 us, so the time is launch latency and the serial work of one block (its
// FMAs run on the FMA units in f32; tensor-core MMA is later work).  The grid
// is B x H x ceil(T / 64) blocks (128 at that shape, 1,024 at a 64-text
// batch), which fills the 132 SMs only at the larger batches.
#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kThreads = 256;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const T* __restrict__ qkv, T* __restrict__ out, int H, int T_, int W, int valid,
           int causal) {
  using Tile = AttnTile<T, DH>;
  extern __shared__ __align__(16) float smem[];
  float* Q_s = smem;
  float* K_s = Q_s + Tile::kRows * Tile::kLd;
  float* V_s = K_s + Tile::kKeys * Tile::kLd;
  float* P_s = V_s + Tile::kKeys * Tile::kLd;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * Tile::kRows;
  const size_t ld = 3 * static_cast<size_t>(W);
  const T* qb = qkv + static_cast<size_t>(b) * T_ * ld + h * DH;
  const T* kb = qb + W;
  const T* vb = qb + 2 * W;
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;

  for (int e = tid; e < Tile::kRows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    Q_s[r * Tile::kLd + d] = q0 + r < T_ ? to_f(qb[(q0 + r) * ld + d]) : 0.f;
  }
  int k_end = min(T_, valid);
  if (causal) k_end = min(k_end, q0 + Tile::kRows);
  Tile tile;
  tile.init();
  for (int kt0 = 0; kt0 < k_end; kt0 += Tile::kKeys) {
    for (int e = tid; e < Tile::kKeys * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      const bool in = kt0 + r < T_;
      const size_t off = (kt0 + r) * ld + d;
      K_s[r * Tile::kLd + d] = in ? to_f(kb[off]) : 0.f;
      V_s[r * Tile::kLd + d] = in ? to_f(vb[off]) : 0.f;
    }
    __syncthreads();
    tile.step(Q_s, K_s, V_s, P_s, kt0, T_, valid, scale_log2, rg, cg, causal ? q0 : -1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg + 16 * i;
    if (t >= T_) continue;
    const float inv_l = 1.f / tile.l[i];
    T* orow = out + (static_cast<size_t>(b) * T_ + t) * W + h * DH;
#pragma unroll
    for (int j = 0; j < Tile::kDj; ++j) orow[cg + 16 * j] = from_f<T>(tile.o[i][j] * inv_l);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, void* out, int B, int T_, int W, int H, int valid,
                   int causal, cudaStream_t stream) {
  const size_t smem = AttnTile<T, DH>::kSmemFloats * sizeof(float);
  auto kernel = mha_kernel<T, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T_ + AttnTile<T, DH>::kRows - 1) / AttnTile<T, DH>::kRows);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), H,
                                           T_, W, valid, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* qkv, void* out, int B, int T_, int W, int H, int valid,
                      int causal, cudaStream_t s) {
  switch (W / H) {
    case 16: return launch<T, 16>(qkv, out, B, T_, W, H, valid, causal, s);
    case 32: return launch<T, 32>(qkv, out, B, T_, W, H, valid, causal, s);
    case 64: return launch<T, 64>(qkv, out, B, T_, W, H, valid, causal, s);
    case 128: return launch<T, 128>(qkv, out, B, T_, W, H, valid, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv [B, T, 3W] and out [B, T, W] in the compute dtype (0 float32, 1
// bfloat16).  Head dim W / n_heads in {16, 32, 64, 128}; 1 <= valid <= T;
// causal 0 or 1.
extern "C" int tapclip_mha(const void* qkv, void* out, int B, int T, int W, int n_heads,
                           int valid, int causal, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(qkv, out, B, T, W, n_heads, valid, causal, s);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(qkv, out, B, T, W, n_heads, valid, causal, s);
  return cudaErrorInvalidValue;
}
