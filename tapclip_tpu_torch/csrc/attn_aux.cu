// K3: attention with the attribution column,
//   out[b, h] = softmax_masked(q k^T / sqrt(Dh)) v,
//   aux[b, h, t] = p[t, eot[b]] / l[t]   (the normalised probability column).
//
// Replaces tapclip_tpu/ops/flash_attention.py::_attn_kernel with
// with_aux=True (the pallas_call in _pallas_attention), causal or not (the
// kernel's static flag).  The wrapper
// (tapclip_tpu_torch/ops/flash_attention.py::fused_attention) takes the
// mean of aux over heads, as the JAX wrapper does.
//
// What bounds it on the card: not measured (no profile of it yet); inferred
// from the shape.  At the slice's shape (B = 8 classes, 8 heads, T = 88,
// Dh = 64) the whole call is 2 x 2 x B x H x T^2 x Dh = 32 MFLOP on 1.4 MB
// of q, k, v, which points to launch latency and the few blocks in flight
// rather than bandwidth or arithmetic.  Only the [B, H, T] column leaves the chip, never
// the [B, H, T, T] probabilities, which is what the reference's attention
// hook needs.
//
// Design: one block per (batch row, head, 64-row query tile).  Each block
// reads its own valid[b] and eot[b] from device memory (the JAX kernel gets
// them as scalar prefetch).  Keys are walked in 64-key tiles with an online
// softmax (attn_tile.cuh), so any T runs in the same shared memory, T = 584
// (ViT-L/14 at 336 px) included.  After the last key tile the block
// recomputes each row's score against key eot[b] and normalises it with the
// final row max and sum; a key at or past valid[b] gives 0, as its masked
// probability does in the JAX kernel.  q and k are read as f32 and the
// probabilities rounded to the compute dtype before p.v, as in the JAX kernel.
//
// Causal (the idiomatic text mode's aux layer): a key after the query takes
// -1e30, and a query tile skips the key tiles wholly above the diagonal
// (their probabilities are exactly 0).  A row whose attribution key eot[b]
// lies after it gets an aux of exactly 0, as exp2(-1e30 - m) is in the JAX
// kernel: in idiomatic mode every context query sits before its class's EOT
// key, so the JAX package's attribution there is the softmax of zeros.
#include "attn_tile.cuh"
#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kThreads = 256;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_aux_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ valid_b,
                const int* __restrict__ eot_b, T* __restrict__ out,
                float* __restrict__ aux, int H, int T_, int with_aux, int causal) {
  using Tile = AttnTile<T, DH>;
  extern __shared__ __align__(16) float smem[];
  float* Q_s = smem;
  float* K_s = Q_s + Tile::kRows * Tile::kLd;
  float* V_s = K_s + Tile::kKeys * Tile::kLd;
  float* P_s = V_s + Tile::kKeys * Tile::kLd;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * Tile::kRows;
  const int valid = valid_b[b];
  const size_t base = static_cast<size_t>(bh) * T_ * DH;
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;

  for (int e = tid; e < Tile::kRows * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    Q_s[r * Tile::kLd + d] =
        q0 + r < T_ ? to_f(q[base + static_cast<size_t>(q0 + r) * DH + d]) : 0.f;
  }
  Tile tile;
  tile.init();
  const int k_end = causal ? min(T_, q0 + Tile::kRows) : T_;
  for (int kt0 = 0; kt0 < k_end; kt0 += Tile::kKeys) {
    for (int e = tid; e < Tile::kKeys * DH; e += kThreads) {
      const int r = e / DH, d = e % DH;
      const bool in = kt0 + r < T_;
      const size_t off = base + static_cast<size_t>(kt0 + r) * DH + d;
      K_s[r * Tile::kLd + d] = in ? to_f(k[off]) : 0.f;
      V_s[r * Tile::kLd + d] = in ? to_f(v[off]) : 0.f;
    }
    __syncthreads();
    tile.step(Q_s, K_s, V_s, P_s, kt0, T_, valid, scale_log2, rg, cg, causal ? q0 : -1);
  }

  const int eot = eot_b[b];
  const bool eot_ok = with_aux && eot >= 0 && eot < valid && eot < T_;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg + 16 * i;
    if (t >= T_) continue;
    const float inv_l = 1.f / tile.l[i];
#pragma unroll
    for (int j = 0; j < Tile::kDj; ++j) {
      const int d = cg + 16 * j;
      out[base + static_cast<size_t>(t) * DH + d] = from_f<T>(tile.o[i][j] * inv_l);
    }
    if (with_aux && cg == 0) {
      float col = 0.f;
      if (eot_ok && !(causal && eot > t)) {
        const T* ke = k + base + static_cast<size_t>(eot) * DH;
        float s = 0.f;
        for (int d = 0; d < DH; ++d) s = fmaf(Q_s[(rg + 16 * i) * Tile::kLd + d], to_f(ke[d]), s);
        col = exp2f(s * scale_log2 - tile.m[i]) * inv_l;
      }
      aux[static_cast<size_t>(bh) * T_ + t] = col;
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid,
                   const int* eot, void* out, float* aux, int B, int H, int T_,
                   int with_aux, int causal, cudaStream_t stream) {
  const size_t smem = AttnTile<T, DH>::kSmemFloats * sizeof(float);
  auto kernel = attn_aux_kernel<T, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T_ + AttnTile<T, DH>::kRows - 1) / AttnTile<T, DH>::kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid,
      eot, static_cast<T*>(out), aux, H, T_, with_aux, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const int* valid,
                      const int* eot, void* out, float* aux, int B, int H, int T_,
                      int Dh, int with_aux, int causal, cudaStream_t s) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, valid, eot, out, aux, B, H, T_, with_aux, causal, s);
    case 32: return launch<T, 32>(q, k, v, valid, eot, out, aux, B, H, T_, with_aux, causal, s);
    case 64: return launch<T, 64>(q, k, v, valid, eot, out, aux, B, H, T_, with_aux, causal, s);
    case 128: return launch<T, 128>(q, k, v, valid, eot, out, aux, B, H, T_, with_aux, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, H, T, Dh]; valid, eot: [B] int32 on the device;
// aux: [B, H, T] f32 (unused when with_aux is 0).  causal: 0 or 1.
// dtype: 0 float32, 1 bfloat16.
extern "C" int tapclip_attn_aux(const void* q, const void* k, const void* v,
                                const void* valid, const void* eot, void* out, void* aux,
                                int B, int H, int T, int Dh, int with_aux, int causal,
                                int dtype, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  const auto* va = static_cast<const int*>(valid);
  const auto* eo = static_cast<const int*>(eot);
  auto* ax = static_cast<float*>(aux);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(q, k, v, va, eo, out, ax, B, H, T, Dh, with_aux, causal, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, va, eo, out, ax, B, H, T, Dh, with_aux, causal, s);
  return cudaErrorInvalidValue;
}
