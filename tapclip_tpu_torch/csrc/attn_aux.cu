// K3: attention with the attribution column,
//   out[b, h] = softmax_masked(q k^T / sqrt(Dh)) v,
//   aux[b, h, t] = p[t, eot[b]] / l[t]   (the normalised probability column).
//
// Replaces tapclip_tpu/ops/flash_attention.py::_attn_kernel with
// with_aux=True (the pallas_call in _pallas_attention), causal or not (the
// kernel's static flag), and past T 2048 ::_blocked_attn_kernel.  The
// wrapper (tapclip_tpu_torch/ops/flash_attention.py::fused_attention) takes
// the mean of aux over heads, as the JAX wrapper does.
//
// Design (flash_mma.cuh): one block per (batch row, head, ROWS-row query
// tile), ROWS / 16 warps, each owning 16 query rows.  Keys are walked in
// 64-key online-softmax tiles, so any T runs in the same shared memory; the
// K and V tiles are double-buffered with 16-byte cp.async, so the next key
// tile loads while this one computes.  q k^T and p v run on the tensor cores
// (mma.sync m16n8k16, f32 accumulation): in bf16 one MMA per product (q, k
// and the rounded p are bf16 values, as the JAX kernel's operands), in f32
// with both operands split into three bf16 terms (six MMAs; emulated, the
// output reads at most 5.1e-7 norm-relative and the aux column 8.9e-8
// absolute against the plain f32 version, flash_mma.cuh).  The score accumulator becomes p
// in registers and the A operand of p v without a trip through shared
// memory.  Scores stay in the log2 domain; keys at or past valid[b] (and
// causal keys after the query) take -1e30, slots past T -inf; the 1/l
// normalisation comes after p v, and l sums the unrounded p.  Causal query
// tiles skip the key tiles wholly above the diagonal.
//
// The attribution column: when the key tile holding key eot[b] passes, the
// lane whose score fragment holds it keeps that row's masked score; after
// the last tile it is normalised with the row's final max and sum.  A key
// at or past valid[b], or after the row under causal, holds -1e30 and gives
// exactly 0, as its masked probability does in the JAX kernel: in idiomatic
// mode every context query sits before its class's EOT key, so the JAX
// package's attribution there is the softmax of zeros.
//
// Query-tile height: 64 rows past T 128; 32 for T in (32, 128] and 16 up to
// T 32, so the text shapes (8 x 8 heads at T 77 or 88) put 192 blocks on the
// card's 132 SMs instead of 128.
//
// What bounds it on the card (H100 80GB HBM3 at 700 W, measured by
// tapclip_tpu_torch/scripts/time_flash.py): at T 4096 (1 x 16 heads, valid
// 4000) the launch takes about 0.3 ms in bf16 against 0.068 ms for its
// products at the bf16 peak, and about 2.2 ms in f32 against 0.41 ms for its
// six MMAs a product (1.0 ms at the f32 FMA peak): the per-score softmax
// work (exp2, masks, the split of f32 operands) and one 64-key tile in
// flight per warp set the rate, not the MMAs.  At the text shapes (8 x 8
// heads, T 77 or 88) the launch alone takes 6-10 us in bf16 and 20 us in
// f32: launch latency and the split.  PERF.md section 6 has the readings.
#include "common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace tapclip;
using namespace tapclip::mma;

template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(2 * ROWS)
attn_aux_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ valid_b, const int* __restrict__ eot_b, int valid_all,
                int eot_all, T* __restrict__ out, float* __restrict__ aux, int H, int T_,
                int with_aux, int causal) {
  constexpr int kThreads = 2 * ROWS;  // ROWS / 16 warps
  constexpr int kLd = tile_ld<T, DH>();
  constexpr int kPTerms = kIsF32<T> ? kF32Terms : 1;  // p.astype(v.dtype): bf16 rounds p
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Q_s = reinterpret_cast<T*>(smem_raw);
  T* KV_s = Q_s + ROWS * kLd;  // buffer i: K at KV_s + 2 i kTile kLd, then V
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / H;
  const int q0 = blockIdx.y * ROWS, r0 = (threadIdx.x >> 5) * 16;
  const int valid = valid_b ? valid_b[b] : valid_all;
  const int eot = with_aux ? (eot_b ? eot_b[b] : eot_all) : -1;
  const size_t base = static_cast<size_t>(bh) * T_ * DH;
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;
  const int n_tiles = ((causal ? min(T_, q0 + ROWS) : T_) + kTile - 1) / kTile;
  const bool active = q0 + r0 < T_;  // the warp holds a row below T

  load_tile<T, DH, ROWS, kThreads>(Q_s, q + base, DH, q0, T_);
  load_tile<T, DH, kTile, kThreads>(KV_s, k + base, DH, 0, T_);
  load_tile<T, DH, kTile, kThreads>(KV_s + kTile * kLd, v + base, DH, 0, T_);
  cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, s_eot[2] = {-INFINITY, -INFINITY};
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      T* nxt = KV_s + ((j + 1) & 1) * 2 * kTile * kLd;
      load_tile<T, DH, kTile, kThreads>(nxt, k + base, DH, (j + 1) * kTile, T_);
      load_tile<T, DH, kTile, kThreads>(nxt + kTile * kLd, v + base, DH, (j + 1) * kTile, T_);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* K_s = KV_s + (j & 1) * 2 * kTile * kLd;
    if (active) {
      const int kt0 = j * kTile;
      float s[kTile / 8][4], mt[2] = {-INFINITY, -INFINITY};
      warp_abt<T, DH, kTile>(s, Q_s, r0, K_s, 0);
      // Only a tile that reaches valid or T, crosses the warp's diagonal or
      // holds the attribution key needs the per-key tests.
      if (kt0 + kTile > min(valid, T_) || (causal && kt0 + kTile > q0 + r0 + 1) ||
          (eot >= kt0 && eot < kt0 + kTile)) {
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
            const int row = q0 + r0 + (lane >> 2) + 8 * (e >> 1);
            float x = s[n][e] * scale_log2;
            if (key >= T_) x = -INFINITY;
            else if (key >= valid || (causal && key > row)) x = kNegBig;
            if (key == eot) s_eot[e >> 1] = x;
            s[n][e] = x;
            mt[e >> 1] = fmaxf(mt[e >> 1], x);
          }
      } else {
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] *= scale_log2;
            mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // Finite from the first tile on: key 0 is below T.
        const float m_new = fmaxf(m[r], quad_max(mt[r]));
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;  // this lane's share of the row sum, unrounded p
          s[n][e] = p;
        }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
      warp_pv<T, DH, kTile, kPTerms>(o, s, K_s + kTile * kLd, 0);
    }
    __syncthreads();  // this buffer is refilled with tile j + 2
  }
  if (!active) return;

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / quad_sum(l[r]);
  store_rows<T, DH>(out + base, DH, q0 + r0, T_, o, inv_l);
  if (with_aux) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // One lane of the quad holds the column (the others 0); -inf and -1e30 give 0.
      const float col = quad_sum(exp2f(s_eot[r] - m[r]) * inv_l[r]);
      const int row = q0 + r0 + (lane >> 2) + 8 * r;
      if ((lane & 3) == 0 && row < T_) aux[static_cast<size_t>(bh) * T_ + row] = col;
    }
  }
}

template <typename T, int DH, int ROWS>
cudaError_t launch(const void* q, const void* k, const void* v, const int* valid, const int* eot,
                   int valid_all, int eot_all, void* out, float* aux, int B, int H, int T_,
                   int with_aux, int causal, cudaStream_t stream) {
  constexpr int kLd = tile_ld<T, DH>();
  const int n_buf = T_ > kTile ? 2 : 1;  // one key tile needs no second buffer
  const size_t smem = (ROWS + n_buf * 2 * kTile) * kLd * sizeof(T);
  auto kernel = attn_aux_kernel<T, DH, ROWS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T_ + ROWS - 1) / ROWS);
  kernel<<<grid, 2 * ROWS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid, eot,
      valid_all, eot_all, static_cast<T*>(out), aux, H, T_, with_aux, causal);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_rows(const void* q, const void* k, const void* v, const int* valid,
                        const int* eot, int valid_all, int eot_all, void* out, float* aux, int B,
                        int H, int T_, int with_aux, int causal, cudaStream_t s) {
  if (T_ <= 32)
    return launch<T, DH, 16>(q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T_, with_aux, causal, s);
  if (T_ <= 128)
    return launch<T, DH, 32>(q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T_, with_aux, causal, s);
  return launch<T, DH, 64>(q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T_, with_aux, causal, s);
}

template <typename T>
cudaError_t launch_dh(const void* q, const void* k, const void* v, const int* valid, const int* eot,
                      int valid_all, int eot_all, void* out, float* aux, int B, int H, int T_,
                      int Dh, int with_aux, int causal, cudaStream_t s) {
  switch (Dh) {
    case 16:
      return launch_rows<T, 16>(q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T_, with_aux, causal, s);
    case 32:
      return launch_rows<T, 32>(q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T_, with_aux, causal, s);
    case 64:
      return launch_rows<T, 64>(q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T_, with_aux, causal, s);
    case 128:
      return launch_rows<T, 128>(q, k, v, valid, eot, valid_all, eot_all, out, aux, B, H, T_, with_aux, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, H, T, Dh] contiguous, 16-byte aligned; valid, eot: [B]
// int32 on the device, or null for valid_all / eot_all in every row;
// aux: [B, H, T] f32 (unused when with_aux is 0).  causal: 0 or 1.
// dtype: 0 float32, 1 bfloat16.
extern "C" int tapclip_attn_aux(const void* q, const void* k, const void* v, const void* valid,
                                const void* eot, int valid_all, int eot_all, void* out, void* aux,
                                int B, int H, int T, int Dh, int with_aux, int causal, int dtype,
                                void* stream) {
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  const auto* va = static_cast<const int*>(valid);
  const auto* eo = static_cast<const int*>(eot);
  auto* ax = static_cast<float*>(aux);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, va, eo, valid_all, eot_all, out, ax, B, H, T, Dh, with_aux, causal, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, va, eo, valid_all, eot_all, out, ax, B, H, T, Dh, with_aux,
                                    causal, s);
  return cudaErrorInvalidValue;
}
