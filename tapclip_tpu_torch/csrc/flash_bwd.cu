// The blockwise attention backward: three kernels that run as one chain,
//   lse   = the row log-sum-exp of the masked log2-domain scores,
//   dk, dv over query tiles, one block per key tile,
//   dq     over key tiles,   one block per query tile,
// with delta = rowsum(dO * O) from the forward's output (a plain PyTorch
// pass in the wrapper, as the JAX package computes it outside any kernel).
//
// Replaces tapclip_tpu/ops/flash_attention.py::_blocked_lse_kernel (LSE),
// ::_blocked_bwd_dkv_kernel (dK/dV) and ::_blocked_bwd_dq_kernel (dQ), the
// three pallas_calls of _pallas_attention_bwd_blocked, and with them the
// single-block ::_attn_bwd_kernel: that kernel holds the whole [T, T] f32
// score tile (16 MB at T = 2048, far past the 227 KB of shared memory a
// block can use), so on the card the chain computes its function at every
// T.  The wrapper (tapclip_tpu_torch/ops/flash_attention.py) runs the chain
// as the backward of fused_attention (attn_impl="pallas").
//
// Math, as the JAX kernels (which cast q, k, v, dO to f32): s2 = q.k^T *
// Dh^-1/2 * log2 e; keys at or past valid[b], and after the query when
// causal, are masked (-1e30 in the LSE, p = 0 in the gradients);
// p = exp2(s2 - lse2); dv += p^T dO; dp = dO v^T; ds = p (dp - delta)
// Dh^-1/2; dk += ds^T q; dq += ds k.  Results go out in the compute dtype.  No atomics: each output row is summed by one block in a
// fixed order, so results repeat bit for bit.
//
// Layout: every [B, H, T, Dh] operand is read through (batch, head, row)
// strides (any with contiguous rows: per-head tensors, or views of packed
// rows).  q, k, v, dq, dk, dv share one stride set, dO another; lse and
// delta are contiguous [B, H, T] f32.  The 16-byte copies need 16-byte
// aligned rows: the wrapper checks the pointers and strides.
//
// Design (flash_mma.cuh, FlashAttention-2's backward): 4 warps a block over
// a 64-row tile, each warp owning 16 rows: query rows in the LSE and dQ
// kernels, key rows in the dK/dV kernel (which computes s^T = k q^T and
// dp^T = v dO^T, so p^T and ds^T are its accumulators and the A operands of
// dv += p^T dO and dk += ds^T q in registers).  The tiles the loop walks
// (k and v, or q, dO, lse and delta) are double-buffered with cp.async.
// Products run on the tensor cores (mma.sync m16n8k16, f32 accumulation):
// in bf16 q k^T and dO v^T are one MMA each (bf16 values), p and ds split
// into two bf16 terms against the bf16 operand; in f32 every product splits both operands into three bf16 terms
// (six MMAs; emulated, the LSE reads at most 1.4e-6 absolute and the
// gradients 6.3e-7 norm-relative against the plain f32 versions,
// flash_mma.cuh), each 16-deep step's partial products added to the
// accumulator by a rounded f32 add (mma_split).  The
// dK/dV kernel walks each query tile in 32-query halves at Dh 128 (register
// room for its two [16, 128] accumulators).  Causal blocks skip the tiles
// wholly above the diagonal, and every loop stops at valid[b].
//
// What bounds it on the card (H100 80GB HBM3 at 700 W, measured by
// tapclip_tpu_torch/scripts/time_flash.py): at T 4096 (1 x 16 heads, valid
// 4000) the three launches take about 1.7 ms in bf16 against 0.37 ms for
// their MMAs at the bf16 peak (one per q k^T and dO v^T, two per p and ds
// product), and about 8 ms in f32 against 1.6 ms for six MMAs a product
// (4.0 ms at the f32 FMA peak): the per-score work (exp2, masks, the splits)
// and register pressure (the f32 dK/dV and dQ kernels use all 255
// registers) set the rate.  At the text shapes (8 x 8 heads, T 77 or 88)
// each launch alone takes 7-12 us in bf16 and 15-33 us in f32: launch
// latency, 128 blocks of one or two tiles, and the split in f32.  PERF.md
// section 6 has the readings.
#include "common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace tapclip;
using namespace tapclip::mma;

constexpr int kThreads = 128;  // 4 warps, 16 rows each

// Element (b, h, t, d) of an operand sits at b * sb + h * sh + t * st + d.
struct Strides {
  int sb, sh, st;
};

// Row 0 of head (b, h) of an operand.
template <typename P>
__device__ __forceinline__ P* head(P* x, Strides s, int b, int h) {
  return x + static_cast<size_t>(b) * s.sb + static_cast<size_t>(h) * s.sh;
}

// Key `key` is visible to query `row`.
__device__ __forceinline__ bool visible(int row, int key, int valid, int causal) {
  return key < valid && (!causal || key <= row);
}

// LSE: one block per (batch row, head, 64-row query tile), over key tiles.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_lse_kernel(const T* __restrict__ q, const T* __restrict__ k, Strides sq,
                 const int* __restrict__ valid_b, float* __restrict__ lse, int H, int T_,
                 int causal) {
  constexpr int kLd = tile_ld<T, DH>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Q_s = reinterpret_cast<T*>(smem_raw);
  T* K_s = Q_s + kTile * kLd;  // two buffers
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int valid = min(valid_b[b], T_);
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;
  const T* q_bh = head(q, sq, b, h);
  const T* k_bh = head(k, sq, b, h);
  const int n_tiles = ((causal ? min(valid, q0 + kTile) : valid) + kTile - 1) / kTile;
  const bool active = q0 + r0 < T_;

  load_tile<T, DH, kTile, kThreads>(Q_s, q_bh, sq.st, q0, T_);
  load_tile<T, DH, kTile, kThreads>(K_s, k_bh, sq.st, 0, T_);
  cp_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile<T, DH, kTile, kThreads>(K_s + ((j + 1) & 1) * kTile * kLd, k_bh, sq.st, (j + 1) * kTile, T_);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int kt0 = j * kTile;
      float s[kTile / 8][4], mt[2] = {-INFINITY, -INFINITY};
      warp_abt<T, DH, kTile>(s, Q_s, r0, K_s + (j & 1) * kTile * kLd, 0);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
          const int row = q0 + r0 + (lane >> 2) + 8 * (e >> 1);
          // Slots past T add nothing (-inf); masked keys take the JAX
          // kernel's -1e30.  Key 0 is visible to every row, so m is finite
          // from the first tile on.
          s[n][e] = key >= T_ ? -INFINITY
                              : (visible(row, key, valid, causal) ? s[n][e] * scale_log2 : kNegBig);
          mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mt[r]));
        l[r] *= exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[n][e] - m[e >> 1]);
    }
    __syncthreads();  // this buffer is refilled with tile j + 2
  }
  cp_wait<0>();
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    const int row = q0 + r0 + (lane >> 2) + 8 * r;
    if ((lane & 3) == 0 && row < T_) lse[static_cast<size_t>(bh) * T_ + row] = m[r] + log2f(fmaxf(lr, 1e-30f));
  }
}

// dK/dV: one block per (batch row, head, 64-key tile), over query tiles.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, Strides sq, Strides sg,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ valid_b, T* __restrict__ dk, T* __restrict__ dv,
                     int H, int T_, int causal) {
  constexpr int kLd = tile_ld<T, DH>();
  constexpr int kQn = DH == 128 ? 32 : 64;  // queries of one score block
  constexpr int kPTerms = kAccTerms<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* K_s = reinterpret_cast<T*>(smem_raw);
  T* V_s = K_s + kTile * kLd;
  T* QG_s = V_s + kTile * kLd;  // buffer i: q at QG_s + 2 i kTile kLd, then dO
  float* LD_s = reinterpret_cast<float*>(QG_s + 4 * kTile * kLd);  // buffer i: lse, then delta
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kTile;
  const int valid = min(valid_b[b], T_);
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;
  const T* q_bh = head(q, sq, b, h);
  const T* g_bh = head(g, sg, b, h);
  const float* lse_bh = lse + static_cast<size_t>(bh) * T_;
  const float* delta_bh = delta + static_cast<size_t>(bh) * T_;

  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  if (k0 < valid) {  // a key tile wholly at or past valid has zero gradients
    // Causal: query tiles before this key tile see none of its keys.
    const int qt_first = causal ? k0 : 0;
    const int n_q = (T_ - qt_first + kTile - 1) / kTile;
    auto load_query_tile = [&](int i) {
      const int qt0 = qt_first + i * kTile;
      T* Q_b = QG_s + (i & 1) * 2 * kTile * kLd;
      float* L_b = LD_s + (i & 1) * 2 * kTile;
      load_tile<T, DH, kTile, kThreads>(Q_b, q_bh, sq.st, qt0, T_);
      load_tile<T, DH, kTile, kThreads>(Q_b + kTile * kLd, g_bh, sg.st, qt0, T_);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        const bool in = qt0 + r < T_;
        cp_async4(L_b + r, lse_bh + (in ? qt0 + r : 0), in);
        cp_async4(L_b + kTile + r, delta_bh + (in ? qt0 + r : 0), in);
      }
    };
    load_tile<T, DH, kTile, kThreads>(K_s, head(k, sq, b, h), sq.st, k0, T_);
    load_tile<T, DH, kTile, kThreads>(V_s, head(v, sq, b, h), sq.st, k0, T_);
    load_query_tile(0);
    cp_commit();
    for (int i = 0; i < n_q; ++i) {
      if (i + 1 < n_q) {
        load_query_tile(i + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int qt0 = qt_first + i * kTile;
      const T* Q_b = QG_s + (i & 1) * 2 * kTile * kLd;
      const T* G_b = Q_b + kTile * kLd;
      const float* L_b = LD_s + (i & 1) * 2 * kTile;
#pragma unroll 1
      for (int c = 0; c < kTile && qt0 + c < T_; c += kQn) {
        float s[kQn / 8][4], dp[kQn / 8][4];
        warp_abt<T, DH, kQn>(s, K_s, r0, Q_b, c);   // s^T = k q^T
        warp_abt<T, DH, kQn>(dp, V_s, r0, G_b, c);  // dp^T = v dO^T
#pragma unroll
        for (int n = 0; n < kQn / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + r0 + (lane >> 2) + 8 * (e >> 1);
            const int qi = c + 8 * n + 2 * (lane & 3) + (e & 1);
            const int query = qt0 + qi;
            const float p = query < T_ && visible(query, key, valid, causal)
                                ? exp2f(s[n][e] * scale_log2 - L_b[qi])
                                : 0.f;
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - L_b[kTile + qi]) * scale;
          }
        warp_pv<T, DH, kQn, kPTerms>(dv_acc, s, G_b, c);          // dv += p^T dO
        warp_pv<T, DH, kQn, kAccTerms<T>>(dk_acc, dp, Q_b, c);    // dk += ds^T q
      }
      __syncthreads();  // this buffer is refilled with query tile i + 2
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<T, DH>(head(dk, sq, b, h), sq.st, k0 + r0, T_, dk_acc, one);
  store_rows<T, DH>(head(dv, sq, b, h), sq.st, k0 + r0, T_, dv_acc, one);
}

// dQ: one block per (batch row, head, 64-row query tile), over key tiles.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, Strides sq, Strides sg,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ valid_b, T* __restrict__ dq, int H, int T_,
                    int causal) {
  constexpr int kLd = tile_ld<T, DH>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Q_s = reinterpret_cast<T*>(smem_raw);
  T* G_s = Q_s + kTile * kLd;
  T* KV_s = G_s + kTile * kLd;  // buffer i: k at KV_s + 2 i kTile kLd, then v
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const int valid = min(valid_b[b], T_);
  const float scale = rsqrtf(static_cast<float>(DH));
  const float scale_log2 = scale * kLog2e;
  const T* k_bh = head(k, sq, b, h);
  const T* v_bh = head(v, sq, b, h);
  const int n_tiles = ((causal ? min(valid, q0 + kTile) : valid) + kTile - 1) / kTile;
  const bool active = q0 + r0 < T_;

  load_tile<T, DH, kTile, kThreads>(Q_s, head(q, sq, b, h), sq.st, q0, T_);
  load_tile<T, DH, kTile, kThreads>(G_s, head(g, sg, b, h), sg.st, q0, T_);
  load_tile<T, DH, kTile, kThreads>(KV_s, k_bh, sq.st, 0, T_);
  load_tile<T, DH, kTile, kThreads>(KV_s + kTile * kLd, v_bh, sq.st, 0, T_);
  cp_commit();
  float lse_r[2], delta_r[2], acc[DH / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + (lane >> 2) + 8 * r;
    lse_r[r] = row < T_ ? lse[static_cast<size_t>(bh) * T_ + row] : 0.f;
    delta_r[r] = row < T_ ? delta[static_cast<size_t>(bh) * T_ + row] : 0.f;
  }
  zero(acc);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      T* nxt = KV_s + ((j + 1) & 1) * 2 * kTile * kLd;
      load_tile<T, DH, kTile, kThreads>(nxt, k_bh, sq.st, (j + 1) * kTile, T_);
      load_tile<T, DH, kTile, kThreads>(nxt + kTile * kLd, v_bh, sq.st, (j + 1) * kTile, T_);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (active) {
      const T* K_s = KV_s + (j & 1) * 2 * kTile * kLd;
      float s[kTile / 8][4], dp[kTile / 8][4];
      warp_abt<T, DH, kTile>(s, Q_s, r0, K_s, 0);
      warp_abt<T, DH, kTile>(dp, G_s, r0, K_s + kTile * kLd, 0);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * kTile + 8 * n + 2 * (lane & 3) + (e & 1);
          const int row = q0 + r0 + (lane >> 2) + 8 * (e >> 1);
          const float p = row < T_ && visible(row, key, valid, causal)
                              ? exp2f(s[n][e] * scale_log2 - lse_r[e >> 1])
                              : 0.f;
          dp[n][e] = p * (dp[n][e] - delta_r[e >> 1]) * scale;
        }
      warp_pv<T, DH, kTile, kAccTerms<T>>(acc, dp, K_s, 0);  // dq += ds k
    }
    __syncthreads();  // this buffer is refilled with tile j + 2
  }
  cp_wait<0>();
  if (!active) return;
  const float one[2] = {1.f, 1.f};
  store_rows<T, DH>(head(dq, sq, b, h), sq.st, q0 + r0, T_, acc, one);
}

// The launch arguments every kernel of the chain shares.
struct Args {
  const void *q, *k, *v, *g;
  const float *lse, *delta;
  const int* valid;
  void *dq, *dk, *dv;
  float* lse_out;
  int B, H, T, causal;
  Strides sq, sg;
  cudaStream_t stream;
};

enum class Which { kLse, kDkv, kDq };

template <typename T, int DH>
cudaError_t launch(Which which, const Args& a) {
  constexpr size_t kTileBytes = kTile * tile_ld<T, DH>() * sizeof(T);
  const dim3 grid(a.B * a.H, (a.T + kTile - 1) / kTile);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  cudaError_t err = cudaSuccess;
  if (which == Which::kLse) {
    auto kernel = flash_lse_kernel<T, DH>;
    const size_t smem = 3 * kTileBytes;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(q, k, a.sq, a.valid, a.lse_out, a.H, a.T, a.causal);
  } else if (which == Which::kDkv) {
    auto kernel = flash_bwd_dkv_kernel<T, DH>;
    const size_t smem = 6 * kTileBytes + 4 * kTile * sizeof(float);
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, g, a.sq, a.sg, a.lse, a.delta, a.valid,
                                                static_cast<T*>(a.dk), static_cast<T*>(a.dv),
                                                a.H, a.T, a.causal);
  } else {
    auto kernel = flash_bwd_dq_kernel<T, DH>;
    const size_t smem = 6 * kTileBytes;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, a.stream>>>(q, k, v, g, a.sq, a.sg, a.lse, a.delta, a.valid,
                                                static_cast<T*>(a.dq), a.H, a.T, a.causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(Which which, const Args& a, int Dh) {
  switch (Dh) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, const Args& a, int Dh, int dtype) {
  if (a.B <= 0 || a.H <= 0 || a.T <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_dh<float>(which, a, Dh);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(which, a, Dh);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared arguments: q, k, v [B, H, T, Dh] read through the strides
// (sq_b, sq_h, sq_t), dO through (sg_b, sg_h, sg_t), all in the compute dtype
// (0 float32, 1 bfloat16), with 16-byte aligned rows; valid [B] int32
// (1 <= valid); Dh in {16, 32, 64, 128}; causal 0 or 1.

// lse [B, H, T] f32 out.
extern "C" int tapclip_flash_lse(const void* q, const void* k, const void* valid, void* lse,
                                 int B, int H, int T, int Dh, int sq_b, int sq_h, int sq_t,
                                 int causal, int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.valid = static_cast<const int*>(valid);
  a.lse_out = static_cast<float*>(lse);
  a.B = B;
  a.H = H;
  a.T = T;
  a.causal = causal;
  a.sq = {sq_b, sq_h, sq_t};
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Which::kLse, a, Dh, dtype);
}

// lse, delta [B, H, T] f32 in; dk, dv out through the q strides.
extern "C" int tapclip_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                     const void* lse, const void* delta, const void* valid,
                                     void* dk, void* dv, int B, int H, int T, int Dh, int sq_b,
                                     int sq_h, int sq_t, int sg_b, int sg_h, int sg_t, int causal,
                                     int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.valid = static_cast<const int*>(valid);
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.T = T;
  a.causal = causal;
  a.sq = {sq_b, sq_h, sq_t};
  a.sg = {sg_b, sg_h, sg_t};
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Which::kDkv, a, Dh, dtype);
}

// lse, delta [B, H, T] f32 in; dq out through the q strides.
extern "C" int tapclip_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                    const void* lse, const void* delta, const void* valid,
                                    void* dq, int B, int H, int T, int Dh, int sq_b, int sq_h,
                                    int sq_t, int sg_b, int sg_h, int sg_t, int causal, int dtype,
                                    void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.valid = static_cast<const int*>(valid);
  a.dq = dq;
  a.B = B;
  a.H = H;
  a.T = T;
  a.causal = causal;
  a.sq = {sq_b, sq_h, sq_t};
  a.sg = {sg_b, sg_h, sg_t};
  a.stream = static_cast<cudaStream_t>(stream);
  return run(Which::kDq, a, Dh, dtype);
}
