// K2's earlier core on the FMA units (K2 itself, attn_block.cu, runs on the
// tensor cores since its redesign), kept as the device code of the A/B
// variants S3/S4 (attn_variants_*.cu) and the one-launch fused layer S1
// (fused_layer.cu): for one (batch row, head group) the LayerNorm statistics
// of the batch row's T tokens, then for each head of the group its q, k, v
// column slices of the QKV product for all T tokens (LN applied on the fly as
// the [64, KT] operand tiles are staged in shared memory) and masked softmax
// attention over 64-row query tiles (attn_tile.cuh).  K2's function (one head
// a block, q, k f32 in an f32 workspace [B, H, 3, T, Dh], v rounded to the
// compute dtype, the online softmax, the output rounded into [B, T, W]) is
// the default CoreCfg with every runtime switch off (S4's flags-off kernel).
//
// The variants' switches, each the nearest Hopper counterpart of a switch of
// scripts/attn_kernel_ab.py or scripts/attn_softmax_ab.py:
//   compile time (CoreCfg):
//     FORM, SUM_ROUNDED  the softmax's numerics (attn_tile.cuh);
//     TAIL_SPLIT         tail_split: keys before and from (T / 128) * 128
//                        summed as two online states, merged at the end;
//     SMEM_QKV           perhead_qkv: the head's q, k, v stay in shared
//                        memory (3 x ceil64(T) rows of Dh + 1 floats, 200 KB
//                        at T 200, Dh 64) instead of the f32 workspace; the
//                        projection stages 16-deep tiles so they fit beside;
//     INTERLEAVED        the interleaved kernel: each head's output is rounded
//                        into [B, T, W], then the block multiplies its group's
//                        columns by their rows of w_out into an f32 partial
//                        [groups, B, T, W] (reduced in a fixed order by a
//                        second launch: no atomics);
//     F32_OUT            S1: the attention output stays f32;
//     SWITCHES           read the runtime switches below (off in K2);
//   run time (CoreSwitches):
//     ln1pass   var = E[x^2] - mean^2;
//     qk_round  q and k rounded to the compute dtype (S3 without
//               perhead_qkv rounds the whole qkv product; S4's qk_cast);
//     fold_q    q multiplied by scale * log2 e, the score not scaled again;
//     mask      kMaskTail: the valid select in the last 64-key tile only
//               (the wrapper checks every pad key lies there);
//               kMaskZeroKV: pad rows of k and v zeroed after the bias, no
//               select, l -= n_pad * exp2(-m) at the end;
//     group     heads per block: one LN pass and one read of x serve them.
#pragma once

#include "attn_tile.cuh"
#include "common.cuh"

namespace tapclip {

constexpr int kCoreThreads = 256;
constexpr int kCoreRowTile = 64;  // token rows per projection tile

enum CoreMask { kMaskFull = 0, kMaskTail = 1, kMaskZeroKV = 2 };

struct CoreSwitches {
  int ln1pass, qk_round, fold_q, mask, group;
};

template <int FORM_ = kOnline, bool SUM_ROUNDED_ = false, bool TAIL_SPLIT_ = false,
          bool SMEM_QKV_ = false, bool INTERLEAVED_ = false, bool F32_OUT_ = false,
          bool SWITCHES_ = false>
struct CoreCfg {
  static constexpr int kForm = FORM_;
  static constexpr bool kSumRounded = SUM_ROUNDED_, kTailSplit = TAIL_SPLIT_, kSmemQkv = SMEM_QKV_,
                        kInterleaved = INTERLEAVED_, kF32Out = F32_OUT_, kSwitches = SWITCHES_;
  static constexpr int kKTile = SMEM_QKV_ ? 16 : 32;  // reduction depth per staged tile
};

// Shared memory of the core, in floats: the projection's staging tiles and the
// attention tile (a union), the resident q, k, v with SMEM_QKV, and the
// batch row's LN statistics (2T).
template <int DH, typename Cfg>
struct CoreSmem {
  using Tile = AttnTile<float, DH>;
  static constexpr int kCols = 3 * DH;  // q, k, v columns of one head
  static constexpr int kProj = kCoreRowTile * (Cfg::kKTile + 1) + Cfg::kKTile * kCols;
  static constexpr int kAttn = Cfg::kSmemQkv ? Tile::kRows * Tile::kPld : Tile::kSmemFloats;
  static constexpr int kOut = Cfg::kInterleaved ? 64 * 33 + 32 * 64 : 0;  // partial out-projection tiles
  static constexpr int kUnion0 = kProj > kAttn ? kProj : kAttn;
  static constexpr int kUnion = kUnion0 > kOut ? kUnion0 : kOut;
  __host__ __device__ static int t_pad(int T) { return (T + 63) / 64 * 64; }
  __host__ __device__ static int resident(int T) { return Cfg::kSmemQkv ? 3 * t_pad(T) * Tile::kLd : 0; }
  __host__ __device__ static size_t bytes(int T) {
    return (static_cast<size_t>(resident(T)) + kUnion + 2 * T) * sizeof(float);
  }
};

template <typename E>  // the compute dtype
struct CoreArgs {
  const E* x;
  const float *gamma, *beta;
  const E* w_qkv;
  const float* b_qkv;
  float* ws;     // f32 [B, H, 3, T, Dh] (not with SMEM_QKV)
  void* attn;    // [B, T, W]: T, or f32 with F32_OUT
  const E* w_out;  // INTERLEAVED: w_out and the f32 partials [W / (group Dh), B, T, W]
  float* part;
  int B, H, T, W, valid;
  float eps;
};

// LayerNorm statistics of the rows x[t, :W], t < n, one warp a row.
template <typename Src>
__device__ __forceinline__ void ln_stats_rows(const Src* x, int n, int W, float eps, bool one_pass,
                                              float* mean_s, float* rstd_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < n; t += kCoreThreads / 32) {
    const Src* xr = x + static_cast<size_t>(t) * W;
    float mean, var;
    if (one_pass) {
      float s = 0.f, q = 0.f;
      for (int c = lane; c < W; c += 32) {
        const float v = to_f(xr[c]);
        s += v;
        q += v * v;
      }
      mean = warp_sum(s) / W;
      var = warp_sum(q) / W - mean * mean;
    } else {
      float s = 0.f;
      for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
      mean = warp_sum(s) / W;
      float v = 0.f;
      for (int c = lane; c < W; c += 32) {
        const float d = to_f(xr[c]) - mean;
        v += d * d;
      }
      var = warp_sum(v) / W;
    }
    if (lane == 0) {
      mean_s[t] = mean;
      rstd_s[t] = rsqrtf(var + eps);
    }
  }
}

// One head h of batch row b: its q, k, v, then attention into attn[b, :, h].
// smem: the core's layout (CoreSmem); mean_s, rstd_s hold the row's LN stats.
template <typename T, int DH, typename Cfg>
__device__ __forceinline__ void attn_core_head(const CoreArgs<T>& a, const CoreSwitches& sw, int b,
                                               int h, float* smem, const float* mean_s,
                                               const float* rstd_s) {
  using Tile = AttnTile<T, DH, Cfg::kForm, Cfg::kSumRounded>;
  using Smem = CoreSmem<DH, Cfg>;
  constexpr int kCols = Smem::kCols;
  constexpr int kNj = kCols / 16;
  constexpr int KT = Cfg::kKTile;
  const int T_ = a.T, W = a.W, valid = a.valid;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const T* xb = a.x + static_cast<size_t>(b) * T_ * W;
  float scale = Cfg::kForm == kNormalized ? rsqrtf(static_cast<float>(DH))
                                          : rsqrtf(static_cast<float>(DH)) * kLog2e;

  // Where q, k, v live: the f32 workspace (row stride DH, q, k, v T rows
  // apart) or, with SMEM_QKV, shared memory (row stride Tile::kLd, zero rows
  // up to ceil64(T)).
  const int ld = Cfg::kSmemQkv ? Tile::kLd : DH;
  const size_t part_stride = static_cast<size_t>(Cfg::kSmemQkv ? Smem::t_pad(T_) : T_) * ld;
  float* const ws_q =
      Cfg::kSmemQkv ? smem : a.ws + (static_cast<size_t>(b) * a.H + h) * 3 * T_ * DH;
  float* const ws_k = ws_q + part_stride;
  float* const ws_v = ws_k + part_stride;
  float* stage = smem + Smem::resident(T_);
  if (Cfg::kSmemQkv) {
    const int pad = (static_cast<int>(part_stride) / ld - T_) * ld;
    for (int e = tid; e < 3 * pad; e += kCoreThreads)
      ws_q[(e / pad) * part_stride + T_ * ld + e % pad] = 0.f;
  }
  const bool fold_q = Cfg::kSwitches && sw.fold_q;
  const bool qk_round = Cfg::kSwitches && sw.qk_round;
  const bool zero_kv = Cfg::kSwitches && sw.mask == kMaskZeroKV;
  if (fold_q) scale = 1.f;
  const float fold = rsqrtf(static_cast<float>(DH)) * kLog2e;

  // q, k, v of head h for all tokens: [T, 3 DH] = LN(x) @ w_qkv[:, head cols].
  float* y_s = stage;                             // [kCoreRowTile][KT + 1]
  float* w_s = stage + kCoreRowTile * (KT + 1);   // [KT][kCols]
  for (int t0 = 0; t0 < T_; t0 += kCoreRowTile) {
    float acc[4][kNj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNj; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < W; k0 += KT) {
      for (int e = tid; e < kCoreRowTile * KT; e += kCoreThreads) {
        const int r = e / KT, kk = e % KT;
        const int t = t0 + r, k = k0 + kk;
        float val = 0.f;
        if (t < T_ && k < W)
          val = round_to<T>((to_f(xb[static_cast<size_t>(t) * W + k]) - mean_s[t]) *
                                rstd_s[t] * a.gamma[k] + a.beta[k]);
        y_s[r * (KT + 1) + kk] = val;
      }
      for (int e = tid; e < KT * kCols; e += kCoreThreads) {
        const int kk = e / kCols, c = e % kCols;
        const int k = k0 + kk;
        const int col = (c / DH) * W + h * DH + (c % DH);
        w_s[kk * kCols + c] = k < W ? to_f(a.w_qkv[static_cast<size_t>(k) * 3 * W + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float av[4], bv[kNj];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = y_s[(rg + 16 * i) * (KT + 1) + kk];
#pragma unroll
        for (int j = 0; j < kNj; ++j) bv[j] = w_s[kk * kCols + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kNj; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + rg + 16 * i;
      if (t >= T_) continue;
#pragma unroll
      for (int j = 0; j < kNj; ++j) {
        const int c = cg + 16 * j;
        const int part = c / DH, d = c % DH;
        float val = acc[i][j] + a.b_qkv[part * W + h * DH + d];
        if (Cfg::kSwitches) {
          if (part == 0 && fold_q) val *= fold;
          if (part > 0 && zero_kv && t >= valid) val = 0.f;
          if (part < 2 && qk_round) val = round_to<T>(val);
        }
        if (part == 2) val = round_to<T>(val);  // v in the compute dtype
        ws_q[part * part_stride + static_cast<size_t>(t) * ld + d] = val;
      }
    }
  }
  __syncthreads();  // makes the q, k, v writes visible to the whole block

  // Attention over 64-row query tiles.  Which keys take the valid select:
  // all (K2), only the last key tile's (tail), none (zerokv: pad k are 0).
  const int n_last = (T_ - 1) / Tile::kKeys * Tile::kKeys;
  auto select_to = [&](int kt0) {
    if (!Cfg::kSwitches || sw.mask == kMaskFull) return valid;
    if (sw.mask == kMaskTail) return kt0 == n_last ? valid : T_;
    return T_;
  };
  const int split0 = T_ / 128 * 128;  // tail_split's boundary
  float* Q_s = stage;
  float* K_s = Q_s + Tile::kRows * Tile::kLd;
  float* V_s = K_s + Tile::kKeys * Tile::kLd;
  float* P_s = Cfg::kSmemQkv ? stage : V_s + Tile::kKeys * Tile::kLd;
  auto stage_keys = [&](int kt0, bool with_v) {  // K_s, V_s of keys kt0 .. kt0 + 63
    if (Cfg::kSmemQkv) {
      K_s = ws_k + kt0 * ld;
      V_s = ws_v + kt0 * ld;
      return;
    }
    for (int e = tid; e < Tile::kKeys * DH; e += kCoreThreads) {
      const int r = e / DH, d = e % DH;
      const bool in = kt0 + r < T_;
      const size_t off = static_cast<size_t>(kt0 + r) * DH + d;
      K_s[r * Tile::kLd + d] = in ? ws_k[off] : 0.f;
      if (with_v) V_s[r * Tile::kLd + d] = in ? ws_v[off] : 0.f;
    }
    __syncthreads();
  };
  for (int q0 = 0; q0 < T_; q0 += Tile::kRows) {
    if (Cfg::kSmemQkv) {
      Q_s = ws_q + q0 * ld;
    } else {
      for (int e = tid; e < Tile::kRows * DH; e += kCoreThreads) {
        const int r = e / DH, d = e % DH;
        Q_s[r * Tile::kLd + d] =
            q0 + r < T_ ? ws_q[static_cast<size_t>(q0 + r) * DH + d] : 0.f;
      }
    }
    Tile tile;
    tile.init();
    if constexpr (Cfg::kForm == kOnline) {
      Tile tail;
      if (Cfg::kTailSplit) tail.init();
      for (int kt0 = 0; kt0 < T_; kt0 += Tile::kKeys) {
        stage_keys(kt0, true);
        if (Cfg::kTailSplit && kt0 >= split0)
          tail.step(Q_s, K_s, V_s, P_s, kt0, T_, select_to(kt0), scale, rg, cg);
        else
          tile.step(Q_s, K_s, V_s, P_s, kt0, T_, select_to(kt0), scale, rg, cg);
      }
      if (Cfg::kTailSplit) tile.merge(tail);
    } else {
      for (int kt0 = 0; kt0 < T_; kt0 += Tile::kKeys) {
        stage_keys(kt0, false);
        tile.scan(Q_s, K_s, kt0, T_, select_to(kt0), scale, rg, cg);
      }
      for (int kt0 = 0; kt0 < T_; kt0 += Tile::kKeys) {
        stage_keys(kt0, true);
        tile.accumulate(Q_s, K_s, V_s, P_s, kt0, T_, select_to(kt0), scale, rg, cg);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + rg + 16 * i;
      if (t >= T_) continue;
      float l = tile.l[i];
      if (zero_kv) l -= static_cast<float>(T_ - valid) * exp2f(-tile.m[i]);
      const float inv_l = 1.f / l;
#pragma unroll
      for (int j = 0; j < Tile::kDj; ++j) {
        const int d = cg + 16 * j;
        const float o = Cfg::kForm == kNormalized ? tile.o[i][j] : tile.o[i][j] * inv_l;
        const size_t off = (static_cast<size_t>(b) * T_ + t) * W + h * DH + d;
        if (Cfg::kF32Out)
          static_cast<float*>(a.attn)[off] = o;
        else
          static_cast<T*>(a.attn)[off] = from_f<T>(o);
      }
    }
  }
  if (Cfg::kSmemQkv) __syncthreads();  // the next head overwrites the resident q, k, v
}

// INTERLEAVED: part[g][b, t, :] = attn[b, t, cols of group g] @ w_out[those rows, :],
// 64 x 64 output tiles, f32 sums over the group's gw = group * DH columns.
template <typename T>
__device__ __forceinline__ void core_group_out_proj(const CoreArgs<T>& a, int b, int g, int gw,
                                                    float* smem) {
  float (*a_s)[33] = reinterpret_cast<float (*)[33]>(smem);            // [64][33]
  float (*w_s)[64] = reinterpret_cast<float (*)[64]>(smem + 64 * 33);  // [32][64]
  const int T_ = a.T, W = a.W;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const T* ab = static_cast<const T*>(a.attn) + static_cast<size_t>(b) * T_ * W + g * gw;
  const T* wb = a.w_out + static_cast<size_t>(g) * gw * W;
  float* pb = a.part + (static_cast<size_t>(g) * a.B + b) * T_ * W;
  for (int t0 = 0; t0 < T_; t0 += 64) {
    for (int c0 = 0; c0 < W; c0 += 64) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < gw; k0 += 32) {
        for (int e = tid; e < 64 * 32; e += kCoreThreads) {
          const int r = e / 32, kk = e % 32;
          const int t = t0 + r, k = k0 + kk;
          a_s[r][kk] = (t < T_ && k < gw) ? to_f(ab[static_cast<size_t>(t) * W + k]) : 0.f;
        }
        for (int e = tid; e < 32 * 64; e += kCoreThreads) {
          const int kk = e / 64, c = e % 64;
          const int k = k0 + kk, n = c0 + c;
          w_s[kk][c] = (k < gw && n < W) ? to_f(wb[static_cast<size_t>(k) * W + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < 32; ++kk) {
          float av[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = a_s[rg + 16 * i][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = w_s[kk][cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + rg + 16 * i;
        if (t >= T_) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = c0 + cg + 16 * j;
          if (n < W) pb[static_cast<size_t>(t) * W + n] = acc[i][j];
        }
      }
    }
  }
}

// One work item of the core: batch row b, heads g * group .. g * group + group - 1.
template <typename T, int DH, typename Cfg>
__device__ __forceinline__ void attn_core_item(const CoreArgs<T>& a, const CoreSwitches& sw, int b,
                                               int g, float* smem) {
  using Smem = CoreSmem<DH, Cfg>;
  const int group = Cfg::kSwitches ? sw.group : 1;
  float* mean_s = smem + Smem::resident(a.T) + Smem::kUnion;  // [T]
  float* rstd_s = mean_s + a.T;                               // [T]
  ln_stats_rows(a.x + static_cast<size_t>(b) * a.T * a.W, a.T, a.W, a.eps,
                Cfg::kSwitches && sw.ln1pass, mean_s, rstd_s);
  __syncthreads();
  for (int hh = 0; hh < group; ++hh)
    attn_core_head<T, DH, Cfg>(a, sw, b, g * group + hh, smem, mean_s, rstd_s);
  if (Cfg::kInterleaved) {
    __syncthreads();  // this block's attn writes are visible to it after the barrier
    core_group_out_proj(a, b, g, group * DH, smem);
  }
  __syncthreads();  // the next item reuses the shared memory
}

// The core as its own launch: one block per (batch row, head group).  The
// pointers come as __restrict__ parameters (not inside CoreArgs) so that the
// compiler may take the read-only inputs through the non-coherent cache and
// move their loads past the workspace's stores, as it did when K2's core had
// its own kernel.
template <typename T, int DH, typename Cfg>
__global__ void __launch_bounds__(kCoreThreads)
attn_core_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const T* __restrict__ w_qkv,
                 const float* __restrict__ b_qkv, float* ws, void* __restrict__ attn,
                 const T* __restrict__ w_out, float* __restrict__ part, int B, int H, int T_,
                 int W, int valid, float eps, CoreSwitches sw) {
  extern __shared__ __align__(16) float smem[];
  const CoreArgs<T> a{x, gamma, beta, w_qkv, b_qkv, ws, attn, w_out, part, B, H, T_, W, valid, eps};
  const int groups = H / (Cfg::kSwitches ? sw.group : 1);
  attn_core_item<T, DH, Cfg>(a, sw, blockIdx.x / groups, blockIdx.x % groups, smem);
}

template <typename T, int DH, typename Cfg>
inline void launch_attn_core(const CoreArgs<T>& a, const CoreSwitches& sw, int blocks, size_t smem,
                             cudaStream_t stream) {
  attn_core_kernel<T, DH, Cfg><<<blocks, kCoreThreads, smem, stream>>>(
      a.x, a.gamma, a.beta, a.w_qkv, a.b_qkv, a.ws, a.attn, a.w_out, a.part, a.B, a.H, a.T, a.W, a.valid,
      a.eps, sw);
}

}  // namespace tapclip
