// S3 and S4, the attention half-block's A/B variants, as K2's own launches
// on the tensor cores (attn_block.cu: LayerNorm rows, the QKV product into an
// f32 workspace, the attention walk, the out-projection; the launcher is
// attn_variants.cu).  Each switch of scripts/attn_kernel_ab.py and
// scripts/attn_softmax_ab.py is a template or runtime parameter of one of
// the four:
//   LayerNorm  ln1pass: var = E[x^2] - mean^2 (ln_rows.cuh's ONE_PASS).
//   QKV        K2's product as it is (kQkv: q and k f32, v rounded).
//   walk       this header: K2's tile walk (attn_core_mma.cuh: 64-key tiles,
//              mma.sync m16n8k16, f32 values split once per block into
//              three bf16 term planes) with
//     FORM        kOnline: K2's softmax (exp2 in the log2 domain, l over the
//                 unrounded p, 1/l after p . v);
//                 kNormalized: exp of s Dh^-1/2 - m and p = p / l BEFORE p
//                 is rounded and multiplied by v (S3's softmax_opt=False and
//                 the interleaved kernel).  l is known only after the last
//                 key tile, so the walk takes two passes over the keys: the
//                 first carries m and l online, the second recomputes q . k^T
//                 (six MMAs a product again in f32) and forms p . v;
//                 kBf16Exp: p = bf16(exp(bf16(bf16(s - m) bf16(ln 2)))) against
//                 the row's final max (XLA's exp2 of a bf16 value), l over
//                 those values: a first pass finds m.
//     QK          the bf16 terms of q and k: 3, or 1 where the variant rounds
//                 them to bf16 (qk_round: S3 without perhead_qkv, S4's
//                 qk_cast), a one-term split of the f32 value being its
//                 rounding (one MMA a product).  In f32 qk_round changes
//                 nothing.
//     fold        (runtime) q times Dh^-1/2 log2 e where the walk stages it,
//                 in f32 before the rounding, the scores not scaled again.
//     zerokv      (runtime) mask_mode "zerokv": pad rows of k and v staged
//                 as zeros, the keys walked to T with no select (a pad key
//                 scores exactly 0 and takes part in m), then
//                 l -= n_pad exp2(-m).  mask_mode "tail" selects only in the
//                 last 64-key tile, where the wrapper lets it run: that is
//                 where K2's walk selects, so tail is the full mask here.
//     sum_rounded (runtime) l sums p after its rounding to the dtype (sum_mxu).
//     TAIL_SPLIT  two online states, over the key tiles before and from
//                 (T / 128) 128, merged at the end.
//     group       (runtime) heads per block: a block walks `group` heads of
//                 its query tile one after the other, a schedule switch.
//              perhead_qkv (smem_qkv) replaces the QKV launch and the
//              workspace: perhead_kernel, one block per (batch row, head
//              group), projects its head's k and v for all T rows, then q for
//              128 rows at a time, on the tensor cores (gemm_mma.cuh's
//              warp_stage on the terms and order of K2's product, so q, k, v
//              equal K2's workspace) into f32 rows in shared memory, and walks
//              them, each warp splitting the fragments it reads
//              (flash_mma.cuh's warp_abt, warp_pv: the terms of K2's planes).
//              Two [ceil64(T), Dh + 4] f32 planes of k and v and the
//              projection's staging take 218,624 bytes at T 320 in f32, the
//              largest T a block's 232,448 bytes hold; past it the wrapper
//              refuses.
//   out-projection  K2's (kResidual), or for interleaved a deterministic split
//              of its depth in H / group parts (gemm_mma.cuh's kStore, part g
//              over head group g's rows of w_out), summed in group order.
//
// The arithmetic of every variant is ops/fused_mha.py::
// attn_block_variant_reference's; the card's split products are emulated by
// scripts/split_error.py::emulate_attn_variant.  The online form with no
// switch that changes a value in the dtype is K2's arithmetic, and the
// launcher runs K2's own code for it: tapclip_attn_block, or with group > 1
// K2's tile function (attn_core_tile) over the block's heads.  No atomics: a
// call repeats bit for bit.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "attn_core_mma.cuh"
#include "common.cuh"
#include "flash_mma.cuh"
#include "gemm_mma.cuh"

// Kernels in a header sit in a named namespace: nvcc's host stub cannot name
// a kernel in an anonymous namespace nested in a named one.
namespace tapclip {
namespace attnv {

using namespace tapclip::mma;
using bf16 = __nv_bfloat16;

enum Form { kOnline = 0, kNormalized = 1, kBf16Exp = 2 };

constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16
constexpr int kDh = 64;                  // head dim of the variants (ViT-B/16, ViT-L/14)
constexpr int kRows = kTile;             // query rows of a walk block (four warps)
constexpr int kWalkThreads = 2 * kRows;
constexpr int kLd = tile_ld<bf16, kDh>();
constexpr int kPlane = kTile * kLd;      // one bf16 plane of a [64, Dh] tile
constexpr int kRld = tile_ld<float, kDh>();  // row stride of perhead's f32 rows
constexpr int kPerheadThreads = gemm::kThreads;
constexpr int kPerheadRows = 2 * kTile;  // query rows of a perhead pass: eight warps of 16

// The runtime switches of the walk.
struct Switches {
  int fold, zerokv, sum_rounded;
};

// The arguments of a walk launch (attn_variants.cu fills it).
struct WalkCall {
  const float* qkv;    // K2's f32 workspace [B T, 3W] (null with resident)
  const void* y;       // resident: LN(x) [B T, W] of the dtype
  const void* w_qkv;   // resident
  const float* b_qkv;  // resident
  void* out;           // the attention output [B T, W] of the dtype
  int B, H, T, W, valid, group;
  int form, qk1, tail_split, resident, k2;  // k2: K2's own tile function over the group
  Switches sw;
  int dtype;  // 0 float32, 1 bfloat16
  cudaStream_t stream;
};

// The walk launchers, one per source file (attn_variants_online.cu,
// attn_variants_two_pass.cu).
cudaError_t launch_online_walk(const WalkCall& c);
cudaError_t launch_two_pass_walk(const WalkCall& c);

// --- one warp's softmax over its 16 query rows --------------------------------

// s *= scale; where the tile reaches them, keys at or past T at -inf and keys
// at or past mask_to at -1e30 (K2's per-key tests); mt: this lane's row maxima.
__device__ __forceinline__ void scale_mask(float (&s)[kTile / 8][4], float (&mt)[2], int kt0, int T_, int mask_to,
                                           float scale) {
  const int lane = threadIdx.x & 31;
  mt[0] = mt[1] = -INFINITY;
  if (kt0 + kTile > min(mask_to, T_)) {
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + 8 * n + 2 * (lane & 3) + (e & 1);
        float x = s[n][e] * scale;
        if (key >= T_) x = -INFINITY;
        else if (key >= mask_to) x = kNegBig;
        s[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
  } else {
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[n][e]);
      }
  }
}

// The state of a warp's two rows a lane (g and g + 8): max m, this lane's
// share of the row sum l, the output accumulators o.
template <typename PT>
struct Rows {
  float m[2], l[2], o[kDh / 8][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
    zero(o);
  }

  // The online form over one key tile: s becomes p = exp2(s - m).  l alpha
  // and the row's first p are summed in one fma, as nvcc contracts them in
  // K2's walk (attn_core_mma.cuh).  Written out: left to the compiler, the
  // sum_rounded branch in bf16 kept them apart, one rounding of l off K2's.
  __device__ __forceinline__ void online(float (&s)[kTile / 8][4], const float (&mt)[2], bool sum_rounded) {
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));  // finite: key 0 is below T
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        const float add = sum_rounded ? round_to<PT>(p) : p;
        l[e >> 1] = n == 0 && (e & 1) == 0 ? __fmaf_rn(l[e >> 1], alpha[e >> 1], add) : l[e >> 1] + add;
        s[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
  }

  // Pass 1 of a two-pass form over one key tile: m, and for kNormalized l
  // of exp(s - m) carried online.
  template <int FORM>
  __device__ __forceinline__ void scan(const float (&s)[kTile / 8][4], const float (&mt)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));
      if (FORM == kNormalized) l[r] *= expf(m[r] - m_new);
      m[r] = m_new;
    }
    if (FORM == kNormalized) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += expf(s[n][e] - m[e >> 1]);
    }
  }

  // Pass 2 over one key tile, against the final m (and, kNormalized, the
  // whole row sum l): s becomes p; kBf16Exp sums l.
  template <int FORM>
  __device__ __forceinline__ void probs(float (&s)[kTile / 8][4]) {
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e] - m[e >> 1];
        float p;
        if (FORM == kNormalized) {
          p = __fdiv_rn(expf(x), l[e >> 1]);
        } else {  // XLA's exp2 of a bf16 value: exp(bf16(x * bf16(ln 2))), rounded
          p = round_to<bf16>(expf(round_to<bf16>(round_to<bf16>(x) * kLn2Bf16)));
          l[e >> 1] += p;
        }
        s[n][e] = p;
      }
  }

  // Join the online state b over key tiles disjoint from this one's.
  __device__ __forceinline__ void merge(const Rows& b) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], b.m[r]);
      const float a0 = exp2f(m[r] - m_new), a1 = exp2f(b.m[r] - m_new);
      m[r] = m_new;
      l[r] = l[r] * a0 + b.l[r] * a1;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        o[n][2 * r] = o[n][2 * r] * a0 + b.o[n][2 * r] * a1;
        o[n][2 * r + 1] = o[n][2 * r + 1] * a0 + b.o[n][2 * r + 1] * a1;
      }
    }
  }
};

// The walk of one warp's 16 query rows (out_rows: its first row's output at
// out + row * W) over the key tiles, every thread of the block calling it
// (ops.stage is the block's).  Ops: PlaneOps (K2's workspace, split once per
// block into term planes) or RowOps (perhead's f32 rows in shared memory).
template <typename PT, int FORM, bool TAIL_SPLIT, typename Ops>
__device__ __forceinline__ void walk(const Ops& ops, bool active, int T_, int valid, const Switches& sw,
                                     PT* __restrict__ out, int W, int row) {
  constexpr int kVT = kIsF32<PT> ? kF32Terms : 1;         // v holds values of PT
  constexpr int kPT = FORM == kBf16Exp ? 1 : kVT;          // p: rounded to PT, or a bf16 value
  constexpr int kPasses = FORM == kOnline ? 1 : 2;
  const bool zkv = sw.zerokv;
  const int mask_to = zkv ? T_ : valid;  // keys at or past it take -1e30
  const int n_tiles = ((zkv ? T_ : valid) + kTile - 1) / kTile;  // tiles wholly past valid add nothing
  const int split0 = T_ / 128 * 128;  // tail_split's boundary
  const float scale = sw.fold ? 1.f
                              : (FORM == kNormalized ? rsqrtf(static_cast<float>(kDh))
                                                     : rsqrtf(static_cast<float>(kDh)) * kLog2e);
  Rows<PT> a, b;
  a.init();
  if (TAIL_SPLIT) b.init();
  for (int pass = 0; pass < kPasses; ++pass) {
    const bool last = pass + 1 == kPasses;
    for (int j = 0; j < n_tiles; ++j) {
      ops.stage(pass + j > 0, j, last);
      if (!active) continue;
      float s[kTile / 8][4], mt[2];
      ops.scores(s, j);
      scale_mask(s, mt, j * kTile, T_, mask_to, scale);
      if constexpr (FORM == kOnline) {
        if (TAIL_SPLIT && j * kTile >= split0) {
          b.online(s, mt, sw.sum_rounded);
          ops.template pv<kPT>(b.o, s, j);
        } else {
          a.online(s, mt, sw.sum_rounded);
          ops.template pv<kPT>(a.o, s, j);
        }
      } else if (!last) {
        a.template scan<FORM>(s, mt);
      } else {
        a.template probs<FORM>(s);
        ops.template pv<kPT>(a.o, s, j);
      }
    }
    if (FORM == kNormalized && !last && active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) a.l[r] = quad_sum(a.l[r]);
    }
  }
  if (!active) return;
  if (TAIL_SPLIT) a.merge(b);
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (FORM == kNormalized) {
      inv_l[r] = 1.f;  // p was divided by l before p . v
    } else {
      float l = quad_sum(a.l[r]);
      if (FORM == kOnline && zkv) l -= static_cast<float>(T_ - valid) * exp2f(-a.m[r]);
      inv_l[r] = 1.f / l;
    }
  }
  store_rows<PT, kDh>(out, W, row, T_, a.o, inv_l);
}

// --- the workspace walk: K2's f32 qkv split into term planes ---------------------

// Q, K and V as bf16 term planes in shared memory (QK of q and k, VT of v),
// each key tile's K and V split by the block from the workspace rows (row
// stride st), rows at or past kv_rows as zeros.
template <int QK, int VT>
struct PlaneOps {
  bf16 *Q_s, *K_s, *V_s;
  const float *k, *v;
  int st, kv_rows, r0;

  __device__ __forceinline__ void stage(bool again, int j, bool with_v) const {
    if (again) __syncthreads();  // every warp is done with the last tile's planes
    split_rows<kDh, kTile, QK, kWalkThreads>(K_s, kPlane, k, st, j * kTile, kv_rows);
    if (with_v) split_rows<kDh, kTile, VT, kWalkThreads>(V_s, kPlane, v, st, j * kTile, kv_rows);
    __syncthreads();
  }
  __device__ __forceinline__ void scores(float (&s)[kTile / 8][4], int) const {
    warp_abt_planes<kDh, kTile, QK, QK>(s, Q_s, kPlane, r0, K_s, kPlane, 0);
  }
  template <int NTP>
  __device__ __forceinline__ void pv(float (&o)[kDh / 8][4], const float (&p)[kTile / 8][4], int) const {
    warp_pv_planes<kDh, kTile, NTP, VT>(o, p, V_s, kPlane, 0);
  }
};

// Q's NT planes of the rows q0.. of the workspace (zeros past T), each value
// times f first (the fold, or 1), rounded once in f32.
template <int NT>
__device__ __forceinline__ void stage_q(bf16* Q_s, const float* __restrict__ q, int st, int q0, int T_, float f) {
  constexpr int kChunks = kDh / 4;  // 16-byte chunks of a row
#pragma unroll 4
  for (int c = threadIdx.x; c < kRows * kChunks; c += kWalkThreads) {
    const int r = c / kChunks, e = (c % kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < T_) {
      v = *reinterpret_cast<const float4*>(q + static_cast<size_t>(q0 + r) * st + e);
      v = make_float4(__fmul_rn(v.x, f), __fmul_rn(v.y, f), __fmul_rn(v.z, f), __fmul_rn(v.w, f));
    }
    uint32_t lo[NT][1], hi[NT][1];
    split_into(v.x, v.y, lo, 0);
    split_into(v.z, v.w, hi, 0);
#pragma unroll
    for (int i = 0; i < NT; ++i)
      *reinterpret_cast<uint2*>(Q_s + i * kPlane + r * kLd + e) = make_uint2(lo[i][0], hi[i][0]);
  }
}

// Bytes of shared memory of a walk block: QK planes of q and k, VT of v.
template <typename PT, int QK>
__host__ __device__ constexpr size_t walk_smem() {
  return static_cast<size_t>(2 * QK + (kIsF32<PT> ? kF32Terms : 1)) * kPlane * sizeof(bf16);
}

// One block per (batch row, head group, 64-row query tile), four warps, the
// group's heads one after the other.
template <typename PT, int FORM, int QK, bool TAIL_SPLIT>
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const float* __restrict__ qkv, PT* __restrict__ out, int H, int T_, int W, int valid, int group,
            Switches sw) {
  constexpr int kVT = kIsF32<PT> ? kF32Terms : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Q_s = reinterpret_cast<bf16*>(smem_raw);
  const int groups = H / group;
  const int b = blockIdx.x / groups, q0 = blockIdx.y * kRows;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int st = 3 * W;
  const float f = sw.fold ? rsqrtf(static_cast<float>(kDh)) * kLog2e : 1.f;
  for (int hh = 0; hh < group; ++hh) {
    const int h = (blockIdx.x % groups) * group + hh;
    if (hh > 0) __syncthreads();  // every warp is done with the last head's planes
    const float* q = qkv + static_cast<size_t>(b) * T_ * st + h * kDh;
    const PlaneOps<QK, kVT> ops{Q_s, Q_s + QK * kPlane, Q_s + 2 * QK * kPlane, q + W, q + 2 * W, st,
                                sw.zerokv ? valid : T_, r0};
    stage_q<QK>(Q_s, q, st, q0, T_, f);
    walk<PT, FORM, TAIL_SPLIT>(ops, q0 + r0 < T_, T_, valid, sw, out + static_cast<size_t>(b) * T_ * W + h * kDh,
                               W, q0 + r0);
  }
}

template <typename PT, int FORM, int QK, bool TAIL_SPLIT>
cudaError_t launch_walk(const WalkCall& c) {
  constexpr size_t smem = walk_smem<PT, QK>();
  auto kernel = walk_kernel<PT, FORM, QK, TAIL_SPLIT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(c.B * (c.H / c.group), (c.T + kRows - 1) / kRows);
  kernel<<<grid, kWalkThreads, smem, c.stream>>>(c.qkv, static_cast<PT*>(c.out), c.H, c.T, c.W, c.valid, c.group,
                                                 c.sw);
  return cudaGetLastError();
}

// --- K2's own tile function over a head group ----------------------------------

template <typename PT, int ROWS>
__global__ void __launch_bounds__(2 * ROWS)
k2_group_kernel(const float* __restrict__ qkv, PT* __restrict__ out, int H, int T_, int W, int valid, int group) {
  const int groups = H / group;
  for (int hh = 0; hh < group; ++hh) {
    if (hh > 0) __syncthreads();  // every warp is done with the last head's planes
    attn::attn_core_tile<float, PT, PT, kDh, ROWS, false, false>(qkv, out, nullptr, T_, W, valid,
                                                                 blockIdx.x / groups,
                                                                 (blockIdx.x % groups) * group + hh,
                                                                 blockIdx.y * ROWS);
  }
}

template <typename PT, int ROWS>
cudaError_t launch_k2_rows(const WalkCall& c) {
  const size_t smem = attn::core_smem<float, PT, kDh, ROWS>(c.T);
  auto kernel = k2_group_kernel<PT, ROWS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(c.B * (c.H / c.group), (c.T + ROWS - 1) / ROWS);
  kernel<<<grid, 2 * ROWS, smem, c.stream>>>(c.qkv, static_cast<PT*>(c.out), c.H, c.T, c.W, c.valid, c.group);
  return cudaGetLastError();
}

// The query-tile height of K2's launch (launch_core_rows).
template <typename PT>
cudaError_t launch_k2_group(const WalkCall& c) {
  if (c.T <= 32) return launch_k2_rows<PT, 16>(c);
  if (c.T <= 128) return launch_k2_rows<PT, 32>(c);
  return launch_k2_rows<PT, 64>(c);
}

// --- perhead_qkv: the head's q, k, v projected into shared memory -------------

// acc (zeroed) = rows [t0, t0 + BM) of y (zeros past T, row stride W) times
// the columns c0 .. c0 + BN / 2 and c1 .. c1 + BN / 2 of w (row stride ldw)
// over the depth W: one kBK-deep stage at a time, staged by the block into
// `stage` (f32 split into three bf16 planes, bf16 as it is) and multiplied
// by gemm_mma.cuh's warp_stage, the terms and order of K2's QKV product.
// The next stage's 16-byte chunks are loaded into registers while this
// stage's products run (one buffer of planes: the staging fits beside k's
// and v's rows).  All kPerheadThreads threads call it; it starts and ends
// with a barrier.
template <typename PT, int BM, int BN>
__device__ __forceinline__ void project(gemm::Acc<BM, BN>& acc, const PT* __restrict__ y, int T_, int W, int t0,
                                        const PT* __restrict__ w, int ldw, int c0, int c1, bf16* stage) {
  using Chunk = typename std::conditional<kIsF32<PT>, float4, uint4>::type;  // 16 bytes of PT
  constexpr int NP = kIsF32<PT> ? kF32Terms : 1;
  constexpr int kAPlane = gemm::a_plane<BM, false>(), kBPlane = gemm::b_plane<BN, false>();
  constexpr int kBLd = tile_ld<bf16, BN>();
  constexpr int kE = 16 / static_cast<int>(sizeof(PT));  // elements of a chunk
  constexpr int kAV = BM * gemm::kBK / kE / kPerheadThreads, kBV = gemm::kBK * BN / kE / kPerheadThreads;
  static_assert(kAV * kE * kPerheadThreads == BM * gemm::kBK && kBV * kE * kPerheadThreads == gemm::kBK * BN,
                "whole chunks a thread");
  bf16* a_s = stage;
  bf16* b_s = stage + NP * kAPlane;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / gemm::Warps<BM, BN>::kN, wn = warp % gemm::Warps<BM, BN>::kN;
  Chunk ra[kAV], rb[kBV];
  auto a_rc = [](int it, int& r, int& c) {
    const int i = threadIdx.x + it * kPerheadThreads;
    r = i / (gemm::kBK / kE);
    c = (i % (gemm::kBK / kE)) * kE;
  };
  auto b_rc = [](int it, int& r, int& c) {
    const int i = threadIdx.x + it * kPerheadThreads;
    r = i / (BN / kE);
    c = (i % (BN / kE)) * kE;
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kAV; ++it) {
      int r, c;
      a_rc(it, r, c);
      const bool in = t0 + r < T_;
      ra[it] = in ? __ldg(reinterpret_cast<const Chunk*>(y + static_cast<size_t>(t0 + r) * W + k0 + c)) : Chunk{};
    }
#pragma unroll
    for (int it = 0; it < kBV; ++it) {
      int r, c;
      b_rc(it, r, c);
      rb[it] = __ldg(reinterpret_cast<const Chunk*>(w + static_cast<size_t>(k0 + r) * ldw +
                                                    (c < BN / 2 ? c0 + c : c1 + c - BN / 2)));
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int it = 0; it < kAV; ++it) {
      int r, c;
      a_rc(it, r, c);
      if constexpr (kIsF32<PT>) {
        gemm::split4(ra[it], a_s + r * gemm::kALd + c, kAPlane);
      } else {
        *reinterpret_cast<uint4*>(a_s + r * gemm::kALd + c) = ra[it];
      }
    }
#pragma unroll
    for (int it = 0; it < kBV; ++it) {
      int r, c;
      b_rc(it, r, c);
      if constexpr (kIsF32<PT>) {
        gemm::split4(rb[it], b_s + r * kBLd + c, kBPlane);
      } else {
        *reinterpret_cast<uint4*>(b_s + r * kBLd + c) = rb[it];
      }
    }
  };
  fetch(0);
  __syncthreads();  // the caller is done with the region
  put();
  __syncthreads();
  for (int k0 = 0; k0 < W; k0 += gemm::kBK) {
    const bool more = k0 + gemm::kBK < W;
    if (more) fetch(k0 + gemm::kBK);  // in flight during this stage's products
    gemm::warp_stage<BM, BN, NP, false, false, NP>(acc, a_s, b_s, wm, wn);
    __syncthreads();  // every warp is done with this stage; at the end, the region is free for the caller
    if (more) {
      put();
      __syncthreads();
    }
  }
}

// f(row, col, v0, v1) for each pair of a warp's accumulators (gemm_mma.cuh's
// epilogue layout: columns col and col + 1 of row `row` of the tile).
template <int BM, int BN, typename F>
__device__ __forceinline__ void each_pair(const gemm::Acc<BM, BN>& acc, F f) {
  using Wp = gemm::Warps<BM, BN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / Wp::kN, wn = warp % Wp::kN;
#pragma unroll
  for (int i = 0; i < Wp::MT; ++i)
#pragma unroll
    for (int j = 0; j < Wp::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(wm * Wp::WM + 16 * i + (lane >> 2) + 8 * h, wn * Wp::WN + 8 * j + 2 * (lane & 3), acc[i][j][2 * h],
          acc[i][j][2 * h + 1]);
}

// A warp's products over perhead's resident f32 rows, split into bf16 terms
// fragment by fragment (VT terms of v).
template <int VT>
struct RowOps {
  const float *Q_r, *K_r, *V_r;
  int r0;

  __device__ __forceinline__ void stage(bool, int, bool) const {}
  __device__ __forceinline__ void scores(float (&s)[kTile / 8][4], int j) const {
    warp_abt<float, kDh, kTile>(s, Q_r, r0, K_r, j * kTile);
  }
  template <int NTP>
  __device__ __forceinline__ void pv(float (&o)[kDh / 8][4], const float (&p)[kTile / 8][4], int j) const {
    warp_pv<float, kDh, kTile, NTP, VT>(o, p, V_r, j * kTile);
  }
};

// Bytes of the region after perhead's k and v rows: the projection's staging
// (K|V tiles of 64 x 128, q tiles of 128 x 64), then q's f32 rows.
template <typename PT>
__host__ __device__ constexpr size_t perhead_region() {
  constexpr int NP = kIsF32<PT> ? kF32Terms : 1;
  constexpr size_t kv = NP * (gemm::a_plane<kTile, false>() + gemm::b_plane<2 * kDh, false>()) * sizeof(bf16);
  constexpr size_t q = NP * (gemm::a_plane<kPerheadRows, false>() + gemm::b_plane<kDh, false>()) * sizeof(bf16);
  constexpr size_t rows = kPerheadRows * kRld * sizeof(float);
  return kv > q ? (kv > rows ? kv : rows) : (q > rows ? q : rows);
}

template <typename PT>
__host__ __device__ constexpr size_t perhead_smem(int T_) {
  return 2 * static_cast<size_t>((T_ + kTile - 1) / kTile * kTile) * kRld * sizeof(float) + perhead_region<PT>();
}

// One block per (batch row, head group), eight warps.  Per head: k and v
// (v rounded to PT) for every row into K_r, V_r (zero rows up to ceil64(T)),
// then per 128 query rows q into Q_r and the walk, a warp's 16 rows each.
template <typename PT, int FORM>
__global__ void __launch_bounds__(kPerheadThreads)
perhead_kernel(const PT* __restrict__ y, const PT* __restrict__ w_qkv, const float* __restrict__ b_qkv,
               PT* __restrict__ out, int H, int T_, int W, int valid, int group, Switches sw) {
  constexpr int kVT = kIsF32<PT> ? kF32Terms : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Tp = (T_ + kTile - 1) / kTile * kTile;
  float* K_r = reinterpret_cast<float*>(smem_raw);
  float* V_r = K_r + Tp * kRld;
  float* Q_r = V_r + Tp * kRld;  // the region: the projection's planes, then q's rows
  bf16* stage = reinterpret_cast<bf16*>(Q_r);
  const int groups = H / group, b = blockIdx.x / groups;
  const PT* yb = y + static_cast<size_t>(b) * T_ * W;
  const int r0 = (threadIdx.x >> 5) * 16;
  for (int hh = 0; hh < group; ++hh) {
    const int h = (blockIdx.x % groups) * group + hh;
    for (int t0 = 0; t0 < Tp; t0 += kTile) {
      gemm::Acc<kTile, 2 * kDh> acc = {};
      project<PT, kTile, 2 * kDh>(acc, yb, T_, W, t0, w_qkv, 3 * W, W + h * kDh, 2 * W + h * kDh, stage);
      each_pair<kTile, 2 * kDh>(acc, [&](int r, int c, float v0, float v1) {
        const bool in = t0 + r < T_;
        const int part = c / kDh, d = c % kDh;  // 0: k, 1: v
        const float* bias = b_qkv + (1 + part) * W + h * kDh + d;
        v0 = in ? v0 + bias[0] : 0.f;
        v1 = in ? v1 + bias[1] : 0.f;
        if (part == 1) {
          v0 = round_to<PT>(v0);
          v1 = round_to<PT>(v1);
        }
        *reinterpret_cast<float2*>((part == 0 ? K_r : V_r) + (t0 + r) * kRld + d) = make_float2(v0, v1);
      });
    }
    for (int q0 = 0; q0 < T_; q0 += kPerheadRows) {
      gemm::Acc<kPerheadRows, kDh> acc = {};
      project<PT, kPerheadRows, kDh>(acc, yb, T_, W, q0, w_qkv, 3 * W, h * kDh, h * kDh + kDh / 2, stage);
      each_pair<kPerheadRows, kDh>(acc, [&](int r, int c, float v0, float v1) {
        *reinterpret_cast<float2*>(Q_r + r * kRld + c) = make_float2(v0 + b_qkv[h * kDh + c],
                                                                     v1 + b_qkv[h * kDh + c + 1]);
      });
      __syncthreads();  // q's rows, and k's and v's, are in place
      const RowOps<kVT> ops{Q_r, K_r, V_r, r0};
      walk<PT, FORM, false>(ops, q0 + r0 < T_, T_, valid, sw, out + static_cast<size_t>(b) * T_ * W + h * kDh, W,
                            q0 + r0);
    }
  }
}

template <typename PT, int FORM>
cudaError_t launch_perhead(const WalkCall& c) {
  const size_t smem = perhead_smem<PT>(c.T);
  auto kernel = perhead_kernel<PT, FORM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<c.B * (c.H / c.group), kPerheadThreads, smem, c.stream>>>(
      static_cast<const PT*>(c.y), static_cast<const PT*>(c.w_qkv), c.b_qkv, static_cast<PT*>(c.out), c.H, c.T,
      c.W, c.valid, c.group, c.sw);
  return cudaGetLastError();
}

}  // namespace attnv
}  // namespace tapclip
