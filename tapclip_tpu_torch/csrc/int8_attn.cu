// B14: int8 W8A8 attention half-block of the frozen-tower eval path,
//   out = x + dequant(int8(attn(split(dequant(int8(LN(x)) . Wqkv_q) + b_qkv))) . Wout_q) + b_out,
// keys at or past `valid` masked, never causal.
//
// Replaces tapclip_tpu/ops/int8_attn.py::_int8_attn_kernel (the pallas_call
// in int8_attn_block) and the round-to-nearest model
// _xla_int8_attn_reference (int8_deterministic): the wrapper
// (tapclip_tpu_torch/ops/int8_attn.py::int8_attn_block) makes the same three
// launches in both modes and counts one B14 a call.  Quantization scheme and
// random bits: int8_common.cuh.
//
// Design.  The qkv rows of one ViT-B/16 sequence are [200, 2304] f32
// (1.8 MB), too large to stay on chip, so the half-block is cut as K2 is
// (attn_block.cu), into three launches:
//   (i)   int8_qkv: a block owns 8 rows: LayerNorm, row amax and codes (one
//         warp a row), the int8 qkv product over packed weights (__dp4a),
//         dequantized + b_qkv into an f32 workspace [R, 3W].  q and k stay
//         f32; v is rounded to the compute dtype in the stochastic mode, as
//         the TPU kernel's `.astype(x.dtype)` (int8_attn.py:122).
//   (ii)  int8_attn_core: one block per (batch row, head, 64-row query tile),
//         the online-softmax tiles of attn_tile.cuh over the f32 workspace,
//         into an f32 [R, W] buffer (the TPU kernel's f32 attn_s scratch).
//         In the stochastic mode p is rounded to the compute dtype before
//         p.v (int8_attn.py:100-102); the round-to-nearest model attends in
//         f32 throughout.
//   (iii) int8_out: a block owns 8 rows of the attention output: row amax
//         (over all heads: it cannot start before every head of the row is
//         done) and codes, the int8 out product, dequantized + b_out + x.
//
// What bounds it on the card: by its shape, neither bytes nor operations.
// At ViT-B/16 serving (8 x 200 rows, W 768, 12 heads, valid 197) the two
// products are 8 R W^2 = 7.5 G int8 operations (0.004 ms at 1,979 TOP/s) and
// the attention core 4 W x 8 x 200 x 197 = 0.97 GFLOP of f32 (0.015 ms at
// 67 TFLOP/s); the workspace round trip is 15 MB (0.005 ms).  The products
// run __dp4a on the integer units and the core on the FMA units; tensor-core
// MMA is later work.
#include "attn_tile.cuh"
#include "int8_common.cuh"

namespace {

using namespace tapclip;

struct RowSmem {  // LN rows (f32) and their codes, for (i); codes only for (iii)
  int ld, wp;
  __host__ __device__ explicit RowSmem(int W) : ld((W + 3) / 4 * 4), wp(pad16(W)) {}
  __host__ __device__ size_t bytes() const {
    return static_cast<size_t>(kInt8Rows) * (ld * sizeof(float) + wp) + kInt8Rows * sizeof(float);
  }
};

// (i) qkv[R, 3W] (f32) = dequant(codes(LN(x)) . w_qkv) + b_qkv.
template <typename T, bool SR>
__global__ void __launch_bounds__(kInt8Threads)
int8_qkv_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                const int* __restrict__ w, const float* __restrict__ s_col, const float* __restrict__ bias,
                float* __restrict__ qkv, int R, int W, float eps, uint32_t seed) {
  constexpr int RB = kInt8Rows;
  extern __shared__ __align__(16) unsigned char smem[];
  const RowSmem lay(W);
  float* y_s = reinterpret_cast<float*>(smem);                 // [RB][ld]
  int8_t* q_s = reinterpret_cast<int8_t*>(y_s + RB * lay.ld);  // [RB][wp]
  float* t_s = reinterpret_cast<float*>(q_s + RB * lay.wp);    // [RB]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * RB;
  for (int r = warp; r < RB; r += kInt8Warps) {
    const int row = row0 + r;
    float* yr = y_s + r * lay.ld;
    if (row < R) {
      ln_row_warp<T, !SR>(x + static_cast<size_t>(row) * W, gamma, beta, W, eps, yr, lane);
    } else {
      for (int c = lane; c < W; c += 32) yr[c] = 0.f;
    }
    __syncwarp();
    const float s = quantize_row_warp<SR, false>(yr, W, lay.wp, q_s + r * lay.wp,
                                                 row_key(seed, kStreamAttnY, row), lane);
    if (lane == 0) t_s[r] = s;
  }
  __syncthreads();
  const int N = 3 * W;
  rows_dot_packed<RB, 2>(reinterpret_cast<const int*>(q_s), lay.wp / 4, w, N, [&](int r, int j, int acc) {
    const int row = row0 + r;
    if (row >= R) return;
    float v = dequant(acc, t_s[r], s_col[j], bias[j]);
    if (SR && j >= 2 * W) v = round_to<T>(v);  // v in the compute dtype
    qkv[static_cast<size_t>(row) * N + j] = v;
  });
}

// (ii) a[b, t, head h] = softmax_masked(q k^T / sqrt(Dh)) v over the f32
// workspace; PT is the type p is rounded to before p.v (float: none).
template <typename PT, int DH>
__global__ void __launch_bounds__(kInt8Threads)
int8_attn_core_kernel(const float* __restrict__ qkv, float* __restrict__ a, int H, int T_, int W,
                      int valid) {
  using Tile = AttnTile<PT, DH>;
  extern __shared__ __align__(16) float fsmem[];
  float* Q_s = fsmem;
  float* K_s = Q_s + Tile::kRows * Tile::kLd;
  float* V_s = K_s + Tile::kKeys * Tile::kLd;
  float* P_s = V_s + Tile::kKeys * Tile::kLd;
  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * Tile::kRows;
  const size_t ld = 3 * static_cast<size_t>(W);
  const float* qb = qkv + static_cast<size_t>(b) * T_ * ld + h * DH;
  const float* kb = qb + W;
  const float* vb = qb + 2 * W;
  const float scale_log2 = rsqrtf(static_cast<float>(DH)) * kLog2e;

  for (int e = tid; e < Tile::kRows * DH; e += kInt8Threads) {
    const int r = e / DH, d = e % DH;
    Q_s[r * Tile::kLd + d] = q0 + r < T_ ? qb[(q0 + r) * ld + d] : 0.f;
  }
  const int k_end = min(T_, valid);
  Tile tile;
  tile.init();
  for (int kt0 = 0; kt0 < k_end; kt0 += Tile::kKeys) {
    for (int e = tid; e < Tile::kKeys * DH; e += kInt8Threads) {
      const int r = e / DH, d = e % DH;
      const bool in = kt0 + r < T_;
      const size_t off = (kt0 + r) * ld + d;
      K_s[r * Tile::kLd + d] = in ? kb[off] : 0.f;
      V_s[r * Tile::kLd + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();
    tile.step(Q_s, K_s, V_s, P_s, kt0, T_, valid, scale_log2, rg, cg);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg + 16 * i;
    if (t >= T_) continue;
    const float inv_l = 1.f / tile.l[i];
    float* arow = a + (static_cast<size_t>(b) * T_ + t) * W + h * DH;
#pragma unroll
    for (int j = 0; j < Tile::kDj; ++j) arow[cg + 16 * j] = tile.o[i][j] * inv_l;
  }
}

// (iii) out[R, W] = x + dequant(codes(a) . w_out) + b_out.
template <typename T, bool SR>
__global__ void __launch_bounds__(kInt8Threads)
int8_out_kernel(const float* __restrict__ a, const int* __restrict__ w, const float* __restrict__ s_col,
                const float* __restrict__ bias, const T* __restrict__ x, T* __restrict__ out, int R, int W,
                uint32_t seed) {
  constexpr int RB = kInt8Rows;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wp = pad16(W);
  int8_t* q_s = reinterpret_cast<int8_t*>(smem);          // [RB][wp]
  float* t_s = reinterpret_cast<float*>(q_s + RB * wp);  // [RB]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * RB;
  for (int r = warp; r < RB; r += kInt8Warps) {
    const int row = row0 + r;
    float s = 1.f;
    if (row < R) {
      s = quantize_row_warp<SR, false>(a + static_cast<size_t>(row) * W, W, wp, q_s + r * wp,
                                       row_key(seed, kStreamAttnA, row), lane);
    } else {
      for (int c = lane; c < wp; c += 32) q_s[r * wp + c] = 0;
    }
    if (lane == 0) t_s[r] = s;
  }
  __syncthreads();
  rows_dot_packed<RB, 2>(reinterpret_cast<const int*>(q_s), wp / 4, w, W, [&](int r, int c, int acc) {
    const int row = row0 + r;
    if (row >= R) return;
    const size_t off = static_cast<size_t>(row) * W + c;
    out[off] = from_f<T>(__fadd_rn(dequant(acc, t_s[r], s_col[c], bias[c]), to_f(x[off])));
  });
}

template <typename T, bool SR>
cudaError_t launch_rows(const void* x, const float* gamma, const float* beta, const int* w_qkv,
                        const float* s_qkv, const float* b_qkv, float* qkv, int R, int W, float eps,
                        uint32_t seed, cudaStream_t s) {
  const size_t smem = RowSmem(W).bytes();
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = int8_qkv_kernel<T, SR>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(R + kInt8Rows - 1) / kInt8Rows, kInt8Threads, smem, s>>>(
      static_cast<const T*>(x), gamma, beta, w_qkv, s_qkv, b_qkv, qkv, R, W, eps, seed);
  return cudaGetLastError();
}

template <typename T, bool SR>
cudaError_t launch_out(const float* a, const int* w_out, const float* s_out, const float* b_out,
                       const void* x, void* out, int R, int W, uint32_t seed, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kInt8Rows) * pad16(W) + kInt8Rows * sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = int8_out_kernel<T, SR>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(R + kInt8Rows - 1) / kInt8Rows, kInt8Threads, smem, s>>>(
      a, w_out, s_out, b_out, static_cast<const T*>(x), static_cast<T*>(out), R, W, seed);
  return cudaGetLastError();
}

template <typename PT, int DH>
cudaError_t launch_core(const float* qkv, float* a, int B, int T_, int W, int H, int valid,
                        cudaStream_t s) {
  const size_t smem = AttnTile<PT, DH>::kSmemFloats * sizeof(float);
  auto kernel = int8_attn_core_kernel<PT, DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (T_ + AttnTile<PT, DH>::kRows - 1) / AttnTile<PT, DH>::kRows);
  kernel<<<grid, kInt8Threads, smem, s>>>(qkv, a, H, T_, W, valid);
  return cudaGetLastError();
}

template <typename PT>
cudaError_t launch_core_dh(const float* qkv, float* a, int B, int T_, int W, int H, int valid,
                           cudaStream_t s) {
  switch (W / H) {
    case 16: return launch_core<PT, 16>(qkv, a, B, T_, W, H, valid, s);
    case 32: return launch_core<PT, 32>(qkv, a, B, T_, W, H, valid, s);
    case 64: return launch_core<PT, 64>(qkv, a, B, T_, W, H, valid, s);
    case 128: return launch_core<PT, 128>(qkv, a, B, T_, W, H, valid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch (i): x [R, W] in the compute dtype (0 float32, 1 bfloat16), gamma,
// beta [W], s_qkv, b_qkv [3W] f32, w_qkv [pad16(W) / 4, 3W] packed int8;
// writes the f32 workspace qkv [R, 3W].  deterministic 1: round to nearest
// (LN rounded to the compute dtype, v kept f32); 0: stochastic with the draws
// of `seed` (v rounded to the compute dtype).
extern "C" int tapclip_int8_qkv(const void* x, const void* gamma, const void* beta, const void* w_qkv,
                                const void* s_qkv, const void* b_qkv, void* qkv, int R, int W, float eps,
                                unsigned int seed, int deterministic, int dtype, void* stream) {
  if (R <= 0 || W <= 0) return cudaErrorInvalidValue;
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* w = static_cast<const int*>(w_qkv);
  const auto* sc = static_cast<const float*>(s_qkv);
  const auto* bs = static_cast<const float*>(b_qkv);
  auto* ws = static_cast<float*>(qkv);
  auto s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (dtype == 0)
    return deterministic ? launch_rows<float, false>(x, g, bt, w, sc, bs, ws, R, W, eps, seed, s)
                         : launch_rows<float, true>(x, g, bt, w, sc, bs, ws, R, W, eps, seed, s);
  if (dtype == 1)
    return deterministic ? launch_rows<bf, false>(x, g, bt, w, sc, bs, ws, R, W, eps, seed, s)
                         : launch_rows<bf, true>(x, g, bt, w, sc, bs, ws, R, W, eps, seed, s);
  return cudaErrorInvalidValue;
}

// Launch (ii): qkv [B, T, 3W] f32 -> a [B, T, W] f32.  Head dim W / n_heads
// in {16, 32, 64, 128}; 1 <= valid <= T.  round_p 1 rounds p to bfloat16
// before p.v (the stochastic mode in bfloat16), 0 keeps it f32.
extern "C" int tapclip_int8_attn_core(const void* qkv, void* a, int B, int T, int W, int n_heads, int valid,
                                      int round_p, void* stream) {
  if (B <= 0 || T <= 0 || n_heads <= 0 || W % n_heads || valid < 1 || valid > T)
    return cudaErrorInvalidValue;
  const auto* q = static_cast<const float*>(qkv);
  auto* o = static_cast<float*>(a);
  auto s = static_cast<cudaStream_t>(stream);
  if (round_p == 0) return launch_core_dh<float>(q, o, B, T, W, n_heads, valid, s);
  if (round_p == 1) return launch_core_dh<__nv_bfloat16>(q, o, B, T, W, n_heads, valid, s);
  return cudaErrorInvalidValue;
}

// Launch (iii): a [R, W] f32, w_out [pad16(W) / 4, W] packed int8, s_out,
// b_out [W] f32, x and out [R, W] in the compute dtype.  deterministic as (i).
extern "C" int tapclip_int8_out(const void* a, const void* w_out, const void* s_out, const void* b_out,
                                const void* x, void* out, int R, int W, unsigned int seed, int deterministic,
                                int dtype, void* stream) {
  if (R <= 0 || W <= 0) return cudaErrorInvalidValue;
  const auto* av = static_cast<const float*>(a);
  const auto* w = static_cast<const int*>(w_out);
  const auto* sc = static_cast<const float*>(s_out);
  const auto* bs = static_cast<const float*>(b_out);
  auto s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (dtype == 0)
    return deterministic ? launch_out<float, false>(av, w, sc, bs, x, out, R, W, seed, s)
                         : launch_out<float, true>(av, w, sc, bs, x, out, R, W, seed, s);
  if (dtype == 1)
    return deterministic ? launch_out<bf, false>(av, w, sc, bs, x, out, R, W, seed, s)
                         : launch_out<bf, true>(av, w, sc, bs, x, out, R, W, seed, s);
  return cudaErrorInvalidValue;
}
