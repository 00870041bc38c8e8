// B5: backward of the fused MLP half-block K1,
//   out = x + (gelu(LN(x) @ w_fc + b_fc) @ w_proj + b_proj).
//
// Replaces tapclip_tpu/ops/fused_mlp.py::_mlp_bwd_kernel (the pallas_call in
// _fused_mlp_bwd_impl).  Like the TPU kernel it never receives the forward's
// hidden tensor: it recomputes LN -> fc -> GELU from x.
//
// The TPU kernel carries the f32 weight-gradient sums across its sequential
// row grid in VMEM.  Hopper blocks run in no order, so this is two passes
// (the wrapper tapclip_tpu_torch/ops/fused_mlp.py::_fused_mlp_bwd_cuda):
//
//   (i)  mlp_bwd_rows (this file): a block owns ROWS rows (16, or 8 where
//        16 rows' buffers do not fit in shared memory).  It recomputes the
//        LayerNorm in f32 and keeps y = LN(x) (rounded to the compute dtype)
//        and the cotangent g in shared memory, then walks the hidden
//        dimension in chunks of 256 columns, one column per thread:
//          h_pre = y . w_fc + b_fc;  h, gelu'(h_pre) = Phi + z phi (erff);
//          dh = g . w_proj^T (w_proj rows staged through shared memory);
//          dh_pre = dh * gelu'.
//        The chunk's dh_pre, rounded to the compute dtype, stays in shared
//        memory and is folded into an f32 [ROWS, W] accumulator
//        dy += dh_pre . w_fc^T (w_fc tiles staged through shared memory).
//        Then the LayerNorm backward per row gives dx = g + dx_ln.  The
//        [ROWS, H] hidden tensors never reach device memory on their way to
//        dx.  When weight gradients are wanted, the block also writes y, h
//        and dh_pre (compute dtype: the operands of dW_fc = y^T . dh_pre and
//        dW_proj = h^T . g) and its partial column sums of dy * n, dy, g
//        and dh_pre (f32) to scratch.
//   (ii) gemm.cu: the A^T . B products over rows for dW_fc and dW_proj and
//        the second column-sum pass for dgamma, dbeta, db_proj and db_fc.
//        On the training path (only the prompt context is trained, the CLIP
//        weights are frozen) the wrapper skips (ii) and the scratch writes.
//
// bfloat16 rounds where the TPU kernel rounds: y, the cotangent, h (for
// dW_proj) and dh_pre (for dy and dW_fc); LN statistics, h_pre, dh and dy
// stay f32; db_fc sums the unrounded dh_pre, as the TPU kernel does.
//
// What bounds it on the card: inferred, not measured (no profile yet).  By
// its shape it is arithmetic: 3 x 2 x R x W x H flops for dx (fc recompute,
// dh, dy), on the FMA units in f32, with every block re-reading all of w_fc
// (twice) and w_proj from L2.  It has the FMA walk's layout (one block of 8
// warps per SM, ROWS rows per block), which a block-count probe of K1 on that
// walk found held back
// by too few warps per SM; the same is expected here.  More rows per block,
// more blocks per SM and tensor-core MMA are later work.
#include "common.cuh"

namespace {

using namespace tapclip;

constexpr int kThreads = 256;
constexpr int kChunk = 256;            // hidden columns per chunk: one per thread
constexpr int kCTile = 32;             // W columns per staged weight tile
constexpr int kStage = kChunk * (kCTile + 1);  // >= kCTile * (kChunk + 1)
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

template <int ROWS>
size_t smem_bytes(int W) {
  return (3 * ROWS * W + ROWS * kChunk + kStage + 2 * ROWS) * sizeof(float);
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
mlp_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const T* __restrict__ w_fc, const float* __restrict__ b_fc,
                    const T* __restrict__ w_proj, T* __restrict__ dx,
                    T* __restrict__ y_out, T* __restrict__ h_out,
                    T* __restrict__ dhp_out, float* __restrict__ part, int R, int W,
                    int H, float eps, int want_w) {
  static_assert(ROWS % 8 == 0, "ROWS is a multiple of the 8 warps");
  extern __shared__ __align__(16) float smem[];
  float* y_s = smem;                   // [ROWS][W] LN(x) rounded; later n
  float* g_s = y_s + ROWS * W;         // [ROWS][W] cotangent
  float* dy_s = g_s + ROWS * W;        // [ROWS][W] f32 accumulator
  float* hc_s = dy_s + ROWS * W;       // [ROWS][kChunk] dh_pre rounded
  float* st_s = hc_s + ROWS * kChunk;  // staged weight tile
  float* mean_s = st_s + kStage;       // [ROWS]
  float* rstd_s = mean_s + ROWS;       // [ROWS]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const size_t part_ld = static_cast<size_t>(3 * W + H);
  float* part_b = part + blockIdx.x * part_ld;  // [dgamma | dbeta | db_proj | db_fc]

  // LayerNorm recompute, one warp per row.
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    const int gr = row0 + r;
    float* yr = y_s + r * W;
    float* gs = g_s + r * W;
    float* dr = dy_s + r * W;
    if (gr < R) {
      const T* xr = x + static_cast<size_t>(gr) * W;
      const T* grow = g + static_cast<size_t>(gr) * W;
      float s = 0.f;
      for (int c = lane; c < W; c += 32) s += to_f(xr[c]);
      const float mean = warp_sum(s) / W;
      float v = 0.f;
      for (int c = lane; c < W; c += 32) {
        const float d = to_f(xr[c]) - mean;
        v += d * d;
      }
      const float rstd = rsqrtf(warp_sum(v) / W + eps);
      for (int c = lane; c < W; c += 32) {
        const float y = round_to<T>((to_f(xr[c]) - mean) * rstd * gamma[c] + beta[c]);
        yr[c] = y;
        gs[c] = to_f(grow[c]);
        dr[c] = 0.f;
        if (want_w) y_out[static_cast<size_t>(gr) * W + c] = from_f<T>(y);
      }
      if (lane == 0) {
        mean_s[r] = mean;
        rstd_s[r] = rstd;
      }
    } else {
      for (int c = lane; c < W; c += 32) yr[c] = gs[c] = dr[c] = 0.f;
      if (lane == 0) mean_s[r] = rstd_s[r] = 0.f;
    }
  }
  __syncthreads();

  for (int j0 = 0; j0 < H; j0 += kChunk) {
    const int hcol = j0 + tid;
    const bool col_ok = hcol < H;
    // h_pre for hidden column hcol: y . w_fc[:, hcol] (coalesced over threads).
    float a[ROWS], d[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) a[r] = d[r] = 0.f;
    if (col_ok) {
      const T* wc = w_fc + hcol;
#pragma unroll 2
      for (int k = 0; k < W; k += 4) {
        const float w0 = to_f(wc[static_cast<size_t>(k) * H]);
        const float w1 = to_f(wc[static_cast<size_t>(k + 1) * H]);
        const float w2 = to_f(wc[static_cast<size_t>(k + 2) * H]);
        const float w3 = to_f(wc[static_cast<size_t>(k + 3) * H]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 yv = *reinterpret_cast<const float4*>(y_s + r * W + k);
          a[r] = fmaf(yv.x, w0, a[r]);
          a[r] = fmaf(yv.y, w1, a[r]);
          a[r] = fmaf(yv.z, w2, a[r]);
          a[r] = fmaf(yv.w, w3, a[r]);
        }
      }
    }
    // dh for hidden column hcol: g . w_proj[hcol, :], the chunk's w_proj rows
    // staged 32 columns at a time.
    for (int c0 = 0; c0 < W; c0 += kCTile) {
      for (int e = tid; e < kChunk * kCTile; e += kThreads) {
        const int t = e / kCTile, cc = e % kCTile;
        const int row = j0 + t;
        st_s[t * (kCTile + 1) + cc] = row < H ? to_f(w_proj[static_cast<size_t>(row) * W + c0 + cc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < kCTile; ++cc) {
        const float w = st_s[tid * (kCTile + 1) + cc];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) d[r] = fmaf(g_s[r * W + c0 + cc], w, d[r]);
      }
      __syncthreads();
    }
    if (col_ok) {
      const float bias = b_fc[hcol];
      float psum = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float z = a[r] + bias;
        const float cdf = 0.5f * (1.f + erff(z * kInvSqrt2));
        const float pdf = expf(-0.5f * z * z) * kInvSqrt2Pi;
        const float dhp = d[r] * (cdf + z * pdf);  // 0 on rows past R (g is 0)
        const int gr = row0 + r;
        if (gr < R) {
          psum += dhp;
          if (want_w) {
            const size_t off = static_cast<size_t>(gr) * H + hcol;
            h_out[off] = from_f<T>(z * cdf);
            dhp_out[off] = from_f<T>(dhp);
          }
        }
        hc_s[r * kChunk + tid] = round_to<T>(dhp);
      }
      if (want_w) part_b[3 * W + hcol] = psum;
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) hc_s[r * kChunk + tid] = 0.f;
    }
    __syncthreads();

    // dy[:, c] += dh_pre_chunk . w_fc[c, chunk]: thread (rp, c) owns rows
    // rp + 8 i of column c0 + c; w_fc rows staged 32 at a time.
    const int c = tid & 31, rp = tid >> 5;
    for (int c0 = 0; c0 < W; c0 += kCTile) {
      for (int e = tid; e < kCTile * kChunk; e += kThreads) {
        const int cc = e / kChunk, jj = e % kChunk;
        const int hc = j0 + jj;
        st_s[cc * (kChunk + 1) + jj] = hc < H ? to_f(w_fc[static_cast<size_t>(c0 + cc) * H + hc]) : 0.f;
      }
      __syncthreads();
      float acc[ROWS / 8];
#pragma unroll
      for (int i = 0; i < ROWS / 8; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < kChunk; ++jj) {
        const float w = st_s[c * (kChunk + 1) + jj];
#pragma unroll
        for (int i = 0; i < ROWS / 8; ++i) acc[i] = fmaf(hc_s[(rp + 8 * i) * kChunk + jj], w, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < ROWS / 8; ++i) dy_s[(rp + 8 * i) * W + c0 + c] += acc[i];
      __syncthreads();
    }
  }

  // LayerNorm backward, one warp per row; y_s now takes n = (x - mean) rstd.
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    const int gr = row0 + r;
    float* nr = y_s + r * W;
    const float* dr = dy_s + r * W;
    if (gr >= R) {
      for (int c = lane; c < W; c += 32) nr[c] = 0.f;
      continue;
    }
    const T* xr = x + static_cast<size_t>(gr) * W;
    const float mean = mean_s[r], rstd = rstd_s[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < W; c += 32) {
      const float n = (to_f(xr[c]) - mean) * rstd;
      const float dn = dr[c] * gamma[c];
      nr[c] = n;
      s1 += dn;
      s2 += dn * n;
    }
    s1 = warp_sum(s1) / W;
    s2 = warp_sum(s2) / W;
    const float* gs = g_s + r * W;
    for (int c = lane; c < W; c += 32) {
      const float dn = dr[c] * gamma[c];
      dx[static_cast<size_t>(gr) * W + c] = from_f<T>(gs[c] + rstd * (dn - s1 - nr[c] * s2));
    }
  }
  if (!want_w) return;
  __syncthreads();
  for (int c = tid; c < W; c += kThreads) {
    float pg = 0.f, pb = 0.f, pp = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float dyv = dy_s[r * W + c];
      pg += dyv * y_s[r * W + c];
      pb += dyv;
      pp += g_s[r * W + c];
    }
    part_b[c] = pg;
    part_b[W + c] = pb;
    part_b[2 * W + c] = pp;
  }
}

template <typename T, int ROWS>
cudaError_t launch_rows(const void* x, const void* g, const float* gamma,
                        const float* beta, const void* w_fc, const float* b_fc,
                        const void* w_proj, void* dx, void* y_out, void* h_out,
                        void* dhp_out, float* part, int R, int W, int H, float eps,
                        int want_w, cudaStream_t s) {
  const size_t smem = smem_bytes<ROWS>(W);
  auto kernel = mlp_bwd_rows_kernel<T, ROWS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(R + ROWS - 1) / ROWS, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), gamma, beta,
      static_cast<const T*>(w_fc), b_fc, static_cast<const T*>(w_proj),
      static_cast<T*>(dx), static_cast<T*>(y_out), static_cast<T*>(h_out),
      static_cast<T*>(dhp_out), part, R, W, H, eps, want_w);
  return cudaGetLastError();
}

constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
cudaError_t launch_dtype(const void* x, const void* g, const float* gamma,
                         const float* beta, const void* w_fc, const float* b_fc,
                         const void* w_proj, void* dx, void* y_out, void* h_out,
                         void* dhp_out, float* part, int R, int W, int H,
                         float eps, int want_w, cudaStream_t s) {
  if (smem_bytes<16>(W) <= kMaxSmem)
    return launch_rows<T, 16>(x, g, gamma, beta, w_fc, b_fc, w_proj, dx, y_out, h_out,
                              dhp_out, part, R, W, H, eps, want_w, s);
  if (smem_bytes<8>(W) <= kMaxSmem)
    return launch_rows<T, 8>(x, g, gamma, beta, w_fc, b_fc, w_proj, dx, y_out, h_out,
                             dhp_out, part, R, W, H, eps, want_w, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Rows per block of mlp_bwd_rows at width W (16 or 8), 0 if W does not fit:
// the wrapper sizes the partial-sum scratch [ceil(R / rows), 3W + H] with it.
extern "C" int tapclip_mlp_bwd_rows_per_block(int W) {
  if (W <= 0) return 0;
  if (smem_bytes<16>(W) <= kMaxSmem) return 16;
  if (smem_bytes<8>(W) <= kMaxSmem) return 8;
  return 0;
}

// Pass (i) of B5.  dtype: 0 float32, 1 bfloat16.  W a multiple of 32.  With
// want_w = 0, y_out, h_out, dhp_out and part are not touched (may be null).
extern "C" int tapclip_mlp_bwd_rows(const void* x, const void* g, const void* gamma,
                                    const void* beta, const void* w_fc,
                                    const void* b_fc, const void* w_proj, void* dx,
                                    void* y_out, void* h_out, void* dhp_out,
                                    void* part, int R, int W, int H, float eps,
                                    int want_w, int dtype, void* stream) {
  if (R <= 0 || W <= 0 || H <= 0 || W % 32) return cudaErrorInvalidValue;
  const auto* gm = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* bf = static_cast<const float*>(b_fc);
  auto* pt = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(x, g, gm, bt, w_fc, bf, w_proj, dx, y_out, h_out, dhp_out,
                               pt, R, W, H, eps, want_w, s);
  if (dtype == 1)
    return launch_dtype<__nv_bfloat16>(x, g, gm, bt, w_fc, bf, w_proj, dx, y_out, h_out,
                                       dhp_out, pt, R, W, H, eps, want_w, s);
  return cudaErrorInvalidValue;
}
