// Backward of the SA-Fuser tail: dr, dd and the 12 parameter gradients.
//
// Replaces the Pallas kernel r3d_tpu/ops/fuser_kernel_bwd.py:70 `_bwd_kernel`
// (launched by `pallas_tail_bwd`, pallas_call at :212), the backward that
// `fused_safuser_tail` runs in training epoch 0. Forward, per row of the
// streams r, d [N, C] (C = 128, hidden Ch = 512, LN eps 1e-5):
//
//   h_* = LN1(*)            x_r = r + h_d Wvp^T + bp     x_d = d + h_r Wvp^T + bp
//   u_* = LN2(x_*)          z_* = u_* W1^T + b1          p_* = GELU(z_*)
//   y_* = x_* + p_* W2^T + b2 (+ the input with the outer residual)
//   out = (LN_out(y_r) + LN_out(y_d)) / 2
//
// and, with g the cotangent of out and g/2 that of each LN_out:
//
//   LN backward  dx = rstd * (gh - mean(gh) - xhat * mean(gh * xhat)), gh = g*gamma;
//                dgamma += sum_rows g*xhat, dbeta += sum_rows g
//   GELU'(z)     = 0.5*(1 + erf(z/sqrt2)) + z*exp(-z^2/2)/sqrt(2 pi)
//
// What bounds it on the H100: operations. Per row it recomputes the forward
// (2*C*C + 4*C*Ch multiply-adds, the up-projection twice) and runs the
// backward's five products, about 6 * 2 * (2*C*C + 4*C*Ch) flops in all:
// 7.25 GFLOP at N = 4096, 0.11 ms at the fp32 CUDA-core peak, against 5*N*C*4
// = 10.5 MB of stream traffic.
//
// What the design does about it. The TPU kernel walks its grid in order and
// sums the parameter gradients into output blocks that stay resident across
// it. Hopper runs blocks in parallel, so the sum across blocks is explicit
// and deterministic: a fixed number G of blocks (at most one per SM) each
// walk their own tiles of TM rows of each stream, and add each tile's
// parameter-gradient contributions into their own slice of a scratch [G, P]
// (P = 8C + Ch + C*C + 2*C*Ch = 148,992 floats, the gradients laid end to end
// in FuserTailParams order), which no other block touches; a second kernel
// then sums the G slices in a fixed order. Inside a tile, as in the forward
// kernel (fuser_tail.cu), the weights stream through a shared-memory chunk in
// torch's [out, in] layout, each thread owns a 4 x 4 tile of a product, and
// the 512-wide hidden activation exists only one 128-wide chunk at a time:
// the forward pass over the chunks sums y, the backward pass recomputes each
// chunk's z, GELU(z) and GELU'(z) and folds it into du, dW1 and dW2 at once.
// The tile keeps xhat1, h1, xhat2, u, the working stream and one chunk in
// shared memory (6 x [32 x 132] fp32 plus an 18 KB weight chunk, 121 KB).
// Rows past N read as zero with a zero cotangent, so they add nothing to the
// parameter gradients and are never stored. Tensor cores are left for a
// later change.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int C = 128;          // channels; the launcher checks
constexpr int TM = 16;          // rows of each stream per tile
constexpr int T = 2 * TM;       // token rows per tile: [0, TM) r, [TM, T) d
constexpr int NT = 256;         // threads per block: 8 warps x 4 token rows
constexpr int LDA = C + 4;      // padded row stride of the activation tiles
constexpr int HC = 128;         // hidden chunk of the MLP
constexpr int KB = 32;          // depth of one staged weight chunk
constexpr int LDW = KB + 4;     // row stride of a staged [C, KB] chunk of W (A @ W^T)
constexpr int WS_FLOATS = C * LDW > KB * C ? C * LDW : KB * C;
constexpr int TILE = T * LDA;
constexpr int SMEM_FLOATS = 6 * TILE + WS_FLOATS + 3 * T;
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

static_assert(T == (NT / 32) * 4, "each warp owns 4 token rows");
static_assert(HC == C, "one thread tile serves every product");
static_assert(NT == 2 * C, "the column sums take C threads");

struct BwdArgs {
  const float* r;
  const float* d;
  const float* g;
  const float* norm1_scale;
  const float* norm1_bias;
  const float* wvp;          // [C, C], [out, in]
  const float* proj_bias;
  const float* norm2_scale;
  const float* norm2_bias;
  const float* mlp1_weight;  // [Ch, C], [out, in]
  const float* mlp1_bias;
  const float* mlp2_weight;  // [C, Ch], [out, in]
  const float* mlp2_bias;
  const float* norm_out_scale;
  const float* norm_out_bias;
  float* dr;
  float* dd;
  float* partial;            // [G, P], zeroed by the launcher
  int n_rows;
  int hidden;
  bool outer_residual;
};

// Offsets of the gradients in one slice of `partial` (FuserTailParams order).
struct Layout {
  int n1s, n1b, wvp, pb, n2s, n2b, w1, b1, w2, b2, nos, nob, total;
  __host__ __device__ explicit Layout(int ch) {
    n1s = 0;
    n1b = n1s + C;
    wvp = n1b + C;
    pb = wvp + C * C;
    n2s = pb + C;
    n2b = n2s + C;
    w1 = n2b + C;
    b1 = w1 + ch * C;
    w2 = b1 + ch;
    b2 = w2 + C * ch;
    nos = b2 + C;
    nob = nos + C;
    total = nob + C;
  }
};

__device__ __forceinline__ int token_row(int i) { return (threadIdx.x >> 5) * 4 + i; }
__device__ __forceinline__ int swapped(int row) { return (row + TM) % T; }

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// acc[i][j] += sum_k A[row_i][k] * W[n0 + lane + 32*j][k0 + k], k < K: the
// product A @ W^T with W [*, ldw] row-major ([out, in]). row_i = token_row(i),
// or the other stream's row when `swap`. W is staged KB columns at a time.
__device__ void gemm_wt(const float* A, bool swap, const float* __restrict__ W, int ldw,
                        int n0, int k0, int K, float* ws, float acc[4][4]) {
  const int lane = threadIdx.x & 31;
  for (int kc = 0; kc < K; kc += KB) {
    for (int idx = threadIdx.x; idx < C * (KB / 4); idx += NT) {
      const int n = idx / (KB / 4);
      const int k4 = (idx % (KB / 4)) * 4;
      *reinterpret_cast<float4*>(ws + n * LDW + k4) = __ldg(reinterpret_cast<const float4*>(
          W + static_cast<size_t>(n0 + n) * ldw + k0 + kc + k4));
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KB; k += 4) {
      float4 a[4];
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = swap ? swapped(token_row(i)) : token_row(i);
        a[i] = *reinterpret_cast<const float4*>(A + row * LDA + kc + k);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = *reinterpret_cast<const float4*>(ws + (lane + 32 * j) * LDW + k);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, w[j].x, s);
          s = fmaf(a[i].y, w[j].y, s);
          s = fmaf(a[i].z, w[j].z, s);
          s = fmaf(a[i].w, w[j].w, s);
          acc[i][j] = s;
        }
      }
    }
    __syncthreads();
  }
}

// acc[i][j] += sum_k A[row_i][k] * W[k0 + k][n0 + lane + 32*j], k < K: the
// product A @ W with W [*, ldw] row-major. W is staged KB rows at a time.
__device__ void gemm_w(const float* A, bool swap, const float* __restrict__ W, int ldw,
                       int n0, int k0, int K, float* ws, float acc[4][4]) {
  const int lane = threadIdx.x & 31;
  for (int kc = 0; kc < K; kc += KB) {
    for (int idx = threadIdx.x; idx < KB * (C / 4); idx += NT) {
      const int k = idx / (C / 4);
      const int n4 = (idx % (C / 4)) * 4;
      *reinterpret_cast<float4*>(ws + k * C + n4) = __ldg(reinterpret_cast<const float4*>(
          W + static_cast<size_t>(k0 + kc + k) * ldw + n0 + n4));
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KB; ++k) {
      float a[4];
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = swap ? swapped(token_row(i)) : token_row(i);
        a[i] = A[row * LDA + kc + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ws[k * C + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// out[a * ldo + b] += sum_{row < T} X[row][a] * Y[y_row][b] for a, b < 128,
// y_row the other stream's row when `swap_y`. Each thread owns an 8 x 8 set
// of (a, b); the block's own slice of the scratch, so no other block races.
__device__ void outer_acc(const float* X, const float* Y, bool swap_y, float* out, int ldo) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float s[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  }
  for (int row = 0; row < T; ++row) {
    const float* x = X + row * LDA;
    const float* y = Y + (swap_y ? swapped(row) : row) * LDA;
    float xa[8];
    float yb[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) xa[i] = x[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) yb[j] = y[tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(xa[i], yb[j], s[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(ty + 16 * i) * ldo + tx + 16 * j] += s[i][j];
  }
}

// out[c] += sum_rows X[row][c] * (Y ? Y[row][c] : 1) for c < 128 (threads < C).
__device__ void colsum_acc(const float* X, const float* Y, float* out) {
  if (threadIdx.x >= C) return;
  const int c = threadIdx.x;
  float s = 0.f;
  for (int row = 0; row < T; ++row) {
    s += Y == nullptr ? X[row * LDA + c] : X[row * LDA + c] * Y[row * LDA + c];
  }
  out[c] += s;
}

// LayerNorm forward of this warp's 4 rows of src: xhat into xh, the affine
// output into y (either may alias src), 1/std into rstd[row].
__device__ void ln_fwd_rows(const float* src, float* xh, float* y, float* rstd,
                            const float* __restrict__ scale, const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = token_row(i);
    float v[4];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = src[row * LDA + lane + 32 * j];
      s += v[j];
    }
    const float mu = r3d::warp_sum(s) * (1.f / C);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dv = v[j] - mu;
      q = fmaf(dv, dv, q);
    }
    const float inv = rsqrtf(r3d::warp_sum(q) * (1.f / C) + 1e-5f);
    if (lane == 0) rstd[row] = inv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      const float xhat = (v[j] - mu) * inv;
      if (xh != nullptr) xh[row * LDA + c] = xhat;
      if (y != nullptr) y[row * LDA + c] = xhat * __ldg(scale + c) + __ldg(bias + c);
    }
  }
}

// Input cotangent of a LayerNorm for this warp's 4 rows: gsrc is the output
// cotangent, xh and rstd the forward's; the result goes to dst (may alias
// gsrc) and is added to dst when `accumulate`.
__device__ void ln_bwd_rows(const float* gsrc, const float* xh, const float* rstd,
                            const float* __restrict__ scale, float* dst, bool accumulate) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = token_row(i);
    float gh[4];
    float xv[4];
    float s1 = 0.f;
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      gh[j] = gsrc[row * LDA + c] * __ldg(scale + c);
      xv[j] = xh[row * LDA + c];
      s1 += gh[j];
      s2 = fmaf(gh[j], xv[j], s2);
    }
    const float m1 = r3d::warp_sum(s1) * (1.f / C);
    const float m2 = r3d::warp_sum(s2) * (1.f / C);
    const float inv = rstd[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      const float dx = (gh[j] - m1 - xv[j] * m2) * inv;
      dst[row * LDA + c] = accumulate ? dst[row * LDA + c] + dx : dx;
    }
  }
}

__global__ void __launch_bounds__(NT) fuser_tail_bwd_kernel(const BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* xh1 = reinterpret_cast<float*>(smem4);  // xhat of LN1
  float* h1 = xh1 + TILE;                         // LN1 output
  float* xh2 = h1 + TILE;                         // xhat of LN2; later gy (outer residual)
  float* u = xh2 + TILE;                          // LN2 output
  float* ws_a = u + TILE;                         // x, y, xhat_out, gy = dm, then dx
  float* ms = ws_a + TILE;                        // hidden chunk, g/2, du, dh
  float* ws = ms + TILE;                          // staged weight chunk
  float* rstd1 = ws + WS_FLOATS;
  float* rstd2 = rstd1 + T;
  float* rstdo = rstd2 + T;

  const int lane = threadIdx.x & 31;
  const Layout L(a.hidden);
  float* part = a.partial + static_cast<size_t>(blockIdx.x) * L.total;
  const int n_tiles = (a.n_rows + TM - 1) / TM;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = static_cast<long>(tile) * TM;

    // ---- forward, recomputed ----
    for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
      const int i = idx / C;
      const int c = idx % C;
      const long g = row0 + i;
      const bool ok = g < a.n_rows;
      ws_a[i * LDA + c] = ok ? __ldg(a.r + g * C + c) : 0.f;
      ws_a[(i + TM) * LDA + c] = ok ? __ldg(a.d + g * C + c) : 0.f;
    }
    __syncthreads();
    ln_fwd_rows(ws_a, xh1, h1, rstd1, a.norm1_scale, a.norm1_bias);
    __syncthreads();
    float acc[4][4];
    zero(acc);
    gemm_wt(h1, true, a.wvp, C, 0, 0, C, ws, acc);  // x = in + swap(h1) Wvp^T + bp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        float* x = ws_a + token_row(i) * LDA + c;
        *x = (*x + acc[i][j]) + __ldg(a.proj_bias + c);
      }
    }
    __syncthreads();
    ln_fwd_rows(ws_a, xh2, u, rstd2, a.norm2_scale, a.norm2_bias);
    __syncthreads();
    float acc2[4][4];
    zero(acc2);
    for (int h0 = 0; h0 < a.hidden; h0 += HC) {  // y = x + GELU(u W1^T + b1) W2^T + b2
      zero(acc);
      gemm_wt(u, false, a.mlp1_weight, C, h0, 0, C, ws, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          const float z = acc[i][j] + __ldg(a.mlp1_bias + h0 + c);
          ms[token_row(i) * LDA + c] = 0.5f * z * (1.f + erff(z * kInvSqrt2));
        }
      }
      __syncthreads();
      gemm_wt(ms, false, a.mlp2_weight, a.hidden, 0, h0, HC, ws, acc2);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        float* x = ws_a + token_row(i) * LDA + c;
        *x = *x + (acc2[i][j] + __ldg(a.mlp2_bias + c));
      }
    }
    __syncthreads();
    if (a.outer_residual) {
      for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
        const int i = idx / C;
        const int c = idx % C;
        const long g = row0 + i;
        if (g < a.n_rows) {
          ws_a[i * LDA + c] += __ldg(a.r + g * C + c);
          ws_a[(i + TM) * LDA + c] += __ldg(a.d + g * C + c);
        }
      }
      __syncthreads();
    }
    ln_fwd_rows(ws_a, ws_a, nullptr, rstdo, a.norm_out_scale, a.norm_out_bias);

    // ---- backward ----
    // g/2 reaches each stream's LN_out (out is the mean of the two)
    for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
      const int i = idx / C;
      const int c = idx % C;
      const long g = row0 + i;
      const float gv = g < a.n_rows ? 0.5f * __ldg(a.g + g * C + c) : 0.f;
      ms[i * LDA + c] = gv;
      ms[(i + TM) * LDA + c] = gv;
    }
    __syncthreads();
    colsum_acc(ms, ws_a, part + L.nos);
    colsum_acc(ms, nullptr, part + L.nob);
    __syncthreads();
    ln_bwd_rows(ms, ws_a, rstdo, a.norm_out_scale, ws_a, false);  // gy = dm, in ws_a
    __syncthreads();
    colsum_acc(ws_a, nullptr, part + L.b2);

    float du[4][4];
    zero(du);
    for (int h0 = 0; h0 < a.hidden; h0 += HC) {
      // z, GELU(z) and GELU'(z) of this chunk
      zero(acc);
      gemm_wt(u, false, a.mlp1_weight, C, h0, 0, C, ws, acc);
      float dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = lane + 32 * j;
          const float z = acc[i][j] + __ldg(a.mlp1_bias + h0 + c);
          const float cdf = 0.5f * (1.f + erff(z * kInvSqrt2));
          dp[i][j] = cdf + z * expf(-0.5f * z * z) * kInvSqrt2Pi;
          ms[token_row(i) * LDA + c] = z * cdf;
        }
      }
      __syncthreads();
      outer_acc(ws_a, ms, false, part + L.w2 + h0, a.hidden);  // dW2[:, chunk] += dm^T p
      zero(acc);
      gemm_w(ws_a, false, a.mlp2_weight, a.hidden, h0, 0, C, ws, acc);  // dm @ W2[:, chunk]
      // gemm_w ends on a barrier: every thread is done reading p from ms
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ms[token_row(i) * LDA + lane + 32 * j] = acc[i][j] * dp[i][j];  // dz
        }
      }
      __syncthreads();
      colsum_acc(ms, nullptr, part + L.b1 + h0);
      outer_acc(ms, u, false, part + L.w1 + h0 * C, C);     // dW1[chunk] += dz^T u
      gemm_w(ms, false, a.mlp1_weight, C, 0, h0, HC, ws, du);  // du += dz @ W1[chunk]
    }
    // gemm_w ended on a barrier: ms is free for du
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ms[token_row(i) * LDA + lane + 32 * j] = du[i][j];
    }
    __syncthreads();
    colsum_acc(ms, xh2, part + L.n2s);
    colsum_acc(ms, nullptr, part + L.n2b);
    __syncthreads();
    // dx = gy + LN2_bwd(du); with the outer residual, gy is kept in xh2 first
    ln_bwd_rows(ms, xh2, rstd2, a.norm2_scale, ms, false);
    if (a.outer_residual) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = token_row(i) * LDA + lane + 32 * j;
          xh2[off] = ws_a[off];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int off = token_row(i) * LDA + lane + 32 * j;
        ws_a[off] += ms[off];
      }
    }
    __syncthreads();
    colsum_acc(ws_a, nullptr, part + L.pb);
    outer_acc(ws_a, h1, true, part + L.wvp, C);  // dWvp += dx^T swap(h1)
    zero(acc);
    gemm_w(ws_a, true, a.wvp, C, 0, 0, C, ws, acc);  // dh = swap(dx) @ Wvp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ms[token_row(i) * LDA + lane + 32 * j] = acc[i][j];
    }
    __syncthreads();
    colsum_acc(ms, xh1, part + L.n1s);
    colsum_acc(ms, nullptr, part + L.n1b);
    // dr = dx + LN1_bwd(dh) (+ gy with the outer residual), in ws_a
    ln_bwd_rows(ms, xh1, rstd1, a.norm1_scale, ws_a, true);
    if (a.outer_residual) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = token_row(i) * LDA + lane + 32 * j;
          ws_a[off] += xh2[off];
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
      const int i = idx / C;
      const int c = idx % C;
      const long g = row0 + i;
      if (g < a.n_rows) {
        a.dr[g * C + c] = ws_a[i * LDA + c];
        a.dd[g * C + c] = ws_a[(i + TM) * LDA + c];
      }
    }
    __syncthreads();  // the next tile overwrites ws_a and ms
  }
}

// grads[p] = sum over the G slices of partial[g][p], in order of g.
__global__ void sum_partials_kernel(const float* __restrict__ partial, int G, int P,
                                    float* __restrict__ grads) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += partial[static_cast<size_t>(g) * P + p];
  grads[p] = s;
}

}  // namespace

// Size in floats of one block's slice of the scratch, and of the gradients.
extern "C" int r3d_fuser_tail_bwd_params(int hidden) { return Layout(hidden).total; }

// r, d, g [N, C]; the tail's parameters (torch layout); dr, dd [N, C];
// partial [G, P] scratch; grads [P] (the 12 gradients end to end, in
// FuserTailParams order, matrices in [out, in] layout). All fp32, contiguous.
extern "C" int r3d_fuser_tail_bwd(
    const float* r, const float* d, const float* g, const float* norm1_scale,
    const float* norm1_bias, const float* wvp, const float* proj_bias,
    const float* norm2_scale, const float* norm2_bias, const float* mlp1_weight,
    const float* mlp1_bias, const float* mlp2_weight, const float* mlp2_bias,
    const float* norm_out_scale, const float* norm_out_bias, float* dr, float* dd,
    float* partial, float* grads, int n_rows, int channels, int hidden, int n_blocks,
    int outer_residual, void* stream) {
  if (channels != C || hidden <= 0 || hidden % HC != 0 || n_rows < 0 || n_blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L(hidden);
  cudaError_t err = cudaMemsetAsync(
      partial, 0, static_cast<size_t>(n_blocks) * L.total * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0) {
    const int smem = SMEM_FLOATS * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(fuser_tail_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const BwdArgs a{r, d, g, norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale,
                    norm2_bias, mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias,
                    norm_out_scale, norm_out_bias, dr, dd, partial, n_rows, hidden,
                    outer_residual != 0};
    fuser_tail_bwd_kernel<<<n_blocks, NT, smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sum_partials_kernel<<<(L.total + 255) / 256, 256, 0, s>>>(partial, n_blocks, L.total, grads);
  return static_cast<int>(cudaGetLastError());
}
