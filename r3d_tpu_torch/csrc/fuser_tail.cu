// Fused CMFuser: BN-affine + bottom-k alpha blend prologue, then the SA-Fuser
// tail, in one pass over a tile of rows.
//
// Replaces the Pallas kernel r3d_tpu/ops/fuser_kernel.py:180 `_kernel`
// (launched by `_pallas_forward`, pallas_call at :254) on its `with_blend`
// route, the one `fused_bn_blend_tail` takes on every serving request. For
// each row i of the two raw streams r, d [N, C]:
//
//   rn = r*scale_r + shift_r            dn = d*scale_d + shift_d
//   x_r = mask_r*(a*rn + (1-a)*dn) + (1-mask_r)*rn   (and the mirror for x_d)
//   x_r += LN1(x_d) Wvp^T + b           x_d += LN1(x_r) Wvp^T + b
//   x_* += W2 GELU(W1 LN2(x_*) + b1) + b2
//   out  = (LN_out(x_r) + LN_out(x_d)) / 2
//
// LayerNorm statistics are fp32 with biased variance and eps 1e-5; GELU is
// the exact erf form (CUDA has erff; the TPU kernel's polynomial erf existed
// only because Mosaic lacked one). All arithmetic is fp32 on the CUDA cores,
// so the kernel agrees with the plain fp32 version to rounding.
//
// What bounds it on the H100: operations. Per output row it does
// 2 * (2*C*C + 4*C*Ch) flops (C = 128, Ch = 512: 589,824) against 3*C*4 =
// 1.5 KB of stream traffic, about 380 flops per byte, far above the fp32
// CUDA-core ridge of 67 TFLOP/s over 3.35 TB/s = 20 flops per byte.
//
// What the design does about it. The TPU kernel keeps all weights resident
// in VMEM; in fp32 Wvp, W1 and W2 are 576 KB and a block has 227 KB of
// shared memory. So a block takes TM rows of each stream (T = 2*TM token
// rows), keeps the residual stream x, its normalized copy h and one GELU'd
// hidden chunk m in shared memory, and streams the weights through a
// [128 x 32] shared-memory chunk, in torch's [out, in] layout as the module
// holds them (no transposed copy per call). The MLP runs over the 512-wide
// hidden dimension in chunks of 128: each chunk's up-projection is GELU'd
// into m and at once multiplied into the down-projection's register
// accumulators, so the [T, 512] hidden activation never exists. Each thread
// owns a 4 x 4 output tile (4 token rows, 4 channels 32 apart), read from
// shared memory as float4s: a broadcast for the activation rows and
// conflict-free for the padded weight rows. Rows past N read as zero and are
// never stored, so the ragged edge needs no padding. Tensor cores (TF32 or
// wgmma) and double-buffered weight loads are left for a later change.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int C = 128;          // channels; the wrapper checks
constexpr int TM = 16;          // rows of each stream per block
constexpr int T = 2 * TM;       // token rows per block: [0, TM) rgb, [TM, T) depth
constexpr int NT = 256;         // threads per block: 8 warps x 4 token rows
constexpr int LDA = C + 4;      // padded row stride of the activation tiles
constexpr int HC = 128;         // hidden chunk of the MLP
constexpr int KB = 32;          // depth of one staged weight chunk
constexpr int LDW = KB + 4;     // padded row stride of the weight chunk
constexpr int SMEM_FLOATS = 3 * T * LDA + C * LDW;

static_assert(T == (NT / 32) * 4, "each warp owns 4 token rows");
static_assert(HC == C, "one thread tile serves both MLP products");

struct TailArgs {
  const float* r;
  const float* d;
  const float* scale_r;
  const float* shift_r;
  const float* scale_d;
  const float* shift_d;
  const float* mask_r;
  const float* mask_d;
  const float* alpha;
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
  float* out;
  int n_rows;
  int hidden;
};

// acc[i][j] += sum_k A[row_i][k] * W[n0 + lane + 32*j][k0 + k], k < K, where
// row_i = 4*warp + i (swapped to the other stream's row when `swap`). A is a
// [T, LDA] tile in shared memory; W is [*, ldw] in global memory and is
// staged KB columns at a time through `ws`.
__device__ __forceinline__ void gemm_acc(const float* A, bool swap, const float* __restrict__ W,
                                         int ldw, int n0, int k0, int K, float* ws,
                                         float acc[4][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int kc = 0; kc < K; kc += KB) {
    for (int idx = threadIdx.x; idx < C * (KB / 4); idx += NT) {
      const int n = idx / (KB / 4);
      const int k4 = (idx % (KB / 4)) * 4;
      const float4 w = __ldg(reinterpret_cast<const float4*>(
          W + static_cast<size_t>(n0 + n) * ldw + k0 + kc + k4));
      *reinterpret_cast<float4*>(ws + n * LDW + k4) = w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KB; k += 4) {
      float4 a[4];
      float4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int row = warp * 4 + i;
        if (swap) row = (row + TM) % T;
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

// dst[row] = LN(src[row]) * scale + bias for this warp's 4 token rows.
__device__ __forceinline__ void layernorm_rows(const float* src, float* dst,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = warp * 4 + i;
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      dst[row * LDA + c] = (v[j] - mu) * inv * __ldg(scale + c) + __ldg(bias + c);
    }
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

__global__ void __launch_bounds__(NT) fused_bn_blend_tail_kernel(const TailArgs a) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [T, LDA] residual stream
  float* hs = xs + T * LDA;                      // [T, LDA] normalized stream
  float* ms = hs + T * LDA;                      // [T, LDA] GELU(hidden chunk)
  float* ws = ms + T * LDA;                      // [C, LDW] weight chunk
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long row0 = static_cast<long>(blockIdx.x) * TM;

  // 1. BN affine + bottom-k alpha blend; rows past n_rows read as zero.
  for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
    const int i = idx / C;
    const int c = idx % C;
    const long g = row0 + i;
    float r = 0.f;
    float d = 0.f;
    if (g < a.n_rows) {
      r = __ldg(a.r + g * C + c);
      d = __ldg(a.d + g * C + c);
    }
    const float rn = r * __ldg(a.scale_r + c) + __ldg(a.shift_r + c);
    const float dn = d * __ldg(a.scale_d + c) + __ldg(a.shift_d + c);
    const float al = __ldg(a.alpha + c);
    const float mr = __ldg(a.mask_r + c);
    const float md = __ldg(a.mask_d + c);
    xs[i * LDA + c] = mr * (al * rn + (1.f - al) * dn) + (1.f - mr) * rn;
    xs[(i + TM) * LDA + c] = md * (al * dn + (1.f - al) * rn) + (1.f - md) * dn;
  }
  __syncthreads();

  // 2. exact two-token attention as a value swap: x_r += LN1(x_d) Wvp^T + b
  layernorm_rows(xs, hs, a.norm1_scale, a.norm1_bias);
  __syncthreads();
  float acc[4][4];
  zero(acc);
  gemm_acc(hs, true, a.wvp, C, 0, 0, C, ws, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      float* x = xs + (warp * 4 + i) * LDA + c;
      *x = (*x + acc[i][j]) + __ldg(a.proj_bias + c);
    }
  }
  __syncthreads();

  // 3. MLP over hidden chunks: acc2 = W2 GELU(W1 LN2(x) + b1)
  layernorm_rows(xs, hs, a.norm2_scale, a.norm2_bias);
  __syncthreads();
  float acc2[4][4];
  zero(acc2);
  for (int h0 = 0; h0 < a.hidden; h0 += HC) {
    zero(acc);
    gemm_acc(hs, false, a.mlp1_weight, C, h0, 0, C, ws, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;
        const float m = acc[i][j] + __ldg(a.mlp1_bias + h0 + c);
        ms[(warp * 4 + i) * LDA + c] = 0.5f * m * (1.f + erff(m * 0.7071067811865476f));
      }
    }
    __syncthreads();
    gemm_acc(ms, false, a.mlp2_weight, a.hidden, 0, h0, HC, ws, acc2);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      float* x = xs + (warp * 4 + i) * LDA + c;
      *x = *x + (acc2[i][j] + __ldg(a.mlp2_bias + c));
    }
  }
  __syncthreads();

  // 4. out = (LN_out(x_r) + LN_out(x_d)) / 2
  layernorm_rows(xs, hs, a.norm_out_scale, a.norm_out_bias);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
    const int i = idx / C;
    const int c = idx % C;
    const long g = row0 + i;
    if (g < a.n_rows) a.out[g * C + c] = 0.5f * (hs[i * LDA + c] + hs[(i + TM) * LDA + c]);
  }
}

}  // namespace

extern "C" int r3d_fused_bn_blend_tail(
    const float* r, const float* d, const float* scale_r, const float* shift_r,
    const float* scale_d, const float* shift_d, const float* mask_r, const float* mask_d,
    const float* alpha, const float* norm1_scale, const float* norm1_bias, const float* wvp,
    const float* proj_bias, const float* norm2_scale, const float* norm2_bias,
    const float* mlp1_weight, const float* mlp1_bias, const float* mlp2_weight,
    const float* mlp2_bias, const float* norm_out_scale, const float* norm_out_bias,
    float* out, int n_rows, int channels, int hidden, void* stream) {
  if (channels != C || hidden <= 0 || hidden % HC != 0 || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const int smem = SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fused_bn_blend_tail_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TailArgs a{r, d, scale_r, shift_r, scale_d, shift_d, mask_r, mask_d, alpha,
                   norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale, norm2_bias,
                   mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias, norm_out_scale,
                   norm_out_bias, out, n_rows, hidden};
  const dim3 grid((n_rows + TM - 1) / TM);
  fused_bn_blend_tail_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
