// Native-layout cross-attention forward: out = softmax(q k^T * scale + bias) v
// per head, with q [B, Lq, C] and k, v [B, S, C] in their projection layout
// (C = H * D, head h in columns [h*D, (h+1)*D)), fp32 online softmax,
// optional dropout on the weights, and the softmax statistics m (row max of
// the scores) and l (sum of exp(score - m)) [B, H, Lq] for the backward.
//
// Replaces the Pallas kernel r3d_tpu/ops/cross_attention.py:50 `_fwd_kernel`
// (launched by `_cross_attention_fwd_impl`, pallas_call at :211), K6. As it
// does, in bf16 the unnormalised weights e (times the dropout keep factor)
// are rounded to the input type before the product with V, l sums the
// unrounded e, the output is acc / l written in the input type. The dropout
// mask is r3d::dropout_bits of the element index ((b*H + h)*Lq + q)*S + k,
// the mask of attention.cu, so cross_attention_bwd.cu redraws it.
//
// On the model's path: the 50salads decoder, Lq = 20 queries against S =
// 1,024 or 3,100 keys, C = 512, H = 8, D = 64, B = 8, bf16, with a key
// padding bias [B, 1, 1, S] of 0 or finfo(float32).min.
//
// What bounds it on the H100: bytes. It must read K and V once (2*B*S*C*2 =
// 50.8 MB at the shape above, bf16) and does 4*B*Lq*S*C = 1.0 GFLOP, about
// 20 flops per byte, far below the tensor cores' ridge: 0.015 ms at 3.35 TB/s.
//
// What the design does about it (a first, simple kernel). It is the body of
// attention.cu's K3/K4 (attention_fwd.cuh) on the native layout: one block
// per (batch, head, tile of 8 queries), one warp per query, staging 32 keys
// at a time of its head's D columns of the C-wide rows through shared
// memory. Each block reads its head's [S, D] slab once, so K and V are read
// ceil(Lq / 8) times in all (3 at Lq = 20, mostly from L2). A fully masked
// row averages over the real keys only, as K3 does.

#include <cuda_runtime.h>

#include "attention_fwd.cuh"

namespace {

constexpr int QB = r3d::kAttnQB;

template <typename T, int D, bool kDropout>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           float* m, float* l, int B, int Lq, int S, int H, float scale, uint32_t seed,
           uint32_t threshold, float keep_scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Lq + QB - 1) / QB);
  r3d::attention_fwd_kernel<T, D, kDropout, true><<<grid, QB * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), m, l, H, Lq, S, scale, seed, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDropout>
int dispatch_d(int D, const void* q, const void* k, const void* v, const float* bias, void* out,
               float* m, float* l, int B, int Lq, int S, int H, float scale, uint32_t seed,
               uint32_t threshold, float keep_scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16, kDropout>(q, k, v, bias, out, m, l, B, Lq, S, H, scale, seed,
                                     threshold, keep_scale, s);
    case 32:
      return launch<T, 32, kDropout>(q, k, v, bias, out, m, l, B, Lq, S, H, scale, seed,
                                     threshold, keep_scale, s);
    case 64:
      return launch<T, 64, kDropout>(q, k, v, bias, out, m, l, B, Lq, S, H, scale, seed,
                                     threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int dropout, int D, const void* q, const void* k, const void* v, const float* bias,
             void* out, float* m, float* l, int B, int Lq, int S, int H, float scale,
             uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t s) {
  return dropout ? dispatch_d<T, true>(D, q, k, v, bias, out, m, l, B, Lq, S, H, scale, seed,
                                       threshold, keep_scale, s)
                 : dispatch_d<T, false>(D, q, k, v, bias, out, m, l, B, Lq, S, H, scale, seed,
                                        threshold, keep_scale, s);
}

}  // namespace

// dtype 0: fp32, 1: bf16 (q, k, v and out). q, out [B, Lq, C]; k, v [B, S, C];
// bias [B, S] fp32 or null; m, l [B, H, Lq] fp32; all contiguous, C = H * D
// with D 16, 32 or 64. With `dropout`, an element is kept when its dropout
// bits under `seed` are >= `threshold` and then scaled by `keep_scale`;
// B*H*Lq*S must fit in 32 bits.
extern "C" int r3d_cross_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                       const float* bias, void* out, float* m, float* l, int B,
                                       int Lq, int S, int H, int D, float scale, int dropout,
                                       uint32_t seed, uint32_t threshold, float keep_scale,
                                       void* stream) {
  if (B <= 0 || Lq <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(dropout, D, q, k, v, bias, out, m, l, B, Lq, S, H, scale, seed,
                             threshold, keep_scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(dropout, D, q, k, v, bias, out, m, l, B, Lq, S, H, scale,
                                     seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
