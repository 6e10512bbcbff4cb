// Attention forward: out = softmax(q k^T * scale + bias) v, fp32 softmax,
// optionally with dropout on the softmax weights.
//
// Replaces two Pallas kernels, as two instantiations of one template:
// - r3d_tpu/ops/attention.py:38 `_kernel` (launched by `_pallas_attention`,
//   pallas_call at :82), the forward that `flash_attention` runs (K3);
// - r3d_tpu/ops/attention.py:192 `_kernel_dropout` (launched by
//   `_pallas_attention_dropout`, pallas_call at :305), the training forward
//   of `flash_attention_dropout` (K4): the weights are multiplied by a keep
//   mask scaled 1/(1-p). The mask comes from a counter-based hash of (seed,
//   element index) (common.cuh), so it does not depend on the tiling, and the
//   backward (attention_bwd.cu) redraws it. With an online softmax the sum l
//   runs over all keys and the numerator over the kept ones:
//   out = sum_k e_k keep_k v_k / ((1-p) l).
// On the model's path both are the decoder cross-attention: Lq = 8 queries
// against Lk = 256 or 512 keys, D = 16, B x H = 8 x 8, with a key-padding
// bias [B, 1, 1, Lk] that holds 0 or finfo(float32).min.
//
// What bounds it on the H100: bytes. It reads K and V once (2 * B*H*Lk*D*4 =
// 2 MB at Lk = 512) and does 4*Lq*Lk*D flops per (batch, head), 8 flops per
// byte of K/V at Lq = 8, below the fp32 ridge of 20. At these sizes the
// launch itself costs more than either bound.
//
// The kernel body, its design and its bf16 rounding (the normalised weights,
// so the bf16 instantiation makes two passes over the keys) are in
// attention_fwd.cuh, shared with K6 (cross_attention.cu); here it runs on
// the head-major layout.

#include <cuda_runtime.h>

#include "attention_fwd.cuh"

namespace {

constexpr int QB = r3d::kAttnQB;

template <typename T, int D, bool kDropout>
int launch(const T* q, const T* k, const T* v, const float* bias, T* out, int B, int H, int Lq,
           int Lk, float scale, uint32_t seed, uint32_t threshold, float keep_scale,
           cudaStream_t stream) {
  const dim3 grid(B * H, (Lq + QB - 1) / QB);
  r3d::attention_fwd_kernel<T, D, kDropout, false><<<grid, QB * 32, 0, stream>>>(
      q, k, v, bias, out, nullptr, nullptr, H, Lq, Lk, scale, seed, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDropout>
int dispatch(const T* q, const T* k, const T* v, const float* bias, T* out, int B, int H, int Lq,
             int Lk, int D, float scale, uint32_t seed, uint32_t threshold, float keep_scale,
             void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<T, 16, kDropout>(q, k, v, bias, out, B, H, Lq, Lk, scale, seed, threshold,
                                     keep_scale, s);
    case 32:
      return launch<T, 32, kDropout>(q, k, v, bias, out, B, H, Lq, Lk, scale, seed, threshold,
                                     keep_scale, s);
    case 64:
      return launch<T, 64, kDropout>(q, k, v, bias, out, B, H, Lq, Lk, scale, seed, threshold,
                                     keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, Lq, D], k and v [B, H, Lk, D], bias [B, Lk] or null, out [B, H, Lq, D];
// all fp32 and contiguous. D must be 16, 32 or 64.
extern "C" int r3d_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* bias, float* out, int B, int H, int Lq, int Lk,
                                 int D, float scale, void* stream) {
  return dispatch<float, false>(q, k, v, bias, out, B, H, Lq, Lk, D, scale, 0u, 0u, 1.f, stream);
}

// As r3d_attention_fwd, with dropout on the weights: an element is kept when
// its dropout bits under `seed` are >= `threshold` (= rate * 2^32) and then
// scaled by `keep_scale` (= 1 / (1 - rate)). B*H*Lq*Lk must fit in 32 bits.
extern "C" int r3d_attention_fwd_dropout(const float* q, const float* k, const float* v,
                                         const float* bias, float* out, int B, int H, int Lq,
                                         int Lk, int D, float scale, uint32_t seed,
                                         uint32_t threshold, float keep_scale, void* stream) {
  return dispatch<float, true>(q, k, v, bias, out, B, H, Lq, Lk, D, scale, seed, threshold,
                               keep_scale, stream);
}

// The two above with bf16 q, k, v and out (the bias stays fp32).
extern "C" int r3d_attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, const float* bias,
                                      __nv_bfloat16* out, int B, int H, int Lq, int Lk, int D,
                                      float scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k, v, bias, out, B, H, Lq, Lk, D, scale, 0u, 0u, 1.f,
                                        stream);
}

extern "C" int r3d_attention_fwd_dropout_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                              const __nv_bfloat16* v, const float* bias,
                                              __nv_bfloat16* out, int B, int H, int Lq, int Lk,
                                              int D, float scale, uint32_t seed,
                                              uint32_t threshold, float keep_scale,
                                              void* stream) {
  return dispatch<__nv_bfloat16, true>(q, k, v, bias, out, B, H, Lq, Lk, D, scale, seed,
                                       threshold, keep_scale, stream);
}
