// The fp32 attention forward's kernel body, out = softmax(q k^T * scale +
// bias) v per (batch, head) with an online fp32 softmax and optional dropout
// on the weights. Only cross_attention.cu instantiates it, for K6 in fp32 on
// the native layout. K3 and K4 have bodies of their own in attention.cu (the
// fp32 cluster kernel and the bf16 split kernel), as K6 in bf16 has in
// cross_attention.cu.
//
// Layouts. Head-major (kNative false): q, out [B, H, Lq, D], k, v
// [B, H, Lk, D]. Native (kNative true): q, out [B, Lq, C], k, v [B, Lk, C]
// with C = H * D and head h in columns [h*D, (h+1)*D), the projections'
// layout; then the kernel also writes the softmax statistics m (row max of
// the scores) and l (sum of exp(score - m)) [B, H, Lq] for the backward.
//
// Design. One block per (batch*head, tile of 8 queries), one warp per query.
// The block stages K, V and the bias in chunks of 32 keys through shared
// memory, so each key is read from device memory once per block, and keeps
// an online softmax (running max m, running sum l, rescaled accumulator)
// over the chunks, so it is right for any Lk. Lane j scores key j of the
// chunk against the query held in registers; for p.V each lane owns one of
// the D output dims and a group of keys, reads the weights with shuffles,
// and the key groups are summed at the end. The ragged last chunk is masked
// in the kernel (no padding of K/V), so a fully masked row averages over the
// real keys only. A score of -inf weighs 0, and a row whose every score is
// -inf gives 0 and (m, l) = (-inf, 0), not NaN. In fp32 the TPU kernels'
// bf16 rounding of the weights is the identity, so one online pass serves
// both rounding points. The dropout mask is r3d::dropout_bits of the element
// index ((b*H + h)*Lq + q)*Lk + k in both layouts, so the backwards redraw it.
#pragma once

#include "common.cuh"

namespace r3d {

constexpr int kAttnQB = 8;    // queries per block, one warp each
constexpr int kAttnKC = 32;   // keys per shared-memory stage, one lane each

template <int D, bool kDropout, bool kNative>
__global__ void __launch_bounds__(kAttnQB * 32)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                     int H, int Lq, int Lk, float scale, uint32_t seed, uint32_t threshold,
                     float keep_scale) {
  constexpr int QB = kAttnQB;
  constexpr int KC = kAttnKC;
  constexpr int LDK = D + 1;              // padded so lane j reads row j conflict-free
  constexpr int DW = D < 32 ? D : 32;     // lanes across the output dims
  constexpr int G = 32 / DW;              // key groups per warp
  constexpr int DPL = D / DW;             // output dims per lane
  __shared__ float ks[KC * LDK];
  __shared__ float vs[KC * D];
  __shared__ float bs[KC];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int qi = blockIdx.y * QB + warp;
  const bool q_ok = qi < Lq;
  const int ld = kNative ? H * D : D;     // elements from one row of q, k, v, out to the next
  const size_t kv_off = kNative ? static_cast<size_t>(b) * Lk * ld + (bh % H) * D
                                : static_cast<size_t>(bh) * Lk * D;
  const size_t q_off = kNative ? (static_cast<size_t>(b) * Lq + qi) * ld + (bh % H) * D
                               : (static_cast<size_t>(bh) * Lq + qi) * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = q_ok ? q[q_off + d] : 0.f;
  const int dl = lane % DW;
  const int kg = lane / DW;
  float m = -INFINITY;
  float l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;

  for (int j0 = 0; j0 < Lk; j0 += KC) {
    const int nk = min(KC, Lk - j0);
    __syncthreads();  // the previous stage is consumed
    for (int idx = threadIdx.x; idx < KC * D; idx += QB * 32) {
      const int j = idx / D;
      const int dd = idx % D;
      const bool ok = j < nk;
      const size_t g = static_cast<size_t>(j0 + j) * ld + dd;
      ks[j * LDK + dd] = ok ? kb[g] : 0.f;
      vs[j * D + dd] = ok ? vb[g] : 0.f;
    }
    if (threadIdx.x < KC) {
      bs[threadIdx.x] = (threadIdx.x < nk && biasb != nullptr) ? biasb[j0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    float s = -INFINITY;  // keys past Lk weigh nothing
    if (lane < nk) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[lane * LDK + d], dot);
      s = dot * scale + bs[lane];
    }
    const float m_new = fmaxf(m, warp_max(s));   // online softmax
    const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
    const float p = s == -INFINITY ? 0.f : expf(s - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
    float pv = p;  // the weight's share of the numerator
    if (kDropout) {
      const uint32_t idx = (static_cast<uint32_t>(bh) * Lq + qi) * Lk + j0 + lane;
      pv = dropout_bits(seed, idx) >= threshold ? p * keep_scale : 0.f;
    }
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = kg; j < KC; j += G) {
      const float pj = __shfl_sync(kFullMask, pv, j);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] = fmaf(pj, vs[j * D + dl + 32 * e], acc[e]);
    }
  }
#pragma unroll
  for (int off = DW; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] += __shfl_xor_sync(kFullMask, acc[e], off);
  }
  if (q_ok && kg == 0) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* o = out + q_off;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[dl + 32 * e] = acc[e] * inv;
    if (kNative && lane == 0) {
      m_out[static_cast<size_t>(bh) * Lq + qi] = m;
      l_out[static_cast<size_t>(bh) * Lq + qi] = l;
    }
  }
}

}  // namespace r3d
