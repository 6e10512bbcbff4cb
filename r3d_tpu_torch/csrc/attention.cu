// Attention forward: out = softmax(q k^T * scale + bias) v, fp32 softmax.
//
// Replaces the Pallas kernel r3d_tpu/ops/attention.py:38 `_kernel` (launched
// by `_pallas_attention`, pallas_call at :82), the forward that
// `flash_attention` runs. On the serving path it is the decoder
// cross-attention: Lq = 8 queries against Lk = 256 or 512 keys, D = 16, B x H
// = 8 x 8, with a key-padding bias [B, 1, 1, Lk] that holds 0 or
// finfo(float32).min.
//
// What bounds it on the H100: bytes. It reads K and V once (2 * B*H*Lk*D*4 =
// 2 MB at Lk = 512) and does 4*Lq*Lk*D flops per (batch, head), 8 flops per
// byte of K/V at Lq = 8, below the fp32 ridge of 20. At these sizes the
// launch itself costs more than either bound.
//
// What the design does about it. One block per (batch*head, tile of 8
// queries), one warp per query. The block stages K, V and the bias in chunks
// of 32 keys through shared memory, so each key is read from device memory
// once per block, and keeps an online softmax (running max m, running sum l,
// rescaled accumulator) over the chunks, so it is right for any Lk. Lane j
// scores key j of the chunk against the query held in registers; for p.V
// each lane owns one of the D output dims and a group of keys, reads the
// weights with shuffles, and the key groups are summed at the end. The ragged
// last chunk is masked in the kernel (no padding of K/V). A masked key's bias
// is finfo.min, not -inf, so no score is -inf unless the caller passes -inf;
// the kernel still guards that case (weight 0, and a row whose every key is
// -inf gives 0 instead of NaN).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int QB = 8;    // queries per block, one warp each
constexpr int KC = 32;   // keys per shared-memory stage, one lane each

template <int D>
__global__ void __launch_bounds__(QB * 32)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, int H, int Lq, int Lk, float scale) {
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
  const float* kb = k + static_cast<size_t>(bh) * Lk * D;
  const float* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q_ok ? q[(static_cast<size_t>(bh) * Lq + qi) * D + d] : 0.f;
  }
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
      const size_t g = static_cast<size_t>(j0 + j) * D + dd;
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
    const float m_new = fmaxf(m, r3d::warp_max(s));
    const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
    const float p = s == -INFINITY ? 0.f : expf(s - m_new);
    l = l * corr + r3d::warp_sum(p);
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = kg; j < KC; j += G) {
      const float pj = __shfl_sync(r3d::kFullMask, p, j);
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] = fmaf(pj, vs[j * D + dl + 32 * e], acc[e]);
    }
    m = m_new;
  }
#pragma unroll
  for (int off = DW; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] += __shfl_xor_sync(r3d::kFullMask, acc[e], off);
  }
  if (q_ok && kg == 0) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* o = out + (static_cast<size_t>(bh) * Lq + qi) * D;
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[dl + 32 * e] = acc[e] * inv;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias, float* out,
           int B, int H, int Lq, int Lk, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, (Lq + QB - 1) / QB);
  attention_fwd_kernel<D><<<grid, QB * 32, 0, stream>>>(q, k, v, bias, out, H, Lq, Lk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Lq, D], k and v [B, H, Lk, D], bias [B, Lk] or null, out [B, H, Lq, D];
// all fp32 and contiguous. D must be 16, 32 or 64.
extern "C" int r3d_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* bias, float* out, int B, int H, int Lq, int Lk,
                                 int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, bias, out, B, H, Lq, Lk, scale, s);
    case 32: return launch<32>(q, k, v, bias, out, B, H, Lq, Lk, scale, s);
    case 64: return launch<64>(q, k, v, bias, out, B, H, Lq, Lk, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
