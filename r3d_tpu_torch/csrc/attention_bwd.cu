// Attention backward: dq, dk, dv (and the bias's cotangent) of
// out = (softmax(q k^T * scale + bias) * keep) v, keep the dropout mask
// scaled 1/(1-p), or 1 everywhere at rate 0.
//
// Replaces the Pallas kernel r3d_tpu/ops/attention.py:215
// `_bwd_kernel_dropout` (launched by `_pallas_attention_bwd`, pallas_call at
// :337), the backward of both `flash_attention` (rate 0) and
// `flash_attention_dropout`. With w the softmax weights, g the cotangent of
// out and D = rowsum(g o out) = sum_k w_k keep_k (g . v_k):
//
//   dv_k = sum_q w_qk keep_qk g_q       ds_qk = w_qk (keep_qk (g_q . v_k) - D_q)
//   dq_q = scale sum_k ds_qk k_k        dk_k = scale sum_q ds_qk q_q
//   dbias_k = sum over heads and queries of ds_qk
//
// What bounds it on the H100: bytes. It reads q, g, k, v and the bias once
// and writes dq, dk and dv once; it recomputes D from q, k, v and g and reads
// no forward output (4*(3*B*H*Lq*D + 4*B*H*Lk*D + B*Lk) = 8.5 MB at B = H = 8,
// Lq = 8, Lk = 512, D = 16) for about 10*Lq*Lk*D flops per (batch, head),
// about 5 flops per byte at Lq = 8.
//
// What the design does about it. The TPU kernel sums dk, dv and dbias over
// its sequential grid of query tiles. Here one block owns one (batch, head)
// and walks its query tiles of 8 (one warp per query) itself, so dk and dv
// need no sum across blocks; on the model's path Lq = 8 is one tile. For
// each tile a first pass over the keys, in chunks of 32 staged through
// shared memory (one key per lane), recomputes each query's running max m,
// sum l and D with an online softmax; a second pass recomputes the weights,
// redraws the dropout mask from (seed, element index) exactly as the forward
// (attention.cu) drew it, and leaves each chunk's w*keep and ds in shared
// memory. Then the block's threads take (key, dim) pairs to add sum_q of
// those times g and q into dk and dv (each element owned by one thread, no
// atomics), and (query, dim) pairs to sum dq in registers across the chunks.
// Keys past Lk score -inf and weigh nothing, queries past Lq are zero, and a
// row whose every score is -inf (l = 0) gives zero gradients, not NaN. dbias
// goes to a per-(batch, head) slice that the wrapper sums over heads, and
// only when the bias needs a gradient.
//
// bf16 (the 50salads decoder: Lq = 20, Lk = 256 or 512, D = 64): q, k, v, g
// are read as bf16 and every product and sum is fp32, as in the TPU kernel,
// which casts g and the weights to fp32 (attention.py:230-253); dq is
// written in bf16, and dk and dv stay fp32 here and are rounded to bf16 once
// by the wrapper, as the TPU kernel's fp32 outputs are (attention.py:365-366).

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int QB = 8;     // queries per tile, one warp each
constexpr int KC = 32;    // keys per shared-memory stage, one lane each
constexpr int NT = QB * 32;

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(NT)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dbias, int H, int Lq, int Lk, float scale,
                     uint32_t seed, uint32_t threshold, float keep_scale) {
  constexpr int LDK = D + 1;                          // conflict-free row reads by lane
  constexpr int DQ_PER_T = (QB * D + NT - 1) / NT;    // (query, dim) pairs per thread
  constexpr int KV_PER_T = (KC * D + NT - 1) / NT;    // (key, dim) pairs per thread
  __shared__ float ks[KC * LDK];
  __shared__ float vs[KC * LDK];
  __shared__ float bs[KC];
  __shared__ float qs[QB * D];
  __shared__ float gs[QB * D];
  __shared__ float wk[QB * KC];   // w * keep of the chunk
  __shared__ float ds[QB * KC];   // ds of the chunk (before the scale)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t kv0 = static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;

  for (int q0 = 0; q0 < Lq; q0 += QB) {
    const int qi = q0 + warp;
    const bool q_ok = qi < Lq;
    __syncthreads();  // the previous tile is done with qs and gs
    for (int idx = threadIdx.x; idx < QB * D; idx += NT) {
      const int w = idx / D;
      const bool ok = q0 + w < Lq;
      const size_t off = (static_cast<size_t>(bh) * Lq + q0 + w) * D + idx % D;
      qs[idx] = ok ? r3d::to_float(q[off]) : 0.f;
      gs[idx] = ok ? r3d::to_float(g[off]) : 0.f;
    }

    // pass 1: running max m, sum l and D-numerator dn of this warp's query
    float m = -INFINITY;
    float l = 0.f;
    float dn = 0.f;
    for (int j0 = 0; j0 < Lk; j0 += KC) {
      const int nk = min(KC, Lk - j0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < KC * D; idx += NT) {
        const int j = idx / D;
        const int dd = idx % D;
        const bool ok = j < nk;
        ks[j * LDK + dd] = ok ? r3d::to_float(k[kv0 + static_cast<size_t>(j0 + j) * D + dd]) : 0.f;
        vs[j * LDK + dd] = ok ? r3d::to_float(v[kv0 + static_cast<size_t>(j0 + j) * D + dd]) : 0.f;
      }
      if (threadIdx.x < KC) {
        bs[threadIdx.x] =
            (threadIdx.x < nk && biasb != nullptr) ? biasb[j0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      float s = -INFINITY;
      float gv = 0.f;
      if (lane < nk) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dot = fmaf(qs[warp * D + d], ks[lane * LDK + d], dot);
          gv = fmaf(gs[warp * D + d], vs[lane * LDK + d], gv);
        }
        s = dot * scale + bs[lane];
      }
      float km = 1.f;
      if (kDropout) {
        const uint32_t idx = (static_cast<uint32_t>(bh) * Lq + qi) * Lk + j0 + lane;
        km = r3d::dropout_bits(seed, idx) >= threshold ? keep_scale : 0.f;
      }
      const float m_new = fmaxf(m, r3d::warp_max(s));
      const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
      const float p = s == -INFINITY ? 0.f : expf(s - m_new);
      l = l * corr + r3d::warp_sum(p);
      dn = dn * corr + r3d::warp_sum(p * km * gv);
      m = m_new;
    }
    const float inv_l = l > 0.f ? 1.f / l : 0.f;
    const float drow = dn * inv_l;

    // pass 2: w*keep and ds per chunk, then dk, dv (and dbias) and dq
    float dq_acc[DQ_PER_T];
#pragma unroll
    for (int t = 0; t < DQ_PER_T; ++t) dq_acc[t] = 0.f;
    for (int j0 = 0; j0 < Lk; j0 += KC) {
      const int nk = min(KC, Lk - j0);
      __syncthreads();  // the previous chunk's wk, ds, ks and vs are consumed
      for (int idx = threadIdx.x; idx < KC * D; idx += NT) {
        const int j = idx / D;
        const int dd = idx % D;
        const bool ok = j < nk;
        ks[j * LDK + dd] = ok ? r3d::to_float(k[kv0 + static_cast<size_t>(j0 + j) * D + dd]) : 0.f;
        vs[j * LDK + dd] = ok ? r3d::to_float(v[kv0 + static_cast<size_t>(j0 + j) * D + dd]) : 0.f;
      }
      if (threadIdx.x < KC) {
        bs[threadIdx.x] =
            (threadIdx.x < nk && biasb != nullptr) ? biasb[j0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      float s = -INFINITY;
      float gv = 0.f;
      if (lane < nk) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dot = fmaf(qs[warp * D + d], ks[lane * LDK + d], dot);
          gv = fmaf(gs[warp * D + d], vs[lane * LDK + d], gv);
        }
        s = dot * scale + bs[lane];
      }
      float km = 1.f;
      if (kDropout) {
        const uint32_t idx = (static_cast<uint32_t>(bh) * Lq + qi) * Lk + j0 + lane;
        km = r3d::dropout_bits(seed, idx) >= threshold ? keep_scale : 0.f;
      }
      const float w = (q_ok && s != -INFINITY) ? expf(s - m) * inv_l : 0.f;
      wk[warp * KC + lane] = w * km;
      ds[warp * KC + lane] = w * (km * gv - drow);
      __syncthreads();

#pragma unroll
      for (int t = 0; t < KV_PER_T; ++t) {
        const int idx = threadIdx.x + t * NT;
        const int j = idx / D;
        const int dd = idx % D;
        if (idx < KC * D && j < nk) {
          float a_v = 0.f;
          float a_k = 0.f;
#pragma unroll
          for (int w2 = 0; w2 < QB; ++w2) {
            a_v = fmaf(wk[w2 * KC + j], gs[w2 * D + dd], a_v);
            a_k = fmaf(ds[w2 * KC + j], qs[w2 * D + dd], a_k);
          }
          const size_t off = kv0 + static_cast<size_t>(j0 + j) * D + dd;
          dv[off] += a_v;
          dk[off] += a_k * scale;
        }
      }
      if (dbias != nullptr && threadIdx.x < nk) {
        float a_b = 0.f;
#pragma unroll
        for (int w2 = 0; w2 < QB; ++w2) a_b += ds[w2 * KC + threadIdx.x];
        dbias[static_cast<size_t>(bh) * Lk + j0 + threadIdx.x] += a_b;
      }
#pragma unroll
      for (int t = 0; t < DQ_PER_T; ++t) {
        const int idx = threadIdx.x + t * NT;
        if (idx < QB * D) {
          const int w2 = idx / D;
          const int dd = idx % D;
          float a_q = dq_acc[t];
          for (int j = 0; j < nk; ++j) a_q = fmaf(ds[w2 * KC + j], ks[j * LDK + dd], a_q);
          dq_acc[t] = a_q;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < DQ_PER_T; ++t) {
      const int idx = threadIdx.x + t * NT;
      if (idx < QB * D && q0 + idx / D < Lq) {
        dq[(static_cast<size_t>(bh) * Lq + q0) * D + idx] = r3d::from_float<T>(dq_acc[t] * scale);
      }
    }
  }
}

template <typename T, int D, bool kDropout>
int launch(const T* q, const T* k, const T* v, const float* bias, const T* g, T* dq, float* dk,
           float* dv, float* dbias, int B, int H, int Lq, int Lk, float scale, uint32_t seed,
           uint32_t threshold, float keep_scale, cudaStream_t stream) {
  attention_bwd_kernel<T, D, kDropout><<<B * H, NT, 0, stream>>>(
      q, k, v, bias, g, dq, dk, dv, dbias, H, Lq, Lk, scale, seed, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDropout>
int dispatch(const T* q, const T* k, const T* v, const float* bias, const T* g, T* dq, float* dk,
             float* dv, float* dbias, int B, int H, int Lq, int Lk, int D, float scale,
             uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16, kDropout>(q, k, v, bias, g, dq, dk, dv, dbias, B, H, Lq, Lk, scale,
                                     seed, threshold, keep_scale, s);
    case 32:
      return launch<T, 32, kDropout>(q, k, v, bias, g, dq, dk, dv, dbias, B, H, Lq, Lk, scale,
                                     seed, threshold, keep_scale, s);
    case 64:
      return launch<T, 64, kDropout>(q, k, v, bias, g, dq, dk, dv, dbias, B, H, Lq, Lk, scale,
                                     seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int run(const T* q, const T* k, const T* v, const float* bias, const T* g, T* dq, float* dk,
        float* dv, float* dbias, int B, int H, int Lq, int Lk, int D, float scale, int dropout,
        uint32_t seed, uint32_t threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t kv_bytes = static_cast<size_t>(B) * H * Lk * D * sizeof(float);
  cudaError_t err = cudaMemsetAsync(dk, 0, kv_bytes, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, kv_bytes, s);
  if (err == cudaSuccess && dbias != nullptr) {
    err = cudaMemsetAsync(dbias, 0, static_cast<size_t>(B) * H * Lk * sizeof(float), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return dropout ? dispatch<T, true>(q, k, v, bias, g, dq, dk, dv, dbias, B, H, Lq, Lk, D, scale,
                                     seed, threshold, keep_scale, s)
                 : dispatch<T, false>(q, k, v, bias, g, dq, dk, dv, dbias, B, H, Lq, Lk, D,
                                      scale, seed, threshold, keep_scale, s);
}

}  // namespace

// q, g, dq [B, H, Lq, D]; k, v, dk, dv [B, H, Lk, D]; bias [B, Lk] or null;
// dbias [B, H, Lk] or null (per-head sums of ds, for the caller to sum over
// heads). All fp32 and contiguous; D must be 16, 32 or 64. With `dropout`,
// the keep mask is drawn as r3d_attention_fwd_dropout draws it.
extern "C" int r3d_attention_bwd(const float* q, const float* k, const float* v,
                                 const float* bias, const float* g, float* dq, float* dk,
                                 float* dv, float* dbias, int B, int H, int Lq, int Lk, int D,
                                 float scale, int dropout, uint32_t seed, uint32_t threshold,
                                 float keep_scale, void* stream) {
  return run<float>(q, k, v, bias, g, dq, dk, dv, dbias, B, H, Lq, Lk, D, scale, dropout, seed,
                    threshold, keep_scale, stream);
}

// As r3d_attention_bwd with bf16 q, k, v, g and dq; dk, dv and dbias stay fp32.
extern "C" int r3d_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, const float* bias,
                                      const __nv_bfloat16* g, __nv_bfloat16* dq, float* dk,
                                      float* dv, float* dbias, int B, int H, int Lq, int Lk,
                                      int D, float scale, int dropout, uint32_t seed,
                                      uint32_t threshold, float keep_scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, bias, g, dq, dk, dv, dbias, B, H, Lq, Lk, D, scale,
                            dropout, seed, threshold, keep_scale, stream);
}
