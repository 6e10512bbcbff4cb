// Native-layout cross-attention backward: dq, dk, dv and the bias's cotangent
// of out = (softmax(q k^T * scale + bias) * keep) v per head, in the layout of
// cross_attention.cu (q, g, o [B, Lq, C]; k, v [B, S, C]; C = H * D), from
// the forward's output o and its softmax statistics m, l [B, H, Lq]:
//
//   w = exp(s - m) / max(l, 1e-30)      delta_q = sum_d g_qd o_qd (per head)
//   dv_k = sum_q w_qk keep_qk g_q       ds_qk = w_qk (keep_qk (g_q . v_k) - delta_q)
//   dq_q = scale sum_k ds_qk k_k        dk_k = scale sum_q ds_qk q_q
//   dbias_k = sum over heads and queries of ds_qk
//
// Replaces the Pallas kernel r3d_tpu/ops/cross_attention.py:115 `_bwd_kernel`
// (launched by `_cross_attention_bwd_impl`, pallas_call at :262), K7. As it
// does: g and o are read as fp32; w * keep stays fp32 for dv; in bf16, ds is
// rounded to the input type before the dq and dk products (the bias's
// cotangent sums the unrounded ds); dq, dk, dv are written in the input type
// and dbias in fp32. The dropout mask is redrawn from (seed, element index)
// exactly as cross_attention.cu drew it.
//
// What bounds it on the H100: bytes. It must read q, g, o (B*Lq*C each), K
// and V (B*S*C each), m, l and the bias, and write dq, dk, dv and dbias once:
// 102 MB at B = 8, Lq = 20, S = 3,100, C = 512 in bf16, 0.030 ms at 3.35 TB/s,
// against about 10*B*Lq*S*C = 2.5 GFLOP (0.0026 ms on bf16 tensor cores).
//
// What the design does about it (a first, simple kernel). Each key belongs
// to one block: block (key block of KB = 64, batch) walks the heads, and per
// head stages q, g (all Lq <= 64 queries), the block's K and V columns of
// the head, and the statistics in shared memory (fp32), then
//   (1) every thread takes (query, key) pairs: the score, g . v, w, w*keep
//       and ds into shared memory;
//   (2) every thread takes (key, dim) pairs: dk and dv of its keys, complete
//       in this block, written once in the input type;
//   (3) every thread takes (query, dim) pairs: this block's share of dq,
//       written to its own slice of an fp32 scratch [n_blocks, B, Lq, C].
// A second launch sums the slices in block order into dq: deterministic, no
// atomics (as fuser_tail_bwd.cu does for the parameter gradients). dbias
// accumulates in registers over heads and queries and is summed over the
// block's threads in a fixed order. Keys past S read as zero and are not
// written.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int KB = 64;    // keys per block (ops/cross_attention.py: BWD_BLOCK_KEYS)
constexpr int NT = 256;   // threads per block; NT % KB == 0
constexpr int MAXQ = 64;  // queries held in shared memory (ops/cross_attention.py: MAX_QUERIES)

template <int D>
size_t smem_bytes(int Lq) {
  return sizeof(float) * (2 * Lq * D + 2 * KB * (D + 1) + 2 * Lq * KB + 3 * Lq + KB + NT);
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(NT)
cross_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ bias,
                           const T* __restrict__ g, const T* __restrict__ o,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           float* __restrict__ dq_part, T* __restrict__ dk,
                           T* __restrict__ dv, float* __restrict__ dbias, int B, int H, int Lq,
                           int S, float scale, uint32_t seed, uint32_t threshold,
                           float keep_scale) {
  constexpr int LDK = D + 1;   // row j of ks/vs conflict-free across lanes
  extern __shared__ float smem[];
  float* qs = smem;                 // [Lq, D]
  float* gs = qs + Lq * D;          // [Lq, D]
  float* ks = gs + Lq * D;          // [KB, LDK]
  float* vs = ks + KB * LDK;        // [KB, LDK]
  float* wk = vs + KB * LDK;        // [Lq, KB]  w * keep
  float* dsr = wk + Lq * KB;        // [Lq, KB]  ds rounded to T
  float* delta = dsr + Lq * KB;     // [Lq]
  float* mrow = delta + Lq;         // [Lq]
  float* linv = mrow + Lq;          // [Lq]  1 / max(l, 1e-30)
  float* bs = linv + Lq;            // [KB]
  float* red = bs + KB;             // [NT]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int blk = blockIdx.x;
  const int b = blockIdx.y;
  const int j0 = blk * KB;
  const int nk = min(KB, S - j0);
  const int C = H * D;
  const size_t q0 = static_cast<size_t>(b) * Lq * C;
  const size_t k0 = (static_cast<size_t>(b) * S + j0) * C;

  if (tid < KB) {
    bs[tid] = (tid < nk && bias != nullptr) ? bias[static_cast<size_t>(b) * S + j0 + tid] : 0.f;
  }
  float db_acc = 0.f;   // this thread's key is tid % KB (NT % KB == 0)

  for (int h = 0; h < H; ++h) {
    __syncthreads();   // the previous head is done with every buffer
    for (int idx = tid; idx < Lq * D; idx += NT) {
      const size_t off = q0 + static_cast<size_t>(idx / D) * C + h * D + idx % D;
      qs[idx] = r3d::to_float(q[off]);
      gs[idx] = r3d::to_float(g[off]);
    }
    for (int idx = tid; idx < KB * D; idx += NT) {
      const int j = idx / D;
      const int d = idx % D;
      const bool ok = j < nk;
      const size_t off = k0 + static_cast<size_t>(j) * C + h * D + d;
      ks[j * LDK + d] = ok ? r3d::to_float(k[off]) : 0.f;
      vs[j * LDK + d] = ok ? r3d::to_float(v[off]) : 0.f;
    }
    for (int qi = warp; qi < Lq; qi += NT / 32) {
      const size_t off = q0 + static_cast<size_t>(qi) * C + h * D;
      float a = 0.f;
      for (int d = lane; d < D; d += 32) {
        a += r3d::to_float(g[off + d]) * r3d::to_float(o[off + d]);
      }
      a = r3d::warp_sum(a);
      if (lane == 0) {
        const size_t st = (static_cast<size_t>(b) * H + h) * Lq + qi;
        delta[qi] = a;
        mrow[qi] = m_in[st];
        linv[qi] = 1.f / fmaxf(l_in[st], 1e-30f);
      }
    }
    __syncthreads();

    // (1) (query, key) pairs: w * keep and ds
    for (int idx = tid; idx < Lq * KB; idx += NT) {
      const int qi = idx / KB;
      const int j = idx % KB;
      float wkv = 0.f;
      float dsv = 0.f;
      if (j < nk) {
        float dot = 0.f;
        float gv = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dot = fmaf(qs[qi * D + d], ks[j * LDK + d], dot);
          gv = fmaf(gs[qi * D + d], vs[j * LDK + d], gv);
        }
        const float s = dot * scale + bs[j];
        const float w = expf(s - mrow[qi]) * linv[qi];
        float km = 1.f;
        if (kDropout) {
          const uint32_t el = ((static_cast<uint32_t>(b) * H + h) * Lq + qi) * S + j0 + j;
          km = r3d::dropout_bits(seed, el) >= threshold ? keep_scale : 0.f;
        }
        wkv = w * km;
        dsv = w * (gv * km - delta[qi]);
      }
      wk[idx] = wkv;
      dsr[idx] = r3d::round_to<T>(dsv);
      db_acc += dsv;
    }
    __syncthreads();

    // (2) (key, dim) pairs: dk and dv of this block's keys
    for (int idx = tid; idx < KB * D; idx += NT) {
      const int j = idx / D;
      const int d = idx % D;
      if (j >= nk) continue;
      float a_v = 0.f;
      float a_k = 0.f;
      for (int qi = 0; qi < Lq; ++qi) {
        a_v = fmaf(wk[qi * KB + j], gs[qi * D + d], a_v);
        a_k = fmaf(dsr[qi * KB + j], qs[qi * D + d], a_k);
      }
      const size_t off = k0 + static_cast<size_t>(j) * C + h * D + d;
      dv[off] = r3d::from_float<T>(a_v);
      dk[off] = r3d::from_float<T>(a_k * scale);
    }

    // (3) (query, dim) pairs: this block's share of dq
    for (int idx = tid; idx < Lq * D; idx += NT) {
      const int qi = idx / D;
      const int d = idx % D;
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < KB; ++j) a = fmaf(dsr[qi * KB + j], ks[j * LDK + d], a);
      dq_part[((static_cast<size_t>(blk) * B + b) * Lq + qi) * C + h * D + d] = a * scale;
    }
  }

  if (dbias != nullptr) {
    red[tid] = db_acc;
    __syncthreads();
    if (tid < nk) {
      float a = 0.f;
      for (int r = tid; r < NT; r += KB) a += red[r];
      dbias[static_cast<size_t>(b) * S + j0 + tid] = a;
    }
  }
}

// dq[i] = sum over blocks, in block order, of dq_part[blk, i].
template <typename T>
__global__ void dq_reduce_kernel(const float* __restrict__ part, T* __restrict__ dq,
                                 int n_blocks, size_t n) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = 0.f;
    for (int blk = 0; blk < n_blocks; ++blk) a += part[static_cast<size_t>(blk) * n + i];
    dq[i] = r3d::from_float<T>(a);
  }
}

template <typename T, int D, bool kDropout>
int launch(const void* q, const void* k, const void* v, const float* bias, const void* g,
           const void* o, const float* m, const float* l, float* dq_part, void* dq, void* dk,
           void* dv, float* dbias, int B, int Lq, int S, int H, int n_blocks, float scale,
           uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(cross_attention_bwd_kernel<T, D, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes<D>(MAXQ)));
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_attention_bwd_kernel<T, D, kDropout><<<dim3(n_blocks, B), NT, smem_bytes<D>(Lq), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(g), static_cast<const T*>(o), m, l, dq_part, static_cast<T*>(dk),
      static_cast<T*>(dv), dbias, B, H, Lq, S, scale, seed, threshold, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * Lq * H * D;
  const size_t want = (n + 255) / 256;
  const int grid = static_cast<int>(want < 1024 ? want : 1024);
  dq_reduce_kernel<T><<<grid, 256, 0, stream>>>(dq_part, static_cast<T*>(dq), n_blocks, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kDropout>
int dispatch_d(int D, const void* q, const void* k, const void* v, const float* bias,
               const void* g, const void* o, const float* m, const float* l, float* dq_part,
               void* dq, void* dk, void* dv, float* dbias, int B, int Lq, int S, int H,
               int n_blocks, float scale, uint32_t seed, uint32_t threshold, float keep_scale,
               cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16, kDropout>(q, k, v, bias, g, o, m, l, dq_part, dq, dk, dv, dbias, B,
                                     Lq, S, H, n_blocks, scale, seed, threshold, keep_scale, s);
    case 32:
      return launch<T, 32, kDropout>(q, k, v, bias, g, o, m, l, dq_part, dq, dk, dv, dbias, B,
                                     Lq, S, H, n_blocks, scale, seed, threshold, keep_scale, s);
    case 64:
      return launch<T, 64, kDropout>(q, k, v, bias, g, o, m, l, dq_part, dq, dk, dv, dbias, B,
                                     Lq, S, H, n_blocks, scale, seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int dropout, int D, const void* q, const void* k, const void* v, const float* bias,
             const void* g, const void* o, const float* m, const float* l, float* dq_part,
             void* dq, void* dk, void* dv, float* dbias, int B, int Lq, int S, int H,
             int n_blocks, float scale, uint32_t seed, uint32_t threshold, float keep_scale,
             cudaStream_t s) {
  return dropout ? dispatch_d<T, true>(D, q, k, v, bias, g, o, m, l, dq_part, dq, dk, dv, dbias,
                                       B, Lq, S, H, n_blocks, scale, seed, threshold,
                                       keep_scale, s)
                 : dispatch_d<T, false>(D, q, k, v, bias, g, o, m, l, dq_part, dq, dk, dv,
                                        dbias, B, Lq, S, H, n_blocks, scale, seed, threshold,
                                        keep_scale, s);
}

}  // namespace

// dtype 0: fp32, 1: bf16 (q, k, v, g, o, dq, dk, dv). q, g, o, dq [B, Lq, C];
// k, v, dk, dv [B, S, C]; bias [B, S] fp32 or null; m, l [B, H, Lq] fp32;
// dq_part fp32 scratch [n_blocks, B, Lq, C] with n_blocks = ceil(S / 64);
// dbias [B, S] fp32 or null (then not computed). All contiguous; C = H * D
// with D 16, 32 or 64; Lq <= 64. With `dropout`, the keep mask is drawn as
// r3d_cross_attention_fwd draws it.
extern "C" int r3d_cross_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const float* bias, const void* g, const void* o,
                                       const float* m, const float* l, float* dq_part, void* dq,
                                       void* dk, void* dv, float* dbias, int B, int Lq, int S,
                                       int H, int D, int n_blocks, float scale, int dropout,
                                       uint32_t seed, uint32_t threshold, float keep_scale,
                                       void* stream) {
  if (B <= 0 || Lq <= 0 || Lq > MAXQ || S <= 0 || H <= 0 || n_blocks != (S + KB - 1) / KB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(dropout, D, q, k, v, bias, g, o, m, l, dq_part, dq, dk, dv, dbias, B,
                             Lq, S, H, n_blocks, scale, seed, threshold, keep_scale, s);
    case 1:
      return dispatch<__nv_bfloat16>(dropout, D, q, k, v, bias, g, o, m, l, dq_part, dq, dk, dv,
                                     dbias, B, Lq, S, H, n_blocks, scale, seed, threshold,
                                     keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
