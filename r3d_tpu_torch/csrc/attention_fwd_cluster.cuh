// The fp32 attention forward's cluster body: out = softmax(q k^T * scale +
// bias) v per (batch, head), fp32 online softmax, optional dropout on the
// weights. Three kernels instantiate it:
// - K3 and K4 (attention.cu; `kNative` false): q, out [B, H, Lq, D], k, v
//   [B, H, Lk, D], the utkinects decoder's cross-attention in its 256 and
//   512 buckets (Lq = 8, D = 16, B x H = 8 x 8);
// - K6 in fp32 (cross_attention.cu; `kNative` true): q, out [B, Lq, C], k, v
//   [B, Lk, C] with C = H * D and head h in columns [h*D, (h+1)*D), the
//   projections' layout, and the softmax statistics m (row max of the
//   scores) and l (sum of exp(score - m)) [B, H, Lq] written out for K7:
//   the utkinects decoder's 1024 and 2000 buckets under R3D_CROSS_NATIVE=1
//   (Lq = 8, Lk = 1,024 or 2,000, C = 128, H = 8).
// A key-padding bias [B, Lk] of 0 or finfo(float32).min is added to the
// scores in both.
//
// What bounds it on the H100: bytes, K and V once (4.2 MB at Lk = 512 and
// 16.4 MB at 2,000, B = H = 8, D = 16: 0.0013 and 0.0049 ms at 3.35 TB/s)
// for 4*Lq*Lk*D flops per (batch, head): 4 flops per byte, far below the
// fp32 ridge of 20, so the products run as plain fp32 FMAs from shared
// memory and tensor cores would buy nothing. At this size the work is a few
// microseconds, so the design is about latency: every block starts its copy
// at once, each walks at most a few tiles, and there is one launch and no
// scratch in device memory.
// - Grid (n_split, ceil(Lq / 8), B*H), 2 warps a block. The keys of one
//   (batch, head) are split into n_split runs of `split_keys` (a multiple of
//   64; ops/attention.py:fp32_split_keys: 8 splits of 64 at Lk = 512, of
//   128 at 1,024, of 256 at 2,000), and the n_split blocks of one
//   (batch*head, tile of 8 queries) form one thread-block cluster: 512
//   blocks in one wave on the main paths. A block copies its first tile of
//   64 keys (K, V and the bias) with 16- and 4-byte cp.async at its start
//   (a head's 64-byte slice of a native row stays 16-byte aligned); a split
//   of more tiles walks them through a ring of two, the copy of the next
//   under the math of this one.
// - A tile: lane j of warp w scores key 32w + j against the 8 queries (q
//   read from shared memory as broadcast float4s), the tile's row max comes
//   from warp maxima through shared memory, the weights p = exp(s - m) of
//   the running max go to shared memory, and each thread keeps, for its
//   (query, dim) pairs of the output, the running sums acc = sum p v and
//   l = sum p, rescaled when the max grows (an online softmax across tiles).
// - In fp32 the TPU kernels' rounding of the weights is the identity, so
//   the splits combine flash-decoding style in one exchange: each block
//   leaves its (m_i, l_i, acc_i) in shared memory; after a cluster barrier
//   each block takes its share of the tile's outputs and reads every rank's
//   (m_i, l_i, acc_i) through distributed shared memory, in rank order:
//   m = max m_i, l = sum l_i exp(m_i - m), out = sum acc_i exp(m_i - m) / l,
//   normalised once; the block whose share holds a row's first element also
//   writes that row's (m, l) (native layout). A second barrier keeps every
//   block's shared memory alive until the others have read it. (Pushing the
//   partials into the owner's shared memory before one barrier instead, as
//   K5 does, measured slower for K3.)
// - Dropout (kDropout): a block adds p * keep / (1 - rate) of each key into
//   acc_i and p alone into l_i; the keep test is r3d::dropout_bits of
//   ((b*H + h)*Lq + q)*Lk + k against `threshold` in both layouts, as the
//   backwards (attention_bwd_cluster.cuh) redraw it. The combine and the
//   final division by l stay as they are.
// Deterministic, no atomics. Keys past Lk are never read (zero-filled) and
// score -inf; a split with no key has m_i = -inf and weighs 0 explicitly; a
// row whose every real key is masked has every m_i = finfo.min and averages
// V over the real keys; a row whose every score is -inf gives 0 and (m, l)
// = (-inf, 0).
#pragma once

#include <cooperative_groups.h>

#include "attention_cluster.cuh"

namespace r3d {

template <int D, bool kDropout, bool kNative>
__global__ void __launch_bounds__(kF32KT)
attention_fwd_cluster_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ bias,
                             float* __restrict__ out, float* __restrict__ m_out,
                             float* __restrict__ l_out, int H, int Lq, int Lk, int split_keys,
                             float scale, uint32_t seed, uint32_t threshold, float keep_scale) {
  constexpr int QT = kF32QT;
  constexpr int KT = kF32KT;
  constexpr int NT = KT;        // threads: 2 warps, a key a thread
  constexpr int PLD = KT + 1;   // row stride of the weights in shared memory
  constexpr int MAXS = kMaxSplits;
  constexpr int LD = kF32Ld<D>;
  constexpr int C4 = D / 4;
  constexpr int OPT = QT * D / NT;   // (query, dim) pairs of the output a thread
  extern __shared__ __align__(16) float f32_smem[];   // the ring: one or two stages
  __shared__ __align__(16) float qs[QT * D];
  __shared__ float ps[QT * PLD];   // the tile's weights p = exp(s - m)
  __shared__ float pk[kDropout ? QT * PLD : 1];   // and p * keep / (1 - rate)
  __shared__ float wmax[2][QT];    // the warps' maxima of the tile
  __shared__ float corr_s[QT];     // the rescale of the running sums
  __shared__ float cm[QT];         // this block's (m_i, l_i, acc_i), read by the cluster
  __shared__ float cl[QT];
  __shared__ float cacc[QT * D];

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Lq - q0);
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int ld = kNative ? H * D : D;   // floats from one row of q, k, v or out to the next
  const int col = kNative ? (bh - b * H) * D : 0;   // the head's first column
  const size_t kv0 = (static_cast<size_t>(kNative ? b : bh) * Lk) * ld + col;
  const size_t row0 = (static_cast<size_t>(kNative ? b : bh) * Lq + q0) * ld + col;   // query q0
  const int key_begin = split * split_keys;
  const int ntiles = (min(split_keys, Lk - key_begin) + KT - 1) / KT;
  const float* kb = k + kv0;
  const float* vb = v + kv0;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;

  // the first tile's copy is in flight while q is loaded
  f32_load_tile<D, NT>(f32_smem, kb, vb, biasb, key_begin, Lk, ld);
  for (int idx = tid; idx < QT * C4; idx += NT) {
    const int r = idx / C4;
    const float4 x = r < nq ? *reinterpret_cast<const float4*>(
                                  q + row0 + static_cast<size_t>(r) * ld + (idx % C4) * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qs + idx * 4) = x;
  }

  float m_run[QT];
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) m_run[qq] = -INFINITY;
  float acc[OPT], lsum[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = lsum[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const float* stage =
        f32_ring_step<D, NT>(f32_smem, t, ntiles, kb, vb, biasb, key_begin, Lk, ld);
    const float* ks = stage;
    const float* vs = stage + KT * LD;
    const int key0 = key_begin + t * KT;
    // the scores of this thread's key against the tile's queries
    float s[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) s[qq] = 0.f;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const float4 kk = *reinterpret_cast<const float4*>(ks + tid * LD + c * 4);
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        const float4 x = *reinterpret_cast<const float4*>(qs + qq * D + c * 4);
        s[qq] = fmaf(x.x, kk.x, fmaf(x.y, kk.y, fmaf(x.z, kk.z, fmaf(x.w, kk.w, s[qq]))));
      }
    }
    const bool key_ok = key0 + tid < Lk;
    const float bj = stage[2 * KT * LD + tid];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      s[qq] = key_ok ? s[qq] * scale + bj : -INFINITY;
      const float mx = warp_max(s[qq]);
      if (lane == 0) wmax[warp][qq] = mx;
    }
    __syncthreads();
    // the running max of every query (each thread alike), the weights
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      const float m_new = fmaxf(m_run[qq], fmaxf(wmax[0][qq], wmax[1][qq]));
      if (tid == qq) corr_s[qq] = m_new == -INFINITY ? 1.f : expf(m_run[qq] - m_new);
      m_run[qq] = m_new;
      const float p = s[qq] == -INFINITY ? 0.f : expf(s[qq] - m_new);
      ps[qq * PLD + tid] = p;
      if (kDropout) {
        const uint32_t el = (static_cast<uint32_t>(bh) * Lq + q0 + qq) * Lk + key0 + tid;
        pk[qq * PLD + tid] = dropout_bits(seed, el) >= threshold ? p * keep_scale : 0.f;
      }
    }
    __syncthreads();
    // this thread's output pairs: acc = acc * corr + sum_j p_j v_j, l likewise
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int idx = tid + i * NT;
      const int qq = idx / D;
      const int d = idx % D;
      const float* pr = ps + qq * PLD;
      const float* pa = (kDropout ? pk : ps) + qq * PLD;   // the numerator's weights
      float a = 0.f, l = 0.f;
#pragma unroll 16
      for (int j = 0; j < KT; ++j) {
        a = fmaf(pa[j], vs[j * LD + d], a);
        l += pr[j];
      }
      const float cr = corr_s[qq];
      acc[i] = fmaf(acc[i], cr, a);
      lsum[i] = fmaf(lsum[i], cr, l);
    }
    __syncthreads();   // the stage, ps and wmax are consumed
  }

  // this block's (m_i, l_i, acc_i), then the cluster's in rank order
#pragma unroll
  for (int i = 0; i < OPT; ++i) {
    const int idx = tid + i * NT;
    cacc[idx] = acc[i];
    if (idx % D == 0) cl[idx / D] = lsum[i];
  }
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) {
    if (tid == qq) cm[qq] = m_run[qq];
  }
  cluster.sync();
  const int n_out = nq * D;
  const int share = (n_out + n_split - 1) / n_split;
  const int end = min(n_out, (split + 1) * share);
  for (int idx = split * share + tid; idx < end; idx += NT) {
    const int qq = idx / D;
    float mi[MAXS], li[MAXS], ai[MAXS];
#pragma unroll
    for (int r = 0; r < MAXS; ++r) {   // every remote load in flight at once
      mi[r] = r < n_split ? cluster.map_shared_rank(cm, r)[qq] : -INFINITY;
      li[r] = r < n_split ? cluster.map_shared_rank(cl, r)[qq] : 0.f;
      ai[r] = r < n_split ? cluster.map_shared_rank(cacc, r)[idx] : 0.f;
    }
    float m = mi[0];
#pragma unroll
    for (int r = 1; r < MAXS; ++r) m = fmaxf(m, mi[r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < MAXS; ++r) {
      const float w = mi[r] == -INFINITY ? 0.f : expf(mi[r] - m);
      l = fmaf(li[r], w, l);
      a = fmaf(ai[r], w, a);
    }
    out[row0 + (kNative ? static_cast<size_t>(qq) * ld + idx % D : idx)] = l > 0.f ? a / l : 0.f;
    if (kNative && idx % D == 0) {
      const size_t st = static_cast<size_t>(bh) * Lq + q0 + qq;
      m_out[st] = m;
      l_out[st] = l;
    }
  }
  cluster.sync();   // no block leaves while another still reads its shared memory
}

// The launch configuration of the body: n_split = ceil(Lk / split_keys)
// blocks a cluster.
template <int D, bool kDropout, bool kNative>
cudaError_t fwd_cluster_config(ClusterLaunch& l, int B, int H, int Lq, int Lk, int split_keys,
                               cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || split_keys <= 0 || split_keys % kF32KT != 0) {
    return cudaErrorInvalidValue;
  }
  const int n_split = (Lk + split_keys - 1) / split_keys;
  if (n_split > kMaxSplits) return cudaErrorInvalidValue;
  return l.init(attention_fwd_cluster_kernel<D, kDropout, kNative>,
                dim3(n_split, (Lq + kF32QT - 1) / kF32QT, B * H), kF32KT,
                f32_ring_bytes<D>(split_keys), stream);
}

// One launch of the body; m and l only for the native layout (else null).
template <int D, bool kDropout, bool kNative>
int fwd_cluster_launch(const float* q, const float* k, const float* v, const float* bias,
                       float* out, float* m, float* l, int B, int H, int Lq, int Lk,
                       int split_keys, float scale, uint32_t seed, uint32_t threshold,
                       float keep_scale, cudaStream_t stream) {
  ClusterLaunch cl;
  cudaError_t err = fwd_cluster_config<D, kDropout, kNative>(cl, B, H, Lq, Lk, split_keys, stream);
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cl.cfg, attention_fwd_cluster_kernel<D, kDropout, kNative>, q, k,
                             v, bias, out, m, l, H, Lq, Lk, split_keys, scale, seed, threshold,
                             keep_scale);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of such a launch the card holds at once
// (cudaOccupancyMaxActiveClusters); launches nothing.
template <int D, bool kNative>
int fwd_cluster_occupancy(int B, int H, int Lq, int Lk, int split_keys, int* clusters) {
  ClusterLaunch cl;
  cudaError_t err = fwd_cluster_config<D, false, kNative>(cl, B, H, Lq, Lk, split_keys, nullptr);
  if (err == cudaSuccess) {
    err = cl.max_active(attention_fwd_cluster_kernel<D, false, kNative>, clusters);
  }
  return static_cast<int>(err);
}

}  // namespace r3d
