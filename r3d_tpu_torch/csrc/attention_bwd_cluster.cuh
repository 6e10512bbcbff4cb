// The fp32 attention backward's cluster body: dq, dk, dv (and the bias's
// cotangent) of out = (softmax(q k^T * scale + bias) * keep) v, keep the
// dropout mask scaled 1/(1-p), or 1 everywhere at rate 0. With w the softmax
// weights, g the cotangent of out and D = rowsum(g o out):
//
//   dv_k = sum_q w_qk keep_qk g_q       ds_qk = w_qk (keep_qk (g_q . v_k) - D_q)
//   dq_q = scale sum_k ds_qk k_k        dk_k = scale sum_q ds_qk q_q
//   dbias_k = sum over heads and queries of ds_qk
//
// Two kernels instantiate it:
// - K5 (attention_bwd.cu; `kNative` false): q, g, dq [B, H, Lq, D], k, v,
//   dk, dv [B, H, Lk, D]; the statistics are recomputed, D = sum_k w_k
//   keep_k (g . v_k), and no forward output is read. Every utkinects train
//   step at Lq = 8, Lk = 256 or 512, D = 16, B = H = 8.
// - K7 in fp32 (cross_attention_bwd.cu; `kNative` true): q, g, o, dq
//   [B, Lq, C], k, v, dk, dv [B, Lk, C] with C = H * D (the projections'
//   layout), the forward's statistics m, l [B, H, Lq] given: w = exp(s - m)
//   / max(l, 1e-30), as the TPU kernel (r3d_tpu/ops/cross_attention.py:115)
//   takes them, and D = rowsum(g o o) per head from the forward's output o,
//   folded into the dot: ds = w (g . (keep v - o)), the same function
//   without K5's difference of two dots (see fp32_bwd_scores). The
//   utkinects 1024 and 2000 buckets under R3D_CROSS_NATIVE=1: Lq = 8,
//   Lk = 1,024 or 2,000, C = 128, H = 8.
//
// What bounds it on the H100: bytes. It reads q, g (and o), k, v and the
// bias once and writes dq, dk and dv once: 2.1 MB at Lk = 512 (K5) and 32.8
// MB at Lk = 2,000 (K7), 0.0025 and 0.0099 ms at 3.35 TB/s, for
// 10*B*H*Lq*Lk*D flops: 5 flops per byte, so the products run as plain fp32
// FMAs from shared memory; tensor cores (3xTF32 for fp32 accuracy) would buy
// nothing at this shape. The work is a few microseconds, so the design is
// about latency: one launch, no memset, no scratch, every block's copy
// started at once and at most a few tiles walked in turn.
// - Grid (n_split, B*H), 4 warps a block. The keys of one (batch, head) are
//   split into n_split runs of `split_keys` (a multiple of 64, at most 8
//   runs; ops/attention.py:fp32_split_keys: 8 splits of 64 at Lk = 512, of
//   256 at 2,000: 512 blocks), and the n_split blocks of one (batch, head)
//   form one thread-block cluster. A block copies its first tile of 64 keys
//   (K, V and the bias) with 16- and 4-byte cp.async at its start and, when
//   its split is one tile (Lk <= 512), keeps it for the whole call; longer
//   splits walk their tiles through a ring of two, the next copy under this
//   tile's math.
// - The block walks the queries in tiles of 8, q and g in shared memory.
//   Thread (j, h) takes key j of the tile and queries 4h .. 4h + 3 of the
//   query tile.
// - Statistics, K5 only: thread (j, h) scores its key and forms g . v_j for
//   its four queries; each warp keeps its (m, l, D-numerator sum exp(s - m)
//   keep (g . v)) per query online over the split's tiles, and a half's two
//   warps are combined in warp order into the block's (m_i, l_i, D_i). Each
//   block stores them into every block of the cluster through distributed
//   shared memory; after a cluster barrier every block combines them in
//   rank order, so every block derives bit-identical m, l and
//   D = sum w keep (g . v). K7 reads m and l, takes o with q and g, and
//   skips this pass and its barrier.
// - Gradients: each thread forms w*keep and ds of its key and four queries
//   into shared memory. The block OWNS dk, dv (and the per-head dbias slice)
//   of its keys: thread (j, h) sums half the dims of key j's rows over all 8
//   queries, and over the query tiles in registers, and writes them once (a
//   split of more than one tile adds each query tile's share to its own rows
//   in device memory instead; no other block touches them). Each block
//   takes a share of the tile's dq, and every block stores its part of that
//   share (sum over its keys of ds k) into it; after a cluster barrier the
//   block sums them in rank order and writes them once (no block reads
//   another's shared memory). Under K7, where no statistics barrier stands
//   between one query tile's dq and the next, a split barrier does: arrive
//   after reading the shares, wait before the next push.
// - What decides the time at this size is how many clusters of 8 the card
//   holds at once: the main paths launch 64, and with 255 registers a
//   thread (a first design, two warps a block) at most four blocks fit an
//   SM, too few, so the launch ran in two waves. The registers are capped
//   (fp32_min_blocks) so they fit in one.
// Deterministic, no atomics. Keys past Lk are zero-filled, score -inf and are
// never written; queries past Lq weigh 0; a row whose every score is -inf
// (l = 0) gives zero gradients, not NaN; a fully masked finite row (every
// real key at finfo.min) averages over the real keys. dbias goes to a
// per-(batch, head) slice [B*H, Lk] that the wrapper sums over heads, and
// only when the bias needs a gradient. The dropout mask is redrawn from
// r3d::dropout_bits of ((b*H + h)*Lq + q)*Lk + k, as the forwards
// (attention_fwd_cluster.cuh) drew it.
#pragma once

#include <cooperative_groups.h>

#include "attention_cluster.cuh"

namespace r3d {

constexpr int kBwdQH = kF32QT / 2;   // queries a thread scores: half the tile
constexpr int kBwdNT = 2 * kF32KT;   // threads per block: 4 warps, a key and a half tile each

// The scores s and keep factors of key `key0 + j` (row j of the tile at
// `stage`) against queries q0 + 4h .. q0 + 4h + 3 (rows 4h.. of qs, gs and
// os), and gv: K5 g . v_j; K7 g . (keep v_j - o), the forward's output o
// subtracted inside the dot, so that ds = w gv needs no difference of two
// large dots (K5's keep (g . v) - D cancels to rounding noise where one key
// holds all the weight). Keys past Lk score -inf.
template <int D, bool kDropout, bool kNative>
__device__ __forceinline__ void fp32_bwd_scores(const float* stage, const float* qs,
                                                const float* gs, const float* os, int j, int h,
                                                int key0, int q0, int bh, int Lq, int Lk,
                                                float scale, uint32_t seed, uint32_t threshold,
                                                float keep_scale, float (&s)[kBwdQH],
                                                float (&gv)[kBwdQH], float (&km)[kBwdQH]) {
  constexpr int LD = kF32Ld<D>;
  const int key = key0 + j;
  const auto keep = [&]() {
#pragma unroll
    for (int i = 0; i < kBwdQH; ++i) {
      km[i] = 1.f;
      if (kDropout) {
        const uint32_t el = (static_cast<uint32_t>(bh) * Lq + q0 + h * kBwdQH + i) * Lk + key;
        km[i] = dropout_bits(seed, el) >= threshold ? keep_scale : 0.f;
      }
    }
  };
  if (kNative) keep();   // K7 needs them in the dot; K5 after it
#pragma unroll
  for (int i = 0; i < kBwdQH; ++i) s[i] = gv[i] = 0.f;
#pragma unroll 2   // c indexes shared memory only: a full unroll hoists every load
  for (int c = 0; c < D / 4; ++c) {
    const float4 kk = *reinterpret_cast<const float4*>(stage + j * LD + c * 4);
    const float4 vv = *reinterpret_cast<const float4*>(stage + (kF32KT + j) * LD + c * 4);
#pragma unroll
    for (int i = 0; i < kBwdQH; ++i) {
      const int row = (h * kBwdQH + i) * D + c * 4;
      const float4 x = *reinterpret_cast<const float4*>(qs + row);
      const float4 y = *reinterpret_cast<const float4*>(gs + row);
      s[i] = fmaf(x.x, kk.x, fmaf(x.y, kk.y, fmaf(x.z, kk.z, fmaf(x.w, kk.w, s[i]))));
      if constexpr (kNative) {
        const float4 z = *reinterpret_cast<const float4*>(os + row);
        gv[i] = fmaf(y.x, fmaf(km[i], vv.x, -z.x),
                     fmaf(y.y, fmaf(km[i], vv.y, -z.y),
                          fmaf(y.z, fmaf(km[i], vv.z, -z.z), fmaf(y.w, fmaf(km[i], vv.w, -z.w),
                                                                   gv[i]))));
      } else {
        gv[i] = fmaf(y.x, vv.x, fmaf(y.y, vv.y, fmaf(y.z, vv.z, fmaf(y.w, vv.w, gv[i]))));
      }
    }
  }
  if (!kNative) keep();
  const float bj = stage[2 * kF32KT * LD + j];
#pragma unroll
  for (int i = 0; i < kBwdQH; ++i) s[i] = key < Lk ? s[i] * scale + bj : -INFINITY;
}

// A cluster barrier in two halves, for the exchange by pushing (each block
// stores its partials into the shared memory of the blocks that combine
// them, then one cluster.sync(), release and acquire, makes them visible and
// every read is local, so no block has to wait for the others before it
// exits): every block signals at its start that it runs (no memory
// ordering), and waits for the others' signals only before its first store
// into another block's shared memory, which must have started. K7 also
// arrives (release) once it has read one query tile's dq shares and waits
// before it pushes the next tile's.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Blocks an SM the registers must leave room for: at D = 16, six (at most
// 80 registers a thread; left free, the compiler takes twice that to hoist
// every load of q and g) leave room for all of the main paths' 64 clusters
// of 8 at once (chip_smoke.py prints how many fit); D = 32 and 64 keep their
// sums unspilled.
constexpr int fp32_min_blocks(int D) { return D <= 16 ? 6 : D <= 32 ? 4 : 2; }

template <int D, bool kDropout, bool kNative>
__global__ void __launch_bounds__(kBwdNT, fp32_min_blocks(D))
attention_bwd_cluster_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ bias,
                             const float* __restrict__ g, const float* __restrict__ o,
                             const float* __restrict__ m_in, const float* __restrict__ l_in,
                             float* __restrict__ dq, float* __restrict__ dk,
                             float* __restrict__ dv, float* __restrict__ dbias, int H, int Lq,
                             int Lk, int split_keys, float scale, uint32_t seed,
                             uint32_t threshold, float keep_scale) {
  constexpr int QT = kF32QT;
  constexpr int KT = kF32KT;
  constexpr int QH = kBwdQH;
  constexpr int NT = kBwdNT;
  constexpr int DLD = KT + 1;   // row stride of w*keep and ds in shared memory
  constexpr int LD = kF32Ld<D>;
  constexpr int C4 = D / 4;
  constexpr int DH = D / 2;             // the dims of dk and dv a thread owns
  constexpr int OPT = QT * D / NT;      // (query, dim) pairs of dq a thread
  extern __shared__ __align__(16) float f32_smem[];   // the ring: one or two stages
  __shared__ __align__(16) float qs[QT * D];
  __shared__ __align__(16) float gs[QT * D];
  __shared__ __align__(16) float os[kNative ? QT * D : 4];   // K7: the forward's output
  __shared__ float wk_s[QT * DLD];   // w * keep of the tile in hand
  __shared__ float ds_s[QT * DLD];   // ds of the tile in hand (before the scale)
  __shared__ float red[3][2][QT];    // the warps' (m, l, D-numerator)
  __shared__ float cst[kMaxSplits][3][QT];   // every block's (m_i, l_i, D_i), pushed by it
  __shared__ float fin[3][QT];               // the row's m, 1 / l and D
  __shared__ float dqp[kMaxSplits][QT * D];  // every block's dq of this block's share

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int j = tid % KT;    // this thread's key of a tile
  const int h = tid / KT;    // its half of the query tile, and of dk's and dv's dims
  const int wh = (tid >> 5) & 1;   // its warp among the half's two
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int ld = kNative ? H * D : D;   // floats from one row of q, k, v, g, o or a gradient to the next
  const int col = kNative ? (bh - b * H) * D : 0;   // the head's first column
  const size_t kv0 = static_cast<size_t>(kNative ? b : bh) * Lk * ld + col;
  const size_t qr0 = static_cast<size_t>(kNative ? b : bh) * Lq * ld + col;   // query 0's row
  const int key_begin = split * split_keys;
  const int ntiles = (min(split_keys, Lk - key_begin) + KT - 1) / KT;
  const bool one_tile = ntiles == 1;   // the tile stays in the ring's first stage
  const float* kb = k + kv0;
  const float* vb = v + kv0;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;
  const int n_qtiles = (Lq + QT - 1) / QT;

  cluster_arrive_relaxed();   // this block runs
  if (one_tile) f32_load_tile<D, NT>(f32_smem, kb, vb, biasb, key_begin, Lk, ld);

  // this thread's half of its key's rows of dk and dv, and the key's dbias
  // (h == 0), summed over the query tiles in registers when the split is
  // one tile
  float dk_acc[DH], dv_acc[DH];
  float db_acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) dk_acc[d] = dv_acc[d] = 0.f;
  float s[QH], gv[QH], km[QH];   // of the tile in hand

  for (int qt = 0; qt < n_qtiles; ++qt) {
    const int q0 = qt * QT;
    const int nq = min(QT, Lq - q0);
    const bool last_q = qt == n_qtiles - 1;
    __syncthreads();   // the previous query tile is done with qs, gs, wk_s, ds_s and fin
    for (int idx = tid; idx < QT * C4; idx += NT) {
      const int r = idx / C4;
      const size_t off = qr0 + static_cast<size_t>(q0 + r) * ld + (idx % C4) * 4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(qs + idx * 4) =
          r < nq ? *reinterpret_cast<const float4*>(q + off) : zero;
      *reinterpret_cast<float4*>(gs + idx * 4) =
          r < nq ? *reinterpret_cast<const float4*>(g + off) : zero;
      if (kNative) {
        *reinterpret_cast<float4*>(os + idx * 4) =
            r < nq ? *reinterpret_cast<const float4*>(o + off) : zero;
      }
    }
    if (one_tile) {
      if (qt == 0) cp_async_wait<0>();
      __syncthreads();
    } else {
      f32_load_tile<D, NT>(f32_smem, kb, vb, biasb, key_begin, Lk, ld);
    }

    if constexpr (kNative) {   // the forward's statistics
      if (tid < QT) {
        const size_t st = static_cast<size_t>(bh) * Lq + q0 + tid;
        fin[0][tid] = tid < nq ? m_in[st] : 0.f;
        fin[1][tid] = tid < nq ? 1.f / fmaxf(l_in[st], 1e-30f) : 0.f;
      }
    } else {
      // statistics: each warp's online (m, l, D-numerator) of its 4 queries
      // over its 32 keys of every tile of the split
      float wm[QH], wl[QH], wd[QH];
#pragma unroll
      for (int i = 0; i < QH; ++i) {
        wm[i] = -INFINITY;
        wl[i] = wd[i] = 0.f;
      }
      for (int t = 0; t < ntiles; ++t) {
        const float* stage = one_tile ? f32_smem
                                      : f32_ring_step<D, NT>(f32_smem, t, ntiles, kb, vb, biasb,
                                                             key_begin, Lk, ld);
        fp32_bwd_scores<D, kDropout, false>(stage, qs, gs, os, j, h, key_begin + t * KT, q0,
                                            bh, Lq, Lk, scale, seed, threshold, keep_scale, s,
                                            gv, km);
#pragma unroll
        for (int i = 0; i < QH; ++i) {
          const float m_new = fmaxf(wm[i], warp_max(s[i]));
          const float corr = m_new == -INFINITY ? 1.f : expf(wm[i] - m_new);
          const float p = s[i] == -INFINITY ? 0.f : expf(s[i] - m_new);
          wl[i] = fmaf(wl[i], corr, warp_sum(p));
          wd[i] = fmaf(wd[i], corr, warp_sum(p * km[i] * gv[i]));
          wm[i] = m_new;
        }
        if (!one_tile) __syncthreads();   // the stage is consumed before the ring refills it
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < QH; ++i) {
          red[0][wh][h * QH + i] = wm[i];
          red[1][wh][h * QH + i] = wl[i];
          red[2][wh][h * QH + i] = wd[i];
        }
      }
      __syncthreads();
      if (qt == 0) cluster_wait();   // every block of the cluster runs
      if (tid < QT) {   // the half's two warps in warp order, into every block of the cluster
        const float m0 = red[0][0][tid], m1 = red[0][1][tid];
        const float m = fmaxf(m0, m1);
        const float w0 = m0 == -INFINITY ? 0.f : expf(m0 - m);
        const float w1 = m1 == -INFINITY ? 0.f : expf(m1 - m);
        const float l = fmaf(red[1][1][tid], w1, red[1][0][tid] * w0);
        const float dn = fmaf(red[2][1][tid], w1, red[2][0][tid] * w0);
        for (int r = 0; r < n_split; ++r) {
          float* c = cluster.map_shared_rank(&cst[split][0][0], r);
          c[tid] = m;
          c[QT + tid] = l;
          c[2 * QT + tid] = dn;
        }
      }
      cluster.sync();
      if (tid < QT) {   // the cluster's blocks, in rank order
        float m = cst[0][0][tid];
#pragma unroll
        for (int r = 1; r < kMaxSplits; ++r) m = r < n_split ? fmaxf(m, cst[r][0][tid]) : m;
        float w[kMaxSplits];
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r) {   // every exponential at once
          w[r] = r < n_split && cst[r][0][tid] != -INFINITY ? expf(cst[r][0][tid] - m) : 0.f;
        }
        float l = 0.f, dn = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxSplits; ++r) {
          if (r < n_split) {
            l = fmaf(cst[r][1][tid], w[r], l);
            dn = fmaf(cst[r][2][tid], w[r], dn);
          }
        }
        const float inv_l = l > 0.f ? 1.f / l : 0.f;
        fin[0][tid] = m;
        fin[1][tid] = inv_l;
        fin[2][tid] = dn * inv_l;
      }
    }
    __syncthreads();

    // gradients of the split's keys for this query tile
    float dq_acc[OPT];
#pragma unroll
    for (int i = 0; i < OPT; ++i) dq_acc[i] = 0.f;
    // the statistics pass walked the ring: its first tile again (K7's is in flight)
    if (!kNative && !one_tile) f32_load_tile<D, NT>(f32_smem, kb, vb, biasb, key_begin, Lk, ld);
    for (int t = 0; t < ntiles; ++t) {
      const int key0 = key_begin + t * KT;
      const float* stage = f32_smem;
      if (!one_tile) {
        stage = f32_ring_step<D, NT>(f32_smem, t, ntiles, kb, vb, biasb, key_begin, Lk, ld);
      }
      if (kNative || !one_tile) {   // K5 on one tile: the statistics' scores are in hand
        fp32_bwd_scores<D, kDropout, kNative>(stage, qs, gs, os, j, h, key0, q0, bh, Lq, Lk,
                                              scale, seed, threshold, keep_scale, s, gv, km);
      }
#pragma unroll
      for (int i = 0; i < QH; ++i) {   // w * keep and ds of this thread's 4 queries
        const int qq = h * QH + i;
        const bool ok = qq < nq && s[i] != -INFINITY;
        const float w = ok ? expf(s[i] - fin[0][qq]) * fin[1][qq] : 0.f;
        wk_s[qq * DLD + j] = w * km[i];
        ds_s[qq * DLD + j] = w * (kNative ? gv[i] : km[i] * gv[i] - fin[2][qq]);
      }
      __syncthreads();
      // dk, dv (this thread's half of the dims) and dbias of its key
      const int key = key0 + j;
      const bool key_ok = key < Lk;
      const size_t row = kv0 + static_cast<size_t>(key) * ld + h * DH;
      if (!one_tile) {   // this query tile's share joins the sums of the earlier ones
#pragma unroll
        for (int d = 0; d < DH; ++d) dk_acc[d] = dv_acc[d] = 0.f;
        db_acc = 0.f;
        if (qt > 0 && key_ok) {
#pragma unroll
          for (int c = 0; c < DH / 4; ++c) {
            const float4 a = *reinterpret_cast<const float4*>(dk + row + c * 4);
            const float4 e = *reinterpret_cast<const float4*>(dv + row + c * 4);
            dk_acc[4 * c] = a.x, dk_acc[4 * c + 1] = a.y, dk_acc[4 * c + 2] = a.z,
            dk_acc[4 * c + 3] = a.w;
            dv_acc[4 * c] = e.x, dv_acc[4 * c + 1] = e.y, dv_acc[4 * c + 2] = e.z,
            dv_acc[4 * c + 3] = e.w;
          }
          if (dbias != nullptr && h == 0) db_acc = dbias[static_cast<size_t>(bh) * Lk + key];
        }
      }
#pragma unroll 2   // as in fp32_bwd_scores
      for (int qq = 0; qq < QT; ++qq) {
        const float dsv = ds_s[qq * DLD + j];
        const float wkv = wk_s[qq * DLD + j];
        db_acc += dsv;
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(qs + qq * D + h * DH + c * 4);
          const float4 y = *reinterpret_cast<const float4*>(gs + qq * D + h * DH + c * 4);
          dk_acc[4 * c] = fmaf(dsv, x.x, dk_acc[4 * c]);
          dk_acc[4 * c + 1] = fmaf(dsv, x.y, dk_acc[4 * c + 1]);
          dk_acc[4 * c + 2] = fmaf(dsv, x.z, dk_acc[4 * c + 2]);
          dk_acc[4 * c + 3] = fmaf(dsv, x.w, dk_acc[4 * c + 3]);
          dv_acc[4 * c] = fmaf(wkv, y.x, dv_acc[4 * c]);
          dv_acc[4 * c + 1] = fmaf(wkv, y.y, dv_acc[4 * c + 1]);
          dv_acc[4 * c + 2] = fmaf(wkv, y.z, dv_acc[4 * c + 2]);
          dv_acc[4 * c + 3] = fmaf(wkv, y.w, dv_acc[4 * c + 3]);
        }
      }
      if (key_ok && (!one_tile || last_q)) {   // dk scaled once, at the last query tile
        const float ks = last_q ? scale : 1.f;
#pragma unroll
        for (int c = 0; c < DH / 4; ++c) {
          *reinterpret_cast<float4*>(dk + row + c * 4) =
              make_float4(dk_acc[4 * c] * ks, dk_acc[4 * c + 1] * ks, dk_acc[4 * c + 2] * ks,
                          dk_acc[4 * c + 3] * ks);
          *reinterpret_cast<float4*>(dv + row + c * 4) =
              make_float4(dv_acc[4 * c], dv_acc[4 * c + 1], dv_acc[4 * c + 2], dv_acc[4 * c + 3]);
        }
        if (dbias != nullptr && h == 0) dbias[static_cast<size_t>(bh) * Lk + key] = db_acc;
      }
      // this block's share of dq: sum over the tile's keys of ds k
#pragma unroll
      for (int i = 0; i < OPT; ++i) {
        const int idx = tid + i * NT;
        const float* dr = ds_s + (idx / D) * DLD;
        const int d = idx % D;
        float a = dq_acc[i];
#pragma unroll 16
        for (int jj = 0; jj < KT; ++jj) a = fmaf(dr[jj], stage[jj * LD + d], a);
        dq_acc[i] = a;
      }
      __syncthreads();   // wk_s, ds_s and the stage are consumed
    }

    // dq: block r takes elements [r * share, (r + 1) * share) of the tile's;
    // every block's share of them into it, then summed there in rank order
    const int n_out = nq * D;
    const int share = (n_out + n_split - 1) / n_split;
    if (kNative) cluster_wait();   // every block runs, and has read the last tile's shares
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int idx = tid + i * NT;
      if (idx < n_out) cluster.map_shared_rank(&dqp[split][0], idx / share)[idx] = dq_acc[i];
    }
    cluster.sync();
    const int end = min(n_out, (split + 1) * share);
    float* dqb = dq + qr0 + static_cast<size_t>(q0) * ld;
    for (int idx = split * share + tid; idx < end; idx += NT) {
      float a = dqp[0][idx];
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r) a += r < n_split ? dqp[r][idx] : 0.f;
      dqb[kNative ? static_cast<size_t>(idx / D) * ld + idx % D : idx] = a * scale;
    }
    if (kNative && !last_q) cluster_arrive();   // this block is done with its shares
  }
}

// The launch configuration of the body: n_split = ceil(Lk / split_keys)
// blocks a cluster, at most 8.
template <int D, bool kDropout, bool kNative>
cudaError_t bwd_cluster_config(ClusterLaunch& l, int B, int H, int Lq, int Lk, int split_keys,
                               cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || split_keys <= 0 || split_keys % kF32KT != 0 ||
      (Lk + split_keys - 1) / split_keys > kMaxSplits) {
    return cudaErrorInvalidValue;
  }
  return l.init(attention_bwd_cluster_kernel<D, kDropout, kNative>,
                dim3((Lk + split_keys - 1) / split_keys, B * H), kBwdNT,
                f32_ring_bytes<D>(split_keys), stream);
}

// One launch of the body; o, m and l only for the native layout (else null).
template <int D, bool kDropout, bool kNative>
int bwd_cluster_launch(const float* q, const float* k, const float* v, const float* bias,
                       const float* g, const float* o, const float* m, const float* l, float* dq,
                       float* dk, float* dv, float* dbias, int B, int H, int Lq, int Lk,
                       int split_keys, float scale, uint32_t seed, uint32_t threshold,
                       float keep_scale, cudaStream_t stream) {
  ClusterLaunch cl;   // the n_split blocks of a (batch, head): one cluster
  cudaError_t err = bwd_cluster_config<D, kDropout, kNative>(cl, B, H, Lq, Lk, split_keys, stream);
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cl.cfg, attention_bwd_cluster_kernel<D, kDropout, kNative>, q, k,
                             v, bias, g, o, m, l, dq, dk, dv, dbias, H, Lq, Lk, split_keys,
                             scale, seed, threshold, keep_scale);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of such a launch the card holds at once
// (cudaOccupancyMaxActiveClusters); launches nothing.
template <int D, bool kDropout, bool kNative>
int bwd_cluster_occupancy(int B, int H, int Lk, int split_keys, int* clusters) {
  ClusterLaunch cl;
  cudaError_t err = bwd_cluster_config<D, kDropout, kNative>(cl, B, H, 1, Lk, split_keys, nullptr);
  if (err == cudaSuccess) {
    err = cl.max_active(attention_bwd_cluster_kernel<D, kDropout, kNative>, clusters);
  }
  return static_cast<int>(err);
}

// The occupancy above for a head dim and dropout known only at run time.
template <bool kNative>
int bwd_cluster_occupancy(int B, int H, int Lk, int D, int split_keys, int dropout,
                          int* clusters) {
  switch (D * 2 + (dropout != 0)) {
    case 32: return bwd_cluster_occupancy<16, false, kNative>(B, H, Lk, split_keys, clusters);
    case 33: return bwd_cluster_occupancy<16, true, kNative>(B, H, Lk, split_keys, clusters);
    case 64: return bwd_cluster_occupancy<32, false, kNative>(B, H, Lk, split_keys, clusters);
    case 65: return bwd_cluster_occupancy<32, true, kNative>(B, H, Lk, split_keys, clusters);
    case 128: return bwd_cluster_occupancy<64, false, kNative>(B, H, Lk, split_keys, clusters);
    case 129: return bwd_cluster_occupancy<64, true, kNative>(B, H, Lk, split_keys, clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch for a head dim known only at run time.
template <bool kDropout, bool kNative>
int bwd_cluster_dispatch(const float* q, const float* k, const float* v, const float* bias,
                         const float* g, const float* o, const float* m, const float* l,
                         float* dq, float* dk, float* dv, float* dbias, int B, int H, int Lq,
                         int Lk, int D, int split_keys, float scale, uint32_t seed,
                         uint32_t threshold, float keep_scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return bwd_cluster_launch<16, kDropout, kNative>(q, k, v, bias, g, o, m, l, dq, dk, dv,
                                                       dbias, B, H, Lq, Lk, split_keys, scale,
                                                       seed, threshold, keep_scale, s);
    case 32:
      return bwd_cluster_launch<32, kDropout, kNative>(q, k, v, bias, g, o, m, l, dq, dk, dv,
                                                       dbias, B, H, Lq, Lk, split_keys, scale,
                                                       seed, threshold, keep_scale, s);
    case 64:
      return bwd_cluster_launch<64, kDropout, kNative>(q, k, v, bias, g, o, m, l, dq, dk, dv,
                                                       dbias, B, H, Lq, Lk, split_keys, scale,
                                                       seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace r3d
