// Attention forward for many queries, fp32: out = softmax(q k^T * scale +
// bias) v with an fp32 online softmax, optionally with dropout on the
// weights, and what the backward (attention_many_bwd_f32.cu) takes from it.
//
// Replaces, at many queries, the Pallas kernels r3d_tpu/ops/attention.py:38
// `_kernel` (launched by `_pallas_attention`, pallas_call at :82), K3, and
// :192 `_kernel_dropout` (launched by `_pallas_attention_dropout`,
// pallas_call at :305), K4, in fp32. The TPU kernels take a block of 256
// queries against the whole padded key range in VMEM with a two-pass
// softmax. attention.cu keeps the cluster body built for 8 queries (the
// utkinects decoder); ops/attention.py sends an fp32 call here when it has
// at least FP32_MANY_QUERY_MIN queries: S queries against S keys in the
// encoder (use_encoder), the depth query source's self- and
// cross-attention and L3 query generation, S up to 2,000.
// Layout: q, out [B, H, Lq, D], k, v [B, H, Lk, D], a key-padding bias
// [B, Lk] of 0 or finfo(float32).min (or null), all fp32.
//
// What bounds it on the H100: operations. At B = H = 8, S = 2,000, D = 16
// the two products are 4*B*H*S*S*D = 16.4 GFLOP: 0.245 ms on the fp32 pipes
// (67 TFLOP/s), 0.099 ms as fp32-accurate 3xTF32 tensor-core products (165
// TFLOP/s), against 4.1 MB of q, k, v and out (0.001 ms at 3.35 TB/s).
// Beside the products every score takes an exponential (256 M at that
// shape, about 0.07 ms on the SFUs) and, with dropout, a hash of its index
// (two fmix32, some twenty integer operations).
//
// The design (one launch, no cluster, no scratch, no atomics):
// - Grid (ceil(Lq / 64), B*H), 4 warps; each warp owns 16 query rows end to
//   end and holds their q as the TF32 high and low parts of mma A
//   fragments in registers for the whole key walk. Each block walks every
//   key once, so the keys of a (batch, head) are read ceil(Lq / 64) times
//   (32 at S = 2,000; the cluster body's query tiles of 8 read them 250
//   times).
// - The keys stream in tiles of 64 through a ring of three stages in
//   dynamic shared memory (K, V and the tile's bias as the cluster bodies
//   copy them, attention_cluster.cuh: f32_load_tile, rows D + 4 floats
//   apart), one barrier a tile: the copies of tiles t+1 and t+2 are in
//   flight under the math of tile t. Keys past Lk are zero-filled and
//   score -inf.
// - S = q k^T and acc += P v run as 3xTF32 mma.sync m16n8k8 with fp32 sums
//   (mma_tf32.cuh: lo hi, hi lo, hi hi; K1 and K2 use the same scheme), the
//   operands split where they are read from shared memory. P needs no
//   shuffle from the scores' C fragments to the A fragments: the keys of a
//   k-step are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so that lane
//   (g, t) holds its A columns t and t + 4 as its C columns 2t and 2t + 1,
//   and reads V's rows 2t and 2t + 1 for its B fragment. With rows D + 4
//   floats apart every fragment read is free of bank conflicts.
// - The softmax is online, in fp32, per row (flash-attention 2's loop
//   order): the running max m, the sum l of exp(s - m) over all weights,
//   the output rescaled by exp(m_old - m_new) when the max grows. In fp32 the TPU
//   kernels' rounding of the weights to V's type is the identity, so the
//   output acc / l is normalised once at the end and written in fp32.
// - Each tile's P v starts from zero in registers and joins the running
//   output once, acc = acc * corr + P v, in fp32. Summed by the tensor
//   cores straight into the running output over thousands of keys, the
//   output drifted several times further from an fp64 reference than the
//   plain version or the cluster body, enough to flip a ReLU in a train
//   step of the depth query source against the plain route; expf in place
//   of __expf, or the low TF32 parts rounded instead of truncated, did not
//   move it and cost time. At D = 16 and 32 a tile's P v runs in two
//   partial sums, the even and the odd k-steps, so that more than D / 8
//   chains of dependent products are in flight.
// - Dropout (kDropout): acc takes p * keep / (1 - rate), l takes p; the
//   keep test is r3d::dropout_bits of the element index ((b*H + h)*Lq +
//   q)*Lk + k against `threshold` (common.cuh), bit for bit the mask that
//   the fp32 cluster backward (attention_bwd_cluster.cuh) redraws. Each
//   tile's keep factors are hashed before its products, so that their
//   integer work can overlap the tensor cores'.
// - For the backward (kStats, a call that trains: `stats` given): each
//   query's m and 1 / l, fp32 [2, B*H, Lq], as the bf16 forward writes them
//   (attention_many.cu), and with dropout the keep mask as bits in the
//   records of attention_many.cuh. The records follow the scores' C
//   fragments (lane (g, t): rows g and g + 8, keys 2t and 2t + 1 of each
//   n-tile), the layout of the m16n8k16 C fragment that the bf16 bodies
//   write; the key order 0, 2, 4, 6, 1, 3, 5, 7 of P's A fragment stays
//   inside P v. The output is fp32 already, so the backward's Dq =
//   rowsum(g o out) reads out itself. Without `stats` (serving, export, a
//   call without gradients) nothing more is written, and out is bit for bit
//   the same either way.
// A row whose every real key is masked (all at finfo.min) averages V over
// the real keys; a row whose every score is -inf gives 0. Queries past Lq
// score zeros and are neither written nor counted. Deterministic: every
// sum runs in a fixed order.

#include <cuda_runtime.h>

#include "attention_cluster.cuh"
#include "attention_many.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int NW = 4;            // warps per block, 16 queries each
constexpr int NTH = NW * 32;
constexpr int BQ = NW * 16;      // queries per block
constexpr int KT = r3d::kF32KT;  // keys per tile
constexpr int NSTAGE = 3;        // tiles in the ring: two copies in flight under the math
static_assert(KT == r3d::kManyKeyTile, "the many-query bodies walk the keys in one tile size");

template <int D>
constexpr size_t kSmemBytes = NSTAGE * r3d::kF32Stage<D> * sizeof(float);

// D = 64 holds two blocks an SM (its ring is 103 KB); D = 16 and 32 three.
template <int D, bool kDropout, bool kStats>
__global__ void __launch_bounds__(NTH, D == 64 ? 2 : 3)
attention_fwd_many_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ bias,
                              float* __restrict__ out, float* __restrict__ stats,
                              uint32_t* __restrict__ keep_bits, int H, int Lq, int Lk,
                              float scale, uint32_t seed, uint32_t threshold,
                              float keep_scale) {
  constexpr int KS = D / 8;    // k-steps of q k^T
  constexpr int NT = D / 8;    // n-tiles of the output
  constexpr int ST = KT / 8;   // n-tiles of the scores, k-steps of P v
  constexpr int NACC = NT >= 8 ? 1 : 2;   // partial sums of a tile's P v: k-steps by parity
  constexpr int LD = r3d::kF32Ld<D>;
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BQ + warp * 16;   // this warp's first query
  const int bh = blockIdx.y;
  const int b = bh / H;
  const bool active = q0 < Lq;   // a warp wholly past Lq only helps copy
  const int ntiles = (Lk + KT - 1) / KT;
  const float* kb = k + static_cast<size_t>(bh) * Lk * D;
  const float* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;
  auto stage = [&](int tile) { return ring + (tile % NSTAGE) * r3d::kF32Stage<D>; };

#pragma unroll
  for (int tile = 0; tile < NSTAGE - 1; ++tile) {   // one commit group per tile
    if (tile < ntiles) {
      r3d::f32_load_tile<D, NTH>(stage(tile), kb, vb, biasb, tile * KT, Lk, D);
    } else {
      r3d::cp_async_commit();
    }
  }

  // the warp's queries as A fragments, high and low TF32 parts (rows past Lq: 0)
  uint32_t qh[KS][1][4], ql[KS][1][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + (i & 1) * 8;
      const int d = kk * 8 + t + (i >> 1) * 4;
      const float x = row < Lq ? q[(static_cast<size_t>(bh) * Lq + row) * D + d] : 0.f;
      r3d::split_tf32(x, qh[kk][0][i], ql[kk][0][i]);
    }
  }

  // rows of this thread: hi = 0, 1 is query q0 + g + hi*8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  uint32_t el_row[2];   // the dropout index of each row's key 0
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    el_row[hi] = (static_cast<uint32_t>(bh) * Lq + q0 + g + hi * 8) * static_cast<uint32_t>(Lk);
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    // tile's copy has landed and every warp is done with tile - 1, whose
    // stage takes the copy of tile + NSTAGE - 1
    r3d::cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (tile + NSTAGE - 1 < ntiles) {
      r3d::f32_load_tile<D, NTH>(stage(tile + NSTAGE - 1), kb, vb, biasb,
                                 (tile + NSTAGE - 1) * KT, Lk, D);
    } else {
      r3d::cp_async_commit();
    }
    if (!active) continue;
    const int key0 = tile * KT;
    const float* ks = stage(tile);
    const float* vs = ks + KT * LD;
    const float* bt = ks + 2 * KT * LD;

    // the keep factors first: integer work that need not wait for the scores
    float kp[ST][4];
    if (kDropout) {
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t el = el_row[i >> 1] + key0 + nt * 8 + 2 * t + (i & 1);
          kp[nt][i] = r3d::dropout_bits(seed, el) >= threshold ? keep_scale : 0.f;
        }
      }
    }

    // scores of 16 queries x 64 keys: s[0][nt][hi*2 + j] is key nt*8 + 2t + j
    float s[1][ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[0][nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kh[ST][2], kl[ST][2];   // B = K^T: (dim t or t + 4, key g) of each n-tile
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        const float* kr = ks + (nt * 8 + g) * LD + kk * 8 + t;
        r3d::split_tf32(kr[0], kh[nt][0], kl[nt][0]);
        r3d::split_tf32(kr[4], kh[nt][1], kl[nt][1]);
      }
      r3d::mma_3xtf32<1, ST>(s, qh[kk], ql[kk], kh, kl);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(bt + nt * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool real = key0 + nt * 8 + 2 * t + (i & 1) < Lk;
        const float sv = real ? fmaf(s[0][nt][i], scale, (i & 1) ? b2.y : b2.x) : -INFINITY;
        s[0][nt][i] = sv;
        mx[i >> 1] = fmaxf(mx[i >> 1], sv);
      }
    }
    // online softmax: l stays a per-lane share until the end; a row with no
    // finite score yet keeps m = -inf and takes its weights against 0
    float corr[2], mu[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float m_new = fmaxf(m[hi], r3d::quad_max(mx[hi]));
      corr[hi] = m_new == -INFINITY ? 1.f : __expf(m[hi] - m_new);
      mu[hi] = m_new == -INFINITY ? 0.f : m_new;
      m[hi] = m_new;
      l[hi] *= corr[hi];
    }
    float part[NACC][1][NT][4];   // this tile's P v, from zero
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[a][0][nt][i] = 0.f;
      }
    }
    // this tile's P v, one k-step of 8 keys (a score n-tile) at a time: A
    // column t is key 2t, column t + 4 key 2t + 1
#pragma unroll
    for (int kk = 0; kk < ST; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = __expf(s[0][kk][i] - mu[i >> 1]);
        l[i >> 1] += p[i];
        if (kDropout) p[i] *= kp[kk][i];
      }
      uint32_t ph[1][4], pl[1][4];
      r3d::split_tf32(p[0], ph[0][0], pl[0][0]);   // (row g, key 2t)
      r3d::split_tf32(p[2], ph[0][1], pl[0][1]);   // (row g + 8, key 2t)
      r3d::split_tf32(p[1], ph[0][2], pl[0][2]);   // (row g, key 2t + 1)
      r3d::split_tf32(p[3], ph[0][3], pl[0][3]);   // (row g + 8, key 2t + 1)
      uint32_t vh[NT][2], vl[NT][2];   // B = V: (key 2t or 2t + 1, dim g) of each n-tile
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* vr = vs + (kk * 8 + 2 * t) * LD + nt * 8 + g;
        r3d::split_tf32(vr[0], vh[nt][0], vl[nt][0]);
        r3d::split_tf32(vr[LD], vh[nt][1], vl[nt][1]);
      }
      r3d::mma_3xtf32<1, NT>(part[kk % NACC], ph, pl, vh, vl);
    }
    // this lane's keep bits of its two rows for the backward
    // (attention_many.cuh), from the keep factors once the products are issued
    if (kDropout && kStats) {
      uint32_t w = 0u;
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kp[nt][i] != 0.f) w |= 1u << ((i >> 1) * 16 + nt * 2 + (i & 1));
        }
      }
      keep_bits[r3d::keep_record(bh, q0 >> 4, tile, (Lq + 15) >> 4, ntiles) + lane] = w;
    }
    // acc = acc * corr + this tile's P v, in fp32
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = NACC == 2 ? part[0][0][nt][i] + part[NACC - 1][0][nt][i]
                                  : part[0][0][nt][i];
        acc[nt][i] = fmaf(acc[nt][i], corr[i >> 1], x);
      }
    }
  }
  r3d::cp_async_wait<0>();   // no copy outlives the block (the last groups are empty)
  if (!active) return;

  // out = acc / l, once, in fp32; with kStats the statistics m (0 for a row
  // with no finite score, whose 1 / l is 0) and 1 / l
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float lr = r3d::quad_sum(l[hi]);
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    const int row = q0 + g + hi * 8;
    if (row >= Lq) continue;
    float* o = out + (static_cast<size_t>(bh) * Lq + row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<float2*>(o + nt * 8) =
          make_float2(acc[nt][hi * 2] * inv, acc[nt][hi * 2 + 1] * inv);
    }
    if (kStats && t == 0) {
      const size_t i = static_cast<size_t>(bh) * Lq + row;
      stats[i] = m[hi] == -INFINITY ? 0.f : m[hi];
      stats[static_cast<size_t>(gridDim.y) * Lq + i] = inv;
    }
  }
}

template <int D, bool kDropout, bool kStats>
int launch(const float* q, const float* k, const float* v, const float* bias, float* out,
           float* stats, uint32_t* keep_bits, int B, int H, int Lq, int Lk, float scale,
           uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t stream) {
  const auto kernel = attention_fwd_many_f32_kernel<D, kDropout, kStats>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes<D>));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((Lq + BQ - 1) / BQ, B * H), NTH, kSmemBytes<D>, stream>>>(
      q, k, v, bias, out, stats, keep_bits, H, Lq, Lk, scale, seed, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDropout>
int launch_d(const float* q, const float* k, const float* v, const float* bias, float* out,
             float* stats, uint32_t* keep_bits, int B, int H, int Lq, int Lk, float scale,
             uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t s) {
  return stats != nullptr
             ? launch<D, kDropout, true>(q, k, v, bias, out, stats, keep_bits, B, H, Lq, Lk,
                                         scale, seed, threshold, keep_scale, s)
             : launch<D, kDropout, false>(q, k, v, bias, out, stats, keep_bits, B, H, Lq, Lk,
                                          scale, seed, threshold, keep_scale, s);
}

template <bool kDropout>
int dispatch(const float* q, const float* k, const float* v, const float* bias, float* out,
             float* stats, uint32_t* keep_bits, int B, int H, int Lq, int Lk, int D, float scale,
             uint32_t seed, uint32_t threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535 ||
      (kDropout && stats != nullptr && keep_bits == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16, kDropout>(q, k, v, bias, out, stats, keep_bits, B, H, Lq, Lk, scale,
                                    seed, threshold, keep_scale, s);
    case 32:
      return launch_d<32, kDropout>(q, k, v, bias, out, stats, keep_bits, B, H, Lq, Lk, scale,
                                    seed, threshold, keep_scale, s);
    case 64:
      return launch_d<64, kDropout>(q, k, v, bias, out, stats, keep_bits, B, H, Lq, Lk, scale,
                                    seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, Lq, D], k and v [B, H, Lk, D], out [B, H, Lq, D], all fp32 and
// contiguous, k and v 16-byte aligned; bias [B, Lk] fp32 or null; stats
// [2, B*H, Lq] fp32 (m, then 1 / l) for a call that trains, else null. D
// must be 16, 32 or 64 and B*H at most 65,535.
extern "C" int r3d_attention_fwd_many_f32(const float* q, const float* k, const float* v,
                                          const float* bias, float* out, float* stats, int B,
                                          int H, int Lq, int Lk, int D, float scale,
                                          void* stream) {
  return dispatch<false>(q, k, v, bias, out, stats, nullptr, B, H, Lq, Lk, D, scale, 0u, 0u, 1.f,
                         stream);
}

// As above, with dropout on the weights: an element is kept when its
// dropout bits under `seed` are >= `threshold` (= rate * 2^32) and then
// scaled by `keep_scale` (= 1 / (1 - rate)). B*H*Lq*Lk must fit in 32 bits.
// With stats, keep_bits (uint32 [B*H, ceil(Lq / 16), ceil(Lk / 64), 32],
// attention_many.cuh) takes the keep mask.
extern "C" int r3d_attention_fwd_dropout_many_f32(const float* q, const float* k, const float* v,
                                                  const float* bias, float* out, float* stats,
                                                  uint32_t* keep_bits, int B, int H, int Lq,
                                                  int Lk, int D, float scale, uint32_t seed,
                                                  uint32_t threshold, float keep_scale,
                                                  void* stream) {
  return dispatch<true>(q, k, v, bias, out, stats, keep_bits, B, H, Lq, Lk, D, scale, seed,
                        threshold, keep_scale, stream);
}
