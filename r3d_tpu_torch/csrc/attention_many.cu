// Attention forward for many queries, bf16: out = softmax(q k^T * scale +
// bias) v with an fp32 online softmax, optionally with dropout on the
// weights, and what the backward (attention_many_bwd.cu) takes from it.
//
// Replaces, at many queries, the Pallas kernels r3d_tpu/ops/attention.py:38
// `_kernel` (launched by `_pallas_attention`, pallas_call at :82), K3, and
// :192 `_kernel_dropout` (launched by `_pallas_attention_dropout`,
// pallas_call at :305), K4. The TPU kernels take a block of 256 queries
// against the whole padded key range in VMEM with a one-shot softmax.
// attention.cu keeps the bodies built for 8-20 queries (the utkinects and
// 50salads decoders); ops/attention.py sends a bf16 call here when it has at
// least MANY_QUERY_MIN queries: the gt-query FUTR's decoder (futr_proposed),
// S queries against S keys, self and cross, S up to 3,100.
// Layout: q, out [B, H, Lq, D], k, v [B, H, Lk, D], a key-padding bias
// [B, Lk] of 0 or finfo(float32).min (or null), all bf16 but the bias.
//
// What bounds it on the H100: operations. At B = H = 8, S = 3,100, D = 64
// the two products are 4*B*H*S*S*D = 157 GFLOP, 0.159 ms at 989 TFLOP/s on
// the bf16 tensor cores, against 10.6 MB of q, k, v and out (0.003 ms at
// 3.35 TB/s). Beside the products every score takes an exponential and a
// few fp32 operations (615 M scores at that shape) and, with dropout, a hash
// of its index: about twenty integer operations, on the card's 64 integer
// lanes an SM.
//
// The design (one launch, no cluster, no scratch, no atomics):
// - Grid (ceil(Lq / 64), B*H), 4 warps; each warp owns 16 query rows end to
//   end and holds their q as mma A fragments in registers for the whole
//   key walk.
// - The keys stream in tiles of 64 through a ring of three stages in
//   dynamic shared memory (K and V as swizzled bf16 tiles, 16-byte
//   cp.async; the tile's bias, 4-byte cp.async), one barrier a tile: the
//   copies of tiles t+1 and t+2 are in flight under the products of tile t.
//   Keys past Lk are never read: zero-filled, with a bias of -inf.
// - S = q k^T and acc += P v run on the tensor cores (mma.sync m16n8k16,
//   bf16 operands, fp32 sums; mma_bf16.cuh), V read through ldmatrix.trans.
// - The softmax is online, in fp32, per row (flash-attention 2's loop
//   order): the running max m, the sum l of exp(s - m) over the unrounded
//   weights, acc rescaled by exp(m_old - m_new) when the max grows.
// - Rounding point: the weights are rounded to bf16 UNNORMALISED, against
//   the running max, after the keep factor (round_bf16(exp(s - m) * keep)),
//   as bf16 K6 does (cross_attention.cu), where the TPU kernel and the plain
//   version (ops/attention.py:composed_attention) round the normalised
//   weights: a weight can differ from the plain version's by one bf16 step.
//   The output acc / l is written once in bf16.
// - Dropout: the keep mask is r3d::dropout_bits of the element index
//   ((b*H + h)*Lq + q)*Lk + k (common.cuh), independent of the tiling. Each
//   tile's keep factors are hashed before its products, so that their
//   integer work can overlap the tensor cores'.
// - For the backward (the call that trains, out32 given): m and 1 / l per
//   query, fp32 [2, B*H, Lq] (1.6 MB at the shape above; not lse = m + log
//   l: a row whose every real key carries finfo.min has m = finfo.min, where
//   m + log l rounds back to m and the backward would lose the 1 / l of its
//   uniform weights); out in fp32 from fp32-accurate weights, [B, H, Lq, D]:
//   each weight's bf16 remainder takes a second product with V, so that the
//   backward's Dq = rowsum(g o out32) is what the plain version sums; with
//   dropout the keep mask as bits (attention_many.cuh; 78 MB at the shape
//   above), one 128-byte record a warp and tile, so that the backward reads
//   it instead of hashing every weight twice more (the hash, some twenty
//   integer operations a weight, is what K4 pays over K3).
// A row whose every real key is masked averages V over the real keys; a row
// whose every score is -inf gives 0 (m = 0, 1 / l = 0). Queries past Lq
// are neither computed nor written. Deterministic.

#include <cuda_runtime.h>

#include "attention_many.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 4;            // warps per block, 16 queries each
constexpr int NTH = NW * 32;
constexpr int BQ = NW * 16;      // queries per block
constexpr int KT = r3d::kManyKeyTile;   // keys per tile
constexpr int NSTAGE = 3;        // tiles in the ring: two copies in flight under the math

template <int D>
constexpr size_t kStageBytes = 2 * KT * D * sizeof(bf16) + KT * sizeof(float);

// kOut32 (a call that trains): also write out in fp32 from fp32-accurate
// weights (each rounded weight's bf16 remainder in a second product), for
// the backward's Dq, and with dropout the keep mask as bits
// (attention_many.cuh). Such a call is held to three blocks an SM: uncapped
// it takes 236 registers at D = 64 (two blocks), capped at 168 it spills a
// few bytes and runs faster; the others take at most 160 and fit three.
template <int D, bool kDropout, bool kOut32>
__global__ void __launch_bounds__(NTH, kOut32 ? 3 : 2)
attention_fwd_many_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          bf16* __restrict__ out, float* __restrict__ out32,
                          float* __restrict__ stats, uint32_t* __restrict__ keep_bits, int H,
                          int Lq, int Lk, float scale, uint32_t seed, uint32_t threshold,
                          float keep_scale) {
  constexpr int CH = D / 8;    // 16-byte chunks of a row
  constexpr int KS = D / 16;   // k-steps of q k^T
  constexpr int NT = D / 8;    // n-tiles of the output
  constexpr int ST = KT / 8;   // n-tiles of the scores
  constexpr int NACC = kOut32 ? 2 : 1;   // the weights' bf16 parts: high (and low)
  extern __shared__ __align__(128) unsigned char smem_raw[];

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
  const bf16* kb = k + static_cast<size_t>(bh) * Lk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;

  auto stage_k = [&](int tile) {
    return reinterpret_cast<bf16*>(smem_raw + (tile % NSTAGE) * kStageBytes<D>);
  };
  auto stage_bias = [&](int tile) {
    return reinterpret_cast<float*>(stage_k(tile) + 2 * KT * D);
  };
  // tile `tile` of the keys (K, V and the bias) into its stage of the ring;
  // keys past Lk read as zeros with a bias of -inf, so they score -inf
  auto copy_tile = [&](int tile) {
    const int key0 = tile * KT;
    bf16* ks = stage_k(tile);
    bf16* vs = ks + KT * D;
    for (int idx = tid; idx < KT * CH; idx += NTH) {
      const int r = idx / CH;
      const int c = idx % CH;
      const bool ok = key0 + r < Lk;
      const size_t off = static_cast<size_t>(ok ? key0 + r : 0) * D + c * 8;
      r3d::cp_async16(r3d::tile_ptr<D>(ks, r, c), kb + off, ok);
      r3d::cp_async16(r3d::tile_ptr<D>(vs, r, c), vb + off, ok);
    }
    for (int i = tid; i < KT; i += NTH) {
      float* dst = stage_bias(tile) + i;
      if (key0 + i >= Lk) {
        *dst = -INFINITY;
      } else {   // no bias: 0
        r3d::cp_async4(dst, biasb != nullptr ? static_cast<const void*>(biasb + key0 + i) : kb,
                       biasb != nullptr);
      }
    }
  };
#pragma unroll
  for (int tile = 0; tile < NSTAGE - 1; ++tile) {   // one commit group per tile
    if (tile < ntiles) copy_tile(tile);
    r3d::cp_async_commit();
  }

  // the warp's queries as A fragments, straight from device memory (rows past Lq: 0)
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + g + (i & 1) * 8;
      const int d = ks * 16 + 2 * t + (i >> 1) * 8;
      qf[ks][i] = row < Lq ? *reinterpret_cast<const uint32_t*>(
                                 q + (static_cast<size_t>(bh) * Lq + row) * D + d)
                           : 0u;
    }
  }

  // rows of this thread: hi = 0, 1 is query q0 + g + hi*8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  uint32_t el_row[2];   // the dropout index of each row's key 0
  float acc[NACC][NT][4];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    el_row[hi] = (static_cast<uint32_t>(bh) * Lq + q0 + g + hi * 8) * Lk;
  }
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[a][nt][i] = 0.f;
    }
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    // tile's copy has landed and every warp is done with tile - 1, whose
    // stage takes the copy of tile + NSTAGE - 1
    r3d::cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (tile + NSTAGE - 1 < ntiles) copy_tile(tile + NSTAGE - 1);
    r3d::cp_async_commit();
    if (!active) continue;
    const int key0 = tile * KT;
    const bf16* ks = stage_k(tile);
    const bf16* vs = ks + KT * D;
    const float* bt = stage_bias(tile);

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

    // scores of 16 queries x 64 keys: s[nt][hi*2 + j] is key nt*8 + 2t + j
    float s[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        uint32_t kf[4];
        r3d::load_b_frag<D>(kf, ks, np * 16, kk, lane);
        r3d::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        r3d::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      const float2 b2 = *reinterpret_cast<const float2*>(bt + nt * 8 + 2 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sv = fmaf(s[nt][i], scale, (i & 1) ? b2.y : b2.x);
        s[nt][i] = sv;
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
    // the weights as A fragments, k-steps of 16 keys: [0] rounded to bf16,
    // [1] (kOut32) the bf16 rounding of what [0] left out
    uint32_t pf[NACC][KT / 16][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = __expf(s[nt][i] - mu[i >> 1]);
        l[i >> 1] += p;
        pv[i] = kDropout ? p * kp[nt][i] : p;
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        uint32_t& w = pf[0][nt >> 1][(nt & 1) * 2 + hi];
        w = r3d::pack_bf16(pv[hi * 2], pv[hi * 2 + 1]);
        if (kOut32) {
          const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
          pf[NACC - 1][nt >> 1][(nt & 1) * 2 + hi] =
              r3d::pack_bf16(pv[hi * 2] - h.x, pv[hi * 2 + 1] - h.y);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[a][nt][0] *= corr[0];
        acc[a][nt][1] *= corr[0];
        acc[a][nt][2] *= corr[1];
        acc[a][nt][3] *= corr[1];
      }
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vf[4];
        r3d::load_b_frag_trans<D>(vf, vs, kk * 16, np, lane);
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          r3d::mma_bf16(acc[a][2 * np], pf[a][kk], vf[0], vf[1]);
          r3d::mma_bf16(acc[a][2 * np + 1], pf[a][kk], vf[2], vf[3]);
        }
      }
    }
    // this lane's keep bits of its two rows for the backward
    // (attention_many.cuh), from the keep factors once the products are
    // issued: folded into the hashing above, they lengthened its chain and
    // cost far more than their own few operations
    if (kDropout && kOut32) {
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
  }
  r3d::cp_async_wait<0>();   // no copy outlives the block (the last groups are empty)
  if (!active) return;

  // out = acc / l, once, in bf16 (and in fp32); the statistics m (0 for a
  // row with no finite score, whose 1 / l is 0) and 1 / l
  const size_t BHL = static_cast<size_t>(gridDim.y) * Lq;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float lr = r3d::quad_sum(l[hi]);
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    const int row = q0 + g + hi * 8;
    if (row >= Lq) continue;
    const size_t off = (static_cast<size_t>(bh) * Lq + row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float x = acc[0][nt][hi * 2];
      const float y = acc[0][nt][hi * 2 + 1];
      *reinterpret_cast<uint32_t*>(out + off + nt * 8) = r3d::pack_bf16(x * inv, y * inv);
      if (kOut32) {
        *reinterpret_cast<float2*>(out32 + off + nt * 8) =
            make_float2((x + acc[NACC - 1][nt][hi * 2]) * inv,
                        (y + acc[NACC - 1][nt][hi * 2 + 1]) * inv);
      }
    }
    if (t == 0) {
      stats[static_cast<size_t>(bh) * Lq + row] = m[hi] == -INFINITY ? 0.f : m[hi];
      stats[BHL + static_cast<size_t>(bh) * Lq + row] = inv;
    }
  }
}

template <int D, bool kDropout, bool kOut32>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out,
           float* out32, float* stats, uint32_t* keep_bits, int B, int H, int Lq, int Lk,
           float scale, uint32_t seed, uint32_t threshold, float keep_scale,
           cudaStream_t stream) {
  constexpr size_t smem = NSTAGE * kStageBytes<D>;
  const auto kernel = attention_fwd_many_kernel<D, kDropout, kOut32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((Lq + BQ - 1) / BQ, B * H), NTH, smem, stream>>>(
      q, k, v, bias, out, out32, stats, keep_bits, H, Lq, Lk, scale, seed, threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kDropout>
int launch_d(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out,
             float* out32, float* stats, uint32_t* keep_bits, int B, int H, int Lq, int Lk,
             float scale, uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t s) {
  return out32 != nullptr
             ? launch<D, kDropout, true>(q, k, v, bias, out, out32, stats, keep_bits, B, H, Lq,
                                         Lk, scale, seed, threshold, keep_scale, s)
             : launch<D, kDropout, false>(q, k, v, bias, out, out32, stats, keep_bits, B, H, Lq,
                                          Lk, scale, seed, threshold, keep_scale, s);
}

template <bool kDropout>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out,
             float* out32, float* stats, uint32_t* keep_bits, int B, int H, int Lq, int Lk, int D,
             float scale, uint32_t seed, uint32_t threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535 || stats == nullptr ||
      (kDropout && out32 != nullptr && keep_bits == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_d<16, kDropout>(q, k, v, bias, out, out32, stats, keep_bits, B, H, Lq, Lk,
                                    scale, seed,
                                    threshold, keep_scale, s);
    case 32:
      return launch_d<32, kDropout>(q, k, v, bias, out, out32, stats, keep_bits, B, H, Lq, Lk,
                                    scale, seed,
                                    threshold, keep_scale, s);
    case 64:
      return launch_d<64, kDropout>(q, k, v, bias, out, out32, stats, keep_bits, B, H, Lq, Lk,
                                    scale, seed,
                                    threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, Lq, D], k and v [B, H, Lk, D], out [B, H, Lq, D], all bf16,
// contiguous and 16-byte aligned; bias [B, Lk] fp32 or null; out32 [B, H,
// Lq, D] fp32 or null (out from fp32-accurate weights, for the backward);
// stats [2, B*H, Lq] fp32 (m, then 1 / l). D must be 16, 32 or 64 and B*H
// at most 65,535.
extern "C" int r3d_attention_fwd_many_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const float* bias, bf16* out, float* out32,
                                           float* stats, int B, int H, int Lq, int Lk, int D,
                                           float scale, void* stream) {
  return dispatch<false>(q, k, v, bias, out, out32, stats, nullptr, B, H, Lq, Lk, D, scale, 0u,
                         0u, 1.f, stream);
}

// As above, with dropout on the weights: an element is kept when its
// dropout bits under `seed` are >= `threshold` (= rate * 2^32) and then
// scaled by `keep_scale` (= 1 / (1 - rate)). B*H*Lq*Lk must fit in 32 bits.
// With out32, keep_bits (uint32 [B*H, ceil(Lq / 16), ceil(Lk / 64), 32],
// attention_many.cuh)
// takes the keep mask for the backward.
extern "C" int r3d_attention_fwd_dropout_many_bf16(const bf16* q, const bf16* k, const bf16* v,
                                                   const float* bias, bf16* out, float* out32,
                                                   float* stats, uint32_t* keep_bits, int B,
                                                   int H, int Lq, int Lk, int D, float scale,
                                                   uint32_t seed, uint32_t threshold,
                                                   float keep_scale, void* stream) {
  return dispatch<true>(q, k, v, bias, out, out32, stats, keep_bits, B, H, Lq, Lk, D, scale, seed,
                        threshold, keep_scale, stream);
}
