// Attention backward for many queries, bf16: dq, dk, dv (and the bias's
// cotangent) of out = (softmax(q k^T * scale + bias) * keep) v, from what
// the forward of the same call kept (attention_many.cu): each query's m and
// 1 / l, out in fp32 from fp32-accurate weights and the keep mask as bits. With w the softmax
// weights, keep the dropout mask scaled 1/(1-p) (1 at rate 0), g the
// cotangent of out and Dq = sum_k w_qk keep_qk (g_q . v_k):
//
//   dv_k = sum_q w_qk keep_qk g_q       ds_qk = w_qk (keep_qk (g_q . v_k) - Dq)
//   dq_q = scale sum_k ds_qk k_k        dk_k = scale sum_q ds_qk q_q
//   dbias_k = sum over heads and queries of ds_qk
//
// Replaces, at many queries, the Pallas kernel r3d_tpu/ops/attention.py:215
// `_bwd_kernel_dropout` (launched by `_pallas_attention_bwd`, pallas_call at
// :337), K5. Its grid (B*H, query blocks) runs in order on the TPU, and dk,
// dv and dbias accumulate across the grid steps in the output refs; blocks
// on Hopper run in no order, so each sum that crosses query blocks is owned
// by one block instead. attention_bwd.cu keeps the body built for 8-20
// queries; ops/attention.py sends a bf16 call here at MANY_QUERY_MIN queries
// or more (futr_proposed's decoder: S queries against S keys, S up to
// 3,100).
//
// What bounds it on the H100: operations. The backward's five products are
// 10*B*H*Lq*Lk*D = 394 GFLOP at B = H = 8, S = 3,100, D = 64, 0.398 ms at
// 989 TFLOP/s; this design does eight (the scores and g v^T twice, dv's low
// part once more), 0.64 ms. Its bytes (q, k, v, g, out32 and the keep bits
// in; dq, dk, dv out; 308 MB) take 0.092 ms. Beside the products every
// weight takes two exponentials, a few fp32 operations and two reads of its
// keep bit.
//
// The design, two launches, no scratch beyond Dq (fp32 [B*H, Lq]), no
// memset, no atomics, deterministic:
// - Launch 1, Dq and dq over query tiles. Grid (ceil(Lq / 64), B*H), 4 warps
//   of 16 query rows each, q and g of the rows held as mma A fragments in
//   registers. Each warp first forms Dq = rowsum(g o out32) of its rows in
//   fp32 and writes it: the forward's out in fp32 from fp32-accurate
//   weights, so Dq is the plain version's sum P keep dP. (From the bf16 out,
//   flash-attention 2's way, every ds would carry the bf16 rounding of out
//   and of the keep factor 1/(1-p): with one key, where the plain version's
//   ds is exactly 0, dq and dk would come out at the size of that rounding
//   times |g||v||k|.) It then walks the keys in tiles of 64 through a ring
//   of three stages (K, V swizzled bf16 tiles by 16-byte cp.async, the
//   tile's bias), one barrier a tile: S = q k^T and dP = g v^T on the tensor
//   cores, P = exp(s - m) / l from the forward's statistics, the keep
//   factors from the forward's bits (one word a lane and tile), ds = P (dP
//   keep - Dq) in fp32, and dq += round_bf16(ds) k with K read through
//   ldmatrix.trans. dq is written once in bf16.
// - Launch 2, dk, dv and dbias over key tiles. Grid (ceil(Lk / 64), B*H), 4
//   warps of 16 keys each; the block OWNS dk, dv and dbias of its 64 keys
//   (the rule of the fp32 cluster body and of the key-block body before
//   this one). K and V of the block sit in shared memory; the queries
//   stream in tiles of 64 through a ring of three stages (q, g, and each
//   query's m, 1 / l and Dq, and the tile's keep-bit records for the
//   block's keys). With the keys as the product's rows: s^T =
//   k q^T and dP^T = v g^T on the tensor cores, P, keep and ds as above,
//   dv += (P keep)^T g and dk += round_bf16(ds)^T q, both with q and g read
//   through ldmatrix.trans; dbias sums the unrounded ds. Each warp keeps its
//   sums in registers over every query tile and writes them once (dk, dv in
//   bf16, dbias in fp32 per head, [B, H, Lk], for the caller to sum over
//   heads).
// - Rounding points, bf16 K7's (cross_attention_bwd.cu): ds is rounded to
//   bf16 before the dq and dk products; P keep stays at fp32 accuracy for
//   dv as the sum of a bf16 high and a bf16 low part, two products (about
//   2^-16 relative, far under dv's own rounding); the plain version
//   (ops/attention.py:composed_attention_bwd) keeps every product in fp32.
// Keys past Lk are never read (zero-filled with a bias of -inf) and are not
// written; queries past Lq weigh 0 (their 1 / l is read as 0) and are not
// written. A row whose every real key carries finfo.min has m = finfo.min
// and weights 1 / l; a row whose every score is -inf has 1 / l = 0 and gives
// zeros.

#include <cuda_runtime.h>

#include "attention_many.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 4;          // warps per block, 16 rows each
constexpr int NTH = NW * 32;
constexpr int BR = NW * 16;    // rows per block: queries (launch 1) or keys (launch 2)
constexpr int TT = r3d::kManyKeyTile;   // keys (launch 1) or queries (launch 2) per tile
constexpr int NSTAGE = 3;      // tiles in a ring: two copies in flight under the math

// Launch 1's stage: K and V tiles, the tiles' bias.
template <int D>
constexpr size_t kKeyStageBytes = 2 * TT * D * sizeof(bf16) + TT * sizeof(float);
// Launch 2's stage: q and g tiles, each query's m, 1 / l and Dq, and the
// keep-bit records of the tile's 4 blocks of 16 queries for this block's keys.
template <int D>
constexpr size_t kQueryStageBytes =
    2 * TT * D * sizeof(bf16) + 3 * TT * sizeof(float) + 4 * 32 * sizeof(uint32_t);
static_assert(BR == TT, "a block of launch 2 owns one key tile of the forward's keep bits");

// Two floats as a bf16 high part and the bf16 rounding of the rest.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  hi = r3d::pack_bf16(x, y);
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  lo = r3d::pack_bf16(x - h.x, y - h.y);
}

// Launch 1: Dq, then dq of 64 queries.
template <int D, bool kDropout>
__global__ void __launch_bounds__(NTH, 3)
attention_bwd_many_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ bias,
                             const bf16* __restrict__ g, const float* __restrict__ out32,
                             const float* __restrict__ stats,
                             const uint32_t* __restrict__ keep_bits, float* __restrict__ delta,
                             bf16* __restrict__ dq, int H, int Lq, int Lk, float scale,
                             float keep_scale) {
  constexpr int CH = D / 8;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr int ST = TT / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BR + warp * 16;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const bool active = q0 < Lq;
  const int ntiles = (Lk + TT - 1) / TT;
  const size_t BHL = static_cast<size_t>(gridDim.y) * Lq;
  const bf16* kb = k + static_cast<size_t>(bh) * Lk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;

  auto stage_k = [&](int tile) {
    return reinterpret_cast<bf16*>(smem_raw + (tile % NSTAGE) * kKeyStageBytes<D>);
  };
  auto stage_bias = [&](int tile) {
    return reinterpret_cast<float*>(stage_k(tile) + 2 * TT * D);
  };
  // key tile `tile` into its stage; keys past Lk read as zeros with a bias of -inf
  auto copy_tile = [&](int tile) {
    const int key0 = tile * TT;
    bf16* ks = stage_k(tile);
    bf16* vs = ks + TT * D;
    for (int idx = tid; idx < TT * CH; idx += NTH) {
      const int r = idx / CH;
      const int c = idx % CH;
      const bool ok = key0 + r < Lk;
      const size_t off = static_cast<size_t>(ok ? key0 + r : 0) * D + c * 8;
      r3d::cp_async16(r3d::tile_ptr<D>(ks, r, c), kb + off, ok);
      r3d::cp_async16(r3d::tile_ptr<D>(vs, r, c), vb + off, ok);
    }
    for (int i = tid; i < TT; i += NTH) {
      float* dst = stage_bias(tile) + i;
      if (key0 + i >= Lk) {
        *dst = -INFINITY;
      } else {
        r3d::cp_async4(dst, biasb != nullptr ? static_cast<const void*>(biasb + key0 + i) : kb,
                       biasb != nullptr);
      }
    }
  };
#pragma unroll
  for (int tile = 0; tile < NSTAGE - 1; ++tile) {
    if (tile < ntiles) copy_tile(tile);
    r3d::cp_async_commit();
  }

  // the warp's rows: q and g as A fragments (rows past Lq: 0), m and 1 / l
  // (rows past Lq: 0, so they weigh 0), Dq
  uint32_t qf[KS][4], gf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + gq + (i & 1) * 8;
      const size_t off = (static_cast<size_t>(bh) * Lq + row) * D + ks * 16 + 2 * t + (i >> 1) * 8;
      qf[ks][i] = row < Lq ? *reinterpret_cast<const uint32_t*>(q + off) : 0u;
      gf[ks][i] = row < Lq ? *reinterpret_cast<const uint32_t*>(g + off) : 0u;
    }
  }
  float mrow[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f}, drow[2] = {0.f, 0.f};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + gq + hi * 8;
    if (row < Lq) {
      mrow[hi] = stats[static_cast<size_t>(bh) * Lq + row];
      inv_l[hi] = stats[BHL + static_cast<size_t>(bh) * Lq + row];
    }
  }
  if (active) {
    for (int r = 0; r < 16; ++r) {   // Dq = rowsum(g o out32), in fp32
      const int row = q0 + r;
      float a = 0.f;
      if (row < Lq) {
        const size_t off = (static_cast<size_t>(bh) * Lq + row) * D;
        for (int d = 2 * lane; d < D; d += 64) {
          const float2 gv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + off + d));
          const float2 ov = *reinterpret_cast<const float2*>(out32 + off + d);
          a = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, a));
        }
      }
      a = r3d::warp_sum(a);
      if (r == gq) drow[0] = a;
      if (r == gq + 8) drow[1] = a;
      if (lane == 0 && row < Lq) delta[static_cast<size_t>(bh) * Lq + row] = a;
    }
  }

  float dqa[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[nt][i] = 0.f;
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    r3d::cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (tile + NSTAGE - 1 < ntiles) copy_tile(tile + NSTAGE - 1);
    r3d::cp_async_commit();
    if (!active) continue;
    const int key0 = tile * TT;
    const bf16* ks = stage_k(tile);
    const bf16* vs = ks + TT * D;
    const float* bt = stage_bias(tile);

    // the forward's keep bits of this lane's keys of its two rows
    const uint32_t kw =
        kDropout ? keep_bits[r3d::keep_record(bh, q0 >> 4, tile, (Lq + 15) >> 4, ntiles) + lane]
                 : 0u;
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        uint32_t kf[4], vf[4];
        r3d::load_b_frag<D>(kf, ks, np * 16, kk, lane);
        r3d::load_b_frag<D>(vf, vs, np * 16, kk, lane);
        r3d::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        r3d::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        r3d::mma_bf16(dp[2 * np], gf[kk], vf[0], vf[1]);
        r3d::mma_bf16(dp[2 * np + 1], gf[kk], vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < TT / 16; ++kk) {
      uint32_t dsf[4];   // round_bf16(ds) of keys kk*16 .. +15 as an A fragment
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        const int nt = 2 * kk + sub;
        const float2 b2 = *reinterpret_cast<const float2*>(bt + nt * 8 + 2 * t);
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hi = i >> 1;
          const float sv = fmaf(s[nt][i], scale, (i & 1) ? b2.y : b2.x);
          const float p = __expf(sv - mrow[hi]) * inv_l[hi];
          const float km = ((kw >> (hi * 16 + nt * 2 + (i & 1))) & 1u) ? keep_scale : 0.f;
          ds[i] = p * ((kDropout ? dp[nt][i] * km : dp[nt][i]) - drow[hi]);
        }
        dsf[sub * 2] = r3d::pack_bf16(ds[0], ds[1]);
        dsf[sub * 2 + 1] = r3d::pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        r3d::load_b_frag_trans<D>(kf, ks, kk * 16, np, lane);
        r3d::mma_bf16(dqa[2 * np], dsf, kf[0], kf[1]);
        r3d::mma_bf16(dqa[2 * np + 1], dsf, kf[2], kf[3]);
      }
    }
  }
  r3d::cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + gq + hi * 8;
    if (row >= Lq) continue;
    bf16* o = dq + (static_cast<size_t>(bh) * Lq + row) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(o + nt * 8 + 2 * t) =
          r3d::pack_bf16(dqa[nt][hi * 2] * scale, dqa[nt][hi * 2 + 1] * scale);
    }
  }
}

// Launch 2: dk, dv and dbias of 64 keys. Three blocks an SM: at D = 64 it
// asks for 217 registers uncapped (two blocks), 168 with a few bytes
// spilled, and runs faster so.
template <int D, bool kDropout>
__global__ void __launch_bounds__(NTH, 3)
attention_bwd_many_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const float* __restrict__ bias,
                               const bf16* __restrict__ g, const float* __restrict__ stats,
                               const uint32_t* __restrict__ keep_bits,
                               const float* __restrict__ delta, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, float* __restrict__ dbias, int H, int Lq,
                               int Lk, float scale, float keep_scale) {
  constexpr int CH = D / 8;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr int ST = TT / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* kblk = reinterpret_cast<bf16*>(smem_raw);   // [BR][D], swizzled
  bf16* vblk = kblk + BR * D;
  unsigned char* ring = smem_raw + 2 * BR * D * sizeof(bf16);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * BR;
  const int kw = k0 + warp * 16;   // this warp's first key
  const int bh = blockIdx.y;
  const int b = bh / H;
  const bool active = kw < Lk;
  const int ntiles = (Lq + TT - 1) / TT;
  const size_t BHL = static_cast<size_t>(gridDim.y) * Lq;
  const bf16* qb = q + static_cast<size_t>(bh) * Lq * D;
  const bf16* gb = g + static_cast<size_t>(bh) * Lq * D;
  const float* mb = stats + static_cast<size_t>(bh) * Lq;
  const float* ilb = stats + BHL + static_cast<size_t>(bh) * Lq;
  const float* db = delta + static_cast<size_t>(bh) * Lq;

  auto stage_q = [&](int tile) {
    return reinterpret_cast<bf16*>(ring + (tile % NSTAGE) * kQueryStageBytes<D>);
  };
  auto stage_f = [&](int tile) {   // m, 1 / l, Dq: three runs of TT floats
    return reinterpret_cast<float*>(stage_q(tile) + 2 * TT * D);
  };
  auto stage_bits = [&](int tile) {   // 4 records of 32 words
    return reinterpret_cast<uint32_t*>(stage_f(tile) + 3 * TT);
  };
  const int nkt = (Lk + TT - 1) / TT;   // key tiles of a record's rows
  const int n_rb = (Lq + 15) >> 4;      // blocks of 16 query rows
  auto copy_tile = [&](int tile) {
    const int qt0 = tile * TT;
    bf16* qs = stage_q(tile);
    bf16* gs = qs + TT * D;
    for (int idx = tid; idx < TT * CH; idx += NTH) {
      const int r = idx / CH;
      const int c = idx % CH;
      const bool ok = qt0 + r < Lq;
      const size_t off = static_cast<size_t>(ok ? qt0 + r : 0) * D + c * 8;
      r3d::cp_async16(r3d::tile_ptr<D>(qs, r, c), qb + off, ok);
      r3d::cp_async16(r3d::tile_ptr<D>(gs, r, c), gb + off, ok);
    }
    if (tid < TT) {   // queries past Lq: m = 1 / l = Dq = 0, so they weigh 0
      const bool ok = qt0 + tid < Lq;
      const int i = ok ? qt0 + tid : 0;
      float* f = stage_f(tile);
      r3d::cp_async4(f + tid, mb + i, ok);
      r3d::cp_async4(f + TT + tid, ilb + i, ok);
      r3d::cp_async4(f + 2 * TT + tid, db + i, ok);
    }
    if (kDropout && tid < 32) {   // 16 bytes each: 4 records of 128
      const int rb = (qt0 >> 4) + (tid >> 3);
      const bool ok = rb < n_rb;
      r3d::cp_async16(stage_bits(tile) + 4 * tid,
                      keep_bits + (ok ? r3d::keep_record(bh, rb, blockIdx.x, n_rb, nkt) : 0) +
                          4 * (tid & 7),
                      ok);
    }
  };
  // the block's keys of K and V go with the first tile's group
  for (int idx = tid; idx < BR * CH; idx += NTH) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool ok = k0 + r < Lk;
    const size_t off = (static_cast<size_t>(bh) * Lk + (ok ? k0 + r : 0)) * D + c * 8;
    r3d::cp_async16(r3d::tile_ptr<D>(kblk, r, c), k + off, ok);
    r3d::cp_async16(r3d::tile_ptr<D>(vblk, r, c), v + off, ok);
  }
#pragma unroll
  for (int tile = 0; tile < NSTAGE - 1; ++tile) {
    if (tile < ntiles) copy_tile(tile);
    r3d::cp_async_commit();
  }

  // this thread's keys: hi = 0, 1 is key kw + gq + hi*8
  // where the forward's keep bits hold this thread's keys: the lane t' =
  // (key % 8) / 2 of a record's row, bit (key / 8)*2 + key % 2 (keys of the
  // block's tile)
  const int kword = gq >> 1;
  int kbit[2];
  float bk[2];   // the key's bias; -inf past Lk, so its weights are 0
  bool kok[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = kw + gq + hi * 8;
    kbit[hi] = (2 * warp + hi) * 2 + (gq & 1);
    kok[hi] = key < Lk;
    bk[hi] = !kok[hi] ? -INFINITY : bias != nullptr ? bias[static_cast<size_t>(b) * Lk + key] : 0.f;
  }
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[nt][i] = dva[nt][i] = 0.f;
  }
  float dba[2] = {0.f, 0.f};   // the unrounded ds summed over this thread's queries

  for (int tile = 0; tile < ntiles; ++tile) {
    r3d::cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (tile + NSTAGE - 1 < ntiles) copy_tile(tile + NSTAGE - 1);
    r3d::cp_async_commit();
    if (!active) continue;
    const int qt0 = tile * TT;
    const bf16* qs = stage_q(tile);
    const bf16* gs = qs + TT * D;
    const float* ms = stage_f(tile);
    const float* ils = ms + TT;
    const float* dls = ms + 2 * TT;

    const uint32_t* bits = stage_bits(tile);
    // s^T = k q^T and dP^T = v g^T: 16 keys x 64 queries; [nt][hi*2 + j] is
    // key gq + hi*8 of the warp and query nt*8 + 2t + j of the tile
    float s[ST][4], dp[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      r3d::load_a_frag<D>(ka, kblk, warp, kk, lane);
      r3d::load_a_frag<D>(va, vblk, warp, kk, lane);
#pragma unroll
      for (int np = 0; np < ST / 2; ++np) {
        uint32_t qf[4], gf[4];
        r3d::load_b_frag<D>(qf, qs, np * 16, kk, lane);
        r3d::load_b_frag<D>(gf, gs, np * 16, kk, lane);
        r3d::mma_bf16(s[2 * np], ka, qf[0], qf[1]);
        r3d::mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
        r3d::mma_bf16(dp[2 * np], va, gf[0], gf[1]);
        r3d::mma_bf16(dp[2 * np + 1], va, gf[2], gf[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < TT / 16; ++kk) {   // queries kk*16 .. +15
      uint32_t ph[4], pl[4], dsf[4];   // P keep (high, low) and round_bf16(ds) as A fragments
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
        const int nt = 2 * kk + sub;
        const int c0 = nt * 8 + 2 * t;
        const float2 m2 = *reinterpret_cast<const float2*>(ms + c0);
        const float2 il2 = *reinterpret_cast<const float2*>(ils + c0);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + c0);
        float pk[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hi = i >> 1;
          const bool odd = i & 1;
          const float sv = fmaf(s[nt][i], scale, bk[hi]);
          const float p = __expf(sv - (odd ? m2.y : m2.x)) * (odd ? il2.y : il2.x);
          // query c0 + odd of the tile: block nt / 2, row (nt & 1)*8 + 2t + odd
          const float km =
              !kDropout ? 1.f
                        : ((bits[(nt >> 1) * 32 + (2 * t + odd) * 4 + kword] >>
                            (kbit[hi] + (nt & 1) * 16)) & 1u) ? keep_scale : 0.f;
          pk[i] = p * km;
          ds[i] = p * (dp[nt][i] * km - (odd ? d2.y : d2.x));
          dba[hi] += ds[i];
        }
        split_bf16(pk[0], pk[1], ph[sub * 2], pl[sub * 2]);
        split_bf16(pk[2], pk[3], ph[sub * 2 + 1], pl[sub * 2 + 1]);
        dsf[sub * 2] = r3d::pack_bf16(ds[0], ds[1]);
        dsf[sub * 2 + 1] = r3d::pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t gf[4], qf[4];
        r3d::load_b_frag_trans<D>(gf, gs, kk * 16, np, lane);
        r3d::load_b_frag_trans<D>(qf, qs, kk * 16, np, lane);
        r3d::mma_bf16(dva[2 * np], ph, gf[0], gf[1]);
        r3d::mma_bf16(dva[2 * np + 1], ph, gf[2], gf[3]);
        r3d::mma_bf16(dva[2 * np], pl, gf[0], gf[1]);
        r3d::mma_bf16(dva[2 * np + 1], pl, gf[2], gf[3]);
        r3d::mma_bf16(dka[2 * np], dsf, qf[0], qf[1]);
        r3d::mma_bf16(dka[2 * np + 1], dsf, qf[2], qf[3]);
      }
    }
  }
  r3d::cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float sum = r3d::quad_sum(dba[hi]);
    const int key = kw + gq + hi * 8;
    if (!kok[hi]) continue;
    if (dbias != nullptr && t == 0) dbias[static_cast<size_t>(bh) * Lk + key] = sum;
    const size_t off = (static_cast<size_t>(bh) * Lk + key) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(dk + off + nt * 8 + 2 * t) =
          r3d::pack_bf16(dka[nt][hi * 2] * scale, dka[nt][hi * 2 + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + nt * 8 + 2 * t) =
          r3d::pack_bf16(dva[nt][hi * 2], dva[nt][hi * 2 + 1]);
    }
  }
}

template <int D, bool kDropout>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* bias, const bf16* g,
           const float* out32, const float* stats, const uint32_t* keep_bits, float* delta,
           bf16* dq, bf16* dk, bf16* dv, float* dbias, int B, int H, int Lq, int Lk, float scale,
           float keep_scale, cudaStream_t stream) {
  constexpr size_t smem_dq = NSTAGE * kKeyStageBytes<D>;
  constexpr size_t smem_kv = 2 * BR * D * sizeof(bf16) + NSTAGE * kQueryStageBytes<D>;
  const auto dq_kernel = attention_bwd_many_dq_kernel<D, kDropout>;
  const auto kv_kernel = attention_bwd_many_dkdv_kernel<D, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3((Lq + BR - 1) / BR, B * H), NTH, smem_dq, stream>>>(
      q, k, v, bias, g, out32, stats, keep_bits, delta, dq, H, Lq, Lk, scale, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<<<dim3((Lk + BR - 1) / BR, B * H), NTH, smem_kv, stream>>>(
      q, k, v, bias, g, stats, keep_bits, delta, dk, dv, dbias, H, Lq, Lk, scale, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDropout>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const float* bias, const bf16* g,
             const float* out32, const float* stats, const uint32_t* keep_bits, float* delta,
             bf16* dq, bf16* dk, bf16* dv, float* dbias, int B, int H, int Lq, int Lk, int D,
             float scale, float keep_scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16, kDropout>(q, k, v, bias, g, out32, stats, keep_bits, delta, dq, dk, dv,
                                  dbias, B, H, Lq, Lk, scale, keep_scale, s);
    case 32:
      return launch<32, kDropout>(q, k, v, bias, g, out32, stats, keep_bits, delta, dq, dk, dv,
                                  dbias, B, H, Lq, Lk, scale, keep_scale, s);
    case 64:
      return launch<64, kDropout>(q, k, v, bias, g, out32, stats, keep_bits, delta, dq, dk, dv,
                                  dbias, B, H, Lq, Lk, scale, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g, dq [B, H, Lq, D] and k, v, dk, dv [B, H, Lk, D], all bf16,
// contiguous and 16-byte aligned; bias [B, Lk] fp32 or null; from the
// forward of the same call (r3d_attention_fwd_many_bf16, or its dropout twin
// at the same seed and rate, with out32): out32 [B, H, Lq, D] fp32, stats
// [2, B*H, Lq] fp32 (m and 1 / l) and, with `dropout`, keep_bits (uint32
// [B*H, ceil(Lq / 16), ceil(Lk / 64), 32], attention_many.cuh); delta [B*H,
// Lq] fp32, written here (Dq); dbias [B, H, Lk] fp32 or null (per-head sums, for the
// caller to sum over heads). D must be 16, 32 or 64 and B*H at most 65,535.
// Every output is written; nothing needs to be zeroed.
extern "C" int r3d_attention_bwd_many_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const float* bias, const bf16* g, const float* out32,
                                           const float* stats, const uint32_t* keep_bits,
                                           float* delta, bf16* dq, bf16* dk, bf16* dv,
                                           float* dbias, int B, int H, int Lq, int Lk, int D,
                                           float scale, int dropout, float keep_scale,
                                           void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535 || stats == nullptr ||
      delta == nullptr || out32 == nullptr || (dropout && keep_bits == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch<true>(q, k, v, bias, g, out32, stats, keep_bits, delta, dq, dk, dv,
                                  dbias, B, H, Lq, Lk, D, scale, keep_scale, s)
                 : dispatch<false>(q, k, v, bias, g, out32, stats, keep_bits, delta, dq, dk, dv,
                                   dbias, B, H, Lq, Lk, D, scale, keep_scale, s);
}
