// Attention backward for many queries, fp32: dq, dk, dv (and the bias's
// cotangent) of out = (softmax(q k^T * scale + bias) * keep) v, from what
// the forward of the same call kept (attention_many_f32.cu): each query's m
// and 1 / l and the keep mask as bits. With w the softmax weights, keep the
// dropout mask scaled 1/(1-p) (1 at rate 0), g the cotangent of out and
// Dq = sum_k w_qk keep_qk (g_q . v_k):
//
//   dv_k = sum_q w_qk keep_qk g_q       ds_qk = w_qk (keep_qk (g_q . v_k) - Dq)
//   dq_q = scale sum_k ds_qk k_k        dk_k = scale sum_q ds_qk q_q
//   dbias_k = sum over heads and queries of ds_qk
//
// Replaces, at many queries, the Pallas kernel r3d_tpu/ops/attention.py:215
// `_bwd_kernel_dropout` (launched by `_pallas_attention_bwd`, pallas_call at
// :337), K5, in fp32. Its grid (B*H, query blocks) runs in order on the TPU,
// and dk, dv and dbias accumulate across the grid steps in the output refs;
// blocks on Hopper run in no order, so each sum that crosses query blocks is
// owned by one block instead (the rule of the bf16 many-query backward,
// attention_many_bwd.cu). attention_bwd.cu keeps the cluster body built for
// 8 queries (the utkinects decoder); ops/attention.py sends an fp32 call
// here from FP32_MANY_QUERY_MIN queries: S queries against S keys in the
// encoder (use_encoder) and the depth query source, S up to 2,000.
//
// What bounds it on the H100: operations. The backward's five products are
// 10*B*H*Lq*Lk*D = 41 GFLOP at B = H = 8, S = 2,000, D = 16: 0.248 ms as
// fp32-accurate 3xTF32 tensor-core products (165 TFLOP/s), 0.611 ms on the
// fp32 pipes (67 TFLOP/s). This design does eight (the scores and g v^T in
// both launches, dq as two), 66 GFLOP, 0.40 ms at the 3xTF32 rate. Its
// bytes (q, k, v, g, the statistics and the keep bits in; dq, dk, dv out;
// 25 MB at that shape with dropout) take 0.008 ms. Beside the products
// every weight takes an exponential in each launch (512 M in all) and two
// reads of its keep bit.
//
// The design, two launches, no scratch beyond Dq (fp32 [B*H, Lq]), no
// memset, no atomics, deterministic:
// - Launch 1, Dq and dq over query tiles. Grid (ceil(Lq / 64), B*H), 4 warps
//   of 16 query rows, q and g of the rows held as the TF32 high and low
//   parts of mma A fragments in registers (at D = 64 read again where used,
//   from L1: held, they would take 128 registers a thread). Each warp walks
//   every key in tiles of 64 through a ring of three stages (K, V and the
//   tile's bias as attention_cluster.cuh: f32_load_tile copies them, rows
//   D + 4 floats apart: every fragment read is free of bank conflicts), one
//   barrier a tile. For each tile: S = q k^T and dP = g v^T as 3xTF32
//   mma.sync m16n8k8 with fp32 sums (mma_tf32.cuh), S bit for bit the
//   forward's; P = exp(s - m) / l from the forward's statistics; the keep
//   factors from the forward's bits (one word a lane and tile); u = P keep
//   dP in fp32; Dq += sum u; dq's two parts sum u k and sum P k, 3xTF32
//   again. u and P need no shuffle from their C fragments to the A
//   fragments: a k-step's keys are taken in the order 0, 2, 4, 6, 1, 3, 5, 7,
//   as the forward takes P for P v, and K is read at rows 2t and 2t + 1. At
//   the end dq = scale (sum u k - Dq sum P k) = scale sum ds k, written once,
//   and Dq for launch 2.
// - Dq from the same P and dP that form ds, as the plain version and the
//   cluster body take it, and not as rowsum(g o out): the forward's out
//   and this launch's dP carry different 3xTF32 roundings (about 2^-22 of
//   |g||v|), so every ds would carry their difference, and with one key,
//   where ds is 0, dbias summed it over the heads and queries to 2.7e-5
//   (B = H = 8, 70 queries) against the 2e-5 that fp32 K5 is held to.
// - Launch 2, dk, dv and dbias over key tiles. Grid (ceil(Lk / 64), B*H), 4
//   warps of 16 keys; the block OWNS dk, dv and the per-head dbias slice of
//   its 64 keys. The warp's k and v rows are A fragments in registers (as
//   above, read again at D = 64). The queries stream in tiles of 64 through
//   a ring of three stages: q and g (rows D + 4 floats apart), each query's
//   m, 1 / l and Dq, and the tile's keep-bit records for the block's keys.
//   With the keys as the product's rows: s^T = k q^T and dP^T = v g^T, their
//   3xTF32 passes in the order that adds launch 1's terms in launch 1's
//   order (hi lo, lo hi, hi hi), P, keep and ds = P (dP keep - Dq), then
//   dv += (P keep)^T g and dk += ds^T q, 3xTF32 with fp32 sums; dbias sums
//   ds. Each sum is written once (dk times
//   `scale`; dbias in fp32 per head, [B, H, Lk], for the caller to sum over
//   heads).
// - Accuracy: each tile's share of dq and Dq (launch 1) and of dk and dv
//   (launch 2) is summed from zero in registers and joins the running sum once, in
//   fp32, as the forward adds each tile's P v (summed by the tensor cores
//   straight into the running sum over 2,000 terms, the forward had drifted
//   2-4x further from the plain version). A warp scores its tile's 64
//   columns in chunks (32 at D = 16 and 32, 16 at D = 64), so that the
//   scores, dP and their operands fit in registers beside what it holds.
// Keys past Lk are zero-filled, score -inf in launch 1 and carry a bias of
// -inf in launch 2, so their weights are 0, and are not written; queries
// past Lq are zero-filled with m = 1 / l = Dq = 0, so they weigh 0, and are
// not written. A row whose every real key carries finfo.min has m =
// finfo.min and weights 1 / l; a row whose every score is -inf has 1 / l = 0
// and gives zeros.

#include <cuda_runtime.h>

#include "attention_cluster.cuh"
#include "attention_many.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int NW = 4;          // warps per block, 16 rows each
constexpr int NTH = NW * 32;
constexpr int BR = NW * 16;    // rows per block: queries (launch 1) or keys (launch 2)
constexpr int TT = r3d::kManyKeyTile;   // keys (launch 1) or queries (launch 2) per tile
constexpr int NSTAGE = 3;      // tiles in a ring: two copies in flight under the math
static_assert(TT == r3d::kF32KT, "launch 1 copies its key tiles with f32_load_tile");
static_assert(BR == TT, "a block of launch 2 owns one key tile of the forward's keep bits");

// Whether a warp holds its 16 rows' A fragments (q and g, or k and v) in
// registers for the whole walk; at D = 64 they are read again where used.
template <int D>
constexpr bool kHoldA = D <= 32;
// n-tiles of 8 columns a warp scores at once.
template <int D>
constexpr int kChunk = D >= 64 ? 2 : 4;
// D = 16 (every real path) three blocks an SM, at most 168 registers; 32 and
// 64 two (their rings, and at 32 the fragments held).
template <int D>
constexpr int kMinBlocks = D == 16 ? 3 : 2;
// Launch 2's stage, in floats: q and g tiles, each query's m, 1 / l and Dq,
// and the keep-bit records of the tile's 4 blocks of 16 queries.
template <int D>
constexpr int kQueryStage = 2 * TT * r3d::kF32Ld<D> + 3 * TT + 4 * 32;

// c1[n] += a1 b1[n] and c2[n] += a2 b2[n], each to about fp32's accuracy
// from the TF32 parts, in mma_3xtf32's order (lo hi, hi lo, hi hi; with
// kSwapped hi lo, lo hi, hi hi: the same terms in the same order when the
// operands trade places), each pass sweeping both products: 2N
// accumulators in flight.
template <int N, bool kSwapped = false>
__device__ __forceinline__ void mma_3xtf32_pair(
    float (&c1)[N][4], const uint32_t (&a1h)[4], const uint32_t (&a1l)[4],
    const uint32_t (&b1h)[N][2], const uint32_t (&b1l)[N][2], float (&c2)[N][4],
    const uint32_t (&a2h)[4], const uint32_t (&a2l)[4], const uint32_t (&b2h)[N][2],
    const uint32_t (&b2l)[N][2]) {
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const bool lo_a = (pass == 0) != kSwapped;   // this pass: lo_a hi_b, else hi_a lo_b
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (lo_a) {
        r3d::mma_tf32(c1[n], a1l, b1h[n][0], b1h[n][1]);
      } else {
        r3d::mma_tf32(c1[n], a1h, b1l[n][0], b1l[n][1]);
      }
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (lo_a) {
        r3d::mma_tf32(c2[n], a2l, b2h[n][0], b2h[n][1]);
      } else {
        r3d::mma_tf32(c2[n], a2h, b2l[n][0], b2l[n][1]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) r3d::mma_tf32(c1[n], a1h, b1h[n][0], b1h[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) r3d::mma_tf32(c2[n], a2h, b2h[n][0], b2h[n][1]);
}

// The A fragment, TF32 high and low parts, of rows r0 + g and r0 + g + 8,
// dims kk*8 + t and kk*8 + t + 4, of a row-major [L, D] fp32 matrix in
// device memory; rows past L read 0.
template <int D>
__device__ __forceinline__ void a_frag(const float* __restrict__ rows, int r0, int L, int kk,
                                       int g, int t, uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + g + (i & 1) * 8;
    const float x = row < L ? __ldg(rows + static_cast<size_t>(row) * D + kk * 8 + t + (i >> 1) * 4)
                            : 0.f;
    r3d::split_tf32(x, h[i], l[i]);
  }
}

// A C fragment's values (lane (g, t): columns 2t, 2t + 1 of rows g and
// g + 8) as the A fragment of a k-step whose columns run 0, 2, 4, 6, 1, 3,
// 5, 7: A column t is C column 2t, A column t + 4 is C column 2t + 1.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&h)[4], uint32_t (&l)[4]) {
  r3d::split_tf32(c[0], h[0], l[0]);   // (row g, column 2t)
  r3d::split_tf32(c[2], h[1], l[1]);   // (row g + 8, column 2t)
  r3d::split_tf32(c[1], h[2], l[2]);   // (row g, column 2t + 1)
  r3d::split_tf32(c[3], h[3], l[3]);   // (row g + 8, column 2t + 1)
}

// B = tile^T for the n-tiles n0 .. n0 + N - 1 of a shared-memory tile whose
// rows are the product's columns: (dim kk*8 + t or + 4, row (n0 + n)*8 + g).
template <int N, int LD>
__device__ __forceinline__ void b_cols(const float* tile, int n0, int kk, int g, int t,
                                       uint32_t (&h)[N][2], uint32_t (&l)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float* p = tile + ((n0 + n) * 8 + g) * LD + kk * 8 + t;
    r3d::split_tf32(p[0], h[n][0], l[n][0]);
    r3d::split_tf32(p[4], h[n][1], l[n][1]);
  }
}

// B = tile over the k-step of rows r0 .. r0 + 7 taken as c_to_a orders
// them, for every n-tile of D: (row r0 + 2t or r0 + 2t + 1, dim nt*8 + g).
template <int NT, int LD>
__device__ __forceinline__ void b_rows(const float* tile, int r0, int g, int t,
                                       uint32_t (&h)[NT][2], uint32_t (&l)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float* p = tile + (r0 + 2 * t) * LD + nt * 8 + g;
    r3d::split_tf32(p[0], h[nt][0], l[nt][0]);
    r3d::split_tf32(p[LD], h[nt][1], l[nt][1]);
  }
}

// Launch 1: Dq and dq of 64 queries.
template <int D, bool kDropout>
__global__ void __launch_bounds__(NTH, kMinBlocks<D>)
attention_bwd_many_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ bias,
                                 const float* __restrict__ g, const float* __restrict__ stats,
                                 const uint32_t* __restrict__ keep_bits,
                                 float* __restrict__ delta, float* __restrict__ dq, int H,
                                 int Lq, int Lk, float scale, float keep_scale) {
  constexpr int KS = D / 8;    // k-steps of q k^T and g v^T
  constexpr int NT = D / 8;    // n-tiles of dq
  constexpr int ST = TT / 8;   // n-tiles of the scores, k-steps of u k and P k
  constexpr int CN = kChunk<D>;
  constexpr int LD = r3d::kF32Ld<D>;
  constexpr int HA = kHoldA<D> ? KS : 1;
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * BR + warp * 16;   // this warp's first query
  const int bh = blockIdx.y;
  const int b = bh / H;
  const bool active = q0 < Lq;   // a warp wholly past Lq only helps copy
  const int ntiles = (Lk + TT - 1) / TT;
  const size_t BHL = static_cast<size_t>(gridDim.y) * Lq;
  const float* qb = q + static_cast<size_t>(bh) * Lq * D;
  const float* gb = g + static_cast<size_t>(bh) * Lq * D;
  const float* kb = k + static_cast<size_t>(bh) * Lk * D;
  const float* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;
  auto stage = [&](int tile) { return ring + (tile % NSTAGE) * r3d::kF32Stage<D>; };

#pragma unroll
  for (int tile = 0; tile < NSTAGE - 1; ++tile) {   // one commit group per tile
    if (tile < ntiles) {
      r3d::f32_load_tile<D, NTH>(stage(tile), kb, vb, biasb, tile * TT, Lk, D);
    } else {
      r3d::cp_async_commit();
    }
  }

  // the warp's rows: q and g as A fragments (rows past Lq: 0), m and 1 / l
  // (rows past Lq: 0, so they weigh 0)
  uint32_t qh[HA][4], ql[HA][4], gh[HA][4], gl[HA][4];
  if constexpr (kHoldA<D>) {
#pragma unroll
    for (int kk = 0; kk < HA; ++kk) {
      a_frag<D>(qb, q0, Lq, kk, gq, t, qh[kk], ql[kk]);
      a_frag<D>(gb, q0, Lq, kk, gq, t, gh[kk], gl[kk]);
    }
  }
  float mrow[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = q0 + gq + hi * 8;
    if (row < Lq) {
      mrow[hi] = stats[static_cast<size_t>(bh) * Lq + row];
      inv_l[hi] = stats[BHL + static_cast<size_t>(bh) * Lq + row];
    }
  }

  // sum u k, sum P k and this lane's share of Dq, over the key tiles
  float ua[NT][4], pa[NT][4], da[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ua[nt][i] = pa[nt][i] = 0.f;
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    // tile's copy has landed and every warp is done with tile - 1, whose
    // stage takes the copy of tile + NSTAGE - 1
    r3d::cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (tile + NSTAGE - 1 < ntiles) {
      r3d::f32_load_tile<D, NTH>(stage(tile + NSTAGE - 1), kb, vb, biasb,
                                 (tile + NSTAGE - 1) * TT, Lk, D);
    } else {
      r3d::cp_async_commit();
    }
    if (!active) continue;
    const int key0 = tile * TT;
    const float* ks = stage(tile);
    const float* vs = ks + TT * LD;
    const float* bt = ks + 2 * TT * LD;

    // the forward's keep bits of this lane's keys of its two rows
    const uint32_t kw =
        kDropout ? keep_bits[r3d::keep_record(bh, q0 >> 4, tile, (Lq + 15) >> 4, ntiles) + lane]
                 : 0u;
    float up[NT][4], pp[NT][4], dp_sum[2] = {0.f, 0.f};   // this tile's shares, from zero
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) up[nt][i] = pp[nt][i] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < ST / CN; ++c) {
      // scores and dP of 16 queries x 8*CN keys: [n][hi*2 + j] is row
      // gq + hi*8 and key (c*CN + n)*8 + 2t + j of the tile
      float s[CN][4], dp[CN][4];
#pragma unroll
      for (int n = 0; n < CN; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4], ch[4], cl[4];   // q and g of this k-step
        if constexpr (kHoldA<D>) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[kk][i];
            al[i] = ql[kk][i];
            ch[i] = gh[kk][i];
            cl[i] = gl[kk][i];
          }
        } else {
          a_frag<D>(qb, q0, Lq, kk, gq, t, ah, al);
          a_frag<D>(gb, q0, Lq, kk, gq, t, ch, cl);
        }
        uint32_t kh[CN][2], kl[CN][2], vh[CN][2], vl[CN][2];
        b_cols<CN, LD>(ks, c * CN, kk, gq, t, kh, kl);
        b_cols<CN, LD>(vs, c * CN, kk, gq, t, vh, vl);
        mma_3xtf32_pair<CN>(s, ah, al, kh, kl, dp, ch, cl, vh, vl);
      }
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        const int nt = c * CN + n;
        const float2 b2 = *reinterpret_cast<const float2*>(bt + nt * 8 + 2 * t);
        float p[4], u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hi = i >> 1;
          const bool real = key0 + nt * 8 + 2 * t + (i & 1) < Lk;
          const float sv = real ? fmaf(s[n][i], scale, (i & 1) ? b2.y : b2.x) : -INFINITY;
          p[i] = __expf(sv - mrow[hi]) * inv_l[hi];
          const float km = ((kw >> (hi * 16 + nt * 2 + (i & 1))) & 1u) ? keep_scale : 0.f;
          u[i] = p[i] * (kDropout ? dp[n][i] * km : dp[n][i]);
          dp_sum[hi] += u[i];
        }
        // u k and P k: this n-tile's 8 keys are one k-step
        uint32_t uh[4], ul[4], ph[4], pl[4], kh[NT][2], kl[NT][2];
        c_to_a(u, uh, ul);
        c_to_a(p, ph, pl);
        b_rows<NT, LD>(ks, nt * 8, gq, t, kh, kl);
        mma_3xtf32_pair<NT>(up, uh, ul, kh, kl, pp, ph, pl, kh, kl);
      }
    }
    // the running sums += this tile's shares, once, in fp32
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ua[nt][i] += up[nt][i];
        pa[nt][i] += pp[nt][i];
      }
    }
    da[0] += dp_sum[0];
    da[1] += dp_sum[1];
  }
  r3d::cp_async_wait<0>();   // no copy outlives the block (the last groups are empty)
  if (!active) return;
  // Dq of each row (its quad's lanes hold its keys), then dq = scale (sum u k
  // - Dq sum P k) = scale sum ds k, written once
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float dq_row = r3d::quad_sum(da[hi]);
    const int row = q0 + gq + hi * 8;
    if (row >= Lq) continue;
    if (t == 0) delta[static_cast<size_t>(bh) * Lq + row] = dq_row;
    float* o = dq + (static_cast<size_t>(bh) * Lq + row) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<float2*>(o + nt * 8) =
          make_float2(fmaf(-dq_row, pa[nt][hi * 2], ua[nt][hi * 2]) * scale,
                      fmaf(-dq_row, pa[nt][hi * 2 + 1], ua[nt][hi * 2 + 1]) * scale);
    }
  }
}

// Launch 2: dk, dv and dbias of 64 keys.
template <int D, bool kDropout>
__global__ void __launch_bounds__(NTH, kMinBlocks<D>)
attention_bwd_many_f32_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ bias,
                                   const float* __restrict__ g, const float* __restrict__ stats,
                                   const uint32_t* __restrict__ keep_bits,
                                   const float* __restrict__ delta, float* __restrict__ dk,
                                   float* __restrict__ dv, float* __restrict__ dbias, int H,
                                   int Lq, int Lk, float scale, float keep_scale) {
  constexpr int C4 = D / 4;    // 16-byte chunks of a row
  constexpr int KS = D / 8;    // k-steps of k q^T and v g^T
  constexpr int NT = D / 8;    // n-tiles of dk and dv
  constexpr int ST = TT / 8;   // n-tiles of the scores, k-steps of the dk and dv products
  constexpr int CN = kChunk<D>;
  constexpr int LD = r3d::kF32Ld<D>;
  constexpr int HA = kHoldA<D> ? KS : 1;
  extern __shared__ __align__(16) float ring[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int kw0 = blockIdx.x * BR + warp * 16;   // this warp's first key
  const int bh = blockIdx.y;
  const int b = bh / H;
  const bool active = kw0 < Lk;
  const int ntiles = (Lq + TT - 1) / TT;
  const size_t BHL = static_cast<size_t>(gridDim.y) * Lq;
  const float* qb = q + static_cast<size_t>(bh) * Lq * D;
  const float* gb = g + static_cast<size_t>(bh) * Lq * D;
  const float* kb = k + static_cast<size_t>(bh) * Lk * D;
  const float* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* mb = stats + static_cast<size_t>(bh) * Lq;
  const float* ilb = stats + BHL + static_cast<size_t>(bh) * Lq;
  const float* db = delta + static_cast<size_t>(bh) * Lq;

  auto stage = [&](int tile) { return ring + (tile % NSTAGE) * kQueryStage<D>; };
  const int nkt = (Lk + TT - 1) / TT;   // key tiles of a record's rows
  const int n_rb = (Lq + 15) >> 4;      // blocks of 16 query rows
  // query tile `tile` into its stage; queries past Lq read as zeros
  auto copy_tile = [&](int tile) {
    const int qt0 = tile * TT;
    float* qs = stage(tile);
    float* gs = qs + TT * LD;
    float* f = gs + TT * LD;   // m, 1 / l, Dq: three runs of TT floats
    for (int idx = tid; idx < TT * C4; idx += NTH) {
      const int r = idx / C4;
      const int c = idx % C4;
      const bool ok = qt0 + r < Lq;
      const size_t off = static_cast<size_t>(ok ? qt0 + r : 0) * D + c * 4;
      r3d::cp_async16(qs + r * LD + c * 4, qb + off, ok);
      r3d::cp_async16(gs + r * LD + c * 4, gb + off, ok);
    }
    if (tid < TT) {
      const bool ok = qt0 + tid < Lq;
      const int i = ok ? qt0 + tid : 0;
      r3d::cp_async4(f + tid, mb + i, ok);
      r3d::cp_async4(f + TT + tid, ilb + i, ok);
      r3d::cp_async4(f + 2 * TT + tid, db + i, ok);
    }
    if (kDropout && tid < 32) {   // 16 bytes each: 4 records of 128
      const int rb = (qt0 >> 4) + (tid >> 3);
      const bool ok = rb < n_rb;
      r3d::cp_async16(f + 3 * TT + 4 * tid,
                      keep_bits + (ok ? r3d::keep_record(bh, rb, blockIdx.x, n_rb, nkt) : 0) +
                          4 * (tid & 7),
                      ok);
    }
  };
#pragma unroll
  for (int tile = 0; tile < NSTAGE - 1; ++tile) {
    if (tile < ntiles) copy_tile(tile);
    r3d::cp_async_commit();
  }

  // the warp's keys: k and v as A fragments (keys past Lk: 0)
  uint32_t kh[HA][4], kl[HA][4], vh[HA][4], vl[HA][4];
  if constexpr (kHoldA<D>) {
#pragma unroll
    for (int kk = 0; kk < HA; ++kk) {
      a_frag<D>(kb, kw0, Lk, kk, gq, t, kh[kk], kl[kk]);
      a_frag<D>(vb, kw0, Lk, kk, gq, t, vh[kk], vl[kk]);
    }
  }
  // this thread's keys: hi = 0, 1 is key kw0 + gq + hi*8. Where the
  // forward's keep bits hold them: the lane t' = (key % 8) / 2 of a record's
  // row, bit (key / 8)*2 + key % 2 (keys of the block's tile)
  const int kword = gq >> 1;
  int kbit[2];
  float bk[2];   // the key's bias; -inf past Lk, so its weights are 0
  bool kok[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int key = kw0 + gq + hi * 8;
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
  float dba[2] = {0.f, 0.f};   // ds summed over this thread's queries

  for (int tile = 0; tile < ntiles; ++tile) {
    r3d::cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (tile + NSTAGE - 1 < ntiles) copy_tile(tile + NSTAGE - 1);
    r3d::cp_async_commit();
    if (!active) continue;
    const float* qs = stage(tile);
    const float* gs = qs + TT * LD;
    const float* ms = gs + TT * LD;
    const float* ils = ms + TT;
    const float* dls = ms + 2 * TT;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(ms + 3 * TT);

    float dkp[NT][4], dvp[NT][4];   // this tile's dk and dv, from zero
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) dkp[nt][i] = dvp[nt][i] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < ST / CN; ++c) {
      // s^T = k q^T and dP^T = v g^T: 16 keys x 8*CN queries; [n][hi*2 + j]
      // is key gq + hi*8 of the warp and query (c*CN + n)*8 + 2t + j of the tile
      float s[CN][4], dp[CN][4];
#pragma unroll
      for (int n = 0; n < CN; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[4], al[4], ch[4], cl[4];   // k and v of this k-step
        if constexpr (kHoldA<D>) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = kh[kk][i];
            al[i] = kl[kk][i];
            ch[i] = vh[kk][i];
            cl[i] = vl[kk][i];
          }
        } else {
          a_frag<D>(kb, kw0, Lk, kk, gq, t, ah, al);
          a_frag<D>(vb, kw0, Lk, kk, gq, t, ch, cl);
        }
        uint32_t qbh[CN][2], qbl[CN][2], gbh[CN][2], gbl[CN][2];
        b_cols<CN, LD>(qs, c * CN, kk, gq, t, qbh, qbl);
        b_cols<CN, LD>(gs, c * CN, kk, gq, t, gbh, gbl);
        mma_3xtf32_pair<CN, true>(s, ah, al, qbh, qbl, dp, ch, cl, gbh, gbl);
      }
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        const int nt = c * CN + n;
        const int c0 = nt * 8 + 2 * t;
        const float2 m2 = *reinterpret_cast<const float2*>(ms + c0);
        const float2 il2 = *reinterpret_cast<const float2*>(ils + c0);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + c0);
        float pk[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hi = i >> 1;
          const bool odd = i & 1;
          const float sv = fmaf(s[n][i], scale, bk[hi]);
          const float p = __expf(sv - (odd ? m2.y : m2.x)) * (odd ? il2.y : il2.x);
          // query c0 + odd of the tile: block nt / 2, row (nt & 1)*8 + 2t + odd
          const float km =
              !kDropout ? 1.f
                        : ((bits[(nt >> 1) * 32 + (2 * t + odd) * 4 + kword] >>
                            (kbit[hi] + (nt & 1) * 16)) & 1u) ? keep_scale : 0.f;
          pk[i] = p * km;
          ds[i] = p * (dp[n][i] * km - (odd ? d2.y : d2.x));
          dba[hi] += ds[i];
        }
        // dv += (P keep)^T g and dk += ds^T q: this n-tile's 8 queries are one k-step
        uint32_t ph[4], pl[4], dh[4], dl[4];
        c_to_a(pk, ph, pl);
        c_to_a(ds, dh, dl);
        uint32_t gbh[NT][2], gbl[NT][2], qbh[NT][2], qbl[NT][2];
        b_rows<NT, LD>(gs, nt * 8, gq, t, gbh, gbl);
        b_rows<NT, LD>(qs, nt * 8, gq, t, qbh, qbl);
        mma_3xtf32_pair<NT>(dvp, ph, pl, gbh, gbl, dkp, dh, dl, qbh, qbl);
      }
    }
    // dk and dv += this tile's shares, once, in fp32
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dka[nt][i] += dkp[nt][i];
        dva[nt][i] += dvp[nt][i];
      }
    }
  }
  r3d::cp_async_wait<0>();
  if (!active) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float sum = r3d::quad_sum(dba[hi]);
    const int key = kw0 + gq + hi * 8;
    if (!kok[hi]) continue;
    if (dbias != nullptr && t == 0) dbias[static_cast<size_t>(bh) * Lk + key] = sum;
    const size_t off = (static_cast<size_t>(bh) * Lk + key) * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<float2*>(dk + off + nt * 8) =
          make_float2(dka[nt][hi * 2] * scale, dka[nt][hi * 2 + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + nt * 8) =
          make_float2(dva[nt][hi * 2], dva[nt][hi * 2 + 1]);
    }
  }
}

template <int D, bool kDropout>
int launch(const float* q, const float* k, const float* v, const float* bias, const float* g,
           const float* stats, const uint32_t* keep_bits, float* delta, float* dq, float* dk,
           float* dv, float* dbias, int B, int H, int Lq, int Lk, float scale, float keep_scale,
           cudaStream_t stream) {
  constexpr size_t smem_dq = NSTAGE * r3d::kF32Stage<D> * sizeof(float);
  constexpr size_t smem_kv = NSTAGE * kQueryStage<D> * sizeof(float);
  const auto dq_kernel = attention_bwd_many_f32_dq_kernel<D, kDropout>;
  const auto kv_kernel = attention_bwd_many_f32_dkdv_kernel<D, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_dq));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<<<dim3((Lq + BR - 1) / BR, B * H), NTH, smem_dq, stream>>>(
      q, k, v, bias, g, stats, keep_bits, delta, dq, H, Lq, Lk, scale, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kernel<<<dim3((Lk + BR - 1) / BR, B * H), NTH, smem_kv, stream>>>(
      q, k, v, bias, g, stats, keep_bits, delta, dk, dv, dbias, H, Lq, Lk, scale, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDropout>
int dispatch(const float* q, const float* k, const float* v, const float* bias, const float* g,
             const float* stats, const uint32_t* keep_bits, float* delta, float* dq, float* dk,
             float* dv, float* dbias, int B, int H, int Lq, int Lk, int D, float scale,
             float keep_scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<16, kDropout>(q, k, v, bias, g, stats, keep_bits, delta, dq, dk, dv,
                                  dbias, B, H, Lq, Lk, scale, keep_scale, s);
    case 32:
      return launch<32, kDropout>(q, k, v, bias, g, stats, keep_bits, delta, dq, dk, dv,
                                  dbias, B, H, Lq, Lk, scale, keep_scale, s);
    case 64:
      return launch<64, kDropout>(q, k, v, bias, g, stats, keep_bits, delta, dq, dk, dv,
                                  dbias, B, H, Lq, Lk, scale, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g, dq [B, H, Lq, D] and k, v, dk, dv [B, H, Lk, D], all fp32,
// contiguous and 16-byte aligned; bias [B, Lk] fp32 or null; from the
// forward of the same call (r3d_attention_fwd_many_f32 with stats, or its
// dropout twin at the same seed and rate): stats [2, B*H, Lq] fp32 (m and
// 1 / l) and, with `dropout`, keep_bits (uint32 [B*H, ceil(Lq / 16),
// ceil(Lk / 64), 32], attention_many.cuh); delta [B*H, Lq] fp32, written
// here (Dq); dbias [B, H, Lk] fp32 or null (per-head sums, for the caller to
// sum over heads). D must be 16, 32 or 64 and B*H at most 65,535. Every
// output is written; nothing needs to be zeroed.
extern "C" int r3d_attention_bwd_many_f32(const float* q, const float* k, const float* v,
                                          const float* bias, const float* g, const float* stats,
                                          const uint32_t* keep_bits, float* delta, float* dq,
                                          float* dk, float* dv, float* dbias, int B, int H,
                                          int Lq, int Lk, int D, float scale, int dropout,
                                          float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B * H > 65535 || stats == nullptr ||
      delta == nullptr || (dropout && keep_bits == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch<true>(q, k, v, bias, g, stats, keep_bits, delta, dq, dk, dv, dbias, B,
                                  H, Lq, Lk, D, scale, keep_scale, s)
                 : dispatch<false>(q, k, v, bias, g, stats, keep_bits, delta, dq, dk, dv, dbias,
                                   B, H, Lq, Lk, D, scale, keep_scale, s);
}
