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
// fp32 (utkinects: B = H = 8, Lq = 8, Lk = 256 or 512, D = 16; every train
// step) has the cluster body of attention_bwd_cluster.cuh (see its note),
// shared with fp32 K7 (cross_attention_bwd.cu): one launch, the keys of a
// (batch, head) split into runs of whole 64-key tiles, one block each, the
// blocks one thread-block cluster that combines each query's (m, l, D) in
// rank order before any gradient; each block owns dk, dv and dbias of its
// keys, and the blocks' dq are summed in rank order.
//
// bf16 (the 50salads decoder: Lq = 20, Lk = 256 or 512, D = 64; 17 MB in and
// out at B = H = 8, Lk = 512) is a design of its own, in three launches that
// split the KEYS across blocks, since the queries are few:
// - Statistics kernel, grid (B*H, ceil(Lk / 64)), 4 warps of 16 keys each.
//   The block copies q, g (32 queries at a time) and its 64 keys of K and V
//   as bf16 into swizzled shared-memory tiles with 16-byte cp.async, forms
//   S = q k^T and g v^T on the tensor cores (mma.sync m16n8k16: bf16
//   operands and fp32 sums are what the TPU kernel's two bf16 products are),
//   and leaves per (key block, query) the block's max m_i, sum l_i of
//   exp(s - m_i) and D-numerator sum exp(s - m_i) keep (g . v) in an fp32
//   scratch [3, n_kblocks, B*H, Lq].
// - Main kernel, the same grid. The block recomputes S and g v^T of its keys,
//   combines the statistics of every key block in block order into each
//   query's m, l and D, and forms w*keep and ds in fp32 in shared memory.
//   dv = (w keep)^T g, dk = ds^T q and this block's share of dq = ds k keep
//   fp32 w and ds as the TPU kernel does: plain fp32 FMAs from shared memory
//   (0.4 GFLOP in all). The block OWNS dk, dv and dbias of its keys: it sums
//   them in registers over the query tiles and writes them once, rounded to
//   bf16 once (no memset, no read-modify-write, no cast afterwards). Its
//   share of dq goes to its own slice of an fp32 scratch
//   [n_kblocks, B*H, Lq, D].
// - Sum kernel: dq = the slices summed in key-block order, rounded to bf16.
// Deterministic, no atomics. Keys past Lk are zero-filled and score -inf,
// queries past Lq weigh nothing, a row whose every score is -inf gives zero.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "attention_bwd_cluster.cuh"
#include "mma_bf16.cuh"

namespace {

// ---- the bf16 body ----

using bf16 = __nv_bfloat16;

constexpr int KB = 64;          // keys per block (ops/attention.py: BWD_BLOCK_KEYS)
constexpr int QT = 32;          // queries per tile: two m16 tiles
constexpr int NW = 4;           // warps per block, 16 keys each
constexpr int NTH = NW * 32;
constexpr int LDW = KB + 8;     // row stride of w*keep and ds in shared memory

// One query tile's q and g and (once per block) the block's keys of K and V
// into swizzled tiles; rows past the end are zero-filled.
template <int D>
__device__ __forceinline__ void copy_rows(bf16* tile, const bf16* src, int rows, int n_real) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NTH) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool ok = r < n_real;
    r3d::cp_async16(r3d::tile_ptr<D>(tile, r, c), src + static_cast<size_t>(ok ? r : 0) * D + c * 8,
                    ok);
  }
}

// Scores s = q k^T * scale + bias, gv = g v^T and the dropout keep factor of
// this warp's 16 keys (block keys warp*16 .. +15) against the tile's 32
// queries, as mma C fragments: [m-tile][n-tile][4]. Keys past Lk score -inf.
template <int D, bool kDropout>
__device__ __forceinline__ void warp_scores(const bf16* qs, const bf16* gs, const bf16* ks,
                                            const bf16* vs, const float* bs, int j0, int q0, int bh,
                                            int Lq, int Lk, float scale, uint32_t seed,
                                            uint32_t threshold, float keep_scale,
                                            float (&s)[2][2][4], float (&gv)[2][2][4],
                                            float (&km)[2][2][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[mt][nt][i] = 0.f;
        gv[mt][nt][i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t kf[4], vf[4];
    r3d::load_b_frag<D>(kf, ks, warp * 16, kk, lane);
    r3d::load_b_frag<D>(vf, vs, warp * 16, kk, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t qf[4], gf[4];
      r3d::load_a_frag<D>(qf, qs, mt, kk, lane);
      r3d::load_a_frag<D>(gf, gs, mt, kk, lane);
      r3d::mma_bf16(s[mt][0], qf, kf[0], kf[1]);
      r3d::mma_bf16(s[mt][1], qf, kf[2], kf[3]);
      r3d::mma_bf16(gv[mt][0], gf, vf[0], vf[1]);
      r3d::mma_bf16(gv[mt][1], gf, vf[2], vf[3]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = warp * 16 + nt * 8 + 2 * t + (i & 1);
        const int key = j0 + kl;
        s[mt][nt][i] = key < Lk ? s[mt][nt][i] * scale + bs[kl] : -INFINITY;
        km[mt][nt][i] = 1.f;
        if (kDropout) {
          const uint32_t qi = q0 + mt * 16 + g + (i >> 1) * 8;
          const uint32_t el = (static_cast<uint32_t>(bh) * Lq + qi) * Lk + key;
          km[mt][nt][i] = r3d::dropout_bits(seed, el) >= threshold ? keep_scale : 0.f;
        }
      }
    }
  }
}

// kMain false: the statistics kernel; true: the main kernel (see the header).
// stats [3, n_kblocks, B*H, Lq]: m_i, l_i and the D-numerator per key block.
template <int D, bool kDropout, bool kMain>
__global__ void __launch_bounds__(NTH, 4)   // 4 blocks an SM: 512 blocks at Lk = 512 are one wave
attention_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const float* __restrict__ bias,
                          const bf16* __restrict__ g, float* __restrict__ stats,
                          float* __restrict__ dq_part, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, float* __restrict__ dbias, int H, int Lq, int Lk,
                          float scale, uint32_t seed, uint32_t threshold, float keep_scale) {
  constexpr int DP = D / 2;              // pairs of dims
  constexpr int KPT = KB * DP / NTH;     // keys per thread in the dk, dv sums
  constexpr int QPT = QT * DP / NTH;     // queries per thread in the dq sum
  static_assert(KPT % 4 == 0 && LDW % 4 == 0, "w*keep and ds are read as float4");
  __shared__ __align__(128) bf16 qs[QT * D];
  __shared__ __align__(128) bf16 gs[QT * D];
  __shared__ __align__(128) bf16 ks[KB * D];
  __shared__ __align__(128) bf16 vs[KB * D];
  __shared__ __align__(16) float wk[kMain ? QT * LDW : 1];    // w * keep
  __shared__ __align__(16) float dsm[kMain ? QT * LDW : 1];   // ds (before the scale)
  __shared__ float bs[KB];
  __shared__ float red[3][NW][QT];   // the warps' statistics (statistics kernel)
  __shared__ float st[3][QT];        // each query's m, 1 / l and D (main kernel)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int BH = gridDim.x;
  const int kb = blockIdx.y;
  const int nkb = gridDim.y;
  const int b = bh / H;
  const int j0 = kb * KB;
  const int nk = min(KB, Lk - j0);
  const size_t kv0 = (static_cast<size_t>(bh) * Lk + j0) * D;
  const size_t srows = static_cast<size_t>(nkb) * BH * Lq;   // rows of one statistic

  copy_rows<D>(ks, k + kv0, KB, nk);
  copy_rows<D>(vs, v + kv0, KB, nk);
  if (tid < KB) {
    bs[tid] = (tid < nk && bias != nullptr) ? bias[static_cast<size_t>(b) * Lk + j0 + tid] : 0.f;
  }

  // the main kernel's sums over the query tiles
  const int dp = tid % DP;
  const int grp = tid / DP;   // key group (dk, dv) and query group (dq)
  float dk_acc[KPT][2], dv_acc[KPT][2];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dv_acc[i][0] = dv_acc[i][1] = 0.f;
  }
  float db_acc = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += QT) {
    const int nq = min(QT, Lq - q0);
    __syncthreads();   // the previous tile is done with qs, gs, wk, dsm, red and st
    const size_t qoff = (static_cast<size_t>(bh) * Lq + q0) * D;
    copy_rows<D>(qs, q + qoff, QT, nq);
    copy_rows<D>(gs, g + qoff, QT, nq);
    r3d::cp_async_commit();
    if (kMain && tid < QT) {
      // every key block's statistics, in block order
      float m = -INFINITY, l = 0.f, dn = 0.f;
      if (tid < nq) {
        const float* sm = stats + static_cast<size_t>(bh) * Lq + q0 + tid;
        const size_t step = static_cast<size_t>(BH) * Lq;
        for (int i = 0; i < nkb; ++i) m = fmaxf(m, sm[i * step]);
        for (int i = 0; i < nkb; ++i) {
          const float mi = sm[i * step];
          const float w = mi == -INFINITY ? 0.f : expf(mi - m);
          l = fmaf(sm[srows + i * step], w, l);
          dn = fmaf(sm[2 * srows + i * step], w, dn);
        }
      }
      const float inv_l = l > 0.f ? 1.f / l : 0.f;
      st[0][tid] = m;
      st[1][tid] = inv_l;
      st[2][tid] = dn * inv_l;
    }
    r3d::cp_async_wait<0>();
    __syncthreads();

    float s[2][2][4], gv[2][2][4], km[2][2][4];
    warp_scores<D, kDropout>(qs, gs, ks, vs, bs, j0, q0, bh, Lq, Lk, scale, seed, threshold,
                             keep_scale, s, gv, km);

    if constexpr (!kMain) {
      // this warp's 16 keys: max, sum and D-numerator of each of its rows
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const int mt = ri >> 1;
        const int hi = ri & 1;
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mx = fmaxf(mx, fmaxf(s[mt][nt][hi * 2], s[mt][nt][hi * 2 + 1]));
        }
        mx = r3d::quad_max(mx);
        float l = 0.f, dn = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float sv = s[mt][nt][hi * 2 + j];
            const float p = sv == -INFINITY ? 0.f : expf(sv - mx);
            l += p;
            dn = fmaf(p * km[mt][nt][hi * 2 + j], gv[mt][nt][hi * 2 + j], dn);
          }
        }
        l = r3d::quad_sum(l);
        dn = r3d::quad_sum(dn);
        if (t == 0) {
          const int row = mt * 16 + gq + hi * 8;
          red[0][warp][row] = mx;
          red[1][warp][row] = l;
          red[2][warp][row] = dn;
        }
      }
      __syncthreads();
      if (tid < nq) {   // the four warps in warp order
        float m = red[0][0][tid];
#pragma unroll
        for (int w = 1; w < NW; ++w) m = fmaxf(m, red[0][w][tid]);
        float l = 0.f, dn = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float mw = red[0][w][tid];
          const float wgt = mw == -INFINITY ? 0.f : expf(mw - m);
          l = fmaf(red[1][w][tid], wgt, l);
          dn = fmaf(red[2][w][tid], wgt, dn);
        }
        const size_t row = (static_cast<size_t>(kb) * BH + bh) * Lq + q0 + tid;
        stats[row] = m;
        stats[srows + row] = l;
        stats[2 * srows + row] = dn;
      }
    } else {
      // w * keep and ds of 32 queries x this warp's 16 keys into shared memory
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = mt * 16 + gq + hi * 8;
          const bool row_ok = row < nq;
          const float m = st[0][row];
          const float inv_l = st[1][row];
          const float drow = st[2][row];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float wkv[2], dsv[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float sv = s[mt][nt][hi * 2 + j];
              const float w = (row_ok && sv != -INFINITY) ? expf(sv - m) * inv_l : 0.f;
              const float kmv = km[mt][nt][hi * 2 + j];
              wkv[j] = w * kmv;
              dsv[j] = w * (kmv * gv[mt][nt][hi * 2 + j] - drow);
            }
            const int col = warp * 16 + nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(&wk[row * LDW + col]) = make_float2(wkv[0], wkv[1]);
            *reinterpret_cast<float2*>(&dsm[row * LDW + col]) = make_float2(dsv[0], dsv[1]);
          }
        }
      }
      __syncthreads();

      // dk, dv of this block's keys: sums over the tile's queries, in fp32;
      // w*keep and ds are read four keys at a time (KPT, LDW are multiples of 4)
      for (int qq = 0; qq < nq; ++qq) {
        const float2 g2 = r3d::tile_pair<D>(gs, qq, dp);
        const float2 q2 = r3d::tile_pair<D>(qs, qq, dp);
#pragma unroll
        for (int i = 0; i < KPT; i += 4) {
          const float4 a4 = *reinterpret_cast<const float4*>(&wk[qq * LDW + grp * KPT + i]);
          const float4 c4 = *reinterpret_cast<const float4*>(&dsm[qq * LDW + grp * KPT + i]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dv_acc[i + u][0] = fmaf(a[u], g2.x, dv_acc[i + u][0]);
            dv_acc[i + u][1] = fmaf(a[u], g2.y, dv_acc[i + u][1]);
            dk_acc[i + u][0] = fmaf(c[u], q2.x, dk_acc[i + u][0]);
            dk_acc[i + u][1] = fmaf(c[u], q2.y, dk_acc[i + u][1]);
          }
        }
      }
      if (dbias != nullptr && tid < nk) {
        for (int qq = 0; qq < nq; ++qq) db_acc += dsm[qq * LDW + tid];
      }
      // this block's share of dq, four keys at a time (keys past nk: ds = 0
      // and K is zero-filled)
      float dq_acc[QPT][2];
#pragma unroll
      for (int i = 0; i < QPT; ++i) dq_acc[i][0] = dq_acc[i][1] = 0.f;
      for (int j = 0; j < nk; j += 4) {
        float2 k2[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) k2[u] = r3d::tile_pair<D>(ks, j + u, dp);
#pragma unroll
        for (int i = 0; i < QPT; ++i) {
          const float4 c4 = *reinterpret_cast<const float4*>(&dsm[(grp * QPT + i) * LDW + j]);
          const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dq_acc[i][0] = fmaf(c[u], k2[u].x, dq_acc[i][0]);
            dq_acc[i][1] = fmaf(c[u], k2[u].y, dq_acc[i][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qq = grp * QPT + i;
        if (qq < nq) {
          float* o = dq_part + ((static_cast<size_t>(kb) * BH + bh) * Lq + q0 + qq) * D + 2 * dp;
          *reinterpret_cast<float2*>(o) = make_float2(dq_acc[i][0] * scale, dq_acc[i][1] * scale);
        }
      }
    }
  }

  if (kMain) {
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = grp * KPT + i;
      if (j < nk) {
        const size_t off = kv0 + static_cast<size_t>(j) * D + 2 * dp;
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(dv_acc[i][0], dv_acc[i][1]);
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(dk_acc[i][0] * scale, dk_acc[i][1] * scale);
      }
    }
    if (dbias != nullptr && tid < nk) dbias[static_cast<size_t>(bh) * Lk + j0 + tid] = db_acc;
  }
}

// dq[i] = sum over key blocks, in block order, of dq_part[blk, i].
__global__ void dq_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dq, int n_blocks,
                              size_t n) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = 0.f;
    for (int blk = 0; blk < n_blocks; ++blk) a += part[static_cast<size_t>(blk) * n + i];
    dq[i] = __float2bfloat16_rn(a);
  }
}

template <int D, bool kDropout>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias, const bf16* g,
                bf16* dq, bf16* dk, bf16* dv, float* dbias, float* stats, float* dq_part, int B,
                int H, int Lq, int Lk, int nkb, float scale, uint32_t seed, uint32_t threshold,
                float keep_scale, cudaStream_t stream) {
  const dim3 grid(B * H, nkb);
  attention_bwd_bf16_kernel<D, kDropout, false><<<grid, NTH, 0, stream>>>(
      q, k, v, bias, g, stats, nullptr, nullptr, nullptr, nullptr, H, Lq, Lk, scale, seed,
      threshold, keep_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_bf16_kernel<D, kDropout, true><<<grid, NTH, 0, stream>>>(
      q, k, v, bias, g, stats, dq_part, dk, dv, dbias, H, Lq, Lk, scale, seed, threshold,
      keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(B) * H * Lq * D;
  const size_t want = (n + 255) / 256;
  dq_sum_kernel<<<static_cast<int>(want < 1024 ? want : 1024), 256, 0, stream>>>(dq_part, dq, nkb,
                                                                                 n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDropout>
int dispatch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias, const bf16* g,
                  bf16* dq, bf16* dk, bf16* dv, float* dbias, float* stats, float* dq_part, int B,
                  int H, int Lq, int Lk, int D, int nkb, float scale, uint32_t seed,
                  uint32_t threshold, float keep_scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_bf16<16, kDropout>(q, k, v, bias, g, dq, dk, dv, dbias, stats, dq_part, B, H,
                                       Lq, Lk, nkb, scale, seed, threshold, keep_scale, s);
    case 32:
      return launch_bf16<32, kDropout>(q, k, v, bias, g, dq, dk, dv, dbias, stats, dq_part, B, H,
                                       Lq, Lk, nkb, scale, seed, threshold, keep_scale, s);
    case 64:
      return launch_bf16<64, kDropout>(q, k, v, bias, g, dq, dk, dv, dbias, stats, dq_part, B, H,
                                       Lq, Lk, nkb, scale, seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, g, dq [B, H, Lq, D]; k, v, dk, dv [B, H, Lk, D]; bias [B, Lk] or null;
// dbias [B, H, Lk] or null (per-head sums of ds, for the caller to sum over
// heads). All fp32, contiguous and 16-byte aligned; D must be 16, 32 or 64,
// and `split_keys` the keys of one block (a multiple of 64 with at most 8
// splits: ops/attention.py:fp32_split_keys). Every output is written by the
// kernel; nothing needs to be zeroed. With `dropout`, the keep mask is drawn
// as r3d_attention_fwd_dropout draws it.
extern "C" int r3d_attention_bwd(const float* q, const float* k, const float* v,
                                 const float* bias, const float* g, float* dq, float* dk,
                                 float* dv, float* dbias, int B, int H, int Lq, int Lk, int D,
                                 int split_keys, float scale, int dropout, uint32_t seed,
                                 uint32_t threshold, float keep_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? r3d::bwd_cluster_dispatch<true, false>(
                       q, k, v, bias, g, nullptr, nullptr, nullptr, dq, dk, dv, dbias, B, H, Lq,
                       Lk, D, split_keys, scale, seed, threshold, keep_scale, s)
                 : r3d::bwd_cluster_dispatch<false, false>(
                       q, k, v, bias, g, nullptr, nullptr, nullptr, dq, dk, dv, dbias, B, H, Lq,
                       Lk, D, split_keys, scale, seed, threshold, keep_scale, s);
}

// How many clusters of r3d_attention_bwd's fp32 launch at these sizes the
// card holds at once (cudaOccupancyMaxActiveClusters); launches nothing.
extern "C" int r3d_attention_bwd_clusters(int B, int H, int Lk, int D, int split_keys, int dropout,
                                          int* clusters) {
  return r3d::bwd_cluster_occupancy<false>(B, H, Lk, D, split_keys, dropout, clusters);
}

// bf16 q, k, v, g (16-byte aligned) and dq, dk, dv, laid out as above; bias
// and dbias fp32. `stats` is an fp32 scratch of 3 * n_kblocks * B*H*Lq values
// and `dq_part` one of n_kblocks * B*H*Lq*D, with n_kblocks = ceil(Lk / 64).
// dk and dv are written once, in bf16; nothing needs to be zeroed.
extern "C" int r3d_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, const float* bias,
                                      const __nv_bfloat16* g, __nv_bfloat16* dq,
                                      __nv_bfloat16* dk, __nv_bfloat16* dv, float* dbias,
                                      float* stats, float* dq_part, int B, int H, int Lq, int Lk,
                                      int D, int n_kblocks, float scale, int dropout,
                                      uint32_t seed, uint32_t threshold, float keep_scale,
                                      void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || n_kblocks != (Lk + KB - 1) / KB ||
      stats == nullptr || dq_part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dropout ? dispatch_bf16<true>(q, k, v, bias, g, dq, dk, dv, dbias, stats, dq_part, B, H,
                                       Lq, Lk, D, n_kblocks, scale, seed, threshold, keep_scale, s)
                 : dispatch_bf16<false>(q, k, v, bias, g, dq, dk, dv, dbias, stats, dq_part, B, H,
                                        Lq, Lk, D, n_kblocks, scale, seed, threshold, keep_scale,
                                        s);
}
