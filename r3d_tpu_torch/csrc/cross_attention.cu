// Native-layout cross-attention forward: out = softmax(q k^T * scale + bias) v
// per head, with q [B, Lq, C] and k, v [B, S, C] in their projection layout
// (C = H * D, head h in columns [h*D, (h+1)*D)), fp32 online softmax,
// optional dropout on the weights, and the softmax statistics m (row max of
// the scores) and l (sum of exp(score - m)) [B, H, Lq] for the backward.
//
// Replaces the Pallas kernel r3d_tpu/ops/cross_attention.py:50 `_fwd_kernel`
// (launched by `_cross_attention_fwd_impl`, pallas_call at :211), K6. As it
// does, in bf16 the unnormalised weights e (times the dropout keep factor)
// are rounded to the input type before the product with V, l sums the
// unrounded e, the output is acc / l written in the input type. The dropout
// mask is r3d::dropout_bits of the element index ((b*H + h)*Lq + q)*S + k,
// the mask of attention.cu, so cross_attention_bwd.cu redraws it.
//
// On the model's path: the 50salads decoder, Lq = 20 queries against S =
// 1,024 or 3,100 keys, C = 512, H = 8, D = 64, B = 8, bf16, with a key
// padding bias [B, 1, 1, S] of 0 or finfo(float32).min.
//
// What bounds it on the H100: bytes. It must read K and V once (2*B*S*C*2 =
// 50.8 MB at the shape above, bf16) and does 4*B*Lq*S*C = 1.0 GFLOP, about
// 20 flops per byte, far below the tensor cores' ridge: 0.015 ms at 3.35 TB/s.
//
// What the bf16 design does about it (two launches):
// - Split kernel, grid (B*H, n_split), 4 warps. The wrapper sizes the splits
//   (a multiple of 128 keys) so that all blocks are resident at once, two an
//   SM: 4 splits of 896 keys at the shape above. A block holds every query
//   of its (batch, head), 32 at a time (two m16 tiles; Lq <= 32 is one
//   pass), so K and V leave device memory once. Each warp OWNS a quarter of
//   the block's keys and walks them in tiles of 32 through its own ring of
//   three swizzled bf16 tiles, filled with 16-byte cp.async from its head's
//   128-byte slices of the 1,024-byte rows: the copies of tiles t+1 and t+2
//   are in flight under the products of tile t, and the warp keeps a private
//   online softmax (m, l, acc) in registers, so no block-wide barrier stands
//   in the key walk. Both products run on the tensor cores (mma.sync
//   m16n8k16, bf16 operands, fp32 sums): S = q k^T from ldmatrix fragments,
//   and acc += round_bf16(e * keep) v with the score fragments repacked in
//   registers as the A operand and V read through ldmatrix.trans. The four
//   warps are then combined in warp order through shared memory and the
//   block writes its partial (m_i, l_i, acc_i) in fp32: [n_split, B*H, Lq]
//   and [n_split, B*H, Lq, D] (1.3 MB at four splits).
// - Combine kernel, grid (B*H, Lq): m = max m_i, l = sum l_i exp(m_i - m),
//   out = sum acc_i exp(m_i - m) / l in split order; writes out in the input
//   type and (m, l). Deterministic, no atomics. A split (or warp) whose keys
//   all carry finfo.min weighs exp(finfo.min - m) = 0; one with no key at all
//   has m_i = -inf and weighs 0; a row whose every real key is masked has
//   every m_i = finfo.min, weights 1, and averages V over the real keys.
//   Keys past S are never read (their tiles are zero-filled) and score -inf.
// The split kernel's exponentials are __expf (ex2.approx of x * log2 e, about
// 2e-6 relative for the arguments that matter), which keeps (m, l) within the
// 1e-5 they are held to and is far below the bf16 rounding of the weights.
// The weights are rounded to bf16 against the warp's running max, not the
// row's final max: a weight can differ from the plain version's by one bf16
// step, as it did against the running max over chunks of 32. The split size
// depends on the card's SM count, so results are bit-equal between calls on
// one card, not between cards of different sizes.
//
// fp32 (the utkinects decoder's 1024 and 2000 buckets under
// R3D_CROSS_NATIVE=1, off by default: B = 8, Lq = 8, S = 1,024 or 2,000,
// C = 128, H = 8, D = 16; 16.4 MB of K and V at S = 2,000, 0.0049 ms at
// 3.35 TB/s) runs the cluster body of fp32 K3 and K4
// (attention_fwd_cluster.cuh, see its note) on the native layout, one
// launch: the keys of a (batch, head) split into runs of `split_keys`
// (ops/cross_attention.py: 8 of 256 at S = 2,000, of 128 at 1,024; 64
// clusters of 8 blocks, one wave), each block walking its tiles of 64 keys
// through a cp.async ring of two, the runs combined in rank order through
// distributed shared memory; the block that owns a row's first output
// element writes its (m, l). No scratch, no atomics, bit-equal calls.

#include <cuda_runtime.h>

#include "attention_fwd_cluster.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- the bf16 body ----

constexpr int KT = 32;              // keys per tile
constexpr int NSTAGE = 3;           // tiles in a warp's ring: two copies in flight under the math
constexpr int NW = 4;               // warps per block
constexpr int QT = 32;              // queries per pass: two m16 tiles
constexpr int MAXQ = 64;            // ops/cross_attention.py: MAX_QUERIES

template <int D>
constexpr int kWarpRingElems = NSTAGE * 2 * KT * D;   // a warp's ring of K and V tiles, bf16 values

template <int D, bool kDropout>
__global__ void __launch_bounds__(NW * 32, 2)
cross_fwd_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ bias,
                       float* __restrict__ part_acc, float* __restrict__ part_m,
                       float* __restrict__ part_l, int H, int Lq, int S, int split_keys,
                       float scale, uint32_t seed, uint32_t threshold, float keep_scale) {
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KS = D / 16;   // k-steps of q k^T
  constexpr int NT = D / 8;    // n-tiles of the output
  constexpr int LDA = D + 8;   // row stride of a warp's fp32 acc in shared memory
  static_assert(QT * LDA * sizeof(float) <= kWarpRingElems<D> * sizeof(bf16),
                "acc fits the warp's ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float wm[NW][QT];
  __shared__ float wl[NW][QT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int C = H * D;
  const int split = blockIdx.y;
  const int BH = gridDim.x;
  const int wk = split_keys / NW;                  // keys per warp, a multiple of KT
  const int wk0 = split * split_keys + warp * wk;  // this warp's first key
  const int ntiles = wk0 < S ? (min(wk, S - wk0) + KT - 1) / KT : 0;

  bf16* ring = reinterpret_cast<bf16*>(smem_raw) + warp * kWarpRingElems<D>;
  float* acc_s = reinterpret_cast<float*>(ring);   // after the keys are consumed
  const bf16* kb = k + static_cast<size_t>(b) * S * C + h * D;
  const bf16* vb = v + static_cast<size_t>(b) * S * C + h * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * S;

  for (int q0 = 0; q0 < Lq; q0 += QT) {
    // tile `tile` of this warp's keys into its stage of the ring
    auto copy_tile = [&](int tile) {
      const int key0 = wk0 + tile * KT;
      bf16* ktile = ring + (tile % NSTAGE) * 2 * KT * D;
      bf16* vtile = ktile + KT * D;
#pragma unroll
      for (int i = 0; i < KT * CH / 32; ++i) {
        const int idx = i * 32 + lane;
        const int r = idx / CH;
        const int c = idx % CH;
        const bool ok = key0 + r < S;
        const size_t off = static_cast<size_t>(ok ? key0 + r : 0) * C + c * 8;
        r3d::cp_async16(r3d::tile_ptr<D>(ktile, r, c), kb + off, ok);
        r3d::cp_async16(r3d::tile_ptr<D>(vtile, r, c), vb + off, ok);
      }
    };
    auto tile_bias = [&](int tile) {   // key `lane` of the tile
      const int key = wk0 + tile * KT + lane;
      return (tile < ntiles && key < S && biasb != nullptr) ? biasb[key] : 0.f;
    };
#pragma unroll
    for (int tile = 0; tile < NSTAGE - 1; ++tile) {   // one commit group per tile
      if (tile < ntiles) copy_tile(tile);
      r3d::cp_async_commit();
    }
    float bias_next = tile_bias(0);

    // the queries' A fragments, straight from device memory (rows past Lq: 0)
    uint32_t qf[2][KS][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + mt * 16 + g + (i & 1) * 8;
          const int d = ks * 16 + 2 * t + (i >> 1) * 8;
          qf[mt][ks][i] = row < Lq ? *reinterpret_cast<const uint32_t*>(
                                         q + (static_cast<size_t>(b) * Lq + row) * C + h * D + d)
                                   : 0u;
        }
      }
    }

    // rows of this thread: ri = mt*2 + hi is query q0 + mt*16 + g + hi*8
    float m[4], l[4];
    float acc[2][NT][4];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      m[ri] = -INFINITY;
      l[ri] = 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
      }
    }

    for (int tile = 0; tile < ntiles; ++tile) {
      // the stage of tile - 1 is free once every lane is done with it: start
      // the copy of tile + NSTAGE - 1 into it, then wait for tile's own copy
      __syncwarp();
      if (tile + NSTAGE - 1 < ntiles) copy_tile(tile + NSTAGE - 1);
      r3d::cp_async_commit();
      const float bias_r = bias_next;
      bias_next = tile_bias(tile + 1);
      r3d::cp_async_wait<NSTAGE - 1>();
      __syncwarp();   // every lane's share of the tile has landed
      const int key0 = wk0 + tile * KT;
      const bf16* ktile = ring + (tile % NSTAGE) * 2 * KT * D;
      const bf16* vtile = ktile + KT * D;

      // scores of 32 queries x 32 keys
      float s[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[mt][nt][i] = 0.f;
        }
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kf[4];
          r3d::load_b_frag<D>(kf, ktile, np * 16, ks, lane);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            r3d::mma_bf16(s[mt][2 * np], qf[mt][ks], kf[0], kf[1]);
            r3d::mma_bf16(s[mt][2 * np + 1], qf[mt][ks], kf[2], kf[3]);
          }
        }
      }
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = key0 + nt * 8 + 2 * t + j;
          const bool ok = key < S;
          const float bj = __shfl_sync(r3d::kFullMask, bias_r, nt * 8 + 2 * t + j);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
              const float sv = ok ? s[mt][nt][hi * 2 + j] * scale + bj : -INFINITY;
              s[mt][nt][hi * 2 + j] = sv;
              mx[mt * 2 + hi] = fmaxf(mx[mt * 2 + hi], sv);
            }
          }
        }
      }
      // online softmax against the warp's running max; l stays a per-lane
      // share until the end
      float corr[4];
#pragma unroll
      for (int ri = 0; ri < 4; ++ri) {
        const float m_new = fmaxf(m[ri], r3d::quad_max(mx[ri]));
        corr[ri] = m_new == -INFINITY ? 1.f : __expf(m[ri] - m_new);
        m[ri] = m_new;
        l[ri] *= corr[ri];
      }
      uint32_t pf[2][2][4];   // the rounded weights as A fragments, two k-steps of 16 keys
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ri = mt * 2 + (i >> 1);
            if (q0 + mt * 16 + (i >> 1) * 8 >= Lq) {   // eight rows past Lq: the whole warp skips
              pv[i] = 0.f;
              continue;
            }
            const float sv = s[mt][nt][i];
            const float p = sv == -INFINITY ? 0.f : __expf(sv - m[ri]);
            l[ri] += p;
            pv[i] = p;
            if (kDropout) {
              const uint32_t qi = q0 + mt * 16 + g + (i >> 1) * 8;
              const uint32_t key = key0 + nt * 8 + 2 * t + (i & 1);
              const uint32_t el = (static_cast<uint32_t>(bh) * Lq + qi) * S + key;
              pv[i] = r3d::dropout_bits(seed, el) >= threshold ? p * keep_scale : 0.f;
            }
          }
          pf[mt][nt >> 1][(nt & 1) * 2] = r3d::pack_bf16(pv[0], pv[1]);
          pf[mt][nt >> 1][(nt & 1) * 2 + 1] = r3d::pack_bf16(pv[2], pv[3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[mt][nt][0] *= corr[mt * 2];
          acc[mt][nt][1] *= corr[mt * 2];
          acc[mt][nt][2] *= corr[mt * 2 + 1];
          acc[mt][nt][3] *= corr[mt * 2 + 1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          r3d::load_b_frag_trans<D>(vf, vtile, kk * 16, np, lane);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            r3d::mma_bf16(acc[mt][2 * np], pf[mt][kk], vf[0], vf[1]);
            r3d::mma_bf16(acc[mt][2 * np + 1], pf[mt][kk], vf[2], vf[3]);
          }
        }
      }
    }

    // the warp's (m, l, acc) into shared memory, over its consumed ring
    r3d::cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const float lr = r3d::quad_sum(l[ri]);
      if (t == 0) {
        const int row = (ri >> 1) * 16 + g + (ri & 1) * 8;
        wm[warp][row] = m[ri];
        wl[warp][row] = lr;
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* p0 = acc_s + (mt * 16 + g) * LDA + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(p0) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(p0 + 8 * LDA) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
    __syncthreads();

    // the four warps in warp order: this block's partial of the pass's rows
    const int rows = min(QT, Lq - q0);
    const size_t prow0 = (static_cast<size_t>(split) * BH + bh) * Lq + q0;
    for (int idx = threadIdx.x; idx < rows * D; idx += NW * 32) {
      const int row = idx / D;
      const int d = idx % D;
      float mb = wm[0][row];
#pragma unroll
      for (int w = 1; w < NW; ++w) mb = fmaxf(mb, wm[w][row]);
      float a = 0.f;
      float lb = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float mw = wm[w][row];
        const float wgt = mw == -INFINITY ? 0.f : __expf(mw - mb);
        const float* aw = reinterpret_cast<const float*>(
            reinterpret_cast<const bf16*>(smem_raw) + w * kWarpRingElems<D>);
        a = fmaf(aw[row * LDA + d], wgt, a);
        lb = fmaf(wl[w][row], wgt, lb);
      }
      part_acc[(prow0 + row) * D + d] = a;
      if (d == 0) {
        part_m[prow0 + row] = mb;
        part_l[prow0 + row] = lb;
      }
    }
    __syncthreads();   // before the next pass copies over the tiles
  }
}

// out, m, l from the splits' partials, in split order. Grid (B*H, Lq), D threads.
__global__ void cross_fwd_combine_kernel(const float* __restrict__ part_acc,
                                         const float* __restrict__ part_m,
                                         const float* __restrict__ part_l,
                                         bf16* __restrict__ out, float* __restrict__ m_out,
                                         float* __restrict__ l_out, int n_split, int H, int Lq) {
  const int D = blockDim.x;
  const int d = threadIdx.x;
  const int bh = blockIdx.x;
  const int qi = blockIdx.y;
  const size_t row = static_cast<size_t>(bh) * Lq + qi;
  const size_t stride = static_cast<size_t>(gridDim.x) * Lq;   // rows per split
  float m = -INFINITY;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, part_m[i * stride + row]);
  float l = 0.f;
  float a = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float mi = part_m[i * stride + row];
    const float w = mi == -INFINITY ? 0.f : expf(mi - m);
    l = fmaf(part_l[i * stride + row], w, l);
    a = fmaf(part_acc[(i * stride + row) * D + d], w, a);
  }
  const int b = bh / H;
  const int h = bh % H;
  out[((static_cast<size_t>(b) * Lq + qi) * H + h) * D + d] =
      __float2bfloat16_rn(a * (l > 0.f ? 1.f / l : 0.f));
  if (d == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <int D, bool kDropout>
int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out, float* m,
                float* l, float* part, int split_keys, int B, int Lq, int S, int H, float scale,
                uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t stream) {
  if (part == nullptr || split_keys <= 0 || split_keys % (NW * KT) != 0 || Lq > MAXQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_split = (S + split_keys - 1) / split_keys;
  constexpr size_t smem = NW * kWarpRingElems<D> * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(cross_fwd_split_kernel<D, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(n_split) * B * H * Lq;
  float* part_m = part + rows * D;
  float* part_l = part_m + rows;
  cross_fwd_split_kernel<D, kDropout><<<dim3(B * H, n_split), NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      part, part_m, part_l, H, Lq, S, split_keys, scale, seed, threshold, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_fwd_combine_kernel<<<dim3(B * H, Lq), D, 0, stream>>>(
      part, part_m, part_l, static_cast<bf16*>(out), m, l, n_split, H, Lq);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDropout>
int dispatch_bf16(int D, const void* q, const void* k, const void* v, const float* bias, void* out,
                  float* m, float* l, float* part, int split_keys, int B, int Lq, int S, int H,
                  float scale, uint32_t seed, uint32_t threshold, float keep_scale,
                  cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_bf16<16, kDropout>(q, k, v, bias, out, m, l, part, split_keys, B, Lq, S, H, scale,
                                       seed, threshold, keep_scale, s);
    case 32:
      return launch_bf16<32, kDropout>(q, k, v, bias, out, m, l, part, split_keys, B, Lq, S, H, scale,
                                       seed, threshold, keep_scale, s);
    case 64:
      return launch_bf16<64, kDropout>(q, k, v, bias, out, m, l, part, split_keys, B, Lq, S, H, scale,
                                       seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the fp32 body: attention_fwd_cluster.cuh on the native layout ----

template <bool kDropout>
int dispatch_fp32(int D, const void* q, const void* k, const void* v, const float* bias, void* out,
                  float* m, float* l, int split_keys, int B, int Lq, int S, int H, float scale,
                  uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t s) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  switch (D) {
    case 16:
      return r3d::fwd_cluster_launch<16, kDropout, true>(qf, kf, vf, bias, of, m, l, B, H, Lq, S,
                                                         split_keys, scale, seed, threshold,
                                                         keep_scale, s);
    case 32:
      return r3d::fwd_cluster_launch<32, kDropout, true>(qf, kf, vf, bias, of, m, l, B, H, Lq, S,
                                                         split_keys, scale, seed, threshold,
                                                         keep_scale, s);
    case 64:
      return r3d::fwd_cluster_launch<64, kDropout, true>(qf, kf, vf, bias, of, m, l, B, H, Lq, S,
                                                         split_keys, scale, seed, threshold,
                                                         keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0: fp32, 1: bf16 (q, k, v and out). q, out [B, Lq, C]; k, v [B, S, C];
// bias [B, S] fp32 or null; m, l [B, H, Lq] fp32; all contiguous, q, k and v
// 16-byte aligned, C = H * D with D 16, 32 or 64. `split_keys` is the keys
// per block: fp32, a multiple of 64 with at most 8 splits
// (ops/attention.py:fp32_split_keys); bf16, a multiple of 128 with Lq <= 64,
// and `part` an fp32 scratch of n_split * B*H*Lq * (D + 2) values with
// n_split = ceil(S / split_keys) (fp32 takes none). With
// `dropout`, an element is kept when its dropout bits under `seed` are >=
// `threshold` and then scaled by `keep_scale`; B*H*Lq*S must fit in 32 bits.
extern "C" int r3d_cross_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                       const float* bias, void* out, float* m, float* l,
                                       float* part, int split_keys, int B, int Lq, int S, int H,
                                       int D, float scale, int dropout, uint32_t seed,
                                       uint32_t threshold, float keep_scale, void* stream) {
  if (B <= 0 || Lq <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dropout ? dispatch_fp32<true>(D, q, k, v, bias, out, m, l, split_keys, B, Lq, S, H,
                                           scale, seed, threshold, keep_scale, s)
                     : dispatch_fp32<false>(D, q, k, v, bias, out, m, l, split_keys, B, Lq, S, H,
                                            scale, seed, threshold, keep_scale, s);
    case 1:
      return dropout ? dispatch_bf16<true>(D, q, k, v, bias, out, m, l, part, split_keys, B, Lq, S,
                                           H, scale, seed, threshold, keep_scale, s)
                     : dispatch_bf16<false>(D, q, k, v, bias, out, m, l, part, split_keys, B, Lq, S,
                                            H, scale, seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of r3d_cross_attention_fwd's fp32 launch at these sizes
// the card holds at once (cudaOccupancyMaxActiveClusters); launches nothing.
extern "C" int r3d_cross_attention_fwd_clusters(int B, int H, int Lq, int S, int D,
                                                int split_keys, int* clusters) {
  switch (D) {
    case 16: return r3d::fwd_cluster_occupancy<16, true>(B, H, Lq, S, split_keys, clusters);
    case 32: return r3d::fwd_cluster_occupancy<32, true>(B, H, Lq, S, split_keys, clusters);
    case 64: return r3d::fwd_cluster_occupancy<64, true>(B, H, Lq, S, split_keys, clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
