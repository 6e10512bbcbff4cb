// Attention forward: out = softmax(q k^T * scale + bias) v, fp32 softmax,
// optionally with dropout on the softmax weights.
//
// Replaces two Pallas kernels, each in fp32 and in bf16:
// - r3d_tpu/ops/attention.py:38 `_kernel` (launched by `_pallas_attention`,
//   pallas_call at :82), the forward that `flash_attention` runs (K3);
// - r3d_tpu/ops/attention.py:192 `_kernel_dropout` (launched by
//   `_pallas_attention_dropout`, pallas_call at :305), the training forward
//   of `flash_attention_dropout` (K4): the weights are multiplied by a keep
//   mask scaled 1/(1-p). The mask comes from a counter-based hash of (seed,
//   element index) ((b*H + h)*Lq + q)*Lk + k (common.cuh), so it does not
//   depend on the tiling, and the backward (attention_bwd.cu) redraws it.
// Layout: q, out [B, H, Lq, D], k, v [B, H, Lk, D], a key-padding bias
// [B, Lk] of 0 or finfo(float32).min.
//
// fp32 K3 (utkinects: Lq = 8 queries against Lk = 256 or 512 keys, D = 16,
// B x H = 8 x 8; every sticky train step, validation step and 256/512
// serving chunk) and fp32 K4 (the same shape with dropout, every epoch-0
// train step) share the cluster body of attention_fwd_cluster.cuh (see its
// note) with fp32 K6 (cross_attention.cu): one launch, the keys of a (batch,
// head) split into runs of whole 64-key tiles, one block each, the blocks of
// one (batch*head, tile of 8 queries) a thread-block cluster that combines
// its (m_i, l_i, acc_i) in rank order through distributed shared memory.
//
// bf16 (the 50salads decoder: Lq = 20 against Lk = 256 or 512, D = 64, B x H
// = 8 x 8) has the split body below. As the TPU kernels do
// (r3d_tpu/ops/attention.py:48-50, 210-212), it rounds the NORMALISED
// weights w = exp(s - m) / l, times the keep factor, to bf16 before the
// product with V; the scores, the softmax and the sums of w v are fp32, and
// out is written once in bf16. What bounds it: bytes, 8.7 MB (K and V once)
// at Lk = 512, 0.0026 ms at 3.35 TB/s; its 0.17 GFLOP take 0.0002 ms on the
// tensor cores. At that size the work is a few microseconds, so the design
// is about latency: every block starts its loads at once, and there is one
// launch and no scratch in device memory.
// - Grid (n_split, ceil(Lq / 32), B*H), 4 warps a block. The keys of one
//   (batch, head) are split into n_split runs of `split_keys` (chosen by the
//   wrapper, ops/attention.py:fwd_split_keys: 4 splits of 128 at Lk = 512,
//   256 blocks), and the n_split blocks of one (batch*head, query tile)
//   form one thread-block cluster (2-8 blocks, launched with
//   cudaLaunchKernelEx). A block holds the tile's 32 queries (two m16
//   tiles; q loaded straight into A fragments), so K and V leave device
//   memory once.
// - Each warp owns a quarter of its block's keys and copies them, 32 keys a
//   tile, K, V and the bias, with 16- and 4-byte cp.async into its own
//   swizzled bf16 tile in shared memory. Pass 1 forms S = q k^T on the
//   tensor cores (mma.sync m16n8k16, bf16 operands, fp32 sums) and the
//   warp's (m, l) per query with __expf.
// - The weights can only be rounded once the row's final m and l are known,
//   so the statistics are combined first, in a fixed order: the block's
//   warps in warp order into the block's (m_i, l_i) in shared memory, then,
//   after a cluster barrier, every block reads all (m_i, l_i) of its cluster
//   through distributed shared memory and combines them in rank order into
//   the row's m = max m_i and l = sum l_i exp(m_i - m): every block derives
//   bit-identical values.
// - Pass 2 takes the scores and the tile still in hand (a warp with more
//   than one tile, Lk > 1,024, copies and scores its tiles again), forms
//   w = round_bf16(exp(s - m) / l * keep) in registers as the A operand, and
//   acc += w v on the tensor cores with V read through ldmatrix.trans. The
//   partials need no rescaling: they are already normalised.
// - The block sums its warps' acc in warp order in shared memory; after a
//   second cluster barrier each block sums, for its share of the tile's
//   output, the cluster's partials in rank order through distributed shared
//   memory, rounds once to bf16 and writes out; a third barrier keeps every
//   block's shared memory alive until the others have read it.
// Deterministic, no atomics. Keys past Lk are never read (zero-filled) and
// score -inf. A split or warp with no key has m_i = -inf and weighs 0
// explicitly; one whose keys all carry finfo.min weighs exp(finfo.min - m) =
// 0; a row whose every real key is masked has every m_i = finfo.min and
// averages V over the real keys; a row whose every score is -inf gives 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "attention_fwd_cluster.cuh"
#include "mma_bf16.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int MAX_SPLITS = r3d::kMaxSplits;   // blocks per cluster (ops/attention.py)

// ---- the bf16 body ----

constexpr int KT = 32;          // keys per tile
constexpr int NW = 4;           // warps per block
constexpr int QT = 32;          // queries per block: two m16 tiles

template <int D>
constexpr int kWarpTileElems = 2 * KT * D;   // a warp's tile of K and V, bf16 values
template <int D>
constexpr int kAccStride = D + 8;   // row stride of a warp's fp32 acc in shared memory
template <int D>   // the warps' acc, and before them (in less room) their tiles
constexpr size_t kSmemBytes = NW * QT * kAccStride<D> * sizeof(float);

// Three blocks an SM (at most 170 registers a thread): at two, fewer clusters
// of 4 fit the card at once than the main path launches, and the launch runs
// in two waves.
template <int D, bool kDropout>
__global__ void __launch_bounds__(NW * 32, 3)
attention_fwd_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const float* __restrict__ bias,
                           bf16* __restrict__ out, int H, int Lq, int Lk, int split_keys,
                           float scale, uint32_t seed, uint32_t threshold, float keep_scale) {
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int KS = D / 16;   // k-steps of q k^T
  constexpr int NT = D / 8;    // n-tiles of the output
  constexpr int LDA = kAccStride<D>;
  static_assert(NW * kWarpTileElems<D> * sizeof(bf16) <= kSmemBytes<D>, "the tiles fit");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float bias_s[NW][KT];   // the bias of each warp's tile
  __shared__ float wm[NW][QT];
  __shared__ float wl[NW][QT];
  __shared__ float cm[QT];     // this block's (m_i, l_i), read by the whole cluster
  __shared__ float cl[QT];
  __shared__ float fm[QT];     // the row's final m and 1 / l
  __shared__ float finv[QT];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.y * QT;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int wk = split_keys / NW;                  // keys per warp, a multiple of KT
  const int wk0 = split * split_keys + warp * wk;  // this warp's first key
  const int ntiles = wk0 < Lk ? (min(wk, Lk - wk0) + KT - 1) / KT : 0;

  bf16* ktile = reinterpret_cast<bf16*>(smem_raw) + warp * kWarpTileElems<D>;
  bf16* vtile = ktile + KT * D;
  const bf16* kb = k + static_cast<size_t>(bh) * Lk * D;
  const bf16* vb = v + static_cast<size_t>(bh) * Lk * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Lk;

  // copy tile `tile` of this warp's keys (K, V and the bias) into the warp's
  // shared memory, which it must be done with; wait_tile waits for the copy
  auto load_tile = [&](int tile) {
    const int key0 = wk0 + tile * KT;
#pragma unroll
    for (int i = 0; i < KT * CH / 32; ++i) {
      const int idx = i * 32 + lane;
      const int r = idx / CH;
      const int c = idx % CH;
      const bool ok = key0 + r < Lk;
      const size_t off = static_cast<size_t>(ok ? key0 + r : 0) * D + c * 8;
      r3d::cp_async16(r3d::tile_ptr<D>(ktile, r, c), kb + off, ok);
      r3d::cp_async16(r3d::tile_ptr<D>(vtile, r, c), vb + off, ok);
    }
    const bool ok = biasb != nullptr && key0 + lane < Lk;   // else 0
    r3d::cp_async4(&bias_s[warp][lane], ok ? static_cast<const void*>(biasb + key0 + lane) : kb,
                   ok);
    r3d::cp_async_commit();
  };
  auto wait_tile = [&]() {
    r3d::cp_async_wait<0>();
    __syncwarp();   // every lane's share of the tile has landed
  };
  if (ntiles > 0) load_tile(0);   // in flight while q is loaded

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
                                       q + (static_cast<size_t>(bh) * Lq + row) * D + d)
                                 : 0u;
      }
    }
  }

  // scores of the 32 queries x 32 keys of the tile in shared memory, scaled
  // and biased, -inf past Lk. Rows of this thread: ri = mt*2 + hi is query
  // q0 + mt*16 + g + hi*8; s[mt][nt][hi*2 + j] is key nt*8 + 2t + j.
  auto tile_scores = [&](int tile, float (&s)[2][4][4]) {
    const float* bt = bias_s[warp];
    const int key0 = wk0 + tile * KT;
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
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + 2 * t + j;
        const bool ok = key0 + col < Lk;
        const float bj = bt[col];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            float& sv = s[mt][nt][hi * 2 + j];
            sv = ok ? sv * scale + bj : -INFINITY;
          }
        }
      }
    }
  };
  // the eight rows of (mt, hi) lie past Lq: the whole warp skips them
  auto rows_out = [&](int mt, int hi) { return q0 + mt * 16 + hi * 8 >= Lq; };

  // pass 1: the warp's max m and sum l of exp(s - m) per query
  float m[4], l[4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    m[ri] = -INFINITY;
    l[ri] = 0.f;
  }
  float s[2][4][4];   // the scores of the tile in hand
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile > 0) {
      __syncwarp();
      load_tile(tile);
    }
    wait_tile();
    tile_scores(tile, s);
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int mt = ri >> 1;
      const int hi = ri & 1;
      if (rows_out(mt, hi)) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mx = fmaxf(mx, fmaxf(s[mt][nt][hi * 2], s[mt][nt][hi * 2 + 1]));
      }
      const float m_new = fmaxf(m[ri], r3d::quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float sv = s[mt][nt][hi * 2 + j];
          sum += sv == -INFINITY ? 0.f : __expf(sv - m_new);
        }
      }
      l[ri] = l[ri] * (m_new == -INFINITY ? 1.f : __expf(m[ri] - m_new)) + sum;
      m[ri] = m_new;
    }
  }

  // the row's m and l: warps in warp order, then the cluster's blocks in rank order
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const float lr = r3d::quad_sum(l[ri]);
    if (t == 0) {
      const int row = (ri >> 1) * 16 + g + (ri & 1) * 8;
      wm[warp][row] = m[ri];
      wl[warp][row] = lr;
    }
  }
  __syncthreads();
  if (threadIdx.x < QT) {
    const int row = threadIdx.x;
    float mb = wm[0][row];
#pragma unroll
    for (int w = 1; w < NW; ++w) mb = fmaxf(mb, wm[w][row]);
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = wm[w][row];
      lb += mw == -INFINITY ? 0.f : wl[w][row] * __expf(mw - mb);
    }
    cm[row] = mb;
    cl[row] = lb;
  }
  cluster.sync();
  if (threadIdx.x < QT) {
    const int row = threadIdx.x;
    float mi[MAX_SPLITS];
    float li[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {   // every remote load in flight at once
      mi[r] = r < n_split ? cluster.map_shared_rank(cm, r)[row] : -INFINITY;
      li[r] = r < n_split ? cluster.map_shared_rank(cl, r)[row] : 0.f;
    }
    float mr = mi[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r) mr = fmaxf(mr, mi[r]);
    float lr = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      lr += mi[r] == -INFINITY ? 0.f : li[r] * __expf(mi[r] - mr);
    }
    fm[row] = mr;
    finv[row] = lr > 0.f ? 1.f / lr : 0.f;
  }
  __syncthreads();

  // pass 2: acc = sum over the warp's keys of round_bf16(exp(s - m) / l * keep) v
  float rm[4], rinv[4];
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int row = (ri >> 1) * 16 + g + (ri & 1) * 8;
    rm[ri] = fm[row];
    rinv[ri] = finv[row];
  }
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
  const bool in_hand = ntiles <= 1;   // pass 1 left the warp's one tile and its scores in hand
  for (int tile = 0; tile < ntiles; ++tile) {
    if (!in_hand) {
      __syncwarp();
      load_tile(tile);
      wait_tile();
      tile_scores(tile, s);
    }
    const int key0 = wk0 + tile * KT;
    uint32_t pf[2][2][4];   // the rounded weights as A fragments, two k-steps of 16 keys
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = mt * 2 + (i >> 1);
          if (rows_out(mt, i >> 1)) {
            pv[i] = 0.f;
            continue;
          }
          const float sv = s[mt][nt][i];
          float w = sv == -INFINITY ? 0.f : __expf(sv - rm[ri]) * rinv[ri];
          if (kDropout) {
            const uint32_t qi = q0 + mt * 16 + g + (i >> 1) * 8;
            const uint32_t key = key0 + nt * 8 + 2 * t + (i & 1);
            const uint32_t el = (static_cast<uint32_t>(bh) * Lq + qi) * Lk + key;
            w = r3d::dropout_bits(seed, el) >= threshold ? w * keep_scale : 0.f;
          }
          pv[i] = w;
        }
        pf[mt][nt >> 1][(nt & 1) * 2] = r3d::pack_bf16(pv[0], pv[1]);
        pf[mt][nt >> 1][(nt & 1) * 2 + 1] = r3d::pack_bf16(pv[2], pv[3]);
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

  // the warps' acc over the consumed tiles, then the block's partial: its
  // warps in warp order, in place in warp 0's
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem_raw) + warp * QT * LDA;
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
  constexpr int D4 = D / 4;
  const int n4 = min(QT, Lq - q0) * D4;   // float4s of the tile's real rows
  float* part = reinterpret_cast<float*>(smem_raw);
  for (int idx = threadIdx.x; idx < n4; idx += NW * 32) {
    const int off = (idx / D4) * LDA + (idx % D4) * 4;
    float4 a = *reinterpret_cast<const float4*>(part + off);
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(part + w * QT * LDA + off);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    *reinterpret_cast<float4*>(part + off) = a;
  }
  cluster.sync();

  // out: this block's share of the tile's values, the cluster's partials in rank order
  const int share = (n4 + n_split - 1) / n_split;
  const int end = min(n4, (split + 1) * share);
  bf16* ob = out + (static_cast<size_t>(bh) * Lq + q0) * D;
  for (int idx = split * share + threadIdx.x; idx < end; idx += NW * 32) {
    const int row = idx / D4;
    const int c = (idx % D4) * 4;
    float4 x[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {   // every remote load in flight at once
      if (r < n_split) {
        x[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + row * LDA + c);
      }
    }
    float4 a = x[0];
#pragma unroll
    for (int r = 1; r < MAX_SPLITS; ++r) {
      if (r < n_split) {
        a.x += x[r].x;
        a.y += x[r].y;
        a.z += x[r].z;
        a.w += x[r].w;
      }
    }
    *reinterpret_cast<uint2*>(ob + row * D + c) =
        make_uint2(r3d::pack_bf16(a.x, a.y), r3d::pack_bf16(a.z, a.w));
  }
  cluster.sync();   // no block leaves while another still reads its shared memory
}

template <int D, bool kDropout>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out, int B,
                int H, int Lq, int Lk, int split_keys, float scale, uint32_t seed,
                uint32_t threshold, float keep_scale, cudaStream_t stream) {
  if (split_keys <= 0 || split_keys % (NW * KT) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_split = (Lk + split_keys - 1) / split_keys;
  if (n_split > MAX_SPLITS) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = kSmemBytes<D>;
  const auto kernel = attention_fwd_split_kernel<D, kDropout>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;   // the n_split blocks of a (batch*head, query tile): one cluster
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = n_split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, (Lq + QT - 1) / QT, B * H);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, k, v, bias, out, H, Lq, Lk, split_keys, scale, seed,
                           threshold, keep_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDropout>
int dispatch_fp32_cluster(const float* q, const float* k, const float* v, const float* bias,
                          float* out, int B, int H, int Lq, int Lk, int D, int split_keys,
                          float scale, uint32_t seed, uint32_t threshold, float keep_scale,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return r3d::fwd_cluster_launch<16, kDropout, false>(q, k, v, bias, out, nullptr, nullptr, B,
                                                          H, Lq, Lk, split_keys, scale, seed,
                                                          threshold, keep_scale, s);
    case 32:
      return r3d::fwd_cluster_launch<32, kDropout, false>(q, k, v, bias, out, nullptr, nullptr, B,
                                                          H, Lq, Lk, split_keys, scale, seed,
                                                          threshold, keep_scale, s);
    case 64:
      return r3d::fwd_cluster_launch<64, kDropout, false>(q, k, v, bias, out, nullptr, nullptr, B,
                                                          H, Lq, Lk, split_keys, scale, seed,
                                                          threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDropout>
int dispatch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out, int B,
                  int H, int Lq, int Lk, int D, int split_keys, float scale, uint32_t seed,
                  uint32_t threshold, float keep_scale, void* stream) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_bf16<16, kDropout>(q, k, v, bias, out, B, H, Lq, Lk, split_keys, scale, seed,
                                       threshold, keep_scale, s);
    case 32:
      return launch_bf16<32, kDropout>(q, k, v, bias, out, B, H, Lq, Lk, split_keys, scale, seed,
                                       threshold, keep_scale, s);
    case 64:
      return launch_bf16<64, kDropout>(q, k, v, bias, out, B, H, Lq, Lk, split_keys, scale, seed,
                                       threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, Lq, D], k and v [B, H, Lk, D], bias [B, Lk] or null, out [B, H, Lq, D];
// all fp32 and contiguous, k and v 16-byte aligned. D must be 16, 32 or 64,
// and `split_keys` the keys of one block (a multiple of 64 with at most 8
// splits: ops/attention.py:fp32_split_keys).
extern "C" int r3d_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* bias, float* out, int B, int H, int Lq, int Lk,
                                 int D, int split_keys, float scale, void* stream) {
  return dispatch_fp32_cluster<false>(q, k, v, bias, out, B, H, Lq, Lk, D, split_keys, scale, 0u,
                                      0u, 1.f, stream);
}

// How many clusters of r3d_attention_fwd's launch at these sizes the card
// holds at once (cudaOccupancyMaxActiveClusters); launches nothing.
extern "C" int r3d_attention_fwd_clusters(int B, int H, int Lq, int Lk, int D, int split_keys,
                                          int* clusters) {
  switch (D) {
    case 16: return r3d::fwd_cluster_occupancy<16, false>(B, H, Lq, Lk, split_keys, clusters);
    case 32: return r3d::fwd_cluster_occupancy<32, false>(B, H, Lq, Lk, split_keys, clusters);
    case 64: return r3d::fwd_cluster_occupancy<64, false>(B, H, Lq, Lk, split_keys, clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As r3d_attention_fwd, with dropout on the weights: an element is kept when
// its dropout bits under `seed` are >= `threshold` (= rate * 2^32) and then
// scaled by `keep_scale` (= 1 / (1 - rate)). B*H*Lq*Lk must fit in 32 bits.
extern "C" int r3d_attention_fwd_dropout(const float* q, const float* k, const float* v,
                                         const float* bias, float* out, int B, int H, int Lq,
                                         int Lk, int D, int split_keys, float scale,
                                         uint32_t seed, uint32_t threshold, float keep_scale,
                                         void* stream) {
  return dispatch_fp32_cluster<true>(q, k, v, bias, out, B, H, Lq, Lk, D, split_keys, scale, seed,
                                     threshold, keep_scale, stream);
}

// The two above with bf16 q, k, v and out (the bias stays fp32), each 16-byte
// aligned, and `split_keys` the keys of one block (a multiple of 128 with at
// most 8 splits: ops/attention.py:fwd_split_keys).
extern "C" int r3d_attention_fwd_bf16(const bf16* q, const bf16* k, const bf16* v,
                                      const float* bias, bf16* out, int B, int H, int Lq, int Lk,
                                      int D, int split_keys, float scale, void* stream) {
  return dispatch_bf16<false>(q, k, v, bias, out, B, H, Lq, Lk, D, split_keys, scale, 0u, 0u, 1.f,
                              stream);
}

extern "C" int r3d_attention_fwd_dropout_bf16(const bf16* q, const bf16* k, const bf16* v,
                                              const float* bias, bf16* out, int B, int H, int Lq,
                                              int Lk, int D, int split_keys, float scale,
                                              uint32_t seed, uint32_t threshold, float keep_scale,
                                              void* stream) {
  return dispatch_bf16<true>(q, k, v, bias, out, B, H, Lq, Lk, D, split_keys, scale, seed,
                             threshold, keep_scale, stream);
}
