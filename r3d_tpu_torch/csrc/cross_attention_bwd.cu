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
// The bf16 body (the 50salads decoder's training step), two launches:
// - Main kernel, grid (B*H, n_split), 4 warps. The wrapper sizes the splits
//   (ops/cross_attention.py:bwd_split_keys, whole tiles of 64 keys) so that
//   every block is resident at once, two an SM: 4 splits of 832 keys at the
//   shape above. A block copies q and g of its (batch, head) once (Lq <= 64,
//   padded to 16-row tiles), and walks its keys in tiles of 64 through a
//   ring of three swizzled bf16 K and V tiles filled with 16-byte cp.async
//   from the head's 128-byte slices of the native rows, so K and V leave
//   device memory once, two tiles in flight under the math of a third. Every
//   product runs on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
//   sums), each warp on 16 keys of the tile, the keys as the rows:
//     s^T = k q^T and (g v^T)^T = v g^T (bf16 operands with fp32 sums are
//     what the TPU kernel computes); w, keep, ds in fp32 in registers;
//     dk = ds_r^T q with ds_r = round_bf16(ds) repacked from the score
//     fragments; dv = (w keep)^T g with the fp32 w*keep taken as the sum of a
//     bf16 high and a bf16 low part, two products (about 2^-16 relative, far
//     under dv's own bf16 rounding; one bf16 product would move a rounding
//     point); dk and dv of the tile are complete in the block and go out once
//     in bf16 through shared memory as 16-byte stores;
//     dq += ds_r k, with ds_r read back transposed from shared memory
//     (ldmatrix.trans), each warp owning 16 of the D columns (per query tile)
//     in registers across the whole split.
//   The block writes its split's dq, scaled, to an fp32 scratch
//   [n_split, B, Lq, C] (1.3 MB at the shape above) and, only when asked for,
//   its column sums of the unrounded ds to a per-head slice [H, B, S].
// - Sum kernel: dq = the splits summed in split order, rounded to bf16, and
//   dbias = the heads' slices summed in head order. Deterministic, no atomics.
// Keys past S are zero-filled, weigh 0 and are never written; queries past Lq
// weigh 0. A fully masked row (every real key at finfo.min) has m = finfo.min
// and finite weights 1 / l.
//
// fp32 (the utkinects decoder's 1024 and 2000 buckets under
// R3D_CROSS_NATIVE=1, off by default: B = 8, Lq = 8, S = 1,024 or 2,000,
// C = 128, H = 8, D = 16; 32.8 MB in and out at S = 2,000, 0.0099 ms at
// 3.35 TB/s) runs the cluster body of fp32 K5 (attention_bwd_cluster.cuh,
// see its note) on the native layout with the forward's statistics given,
// one launch: the keys of a (batch, head) split into runs of `split_keys`
// (ops/attention.py:fp32_split_keys: 8 of 256 at S = 2,000; 64 clusters of 8
// blocks, one wave), each block walking its tiles of 64 keys through a
// cp.async ring of two and owning dk, dv and the per-head dbias slice of
// its keys; dq summed in rank order through distributed shared memory. No
// scratch, no atomics, bit-equal calls.

#include <cuda_runtime.h>

#include "attention_bwd_cluster.cuh"
#include "mma_bf16.cuh"

namespace {

// ---- the bf16 body ----

using bf16 = __nv_bfloat16;

constexpr int MAXQ = 64;     // queries held in shared memory (ops/cross_attention.py: MAX_QUERIES)
constexpr int KT = 64;       // keys per tile (ops/cross_attention.py: BWD_TILE_KEYS)
constexpr int NW = 4;        // warps per block, 16 keys of each tile
constexpr int NTH = NW * 32;
constexpr int NSTAGE = 3;    // K and V tiles in the ring: two copies in flight under the math
static_assert(KT == NW * 16, "a warp takes one m16 tile of keys");

// Shared memory of the bf16 body: bf16 tiles, then fp32 vectors.
template <int D>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (2 * MAXQ * D        // q, g
                         + NSTAGE * 2 * KT * D  // the K and V ring
                         + KT * MAXQ         // ds_r of a tile, keys as rows
                         + 2 * KT * D)       // dk, dv of a tile on their way out
         + sizeof(float) * (NSTAGE * KT + 3 * MAXQ);   // the bias ring; m, 1 / l, delta
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(NTH, 2)
cross_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      const bf16* __restrict__ g, const bf16* __restrict__ o,
                      const float* __restrict__ m_in, const float* __restrict__ l_in,
                      float* __restrict__ dq_part, float* __restrict__ dbias_part,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int Lq, int S,
                      int split_keys, float scale, uint32_t seed, uint32_t threshold,
                      float keep_scale) {
  constexpr int CH = D / 8;     // 16-byte chunks of a head's row
  constexpr int KS = D / 16;    // k-steps over D; also n-tile pairs of D
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [MAXQ][D]
  bf16* gs = qs + MAXQ * D;                        // [MAXQ][D]
  bf16* ring = gs + MAXQ * D;                      // NSTAGE x (K [KT][D], V [KT][D])
  bf16* dst = ring + NSTAGE * 2 * KT * D;          // [KT][MAXQ] ds_r, keys as rows
  bf16* dks = dst + KT * MAXQ;                     // [KT][D]
  bf16* dvs = dks + KT * D;                        // [KT][D]
  float* bs = reinterpret_cast<float*>(dvs + KT * D);   // NSTAGE x [KT]
  float* mrow = bs + NSTAGE * KT;                  // [MAXQ]
  float* linv = mrow + MAXQ;                       // [MAXQ] 1 / max(l, 1e-30)
  float* delta = linv + MAXQ;                      // [MAXQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int C = H * D;
  const int split = blockIdx.y;
  const int key_begin = split * split_keys;
  const int ntiles = (min(S, key_begin + split_keys) - key_begin + KT - 1) / KT;
  const int nq16 = (Lq + 15) / 16;   // 16-query tiles
  const bf16* kb = k + static_cast<size_t>(b) * S * C + h * D;
  const bf16* vb = v + static_cast<size_t>(b) * S * C + h * D;
  const float* biasb = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * S;

  // q and g of this (batch, head) first (rows past Lq zero), then the first
  // tiles: one commit group each
  for (int idx = tid; idx < nq16 * 16 * CH; idx += NTH) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool ok = r < Lq;
    const size_t off = (static_cast<size_t>(b) * Lq + (ok ? r : 0)) * C + h * D + c * 8;
    r3d::cp_async16(r3d::tile_ptr<D>(qs, r, c), q + off, ok);
    r3d::cp_async16(r3d::tile_ptr<D>(gs, r, c), g + off, ok);
  }
  r3d::cp_async_commit();
  auto copy_tile = [&](int tile) {
    const int key0 = key_begin + tile * KT;
    bf16* ktile = ring + (tile % NSTAGE) * 2 * KT * D;
    bf16* vtile = ktile + KT * D;
    for (int idx = tid; idx < KT * CH; idx += NTH) {
      const int r = idx / CH;
      const int c = idx % CH;
      const bool ok = key0 + r < S;
      const size_t off = static_cast<size_t>(ok ? key0 + r : 0) * C + c * 8;
      r3d::cp_async16(r3d::tile_ptr<D>(ktile, r, c), kb + off, ok);
      r3d::cp_async16(r3d::tile_ptr<D>(vtile, r, c), vb + off, ok);
    }
    if (tid < KT) {
      const bool ok = biasb != nullptr && key0 + tid < S;
      r3d::cp_async4(bs + (tile % NSTAGE) * KT + tid,
                     ok ? static_cast<const void*>(biasb + key0 + tid) : kb, ok);
    }
  };
#pragma unroll
  for (int tile = 0; tile < NSTAGE - 1; ++tile) {
    if (tile < ntiles) copy_tile(tile);
    r3d::cp_async_commit();
  }

  // each query's delta, m and 1 / l
  for (int qi = warp; qi < Lq; qi += NW) {
    const size_t off = (static_cast<size_t>(b) * Lq + qi) * C + h * D;
    float a = 0.f;
    for (int d = lane; d < D; d += 32) a += __bfloat162float(g[off + d]) * __bfloat162float(o[off + d]);
    a = r3d::warp_sum(a);
    if (lane == 0) {
      const size_t st = static_cast<size_t>(bh) * Lq + qi;
      delta[qi] = a;
      mrow[qi] = m_in[st];
      linv[qi] = 1.f / fmaxf(l_in[st], 1e-30f);
    }
  }

  // dq of this warp's units (a 16-query tile x 16 of the D columns): unit
  // u = warp + NW * i is query tile u / KS, columns 16 * (u % KS) ..
  const int n_units = nq16 * KS;
  float dq_acc[KS][2][4];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq_acc[i][j][e] = 0.f;
    }
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    // tile's copy has landed for every thread, and every thread is done with
    // the previous tile: its stage takes the copy of tile + NSTAGE - 1
    r3d::cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    if (tile + NSTAGE - 1 < ntiles) copy_tile(tile + NSTAGE - 1);
    r3d::cp_async_commit();
    const int key0 = key_begin + tile * KT;
    const bf16* ktile = ring + (tile % NSTAGE) * 2 * KT * D;
    const bf16* vtile = ktile + KT * D;
    const float* btile = bs + (tile % NSTAGE) * KT;

    // s^T and (g v^T)^T of this warp's 16 keys x every query, n-tiles of 8 queries
    float s[8][4], gv[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = gv[nt][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      r3d::load_a_frag<D>(ka, ktile, warp, ks, lane);
      r3d::load_a_frag<D>(va, vtile, warp, ks, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < nq16) {
          uint32_t qf[4], gf[4];
          r3d::load_b_frag<D>(qf, qs, np * 16, ks, lane);
          r3d::load_b_frag<D>(gf, gs, np * 16, ks, lane);
          r3d::mma_bf16(s[2 * np], ka, qf[0], qf[1]);
          r3d::mma_bf16(s[2 * np + 1], ka, qf[2], qf[3]);
          r3d::mma_bf16(gv[2 * np], va, gf[0], gf[1]);
          r3d::mma_bf16(gv[2 * np + 1], va, gf[2], gf[3]);
        }
      }
    }

    // w * keep and ds in fp32, repacked as A fragments (keys x 16 queries):
    // ds_r, and w * keep as a bf16 high and low part. Element e of n-tile nt
    // is key row gq + (e >> 1) * 8 of the warp's 16, query nt * 8 + 2t + (e & 1).
    uint32_t dsa[4][4], wha[4][4], wla[4][4];
    float db[2] = {0.f, 0.f};   // the unrounded ds summed over this thread's queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * nq16) {
        float dsv[4], wkv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = warp * 16 + gq + (e >> 1) * 8;
          const int key = key0 + kl;
          const int qi = nt * 8 + 2 * t + (e & 1);
          dsv[e] = wkv[e] = 0.f;
          if (key < S && qi < Lq) {
            const float w = expf(s[nt][e] * scale + btile[kl] - mrow[qi]) * linv[qi];
            float km = 1.f;
            if (kDropout) {
              const uint32_t el = (static_cast<uint32_t>(bh) * Lq + qi) * S + key;
              km = r3d::dropout_bits(seed, el) >= threshold ? keep_scale : 0.f;
            }
            wkv[e] = w * km;
            dsv[e] = w * (gv[nt][e] * km - delta[qi]);
          }
          db[e >> 1] += dsv[e];
        }
        const int kq = nt >> 1;
        const int slot = (nt & 1) * 2;
        float wh[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) wh[e] = __bfloat162float(__float2bfloat16_rn(wkv[e]));
        dsa[kq][slot] = r3d::pack_bf16(dsv[0], dsv[1]);
        dsa[kq][slot + 1] = r3d::pack_bf16(dsv[2], dsv[3]);
        wha[kq][slot] = r3d::pack_bf16(wh[0], wh[1]);
        wha[kq][slot + 1] = r3d::pack_bf16(wh[2], wh[3]);
        wla[kq][slot] = r3d::pack_bf16(wkv[0] - wh[0], wkv[1] - wh[1]);
        wla[kq][slot + 1] = r3d::pack_bf16(wkv[2] - wh[2], wkv[3] - wh[3]);
        // ds_r for the dq product, keys as rows (two queries in 4 bytes)
        const int kl = warp * 16 + gq;
        *reinterpret_cast<uint32_t*>(r3d::tile_ptr<MAXQ>(dst, kl, nt) + 2 * t) = dsa[kq][slot];
        *reinterpret_cast<uint32_t*>(r3d::tile_ptr<MAXQ>(dst, kl + 8, nt) + 2 * t) =
            dsa[kq][slot + 1];
      }
    }

    // dk = ds_r^T q and dv = (w keep)^T g of this warp's 16 keys
    float dka[2 * KS][4], dva[2 * KS][4];
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
    }
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      if (kq < nq16) {
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t qf[4], gf[4];
          r3d::load_b_frag_trans<D>(qf, qs, kq * 16, np, lane);
          r3d::load_b_frag_trans<D>(gf, gs, kq * 16, np, lane);
          r3d::mma_bf16(dka[2 * np], dsa[kq], qf[0], qf[1]);
          r3d::mma_bf16(dka[2 * np + 1], dsa[kq], qf[2], qf[3]);
          r3d::mma_bf16(dva[2 * np], wla[kq], gf[0], gf[1]);
          r3d::mma_bf16(dva[2 * np + 1], wla[kq], gf[2], gf[3]);
          r3d::mma_bf16(dva[2 * np], wha[kq], gf[0], gf[1]);
          r3d::mma_bf16(dva[2 * np + 1], wha[kq], gf[2], gf[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2 * KS; ++nt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int kl = warp * 16 + gq + hi * 8;
        *reinterpret_cast<uint32_t*>(r3d::tile_ptr<D>(dks, kl, nt) + 2 * t) =
            r3d::pack_bf16(dka[nt][hi * 2] * scale, dka[nt][hi * 2 + 1] * scale);
        *reinterpret_cast<uint32_t*>(r3d::tile_ptr<D>(dvs, kl, nt) + 2 * t) =
            r3d::pack_bf16(dva[nt][hi * 2], dva[nt][hi * 2 + 1]);
      }
    }
    if (dbias_part != nullptr) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float a = r3d::quad_sum(db[hi]);
        const int key = key0 + warp * 16 + gq + hi * 8;
        if (t == 0 && key < S) dbias_part[(static_cast<size_t>(h) * B + b) * S + key] = a;
      }
    }
    __syncthreads();   // ds_r, dk and dv of the whole tile are in shared memory

    // dq += ds_r k over the tile's 64 keys, this warp's units
    const int mi = lane >> 3;
    const int r8 = lane & 7;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int u = warp + NW * i;
      if (u < n_units) {
        const int mt = u / KS;
        const int np = u % KS;
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          uint32_t a[4], kf[4];
          r3d::ldmatrix_x4_trans(a, r3d::tile_ptr<MAXQ>(dst, kk * 16 + (mi >> 1) * 8 + r8,
                                                         2 * mt + (mi & 1)));
          r3d::load_b_frag_trans<D>(kf, ktile, kk * 16, np, lane);
          r3d::mma_bf16(dq_acc[i][0], a, kf[0], kf[1]);
          r3d::mma_bf16(dq_acc[i][1], a, kf[2], kf[3]);
        }
      }
    }

    // dk and dv of the tile's keys, 16 bytes a store
    for (int idx = tid; idx < KT * CH; idx += NTH) {
      const int r = idx / CH;
      const int c = idx % CH;
      if (key0 + r < S) {
        const size_t off = (static_cast<size_t>(b) * S + key0 + r) * C + h * D + c * 8;
        *reinterpret_cast<uint4*>(dk + off) = *reinterpret_cast<const uint4*>(r3d::tile_ptr<D>(dks, r, c));
        *reinterpret_cast<uint4*>(dv + off) = *reinterpret_cast<const uint4*>(r3d::tile_ptr<D>(dvs, r, c));
      }
    }
  }
  r3d::cp_async_wait<0>();

  // this split's share of dq
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int u = warp + NW * i;
    if (u < n_units) {
      const int mt = u / KS;
      const int np = u % KS;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int qi = mt * 16 + gq + hi * 8;
          if (qi < Lq) {
            float* p = dq_part + ((static_cast<size_t>(split) * B + b) * Lq + qi) * C + h * D +
                       np * 16 + j * 8 + 2 * t;
            *reinterpret_cast<float2*>(p) =
                make_float2(dq_acc[i][j][hi * 2] * scale, dq_acc[i][j][hi * 2 + 1] * scale);
          }
        }
      }
    }
  }
}

// dq[i] = the splits' dq_part[., i] summed in split order, in bf16; with
// dbias, dbias[j] = the heads' slices summed in head order.
__global__ void cross_bwd_sum_kernel(const float* __restrict__ dq_part, bf16* __restrict__ dq,
                                     const float* __restrict__ dbias_part,
                                     float* __restrict__ dbias, int n_split, size_t n_dq, int H,
                                     size_t n_bias) {
  const size_t n = n_dq + (dbias != nullptr ? n_bias : 0);
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = 0.f;
    if (i < n_dq) {
      for (int s = 0; s < n_split; ++s) a += dq_part[static_cast<size_t>(s) * n_dq + i];
      dq[i] = __float2bfloat16_rn(a);
    } else {
      const size_t j = i - n_dq;
      for (int h = 0; h < H; ++h) a += dbias_part[static_cast<size_t>(h) * n_bias + j];
      dbias[j] = a;
    }
  }
}

template <int D, bool kDropout>
int launch_bf16(const void* q, const void* k, const void* v, const float* bias, const void* g,
                const void* o, const float* m, const float* l, float* part, void* dq, void* dk,
                void* dv, float* dbias, int B, int Lq, int S, int H, int split_keys, float scale,
                uint32_t seed, uint32_t threshold, float keep_scale, cudaStream_t stream) {
  constexpr size_t smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(cross_bwd_bf16_kernel<D, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_split = (S + split_keys - 1) / split_keys;
  const size_t n_dq = static_cast<size_t>(B) * Lq * H * D;
  const size_t n_bias = static_cast<size_t>(B) * S;
  float* dbias_part = dbias == nullptr ? nullptr : part + static_cast<size_t>(n_split) * n_dq;
  cross_bwd_bf16_kernel<D, kDropout><<<dim3(B * H, n_split), NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<const bf16*>(g), static_cast<const bf16*>(o), m, l, part, dbias_part,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, H, Lq, S, split_keys, scale, seed,
      threshold, keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = n_dq + (dbias != nullptr ? n_bias : 0);
  const size_t want = (n + 255) / 256;
  cross_bwd_sum_kernel<<<static_cast<int>(want < 1024 ? want : 1024), 256, 0, stream>>>(
      part, static_cast<bf16*>(dq), dbias_part, dbias, n_split, n_dq, H, n_bias);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDropout>
int dispatch_bf16(int D, const void* q, const void* k, const void* v, const float* bias,
                  const void* g, const void* o, const float* m, const float* l, float* part,
                  void* dq, void* dk, void* dv, float* dbias, int B, int Lq, int S, int H,
                  int split_keys, float scale, uint32_t seed, uint32_t threshold,
                  float keep_scale, cudaStream_t s) {
  if (part == nullptr || split_keys % KT != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return launch_bf16<16, kDropout>(q, k, v, bias, g, o, m, l, part, dq, dk, dv, dbias, B, Lq,
                                       S, H, split_keys, scale, seed, threshold, keep_scale, s);
    case 32:
      return launch_bf16<32, kDropout>(q, k, v, bias, g, o, m, l, part, dq, dk, dv, dbias, B, Lq,
                                       S, H, split_keys, scale, seed, threshold, keep_scale, s);
    case 64:
      return launch_bf16<64, kDropout>(q, k, v, bias, g, o, m, l, part, dq, dk, dv, dbias, B, Lq,
                                       S, H, split_keys, scale, seed, threshold, keep_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp32: the cluster body on the native layout, the forward's statistics given
template <bool kDropout>
int dispatch_fp32(int D, const void* q, const void* k, const void* v, const float* bias,
                  const void* g, const void* o, const float* m, const float* l, void* dq,
                  void* dk, void* dv, float* dbias, int B, int Lq, int S, int H, int split_keys,
                  float scale, uint32_t seed, uint32_t threshold, float keep_scale,
                  cudaStream_t s) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  return r3d::bwd_cluster_dispatch<kDropout, true>(
      f(q), f(k), f(v), bias, f(g), f(o), m, l, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), dbias, B, H, Lq, S, D, split_keys, scale, seed, threshold,
      keep_scale, s);
}

}  // namespace

// dtype 0: fp32, 1: bf16 (q, k, v, g, o, dq, dk, dv). q, g, o, dq [B, Lq, C];
// k, v, dk, dv [B, S, C]; bias [B, S] fp32 or null; m, l [B, H, Lq] fp32.
// All contiguous, q, k, v, g (fp32: and o) 16-byte aligned; C = H * D with D
// 16, 32 or 64; Lq <= 64. `split_keys` is the keys per block. fp32: a
// multiple of 64 with at most 8 splits (ops/attention.py:fp32_split_keys),
// no scratch (`part` is not read), and dbias [B, H, S] fp32 or null: each
// head's column sums of ds, for the caller to sum over heads. bf16: a
// multiple of 64, `part` an fp32 scratch [n_split, B, Lq, C] with n_split =
// ceil(S / split_keys), followed, when dbias is not null, by [H, B, S], and
// dbias [B, S] fp32 or null. A null dbias is not computed. With `dropout`,
// the keep mask is drawn as r3d_cross_attention_fwd draws it.
extern "C" int r3d_cross_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const float* bias, const void* g, const void* o,
                                       const float* m, const float* l, float* part, void* dq,
                                       void* dk, void* dv, float* dbias, int B, int Lq, int S,
                                       int H, int D, int split_keys, float scale, int dropout,
                                       uint32_t seed, uint32_t threshold, float keep_scale,
                                       void* stream) {
  if (B <= 0 || Lq <= 0 || Lq > MAXQ || S <= 0 || H <= 0 || split_keys <= 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dropout ? dispatch_fp32<true>(D, q, k, v, bias, g, o, m, l, dq, dk, dv, dbias, B, Lq,
                                         S, H, split_keys, scale, seed, threshold, keep_scale, s)
                   : dispatch_fp32<false>(D, q, k, v, bias, g, o, m, l, dq, dk, dv, dbias, B, Lq,
                                          S, H, split_keys, scale, seed, threshold, keep_scale, s);
  }
  return dropout ? dispatch_bf16<true>(D, q, k, v, bias, g, o, m, l, part, dq, dk, dv, dbias, B,
                                       Lq, S, H, split_keys, scale, seed, threshold, keep_scale, s)
                 : dispatch_bf16<false>(D, q, k, v, bias, g, o, m, l, part, dq, dk, dv, dbias, B,
                                        Lq, S, H, split_keys, scale, seed, threshold, keep_scale,
                                        s);
}

// How many clusters of r3d_cross_attention_bwd's fp32 launch at these sizes
// the card holds at once (cudaOccupancyMaxActiveClusters); launches nothing.
extern "C" int r3d_cross_attention_bwd_clusters(int B, int H, int S, int D, int split_keys,
                                                int dropout, int* clusters) {
  return r3d::bwd_cluster_occupancy<true>(B, H, S, D, split_keys, dropout, clusters);
}

// Blocks of the bf16 main kernel (head dim D, with or without dropout) that
// fit one SM at once, into *blocks_per_sm.
extern "C" int r3d_cross_attention_bwd_occupancy(int D, int dropout, int* blocks_per_sm) {
  auto query = [&](auto kernel, size_t smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, NTH, smem);
    }
    return static_cast<int>(err);
  };
  switch (D * 2 + (dropout != 0)) {
    case 32: return query(cross_bwd_bf16_kernel<16, false>, bf16_smem_bytes<16>());
    case 33: return query(cross_bwd_bf16_kernel<16, true>, bf16_smem_bytes<16>());
    case 64: return query(cross_bwd_bf16_kernel<32, false>, bf16_smem_bytes<32>());
    case 65: return query(cross_bwd_bf16_kernel<32, true>, bf16_smem_bytes<32>());
    case 128: return query(cross_bwd_bf16_kernel<64, false>, bf16_smem_bytes<64>());
    case 129: return query(cross_bwd_bf16_kernel<64, true>, bf16_smem_bytes<64>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
