// Fused CMFuser: the SA-Fuser tail, optionally after the BN-affine + bottom-k
// alpha blend prologue, in one pass over a tile of rows.
//
// Replaces the Pallas kernel r3d_tpu/ops/fuser_kernel.py:180 `_kernel`
// (launched by `_pallas_forward`, pallas_call at :254) on both its routes:
// `with_blend` (`fused_bn_blend_tail`: serving, validation and the sticky
// training epochs) and without it (`fused_safuser_tail`: training epoch 0,
// after the composed blend and dropout). For each row i of the streams
// r, d [N, C]:
//
//   with the blend:  rn = r*scale_r + shift_r      dn = d*scale_d + shift_d
//                    r <- mask_r*(a*rn + (1-a)*dn) + (1-mask_r)*rn  (mirror: d)
//   x_r = r + LN1(d) Wvp^T + b          x_d = d + LN1(r) Wvp^T + b
//   x_* += W2 GELU(W1 LN2(x_*) + b1) + b2
//   x_r += r, x_d += d                  (only with the outer residual)
//   out  = (LN_out(x_r) + LN_out(x_d)) / 2
//
// Both choices are template parameters, so the blend route that serving takes
// carries no register or shared-memory cost of the other. The outer residual
// re-reads (and re-blends) the tile's input rows from global memory at the
// end instead of keeping a copy in shared memory.
//
// LayerNorm statistics are fp32 with biased variance and eps 1e-5; GELU is
// the exact erf form (CUDA has erff; the TPU kernel's polynomial erf existed
// only because Mosaic lacked one). Everything but the three products is fp32
// on the CUDA cores, and the products keep about fp32's accuracy (below), so
// the kernel agrees with the plain fp32 version to rounding.
//
// What bounds it on the H100: operations. Per output row it does
// 2 * (2*C*C + 4*C*Ch) flops (C = 128, Ch = 512: 589,824) against 3*C*4 =
// 1.5 KB of stream traffic, about 380 flops per byte. The products must be
// fp32-accurate (the plain version and the TPU kernel sum fp32 products), so
// they run on the tensor cores as 3xTF32 (mma_tf32.cuh: three TF32 products a
// product, fp32 sums, about fp32's accuracy; one TF32 product would not hold
// the plain version's 1e-4): 165 TFLOP/s at most, 0.0146 ms at N = 8 x 512.
//
// What the design does about it. The TPU kernel keeps all weights resident
// in VMEM; in fp32 Wvp, W1 and W2 are 576 KB and a block has 227 KB of
// shared memory. So a block takes TM rows of each stream (T = 2*TM token
// rows), keeps the residual stream x, its normalised copy h and one GELU'd
// hidden chunk m in shared memory, and streams the weights, in
// torch's [out, in] layout as the module holds them (no transposed copy per
// call), as [128 x 32] chunks through a ring of four shared-memory stages
// filled with 16-byte cp.async: the copies of the next three chunks are in
// flight under the products of the current one, across the boundaries of
// the three products, with one block barrier a chunk. The MLP runs over the
// 512-wide hidden dimension in chunks of 128: each chunk's up-projection is
// GELU'd into m and at once multiplied into the down-projection's register
// accumulators, so the [T, 512] hidden activation never exists. Eight warps
// each own one stream's TM rows x 32 of every product's 128 outputs, split A
// and B into TF32 parts as they read them, and run mma.sync m16n8k8 three
// times a fragment pair, each pass swept over the warp's tile before the next
// so that the mma latency hides behind the tile's other accumulators
// (mma_tf32.cuh). Each operand costs a shared load and a split before
// its mma, instructions that compete with the mma for issue slots. So a
// warp's tile is 32 x 32 (each split operand feeds four or two
// fragment pairs), and the k order within each 16-deep step is permuted alike
// in A and B (a product sums over k in any order): physical columns 4t..4t+3
// hold what the two k-steps' fragments of lane t need, so one 16-byte load
// fetches them (rows padded to a stride of 16 mod 32 floats, so a quarter
// warp's 16-byte loads hit distinct banks). The row tile is sized for the card:
// T = 64 (TM = 32) where that still gives nine SMs in ten a block (N = 8 x
// 512 and up: 128 blocks), else T = 32: 64 blocks of 64 tokens would leave
// half the SMs idle at N = 8 x 256. Either way a block holds one SM. Rows
// past N read as zero and are never stored, so the ragged edge needs no
// padding.

//
// The bf16 instantiation (the fusion models in bf16: bf16 streams and output,
// fp32 parameters) computes in the stream's dtype at the Pallas kernel's
// rounding points: each elementwise op of the blend prologue and the
// residuals rounds to bf16 (__float2bfloat16_rn after each op, so no FMA
// contracts two of them), the LayerNorms keep fp32 statistics, scale and
// bias and round their output, the GELU is the fp32 erf form rounded, and
// each product takes bf16 operands with fp32 sums and rounds once, its bias
// then added in bf16: JAX's `preferred_element_type=f32` and `astype`, which
// is exactly mma.sync m16n8k16 with bf16 operands and fp32 accumulators. The
// weights are read in fp32 and rounded to bf16 as they are staged into
// shared memory, a whole [128 x 128] tile at a time (Wvp, then per hidden
// chunk W1's and W2's), double-buffered: the next tile's loads are in flight
// in registers under the current tile's products. The activations h and m
// are bf16 tiles; the residual stream x stays in fp32 storage holding bf16
// values. Bound on the H100: the same 2 * (2*C*C + 4*C*Ch) flops a row at
// the bf16 tensor-core rate (989 TFLOP/s), 0.0024 ms at N = 8 x 512.

#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int C = 128;          // channels; the wrapper checks
constexpr int NT = 256;         // threads per block: 8 warps
constexpr int NWARP = NT / 32;
constexpr int LDA = C + 16;     // padded row stride of the activation tiles (% 32 == 16)
constexpr int HC = 128;         // hidden chunk of the MLP
constexpr int KC = 32;          // depth of one weight chunk
constexpr int LDW = KC + 16;    // padded row stride of a weight chunk (% 32 == 16)
constexpr int NSTAGE = 4;       // weight chunks in the ring
constexpr int CHUNK = C * LDW;  // floats of one [128 x 32] chunk

static_assert(HC == C, "every product has 128 outputs");

// Shared memory of a block of T token rows: x, h, m and the weight ring.
template <int T>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (3 * T * LDA + NSTAGE * CHUNK);
}

struct TailArgs {
  const void* r;             // float or __nv_bfloat16, as the instantiation
  const void* d;
  const float* scale_r;
  const float* shift_r;
  const float* scale_d;
  const float* shift_d;
  const float* mask_r;
  const float* mask_d;
  const float* alpha;
  const float* norm1_scale;
  const float* norm1_bias;
  const float* wvp;          // [C, C], [out, in]
  const float* proj_bias;
  const float* norm2_scale;
  const float* norm2_bias;
  const float* mlp1_weight;  // [Ch, C], [out, in]
  const float* mlp1_bias;
  const float* mlp2_weight;  // [C, Ch], [out, in]
  const float* mlp2_bias;
  const float* norm_out_scale;
  const float* norm_out_bias;
  void* out;                 // the streams' type
  int n_rows;
  int hidden;
};

// Source of weight chunk c, in the order the block consumes them: Wvp's four
// (k 0..127), then per hidden chunk j W1's four (out rows 128j.., k 0..127)
// and W2's four (k 128j..). Each is 128 rows x 32 values of a row-major
// [rows, ldw] matrix.
__device__ __forceinline__ const float* chunk_src(const TailArgs& a, int c, int& ldw) {
  if (c < 4) {
    ldw = C;
    return a.wvp + c * KC;
  }
  const int j = (c - 4) / 8;
  const int r = (c - 4) % 8;
  if (r < 4) {
    ldw = C;
    return a.mlp1_weight + static_cast<size_t>(j) * HC * C + r * KC;
  }
  ldw = a.hidden;
  return a.mlp2_weight + j * HC + (r - 4) * KC;
}

// x rounded to bf16, held as a float: the rounding after each bf16 op.
__device__ __forceinline__ float rb(float x) { return r3d::round_to<__nv_bfloat16>(x); }

// Token row i of the tile's streams: (r, d) of global row row0 + i, blended
// when kBlend; rows past n_rows read as zero. In bf16 the blend rounds after
// every op, in the Pallas kernel's order.
template <bool kBlend, typename TIn>
__device__ __forceinline__ float2 load_pair(const TailArgs& a, long g, int c) {
  float r = 0.f;
  float d = 0.f;
  if (g < a.n_rows) {
    r = r3d::to_float(static_cast<const TIn*>(a.r)[g * C + c]);
    d = r3d::to_float(static_cast<const TIn*>(a.d)[g * C + c]);
  }
  if (!kBlend) return make_float2(r, d);
  if constexpr (sizeof(TIn) == 2) {
    const float al = rb(__ldg(a.alpha + c));
    const float mr = rb(__ldg(a.mask_r + c));
    const float md = rb(__ldg(a.mask_d + c));
    const float rn = rb(rb(r * rb(__ldg(a.scale_r + c))) + rb(__ldg(a.shift_r + c)));
    const float dn = rb(rb(d * rb(__ldg(a.scale_d + c))) + rb(__ldg(a.shift_d + c)));
    const float om = rb(1.f - al);
    return make_float2(rb(rb(mr * rb(rb(al * rn) + rb(om * dn))) + rb(rb(1.f - mr) * rn)),
                       rb(rb(md * rb(rb(al * dn) + rb(om * rn))) + rb(rb(1.f - md) * dn)));
  }
  const float rn = r * __ldg(a.scale_r + c) + __ldg(a.shift_r + c);
  const float dn = d * __ldg(a.scale_d + c) + __ldg(a.shift_d + c);
  const float al = __ldg(a.alpha + c);
  const float mr = __ldg(a.mask_r + c);
  const float md = __ldg(a.mask_d + c);
  return make_float2(mr * (al * rn + (1.f - al) * dn) + (1.f - mr) * rn,
                     md * (al * dn + (1.f - al) * rn) + (1.f - md) * dn);
}

// dst[row] = LN(src[row]) * scale + bias for this warp's T / 8 token rows,
// in dst's type (row stride LDD).
template <int T, int LDD = LDA, typename TOut>
__device__ __forceinline__ void layernorm_rows(const float* src, TOut* dst,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < T / NWARP; ++i) {
    const int row = warp * (T / NWARP) + i;
    float v[4];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = src[row * LDA + lane + 32 * j];
      s += v[j];
    }
    const float mu = r3d::warp_sum(s) * (1.f / C);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float dv = v[j] - mu;
      q = fmaf(dv, dv, q);
    }
    const float inv = rsqrtf(r3d::warp_sum(q) * (1.f / C) + 1e-5f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      dst[row * LDD + c] =
          r3d::from_float<TOut>((v[j] - mu) * inv * __ldg(scale + c) + __ldg(bias + c));
    }
  }
}

// The warp layout of a block of T token rows: warp w owns the rows of one
// stream (w / 4: TM rows, MT m-tiles) x 32 of the 128 outputs (w % 4: NTW
// n-tiles) of every product.
template <int T>
struct Layout {
  static constexpr int TM = T / 2;    // rows of each stream
  static constexpr int MT = TM / 16;  // m-tiles of a warp
  static constexpr int NTW = 4;       // n-tiles of a warp
};
static_assert(NWARP == 2 * C / 32, "two streams x 32-column slices");

template <int MT, int NTW>
__device__ __forceinline__ void zero(float (&acc)[MT][NTW][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
}

// Copy weight chunk c (if it exists) into its stage of the ring, one commit
// group either way.
__device__ __forceinline__ void issue_chunk(const TailArgs& a, float* ring, int c, int n_chunks) {
  if (c < n_chunks) {
    int ldw;
    const float* src = chunk_src(a, c, ldw);
    float* ws = ring + (c % NSTAGE) * CHUNK;
    for (int idx = threadIdx.x; idx < C * (KC / 4); idx += NT) {
      const int n = idx / (KC / 4);
      const int k4 = (idx % (KC / 4)) * 4;
      r3d::cp_async16(ws + n * LDW + k4, src + static_cast<size_t>(n) * ldw + k4, true);
    }
  }
  r3d::cp_async_commit();
}

// acc += A W^T over the four chunks from `cur` on (one product of depth
// 128), A the [T, LDA] tile; with kSwap each row reads the other stream's
// row. Each chunk's wait and barrier also issues the copy of chunk
// cur + NSTAGE - 1 into the stage of cur - 1. Within a 16-deep step, k-step
// s of lane t takes k = 4t + 2s into its fragments' first k slot (a0, a1;
// b0) and 4t + 2s + 1 into the second (a2, a3; b1).
template <int T, bool kSwap>
__device__ __forceinline__ void gemm(const TailArgs& a, const float* A, float* ring, int& cur,
                                     int n_chunks, int row0, int col0,
                                     float (&acc)[Layout<T>::MT][Layout<T>::NTW][4]) {
  constexpr int MT = Layout<T>::MT;
  constexpr int NTW = Layout<T>::NTW;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 1
  for (int kc = 0; kc < 4; ++kc, ++cur) {
    r3d::cp_async_wait<NSTAGE - 2>();
    __syncthreads();   // chunk `cur` has landed; every thread is done with `cur - 1`
    issue_chunk(a, ring, cur + NSTAGE - 1, n_chunks);
    const float* ws = ring + (cur % NSTAGE) * CHUNK;
#pragma unroll
    for (int k16 = 0; k16 < KC; k16 += 16) {
      uint32_t a_hi[2][MT][4], a_lo[2][MT][4];     // [k-step][m-tile][fragment]
      uint32_t b_hi[2][NTW][2], b_lo[2][NTW][2];   // [k-step][n-tile][fragment]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = kSwap ? (row0 + mt * 16 + Layout<T>::TM) % T : row0 + mt * 16;
        const float* p = A + (r + g) * LDA + kc * KC + k16 + 4 * t;
        const float4 top = *reinterpret_cast<const float4*>(p);
        const float4 bot = *reinterpret_cast<const float4*>(p + 8 * LDA);
        r3d::split_tf32(top.x, a_hi[0][mt][0], a_lo[0][mt][0]);
        r3d::split_tf32(bot.x, a_hi[0][mt][1], a_lo[0][mt][1]);
        r3d::split_tf32(top.y, a_hi[0][mt][2], a_lo[0][mt][2]);
        r3d::split_tf32(bot.y, a_hi[0][mt][3], a_lo[0][mt][3]);
        r3d::split_tf32(top.z, a_hi[1][mt][0], a_lo[1][mt][0]);
        r3d::split_tf32(bot.z, a_hi[1][mt][1], a_lo[1][mt][1]);
        r3d::split_tf32(top.w, a_hi[1][mt][2], a_lo[1][mt][2]);
        r3d::split_tf32(bot.w, a_hi[1][mt][3], a_lo[1][mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const float4 w =
            *reinterpret_cast<const float4*>(ws + (col0 + nt * 8 + g) * LDW + k16 + 4 * t);
        r3d::split_tf32(w.x, b_hi[0][nt][0], b_lo[0][nt][0]);
        r3d::split_tf32(w.y, b_hi[0][nt][1], b_lo[0][nt][1]);
        r3d::split_tf32(w.z, b_hi[1][nt][0], b_lo[1][nt][0]);
        r3d::split_tf32(w.w, b_hi[1][nt][1], b_lo[1][nt][1]);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) r3d::mma_3xtf32(acc, a_hi[ks], a_lo[ks], b_hi[ks], b_lo[ks]);
    }
  }
}

template <bool kBlend, bool kOuterResidual, int T>
__global__ void __launch_bounds__(NT, 1) fuser_tail_tf32_kernel(const TailArgs a) {
  using L = Layout<T>;
  constexpr int TM = L::TM;
  constexpr int MT = L::MT;
  constexpr int NTW = L::NTW;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [T, LDA] residual stream
  float* hs = xs + T * LDA;                      // [T, LDA] normalised stream
  float* ms = hs + T * LDA;                      // [T, LDA] GELU(hidden chunk)
  float* ring = ms + T * LDA;                    // NSTAGE x [C, LDW] weight chunks
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (warp / 4) * TM;    // the warp's first token row
  const int col0 = (warp % 4) * 32;    // and first output column
  const long grow0 = static_cast<long>(blockIdx.x) * TM;
  const int n_chunks = 4 + 8 * (a.hidden / HC);
  // element e of this thread's accumulator tile (mt, nt) is at row
  // row0 + mt*16 + g + (e / 2)*8, column col0 + nt*8 + 2t + e % 2

  int cur = 0;   // the next weight chunk to use
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) issue_chunk(a, ring, c, n_chunks);   // under the input loads

  // 1. the input rows (BN affine + bottom-k alpha blend when kBlend)
  for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
    const int i = idx / C;
    const int c = idx % C;
    const float2 rd = load_pair<kBlend, float>(a, grow0 + i, c);
    xs[i * LDA + c] = rd.x;
    xs[(i + TM) * LDA + c] = rd.y;
  }
  __syncthreads();

  // 2. exact two-token attention as a value swap: x_r += LN1(x_d) Wvp^T + b
  layernorm_rows<T>(xs, hs, a.norm1_scale, a.norm1_bias);
  float acc[MT][NTW][4];
  zero<MT, NTW>(acc);
  gemm<T, true>(a, hs, ring, cur, n_chunks, row0, col0, acc);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = col0 + nt * 8 + 2 * t;
      const float2 b = make_float2(__ldg(a.proj_bias + col), __ldg(a.proj_bias + col + 1));
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float2* x = reinterpret_cast<float2*>(xs + (row0 + mt * 16 + g + hi * 8) * LDA + col);
        const float2 v = *x;
        *x = make_float2((v.x + acc[mt][nt][2 * hi]) + b.x, (v.y + acc[mt][nt][2 * hi + 1]) + b.y);
      }
    }
  }
  __syncthreads();

  // 3. MLP over hidden chunks: acc2 = W2 GELU(W1 LN2(x) + b1)
  layernorm_rows<T>(xs, hs, a.norm2_scale, a.norm2_bias);
  float acc2[MT][NTW][4];
  zero<MT, NTW>(acc2);
  for (int h0 = 0; h0 < a.hidden; h0 += HC) {
    zero<MT, NTW>(acc);
    gemm<T, false>(a, hs, ring, cur, n_chunks, row0, col0, acc);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int col = col0 + nt * 8 + 2 * t;
        const float2 b = make_float2(__ldg(a.mlp1_bias + h0 + col), __ldg(a.mlp1_bias + h0 + col + 1));
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float m0 = acc[mt][nt][2 * hi] + b.x;
          const float m1 = acc[mt][nt][2 * hi + 1] + b.y;
          *reinterpret_cast<float2*>(ms + (row0 + mt * 16 + g + hi * 8) * LDA + col) =
              make_float2(0.5f * m0 * (1.f + erff(m0 * 0.7071067811865476f)),
                          0.5f * m1 * (1.f + erff(m1 * 0.7071067811865476f)));
        }
      }
    }
    gemm<T, false>(a, ms, ring, cur, n_chunks, row0, col0, acc2);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = col0 + nt * 8 + 2 * t;
      const float2 b = make_float2(__ldg(a.mlp2_bias + col), __ldg(a.mlp2_bias + col + 1));
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float2* x = reinterpret_cast<float2*>(xs + (row0 + mt * 16 + g + hi * 8) * LDA + col);
        const float2 v = *x;
        *x = make_float2(v.x + (acc2[mt][nt][2 * hi] + b.x), v.y + (acc2[mt][nt][2 * hi + 1] + b.y));
      }
    }
  }
  __syncthreads();
  if (kOuterResidual) {
    for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
      const int i = idx / C;
      const int c = idx % C;
      const float2 rd = load_pair<kBlend, float>(a, grow0 + i, c);
      xs[i * LDA + c] += rd.x;
      xs[(i + TM) * LDA + c] += rd.y;
    }
    __syncthreads();
  }

  // 4. out = (LN_out(x_r) + LN_out(x_d)) / 2
  layernorm_rows<T>(xs, hs, a.norm_out_scale, a.norm_out_bias);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
    const int i = idx / C;
    const int c = idx % C;
    const long gr = grow0 + i;
    if (gr < a.n_rows) {
      static_cast<float*>(a.out)[gr * C + c] = 0.5f * (hs[i * LDA + c] + hs[(i + TM) * LDA + c]);
    }
  }
  r3d::cp_async_wait<0>();
}

// ---- the bf16 instantiation ----

constexpr int LDH = C + 8;      // bf16 row stride of h, m and a weight tile (68 words, % 32 == 4)
constexpr int WTILE = C * LDH;  // bf16 values of one staged [128 x 128] weight tile
constexpr int PRE = C * C / 4 / NT;   // float4 loads of a weight tile a thread takes

static_assert(PRE * NT * 4 == C * C, "a weight tile splits evenly over the threads");

template <int T>
constexpr int smem_bytes_bf16() {
  return static_cast<int>(sizeof(float)) * T * LDA +
         static_cast<int>(sizeof(__nv_bfloat16)) * (2 * T * LDH + 2 * WTILE);
}

// Weight tile c in the order the block consumes them: Wvp, then per hidden
// chunk j W1's rows 128j.. (k 0..127) and W2's columns 128j.. Each is 128
// rows x 128 values of a row-major [rows, ldw] fp32 matrix.
__device__ __forceinline__ const float* tile_src(const TailArgs& a, int c, int& ldw) {
  if (c == 0) {
    ldw = C;
    return a.wvp;
  }
  const int j = (c - 1) / 2;
  if ((c - 1) % 2 == 0) {
    ldw = C;
    return a.mlp1_weight + static_cast<size_t>(j) * HC * C;
  }
  ldw = a.hidden;
  return a.mlp2_weight + j * HC;
}

// Issue this thread's loads of weight tile c (if it exists) into registers.
__device__ __forceinline__ void load_tile(const TailArgs& a, int c, int n_tiles,
                                          float4 (&v)[PRE]) {
  if (c >= n_tiles) return;
  int ldw;
  const float* src = tile_src(a, c, ldw);
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int idx = threadIdx.x + i * NT;
    v[i] = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(idx >> 5) * ldw +
                                                 (idx & 31) * 4));
  }
}

// Round the loaded tile to bf16 into a [C, LDH] buffer.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, int c, int n_tiles,
                                           const float4 (&v)[PRE]) {
  if (c >= n_tiles) return;
#pragma unroll
  for (int i = 0; i < PRE; ++i) {
    const int idx = threadIdx.x + i * NT;
    *reinterpret_cast<uint2*>(dst + (idx >> 5) * LDH + (idx & 31) * 4) =
        make_uint2(r3d::pack_bf16(v[i].x, v[i].y), r3d::pack_bf16(v[i].z, v[i].w));
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += A W^T, A a bf16 [T, LDH] tile and W a staged [128 out, LDH] tile,
// depth 128 on mma.sync m16n8k16; with kSwap each row reads the other
// stream's row.
template <int T, bool kSwap>
__device__ __forceinline__ void gemm_bf16(const __nv_bfloat16* A, const __nv_bfloat16* W,
                                          int row0, int col0,
                                          float (&acc)[Layout<T>::MT][Layout<T>::NTW][4]) {
  constexpr int MT = Layout<T>::MT;
  constexpr int NTW = Layout<T>::NTW;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = kSwap ? (row0 + mt * 16 + Layout<T>::TM) % T : row0 + mt * 16;
      const __nv_bfloat16* p = A + (r + g) * LDH + ks * 16 + 2 * t;
      af[mt][0] = ld32(p);
      af[mt][1] = ld32(p + 8 * LDH);
      af[mt][2] = ld32(p + 8);
      af[mt][3] = ld32(p + 8 * LDH + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const __nv_bfloat16* q = W + (col0 + nt * 8 + g) * LDH + ks * 16 + 2 * t;
      const uint32_t b0 = ld32(q);
      const uint32_t b1 = ld32(q + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) r3d::mma_bf16(acc[mt][nt], af[mt], b0, b1);
    }
  }
}

template <bool kBlend, bool kOuterResidual, int T>
__global__ void __launch_bounds__(NT, 1) fuser_tail_bf16_kernel(const TailArgs a) {
  using L = Layout<T>;
  using bf16 = __nv_bfloat16;
  constexpr int TM = L::TM;
  constexpr int MT = L::MT;
  constexpr int NTW = L::NTW;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);      // [T, LDA] residual stream (bf16 values)
  bf16* hs = reinterpret_cast<bf16*>(xs + T * LDA);  // [T, LDH] normalised stream
  bf16* ms = hs + T * LDH;                           // [T, LDH] GELU(hidden chunk)
  bf16* wb = ms + T * LDH;                           // 2 x [C, LDH] weight tiles
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = (warp / 4) * TM;
  const int col0 = (warp % 4) * 32;
  const long grow0 = static_cast<long>(blockIdx.x) * TM;
  const int nj = a.hidden / HC;
  const int n_tiles = 1 + 2 * nj;
  // element e of accumulator tile (mt, nt) is at row row0 + mt*16 + g +
  // (e / 2)*8, column col0 + nt*8 + 2t + e % 2

  float4 pre[PRE];
  load_tile(a, 0, n_tiles, pre);

  // 1. the input rows (BN affine + bottom-k alpha blend when kBlend)
  for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
    const int i = idx / C;
    const int c = idx % C;
    const float2 rd = load_pair<kBlend, bf16>(a, grow0 + i, c);
    xs[i * LDA + c] = rd.x;
    xs[(i + TM) * LDA + c] = rd.y;
  }
  store_tile(wb, 0, n_tiles, pre);
  __syncthreads();

  // 2. exact two-token attention as a value swap: x_r += LN1(x_d) Wvp^T + b
  layernorm_rows<T, LDH>(xs, hs, a.norm1_scale, a.norm1_bias);
  __syncthreads();
  float acc[MT][NTW][4];
  zero<MT, NTW>(acc);
  load_tile(a, 1, n_tiles, pre);
  gemm_bf16<T, true>(hs, wb, row0, col0, acc);
  store_tile(wb + WTILE, 1, n_tiles, pre);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = col0 + nt * 8 + 2 * t;
      const float b0 = rb(__ldg(a.proj_bias + col));
      const float b1 = rb(__ldg(a.proj_bias + col + 1));
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float2* x = reinterpret_cast<float2*>(xs + (row0 + mt * 16 + g + hi * 8) * LDA + col);
        const float2 v = *x;
        *x = make_float2(rb(rb(v.x + rb(acc[mt][nt][2 * hi])) + b0),
                         rb(rb(v.y + rb(acc[mt][nt][2 * hi + 1])) + b1));
      }
    }
  }
  __syncthreads();

  // 3. MLP over hidden chunks: acc2 = W2 GELU(W1 LN2(x) + b1)
  layernorm_rows<T, LDH>(xs, hs, a.norm2_scale, a.norm2_bias);
  __syncthreads();
  float acc2[MT][NTW][4];
  zero<MT, NTW>(acc2);
  for (int j = 0; j < nj; ++j) {
    const int c = 1 + 2 * j;   // W1's tile, in buffer c % 2; W2's next
    zero<MT, NTW>(acc);
    load_tile(a, c + 1, n_tiles, pre);
    gemm_bf16<T, false>(hs, wb + (c & 1) * WTILE, row0, col0, acc);
    store_tile(wb + ((c + 1) & 1) * WTILE, c + 1, n_tiles, pre);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        const int col = col0 + nt * 8 + 2 * t;
        const float b0 = rb(__ldg(a.mlp1_bias + j * HC + col));
        const float b1 = rb(__ldg(a.mlp1_bias + j * HC + col + 1));
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float m0 = rb(rb(acc[mt][nt][2 * hi]) + b0);
          const float m1 = rb(rb(acc[mt][nt][2 * hi + 1]) + b1);
          *reinterpret_cast<uint32_t*>(ms + (row0 + mt * 16 + g + hi * 8) * LDH + col) =
              r3d::pack_bf16(0.5f * m0 * (1.f + erff(m0 * 0.7071067811865476f)),
                             0.5f * m1 * (1.f + erff(m1 * 0.7071067811865476f)));
        }
      }
    }
    __syncthreads();   // m complete; W2's tile staged; every warp done with W1's
    load_tile(a, c + 2, n_tiles, pre);
    gemm_bf16<T, false>(ms, wb + ((c + 1) & 1) * WTILE, row0, col0, acc2);
    store_tile(wb + (c & 1) * WTILE, c + 2, n_tiles, pre);
    __syncthreads();   // every warp done with m and W2's tile; the next W1 staged
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = col0 + nt * 8 + 2 * t;
      const float b0 = rb(__ldg(a.mlp2_bias + col));
      const float b1 = rb(__ldg(a.mlp2_bias + col + 1));
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        float2* x = reinterpret_cast<float2*>(xs + (row0 + mt * 16 + g + hi * 8) * LDA + col);
        const float2 v = *x;
        *x = make_float2(rb(v.x + rb(rb(acc2[mt][nt][2 * hi]) + b0)),
                         rb(v.y + rb(rb(acc2[mt][nt][2 * hi + 1]) + b1)));
      }
    }
  }
  __syncthreads();
  if (kOuterResidual) {
    for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
      const int i = idx / C;
      const int c = idx % C;
      const float2 rd = load_pair<kBlend, bf16>(a, grow0 + i, c);
      xs[i * LDA + c] = rb(xs[i * LDA + c] + rd.x);
      xs[(i + TM) * LDA + c] = rb(xs[(i + TM) * LDA + c] + rd.y);
    }
    __syncthreads();
  }

  // 4. out = (LN_out(x_r) + LN_out(x_d)) / 2, each LN rounded to bf16
  layernorm_rows<T, LDH>(xs, hs, a.norm_out_scale, a.norm_out_bias);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
    const int i = idx / C;
    const int c = idx % C;
    const long gr = grow0 + i;
    if (gr < a.n_rows) {
      static_cast<bf16*>(a.out)[gr * C + c] = __float2bfloat16_rn(
          0.5f * (__bfloat162float(hs[i * LDH + c]) + __bfloat162float(hs[(i + TM) * LDH + c])));
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = 0;
    }
  }
  return n;
}

// Token rows a block takes at n_rows: 64 (half the weight traffic and
// fewer operand splits an mma than 32) where that still gives nine SMs in
// ten a block, else 32.
int tile_rows(int n_rows) { return 10 * ((n_rows + 31) / 32) >= 9 * sm_count() ? 64 : 32; }

template <bool kBlend, bool kOuterResidual, int T, bool kBf16>
int launch_t(const TailArgs& a, cudaStream_t stream) {
  constexpr int smem = kBf16 ? smem_bytes_bf16<T>() : smem_bytes<T>();
  auto kernel = kBf16 ? fuser_tail_bf16_kernel<kBlend, kOuterResidual, T>
                      : fuser_tail_tf32_kernel<kBlend, kOuterResidual, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(a.n_rows + T / 2 - 1) / (T / 2), NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBlend, bool kBf16 = false>
int launch(const TailArgs& a, bool outer_residual, void* stream) {
  if (a.hidden <= 0 || a.hidden % HC != 0 || a.n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n_rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows(a.n_rows) == 64) {
    return outer_residual ? launch_t<kBlend, true, 64, kBf16>(a, s)
                          : launch_t<kBlend, false, 64, kBf16>(a, s);
  }
  return outer_residual ? launch_t<kBlend, true, 32, kBf16>(a, s)
                        : launch_t<kBlend, false, 32, kBf16>(a, s);
}

template <typename Kernel>
int occupancy(Kernel kernel, int smem, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, NT, smem);
  }
  return static_cast<int>(err);
}

}  // namespace

// The blend route: raw streams r, d [N, C], the folded BN affine and blend
// vectors [C], the tail's parameters; out [N, C]. All fp32 and contiguous.
extern "C" int r3d_fused_bn_blend_tail(
    const float* r, const float* d, const float* scale_r, const float* shift_r,
    const float* scale_d, const float* shift_d, const float* mask_r, const float* mask_d,
    const float* alpha, const float* norm1_scale, const float* norm1_bias, const float* wvp,
    const float* proj_bias, const float* norm2_scale, const float* norm2_bias,
    const float* mlp1_weight, const float* mlp1_bias, const float* mlp2_weight,
    const float* mlp2_bias, const float* norm_out_scale, const float* norm_out_bias,
    float* out, int n_rows, int channels, int hidden, int outer_residual, void* stream) {
  if (channels != C) return static_cast<int>(cudaErrorInvalidValue);
  const TailArgs a{r, d, scale_r, shift_r, scale_d, shift_d, mask_r, mask_d, alpha,
                   norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale, norm2_bias,
                   mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias, norm_out_scale,
                   norm_out_bias, out, n_rows, hidden};
  return launch<true>(a, outer_residual != 0, stream);
}

// The no-blend route: the tail on already blended streams r, d [N, C].
extern "C" int r3d_fused_safuser_tail(
    const float* r, const float* d, const float* norm1_scale, const float* norm1_bias,
    const float* wvp, const float* proj_bias, const float* norm2_scale,
    const float* norm2_bias, const float* mlp1_weight, const float* mlp1_bias,
    const float* mlp2_weight, const float* mlp2_bias, const float* norm_out_scale,
    const float* norm_out_bias, float* out, int n_rows, int channels, int hidden,
    int outer_residual, void* stream) {
  if (channels != C) return static_cast<int>(cudaErrorInvalidValue);
  const TailArgs a{r, d, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale, norm2_bias,
                   mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias, norm_out_scale,
                   norm_out_bias, out, n_rows, hidden};
  return launch<false>(a, outer_residual != 0, stream);
}

// The bf16 instantiations: the same arguments with bf16 streams r, d and
// output, the parameters and blend vectors fp32.
extern "C" int r3d_fused_bn_blend_tail_bf16(
    const void* r, const void* d, const float* scale_r, const float* shift_r,
    const float* scale_d, const float* shift_d, const float* mask_r, const float* mask_d,
    const float* alpha, const float* norm1_scale, const float* norm1_bias, const float* wvp,
    const float* proj_bias, const float* norm2_scale, const float* norm2_bias,
    const float* mlp1_weight, const float* mlp1_bias, const float* mlp2_weight,
    const float* mlp2_bias, const float* norm_out_scale, const float* norm_out_bias,
    void* out, int n_rows, int channels, int hidden, int outer_residual, void* stream) {
  if (channels != C) return static_cast<int>(cudaErrorInvalidValue);
  const TailArgs a{r, d, scale_r, shift_r, scale_d, shift_d, mask_r, mask_d, alpha,
                   norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale, norm2_bias,
                   mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias, norm_out_scale,
                   norm_out_bias, out, n_rows, hidden};
  return launch<true, true>(a, outer_residual != 0, stream);
}

extern "C" int r3d_fused_safuser_tail_bf16(
    const void* r, const void* d, const float* norm1_scale, const float* norm1_bias,
    const float* wvp, const float* proj_bias, const float* norm2_scale,
    const float* norm2_bias, const float* mlp1_weight, const float* mlp1_bias,
    const float* mlp2_weight, const float* mlp2_bias, const float* norm_out_scale,
    const float* norm_out_bias, void* out, int n_rows, int channels, int hidden,
    int outer_residual, void* stream) {
  if (channels != C) return static_cast<int>(cudaErrorInvalidValue);
  const TailArgs a{r, d, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale, norm2_bias,
                   mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias, norm_out_scale,
                   norm_out_bias, out, n_rows, hidden};
  return launch<false, true>(a, outer_residual != 0, stream);
}

// The launch shape at n_rows: rows of each stream a block takes, blocks, and
// the blocks that fit one SM at once (the blend route, no outer residual).
extern "C" int r3d_fuser_tail_config(int n_rows, int* rows_per_block, int* blocks,
                                     int* blocks_per_sm) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int T = tile_rows(n_rows);
  *rows_per_block = T / 2;
  *blocks = (n_rows + T / 2 - 1) / (T / 2);
  return T == 64 ? occupancy(fuser_tail_tf32_kernel<true, false, 64>, smem_bytes<64>(), blocks_per_sm)
                 : occupancy(fuser_tail_tf32_kernel<true, false, 32>, smem_bytes<32>(), blocks_per_sm);
}

