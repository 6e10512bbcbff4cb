// Backward of the SA-Fuser tail: dr, dd and the 12 parameter gradients.
//
// Replaces the Pallas kernel r3d_tpu/ops/fuser_kernel_bwd.py:70 `_bwd_kernel`
// (launched by `pallas_tail_bwd`, pallas_call at :212), the backward that
// `fused_safuser_tail` runs in training epoch 0. Forward, per row of the
// streams r, d [N, C] (C = 128, hidden Ch = 512, LN eps 1e-5):
//
//   h_* = LN1(*)            x_r = r + h_d Wvp^T + bp     x_d = d + h_r Wvp^T + bp
//   u_* = LN2(x_*)          z_* = u_* W1^T + b1          p_* = GELU(z_*)
//   y_* = x_* + p_* W2^T + b2 (+ the input with the outer residual)
//   out = (LN_out(y_r) + LN_out(y_d)) / 2
//
// and, with g the cotangent of out and g/2 that of each LN_out:
//
//   LN backward  dx = rstd * (gh - mean(gh) - xhat * mean(gh * xhat)), gh = g*gamma;
//                dgamma += sum_rows g*xhat, dbeta += sum_rows g
//   GELU'(z)     = 0.5*(1 + erf(z/sqrt2)) + z*exp(-z^2/2)/sqrt(2 pi)
//
// What bounds it on the H100: operations. Per token row the forward is
// recomputed (the Wvp, W1 and W2 products), the backward runs three more
// (dm W2, dz W1, dx Wvp), and the three weight gradients are outer products
// summed over the 2N token rows: about 6 * N * (2*C*C + 4*C*Ch) flops, 7.25
// GFLOP at N = 4,096 (the up-projection counted once). The products must be
// fp32-accurate (the plain version sums fp32 products; one TF32 pass misses
// 1e-4), so they run as 3xTF32 on the tensor cores (mma_tf32.cuh), 165
// TFLOP/s at most: 0.044 ms, against 5*N*C*4 = 10.5 MB of stream traffic.
//
// What the design does about it: two phases in one call of four launches,
// every product on 3xTF32 mma.sync, no memset, no read-modify-write of a
// gradient in device memory, every sum over rows in a fixed order (two calls
// agree bit for bit).
// 0. transpose_weights_kernel copies Wvp, W1 and W2 transposed (576 KB),
//    so that every product of the row phase is A W^T with W row-major, as
//    K1 streams its weights (fuser_tail.cu).
// 1. fuser_tail_bwd_rows_kernel: one block per tile of T token rows (TM
//    rows of each stream; T = 64 where that gives nine SMs in ten a block,
//    else 32, as K1). It recomputes the forward with the up-projection done
//    once per row (z, GELU(z) and GELU'(z) from one product, as the TPU
//    kernel does), runs the backward to dr and dd, and leaves the operands
//    of the weight gradients in a scratch of token rows: p and dz [R, Ch],
//    dm, u, dx and the swapped h1 [R, C] (R = tiles x T; the tile's rows in
//    order, r's then d's; rows past N are zeros and weigh nothing). The
//    column sums of each half of a tile (the 9 vector gradients) go to its
//    own row of a scratch [tiles, 2, 8C + Ch]. Eight warps each own one
//    stream's TM rows x 32 of every product's 128 outputs; the weights
//    stream as [128 x 32] chunks through a ring of three shared-memory
//    stages filled with cp.async (the copies of the next two chunks in
//    flight under the products of this one, across product boundaries; a
//    fourth stage, of unpadded swizzled chunks, measured no faster). Four
//    activation tiles take the rest of the shared memory, so GELU'(z) waits
//    in the dz scratch slot for the backward, which overwrites it with dz.
// 2. fuser_tail_wgrad_kernel: dW2 = dm^T p, dW1 = dz^T u and dWvp = dx^T
//    swap(h1) as 128 x 128 output tiles (2 Ch / 128 + 1 of them) times
//    splits of the R token rows (whole chunks of 32 rows, as many splits as
//    fill the card once), each block a 3xTF32 product over its rows, its
//    partial written once.
// 3. fuser_tail_bwd_sum_kernel sums the splits' partials in split order and
//    the tiles' column sums in a fixed order into the 12 gradients.
//
// The bf16 instantiation (the fusion models in bf16) reads bf16 r, d and g
// and writes bf16 dr and dd; everything between is the fp32 body above, as
// the TPU kernel upcasts its inputs and computes in fp32. The parameter
// gradients stay fp32.

#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int C = 128;          // channels; the launcher checks
constexpr int NT = 256;         // threads per block: 8 warps
constexpr int NWARP = NT / 32;
constexpr int LDA = C + 16;     // padded row stride of the activation tiles (% 32 == 16)
constexpr int HC = 128;         // hidden chunk of the MLP
constexpr int KC = 32;          // depth of one weight chunk
constexpr int LDW = KC + 16;    // padded row stride of a weight chunk (% 32 == 16)
constexpr int NSTAGE = 3;       // weight chunks in the ring
constexpr int CHUNK = C * LDW;  // floats of one [128 x 32] chunk
constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

static_assert(HC == C, "every product has 128 outputs");
static_assert(NWARP == 2 * C / 32, "two streams x 32-column slices");

// Offsets of the vector gradients in one tile's row of the column-sum
// scratch: eight [C] vectors, then db1 [Ch].
enum ColSum { kN1s = 0, kN1b = C, kPb = 2 * C, kN2s = 3 * C, kN2b = 4 * C, kB2 = 5 * C,
              kNos = 6 * C, kNob = 7 * C, kB1 = 8 * C };

// Shared memory of a block of T token rows: four activation tiles, the
// ring and three [T] vectors of 1/std.
template <int T>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (4 * T * LDA + NSTAGE * CHUNK + 3 * T);
}

struct BwdArgs {
  const void* r;             // float or __nv_bfloat16, as the instantiation
  const void* d;
  const void* g;
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
  const float* w2t;          // W2^T [Ch, C]
  const float* w1t;          // W1^T [C, Ch]
  const float* wvpt;         // Wvp^T [C, C]
  void* dr;                  // the streams' type
  void* dd;
  float* p;                  // [R, Ch] GELU(z)
  float* dz;                 // [R, Ch] GELU'(z), then dz
  float* dm;                 // [R, C] the cotangent of the MLP's output
  float* u;                  // [R, C] LN2's output
  float* dx;                 // [R, C] the cotangent of x
  float* h1s;                // [R, C] LN1's output of the other stream's row
  float* cs;                 // [tiles, 2, 8C + Ch] column sums of each half of a tile
  int n_rows;
  int hidden;
};

// Offsets of the gradients in the flat output (FuserTailParams order).
struct Layout {
  int n1s, n1b, wvp, pb, n2s, n2b, w1, b1, w2, b2, nos, nob, total;
  __host__ __device__ explicit Layout(int ch) {
    n1s = 0;
    n1b = n1s + C;
    wvp = n1b + C;
    pb = wvp + C * C;
    n2s = pb + C;
    n2b = n2s + C;
    w1 = n2b + C;
    b1 = w1 + ch * C;
    w2 = b1 + ch;
    b2 = w2 + C * ch;
    nos = b2 + C;
    nob = nos + C;
    total = nob + C;
  }
};

// ---- 0. the transposed weights ----

// wt = [W2^T [Ch, C], W1^T [C, Ch], Wvp^T [C, C]]; one block per 32 x 32
// tile of a source matrix, through shared memory.
__global__ void __launch_bounds__(256) transpose_weights_kernel(
    const float* __restrict__ wvp, const float* __restrict__ w1, const float* __restrict__ w2,
    float* __restrict__ wt, int hidden) {
  __shared__ float tile[32][33];
  const int n2 = (C / 32) * (hidden / 32);   // tiles of W2, and of W1
  int b = blockIdx.x;
  const float* src;
  float* dst;
  int cols;   // of the source; its rows are the destination's columns
  int rows;
  if (b < n2) {
    src = w2, dst = wt, rows = C, cols = hidden;
  } else if (b < 2 * n2) {
    b -= n2;
    src = w1, dst = wt + hidden * C, rows = hidden, cols = C;
  } else {
    b -= 2 * n2;
    src = wvp, dst = wt + 2 * hidden * C, rows = C, cols = C;
  }
  const int r0 = (b / (cols / 32)) * 32;
  const int c0 = (b % (cols / 32)) * 32;
  const int x = threadIdx.x & 31;
  for (int y = threadIdx.x >> 5; y < 32; y += 8) {
    tile[y][x] = src[static_cast<size_t>(r0 + y) * cols + c0 + x];
  }
  __syncthreads();
  for (int y = threadIdx.x >> 5; y < 32; y += 8) {
    dst[static_cast<size_t>(c0 + y) * rows + r0 + x] = tile[x][y];
  }
}

// ---- 1. the row phase ----

// The warp layout of a block of T token rows: warp w owns the rows of one
// stream (w / 4: TM rows, MT m-tiles) x 32 of the 128 outputs (w % 4: NTW
// n-tiles) of every product; for the row-wise steps (LayerNorm, its
// backward) warp w owns rows RPW*w .. RPW*w + RPW - 1.
template <int T>
struct Tile {
  static constexpr int TM = T / 2;     // rows of each stream
  static constexpr int MT = TM / 16;   // m-tiles of a warp
  static constexpr int NTW = 4;        // n-tiles of a warp
  static constexpr int RPW = T / NWARP;
};

template <int T>
using Acc = float[Tile<T>::MT][Tile<T>::NTW][4];

template <int T>
__device__ __forceinline__ void zero(Acc<T>& acc) {
#pragma unroll
  for (int mt = 0; mt < Tile<T>::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < Tile<T>::NTW; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
}

// f(row, col, acc[..][2*hi], acc[..][2*hi + 1]) for each pair of this
// thread's accumulator: tile (mt, nt) element e is at row row0 + mt*16 + g +
// (e / 2)*8, column col0 + nt*8 + 2t + e % 2.
template <int T, typename F>
__device__ __forceinline__ void each_pair(Acc<T>& acc, int row0, int col0, F f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < Tile<T>::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < Tile<T>::NTW; ++nt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        f(row0 + mt * 16 + g + hi * 8, col0 + nt * 8 + 2 * t, acc[mt][nt][2 * hi],
          acc[mt][nt][2 * hi + 1]);
      }
    }
  }
}

// Source of weight chunk c, in the order a block consumes them, each 128
// rows x 32 values of a row-major [rows, ldw] matrix: the forward's Wvp (4
// chunks, k 0..127), per hidden chunk j W1's four (out rows 128j.., k
// 0..127) and W2's four (k 128j..); the backward's per hidden chunk j
// W2^T's four (out rows 128j..) and W1^T's four (k 128j..), then Wvp^T's.
__device__ __forceinline__ const float* chunk_src(const BwdArgs& a, int c, int& ldw) {
  const int nj = a.hidden / HC;
  ldw = C;
  if (c < 4) return a.wvp + c * KC;
  c -= 4;
  if (c < 8 * nj) {
    const int j = c / 8, r = c % 8;
    if (r < 4) return a.mlp1_weight + static_cast<size_t>(j) * HC * C + r * KC;
    ldw = a.hidden;
    return a.mlp2_weight + j * HC + (r - 4) * KC;
  }
  c -= 8 * nj;
  if (c < 8 * nj) {
    const int j = c / 8, r = c % 8;
    if (r < 4) return a.w2t + static_cast<size_t>(j) * HC * C + r * KC;
    ldw = a.hidden;
    return a.w1t + j * HC + (r - 4) * KC;
  }
  return a.wvpt + (c - 8 * nj) * KC;
}

// Copy weight chunk c (if it exists) into its stage of the ring, one commit
// group either way.
__device__ __forceinline__ void issue_chunk(const BwdArgs& a, float* ring, int c, int n_chunks) {
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
// b0) and 4t + 2s + 1 into the second (a2, a3; b1), so one 16-byte load
// fetches an operand's two k-steps (as fuser_tail.cu).
template <int T, bool kSwap>
__device__ __forceinline__ void gemm(const BwdArgs& a, const float* A, float* ring, int& cur,
                                     int n_chunks, int row0, int col0, Acc<T>& acc) {
  constexpr int MT = Tile<T>::MT;
  constexpr int NTW = Tile<T>::NTW;
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
        const int r = kSwap ? (row0 + mt * 16 + Tile<T>::TM) % T : row0 + mt * 16;
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

// LayerNorm forward of this warp's rows of src: xhat into xh, the affine
// output into y (either may alias src, or be null), 1/std into rstd[row].
template <int T>
__device__ void ln_rows(const float* src, float* xh, float* y, float* rstd,
                        const float* __restrict__ scale, const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = 0; i < Tile<T>::RPW; ++i) {
    const int row = warp * Tile<T>::RPW + i;
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
    if (lane == 0) rstd[row] = inv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      const float xhat = (v[j] - mu) * inv;
      if (xh != nullptr) xh[row * LDA + c] = xhat;
      if (y != nullptr) y[row * LDA + c] = xhat * __ldg(scale + c) + __ldg(bias + c);
    }
  }
}

// Input cotangent of a LayerNorm for this warp's rows: gsrc is the output
// cotangent, xh and rstd the forward's; the result goes to dst (may alias
// gsrc) and is added to dst when `accumulate`.
template <int T>
__device__ void ln_bwd_rows(const float* gsrc, const float* xh, const float* rstd,
                            const float* __restrict__ scale, float* dst, bool accumulate) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int i = 0; i < Tile<T>::RPW; ++i) {
    const int row = warp * Tile<T>::RPW + i;
    float gh[4];
    float xv[4];
    float s1 = 0.f;
    float s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      gh[j] = gsrc[row * LDA + c] * __ldg(scale + c);
      xv[j] = xh[row * LDA + c];
      s1 += gh[j];
      s2 = fmaf(gh[j], xv[j], s2);
    }
    const float m1 = r3d::warp_sum(s1) * (1.f / C);
    const float m2 = r3d::warp_sum(s2) * (1.f / C);
    const float inv = rstd[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = lane + 32 * j;
      const float dx = (gh[j] - m1 - xv[j] * m2) * inv;
      dst[row * LDA + c] = accumulate ? dst[row * LDA + c] + dx : dx;
    }
  }
}

// dst[row] += src[row] over this warp's rows.
template <int T>
__device__ __forceinline__ void add_rows(float* dst, const float* src) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < Tile<T>::RPW; ++i) {
    const int row = warp * Tile<T>::RPW + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[row * LDA + lane + 32 * j] += src[row * LDA + lane + 32 * j];
  }
}

// The column sums of X[row][c] * (Y ? Y[row][c] : 1) over each half of the
// tile's T rows, c < 128: thread c + 128h sums rows [hT/2, (h+1)T/2) as four
// interleaved partial sums added in a fixed order, into out[h * half + c].
template <int T>
__device__ __forceinline__ void colsum(const float* X, const float* Y, float* out, int half) {
  static_assert(NT == 2 * C, "a thread per column and half");
  const int c = threadIdx.x % C;
  const int h = threadIdx.x / C;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < T / 2; ++i) {
    const int row = h * (T / 2) + i;
    const float x = X[row * LDA + c];
    s[i % 4] += Y == nullptr ? x : x * Y[row * LDA + c];
  }
  out[h * half + c] = (s[0] + s[1]) + (s[2] + s[3]);
}

// The T rows of the tile in shared memory (stride LDA) to rows srow0.. of a
// [R, C] scratch; with kSwap each row takes the other stream's row.
template <int T, bool kSwap>
__device__ __forceinline__ void store_rows(float* dst, const float* src, long srow0) {
  for (int idx = threadIdx.x; idx < T * (C / 4); idx += NT) {
    const int row = idx / (C / 4);
    const int c = (idx % (C / 4)) * 4;
    const int from = kSwap ? (row + Tile<T>::TM) % T : row;
    *reinterpret_cast<float4*>(dst + (srow0 + row) * C + c) =
        *reinterpret_cast<const float4*>(src + from * LDA + c);
  }
}

// Four values to dst[i..i+3] in the streams' type (16 or 8 bytes).
template <typename TOut>
__device__ __forceinline__ void store4(void* dst, long i, float4 v) {
  if constexpr (sizeof(TOut) == 4) {
    *reinterpret_cast<float4*>(static_cast<float*>(dst) + i) = v;
  } else {
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(dst) + i) =
        make_uint2(r3d::pack_bf16(v.x, v.y), r3d::pack_bf16(v.z, v.w));
  }
}

// The tile's rows of both streams (TM global rows from grow0) into the
// tile: r's in rows [0, TM), d's in [TM, T); rows past n_rows read as zero.
// With kAdd they are added to what the tile holds.
template <int T, bool kAdd, typename TIn>
__device__ __forceinline__ void load_streams(const BwdArgs& a, float* dst, long grow0) {
  constexpr int TM = Tile<T>::TM;
  for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
    const int i = idx / C;
    const int c = idx % C;
    const long gr = grow0 + i;
    const bool ok = gr < a.n_rows;
    const float rv = ok ? r3d::to_float(static_cast<const TIn*>(a.r)[gr * C + c]) : 0.f;
    const float dv = ok ? r3d::to_float(static_cast<const TIn*>(a.d)[gr * C + c]) : 0.f;
    if (kAdd) {
      dst[i * LDA + c] += rv;
      dst[(i + TM) * LDA + c] += dv;
    } else {
      dst[i * LDA + c] = rv;
      dst[(i + TM) * LDA + c] = dv;
    }
  }
}

template <bool kOuterResidual, int T, typename TIn>
__global__ void __launch_bounds__(NT, 1) fuser_tail_bwd_rows_kernel(const BwdArgs a) {
  using L = Tile<T>;
  constexpr int TM = L::TM;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // x, y, xhat_out, gy = dm, dx, dr
  float* hs = xs + T * LDA;                      // h1, u, du, dh
  float* x2 = hs + T * LDA;                      // xhat2; gy (outer residual) after LN2's backward
  float* ms = x2 + T * LDA;                      // a hidden chunk (p, dz); g/2; xhat1
  float* ring = ms + T * LDA;                    // NSTAGE x [C, LDW] weight chunks
  float* rstd1 = ring + NSTAGE * CHUNK;
  float* rstd2 = rstd1 + T;
  float* rstdo = rstd2 + T;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp / 4) * TM;    // the warp's first token row in the products
  const int col0 = (warp % 4) * 32;    // and first output column
  const int tile = blockIdx.x;
  const long grow0 = static_cast<long>(tile) * TM;   // the tile's first row of each stream
  const long srow0 = static_cast<long>(tile) * T;    // and first row of the scratch
  const int ch = a.hidden;
  const int n_chunks = 8 + 16 * (ch / HC);
  const int csw = 8 * C + ch;   // a half's row of column sums
  float* cs = a.cs + static_cast<size_t>(tile) * 2 * csw;

  int cur = 0;   // the next weight chunk to use
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) issue_chunk(a, ring, c, n_chunks);   // under the input loads

  // ---- forward, recomputed ----
  load_streams<T, false, TIn>(a, xs, grow0);
  __syncthreads();
  ln_rows<T>(xs, nullptr, hs, rstd1, a.norm1_scale, a.norm1_bias);
  __syncthreads();
  store_rows<T, true>(a.h1s, hs, srow0);
  Acc<T> acc;
  zero<T>(acc);
  gemm<T, true>(a, hs, ring, cur, n_chunks, row0, col0, acc);   // x = in + swap(h1) Wvp^T + bp
  each_pair<T>(acc, row0, col0, [&](int row, int col, float v0, float v1) {
    float2* x = reinterpret_cast<float2*>(xs + row * LDA + col);
    const float2 o = *x;
    *x = make_float2((o.x + v0) + __ldg(a.proj_bias + col),
                     (o.y + v1) + __ldg(a.proj_bias + col + 1));
  });
  __syncthreads();
  ln_rows<T>(xs, x2, hs, rstd2, a.norm2_scale, a.norm2_bias);   // u into hs
  __syncthreads();
  store_rows<T, false>(a.u, hs, srow0);
  Acc<T> acc2;
  zero<T>(acc2);
  for (int h0 = 0; h0 < ch; h0 += HC) {   // y = x + GELU(u W1^T + b1) W2^T + b2
    zero<T>(acc);
    gemm<T, false>(a, hs, ring, cur, n_chunks, row0, col0, acc);
    each_pair<T>(acc, row0, col0, [&](int row, int col, float v0, float v1) {
      const float z0 = v0 + __ldg(a.mlp1_bias + h0 + col);
      const float z1 = v1 + __ldg(a.mlp1_bias + h0 + col + 1);
      const float c0 = 0.5f * (1.f + erff(z0 * kInvSqrt2));
      const float c1 = 0.5f * (1.f + erff(z1 * kInvSqrt2));
      const float2 p = make_float2(z0 * c0, z1 * c1);
      const size_t off = static_cast<size_t>(srow0 + row) * ch + h0 + col;
      *reinterpret_cast<float2*>(ms + row * LDA + col) = p;
      *reinterpret_cast<float2*>(a.p + off) = p;
      *reinterpret_cast<float2*>(a.dz + off) =   // GELU'(z), until the backward
          make_float2(c0 + z0 * expf(-0.5f * z0 * z0) * kInvSqrt2Pi,
                      c1 + z1 * expf(-0.5f * z1 * z1) * kInvSqrt2Pi);
    });
    gemm<T, false>(a, ms, ring, cur, n_chunks, row0, col0, acc2);
  }
  each_pair<T>(acc2, row0, col0, [&](int row, int col, float v0, float v1) {
    float2* x = reinterpret_cast<float2*>(xs + row * LDA + col);
    const float2 o = *x;
    *x = make_float2(o.x + (v0 + __ldg(a.mlp2_bias + col)),
                     o.y + (v1 + __ldg(a.mlp2_bias + col + 1)));
  });
  __syncthreads();
  if (kOuterResidual) {
    load_streams<T, true, TIn>(a, xs, grow0);
    __syncthreads();
  }
  ln_rows<T>(xs, xs, nullptr, rstdo, a.norm_out_scale, a.norm_out_bias);   // xhat_out

  // ---- backward ----
  // g/2 reaches each stream's LN_out (out is the mean of the two)
  for (int idx = threadIdx.x; idx < TM * C; idx += NT) {
    const int i = idx / C;
    const int c = idx % C;
    const long gr = grow0 + i;
    const float gv =
        gr < a.n_rows ? 0.5f * r3d::to_float(static_cast<const TIn*>(a.g)[gr * C + c]) : 0.f;
    ms[i * LDA + c] = gv;
    ms[(i + TM) * LDA + c] = gv;
  }
  __syncthreads();
  colsum<T>(ms, xs, cs + kNos, csw);
  colsum<T>(ms, nullptr, cs + kNob, csw);
  __syncthreads();
  ln_bwd_rows<T>(ms, xs, rstdo, a.norm_out_scale, xs, false);   // gy = dm, in xs
  __syncthreads();
  colsum<T>(xs, nullptr, cs + kB2, csw);
  store_rows<T, false>(a.dm, xs, srow0);

  Acc<T> du;
  zero<T>(du);
  for (int h0 = 0; h0 < ch; h0 += HC) {
    zero<T>(acc);
    gemm<T, false>(a, xs, ring, cur, n_chunks, row0, col0, acc);   // dm W2[:, chunk]
    each_pair<T>(acc, row0, col0, [&](int row, int col, float v0, float v1) {
      float2* slot =
          reinterpret_cast<float2*>(a.dz + static_cast<size_t>(srow0 + row) * ch + h0 + col);
      const float2 dp = *slot;   // this thread's own GELU'(z) from the forward
      const float2 dz = make_float2(v0 * dp.x, v1 * dp.y);
      *slot = dz;
      *reinterpret_cast<float2*>(ms + row * LDA + col) = dz;
    });
    __syncthreads();
    colsum<T>(ms, nullptr, cs + kB1 + h0, csw);
    gemm<T, false>(a, ms, ring, cur, n_chunks, row0, col0, du);    // du += dz W1[chunk]
  }
  // the last gemm read hs' u long ago and ms' dz: its own barriers are
  // behind every warp's last use of hs
  each_pair<T>(du, row0, col0, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(hs + row * LDA + col) = make_float2(v0, v1);
  });
  __syncthreads();
  colsum<T>(hs, x2, cs + kN2s, csw);
  colsum<T>(hs, nullptr, cs + kN2b, csw);
  __syncthreads();
  // dx = gy + LN2_bwd(du); with the outer residual, gy is kept in x2 after
  ln_bwd_rows<T>(hs, x2, rstd2, a.norm2_scale, hs, false);
  if (kOuterResidual) {
    const int lane = threadIdx.x & 31;
    for (int i = 0; i < L::RPW; ++i) {
      const int row = warp * L::RPW + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) x2[row * LDA + lane + 32 * j] = xs[row * LDA + lane + 32 * j];
    }
  }
  add_rows<T>(xs, hs);
  __syncthreads();
  colsum<T>(xs, nullptr, cs + kPb, csw);
  store_rows<T, false>(a.dx, xs, srow0);
  zero<T>(acc);
  gemm<T, true>(a, xs, ring, cur, n_chunks, row0, col0, acc);   // dh = swap(dx) Wvp
  each_pair<T>(acc, row0, col0, [&](int row, int col, float v0, float v1) {
    *reinterpret_cast<float2*>(hs + row * LDA + col) = make_float2(v0, v1);
  });
  // xhat1 again, from the inputs
  load_streams<T, false, TIn>(a, ms, grow0);
  __syncthreads();
  ln_rows<T>(ms, ms, nullptr, rstd1, a.norm1_scale, a.norm1_bias);
  __syncthreads();
  colsum<T>(hs, ms, cs + kN1s, csw);
  colsum<T>(hs, nullptr, cs + kN1b, csw);
  // dr = dx + LN1_bwd(dh) (+ gy with the outer residual), in xs
  ln_bwd_rows<T>(hs, ms, rstd1, a.norm1_scale, xs, true);
  if (kOuterResidual) add_rows<T>(xs, x2);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * (C / 4); idx += NT) {
    const int i = idx / (C / 4);
    const int c = (idx % (C / 4)) * 4;
    const long gr = grow0 + i;
    if (gr < a.n_rows) {
      store4<TIn>(a.dr, gr * C + c, *reinterpret_cast<const float4*>(xs + i * LDA + c));
      store4<TIn>(a.dd, gr * C + c, *reinterpret_cast<const float4*>(xs + (i + TM) * LDA + c));
    }
  }
  r3d::cp_async_wait<0>();
}

// ---- 2. the weight gradients ----

constexpr int WK = 32;                 // token rows of one chunk
constexpr int LDK = C + 8;             // row stride of a staged chunk (% 32 == 8)
constexpr int WSTAGE = 2 * WK * LDK;   // floats of one stage: X's and Y's chunk
constexpr int WNSTAGE = 4;             // stages of the ring
constexpr int WGRAD_SMEM = static_cast<int>(sizeof(float)) * WNSTAGE * WSTAGE;

struct WgradArgs {
  const float* p;
  const float* dz;
  const float* dm;
  const float* u;
  const float* dx;
  const float* h1s;
  float* partial;   // [splits, out tiles, C, C]
  int rows;         // R
  int split_rows;   // rows of one split, a multiple of WK
  int hidden;
};

// out[a][b] = sum over the split's rows of X[row][a] * Y[row][b] for one
// 128 x 128 output tile (blockIdx.y): dW2 tiles j < Ch/128 (X = dm, Y = p
// columns 128j..), then dW1 tiles (X = dz columns 128j.., Y = u), then dWvp
// (X = dx, Y = swap(h1)); blockIdx.x the split. The chunks of 32 rows of X
// and Y stream through a ring of four stages (16-byte cp.async, rows past R
// zero) in row-major [32 x 128] tiles: the row is the product's k, so the
// fragments read A[a][k] = X[k][a] and B[k][b] = Y[k][b] with plain loads,
// conflict-free at a row stride of 8 mod 32 (lane g, t: bank 8t + g). Eight
// warps each own 64 x 32 of the tile (4 x 4 fragment pairs), 3xTF32.
__global__ void __launch_bounds__(NT, 1) fuser_tail_wgrad_kernel(const WgradArgs w) {
  extern __shared__ float4 wsmem4[];
  float* ring = reinterpret_cast<float*>(wsmem4);
  const int nj = w.hidden / HC;
  const int ot = blockIdx.y;
  const float* X;
  const float* Y;
  int ldx = C, ldy = C;
  if (ot < nj) {
    X = w.dm, Y = w.p + ot * HC, ldy = w.hidden;
  } else if (ot < 2 * nj) {
    X = w.dz + (ot - nj) * HC, ldx = w.hidden, Y = w.u;
  } else {
    X = w.dx, Y = w.h1s;
  }
  const int row_begin = blockIdx.x * w.split_rows;
  const int row_end = min(w.rows, row_begin + w.split_rows);
  const int n_ch = row_end > row_begin ? (row_end - row_begin + WK - 1) / WK : 0;
  auto issue = [&](int c) {
    if (c < n_ch) {
      float* st = ring + (c % WNSTAGE) * WSTAGE;
      for (int idx = threadIdx.x; idx < 2 * WK * (C / 4); idx += NT) {
        const int which = idx / (WK * (C / 4));   // 0: X, 1: Y
        const int r = (idx / (C / 4)) % WK;
        const int c4 = (idx % (C / 4)) * 4;
        const int row = row_begin + c * WK + r;
        const bool ok = row < row_end;
        const float* src = which ? Y + static_cast<size_t>(ok ? row : 0) * ldy
                                 : X + static_cast<size_t>(ok ? row : 0) * ldx;
        r3d::cp_async16(st + which * WK * LDK + r * LDK + c4, src + c4, ok);
      }
    }
    r3d::cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < WNSTAGE - 1; ++c) issue(c);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int a0 = (warp / 4) * 64;   // the warp's output rows
  const int b0 = (warp % 4) * 32;   // and columns
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }
#pragma unroll 1
  for (int c = 0; c < n_ch; ++c) {
    r3d::cp_async_wait<WNSTAGE - 2>();
    __syncthreads();   // chunk c has landed; every thread is done with c - 1
    issue(c + WNSTAGE - 1);
    const float* xs = ring + (c % WNSTAGE) * WSTAGE;
    const float* ys = xs + WK * LDK;
#pragma unroll
    for (int k = 0; k < WK; k += 8) {
      uint32_t a_hi[4][4], a_lo[4][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* p = xs + (k + t) * LDK + a0 + mt * 16 + g;
        r3d::split_tf32(p[0], a_hi[mt][0], a_lo[mt][0]);
        r3d::split_tf32(p[8], a_hi[mt][1], a_lo[mt][1]);
        r3d::split_tf32(p[4 * LDK], a_hi[mt][2], a_lo[mt][2]);
        r3d::split_tf32(p[4 * LDK + 8], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = ys + (k + t) * LDK + b0 + nt * 8 + g;
        r3d::split_tf32(p[0], b_hi[nt][0], b_lo[nt][0]);
        r3d::split_tf32(p[4 * LDK], b_hi[nt][1], b_lo[nt][1]);
      }
      r3d::mma_3xtf32(acc, a_hi, a_lo, b_hi, b_lo);
    }
  }
  r3d::cp_async_wait<0>();
  float* out = w.partial + (static_cast<size_t>(blockIdx.x) * gridDim.y + ot) * C * C;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        *reinterpret_cast<float2*>(out + (a0 + mt * 16 + g + hi * 8) * C + b0 + nt * 8 + 2 * t) =
            make_float2(acc[mt][nt][2 * hi], acc[mt][nt][2 * hi + 1]);
      }
    }
  }
}

// ---- 3. the ordered sums ----

// The 12 gradients from the partials: first the matrix entries (Wvp, W1,
// W2), a thread each, summed over the splits' partials in split order; then
// the vector gradients, 32 columns of the column sums a block: warp w sums
// the tiles' halves w, w + 8, ... in order, and warp 0 adds the 8 warps'
// sums in warp order.
__global__ void __launch_bounds__(256) fuser_tail_bwd_sum_kernel(
    const float* __restrict__ cs, int n_tiles, const float* __restrict__ partial, int n_split,
    int hidden, float* __restrict__ grads) {
  const Layout L(hidden);
  const int nj = hidden / HC;
  const int n_mat = C * C + 2 * hidden * C;
  const int mat_blocks = (n_mat + 255) / 256;
  if (static_cast<int>(blockIdx.x) < mat_blocks) {
    const int m = blockIdx.x * 256 + threadIdx.x;
    if (m >= n_mat) return;
    int q, tile, a, b;
    if (m < C * C) {
      q = L.wvp + m, tile = 2 * nj, a = m / C, b = m % C;
    } else if (m < C * C + hidden * C) {
      const int i = m - C * C;   // dW1 [Ch, C]
      q = L.w1 + i, tile = nj + (i / C) / HC, a = (i / C) % HC, b = i % C;
    } else {
      const int i = m - C * C - hidden * C;   // dW2 [C, Ch]
      q = L.w2 + i, tile = (i % hidden) / HC, a = i / hidden, b = (i % hidden) % HC;
    }
    const size_t off = (static_cast<size_t>(tile) * C + a) * C + b;
    const size_t step = static_cast<size_t>(2 * nj + 1) * C * C;
    float s = 0.f;
#pragma unroll 4
    for (int i = 0; i < n_split; ++i) s += partial[i * step + off];
    grads[q] = s;
    return;
  }
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = (blockIdx.x - mat_blocks) * 32 + lane;   // 8C + Ch columns, a multiple of 32
  const int ld = 8 * C + hidden;
  float s = 0.f;
#pragma unroll 8
  for (int i = warp; i < 2 * n_tiles; i += 8) s += cs[static_cast<size_t>(i) * ld + col];
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0) return;
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) t += part[w][lane];
  const int q = col < kPb ? L.n1s + col                 // n1s, n1b
                : col < kB2 ? L.pb + (col - kPb)        // pb, n2s, n2b
                : col < kB1 ? L.b2 + (col - kB2)        // b2, nos, nob
                            : L.b1 + (col - kB1);
  grads[q] = t;
}

template <bool kOuterResidual, int T, typename TIn>
cudaError_t launch_rows(const BwdArgs& a, int n_tiles, cudaStream_t s) {
  constexpr int smem = smem_bytes<T>();
  auto kernel = fuser_tail_bwd_rows_kernel<kOuterResidual, T, TIn>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, NT, smem, s>>>(a);
  return cudaGetLastError();
}

// r, d, g [N, C]; the tail's parameters (torch layout); dr, dd [N, C];
// scratch (ops/fuser_kernel_bwd.py:scratch_floats: the transposed weights,
// then p, dz [R, Ch], dm, u, dx, swapped h1 [R, C], the column sums
// [tiles, 2, 8C + Ch] and the partials [splits, 2 Ch/128 + 1, C, C]); grads [P]
// (the 12 gradients end to end, in FuserTailParams order, matrices in
// [out, in] layout). r, d, g, dr and dd of type TIn (fp32 or bf16), the rest fp32;
// all contiguous and 16-byte aligned. `tile_rows`
// (32 or 64) token rows a block of the row phase takes, R = ceil(N /
// (tile_rows / 2)) * tile_rows; `split_rows` (a multiple of 32) rows of a
// split of the weight-gradient phase. Four launches.
template <typename TIn>
int tail_bwd(
    const void* r, const void* d, const void* g, const float* norm1_scale,
    const float* norm1_bias, const float* wvp, const float* proj_bias,
    const float* norm2_scale, const float* norm2_bias, const float* mlp1_weight,
    const float* mlp1_bias, const float* mlp2_weight, const float* mlp2_bias,
    const float* norm_out_scale, const float* norm_out_bias, void* dr, void* dd,
    float* scratch, float* grads, int n_rows, int channels, int hidden, int tile_rows,
    int split_rows, int outer_residual, void* stream) {
  if (channels != C || hidden <= 0 || hidden % HC != 0 || n_rows < 0 ||
      (tile_rows != 32 && tile_rows != 64) || split_rows <= 0 || split_rows % WK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n_rows + tile_rows / 2 - 1) / (tile_rows / 2);
  const int R = n_tiles * tile_rows;
  const int n_split = R > 0 ? (R + split_rows - 1) / split_rows : 1;
  const int n_out = 2 * (hidden / HC) + 1;
  float* wt = scratch;
  float* p = wt + 2 * hidden * C + C * C;
  float* dz = p + static_cast<size_t>(R) * hidden;
  float* dm = dz + static_cast<size_t>(R) * hidden;
  float* u = dm + static_cast<size_t>(R) * C;
  float* dx = u + static_cast<size_t>(R) * C;
  float* h1s = dx + static_cast<size_t>(R) * C;
  float* cs = h1s + static_cast<size_t>(R) * C;
  float* partial = cs + static_cast<size_t>(n_tiles) * 2 * (8 * C + hidden);

  transpose_weights_kernel<<<(2 * hidden * C + C * C) / 1024, 256, 0, s>>>(wvp, mlp1_weight,
                                                                          mlp2_weight, wt, hidden);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles > 0) {
    const BwdArgs a{r, d, g, norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale, norm2_bias,
                    mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias, norm_out_scale, norm_out_bias,
                    wt, wt + hidden * C, wt + 2 * hidden * C, dr, dd, p, dz, dm, u,
                    dx, h1s, cs, n_rows, hidden};
    if (tile_rows == 64) {
      err = outer_residual ? launch_rows<true, 64, TIn>(a, n_tiles, s)
                           : launch_rows<false, 64, TIn>(a, n_tiles, s);
    } else {
      err = outer_residual ? launch_rows<true, 32, TIn>(a, n_tiles, s)
                           : launch_rows<false, 32, TIn>(a, n_tiles, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(fuser_tail_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WGRAD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const WgradArgs w{p, dz, dm, u, dx, h1s, partial, R, split_rows, hidden};
  fuser_tail_wgrad_kernel<<<dim3(n_split, n_out), NT, WGRAD_SMEM, s>>>(w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sum_blocks = (C * C + 2 * hidden * C + 255) / 256 + (8 * C + hidden) / 32;
  fuser_tail_bwd_sum_kernel<<<sum_blocks, 256, 0, s>>>(cs, n_tiles, partial, n_split, hidden,
                                                       grads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int r3d_fuser_tail_bwd(
    const float* r, const float* d, const float* g, const float* norm1_scale,
    const float* norm1_bias, const float* wvp, const float* proj_bias,
    const float* norm2_scale, const float* norm2_bias, const float* mlp1_weight,
    const float* mlp1_bias, const float* mlp2_weight, const float* mlp2_bias,
    const float* norm_out_scale, const float* norm_out_bias, float* dr, float* dd,
    float* scratch, float* grads, int n_rows, int channels, int hidden, int tile_rows,
    int split_rows, int outer_residual, void* stream) {
  return tail_bwd<float>(r, d, g, norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale,
                         norm2_bias, mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias,
                         norm_out_scale, norm_out_bias, dr, dd, scratch, grads, n_rows,
                         channels, hidden, tile_rows, split_rows, outer_residual, stream);
}

// The bf16 instantiation: r, d, g, dr and dd bf16, all else as above.
extern "C" int r3d_fuser_tail_bwd_bf16(
    const void* r, const void* d, const void* g, const float* norm1_scale,
    const float* norm1_bias, const float* wvp, const float* proj_bias,
    const float* norm2_scale, const float* norm2_bias, const float* mlp1_weight,
    const float* mlp1_bias, const float* mlp2_weight, const float* mlp2_bias,
    const float* norm_out_scale, const float* norm_out_bias, void* dr, void* dd,
    float* scratch, float* grads, int n_rows, int channels, int hidden, int tile_rows,
    int split_rows, int outer_residual, void* stream) {
  return tail_bwd<__nv_bfloat16>(r, d, g, norm1_scale, norm1_bias, wvp, proj_bias, norm2_scale,
                                 norm2_bias, mlp1_weight, mlp1_bias, mlp2_weight, mlp2_bias,
                                 norm_out_scale, norm_out_bias, dr, dd, scratch, grads, n_rows,
                                 channels, hidden, tile_rows, split_rows, outer_residual, stream);
}
