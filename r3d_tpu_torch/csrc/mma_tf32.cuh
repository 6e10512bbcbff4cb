// Building blocks of the fp32-accurate tensor-core products (fuser_tail.cu):
// the warp level product mma.sync m16n8k8 with TF32 operands and fp32 sums,
// and the 3xTF32 split x = hi + lo: hi is x rounded to TF32 (nearest, ties
// away from zero), lo = x - hi is exact in fp32, and the mma reads only the
// top 19 bits of each operand, so lo enters truncated to TF32. Then
// a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b: the dropped lo_a lo_b and the
// truncation of the lo parts are about 2^-22 of a b, so a sum of such
// products keeps about fp32's accuracy, at a third of the TF32 rate (165 of
// the H100's 495 TFLOP/s, against 67 on the fp32 pipes). One TF32 product
// (10-bit mantissa, 2^-11 relative) would not. The rounding is two integer
// operations on x's bits: cvt.rna.tf32.f32 does the same on the SM's slow
// conversion path, which made it the first design's bottleneck.
//
// Fragments (PTX ISA, mma.m16n8k8 with .tf32; g = lane / 4, t = lane % 4):
//   A [16 x 8] row-major: a0 = (row g, col t), a1 = (row g+8, col t),
//     a2 = (row g, col t+4), a3 = (row g+8, col t+4);
//   B [8 x 8]: b0 = (k t, n g), b1 = (k t+4, n g);
//   C [16 x 8] fp32: c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, ...).
#pragma once

#include "common.cuh"

namespace r3d {

// The high and low TF32 parts of x, as the 32-bit operands of an mma: hi
// adds half of the 13 dropped bits' range to x's bits and clears them.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, a [16 x 8] and b [8 x 8] TF32 fragments, c [16 x 8] fp32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[m][n] += a[m] b[n] over a warp's MT x NT tile of fragment pairs, to
// about fp32's accuracy from the parts: lo_a hi_b, then hi_a lo_b, then
// hi_a hi_b, each pass sweeping the whole tile, so that MT * NT independent
// accumulators are in flight between two products on one of them (the
// asm is volatile and keeps this order; three products chained on one
// accumulator would each wait out the mma's latency). b[n] holds the
// fragment's two registers.
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&c)[MT][NT][4], const uint32_t (&a_hi)[MT][4],
                                           const uint32_t (&a_lo)[MT][4],
                                           const uint32_t (&b_hi)[NT][2],
                                           const uint32_t (&b_lo)[NT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[m][n], a_lo[m], b_hi[n][0], b_hi[n][1]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[m][n], a_hi[m], b_lo[n][0], b_lo[n][1]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(c[m][n], a_hi[m], b_hi[n][0], b_hi[n][1]);
  }
}

}  // namespace r3d
