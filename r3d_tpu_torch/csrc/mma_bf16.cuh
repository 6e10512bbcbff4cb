// Building blocks of the bf16 tensor-core kernels (the bf16 bodies of
// attention.cu, attention_bwd.cu, cross_attention.cu and
// cross_attention_bwd.cu): bf16 tiles in shared memory, filled with the
// asynchronous copies of common.cuh, with their 16-byte chunks swizzled so
// that `ldmatrix` reads them without bank conflicts, and the warp level
// product mma.sync m16n8k16 (bf16 x bf16 -> fp32).
//
// A tile is [rows][D] bf16, D in {16, 32, 64}, a row being D/8 chunks of 8
// values (16 bytes). Chunk c of row r is stored at chunk c ^ swizzle(r), the
// swizzle chosen so that 8 consecutive rows of one logical chunk fall into 8
// different 16-byte lanes of a 128-byte line of shared memory.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16; g = lane / 4, t = lane % 4):
//   A [16 x 16] row-major: a0 = (row g, cols 2t, 2t+1), a1 = (row g+8, same
//     cols), a2 = (row g, cols 2t+8, 2t+9), a3 = (row g+8, cols 2t+8, 2t+9);
//   B [16 x 8]: b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g);
//   C [16 x 8] fp32: c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, ...).
#pragma once

#include "common.cuh"

namespace r3d {

// Address of chunk c (8 values) of row r of a swizzled [rows][D] bf16 tile.
template <int D>
__device__ __forceinline__ __nv_bfloat16* tile_ptr(__nv_bfloat16* tile, int r, int c) {
  constexpr int CH = D / 8;
  return tile + r * D + ((c ^ ((r * CH / 8) & (CH - 1))) << 3);
}
template <int D>
__device__ __forceinline__ const __nv_bfloat16* tile_ptr(const __nv_bfloat16* tile, int r, int c) {
  constexpr int CH = D / 8;
  return tile + r * D + ((c ^ ((r * CH / 8) & (CH - 1))) << 3);
}

// Values 2*dp and 2*dp + 1 of row r of a swizzled tile, as floats.
template <int D>
__device__ __forceinline__ float2 tile_pair(const __nv_bfloat16* tile, int r, int dp) {
  const __nv_bfloat162 x =
      *reinterpret_cast<const __nv_bfloat162*>(tile_ptr<D>(tile, r, dp >> 2) + ((dp & 3) << 1));
  return __bfloat1622float2(x);
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes), and receives of matrix i, in r[i], the values (row g,
// cols 2t, 2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// As ldmatrix_x4 with each matrix transposed: r[i] holds (rows 2t, 2t+1; col g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// c += a b, a [16 x 16] and b [16 x 8] bf16 fragments, c [16 x 8] fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The A fragment (rows mt*16 .. +15, values ks*16 .. +15) of a swizzled tile
// whose rows are the product's rows.
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const __nv_bfloat16* tile, int mt,
                                            int ks, int lane) {
  const int mi = lane >> 3;
  const int r = lane & 7;
  ldmatrix_x4(a, tile_ptr<D>(tile, mt * 16 + (mi & 1) * 8 + r, 2 * ks + (mi >> 1)));
}

// The B fragments of two neighbouring n-tiles (tile rows n0 .. n0+7 in
// b[0], b[1] and n0+8 .. n0+15 in b[2], b[3]; values ks*16 .. +15) of a
// swizzled tile whose rows are the product's columns: b = tile^T.
template <int D>
__device__ __forceinline__ void load_b_frag(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                            int ks, int lane) {
  const int mi = lane >> 3;
  const int r = lane & 7;
  ldmatrix_x4(b, tile_ptr<D>(tile, n0 + (mi >> 1) * 8 + r, 2 * ks + (mi & 1)));
}

// The B fragments of two neighbouring n-tiles (tile columns 16*np .. +7 in
// b[0], b[1] and 16*np+8 .. +15 in b[2], b[3]) over the tile rows k0 .. k0+15,
// of a swizzled tile whose rows are the product's inner dimension: b = tile.
template <int D>
__device__ __forceinline__ void load_b_frag_trans(uint32_t (&b)[4], const __nv_bfloat16* tile,
                                                  int k0, int np, int lane) {
  const int mi = lane >> 3;
  const int r = lane & 7;
  ldmatrix_x4_trans(b, tile_ptr<D>(tile, k0 + (mi & 1) * 8 + r, 2 * np + (mi >> 1)));
}

// The max / sum over the four lanes that share a fragment row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFullMask, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFullMask, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFullMask, v, 1);
  return v + __shfl_xor_sync(kFullMask, v, 2);
}

}  // namespace r3d
