// What the many-query attention forwards (attention_many.cu in bf16,
// attention_many_f32.cu in fp32) keep for their backwards
// (attention_many_bwd.cu, attention_many_bwd_f32.cu) besides each query's
// (m, 1 / l) and, in bf16, the fp32 output: with dropout, the keep mask, one
// bit a weight, so that the backward reads it instead of hashing every
// element again.
//
// Layout: uint32 [B*H, ceil(Lq / 16), ceil(Lk / 64), 32], one record of 32
// words per (block of 16 query rows, tile of 64 keys), word g*4 + t for the
// lane (g, t) of an mma C fragment (mma_bf16.cuh's m16n8k16 and
// mma_tf32.cuh's m16n8k8 share the C layout): bits 0-15 row g of the
// block, bits 16-31 row g + 8, key nt*8 + 2t + j of the tile at bit nt*2 + j
// (nt < 8, j < 2). The forward's warps, and the backward's dq launch, own
// blocks of 16 rows, so each lane writes and reads its own word; the dk/dv
// launch, whose rows are keys, stages a query tile's records and picks its
// bits.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace r3d {

constexpr int kManyKeyTile = 64;   // keys per tile of both launches' key walks

// The record of (16-row block rb, key tile) of (batch, head) bh.
__device__ __forceinline__ size_t keep_record(int bh, int rb, int tile, int n_rb, int ntiles) {
  return ((static_cast<size_t>(bh) * n_rb + rb) * ntiles + tile) * 32;
}

}  // namespace r3d
