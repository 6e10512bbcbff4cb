// Shared by the fp32 cluster bodies of the attention forward
// (attention_fwd_cluster.cuh: K3, K4, K6) and backward
// (attention_bwd_cluster.cuh: K5, K7): the tile shape, the copy of a tile of
// keys into shared memory and the launch. The keys of one (batch, head) are
// split into at most 8 runs of whole tiles of 64
// (ops/attention.py:fp32_split_keys), one block each, and the blocks of one
// (batch, head) and query tile form one thread-block cluster. A split of one
// tile copies it once at its start; a longer one walks its tiles through a
// ring of two stages. K and V rows lie `ld` floats apart in device memory: D
// in the head-major layout [B, H, L, D], H * D in the projections' native
// layout [B, L, H * D], where a head's row is 4*D bytes of a longer one.
#pragma once

#include "common.cuh"

namespace r3d {

constexpr int kMaxSplits = 8;   // blocks per cluster, the portable limit
constexpr int kF32QT = 8;       // queries a block takes at a time
constexpr int kF32KT = 64;      // keys per tile, one a thread

template <int D>
constexpr int kF32Ld = D + 4;   // row stride of a K or V tile: conflict-free float4 rows by lane
template <int D>                // one stage of the ring: K, V and the bias of a tile, in floats
constexpr int kF32Stage = 2 * kF32KT * kF32Ld<D> + kF32KT;

// Copy the tile of keys from `key0` (K at `stage`, V after it, then the
// bias) with 16- and 4-byte cp.async, by a block of NT threads; rows past Lk
// are zero, their bias 0, and so is every bias where there is none. One
// commit group.
template <int D, int NT>
__device__ __forceinline__ void f32_load_tile(float* stage, const float* kb, const float* vb,
                                              const float* biasb, int key0, int Lk, int ld) {
  constexpr int C4 = D / 4;
  constexpr int LD = kF32Ld<D>;
  for (int idx = threadIdx.x; idx < kF32KT * C4; idx += NT) {
    const int r = idx / C4;
    const int c = idx % C4;
    const bool ok = key0 + r < Lk;
    const size_t off = static_cast<size_t>(ok ? key0 + r : 0) * ld + c * 4;
    cp_async16(stage + r * LD + c * 4, kb + off, ok);
    cp_async16(stage + (kF32KT + r) * LD + c * 4, vb + off, ok);
  }
  const int j = threadIdx.x;   // a key a thread
  if (j < kF32KT) {
    const bool ok = biasb != nullptr && key0 + j < Lk;
    cp_async4(stage + 2 * kF32KT * LD + j, ok ? static_cast<const void*>(biasb + key0 + j) : kb,
              ok);
  }
  cp_async_commit();
}

// Tile `t` of a split of `ntiles` walked through the ring of two stages at
// `ring`, whose tile 0 the caller copied: copies tile t + 1 into the other
// stage (which the block must be done with), waits for tile t and the whole
// block, and returns tile t's stage.
template <int D, int NT>
__device__ __forceinline__ const float* f32_ring_step(float* ring, int t, int ntiles,
                                                      const float* kb, const float* vb,
                                                      const float* biasb, int key_begin, int Lk,
                                                      int ld) {
  const bool next = t + 1 < ntiles;
  if (next) {
    f32_load_tile<D, NT>(ring + ((t + 1) & 1) * kF32Stage<D>, kb, vb, biasb,
                         key_begin + (t + 1) * kF32KT, Lk, ld);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  return ring + (t & 1) * kF32Stage<D>;
}

// Dynamic shared memory of a launch with `split_keys` keys a block: one
// stage, or two where the split walks more than one tile.
template <int D>
inline size_t f32_ring_bytes(int split_keys) {
  return sizeof(float) * kF32Stage<D> * (split_keys > kF32KT ? 2 : 1);
}

// The launch of a cluster body: `grid` with its x blocks one cluster,
// `threads` a block, `smem` bytes of the ring. Raises the kernel's
// dynamic shared-memory limit where its static and dynamic shared memory
// together pass the default 48 KB (two stages at D = 32 or 64); a ring of
// up to 16 KB (one stage at D = 16, the main path) cannot, so those
// launches make no extra call. `cfg` points into this struct: use it in
// place.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;

  template <typename Kernel>
  cudaError_t init(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
    if (smem > 16 * 1024) {
      cudaFuncAttributes a = {};
      cudaError_t err = cudaFuncGetAttributes(&a, kernel);
      if (err == cudaSuccess && a.sharedSizeBytes + smem > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
      }
      if (err != cudaSuccess) return err;
    }
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = grid.x;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
  }

  // How many of these clusters the card holds at once.
  template <typename Kernel>
  cudaError_t max_active(Kernel kernel, int* clusters) const {
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  }
};

}  // namespace r3d
