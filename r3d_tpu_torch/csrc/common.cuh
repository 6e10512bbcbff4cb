// Helpers shared by the port's CUDA kernels. Each kernel source is built into
// its own shared library with a plain C interface (r3d_tpu_torch/ops/build.py)
// and every exported launcher returns the cudaError_t of its launch as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace r3d {

constexpr unsigned kFullMask = 0xffffffffu;

// Loads and stores of an input type (float or bf16); the math is fp32.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision (nearest even), held as a float.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from device to shared memory without passing registers; with
// `ok` false nothing is read and the 16 bytes are set to zero (`src` must
// still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

// As cp_async16 for 4 bytes (through L1: .cg takes only 16).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// murmur3's 32-bit finalizer: a bijection with full avalanche.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// The attention-dropout bits of element `idx` = ((b*H + h)*Lq + q)*Lk + k of
// the [B, H, Lq, Lk] weights under `seed`: a counter-based hash, so the mask
// depends on neither tiling nor launch order, and the backward redraws the
// forward's mask. An element is kept when its bits are >= rate * 2^32.
// ops/attention.py:dropout_bits computes the same bits with torch integer ops.
__device__ __forceinline__ uint32_t dropout_bits(uint32_t seed, uint32_t idx) {
  const uint32_t key = fmix32(seed ^ 0x5bd1e995u);
  return fmix32(fmix32(idx ^ key) + key);
}

}  // namespace r3d

// Text of an error code returned by a launcher, for the Python wrapper's message.
extern "C" const char* r3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
