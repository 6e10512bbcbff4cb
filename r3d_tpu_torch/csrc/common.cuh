// Helpers shared by the port's CUDA kernels. Each kernel source is built into
// its own shared library with a plain C interface (r3d_tpu_torch/ops/build.py)
// and every exported launcher returns the cudaError_t of its launch as an int.
#pragma once

#include <cuda_runtime.h>

namespace r3d {

constexpr unsigned kFullMask = 0xffffffffu;

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

}  // namespace r3d

// Text of an error code returned by a launcher, for the Python wrapper's message.
extern "C" const char* r3d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
