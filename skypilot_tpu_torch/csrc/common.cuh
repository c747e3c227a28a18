// Shared helpers for the hand-written Hopper kernels.
//
// Each kernel source is compiled on its own into a shared library with a
// plain C interface (see skypilot_tpu_torch/ops/kernels.py): every entry
// point takes raw device pointers and a cudaStream_t, launches on that
// stream and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace xsky {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element-type codes shared with the Python wrappers.
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2 };

}  // namespace xsky

#define XSKY_ERROR_STRING_FN                                   \
  extern "C" const char* xsky_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
