// Shared by every kernel library of the port. Each .cu file is built into
// its own shared library with a plain C interface, loaded with ctypes
// (voicefixer_tpu_torch/kernels/build.py). Every entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so
// that the Python wrapper raises on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* vf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace vf {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// v rounded to T's precision and widened back to float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

}  // namespace vf
