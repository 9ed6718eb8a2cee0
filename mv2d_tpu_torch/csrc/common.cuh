// Shared helpers for the port's CUDA kernels: float32/bfloat16 element
// conversion and the dtype dispatch of the C entry points (0 = float32,
// 1 = bfloat16).  Every kernel loads its inputs into float32 and
// accumulates in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mv2d {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace mv2d

// Runs the statement block with T bound to the element type of `code`.
#define MV2D_DISPATCH(code, T, ...)                  \
  do {                                               \
    if ((code) == 0) {                               \
      using T = float;                               \
      __VA_ARGS__                                    \
    } else if ((code) == 1) {                        \
      using T = __nv_bfloat16;                       \
      __VA_ARGS__                                    \
    } else {                                         \
      return static_cast<int>(cudaErrorInvalidValue); \
    }                                                \
  } while (0)
