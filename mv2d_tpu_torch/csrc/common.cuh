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

// p[0..N) += v[0..N) with float32 atomics; p 16-byte aligned, N % 4 == 0.
// sm_90 adds four floats in one vector atomic.
template <int N>
__device__ __forceinline__ void atomic_add(float* p, const float* v) {
  static_assert(N % 4 == 0, "atomic_add takes whole float4 groups");
#pragma unroll
  for (int k = 0; k < N; k += 4) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(reinterpret_cast<float4*>(p + k),
              make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
#else
    for (int j = 0; j < 4; ++j) atomicAdd(p + k + j, v[k + j]);
#endif
  }
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
