// Shared helpers of the package's CUDA kernels: stream-dtype conversion and
// the pointwise functions, in the same formulas as the JAX reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mmu {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// an f32 value rounded through the stream dtype (identity for f32 streams)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

}  // namespace mmu
