// Helpers shared by the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Masked logits take this finite value (never -inf), as in the reference
// kernels: a query whose keys are all masked then averages V instead of
// producing NaN.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load VEC consecutive elements starting at p and widen them to float.
// VEC > 1 issues one 16-byte load, so p must be 16-byte aligned.
template <typename T, int VEC>
__device__ __forceinline__ void load_f(const T* p, float* dst) {
  if constexpr (VEC == 1) {
    dst[0] = to_f(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = to_f(e[i]);
  }
}

}  // namespace rt
