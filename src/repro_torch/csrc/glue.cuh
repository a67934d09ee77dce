// Helpers of the fused elementwise kernels (add_rmsnorm, gated_act, rope,
// rope_cache_write, and the MoE layer's moe_combine).  Each replaces a run of eager PyTorch launches of the
// transformer's serving forward and decode step and must round where that
// run rounds: every product, sum and difference the eager run computes in
// its own launch is written with a _rn intrinsic here, so that nvcc cannot
// contract it with its neighbour into one fused multiply-add.
#pragma once

#include "common.cuh"

namespace rt {

// Round x to T and widen it back: what storing an eager op's result in
// the tensor's dtype and reading it again does.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Store VEC floats at p as T, one 16-byte store when VEC > 1 (p 16-byte
// aligned then).
template <typename T, int VEC>
__device__ __forceinline__ void store_f(T* p, const float* src) {
  if constexpr (VEC == 1) {
    p[0] = from_f<T>(src[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector stores are 16 bytes");
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(src[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// The half-split RoPE rotation of one pair (x1 at column i, x2 at column
// i + head_dim / 2) by the angle whose cosine and sine are c and s, as
// layers.apply_rope computes it in f32: x1 c - x2 s and x2 c + x1 s, each
// product and each sum rounded on its own.
__device__ __forceinline__ void rope_rotate(float x1, float x2, float c,
                                            float s, float* o1, float* o2) {
  *o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  *o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

// The cosine and sine of pos * freq, the angle apply_rope builds as
// positions.float() * freqs, with the precise sincosf (the port is built
// without --use_fast_math).
__device__ __forceinline__ void rope_angle(int pos, float freq, float* c,
                                           float* s) {
  sincosf(__fmul_rn(static_cast<float>(pos), freq), s, c);
}

}  // namespace rt
