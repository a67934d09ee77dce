// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// The shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes from device memory into shared memory; both
// addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The dynamic shared memory one kernel has been opted in to, per device
// (the attribute is per kernel and device).  Each launch site keeps one as
// a function-local static beside its kernel.
struct SmemOptIn {
  static constexpr int kDevices = 64;
  std::atomic<int> bytes[kDevices];
};

// Opt `kernel` in to `bytes` of dynamic shared memory on the current
// device when it needs more than the default 48 KB and is not opted in to
// that much there yet; the opt-in then holds for every later launch.
inline cudaError_t opt_in_smem(SmemOptIn& done, const void* kernel,
                               size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < SmemOptIn::kDevices;
  if (known && done.bytes[dev].load(std::memory_order_relaxed) >= (int)bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && known) {
    int seen = done.bytes[dev].load(std::memory_order_relaxed);
    while (seen < (int)bytes &&
           !done.bytes[dev].compare_exchange_weak(seen, (int)bytes)) {
    }
  }
  return err;
}

}  // namespace rt
