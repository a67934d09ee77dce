// Residual add and RMSNorm in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves the residual add and the
// norm (src/repro/models/layers.py rmsnorm) to XLA, which fuses them.  The
// port's eager composition spends 11 launches on them (the add, then
// float, x*x, mean, +eps, rsqrt, mul, scale.float, 1+, mul, to), twice a
// layer; this kernel is one.
//
// What it computes, for each row of x [rows, D] (and delta, same shape):
//   x'  = x + delta                      rounded to x's dtype (the eager add)
//   var = mean(x'^2) in f32,   r = rsqrt(var + eps)
//   h   = (x' r) (1 + scale)             in f32, rounded to x's dtype
// with every product and sum rounded where layers.rmsnorm rounds it (the
// sum over the row is taken in another order than PyTorch's reduction,
// so var, and through it h, may differ in the last bit).  Without delta,
// x' is x and is not written.
//
// Bound on this card: bytes (a few operations an element).  One block a
// row, 16-byte loads and stores; the sum of squares is reduced by warp
// shuffles and one pass through shared memory.  The second pass reads the
// row again (x' as this thread wrote it, or x), from L1/L2.
#include "glue.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    add_rmsnorm_kernel(const T* x, const T* delta, const T* scale, T* x_out,
                       T* h, int D, float eps) {
  const long long base = static_cast<long long>(blockIdx.x) * D;
  const T* xr = x + base;
  // the row the norm reads: x' where it is written (by this thread, at
  // the same columns: no pointer is __restrict__, so the loads below are
  // coherent with those stores), else x
  const T* nr = delta ? x_out + base : xr;
  float ss = 0.f;
  for (int c = threadIdx.x * VEC; c < D; c += kThreads * VEC) {
    float a[VEC];
    rt::load_f<T, VEC>(xr + c, a);
    if (delta) {
      float d[VEC];
      rt::load_f<T, VEC>(delta + base + c, d);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        a[i] = rt::round_to<T>(__fadd_rn(a[i], d[i]));
      rt::store_f<T, VEC>(x_out + base + c, a);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      ss = __fadd_rn(ss, __fmul_rn(a[i], a[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float part[kThreads / 32];
  __shared__ float r_row;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float v = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    // mean = sum * (1 / D), as PyTorch's mean reduction projects its sum
    if (threadIdx.x == 0)
      r_row =
          rsqrtf(__fadd_rn(__fmul_rn(v, __fdiv_rn(1.f, (float)D)), eps));
  }
  __syncthreads();
  const float r = r_row;
  for (int c = threadIdx.x * VEC; c < D; c += kThreads * VEC) {
    float a[VEC], s[VEC], o[VEC];
    rt::load_f<T, VEC>(nr + c, a);
    rt::load_f<T, VEC>(scale + c, s);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      o[i] = __fmul_rn(__fmul_rn(a[i], r), __fadd_rn(1.f, s[i]));
    rt::store_f<T, VEC>(h + base + c, o);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* delta, const void* scale,
                   void* x_out, void* h, int rows, int D, float eps,
                   cudaStream_t st) {
  add_rmsnorm_kernel<T, VEC><<<rows, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(delta),
      static_cast<const T*>(scale), static_cast<T*>(x_out),
      static_cast<T*>(h), D, eps);
  return cudaGetLastError();
}

}  // namespace

// x, delta (may be null), scale [D], x_out (written when delta is given)
// and h: contiguous rows of D elements of one dtype (0 float32, 1
// bfloat16).  vec: every pointer 16-byte aligned and D a multiple of 16
// bytes' worth of elements.  Returns the launch's CUDA error (0 =
// launched).
extern "C" int add_rmsnorm_launch(const void* x, const void* delta,
                                  const void* scale, void* x_out, void* h,
                                  int rows, int D, float eps, int dtype,
                                  int vec, void* stream) {
  if (rows < 1 || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec ? launch<float, 4>(x, delta, scale, x_out, h, rows, D, eps, st)
              : launch<float, 1>(x, delta, scale, x_out, h, rows, D, eps, st);
  else
    err = vec ? launch<__nv_bfloat16, 8>(x, delta, scale, x_out, h, rows, D,
                                         eps, st)
              : launch<__nv_bfloat16, 1>(x, delta, scale, x_out, h, rows, D,
                                         eps, st);
  return static_cast<int>(err);
}

extern "C" const char* add_rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
