// The gated MLP's activation and product in one launch, for Hopper
// (sm_90a): out = act(gate) * up.
//
// Replaces no TPU kernel: the reference leaves the gate to XLA, which fuses
// it into the products around it.  The port's eager composition
// (layers.mlp_apply) spends two launches on it, the activation and the
// product; this kernel is one.
//
// What it computes, element by element of gate and up (same shape, one
// dtype): a = act(gate) in f32, rounded to the dtype, then a * up in f32,
// rounded to the dtype: the activation's result is stored before the
// product reads it, as `_act(gate) * up` rounds it.  act is silu,
// x / (1 + exp(-x)), or the tanh form of gelu, both written as PyTorch's
// own CUDA kernels write them (ActivationSiluKernel.cu,
// ActivationGeluKernel.cu) with the precise expf and tanhf.
//
// Bound on this card: bytes (2 reads and 1 write an element, a dozen
// operations).  A grid-stride loop of 16-byte loads and stores.
#include <math.h>

#include "glue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8 * 132;  // eight blocks an SM, then stride

__device__ __forceinline__ float silu(float x) {
  return x / (1.f + expf(-x));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5;
  constexpr float kKappa = 0.044715f;
  const float x_cube = x * x * x;
  const float inner = kBeta * (x + kKappa * x_cube);
  return 0.5f * x * (1.f + tanhf(inner));
}

template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
    gated_act_kernel(const T* gate, const T* up, T* out, long long n) {
  const long long stride =
      static_cast<long long>(gridDim.x) * kThreads * VEC;
  for (long long c = (static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x) * VEC;
       c < n; c += stride) {
    float g[VEC], u[VEC], o[VEC];
    rt::load_f<T, VEC>(gate + c, g);
    rt::load_f<T, VEC>(up + c, u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float a =
          rt::round_to<T>(ACT == 0 ? silu(g[i]) : gelu_tanh(g[i]));
      o[i] = __fmul_rn(a, u[i]);
    }
    rt::store_f<T, VEC>(out + c, o);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* gate, const void* up, void* out, long long n,
                   int act, cudaStream_t st) {
  const long long vecs = n / VEC;
  const long long want = (vecs + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const T* g = static_cast<const T*>(gate);
  const T* u = static_cast<const T*>(up);
  T* o = static_cast<T*>(out);
  if (act == 0)
    gated_act_kernel<T, VEC, 0><<<blocks, kThreads, 0, st>>>(g, u, o, n);
  else
    gated_act_kernel<T, VEC, 1><<<blocks, kThreads, 0, st>>>(g, u, o, n);
  return cudaGetLastError();
}

}  // namespace

// gate, up and out: n contiguous elements of one dtype (0 float32, 1
// bfloat16).  act: 0 silu, 1 gelu (tanh form).  vec: every pointer
// 16-byte aligned and n a multiple of 16 bytes' worth of elements.
// Returns the launch's CUDA error (0 = launched).
extern "C" int gated_act_launch(const void* gate, const void* up, void* out,
                                long long n, int act, int dtype, int vec,
                                void* stream) {
  if (n < 1 || act < 0 || act > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec ? launch<float, 4>(gate, up, out, n, act, st)
              : launch<float, 1>(gate, up, out, n, act, st);
  else
    err = vec ? launch<__nv_bfloat16, 8>(gate, up, out, n, act, st)
              : launch<__nv_bfloat16, 1>(gate, up, out, n, act, st);
  return static_cast<int>(err);
}

extern "C" const char* gated_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
