// RG-LRU linear-recurrence scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (_rglru_kernel,
// pl.pallas_call at rglru_scan.py:51).
//
// What it computes, for each sequence b and channel r of the width R:
//   h_{-1} = h0[b, r]  (zero when no h0 is given)
//   h_t    = a[b, t, r] * h_{t-1} + x[b, t, r],   out[b, t, r] = h_t
// a and x are [B, T, R] (float32 or bfloat16), h0 f32 [B, R], out f32.
//
// Bound on this card: bytes.  One multiply-add per element against at
// least 2 input reads and one f32 write, so the least time is the bytes
// of a, x, h0 and out over 3.35 TB/s.
//
// Design: one thread per (b, r), walking t; neighbouring threads own
// neighbouring channels, so every load and store of a warp is one
// contiguous run of R.  The loads of a and x do not depend on h: each
// thread issues kChunk steps of them before the dependent multiply-add
// chain of that chunk, so a chunk pays one memory latency.  Any T and R
// are taken (the TPU kernel asks T and R to divide its tiles).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // time steps loaded ahead of the FMA chain

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ x,
    const float* __restrict__ h0, float* __restrict__ out, int Tn, int R) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const long long base = (long long)b * Tn * R + r;
  float h = h0 != nullptr ? h0[(long long)b * R + r] : 0.f;

  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    float av[kChunk], xv[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (t0 + c < Tn) {
        const long long off = base + (long long)(t0 + c) * R;
        av[c] = rt::to_f(a[off]);
        xv[c] = rt::to_f(x[off]);
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (t0 + c < Tn) {
        h = fmaf(av[c], h, xv[c]);
        out[base + (long long)(t0 + c) * R] = h;
      }
    }
  }
}

template <typename T>
void launch(const void* a, const void* x, const float* h0, float* out,
            int B, int Tn, int R, cudaStream_t stream) {
  const dim3 grid((R + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), h0, out, Tn, R);
}

}  // namespace

// a, x: contiguous [B, T, R] of one dtype (0 = float32, 1 = bfloat16);
// h0: contiguous f32 [B, R] or null (zero state); out: contiguous f32
// [B, T, R].  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* x,
                                 const void* h0, void* out, int B, int T,
                                 int R, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h0);
  float* of = static_cast<float*>(out);
  if (dtype == 0)
    launch<float>(a, x, hf, of, B, T, R, st);
  else
    launch<__nv_bfloat16>(a, x, hf, of, B, T, R, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
