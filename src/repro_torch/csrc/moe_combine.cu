// The MoE layer's combine, for Hopper (sm_90a): each token's output is its
// k experts' rows weighted by its gates.
//
// Replaces no TPU kernel: the reference combines with XLA ops.  The port's
// eager composition (models/moe.py moe_apply_grouped) spends six launches
// on it: the gates' gather into pair order, zeros, the f32 copy of the
// expert rows, their product with the gates, index_add_ (atomics, in no
// fixed order) and the cast back to x's dtype.
//
// What it computes, one block a token t: y[t] = sum_j top_w[t, j]
// out_rows[pos[t, j]], each product rounded to f32 and the sum taken in f32
// in the order of the rows, which is the experts' order (no fused
// multiply-add, as the eager product and add each round), then rounded
// once to the rows' dtype.  The masked combine of the reference adds a
// token's experts in that order too, and index_add_ over the
// expert-sorted pairs as a rule does; here the order is fixed, so a call
// gives the same bits every run, where index_add_'s atomics need not.
//
// Bound on this card: bytes (k rows read and one written a token).
// 16-byte loads and stores.
#include "glue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    moe_combine_kernel(const T* __restrict__ out_rows,
                       const float* __restrict__ top_w,
                       const int* __restrict__ pos, T* __restrict__ y, int D,
                       int k) {
  __shared__ float gate[kMaxK];
  __shared__ long long row[kMaxK];
  const int t = blockIdx.x;
  if (threadIdx.x == 0) {
    // the token's pairs sorted by their rows (an insertion sort of k)
    for (int j = 0; j < k; ++j) {
      const long long at = static_cast<long long>(t) * k + j;
      const long long r = static_cast<long long>(pos[at]) * D;
      const float w = top_w[at];
      int i = j;
      for (; i > 0 && row[i - 1] > r; --i) {
        row[i] = row[i - 1];
        gate[i] = gate[i - 1];
      }
      row[i] = r;
      gate[i] = w;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x * VEC; c < D; c += kThreads * VEC) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int j = 0; j < k; ++j) {
      float o[VEC];
      rt::load_f<T, VEC>(out_rows + row[j] + c, o);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(gate[j], o[v]));
    }
    rt::store_f<T, VEC>(y + static_cast<long long>(t) * D + c, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* out_rows, const void* top_w, const void* pos,
                   void* y, int n_tok, int D, int k, cudaStream_t st) {
  moe_combine_kernel<T, VEC><<<n_tok, kThreads, 0, st>>>(
      static_cast<const T*>(out_rows), static_cast<const float*>(top_w),
      static_cast<const int*>(pos), static_cast<T*>(y), D, k);
  return cudaGetLastError();
}

}  // namespace

// out_rows: [n_tok k, D] contiguous (dtype 0 float32, 1 bfloat16), the
// expert-sorted pairs' rows; top_w: [n_tok, k] f32; pos: [n_tok, k] int32,
// each pair's row (moe_permute's); y: [n_tok, D] of out_rows' dtype.  vec:
// out_rows and y 16-byte aligned and D a multiple of 16 bytes' worth of
// elements.  Returns the launch's CUDA error (0 = launched).
extern "C" int moe_combine_launch(const void* out_rows, const void* top_w,
                                  const void* pos, void* y, int n_tok, int D,
                                  int k, int dtype, int vec, void* stream) {
  if (n_tok < 1 || D < 1 || k < 1 || k > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec ? launch<float, 4>(out_rows, top_w, pos, y, n_tok, D, k, st)
              : launch<float, 1>(out_rows, top_w, pos, y, n_tok, D, k, st);
  else
    err = vec ? launch<__nv_bfloat16, 8>(out_rows, top_w, pos, y, n_tok, D, k,
                                         st)
              : launch<__nv_bfloat16, 1>(out_rows, top_w, pos, y, n_tok, D, k,
                                         st);
  return static_cast<int>(err);
}

extern "C" const char* moe_combine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
