// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py (_wkv_kernel,
// pl.pallas_call at wkv6.py:59).
//
// What it computes, per sequence b and head h, from a zero state S [hd, hd]:
//   for t = 0 .. T-1:
//     kv[i,j] = k_t[i] * v_t[j]
//     y_t[j]  = sum_i r_t[i] * (S[i,j] + u[i] * kv[i,j])
//     S[i,j]  = w_t[i] * S[i,j] + kv[i,j]
// and, when asked, writes the final S (the decode cache's state).
// r, k, v, w are [B, T, H, hd] (float32 or bfloat16), u [H, hd] f32; y is
// f32 [B, T, H, hd], the state f32 [B, H, hd, hd].
//
// Bound on this card: bytes.  With q_t = r_t * u * k_t taken out of the
// sum (see the design), each step does 5 * hd * hd f32 operations (a
// multiply-add for sum_i r_t[i] * S[i,j], the product k_t[i] * v_t[j] and
// a multiply-add for the decay update) on CUDA cores for 4 * hd input
// values and hd outputs.  The least time is the larger of
// 5 * B * T * H * hd^2 / 67 TFLOP/s and the bytes of r, k, v, w, u, y
// (and the state) over 3.35 TB/s; at f32 inputs the bytes are larger.
//
// Design: one block per (b, h) with one thread per value column j.
// Thread j keeps column j of S (hd f32 values) in registers, so the state
// never leaves the SM and the steps need no exchange between threads:
// y_t[j] = sum_i r_t[i] * S[i,j] + v_t[j] * sum_i q_t[i] with q_t[i] =
// r_t[i] * u[i] * k_t[i], and the update of S[:, j], use only the shared
// r_t, k_t, w_t and q_t and the thread's own v_t[j].  The sequential
// time loop runs inside the block (the TPU kernel's "arbitrary" chunk
// axis); the step loop is not unrolled, to keep the build short and the
// registers for S and the loads in flight.  Inputs are staged
// kChunk steps at a time: while the block computes one chunk from shared
// memory, the loads of the next chunk are already in flight in registers,
// so a load's latency is paid once per chunk rather than once per step.
// The sums over i are split four ways to shorten their dependent chains.
// One block per (b, h) gives B * H blocks of hd threads: few warps per SM
// at small B * H; splitting S's columns across blocks is later work.
#include "common.cuh"

namespace {

constexpr int kChunk = 8;  // time steps staged per shared-memory chunk

// Load kChunk steps of thread j's r, k, w and v values (zeros past T).
template <typename T>
__device__ __forceinline__ void load_chunk(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w, long long base,
    long long row, int t0, int Tn, float (&nr)[kChunk],
    float (&nk)[kChunk], float (&nw)[kChunk], float (&nv)[kChunk]) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) {
    const int t = t0 + c;
    if (t < Tn) {
      const long long off = base + t * row;
      nr[c] = rt::to_f(r[off]);
      nk[c] = rt::to_f(k[off]);
      nw[c] = rt::to_f(w[off]);
      nv[c] = rt::to_f(v[off]);
    } else {
      nr[c] = nk[c] = nw[c] = nv[c] = 0.f;
    }
  }
}

template <typename T, int MAXHD>
__global__ void __launch_bounds__(MAXHD, 1) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const float* __restrict__ u, float* __restrict__ y,
    float* __restrict__ state_out, int Tn, int H, int hd) {
  __shared__ float s_r[kChunk][MAXHD];
  __shared__ float s_k[kChunk][MAXHD];
  __shared__ float s_w[kChunk][MAXHD];
  __shared__ float s_v[kChunk][MAXHD];
  __shared__ float s_q[kChunk][MAXHD];  // r * u * k: the bonus term

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;  // blockDim.x == hd
  const long long row = (long long)H * hd;            // one t step
  const long long base = ((long long)b * Tn * H + h) * hd + j;

  // Rows i >= hd (when hd < MAXHD) stay zero in shared memory and add
  // nothing: their S stays 0 and their r and q are 0.
  for (int e = j; e < kChunk * MAXHD; e += blockDim.x) {
    (&s_r[0][0])[e] = 0.f;
    (&s_k[0][0])[e] = 0.f;
    (&s_w[0][0])[e] = 0.f;
    (&s_q[0][0])[e] = 0.f;
  }
  const float uj = u[h * hd + j];

  float S[MAXHD];
#pragma unroll
  for (int i = 0; i < MAXHD; ++i) S[i] = 0.f;

  // the chunk in flight (registers) and the chunk being computed (smem)
  float nr[kChunk], nk[kChunk], nw[kChunk], nv[kChunk];
  load_chunk<T>(r, k, v, w, base, row, 0, Tn, nr, nk, nw, nv);
  for (int t0 = 0; t0 < Tn; t0 += kChunk) {
    __syncthreads();  // every thread is done reading the previous chunk
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      s_r[c][j] = nr[c];
      s_k[c][j] = nk[c];
      s_w[c][j] = nw[c];
      s_v[c][j] = nv[c];
      s_q[c][j] = nr[c] * uj * nk[c];
    }
    __syncthreads();
    if (t0 + kChunk < Tn)
      load_chunk<T>(r, k, v, w, base, row, t0 + kChunk, Tn, nr, nk, nw, nv);

    const int steps = min(kChunk, Tn - t0);
#pragma unroll 1
    for (int c = 0; c < steps; ++c) {
      const float vj = s_v[c][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};   // sum_i r[i] * S[i,j]
      float bon[4] = {0.f, 0.f, 0.f, 0.f};   // sum_i q[i], the same for all j
#pragma unroll
      for (int i = 0; i < MAXHD; ++i) {
        acc[i & 3] = fmaf(s_r[c][i], S[i], acc[i & 3]);
        bon[i & 3] += s_q[c][i];
        S[i] = fmaf(s_w[c][i], S[i], s_k[c][i] * vj);
      }
      y[base + (long long)(t0 + c) * row] =
          fmaf(vj, (bon[0] + bon[1]) + (bon[2] + bon[3]),
               (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

  if (state_out != nullptr) {
    float* so = state_out + ((long long)b * H + h) * hd * hd + j;
#pragma unroll
    for (int i = 0; i < MAXHD; ++i)
      if (i < hd) so[(long long)i * hd] = S[i];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, float* y,
                   float* state_out, int B, int Tn, int H, int hd,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  const dim3 block(hd);
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* ww = static_cast<const T*>(w);
  if (hd <= 32)
    wkv6_kernel<T, 32><<<grid, block, 0, stream>>>(rr, kk, vv, ww, u, y,
                                                  state_out, Tn, H, hd);
  else if (hd <= 64)
    wkv6_kernel<T, 64><<<grid, block, 0, stream>>>(rr, kk, vv, ww, u, y,
                                                  state_out, Tn, H, hd);
  else if (hd <= 128)
    wkv6_kernel<T, 128><<<grid, block, 0, stream>>>(rr, kk, vv, ww, u, y,
                                                   state_out, Tn, H, hd);
  else
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// r, k, v, w: contiguous [B, T, H, hd] of one dtype (0 = float32,
// 1 = bfloat16); u: contiguous f32 [H, hd]; y: contiguous f32
// [B, T, H, hd]; state_out: contiguous f32 [B, H, hd, hd] or null.
// hd <= 128.  Returns the launch's CUDA error (0 = launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* y,
                           void* state_out, int B, int T, int H, int hd,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  cudaError_t err =
      dtype == 0 ? launch<float>(r, k, v, w, uf, yf, so, B, T, H, hd, st)
                 : launch<__nv_bfloat16>(r, k, v, w, uf, yf, so, B, T, H, hd,
                                         st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
