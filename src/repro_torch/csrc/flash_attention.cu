// Flash attention for Hopper (sm_90a): the prefill's causal / windowed /
// softcapped GQA attention with an online softmax over kv tiles.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, pl.pallas_call at flash_attention.py:95).
//
// What it computes, for q [B, H, S, hd] and k, v [B, K, S, hd]:
//   logits = scale * q k^T, optionally softcap * tanh(logits / softcap)
//   masked to -1e30 unless k_pos <= q_pos (causal) and q_pos - k_pos <
//   window (when a window is set); out = softmax(logits) v, in q's dtype,
//   with f32 accumulators.  Query head h reads kv head h / (H / K).
//
// Bound on this card: the larger of operations and bytes.  The causal
// products need about 2 * B * H * S^2 * hd floating-point operations, over
// 989 TFLOP/s (the bf16 tensor-core peak); q, k, v and out cross device
// memory once, over 3.35 TB/s.  Bytes set the bound at short prompts (the
// prefill's S = 256 at yi-9b widths), operations at long ones.  This
// first kernel does its
// multiply-adds with scalar f32 FMAs in the CUDA cores, which keeps it
// simple and exact in both input types but leaves it far from that bound:
// wgmma tiles with TMA loads and skipping fully masked kv tiles are later
// work.
//
// Design: one block of 256 threads per (query tile of 32 rows, b * h).
// The block stages its Q tile, then for every kv tile of 32 rows stages K
// and V (converted to f32, rows padded by one float against bank
// conflicts) in shared memory.  Thread t owns query row t / 8 and, of
// that row, 4 of the 32 scores and head_dim / 8 accumulator columns; the
// 8 threads of a row reduce the row max and sum with warp shuffles.  Any
// S is accepted: query rows past S are not stored and keys past S get
// zero weight, so the ragged edge is masked in the kernel rather than
// demanding S be a multiple of the tile.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 32;         // query rows per block
constexpr int kBK = 32;         // kv rows per tile
constexpr int kThreads = 256;   // 8 threads per query row
constexpr int kMaxCols = 32;    // head_dim / 8 <= 32, so head_dim <= 256

template <typename T, int VEC>
__device__ __forceinline__ void stage_rows(const T* base, long long row_stride,
                                           int row0, int S, int hd,
                                           float* dst, int ld) {
  const int nvec = kBQ * hd / VEC;
  for (int e = threadIdx.x; e < nvec; e += kThreads) {
    const int idx = e * VEC;
    const int r = idx / hd;
    const int c = idx - r * hd;
    float tmp[VEC];
    if (row0 + r < S) {
      rt::load_f<T, VEC>(base + (row0 + r) * row_stride + c, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * ld + c + i] = tmp[i];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int K, int S, int hd, long long q_sb, long long q_sh,
                       long long q_ss, long long k_sb, long long k_sh,
                       long long k_ss, long long v_sb, long long v_sh,
                       long long v_ss, float scale, float softcap,
                       int causal, int window) {
  static_assert(kBQ == kBK, "stage_rows stages kBQ rows for every tile");
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sq = smem;               // [kBQ][ld]
  float* sk = sq + kBQ * ld;      // [kBK][ld]
  float* sv = sk + kBK * ld;      // [kBK][ld]
  float* sp = sv + kBK * ld;      // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / K);
  const int t = threadIdx.x;
  const int r = t >> 3;           // query row within the tile
  const int sub = t & 7;          // lane within the row's 8 threads
  const int ncol = hd >> 3;
  const int qpos = q0 + r;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  stage_rows<T, VEC>(qb, q_ss, q0, S, hd, sq, ld);

  float m = rt::kNegInf;
  float l = 0.f;
  float acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // Q staged / previous K, V tile consumed
    stage_rows<T, VEC>(kb, k_ss, k0, S, hd, sk, ld);
    stage_rows<T, VEC>(vb, v_ss, k0, S, hd, sv, ld);
    __syncthreads();

    float s[4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = sub + 8 * j;
      const float* qr = sq + r * ld;
      const float* kr = sk + c * ld;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qr[d] * kr[d];
      float x = dot * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int kpos = k0 + c;
      if (kpos >= S) {
        x = -INFINITY;  // past the ragged edge: zero weight
      } else if ((causal && kpos > qpos) ||
                 (window > 0 && qpos - kpos >= window)) {
        x = rt::kNegInf;
      }
      s[j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[j] - mn);
      rowsum += p;
      sp[r * (kBK + 1) + sub + 8 * j] = p;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, off);
    l = l * corr + rowsum;
    m = mn;
    __syncwarp();  // a row's probabilities are written and read in-warp

#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncol) acc[j] *= corr;
    for (int c = 0; c < kBK; ++c) {
      const float p = sp[r * (kBK + 1) + c];
      const float* vr = sv + c * ld + sub;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < ncol) acc[j] += p * vr[8 * j];
    }
  }

  if (qpos < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* o = out + (((long long)b * H + h) * S + qpos) * hd;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < ncol) o[sub + 8 * j] = rt::from_f<T>(acc[j] * inv);
  }
}

template <typename T, int VEC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, int hd, const long long* st, float scale,
           float softcap, int causal, int window, cudaStream_t stream) {
  const size_t smem = ((size_t)(kBQ + 2 * kBK) * (hd + 1) +
                       (size_t)kBQ * (kBK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, K, S, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when every row start is
// 16-byte aligned (16-byte loads), else 0.  strides (elements): q_b, q_h,
// q_s, k_b, k_h, k_s, v_b, v_h, v_s.  The last dim of q, k and v is
// contiguous; out is a contiguous [B, H, S, hd].
// Returns the launch's CUDA error code (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int S, int hd, const long long* strides, float scale,
    float softcap, int causal, int window, int dtype, int vec,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(q, k, v, out, B, H, K, S, hd, strides,
                                  scale, softcap, causal, window, st)
               : launch<float, 1>(q, k, v, out, B, H, K, S, hd, strides,
                                  scale, softcap, causal, window, st);
  }
  return vec ? launch<__nv_bfloat16, 8>(q, k, v, out, B, H, K, S, hd,
                                        strides, scale, softcap, causal,
                                        window, st)
             : launch<__nv_bfloat16, 1>(q, k, v, out, B, H, K, S, hd,
                                        strides, scale, softcap, causal,
                                        window, st);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
