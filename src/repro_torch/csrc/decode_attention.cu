// Decode attention for Hopper (sm_90a): ONE query token per sequence
// against a ring-buffer KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (_decode_kernel, pl.pallas_call at decode_attention.py:88).
//
// What it computes, per sequence b and query head h (kv head h / G):
//   logits[s] = scale * q[b,h] . k[b,h/G,s]   (optionally softcapped)
//   valid iff 0 <= kpos[b,s] <= qpos[b] and, with a window, qpos-kpos < window
//   out[b,h] = softmax(masked logits) @ v[b,h/G]
// with masked logits set to -1e30 and f32 online-softmax state.
//
// Bound on this card: memory.  Every K and V byte of the cache is read
// once and each is used by only G multiply-adds per query head group, so
// the least time is (K bytes + V bytes) / 3.35 TB/s.
//
// Design: one block per (b, kv head); one warp per query head of the
// group, so the G heads that share a kv head read each cache tile from
// shared memory once instead of G times from device memory.  A group of
// more than 32 heads (granite-34b: G = 48) runs in ceil(G / 32) passes
// over the cache with G / passes warps each, so any G works.  The cache
// is read through the caller's strides (the model hands a transposed view
// of its [B, W, K, hd] ring cache), so it is never copied.  Each lane
// owns head_dim/32 elements of q and of the accumulator; a tile of K, V
// and slot positions is staged in shared memory with 16-byte loads, and
// the online-softmax update runs key by key in registers.  Split-S across
// blocks (flash-decoding) for small B*K is later work.
#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 8;  // head_dim <= 256

// At most 1024 threads: 32 warps, one query head each per pass.
template <typename T, int VEC>
__global__ void __launch_bounds__(1024) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kpos,
    const int* __restrict__ qpos, T* __restrict__ out, int H, int K, int S,
    int hd, int tile, long long q_sb, long long q_sh, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long kp_sb, long long kp_ss, long long qp_s,
    float scale, float softcap, int window) {
  extern __shared__ float smem[];
  float* sk = smem;                                      // [tile][hd]
  float* sv = sk + tile * hd;                            // [tile][hd]
  int* spos = reinterpret_cast<int*>(sv + tile * hd);    // [tile]

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int nwarps = blockDim.x >> 5;
  const int passes = (G + nwarps - 1) / nwarps;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nd = hd >> 5;
  const int qp = qpos[b * qp_s];
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  // Every warp runs every pass and every tile (the block synchronises per
  // tile); a warp with no head left in the last pass only helps load.
  for (int pass = 0; pass < passes; ++pass) {
    const int g = pass * nwarps + warp;
    const bool active = g < G;
    const int h = kh * G + (active ? g : 0);
    const T* qh = q + b * q_sb + h * q_sh;

    float qr[kMaxPerLane], acc[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      qr[i] = i < nd ? rt::to_f(qh[lane + 32 * i]) : 0.f;
      acc[i] = 0.f;
    }
    float m = rt::kNegInf;
    float l = 0.f;

    for (int s0 = 0; s0 < S; s0 += tile) {
      const int rows = min(tile, S - s0);
      __syncthreads();  // every warp is done with the previous tile
      const int nvec = rows * hd / VEC;
      for (int e = threadIdx.x; e < nvec; e += blockDim.x) {
        const int idx = e * VEC;
        const int r = idx / hd;
        const int c = idx - r * hd;
        rt::load_f<T, VEC>(kb + (s0 + r) * k_ss + c, sk + idx);
        rt::load_f<T, VEC>(vb + (s0 + r) * v_ss + c, sv + idx);
      }
      for (int r = threadIdx.x; r < rows; r += blockDim.x)
        spos[r] = kpos[b * kp_sb + (s0 + r) * kp_ss];
      __syncthreads();
      if (!active) continue;

      for (int r = 0; r < rows; ++r) {
        const float* kr = sk + r * hd;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i)
          if (i < nd) dot += qr[i] * kr[lane + 32 * i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float x = dot * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int kp = spos[r];
        const bool valid =
            kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
        if (!valid) x = rt::kNegInf;
        const float mn = fmaxf(m, x);
        const float corr = expf(m - mn);
        const float p = expf(x - mn);
        l = l * corr + p;
        const float* vr = sv + r * hd;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i)
          if (i < nd) acc[i] = acc[i] * corr + p * vr[lane + 32 * i];
        m = mn;
      }
    }

    if (active) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      T* o = out + ((long long)b * H + h) * hd;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i)
        if (i < nd) o[lane + 32 * i] = rt::from_f<T>(acc[i] * inv);
    }
  }
}

template <typename T, int VEC>
void launch(const void* q, const void* k, const void* v, const int* kpos,
            const int* qpos, void* out, int B, int H, int K, int S, int hd,
            int tile, const long long* st, float scale, float softcap,
            int window, cudaStream_t stream) {
  // ceil(G / 32) passes, with the group's heads spread evenly over them
  const int G = H / K;
  const int passes = (G + 31) / 32;
  const dim3 grid(B, K);
  const dim3 block(32 * ((G + passes - 1) / passes));
  const size_t smem = (size_t)2 * tile * hd * sizeof(float) +
                      (size_t)tile * sizeof(int);
  decode_attention_kernel<T, VEC><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kpos, qpos, static_cast<T*>(out), H, K, S,
      hd, tile, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], scale, softcap, window);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when every row start is
// 16-byte aligned (16-byte loads), else 0.  strides (elements): q_b, q_h,
// k_b, k_h, k_s, v_b, v_h, v_s, kpos_b, kpos_s, qpos.  The last dim of
// q, k and v is contiguous; out is a contiguous [B, H, hd].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kpos,
    const void* qpos, void* out, int B, int H, int K, int S, int hd,
    int tile, const long long* strides, float scale, float softcap,
    int window, int dtype, int vec, void* stream) {
  const int* kp = static_cast<const int*>(kpos);
  const int* qp = static_cast<const int*>(qpos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec)
      launch<float, 4>(q, k, v, kp, qp, out, B, H, K, S, hd, tile, strides,
                       scale, softcap, window, st);
    else
      launch<float, 1>(q, k, v, kp, qp, out, B, H, K, S, hd, tile, strides,
                       scale, softcap, window, st);
  } else {
    if (vec)
      launch<__nv_bfloat16, 8>(q, k, v, kp, qp, out, B, H, K, S, hd, tile,
                               strides, scale, softcap, window, st);
    else
      launch<__nv_bfloat16, 1>(q, k, v, kp, qp, out, B, H, K, S, hd, tile,
                               strides, scale, softcap, window, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
