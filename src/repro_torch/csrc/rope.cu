// Half-split RoPE of the prefill's queries and keys in one launch, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference leaves RoPE
// (src/repro/models/layers.py apply_rope) to XLA, which fuses it into its
// neighbours.  The port's eager composition spends 17 launches on each of
// q and k (the frequency table alone is rebuilt with 4); this kernel
// rotates both from a frequency table built once.
//
// What it computes, for q [B, S, H, hd] and k [B, S, K, hd] at positions
// pos [B, S] (a [S] row of positions is passed with a zero batch stride):
// the angle of column i < hd / 2 is pos * freqs[i] in f32, and the pair
// (x1, x2) = (x[i], x[i + hd / 2]) becomes (x1 c - x2 s, x2 c + x1 s),
// each product and sum rounded where layers.apply_rope rounds it, the
// result rounded to the input's dtype.  qo and ko are written
// contiguous; q and k are read through their strides (head_dim
// contiguous).
//
// Bound on this card: bytes (q and k read and written once).  One block
// a (b, s) position: its first hd / 2 threads compute the angle's cosine
// and sine once into shared memory, then the block's threads take the
// (head, pair) items of q's and k's heads in turn, neighbouring threads
// on neighbouring columns.
#include "glue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHalf = 512;   // head_dim up to 1024

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* q, const T* k, const int* pos, const float* freqs,
                T* qo, T* ko, int S, int H, int K, int hd, long long qb,
                long long qs, long long qh, long long kb, long long ks,
                long long kh, long long pb, long long ps) {
  __shared__ float cs[kMaxHalf], sn[kMaxHalf];
  const int b = blockIdx.x / S, s = blockIdx.x % S;
  const int half = hd / 2;
  const int p = pos[b * pb + s * ps];
  for (int i = threadIdx.x; i < half; i += kThreads)
    rt::rope_angle(p, freqs[i], &cs[i], &sn[i]);
  __syncthreads();
  const long long row = static_cast<long long>(b) * S + s;
  for (int item = threadIdx.x; item < (H + K) * half; item += kThreads) {
    const int head = item / half, i = item % half;
    const T* x;
    T* o;
    if (head < H) {
      x = q + b * qb + s * qs + head * qh;
      o = qo + (row * H + head) * hd;
    } else {
      x = k + b * kb + s * ks + (head - H) * kh;
      o = ko + (row * K + head - H) * hd;
    }
    float o1, o2;
    rt::rope_rotate(rt::to_f(x[i]), rt::to_f(x[i + half]), cs[i], sn[i],
                    &o1, &o2);
    o[i] = rt::from_f<T>(o1);
    o[i + half] = rt::from_f<T>(o2);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const int* pos,
                   const float* freqs, void* qo, void* ko, int B, int S,
                   int H, int K, int hd, const long long* st_,
                   cudaStream_t st) {
  rope_kernel<T><<<B * S, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), pos, freqs,
      static_cast<T*>(qo), static_cast<T*>(ko), S, H, K, hd, st_[0], st_[1],
      st_[2], st_[3], st_[4], st_[5], st_[6], st_[7]);
  return cudaGetLastError();
}

}  // namespace

// q [B, S, H, hd] and k [B, S, K, hd] of one dtype (0 float32, 1
// bfloat16) with head_dim contiguous; pos int32; freqs f32 [hd / 2]; qo
// and ko contiguous, of q's and k's shapes.  strides (elements): q's b,
// s, h; k's b, s, h; pos's b, s.  Returns the launch's CUDA error (0 =
// launched).
extern "C" int rope_launch(const void* q, const void* k, const void* pos,
                           const void* freqs, void* qo, void* ko, int B,
                           int S, int H, int K, int hd,
                           const long long* strides, int dtype,
                           void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 0 || hd < 2 || hd % 2 ||
      hd / 2 > kMaxHalf || (long long)B * S > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const float* f = static_cast<const float*>(freqs);
  const cudaError_t err =
      dtype == 0 ? launch<float>(q, k, p, f, qo, ko, B, S, H, K, hd, strides,
                                 st)
                 : launch<__nv_bfloat16>(q, k, p, f, qo, ko, B, S, H, K, hd,
                                         strides, st);
  return static_cast<int>(err);
}

extern "C" const char* rope_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
