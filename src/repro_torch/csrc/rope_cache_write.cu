// One decode step's RoPE and ring-cache write in one launch, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference leaves RoPE and the ring write
// (src/repro/models/transformer.py, the decode step's .at[].set) to XLA.
// The port's eager composition spends about 41 launches on them a layer:
// 17 for each of q's and k's rotations and 7 for the write (pos % W, the
// batch index, three index_put_ and the positions' cast).  This kernel is
// one; decode_attention then reads the written cache as before.
//
// What it computes, for q [B, 1, H, hd], k and v [B, 1, K, hd], pos [B]
// int32 and this layer's ring kc, vc [B, W, K, hd] and pc [B, W] int32:
//   slot  = pos[b] mod W (never negative)
//   qo[b] = rope(q[b], pos[b]),  kc[b, slot] = rope(k[b], pos[b]),
//   vc[b, slot] = v[b],          pc[b, slot] = pos[b]
// with rope the half-split rotation of rope.cu at the angle pos * freqs[i]
// (f32, precise sincosf), rounded where layers.apply_rope rounds it.
// Without freqs (rope_theta <= 0) nothing is rotated: k is written as it
// is and q is left to the caller.
//
// Bound on this card: latency (a few KB a step).  One block of hd / 2
// threads per (b, head) over q's, k's and v's heads; a thread takes the
// pair (i, i + hd / 2).  Every tensor is addressed through its strides
// (head_dim contiguous), so the ring slices of the step's cache copy are
// written in place.
#include "glue.cuh"

namespace {

// Element strides: q's b, h; k's b, h; v's b, h; kc's b, w, h; vc's b, w,
// h; pc's b, w; pos's b.
struct Strides {
  long long qb, qh, kb, kh, vb, vh, kcb, kcw, kch, vcb, vcw, vch, pcb, pcw,
      pb;
};

template <typename T>
__device__ __forceinline__ void rotate_pair(const T* x, T* o, int i,
                                            int half, int p,
                                            const float* freqs) {
  float c, s, o1, o2;
  rt::rope_angle(p, freqs[i], &c, &s);
  rt::rope_rotate(rt::to_f(x[i]), rt::to_f(x[i + half]), c, s, &o1, &o2);
  o[i] = rt::from_f<T>(o1);
  o[i + half] = rt::from_f<T>(o2);
}

template <typename T>
__global__ void rope_cache_write_kernel(const T* q, const T* k, const T* v,
                                        const int* pos, const float* freqs,
                                        T* qo, T* kc, T* vc, int* pc, int H,
                                        int K, int W, int hd, Strides st) {
  const int b = blockIdx.x, head = blockIdx.y, i = threadIdx.x;
  const int half = hd / 2;
  const int p = pos[b * st.pb];
  const int slot = ((p % W) + W) % W;
  if (head < H) {
    if (freqs)
      rotate_pair(q + b * st.qb + head * st.qh,
                  qo + (static_cast<long long>(b) * H + head) * hd, i, half,
                  p, freqs);
  } else if (head < H + K) {
    const int h = head - H;
    const T* x = k + b * st.kb + h * st.kh;
    T* o = kc + b * st.kcb + slot * st.kcw + h * st.kch;
    if (freqs) {
      rotate_pair(x, o, i, half, p, freqs);
    } else {
      o[i] = x[i];
      o[i + half] = x[i + half];
    }
    if (h == 0 && i == 0) pc[b * st.pcb + slot * st.pcw] = p;
  } else {
    const int h = head - H - K;
    const T* x = v + b * st.vb + h * st.vh;
    T* o = vc + b * st.vcb + slot * st.vcw + h * st.vch;
    o[i] = x[i];
    o[i + half] = x[i + half];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, const float* freqs, void* qo, void* kc,
                   void* vc, int* pc, int B, int H, int K, int W, int hd,
                   const Strides& st, cudaStream_t stream) {
  rope_cache_write_kernel<T><<<dim3(B, H + 2 * K), hd / 2, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, freqs, static_cast<T*>(qo),
      static_cast<T*>(kc), static_cast<T*>(vc), pc, H, K, W, hd, st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, kc, vc of one dtype (0 float32, 1 bfloat16) with head_dim
// contiguous; pos and pc int32; freqs f32 [hd / 2], or null for no
// rotation; qo [B, 1, H, hd] contiguous (not written without freqs).
// strides: 15 element strides in the order of struct Strides.  Returns
// the launch's CUDA error (0 = launched).
extern "C" int rope_cache_write_launch(
    const void* q, const void* k, const void* v, const void* pos,
    const void* freqs, void* qo, void* kc, void* vc, void* pc, int B, int H,
    int K, int W, int hd, const long long* strides, int dtype,
    void* stream) {
  if (B < 1 || H < 0 || K < 1 || H + 2 * K > 65535 ||
      W < 1 || hd < 2 || hd % 2 || hd / 2 > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5],  s[6], s[7],
                   s[8], s[9], s[10], s[11], s[12], s[13], s[14]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const float* f = static_cast<const float*>(freqs);
  int* pcp = static_cast<int*>(pc);
  const cudaError_t err =
      dtype == 0 ? launch<float>(q, k, v, p, f, qo, kc, vc, pcp, B, H, K, W,
                                 hd, st, cs)
                 : launch<__nv_bfloat16>(q, k, v, p, f, qo, kc, vc, pcp, B,
                                         H, K, W, hd, st, cs);
  return static_cast<int>(err);
}

extern "C" const char* rope_cache_write_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
