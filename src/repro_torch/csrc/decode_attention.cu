// Decode attention for Hopper (sm_90a): ONE query token per sequence
// against a ring-buffer KV cache, split over the cache (flash-decoding).
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
// Bound on this card: memory.  The K and V rows of the valid slots must
// be read once and each is used by only G multiply-adds per query head
// group, so the least time is (their bytes + q, out, positions) / 3.35
// TB/s.  At the served path's B = 4, K = 4 there are 16 (b, kv head)
// pairs for 132 SMs, and most ring slots are still empty.
//
// Design: decode_split_kernel, grid (B, K * passes, splits), then the
// combine.
// Each block owns a contiguous range of `chunk` ring slots of one (b, kv
// head), so B * K * splits blocks cover the SMs about four times.  It
// first reads the sequence's whole kpos row and marks which of its tiles
// of 32 slots hold a valid slot; when the sequence has a valid slot
// anywhere, tiles without one are never loaded (they would weigh
// exp(-1e30 - m) = 0), and when it has none, every slot takes part, so
// the result is the reference's mean of V.  The remaining tiles of K and
// V are staged as they are stored (bf16 or f32, rows padded by 16 bytes
// against bank conflicts) with cp.async, double-buffered.  Lane r of a
// warp takes slot r of the tile and dots its K row with the warp's query
// heads (HPW of them, q widened to f32 in shared memory), so a tile costs
// one max and one sum across the warp per head instead of a reduction per
// key; then the lanes switch to head_dim (lane owns head_dim / 32
// columns) for P V.  The group's heads read each tile from shared memory,
// not from device memory.  A group of more than 64 heads is cut into
// passes, one block each.  Each block writes its (m, l, acc[head_dim])
// partials in f32 to scratch the wrapper allocated (m = -inf, l = 0,
// acc = 0 when all its tiles were skipped).  decode_combine_kernel, one
// block per (b, h), merges them into out; it is launched as a
// programmatic dependent, so its launch overlaps the split kernel.
//
// The cache is read through the caller's strides (the model hands a
// transposed view of its [B, W, K, hd] ring cache), so it is never copied.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTS = 32;          // cache slots per tile: one per lane
constexpr int kMaxPerLane = 8;   // head_dim / 32 <= 8

// 16 bytes from device memory into shared memory: cp.async when the
// source is 16-byte aligned, else element by element.
template <typename T, bool ASYNC>
__device__ __forceinline__ void copy16(uint8_t* dst, const T* src) {
  if constexpr (ASYNC) {
    rt::cp_async16(dst, src);
  } else {
    T* d = reinterpret_cast<T*>(dst);
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) d[i] = src[i];
  }
}

// 16 bytes of shared memory as floats
template <typename T>
__device__ __forceinline__ void load16_f(const uint8_t* p, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = rt::to_f(e[i]);
}

// The nd <= kMaxPerLane elements at p as floats, the rest of dst 0;
// one 8- or 16-byte load where the row's nd elements fill one (p is then
// aligned to it).
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, int nd, float* dst) {
#pragma unroll
  for (int e = 0; e < kMaxPerLane; ++e) dst[e] = 0.f;
  const int bytes = nd * (int)sizeof(T);
  if (bytes == 16) {
    load16_f<T>(reinterpret_cast<const uint8_t*>(p), dst);
  } else if (bytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8 / (int)sizeof(T); ++i) dst[i] = rt::to_f(e[i]);
  } else {
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e)
      if (e < nd) dst[e] = rt::to_f(p[e]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The tile after tile t that the block computes: every tile when the
// sequence has no valid slot at all (`any` = 0), else the next one that
// holds a valid slot.
__device__ __forceinline__ int next_tile(int t, int ntiles, int any,
                                         const int* sflag) {
  do {
    ++t;
  } while (any && t < ntiles && !sflag[t]);
  return t;
}

// Stage the K and V rows of the tile that starts at slot s0 (at most kTS
// rows, none past s_end) into one buffer of each, and commit the copies.
template <typename T, bool ASYNC>
__device__ __forceinline__ void stage_tile(const T* kb, const T* vb,
                                           long long k_ss, long long v_ss,
                                           int s0, int s_end, int hd,
                                           uint8_t* dk, uint8_t* dv,
                                           int row_bytes) {
  constexpr int E = 16 / sizeof(T);
  const int rows = min(kTS, s_end - s0);
  const int per_row = hd / E;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * E;
    copy16<T, ASYNC>(dk + r * row_bytes + c * (int)sizeof(T),
                     kb + (s0 + r) * k_ss + c);
    copy16<T, ASYNC>(dv + r * row_bytes + c * (int)sizeof(T),
                     vb + (s0 + r) * v_ss + c);
  }
  rt::cp_commit();
}

// HPW: query heads per warp.  ASYNC: K and V rows are 16-byte aligned.
// A minimum of one block per SM in the launch bounds leaves ptxas the
// registers it needs (it capped the 4-heads-a-warp instance at 80 and
// spilled without it).
template <typename T, int HPW, bool ASYNC>
__global__ void __launch_bounds__(256, 1) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kpos,
    const int* __restrict__ qpos, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int H, int K, int S, int hd, int chunk,
    int splits, int passes, int gpb, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long kp_sb, long long kp_ss,
    long long qp_s, float scale, float softcap, int window) {
  constexpr int E = 16 / sizeof(T);   // elements in 16 bytes
  extern __shared__ __align__(16) uint8_t smem[];
  const int row_bytes = hd * (int)sizeof(T) + 16;
  uint8_t* sk = smem;                                   // [2][kTS] rows
  uint8_t* sv = sk + 2 * kTS * row_bytes;               // [2][kTS] rows
  // the group's q rows in f32, [gpb][hd]
  float* sq = reinterpret_cast<float*>(sv + 2 * kTS * row_bytes);
  int* sflag = reinterpret_cast<int*>(sq + gpb * hd);   // [tiles]

  const int b = blockIdx.x;
  const int kh = blockIdx.y / passes;
  const int g0 = (blockIdx.y - kh * passes) * gpb;      // first head here
  const int split = blockIdx.z;
  const int G = H / K;
  const int ng = min(gpb, G - g0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nd = hd >> 5;
  const int s_begin = split * chunk;
  const int s_end = min(S, s_begin + chunk);
  const int ntiles = (s_end - s_begin + kTS - 1) / kTS;
  const int qp = qpos[b * qp_s];
  const int* kp_row = kpos + b * kp_sb;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  // the combine may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

  // Each thread loads 8 consecutive slot positions and E consecutive q
  // elements per round, the first round of positions issued before q's
  // loads: the block's set-up costs about one memory latency.
  int kp[8];
  auto load_positions = [&](int s0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      kp[j] = s0 + j < S ? __ldg(kp_row + (s0 + j) * kp_ss) : -1;
  };
  load_positions(tid * 8);
  for (int e0 = tid * E; e0 < ng * hd; e0 += blockDim.x * E) {
    const int g = e0 / hd;
    const T* src = q + b * q_sb + (kh * G + g0 + g) * q_sh + (e0 - g * hd);
    T raw[E];
#pragma unroll
    for (int e = 0; e < E; ++e) raw[e] = __ldg(src + e);
#pragma unroll
    for (int e = 0; e < E; ++e) sq[e0 + e] = rt::to_f(raw[e]);
  }
  for (int t = tid; t < ntiles; t += blockDim.x) sflag[t] = 0;
  __syncthreads();
  int any = 0;
  for (int s0 = tid * 8; s0 < S; s0 += blockDim.x * 8) {
    if (s0 != tid * 8) load_positions(s0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kp[j] >= 0 && kp[j] <= qp &&
          (window <= 0 || qp - kp[j] < window)) {
        any = 1;
        const int s = s0 + j;
        if (s >= s_begin && s < s_end) sflag[(s - s_begin) / kTS] = 1;
      }
    }
  }
  any = __syncthreads_or(any);
  float m[HPW], l[HPW], acc[HPW][kMaxPerLane];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e) acc[i][e] = 0.f;
  }

  int t = next_tile(-1, ntiles, any, sflag);
  int st = 0;
  if (t < ntiles)
    stage_tile<T, ASYNC>(kb, vb, k_ss, v_ss, s_begin + t * kTS, s_end, hd,
                         sk, sv, row_bytes);
  while (t < ntiles) {
    const int tn = next_tile(t, ntiles, any, sflag);
    if (tn < ntiles) {
      stage_tile<T, ASYNC>(kb, vb, k_ss, v_ss, s_begin + tn * kTS, s_end,
                           hd, sk + (st ^ 1) * kTS * row_bytes,
                           sv + (st ^ 1) * kTS * row_bytes, row_bytes);
      rt::cp_wait<1>();
    } else {
      rt::cp_wait<0>();
    }
    __syncthreads();   // tile t is in shared memory for every warp

    const int s0 = s_begin + t * kTS;
    const int rows = min(kTS, s_end - s0);
    const bool in = lane < rows;
    const int kp = in ? kp_row[(s0 + lane) * kp_ss] : -1;
    const bool valid =
        in && kp >= 0 && kp <= qp && (window <= 0 || qp - kp < window);
    const uint8_t* tk = sk + st * kTS * row_bytes;
    const uint8_t* tv = sv + st * kTS * row_bytes;

    // lane = slot: its K row against each of the warp's heads, with two
    // partial sums per head to halve the chain of dependent FMAs; q is
    // read from shared memory 16 bytes at a time (a broadcast)
    float dot[HPW][2];
#pragma unroll
    for (int i = 0; i < HPW; ++i) dot[i][0] = dot[i][1] = 0.f;
    const uint8_t* krow = tk + lane * row_bytes;
#pragma unroll 2
    for (int c = 0; c < hd; c += E) {
      float kf[E];
      load16_f<T>(krow + c * (int)sizeof(T), kf);
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int g = warp * HPW + i;
        if (g < ng) {
          const float4* qg =
              reinterpret_cast<const float4*>(sq + g * hd + c);
#pragma unroll
          for (int e4 = 0; e4 < E / 4; ++e4) {
            const float4 qv = qg[e4];
            float& d = dot[i][e4 & 1];
            d += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1];
            d += qv.z * kf[4 * e4 + 2] + qv.w * kf[4 * e4 + 3];
          }
        }
      }
    }
    float p[HPW];
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      float x = (dot[i][0] + dot[i][1]) * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x = !in ? -INFINITY : (valid ? x : rt::kNegInf);
      const float mn = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - mn);
      p[i] = expf(x - mn);
      l[i] = l[i] * corr + warp_sum(p[i]);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < kMaxPerLane; ++e) acc[i][e] *= corr;
    }
    // lane = columns lane*nd .. lane*nd + nd - 1: P V over the tile
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float vf[kMaxPerLane];
      load_cols<T>(reinterpret_cast<const T*>(tv + r * row_bytes) + lane * nd,
                   nd, vf);
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const float pr = __shfl_sync(0xffffffffu, p[i], r);
#pragma unroll
        for (int e = 0; e < kMaxPerLane; ++e) acc[i][e] += pr * vf[e];
      }
    }
    __syncthreads();   // every warp is done with this stage
    t = tn;
    st ^= 1;
  }

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp * HPW + i;
    if (g >= ng) continue;
    const long long idx =
        ((long long)b * H + kh * G + g0 + g) * splits + split;
    if (lane == 0) {
      part_ml[2 * idx] = m[i];
      part_ml[2 * idx + 1] = l[i];
    }
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e)
      if (e < nd) part_acc[idx * hd + lane * nd + e] = acc[i][e];
  }
}

// One block per (b, h): merge the splits' partials into out[b, h].  Warp
// 0 turns the splits' (m, l) into weights exp(m_i - M) in shared memory
// (0 for a split that computed nothing) and the inverse of the weighted
// sum of l; then every thread sums its columns of acc.  Launched as a
// programmatic dependent of the split kernel: its blocks may start while
// the split kernel runs and wait (griddepcontrol.wait) until that grid
// has finished and its writes are visible, so the launch costs no gap.
template <typename T>
__global__ void __launch_bounds__(256) decode_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    T* __restrict__ out, int splits, int hd) {
  extern __shared__ float w[];   // [splits] weights, then 1 / sum
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long bh = blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = -INFINITY;
    for (int s = lane; s < splits; s += 32) M = fmaxf(M, ml[2 * s]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float ws = ml[2 * s] == -INFINITY ? 0.f : expf(ml[2 * s] - M);
      w[s] = ws;
      L += ws * ml[2 * s + 1];
    }
    L = warp_sum(L);
    if (lane == 0) w[splits] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const float* acc = part_acc + bh * splits * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) a += w[s] * acc[s * hd + d];
    out[bh * hd + d] = rt::from_f<T>(a * w[splits]);
  }
}

template <typename T, int HPW, bool ASYNC>
int launch(const void* q, const void* k, const void* v, const int* kpos,
           const int* qpos, void* out, float* part_ml, float* part_acc,
           int B, int H, int K, int S, int hd, int splits, int chunk,
           int passes, int gpb, const long long* st, float scale,
           float softcap, int window, cudaStream_t stream) {
  const int warps = (gpb + HPW - 1) / HPW;
  const int tiles = (chunk + kTS - 1) / kTS;
  const size_t smem = (size_t)4 * kTS * (hd * sizeof(T) + 16) +
                      (size_t)gpb * hd * sizeof(float) + tiles * sizeof(int);
  auto kernel = decode_split_kernel<T, HPW, ASYNC>;
  static rt::SmemOptIn opted;
  cudaError_t err =
      rt::opt_in_smem(opted, reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(B, K * passes, splits), 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kpos, qpos, part_ml, part_acc, H, K, S, hd,
      chunk, splits, passes, gpb, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], scale, softcap, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(hd);
  cfg.dynamicSmemBytes = (splits + 1) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, decode_combine_kernel<T>, static_cast<const float*>(part_ml),
      static_cast<const float*>(part_acc), static_cast<T*>(out), splits,
      hd));
}

template <typename T, bool ASYNC>
int launch_hpw(const void* q, const void* k, const void* v, const int* kpos,
               const int* qpos, void* out, float* ml, float* acc, int B,
               int H, int K, int S, int hd, int splits, int chunk,
               const long long* st, float scale, float softcap, int window,
               cudaStream_t s) {
  // at most 64 heads of the group per block (q in shared memory), cut
  // evenly into passes; the fewest heads per warp that keep a block at 4
  // warps or fewer (8 heads a warp above 32 heads)
  const int G = H / K;
  const int passes = (G + 63) / 64;
  const int gpb = (G + passes - 1) / passes;
  const int hpw = gpb <= 4 ? 1 : gpb <= 8 ? 2 : gpb <= 16 ? 4 : 8;
#define RT_DECODE_LAUNCH(N)                                                 \
  launch<T, N, ASYNC>(q, k, v, kpos, qpos, out, ml, acc, B, H, K, S, hd,   \
                      splits, chunk, passes, gpb, st, scale, softcap,      \
                      window, s)
  switch (hpw) {
    case 1: return RT_DECODE_LAUNCH(1);
    case 2: return RT_DECODE_LAUNCH(2);
    case 4: return RT_DECODE_LAUNCH(4);
    default: return RT_DECODE_LAUNCH(8);
  }
#undef RT_DECODE_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when every K and V row start
// is 16-byte aligned (cp.async), else 0.  part_ml [B, H, splits, 2] and
// part_acc [B, H, splits, hd] are f32 scratch; split i owns ring slots
// [i * chunk, (i + 1) * chunk), chunk a multiple of 32.  strides
// (elements): q_b, q_h, k_b, k_h, k_s, v_b, v_h, v_s, kpos_b, kpos_s,
// qpos.  The last dim of q, k and v is contiguous; out is a contiguous
// [B, H, hd].  Returns the CUDA error of the two launches (0 = launched).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kpos,
    const void* qpos, void* out, void* part_ml, void* part_acc, int B,
    int H, int K, int S, int hd, int splits, int chunk,
    const long long* strides, float scale, float softcap, int window,
    int dtype, int vec, void* stream) {
  const int* kp = static_cast<const int*>(kpos);
  const int* qp = static_cast<const int*>(qpos);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_DECODE_ENTRY(T, ASYNC)                                           \
  launch_hpw<T, ASYNC>(q, k, v, kp, qp, out, ml, acc, B, H, K, S, hd,      \
                       splits, chunk, strides, scale, softcap, window, s)
  if (dtype == 0)
    return vec ? RT_DECODE_ENTRY(float, true) : RT_DECODE_ENTRY(float, false);
  return vec ? RT_DECODE_ENTRY(__nv_bfloat16, true)
             : RT_DECODE_ENTRY(__nv_bfloat16, false);
#undef RT_DECODE_ENTRY
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
