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
// of a, x, h0 and out over 3.35 TB/s.  Reaching it takes every load of
// the call in flight at once; one thread per channel walking all of T
// (B R = 10,240 threads at the served shape) keeps far too few.
//
// Design: T is split as well as R.  A thread owns one channel and one
// segment of `seg` steps; the W warps of a block take W consecutive
// segments of the same 32 channels, and the n_t blocks of a cluster (grid
// (ceil(R / 32), B, n_t), cluster (1, 1, n_t), n_t <= 8) take consecutive
// runs of W segments.
// - A segment of at most kStage = 32 steps is staged in shared memory
//   at the start (cp.async for f32; bf16 elements are 2 bytes, below
//   cp.async's least size, and are copied through registers): all loads
//   of the call are in flight together, and few registers keep every
//   block resident.  It is folded from zero into its composite (P_end =
//   prod a, h_end) and, once its carry-in is known, run again from the
//   carry over the staged steps: a and x are read from device memory once
//   and out written once.
// - The carries: after a block barrier, warp w composes the segments
//   before it from shared memory; the last warp publishes the block's
//   composite; after cluster.sync() each block folds the composites of
//   the blocks before it, read through distributed shared memory, into
//   h0.
// - A longer segment (T beyond 8 blocks of 8 warps of 32 steps) is swept
//   twice, two register buffers of steps taking turns so that one's loads
//   are in flight while the other computes; the second sweep re-reads a
//   and x, mostly from L2.
// - Segments past T are empty and compose as the identity; any T and R
//   are taken.
// The plan comes from the wrapper (kernels/rglru_scan.py: scan_plan): at
// the served shape, T = 256, clusters of 2 blocks of 4 warps of 32 steps.
// Larger clusters with shorter segments, and 16-byte lanes (4 f32
// channels a thread, whose 32 staged steps need 256 KB a block), were
// measured slower on the H100 (PERF.md).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 8;  // time segments per block
constexpr int kStage = 32;    // most steps a thread stages in shared memory
constexpr int kTS = 16;       // steps per register buffer (two sweeps)

// One element from device memory into shared memory: cp.async for f32,
// a plain copy for bf16 (cp.async copies 4, 8 or 16 bytes).
template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     rt::smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    *dst = *src;
  }
}

// kTS steps of a and x in registers, for a segment too long to stage: two
// of them take turns, so one's loads are in flight while the other
// computes.
struct Steps {
  float a[kTS], x[kTS];

  // load the steps from t0 (identity steps a = 1, x = 0 past `end`)
  template <typename T>
  __device__ __forceinline__ void load(const T* ap, const T* xp,
                                       long long R, int t0, int end) {
#pragma unroll
    for (int c = 0; c < kTS; ++c) {
      if (t0 + c < end) {
        a[c] = rt::to_f(ap[(t0 + c) * R]);
        x[c] = rt::to_f(xp[(t0 + c) * R]);
      } else {
        a[c] = 1.f, x[c] = 0.f;
      }
    }
  }

  // fold the steps into the composite (P, h) of the segment so far
  __device__ __forceinline__ void fold(float& P, float& h) const {
#pragma unroll
    for (int c = 0; c < kTS; ++c) {
      h = fmaf(a[c], h, x[c]);
      P *= a[c];
    }
  }

  // h_t = a_t h_{t-1} + x_t from h, stored for the steps before `end`
  __device__ __forceinline__ void run(float& h, float* op, long long R,
                                      int t0, int end) const {
#pragma unroll
    for (int c = 0; c < kTS; ++c) {
      h = fmaf(a[c], h, x[c]);
      if (t0 + c < end) op[(t0 + c) * R] = h;
    }
  }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(32 * kMaxWarps) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ x,
    const float* __restrict__ h0, float* __restrict__ out, int Tn, int R,
    int seg) {
  // shared memory: the block's composite (P, h) of its 32 channels, each
  // warp's segment composite, then (staged) each warp's steps of a and x
  extern __shared__ __align__(16) float smem[];
  const int W = blockDim.x / 32;
  float* s_blk = smem;             // [2][32]: P, then h
  float* s_segP = smem + 2 * 32;   // [W][32]
  float* s_segH = s_segP + W * 32;
  cg::cluster_group cluster = cg::this_cluster();

  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int rank = (int)cluster.block_rank();  // its place along T
  const int b = blockIdx.y;
  const int ch = blockIdx.x * 32 + lane;
  const bool live = ch < R;
  const int t_begin = min(Tn, (rank * W + wid) * seg);
  const int t_end = min(Tn, t_begin + seg);
  const int n = t_end - t_begin;
  const long long at = (long long)b * Tn * R + ch;
  const T* ap = a + at + (long long)t_begin * R;
  const T* xp = x + at + (long long)t_begin * R;
  float* op = out + at + (long long)t_begin * R;
  // this thread's staged steps: [kStage][32] per warp, a then x
  T* sa = reinterpret_cast<T*>(s_segH + W * 32) + wid * kStage * 32 + lane;
  T* sx = sa + W * kStage * 32;

  // this segment from zero: its composite (P, hl)
  float P = 1.f, hl = 0.f;
  if (live) {
    if constexpr (STAGED) {
#pragma unroll
      for (int c = 0; c < kStage; ++c)
        if (c < n) {
          stage_copy<T>(sa + c * 32, ap + c * (long long)R);
          stage_copy<T>(sx + c * 32, xp + c * (long long)R);
        }
      rt::cp_commit();
      rt::cp_wait<0>();  // each thread reads back only what it staged
#pragma unroll
      for (int c = 0; c < kStage; ++c)
        if (c < n) {
          const float av = rt::to_f(sa[c * 32]);
          hl = fmaf(av, hl, rt::to_f(sx[c * 32]));
          P *= av;
        }
    } else {
      Steps A, Bs;
      A.load(ap, xp, R, 0, n);
      for (int t0 = 0; t0 < n; t0 += 2 * kTS) {
        Bs.load(ap, xp, R, t0 + kTS, n);
        A.fold(P, hl);
        if (t0 + 2 * kTS < n) A.load(ap, xp, R, t0 + 2 * kTS, n);
        Bs.fold(P, hl);
      }
    }
  }
  s_segP[wid * 32 + lane] = P;
  s_segH[wid * 32 + lane] = hl;
  __syncthreads();

  // the composite (pp, ph) of this block's segments before this warp's
  float pp = 1.f, ph = 0.f;
  for (int w = 0; w < wid; ++w) {
    const float Pw = s_segP[w * 32 + lane];
    ph = fmaf(Pw, ph, s_segH[w * 32 + lane]);
    pp *= Pw;
  }
  if (wid == W - 1) {
    s_blk[lane] = pp * P;
    s_blk[32 + lane] = fmaf(P, ph, hl);
  }
  cluster.sync();  // every block's composite is visible in the cluster

  // carry into this block: h0, then the composites of blocks 0 .. rank-1
  float carry = h0 != nullptr && live ? h0[(long long)b * R + ch] : 0.f;
  for (int q = 0; q < rank; ++q) {
    const float* peer = cluster.map_shared_rank(s_blk, q);
    carry = fmaf(peer[lane], carry, peer[32 + lane]);
  }
  cluster_arrive();  // done reading the peers' shared memory
  carry = fmaf(pp, carry, ph);

  // the recurrence again from the carry, over the staged steps or a
  // second sweep of device memory (mostly served by L2)
  if (live) {
    if constexpr (STAGED) {
#pragma unroll
      for (int c = 0; c < kStage; ++c)
        if (c < n) {
          carry = fmaf(rt::to_f(sa[c * 32]), carry, rt::to_f(sx[c * 32]));
          op[c * (long long)R] = carry;
        }
    } else {
      Steps A, Bs;
      A.load(ap, xp, R, 0, n);
      for (int t0 = 0; t0 < n; t0 += 2 * kTS) {
        Bs.load(ap, xp, R, t0 + kTS, n);
        A.run(carry, op, R, t0, n);
        if (t0 + 2 * kTS < n) A.load(ap, xp, R, t0 + 2 * kTS, n);
        Bs.run(carry, op, R, t0 + kTS, n);
      }
    }
  }
  cluster_wait();  // no block leaves while a peer may still read it
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const float* h0,
                   float* out, int B, int Tn, int R, int nt, int warps,
                   int seg, cudaStream_t stream) {
  const bool staged = seg <= kStage;
  const size_t smem =
      (size_t)(2 + 2 * warps) * 32 * sizeof(float) +
      (staged ? (size_t)2 * warps * kStage * 32 * sizeof(T) : 0);
  auto kernel = staged ? rglru_scan_kernel<T, true>
                       : rglru_scan_kernel<T, false>;
  static rt::SmemOptIn opted[2];  // one per kernel: two sweeps, staged
  cudaError_t err = rt::opt_in_smem(
      opted[staged], reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + 31) / 32, B, nt);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nt;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a),
                            static_cast<const T*>(x), h0, out, Tn, R, seg);
}

}  // namespace

// a, x: contiguous [B, T, R] of one dtype (0 = float32, 1 = bfloat16);
// h0: contiguous f32 [B, R] or null (zero state); out: contiguous f32
// [B, T, R].  The plan: nt blocks per cluster along T (1..8), warps per
// block (1..8), seg steps per warp (nt * warps * seg >= T); segments of
// at most 32 steps are staged in shared memory, longer ones swept twice.
// Returns the launch's CUDA error (0 = launched).
extern "C" int rglru_scan_launch(const void* a, const void* x,
                                 const void* h0, void* out, int B, int T,
                                 int R, int dtype, int nt, int warps,
                                 int seg, void* stream) {
  if (nt < 1 || nt > 8 || warps < 1 || warps > kMaxWarps || seg < 0 ||
      (long long)nt * warps * seg < T)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h0);
  float* of = static_cast<float*>(out);
  const cudaError_t err =
      dtype == 0
          ? launch<float>(a, x, hf, of, B, T, R, nt, warps, seg, st)
          : launch<__nv_bfloat16>(a, x, hf, of, B, T, R, nt, warps, seg,
                                  st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
