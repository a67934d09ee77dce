// The MoE layer's router and the counts that place its (token, expert)
// pairs, for Hopper (sm_90a): two kernels launched back to back by one
// call.
//
// Replaces no TPU kernel: the reference routes with XLA ops
// (models/moe.py _router and the pairs' argsort), which XLA fuses.  The
// port's eager composition (models/moe.py moe_apply_grouped) spends about
// twenty launches a MoE call on this part: an f32 copy of x, the router's
// GEMV and its reduce, softmax, a sort over the experts, the load-balance
// statistics (a mean, zeros, scatter_add_, a division, a product, a sum),
// and the pairs' radix sort, counts and scan.
//
// moe_route_kernel, one block a tile of TT tokens (1 or 8):
//   logits[t, e] = sum_d x[t, d] w[d, e], x widened exactly to f32 and the
//   products accumulated in f32 (each thread over its rows d in order with
//   fused multiply-adds, the threads' partial sums then added in the order
//   of their rows); softmax in f32 as PyTorch's CUDA softmax writes it,
//   exp(l - max) / sum; the k largest probabilities, ties to the lower
//   expert (torch.sort(descending=True, stable=True), as the eager router
//   takes them); renormalised by max(sum, 1e-9) where asked.  Writes top_w
//   [T, k] f32 and top_i [T, k] int64, and for its tile: the count of each
//   expert among the tile's T*k choices and among its first choices, and
//   the sum of each expert's probabilities over the tile's tokens, in
//   token order.
// moe_scan_kernel, one block:
//   from the tiles' counts: ends[e], the inclusive prefix of the experts'
//   pair counts (int32: torch._grouped_mm's offs), and base[tile, e], the
//   place among the expert-sorted pairs of the tile's first pair routed to
//   e (the pairs of expert e before the tile, after every pair of the
//   experts before e); and the load-balance loss aux = E sum_e me[e] ce[e],
//   me the mean probability (the tile sums added in tile order, over T),
//   ce the share of first choices.  The counts are integers; every float
//   sum runs in a fixed order, so a call gives the same bits every run.
//
// Bound on this card: bytes at a tile of one token (the router's D x E f32
// weights, 512 KB at deepseek-moe-16b's width, read once), operations at
// large T (2 T D E on the f32 units, the weights read from L2 by each
// tile).  Sixteen warps keep a 16-byte load of each of their rows in
// flight; a tile of 8 tokens reuses each loaded weight eight times.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 256;      // columns of x staged in shared memory a pass
constexpr int kMaxE = 256;
constexpr int kMaxK = 8;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Every lane ends with the same sum: a + b == b + a in IEEE arithmetic.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The warp's best (v, i): the larger v, and of equal v the lower i.
__device__ __forceinline__ void warp_argmax(float* v, int* i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, *v, o);
    const int j = __shfl_xor_sync(kFull, *i, o);
    if (w > *v || (w == *v && j < *i)) {
      *v = w;
      *i = j;
    }
  }
}

template <typename T, int TT, int VEC>
__global__ void __launch_bounds__(kThreads)
    moe_route_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ top_w, long long* __restrict__ top_i,
                     int* __restrict__ hist, int* __restrict__ first,
                     float* __restrict__ psum, int n_tok, int D, int E,
                     int k, int renorm) {
  __shared__ float xs[TT][kChunk];
  __shared__ float red[kThreads * VEC];
  __shared__ float prob[TT][kMaxE];
  __shared__ int sel[TT][kMaxK];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int t0 = tile * TT;
  const int nt = min(TT, n_tok - t0);
  const int lanes = E / VEC;            // threads a row of w
  const int groups = kThreads / lanes;  // rows of w read at once
  const int q = tid % lanes, g = tid / lanes;
  const bool active = g < groups;

  // -- logits: each thread's rows d = g, g + groups, ... of its VEC columns
  float acc[TT][VEC];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[t][v] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    const int dn = min(kChunk, D - d0);
    for (int i = tid; i < TT * kChunk; i += kThreads) {
      const int t = i / kChunk, d = i % kChunk;
      xs[t][d] = t < nt && d < dn
                     ? rt::to_f(x[static_cast<long long>(t0 + t) * D + d0 + d])
                     : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int d = g; d < dn; d += groups) {
        float wv[VEC];
        rt::load_f<float, VEC>(
            w + static_cast<long long>(d0 + d) * E + q * VEC, wv);
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float xv = xs[t][d];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[t][v] = fmaf(xv, wv[v], acc[t][v]);
        }
      }
    }
    __syncthreads();
  }
  // the row groups' partial sums, added in group order, one token a round
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t < nt) {
      if (active) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) red[g * E + q * VEC + v] = acc[t][v];
      }
      __syncthreads();
      for (int e = tid; e < E; e += kThreads) {
        float s = red[e];
        for (int j = 1; j < groups; ++j) s = __fadd_rn(s, red[j * E + e]);
        prob[t][e] = s;  // the logit until the softmax below
      }
      __syncthreads();
    }
  }

  // -- softmax and top-k: one warp a token
  const int warp = tid / 32, lane = tid % 32;
  if (warp < nt) {
    const int t = warp;
    float m = -INFINITY;
    for (int e = lane; e < E; e += 32) m = fmaxf(m, prob[t][e]);
    m = warp_max(m);
    float s = 0.f;
    for (int e = lane; e < E; e += 32) {
      const float p = expf(prob[t][e] - m);
      prob[t][e] = p;
      s = __fadd_rn(s, p);
    }
    s = warp_sum(s);
    for (int e = lane; e < E; e += 32) prob[t][e] = __fdiv_rn(prob[t][e], s);
    __syncwarp();
    unsigned taken = 0;  // bit b: expert lane + 32 b is chosen
    float mine_w = 0.f, wsum = 0.f;
    int mine_i = 0;
    for (int j = 0; j < k; ++j) {
      float v = -INFINITY;
      int i = INT_MAX;
      for (int b = 0, e = lane; e < E; ++b, e += 32) {
        // experts in increasing order: a tie keeps the lower one
        if (!((taken >> b) & 1u) && prob[t][e] > v) {
          v = prob[t][e];
          i = e;
        }
      }
      warp_argmax(&v, &i);
      if ((i & 31) == lane) taken |= 1u << (i >> 5);
      if (lane == j) {
        mine_w = v;
        mine_i = i;
      }
      wsum = __fadd_rn(wsum, v);
      if (lane == 0) sel[t][j] = i;
    }
    if (renorm) mine_w = __fdiv_rn(mine_w, fmaxf(wsum, 1e-9f));
    if (lane < k) {
      const long long at = static_cast<long long>(t0 + t) * k + lane;
      top_w[at] = mine_w;
      top_i[at] = mine_i;
    }
  }
  __syncthreads();

  // -- the tile's counts and probability sums, one thread an expert
  for (int e = tid; e < E; e += kThreads) {
    int c = 0, f = 0;
    float ps = 0.f;
    for (int t = 0; t < nt; ++t) {
      ps = __fadd_rn(ps, prob[t][e]);
      f += sel[t][0] == e;
      for (int j = 0; j < k; ++j) c += sel[t][j] == e;
    }
    hist[tile * E + e] = c;
    first[tile * E + e] = f;
    psum[tile * E + e] = ps;
  }
}

// One block.  Thread (c, e) owns expert e over the c-th run of tiles.
__global__ void __launch_bounds__(kScanThreads)
    moe_scan_kernel(const int* __restrict__ hist,
                    const int* __restrict__ first,
                    const float* __restrict__ psum, int* __restrict__ ends,
                    int* __restrict__ base, float* __restrict__ aux,
                    int tiles, int n_tok, int E) {
  __shared__ int s_cnt[kScanThreads];
  __shared__ int s_first[kScanThreads];
  __shared__ float s_ps[kScanThreads];
  __shared__ int s_total[kMaxE];
  __shared__ float s_prod[kMaxE];
  __shared__ int s_start[kMaxE];
  const int tid = threadIdx.x;
  const int runs = kScanThreads / E;
  const int c = tid / E, e = tid % E;
  const int per = (tiles + runs - 1) / runs;
  const int lo = min(tiles, c * per), hi = min(tiles, lo + per);
  if (c < runs) {
    int n = 0, f = 0;
    float ps = 0.f;
    for (int i = lo; i < hi; ++i) {
      n += hist[i * E + e];
      f += first[i * E + e];
      ps = __fadd_rn(ps, psum[i * E + e]);
    }
    s_cnt[tid] = n;
    s_first[tid] = f;
    s_ps[tid] = ps;
  }
  __syncthreads();
  if (tid < E) {
    int n = 0, f = 0;
    float ps = 0.f;
    for (int r = 0; r < runs; ++r) {
      n += s_cnt[r * E + tid];
      f += s_first[r * E + tid];
      ps = __fadd_rn(ps, s_ps[r * E + tid]);
    }
    const float me = __fdiv_rn(ps, static_cast<float>(n_tok));
    const float ce = __fdiv_rn(static_cast<float>(f),
                               static_cast<float>(n_tok));
    s_total[tid] = n;
    s_prod[tid] = __fmul_rn(me, ce);
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    float dot = 0.f;
    for (int x = 0; x < E; ++x) {
      s_start[x] = run;
      run += s_total[x];
      ends[x] = run;
      dot = __fadd_rn(dot, s_prod[x]);
    }
    *aux = __fmul_rn(static_cast<float>(E), dot);
  }
  __syncthreads();
  if (c < runs) {
    int run = s_start[e];
    for (int r = 0; r < c; ++r) run += s_cnt[r * E + e];
    for (int i = lo; i < hi; ++i) {
      base[i * E + e] = run;
      run += hist[i * E + e];
    }
  }
}

template <typename T, int TT, int VEC>
cudaError_t launch(const void* x, const void* w, void* top_w, void* top_i,
                   int* ints, float* sums, int n_tok, int D, int E, int k,
                   int renorm, cudaStream_t st) {
  const int tiles = (n_tok + TT - 1) / TT;
  int* ends = ints;
  int* hist = ints + E;
  int* first = hist + static_cast<long long>(tiles) * E;
  int* base = first + static_cast<long long>(tiles) * E;
  float* aux = sums;
  float* psum = sums + 1;
  moe_route_kernel<T, TT, VEC><<<tiles, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<float*>(top_w), static_cast<long long*>(top_i), hist, first,
      psum, n_tok, D, E, k, renorm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_scan_kernel<<<1, kScanThreads, 0, st>>>(hist, first, psum, ends, base,
                                              aux, tiles, n_tok, E);
  return cudaGetLastError();
}

template <typename T, int TT>
cudaError_t launch_vec(int vec, const void* x, const void* w, void* top_w,
                       void* top_i, int* ints, float* sums, int n_tok, int D,
                       int E, int k, int renorm, cudaStream_t st) {
  return vec ? launch<T, TT, 4>(x, w, top_w, top_i, ints, sums, n_tok, D, E,
                                k, renorm, st)
             : launch<T, TT, 1>(x, w, top_w, top_i, ints, sums, n_tok, D, E,
                                k, renorm, st);
}

template <typename T>
cudaError_t launch_tile(int tile, int vec, const void* x, const void* w,
                        void* top_w, void* top_i, int* ints, float* sums,
                        int n_tok, int D, int E, int k, int renorm,
                        cudaStream_t st) {
  return tile == 1 ? launch_vec<T, 1>(vec, x, w, top_w, top_i, ints, sums,
                                      n_tok, D, E, k, renorm, st)
                   : launch_vec<T, 8>(vec, x, w, top_w, top_i, ints, sums,
                                      n_tok, D, E, k, renorm, st);
}

}  // namespace

// x: [n_tok, D] contiguous (dtype 0 float32, 1 bfloat16); w: the router,
// [D, E] f32 contiguous; top_w: [n_tok, k] f32; top_i: [n_tok, k] int64.
// ints: int32 [E + 3 tiles E], written as ends [E], then each tile's
// counts of all choices [tiles, E], of first choices [tiles, E], and its
// bases [tiles, E]; sums: f32 [1 + tiles E], aux then each tile's
// probability sums.  tiles = ceil(n_tok / tile), tile 1 or 8.  vec: E a
// multiple of 4 and w 16-byte aligned.  1 <= k <= min(E, 8), E <= 256.
// Returns the launches' CUDA error (0 = both launched).
extern "C" int moe_route_launch(const void* x, const void* w, void* top_w,
                                void* top_i, void* ints, void* sums,
                                int n_tok, int D, int E, int k, int renorm,
                                int tile, int dtype, int vec, void* stream) {
  if (n_tok < 1 || D < 1 || E < 1 || E > kMaxE || k < 1 || k > kMaxK ||
      k > E || (tile != 1 && tile != 8) || (vec && E % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* iw = static_cast<int*>(ints);
  float* fw = static_cast<float*>(sums);
  cudaError_t err =
      dtype == 0 ? launch_tile<float>(tile, vec, x, w, top_w, top_i, iw, fw,
                                      n_tok, D, E, k, renorm, st)
                 : launch_tile<__nv_bfloat16>(tile, vec, x, w, top_w, top_i,
                                              iw, fw, n_tok, D, E, k, renorm,
                                              st);
  return static_cast<int>(err);
}

extern "C" const char* moe_route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
