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
// Bound on this card: bytes, with the operations close behind.  With
// q_t = r_t * u * k_t taken out of the sum, y_t[j] = sum_i r_t[i] S[i,j]
// + v_t[j] * sum_i q_t[i], and each step does 5 * hd * hd f32 operations
// (a multiply-add for r.S, the product k v and a multiply-add for the
// decay) on CUDA cores.  The least time is the larger of 5 B T H hd^2 /
// 67 TFLOP/s and the bytes of r, k, v, w, u, y and the state over 3.35
// TB/s.  Three instructions per state entry and step are the floor in
// f32; the tensor cores take f32 only as TF32 (about 3 digits), too
// coarse for a recurrence held at 1e-4.  The steps are sequential, so one
// (b, h) is one SM's work for all of T: what decides the time is how many
// of its warps can issue, and what each state entry costs besides the
// three instructions.
//
// Design: the state stays in registers, cut into tiles of 4 rows by kCC =
// 4 columns, one per thread.  A block owns kCB <= 64 columns of one
// (b, h) (grid (H, B, ceil(hd / kCB))); its L = hd_max / 4 lanes of a
// column group lie in one warp.  At hd = 64 that is 256 threads, 8 warps
// per (b, h) where one thread per column gave 2.
// - Per step a lane reads its rows' r, k and w and its columns' v from
//   shared memory, one float4 each (the next step's while this step's
//   multiply-adds run), for 16 state entries: a quarter of the shared
//   loads per entry of a column split over lanes of 16 rows.
// - Each lane's partial sums of r.S for its columns are combined over
//   the L lanes by a shuffle reduce-scatter every kRS = 8 steps (32
//   partials a lane; log2 L rounds, after which lane g holds the sums of
//   partials g, g + L, ...), not every step.
// - The sum of q_t over i, the same for every column, is computed once
//   per step by one warp into shared memory.
// - Inputs are staged kSteps = 8 steps at a time in a ring of three
//   shared buffers: the next chunk's copy is in flight while a chunk
//   computes (cp.async for 16-byte-aligned f32, else loads held in
//   registers and stored after the chunk), and a chunk's y is written
//   after the next barrier, when the sums of q are visible, from the
//   buffer the copy in flight does not touch.
// - Rows i >= hd and columns past hd are zero in shared memory and add
//   nothing; the steps past T of a ragged last chunk are skipped.
// Measured on the H100 (PERF.md): about 0.17 us a step, the same for one
// block alone, of which the arithmetic is a small part; ptxas hoists a
// reduce-scatter group's shared loads ahead of its multiply-adds, so the
// shared-memory and FMA pipes of the block's 8 warps take turns rather
// than overlap.
#include "common.cuh"

namespace {

constexpr int kSteps = 8;  // time steps per staged chunk
constexpr int kCols = 64;  // most columns per block
constexpr int kRing = 3;   // staged chunks: computing, in flight, drained
constexpr int kCC = 4;     // columns of S per thread
constexpr int kV = 32;     // partials per lane per reduce-scatter

// A block of one (b, h) owns kCB columns of S; lane g of a column group
// owns rows 4g .. 4g+3 of kCC neighbouring columns.
template <int MAXHD>
struct Plan {
  static constexpr int kLanes = MAXHD / 4;                   // 8, 16, 32
  static constexpr int kCB = MAXHD < kCols ? MAXHD : kCols;  // columns
  static constexpr int kThreads = kLanes * (kCB / kCC);
  static constexpr int kRS = kV / kCC;  // steps per reduce-scatter
  static constexpr int kPer = kSteps * kCC / kLanes;  // y values per lane
  static_assert(32 % kLanes == 0 && kSteps % kRS == 0 && kPer >= 1,
                "a column group lies in one warp; reductions fit a chunk");
  static_assert(kSteps * MAXHD % kThreads == 0 &&
                    kSteps * kCB % kThreads == 0,
                "every thread stages the same number of values");
};

// One staged chunk, widened to f32.
template <int MAXHD>
struct __align__(16) Stage {
  float r[kSteps][MAXHD];
  float k[kSteps][MAXHD];
  float w[kSteps][MAXHD];
  float v[kSteps][MAXHD < kCols ? MAXHD : kCols];  // this block's columns
  float sq[kSteps];                                 // sum_i r * u * k
};

// Where one block reads its chunks from: the (b, h) row at t = 0 and the
// element stride of one step.
template <typename T>
struct Src {
  const T* __restrict__ r;
  const T* __restrict__ k;
  const T* __restrict__ v;
  const T* __restrict__ w;
  long long base, row;
  int hd, j0, cbw;
};

// Copy the chunk at t0 (`steps` steps) into `s` with cp.async, 16 bytes
// at a time (f32, hd % 4 == 0, 16-byte-aligned rows).
template <int MAXHD, int NT>
__device__ __forceinline__ void stage_async(Stage<MAXHD>& s,
                                            const Src<float>& in, int t0,
                                            int steps) {
  constexpr int Q = MAXHD / 4;
  constexpr int QV = (MAXHD < kCols ? MAXHD : kCols) / 4;
  for (int e = threadIdx.x; e < kSteps * Q; e += NT) {
    const int c = e / Q, i = 4 * (e % Q);
    if (c < steps && i < in.hd) {
      const long long off = in.base + (t0 + c) * in.row + i;
      rt::cp_async16(&s.r[c][i], in.r + off);
      rt::cp_async16(&s.k[c][i], in.k + off);
      rt::cp_async16(&s.w[c][i], in.w + off);
    }
  }
  for (int e = threadIdx.x; e < kSteps * QV; e += NT) {
    const int c = e / QV, j = 4 * (e % QV);
    if (c < steps && j < in.cbw)
      rt::cp_async16(&s.v[c][j],
                     in.v + in.base + (t0 + c) * in.row + in.j0 + j);
  }
}

// The same chunk through registers (bf16, or rows that are not 16-byte
// aligned): load() issues the loads, store() widens them into a stage.
template <typename T, int MAXHD, int NT>
struct Held {
  static constexpr int CB = MAXHD < kCols ? MAXHD : kCols;
  static constexpr int N = kSteps * MAXHD / NT;  // r, k, w values each
  static constexpr int NV = kSteps * CB / NT;    // v values
  float r[N], k[N], w[N], v[NV];

  __device__ __forceinline__ void load(const Src<T>& in, int t0,
                                       int steps) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * NT, c = e / MAXHD, i = e % MAXHD;
      const bool ok = c < steps && i < in.hd;
      const long long off = in.base + (t0 + c) * in.row + i;
      r[n] = ok ? rt::to_f(in.r[off]) : 0.f;
      k[n] = ok ? rt::to_f(in.k[off]) : 0.f;
      w[n] = ok ? rt::to_f(in.w[off]) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = threadIdx.x + n * NT, c = e / CB, j = e % CB;
      const bool ok = c < steps && j < in.cbw;
      v[n] = ok ? rt::to_f(in.v[in.base + (t0 + c) * in.row + in.j0 + j])
                : 0.f;
    }
  }

  __device__ __forceinline__ void store(Stage<MAXHD>& s) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * NT, c = e / MAXHD, i = e % MAXHD;
      s.r[c][i] = r[n];
      s.k[c][i] = k[n];
      s.w[c][i] = w[n];
    }
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = threadIdx.x + n * NT;
      s.v[e / CB][e % CB] = v[n];
    }
  }
};

// sum_i r_t[i] * u[i] * k_t[i] for the chunk's steps, one warp a step.
template <int MAXHD, int NT>
__device__ __forceinline__ void sum_q(Stage<MAXHD>& s, const float* s_u,
                                      int steps) {
  const int lane = threadIdx.x % 32;
  for (int c = threadIdx.x / 32; c < steps; c += NT / 32) {
    float q = 0.f;
#pragma unroll
    for (int i = lane; i < MAXHD; i += 32)
      q = fmaf(s.r[c][i] * s_u[i], s.k[c][i], q);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      q += __shfl_xor_sync(0xffffffffu, q, m);
    if (lane == 0) s.sq[c] = q;
  }
}

// The operands of one step for a lane: its 4 rows of r, k and w and its
// kCC columns of v.
template <int MAXHD>
struct Operands {
  float4 r, k, w;
  float v[kCC];

  __device__ __forceinline__ void load(const Stage<MAXHD>& s, int c, int g,
                                       int jl) {
    r = reinterpret_cast<const float4*>(s.r[c])[g];
    k = reinterpret_cast<const float4*>(s.k[c])[g];
    w = reinterpret_cast<const float4*>(s.w[c])[g];
#pragma unroll
    for (int cc = 0; cc < kCC; cc += 4) {
      const float4 v4 = *reinterpret_cast<const float4*>(&s.v[c][jl + cc]);
      v[cc] = v4.x, v[cc + 1] = v4.y, v[cc + 2] = v4.z, v[cc + 3] = v4.w;
    }
  }
};

// kRS steps from step c0 of the chunk on this lane's 4 rows and kCC
// columns (from column jl of the block): p[cs * kCC + cc] is the lane's
// partial sum_i r[i] S[i, jl + cc] of step c0 + cs (0 past `steps`).  The
// next step's operands are loaded before this step's arithmetic.
template <int MAXHD, bool TAIL>
__device__ __forceinline__ void run_steps(const Stage<MAXHD>& s, int c0,
                                          int g, int jl, int steps,
                                          float (&S)[4][kCC],
                                          float (&p)[kV]) {
  constexpr int RS = Plan<MAXHD>::kRS;
  Operands<MAXHD> cur, nxt;
  cur.load(s, c0, g, jl);
#pragma unroll
  for (int cs = 0; cs < RS; ++cs) {
    const int c = c0 + cs;
    if (cs + 1 < RS) nxt.load(s, c + 1, g, jl);
    if (TAIL && c >= steps) {
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) p[cs * kCC + cc] = 0.f;
    } else {
#pragma unroll
      for (int cc = 0; cc < kCC; ++cc) {
        float acc = cur.r.x * S[0][cc];
        acc = fmaf(cur.r.y, S[1][cc], acc);
        acc = fmaf(cur.r.z, S[2][cc], acc);
        p[cs * kCC + cc] = fmaf(cur.r.w, S[3][cc], acc);
        S[0][cc] = fmaf(cur.w.x, S[0][cc], cur.k.x * cur.v[cc]);
        S[1][cc] = fmaf(cur.w.y, S[1][cc], cur.k.y * cur.v[cc]);
        S[2][cc] = fmaf(cur.w.z, S[2][cc], cur.k.z * cur.v[cc]);
        S[3][cc] = fmaf(cur.w.w, S[3][cc], cur.k.w * cur.v[cc]);
      }
    }
    if (cs + 1 < RS) cur = nxt;
  }
}

// Reduce-scatter of the L lanes' partials: afterwards p[L * n] of lane g
// holds the sum over the lanes of partial L * n + g.
template <int L>
__device__ __forceinline__ void reduce_scatter(float (&p)[kV], int g) {
#pragma unroll
  for (int m = L / 2; m >= 1; m >>= 1) {
    const bool hi = (g & m) != 0;
#pragma unroll
    for (int c = 0; c < kV; ++c) {
      if (c & (L - m)) continue;  // c holds the pair (c, c | m)
      const float send = hi ? p[c] : p[c | m];
      const float keep = hi ? p[c | m] : p[c];
      p[c] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
}

// y of the chunk at t0 from the reduced partials yv (kPer per lane): the
// n-th of reduce-scatter q is partial L * n + g of steps q * kRS onwards,
// that is step q * kRS + (L n + g) / kCC and column jl + (L n + g) % kCC.
template <int MAXHD>
__device__ __forceinline__ void write_y(
    const Stage<MAXHD>& s, const float (&yv)[Plan<MAXHD>::kPer],
    float* __restrict__ y, long long at, long long row, int steps, int g,
    int jl, int jmax) {
  using P = Plan<MAXHD>;
  constexpr int PER = kV / P::kLanes;  // per reduce-scatter
#pragma unroll
  for (int q = 0; q < kSteps / P::kRS; ++q)
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int idx = P::kLanes * n + g;
      const int c = q * P::kRS + idx / kCC, col = jl + idx % kCC;
      if (c < steps && col < jmax)
        y[at + c * row + col] =
            fmaf(s.v[c][col], s.sq[c], yv[q * PER + n]);
    }
}

template <typename T, int MAXHD, bool ASYNC>
__global__ void __launch_bounds__(Plan<MAXHD>::kThreads, 1) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const float* __restrict__ u, float* __restrict__ y,
    float* __restrict__ state_out, int Tn, int H, int hd) {
  using P = Plan<MAXHD>;
  constexpr int L = P::kLanes, CB = P::kCB, NT = P::kThreads;
  constexpr int PER = kV / L;
  // the chunk computing, the next one in flight, and the one before,
  // whose y is written after the next barrier
  __shared__ Stage<MAXHD> st[kRing];
  __shared__ float s_u[MAXHD];

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = threadIdx.x % L;          // rows 4g .. 4g+3
  const int jl = threadIdx.x / L * kCC;    // first column within the block
  const int j0 = blockIdx.z * CB;
  const int jmax = min(CB, hd - j0);      // columns this block owns
  const long long row = (long long)H * hd;
  const long long base = ((long long)b * Tn * H + h) * hd;
  const Src<T> in{r, k, v, w, base, row, hd, j0, jmax};

  // zero the ring (padding rows and columns stay zero) before any copy
  float* flat = reinterpret_cast<float*>(st);
  for (int e = threadIdx.x; e < (int)(sizeof(st) / sizeof(float)); e += NT)
    flat[e] = 0.f;
  for (int i = threadIdx.x; i < MAXHD; i += NT)
    s_u[i] = i < hd ? u[h * hd + i] : 0.f;
  __syncthreads();

  float S[4][kCC];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int cc = 0; cc < kCC; ++cc) S[e][cc] = 0.f;
  float p[kV];
  float yv[P::kPer];
#pragma unroll
  for (int n = 0; n < P::kPer; ++n) yv[n] = 0.f;

  const int chunks = (Tn + kSteps - 1) / kSteps;
  Held<T, MAXHD, NT> held;
  if (chunks > 0) {
    if constexpr (ASYNC) {
      stage_async<MAXHD, NT>(st[0], in, 0, min(kSteps, Tn));
      rt::cp_commit();
    } else {
      held.load(in, 0, min(kSteps, Tn));
      held.store(st[0]);
    }
  }
  for (int n = 0; n < chunks; ++n) {
    Stage<MAXHD>& cur = st[n % kRing];
    const int t0 = n * kSteps, steps = min(kSteps, Tn - t0);
    if constexpr (ASYNC) rt::cp_wait<0>();
    __syncthreads();  // chunk n landed; chunk n-1's sums of q are visible
    if (n > 0)
      write_y<MAXHD>(st[(n - 1) % kRing], yv, y,
                         base + (t0 - kSteps) * row + j0, row, kSteps, g,
                         jl, jmax);
    if (n + 1 < chunks) {  // into the slot of chunk n - 2
      const int nsteps = min(kSteps, Tn - t0 - kSteps);
      if constexpr (ASYNC) {
        stage_async<MAXHD, NT>(st[(n + 1) % kRing], in, t0 + kSteps,
                               nsteps);
        rt::cp_commit();
      } else {
        held.load(in, t0 + kSteps, nsteps);
      }
    }
#pragma unroll
    for (int q = 0; q < kSteps / P::kRS; ++q) {
      if (steps == kSteps)
        run_steps<MAXHD, false>(cur, q * P::kRS, g, jl, steps, S, p);
      else
        run_steps<MAXHD, true>(cur, q * P::kRS, g, jl, steps, S, p);
      reduce_scatter<L>(p, g);
#pragma unroll
      for (int m = 0; m < PER; ++m) yv[q * PER + m] = p[L * m];
    }
    sum_q<MAXHD, NT>(cur, s_u, steps);
    if constexpr (!ASYNC) {
      if (n + 1 < chunks) held.store(st[(n + 1) % kRing]);
    }
  }
  if (chunks > 0) {
    __syncthreads();  // the last chunk's sums of q
    const int t0 = (chunks - 1) * kSteps;
    write_y<MAXHD>(st[(chunks - 1) % kRing], yv, y,
                       base + t0 * row + j0, row, Tn - t0, g, jl, jmax);
  }

  if (state_out != nullptr) {
    float* so = state_out + ((long long)b * H + h) * hd * hd + j0 + jl;
    // 16-byte rows of 4 columns where they are whole and aligned
    const bool vec = hd % 4 == 0 && jl + kCC <= jmax;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * g + e >= hd) continue;
      float* dst = so + (long long)(4 * g + e) * hd;
#pragma unroll
      for (int cc = 0; cc < kCC; cc += 4) {
        if (vec) {
          *reinterpret_cast<float4*>(dst + cc) =
              make_float4(S[e][cc], S[e][cc + 1], S[e][cc + 2], S[e][cc + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (jl + cc + i < jmax) dst[cc + i] = S[e][cc + i];
        }
      }
    }
  }
}

template <typename T, int MAXHD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, float* y,
                   float* state_out, int B, int Tn, int H, int hd,
                   bool async, cudaStream_t stream) {
  using P = Plan<MAXHD>;
  const dim3 grid(H, B, (hd + P::kCB - 1) / P::kCB);
  const T* rr = static_cast<const T*>(r);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* ww = static_cast<const T*>(w);
  if constexpr (sizeof(T) == 4) {
    if (async) {
      wkv6_kernel<T, MAXHD, true><<<grid, P::kThreads, 0, stream>>>(
          rr, kk, vv, ww, u, y, state_out, Tn, H, hd);
      return cudaSuccess;
    }
  }
  wkv6_kernel<T, MAXHD, false><<<grid, P::kThreads, 0, stream>>>(
      rr, kk, vv, ww, u, y, state_out, Tn, H, hd);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_hd(const void* r, const void* k, const void* v,
                      const void* w, const float* u, float* y, float* so,
                      int B, int Tn, int H, int hd, bool async,
                      cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(r, k, v, w, u, y, so, B, Tn, H, hd, async, st);
  if (hd <= 64)
    return launch<T, 64>(r, k, v, w, u, y, so, B, Tn, H, hd, async, st);
  if (hd <= 128)
    return launch<T, 128>(r, k, v, w, u, y, so, B, Tn, H, hd, async,
                              st);
  return cudaErrorInvalidValue;
}

}  // namespace

// r, k, v, w: contiguous [B, T, H, hd] of one dtype (0 = float32,
// 1 = bfloat16); u: contiguous f32 [H, hd]; y: contiguous f32
// [B, T, H, hd]; state_out: contiguous f32 [B, H, hd, hd] or null.
// hd <= 128.  aligned: 1 when r, k, v and w start 16-byte aligned and
// hd % 4 == 0 (f32 chunks are then staged with cp.async), else 0.
// Returns the launch's CUDA error (0 = launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* y,
                           void* state_out, int B, int T, int H, int hd,
                           int dtype, int aligned, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* so = static_cast<float*>(state_out);
  cudaError_t err =
      dtype == 0
          ? launch_hd<float>(r, k, v, w, uf, yf, so, B, T, H, hd,
                             aligned != 0, st)
          : launch_hd<__nv_bfloat16>(r, k, v, w, uf, yf, so, B, T, H, hd,
                                     false, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
