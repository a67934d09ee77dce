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
// prefill's S = 256 at yi-9b widths), operations at long ones.
//
// Three hand-written instances sit behind the one C entry point; the
// wrapper picks one by dtype and head_dim and says which
// (flash_attention.last_instance):
//
// "wgmma" (bf16, head_dim 64 or 128; yi-9b and the other dense configs):
//   one warpgroup of 128 threads per (b * h, 64-row query tile), the query
//   tiles with the most kv tiles launched first.  TMA brings the Q tile
//   and two stages of K and V tiles (64 keys each) into shared memory
//   with the 128-byte swizzle that wgmma reads, one mbarrier per stage,
//   so the next kv tile loads while this one is multiplied.  S = Q K^T
//   runs as wgmma m64n64k16 with both operands in shared memory and
//   f32 accumulators in registers; the online softmax runs on those
//   registers (a row lives in the 4 threads of a quad); P is rounded to
//   bf16 in registers, in the layout wgmma takes for its A operand, and
//   O += P V runs as wgmma with V read transposed from shared memory.  kv
//   tiles that the causal mask or the window empty for every row of the
//   query tile are never loaded: each row keeps its own diagonal key, so
//   a key masked to -1e30 in a tile that is computed weighs exactly 0.
//   The tensor maps are encoded per call on the host (the caller's strided
//   [B, S, H, hd] views need no copy); TMA zero-fills rows past S.
//
// "pingpong" (bf16, head_dim 256; gemma2-9b): a producer warp and two
//   consumer warpgroups per 128-row query tile, the consumers taking
//   turns at the tensor cores (see namespace ws below).
//
// "simt" (f32, and bf16 at the head dims the tensor-core instances do not
//   take): one block of 256 threads per (query tile of 32 rows, b * h)
//   with scalar f32 FMAs on CUDA cores; K and V tiles are staged in
//   shared memory as f32, and only the kv tiles that hold a valid key for
//   some row of the tile are computed.  Exact in f32, which the f32 token
//   check needs.
//
// All three accept any S: query rows past S are not stored and keys past S get
// zero weight, so the ragged edge is masked in the kernel.
#include <cuda.h>  // CUtensorMap and the driver's types (no -lcuda)
#include <math.h>

#include "common.cuh"

namespace simt {

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

  // only the kv tiles that hold a valid key for some row of the tile, by
  // tc::'s rule: a key masked in a computed tile weighs exactly 0, and a
  // row's fully masked tiles before its first valid key are wiped by the
  // correction exp(-1e30 - m) = 0, so the result is the same to the bit
  const int q_last = min(q0 + kBQ, S) - 1;
  int t_hi = (S + kBK - 1) / kBK;
  if (causal) t_hi = min(t_hi, q_last / kBK + 1);
  const int t_lo =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / kBK : 0;
  for (int k0 = t_lo * kBK; k0 < t_hi * kBK; k0 += kBK) {
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
  static rt::SmemOptIn opted;
  cudaError_t err = rt::opt_in_smem(
      opted, reinterpret_cast<const void*>(flash_attention_kernel<T, VEC>),
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, VEC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, K, S, hd, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int K, int S, int hd, const long long* st, float scale,
             float softcap, int causal, int window, int dtype, int vec,
             cudaStream_t s) {
  if (dtype == 0) {
    return vec ? launch<float, 4>(q, k, v, out, B, H, K, S, hd, st, scale,
                                  softcap, causal, window, s)
               : launch<float, 1>(q, k, v, out, B, H, K, S, hd, st, scale,
                                  softcap, causal, window, s);
  }
  return vec ? launch<__nv_bfloat16, 8>(q, k, v, out, B, H, K, S, hd, st,
                                        scale, softcap, causal, window, s)
             : launch<__nv_bfloat16, 1>(q, k, v, out, B, H, K, S, hd, st,
                                        scale, softcap, causal, window, s);
}

}  // namespace simt

namespace tc {

constexpr int kBQ = 64;         // query rows per block: one wgmma M
constexpr int kBK = 64;         // keys per kv tile
constexpr int kThreads = 128;   // one warpgroup
constexpr int kChunk = 64;      // bf16 columns in one 128-byte swizzle row
constexpr int kChunkBytes = kBQ * 128;   // one 64-row box of 128 bytes
static_assert(kBQ == kBK, "Q, K and V boxes share one shape");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64-row box of a 4-d tensor map (coordinates innermost first:
// head_dim offset, row, head, batch) into shared memory, counted against
// the transaction bytes of `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma's descriptor of a 128-byte-swizzled operand whose 8-row groups
// lie 1024 bytes apart.  Q and K are K-major (head_dim contiguous), for
// which the leading offset is unused; V is read transposed, one 64-wide
// column block per product, so its leading offset (the step to the next
// column block) is unused too.  Both offsets are set to the group stride.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(1024 >> 4) << 16;  // leading byte offset
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride byte offset
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the 32 f32 accumulators of a 64 x 64 wgmma, thread by thread
#define RT_ACC32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B in shared memory, both
// K-major.  `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : RT_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (4 bf16 pairs a
// thread), B in shared memory with its N dimension contiguous
// (transposed).
__device__ __forceinline__ void wgmma_rs_tb(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : RT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float* rounded_sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  *rounded_sum += __low2float(v) + __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int H, int K, int S,
                   float scale, float softcap, int causal, int window) {
  constexpr int NC = HD / kChunk;                // 64-wide column blocks
  constexpr int kTileBytes = NC * kChunkBytes;   // one Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle atoms are 1024 bytes: align the tiles to them
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + kTileBytes;                 // [2 stages]
  uint8_t* sV = sK + 2 * kTileBytes;             // [2 stages]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + 2 * kTileBytes);

  // the query tiles with the most kv tiles first: blockIdx.y = 0 is the
  // last tile of every (b, h), so the longest blocks start in the first
  // wave and the short ones fill the tail
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // the kv tiles that hold a valid key for some row of this query tile
  const int q_last = min(q0 + kBQ, S) - 1;
  int t_hi = (S + kBK - 1) / kBK;
  if (causal) t_hi = min(t_hi, q_last / kBK + 1);
  const int t_lo =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / kBK : 0;
  const int n = t_hi - t_lo;   // >= 1: row q0 keeps its own key

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int j) {   // tile t_lo + j into stage j % 2
    const int st = j & 1;
    const int row = (t_lo + j) * kBK;
    mbar_expect_tx(&bar[1 + st], 2 * kTileBytes);
    for (int c = 0; c < NC; ++c) {
      tma_load(sK + st * kTileBytes + c * kChunkBytes, &tk, &bar[1 + st],
               c * kChunk, row, kh, b);
      tma_load(sV + st * kTileBytes + c * kChunkBytes, &tv, &bar[1 + st],
               c * kChunk, row, kh, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(&bar[0], kTileBytes);
    for (int c = 0; c < NC; ++c)
      tma_load(sQ + c * kChunkBytes, &tq, &bar[0], c * kChunk, q0, h, b);
    load_kv(0);
    if (n > 1) load_kv(1);
  }

  // accumulator layout of wgmma m64nN: d[i] of thread (warp, lane) sits
  // at row warp*16 + lane/4 + 8*((i/2)%2), column 8*(i/4) + 2*(lane%4) +
  // i%2.  Each thread holds two rows, r0 and r0 + 8.
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
  float o[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {rt::kNegInf, rt::kNegInf};   // running max, log2 domain
  float l[2] = {0.f, 0.f};                   // this thread's part of the sum

  const uint32_t qa = smem_u32(sQ);
  mbar_wait(&bar[0], 0);
  for (int j = 0; j < n; ++j) {
    const int st = j & 1;
    const int k0 = (t_lo + j) * kBK;
    const uint32_t ka = smem_u32(sK + st * kTileBytes);
    const uint32_t va = smem_u32(sV + st * kTileBytes);
    mbar_wait(&bar[1 + st], (j >> 1) & 1);

    // S = Q K^T over head_dim in steps of 16 (32 bytes of a swizzle row)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs<32>(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kChunkBytes + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(qa + off), sw128_desc(ka + off), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs<32>(s);

    // scale, softcap, masks; the row max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      const int row = q0 + r0 + 8 * half;
      const int key = k0 + (i >> 2) * 8 + cq + (i & 1);
      float x = s[i] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      x *= kLog2e;
      if (key >= S) {
        x = -INFINITY;   // past the ragged edge: zero weight
      } else if ((causal && key > row) ||
                 (window > 0 && row - key >= window)) {
        x = rt::kNegInf;
      }
      s[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
    // P in bf16, already in the register layout of wgmma's A operand:
    // for keys 16kk..16kk+15, a_q holds d[8kk + 2q], d[8kk + 2q + 1]
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        const int i = 8 * kk + 2 * qd;
        const int half = qd & 1;
        pa[4 * kk + qd] = pack_bf16(exp2f(s[i] - m[half]),
                                    exp2f(s[i + 1] - m[half]), &l[half]);
      }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];

    // O += P V: V's 16 keys of step kk are 16 swizzle rows (2048 bytes)
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs<32>(o[c]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        wgmma_rs_tb(o[c], &pa[4 * kk],
                    sw128_desc(va + c * kChunkBytes + kk * 2048));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs<32>(o[c]);

    __syncthreads();   // every warp is done with this stage's K and V
    if (tid == 0 && j + 2 < n) load_kv(j + 2);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = out + static_cast<long long>(bh) * S * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    if (row >= S) continue;
    __nv_bfloat16* orow = ob + static_cast<long long>(row) * HD + cq;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            o[c][4 * jj + 2 * half] * inv[half],
            o[c][4 * jj + 2 * half + 1] * inv[half]);
        *reinterpret_cast<__nv_bfloat162*>(orow + c * kChunk + 8 * jj) = v;
      }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library needs no -lcuda.
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [B, N, S, hd] bf16 view with element strides st = (b, n, s) and a
// contiguous head_dim, as a 4-d map (hd, S, N, B) read in 64 x 64 boxes
// with the 128-byte swizzle.  Rows past S read as zeros.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B,
            int N, int S, int hd, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {kChunk, kBK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, const long long* st, float scale,
           float softcap, int causal, int window, cudaStream_t stream) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, B, H, S, HD, st) ||
      !encode(fn, &tk, k, B, K, S, HD, st + 3) ||
      !encode(fn, &tv, v, B, K, S, HD, st + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  // Q, two stages of K and V, three barriers, and room to align to 1024
  const size_t smem = 5 * (HD / kChunk) * kChunkBytes + 3 * 8 + 1024;
  static rt::SmemOptIn opted;
  cudaError_t err = rt::opt_in_smem(
      opted, reinterpret_cast<const void*>(flash_wgmma_kernel<HD>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_wgmma_kernel<HD><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), H, K, S, scale, softcap,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The instance for bf16 at head_dim 256 (gemma2-9b), FlashAttention-3's
// layout: three warpgroups per (b * h, 128-row query tile).  Warpgroup 0
// is the producer: one thread issues every TMA load (Q once, then K and V
// tiles of 64 keys into two stages each, each stage refilled when the 8
// consumer warps have released it on its "empty" mbarrier), and the
// warpgroup gives its registers up (setmaxnreg 24).  Warpgroups 1 and 2
// are consumers with 240 registers a thread: each owns 64 query rows,
// keeps its 64 x 256 f32 O in registers (128 a thread) and reads every K
// and V stage, which the two share.  In turn j a consumer issues
// S_j = Q K_j^T (wgmma m64n64k16, 16 steps over head_dim) and
// O += P_{j-1} V_{j-1} (wgmma m64n256k16 with P in registers, 4 steps
// over the keys), waits for S_j alone, releases K_j and runs the
// softmax of S_j while its own P V and the other consumer's products
// run; then it waits for P V, releases V_{j-1}, rescales O and packs P_j
// to bf16.  Two named barriers hand the tensor cores from one consumer
// to the other each turn (ping-pong), so one consumer's exp2 and tanh
// run beside the other's products.  The softcap's tanh is
// 1 - 2 / (2^(2x log2 e) + 1) on the special-function unit (absolute
// error about 1e-7, against tanhf's branches).  Tiles are skipped as in
// the 64-row instance, per 128-row tile; the per-element masks run only
// on tiles that a mask or the ragged edge cuts.
namespace ws {

constexpr int HD = 256;
constexpr int NC = HD / tc::kChunk;                // 4 column blocks of 64
constexpr int kRows = 64;                          // query rows a consumer
constexpr int kBQ = 2 * kRows;                     // query rows a block
constexpr int kBK = tc::kBK;                       // keys per kv tile
constexpr int kThreads = 3 * 128;                  // producer, 2 consumers
constexpr int kTileBytes = NC * tc::kChunkBytes;   // 64 rows x 256: 32 KB
constexpr int kConsumerWarps = 8;
// mbarriers: Q, then per stage K full, V full, K empty, V empty
constexpr int kBarQ = 0, kFullK = 1, kFullV = 3, kEmptyK = 5, kEmptyV = 7;
constexpr int kNumBars = 9;
constexpr int kTurnBar = 1;   // named barriers 1, 2: consumer 0's, 1's turn

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   tc::smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   tc::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The descriptor of V read transposed across all four 64-wide column
// blocks at once: the leading offset is the step to the next block.
__device__ __forceinline__ uint64_t sw128_desc_lbo(uint32_t addr,
                                                   uint32_t lbo) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>(lbo >> 4) << 16;   // leading byte offset
  d |= static_cast<uint64_t>(1024 >> 4) << 32;  // stride byte offset
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}

#define RT_ACC128(d) \
  RT_ACC32(d), RT_ACC32((d + 32)), RT_ACC32((d + 64)), RT_ACC32((d + 96))

// d[64 x 256] += A[64 x 16] B[16 x 256], A in registers, B in shared
// memory with its N dimension contiguous (transposed).
__device__ __forceinline__ void wgmma_rs_n256_tb(float* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}"
      : RT_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float tanh_ex2(float x) {
  const float e = exp2f(fminf(x * 2.8853900817779268f, 64.f));
  return 1.f - __fdividef(2.f, e + 1.f);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_pingpong_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      __nv_bfloat16* __restrict__ out, int H, int K, int S,
                      float scale, float softcap, int causal, int window) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + 2 * kTileBytes;             // [2 stages]
  uint8_t* sV = sK + 2 * kTileBytes;             // [2 stages]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + 2 * kTileBytes);

  // the query tiles with the most kv tiles first (see tc::)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  // the warpgroup, broadcast from lane 0 so the compiler sees it is
  // uniform in the warp: wgmma in a branch it takes for divergent is
  // serialized
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);

  // the kv tiles that hold a valid key for some row of the 128
  const int q_last = min(q0 + kBQ, S) - 1;
  int t_hi = (S + kBK - 1) / kBK;
  if (causal) t_hi = min(t_hi, q_last / kBK + 1);
  const int t_lo =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / kBK : 0;
  const int n = t_hi - t_lo;   // >= 1: row q0 keeps its own key

  if (tid == 0) {
    mbar_init(&bar[kBarQ], 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bar[kFullK + i], 1);
      mbar_init(&bar[kFullV + i], 1);
      mbar_init(&bar[kEmptyK + i], kConsumerWarps);
      mbar_init(&bar[kEmptyV + i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // -- producer ----------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (tid == 0) {
      tc::mbar_expect_tx(&bar[kBarQ], 2 * kTileBytes);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < NC; ++c)
          tc::tma_load(sQ + (half * NC + c) * tc::kChunkBytes, &tq,
                       &bar[kBarQ], c * tc::kChunk, q0 + half * kRows, h, b);
      for (int j = 0; j < n; ++j) {
        const int st = j & 1;
        const int row = (t_lo + j) * kBK;
        // stage st last held tile j - 2: wait until both consumers let it go
        const uint32_t freed = ((j >> 1) - 1) & 1;
        if (j >= 2) tc::mbar_wait(&bar[kEmptyK + st], freed);
        tc::mbar_expect_tx(&bar[kFullK + st], kTileBytes);
        for (int c = 0; c < NC; ++c)
          tc::tma_load(sK + st * kTileBytes + c * tc::kChunkBytes, &tk,
                       &bar[kFullK + st], c * tc::kChunk, row, kh, b);
        if (j >= 2) tc::mbar_wait(&bar[kEmptyV + st], freed);
        tc::mbar_expect_tx(&bar[kFullV + st], kTileBytes);
        for (int c = 0; c < NC; ++c)
          tc::tma_load(sV + st * kTileBytes + c * tc::kChunkBytes, &tv,
                       &bar[kFullV + st], c * tc::kChunk, row, kh, b);
      }
    }
  } else {
    // -- consumers ---------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = wg - 1;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int qw0 = q0 + cw * kRows;   // this consumer's first query row
    // accumulator layout as in tc::: rows r0 and r0 + 8 of the 64, the
    // columns 8 (i / 4) + cq + i % 2
    const int r0 = warp * 16 + (lane >> 2);
    const int cq = (lane & 3) * 2;
    const int my_turn = kTurnBar + cw;
    const int their_turn = kTurnBar + 1 - cw;
    if (cw == 1) bar_arrive(kTurnBar);   // consumer 0 takes the first turn

    // scale (and the softcap) folded with log2 e: the softmax runs in exp2
    const float pre = softcap > 0.f ? scale / softcap : scale * tc::kLog2e;
    const float post = softcap * tc::kLog2e;
    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float s[32];
    uint32_t pa[16];
    float m[2] = {rt::kNegInf, rt::kNegInf};   // running max, log2 domain
    float l[2] = {0.f, 0.f};                   // this thread's part of the sum
    float corr[2] = {1.f, 1.f};

    const uint32_t qa = tc::smem_u32(sQ + cw * kTileBytes);
    // S_j = Q K_j^T, one commit group
    auto issue_s = [&](int j) {
      const uint32_t ka = tc::smem_u32(sK + (j & 1) * kTileBytes);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      tc::fence_regs<32>(s);
      tc::fence_regs<128>(o);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * tc::kChunkBytes + (kk % 4) * 32;
        tc::wgmma_ss(s, tc::sw128_desc(qa + off), tc::sw128_desc(ka + off),
                     kk > 0);
      }
      tc::wg_commit();
    };
    // O += P_j V_j, one commit group
    auto issue_pv = [&](int j) {
      const uint32_t va = tc::smem_u32(sV + (j & 1) * kTileBytes);
      tc::fence_regs<128>(o);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n256_tb(o, &pa[4 * kk],
                         sw128_desc_lbo(va + kk * 2048, tc::kChunkBytes));
      tc::wg_commit();
    };
    // S_j (done) -> scale, softcap, masks, running max; s holds P_j in f32
    auto softmax = [&](int j) {
      tc::fence_regs<32>(s);
      if (lane == 0) mbar_arrive(&bar[kEmptyK + (j & 1)]);
      const int k0 = (t_lo + j) * kBK;
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > qw0) ||
                        (window > 0 && qw0 + kRows - 1 - k0 >= window);
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = post * tanh_ex2(s[i] * pre);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= pre;
      }
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = qw0 + r0 + 8 * ((i >> 1) & 1);
          const int key = k0 + (i >> 2) * 8 + cq + (i & 1);
          if (key >= S) {
            s[i] = -INFINITY;   // past the ragged edge: zero weight
          } else if ((causal && key > row) ||
                     (window > 0 && row - key >= window)) {
            s[i] = rt::kNegInf;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - mn);
        m[r] = mn;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    };
    // P V of tile j done: release V_j
    auto pv_done = [&](int j) {
      wg_wait<0>();
      tc::fence_regs<128>(o);
      fence_u32<16>(pa);
      if (lane == 0) mbar_arrive(&bar[kEmptyV + (j & 1)]);
    };
    // O to the new running max; P_j in bf16 in the layout of wgmma's A
    // operand (see tc::), its rounded values summed into l
    auto rescale_pack = [&]() {
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 128; ++i) o[i] *= corr[(i >> 1) & 1];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          const int i = 8 * kk + 2 * qd;
          pa[4 * kk + qd] = tc::pack_bf16(s[i], s[i + 1], &l[qd & 1]);
        }
    };

    tc::mbar_wait(&bar[kBarQ], 0);
    // turn 0: S_0 alone
    tc::mbar_wait(&bar[kFullK], 0);
    bar_sync(my_turn);
    issue_s(0);
    bar_arrive(their_turn);
    wg_wait<0>();
    softmax(0);
    rescale_pack();
    // turn j: S_j and P_{j-1} V_{j-1}; the softmax of S_j runs while P V
    // and the other consumer's products do
    for (int j = 1; j < n; ++j) {
      tc::mbar_wait(&bar[kFullK + (j & 1)], (j >> 1) & 1);
      tc::mbar_wait(&bar[kFullV + ((j - 1) & 1)], ((j - 1) >> 1) & 1);
      bar_sync(my_turn);
      issue_s(j);
      issue_pv(j - 1);
      bar_arrive(their_turn);
      wg_wait<1>();   // S_j is done; P V may still run
      softmax(j);
      pv_done(j - 1);
      rescale_pack();
    }
    // turn n: P_{n-1} V_{n-1} alone; consumer 1's last turn hands nothing
    // on, so each named barrier sees as many arrivals as waits
    tc::mbar_wait(&bar[kFullV + ((n - 1) & 1)], ((n - 1) >> 1) & 1);
    bar_sync(my_turn);
    issue_pv(n - 1);
    if (cw == 0) bar_arrive(their_turn);
    pv_done(n - 1);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* ob = out + static_cast<long long>(bh) * S * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = qw0 + r0 + 8 * half;
      if (row >= S) continue;
      __nv_bfloat16* orow = ob + static_cast<long long>(row) * HD + cq;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 32 * c + 4 * jj + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(orow + c * tc::kChunk + 8 * jj) =
              __floats2bfloat162_rn(o[i] * inv[half], o[i + 1] * inv[half]);
        }
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, const long long* st, float scale,
           float softcap, int causal, int window, cudaStream_t stream) {
  tc::EncodeTiledFn fn = tc::encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!tc::encode(fn, &tq, q, B, H, S, HD, st) ||
      !tc::encode(fn, &tk, k, B, K, S, HD, st + 3) ||
      !tc::encode(fn, &tv, v, B, K, S, HD, st + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  // Q (128 rows), two stages of K and V, the barriers, room to align
  const size_t smem = 6 * kTileBytes + kNumBars * 8 + 1024;
  static rt::SmemOptIn opted;
  cudaError_t err = rt::opt_in_smem(
      opted, reinterpret_cast<const void*>(flash_pingpong_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_pingpong_kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), H, K, S, scale, softcap,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ws

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 when every row start is
// 16-byte aligned (16-byte loads), else 0.  instance: 1 = the 64-row
// tensor-core kernel (bf16, head_dim 64 or 128), 2 = the ping-pong
// kernel (bf16, head_dim 256), both with base and strides 16-byte
// aligned, as TMA needs; 0 = the SIMT kernel.  strides (elements): q_b,
// q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s.  The last dim of q, k and v is
// contiguous; out is a contiguous [B, H, S, hd].
// Returns the launch's CUDA error code (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int K, int S, int hd, const long long* strides, float scale,
    float softcap, int causal, int window, int dtype, int vec, int instance,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (instance == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (hd == 64)
      return tc::launch<64>(q, k, v, out, B, H, K, S, strides, scale,
                            softcap, causal, window, st);
    if (hd == 128)
      return tc::launch<128>(q, k, v, out, B, H, K, S, strides, scale,
                             softcap, causal, window, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (instance == 2) {
    if (dtype != 1 || hd != ws::HD)
      return static_cast<int>(cudaErrorInvalidValue);
    return ws::launch(q, k, v, out, B, H, K, S, strides, scale, softcap,
                      causal, window, st);
  }
  return simt::dispatch(q, k, v, out, B, H, K, S, hd, strides, scale,
                        softcap, causal, window, dtype, vec, st);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
