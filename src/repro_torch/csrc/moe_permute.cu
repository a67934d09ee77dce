// The MoE layer's (token, expert) pairs put in expert order, with their
// rows gathered, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference sorts the pairs with XLA ops.  In
// the port's eager composition (models/moe.py moe_apply_grouped) this is
// the pairs' token ids (floor_divide of the sorted order) and the gather
// of their rows, xf[order // k]; the order itself comes from a radix sort,
// which moe_route's counts replace.
//
// One block a tile of the tokens moe_route tiled (1 or 8 tokens: the same
// tiles, whose bases moe_route's scan wrote).  Pair p = t k + j (token t,
// its j-th choice e) goes to place base[tile, e] + r, r the number of the
// tile's pairs before p routed to e: the place a stable sort of the
// pairs' experts gives it (torch.argsort(stable=True)).  Writes pos[t, j],
// the place, which moe_combine reads, and rows[place] = x[t], copied as
// raw bits (16 bytes at a time where rows allow).
//
// Bound on this card: bytes (each pair's row written once, x's rows read
// once a choice, mostly from L2).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 8;

template <typename U, int TT>
__global__ void __launch_bounds__(kThreads)
    moe_permute_kernel(const U* __restrict__ x,
                       const long long* __restrict__ top_i,
                       const int* __restrict__ base, int* __restrict__ pos,
                       U* __restrict__ rows, int n_tok, int units, int E,
                       int k) {
  __shared__ int place[TT * kMaxK];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int t0 = tile * TT;
  const int np = min(TT, n_tok - t0) * k;
  const long long* ti = top_i + static_cast<long long>(t0) * k;
  if (tid < np) {
    const long long e = ti[tid];
    int r = 0;
    for (int p = 0; p < tid; ++p) r += ti[p] == e;
    const int at = base[tile * E + static_cast<int>(e)] + r;
    place[tid] = at;
    pos[static_cast<long long>(t0) * k + tid] = at;
  }
  __syncthreads();
  const int n = np * units;
  for (int i = tid; i < n; i += kThreads) {
    const int p = i / units, c = i % units;
    rows[static_cast<long long>(place[p]) * units + c] =
        x[static_cast<long long>(t0 + p / k) * units + c];
  }
}

template <typename U>
cudaError_t launch(const void* x, const void* top_i, const int* base,
                   void* pos, void* rows, int n_tok, int units, int E, int k,
                   int tile, cudaStream_t st) {
  const int tiles = (n_tok + tile - 1) / tile;
  const U* xu = static_cast<const U*>(x);
  const long long* ti = static_cast<const long long*>(top_i);
  int* po = static_cast<int*>(pos);
  U* ro = static_cast<U*>(rows);
  if (tile == 1)
    moe_permute_kernel<U, 1><<<tiles, kThreads, 0, st>>>(
        xu, ti, base, po, ro, n_tok, units, E, k);
  else
    moe_permute_kernel<U, 8><<<tiles, kThreads, 0, st>>>(
        xu, ti, base, po, ro, n_tok, units, E, k);
  return cudaGetLastError();
}

}  // namespace

// x: [n_tok, D] contiguous, D elements of elsize bytes (2 or 4); top_i:
// [n_tok, k] int64, moe_route's; ints: moe_route's int32 workspace (ends
// [E], then three [tiles, E] blocks, the bases last); pos: int32 [n_tok,
// k]; rows: [n_tok k, D] of x's dtype.  tile: moe_route's (1 or 8).  vec:
// x and rows 16-byte aligned and D elsize a multiple of 16.  Returns the
// launch's CUDA error (0 = launched).
extern "C" int moe_permute_launch(const void* x, const void* top_i,
                                  const void* ints, void* pos, void* rows,
                                  int n_tok, int D, int E, int k, int tile,
                                  int elsize, int vec, void* stream) {
  if (n_tok < 1 || D < 1 || E < 1 || k < 1 || k > kMaxK ||
      (tile != 1 && tile != 8) || (elsize != 2 && elsize != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (n_tok + tile - 1) / tile;
  const int* base = static_cast<const int*>(ints) + E + 2 * tiles * E;
  const long long bytes = static_cast<long long>(D) * elsize;
  cudaError_t err;
  if (vec)
    err = launch<uint4>(x, top_i, base, pos, rows, n_tok,
                        static_cast<int>(bytes / 16), E, k, tile, st);
  else if (elsize == 2)
    err = launch<unsigned short>(x, top_i, base, pos, rows, n_tok, D, E, k,
                                 tile, st);
  else
    err = launch<unsigned int>(x, top_i, base, pos, rows, n_tok, D, E, k,
                               tile, st);
  return static_cast<int>(err);
}

extern "C" const char* moe_permute_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
