// Inclusive segmented scan of i32 / u32 / f32 values under sum, min or max,
// restarting at every head flag (position 0 is always a head).
//
// Replaces: cuda/radixsort_tpu/kernels/scan.py, segmented_scan_pallas (body
// _sscan_kernel). The TPU kernel carries the running value from one grid
// step to the next in SMEM, because that grid runs in order; blocks here run
// in any order, so each tile's carry-in comes from a pass over the tiles'
// aggregates instead.
//
// Bound on this card: device memory. The function reads 4 B of value and
// 1 B of flag and writes 4 B per row: 151 MB at 2^24 rows, about 45 us at
// 3.35 TB/s. This three-phase form reads values and flags twice (14 B per
// row); a single-pass chained scan with decoupled lookback (CUB
// agent_scan_by_key.cuh) would read them once, and is later work.
//
// Design: reduce-then-scan over tiles of 4096 rows (256 threads x 16 rows).
//   1. scan_reduce: one block per tile computes the tile's pair
//      (aggregate, has-head): the running value at the tile's last row and
//      whether the tile holds a head.
//   2. scan_spine: one block scans the tiles' pairs under the segmented
//      operator (a,fa) + (b,fb) = (fb ? b : a o b, fa | fb) and writes each
//      tile's carry-in (the running value at the previous tile's last row).
//   3. scan_down: one block per tile scans its rows, seeded with its carry-in.
// Inside a tile, rows are loaded coalesced into shared memory and read back
// blocked (16 consecutive rows per thread, one spare word per 32 so neither
// layout has bank conflicts). Each thread scans its rows serially, a warp
// scans its threads' pairs with shuffles, and the block joins its warps'
// pairs in shared memory. Results return through shared memory and are
// stored coalesced. Every pair carries a "holds a value" bit, so no operator
// identity is ever combined in. Offsets are int64. i32 sums wrap (they are
// added as u32); f32 min/max propagate NaN as jnp.minimum/maximum do
// (fminf/fmaxf would drop it).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // load_tile reads a thread's flags as one uint4
constexpr int kTile = kThreads * kItems;  // keep in step with kernels/scan.py
constexpr int kPadded = kTile + kTile / 32;
constexpr int kSpineThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

enum { kSum = 0, kMin = 1, kMax = 2 };

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {  // a is the earlier operand
  if constexpr (OP == kSum) {
    if constexpr (std::is_same<T, int>::value)
      return (int)((unsigned)a + (unsigned)b);
    else
      return a + b;
  } else {
    if constexpr (std::is_same<T, float>::value) {
      if (a != a) return a;
      if (b != b) return b;
    }
    if constexpr (OP == kMin)
      return b < a ? b : a;
    else
      return b > a ? b : a;
  }
}

// A run's pair: its running value v, whether it holds a head (f), and
// whether it holds any row at all (h; an empty run is the neutral element).
template <typename T>
struct Acc {
  T v;
  bool f;
  bool h;
};

template <typename T, int OP>
__device__ __forceinline__ Acc<T> join(Acc<T> a, Acc<T> b) {
  if (!b.h) return a;
  if (!a.h) return b;
  return {b.f ? b.v : apply<T, OP>(a.v, b.v), a.f || b.f, true};
}

template <typename T>
__device__ __forceinline__ Acc<T> shfl_up(Acc<T> a, int d) {
  const int bits = __shfl_up_sync(kFull, (int)a.f | ((int)a.h << 1), d);
  return {__shfl_up_sync(kFull, a.v, d), (bits & 1) != 0, (bits & 2) != 0};
}

// Inclusive scan of one pair per lane over the warp.
template <typename T, int OP>
__device__ __forceinline__ Acc<T> warp_inclusive(Acc<T> a) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const Acc<T> p = shfl_up(a, d);
    if (lane >= d) a = join<T, OP>(p, a);
  }
  return a;
}

// Pair of everything before this lane in the warp (empty for lane 0).
template <typename T>
__device__ __forceinline__ Acc<T> warp_exclusive(Acc<T> inclusive) {
  Acc<T> e = shfl_up(inclusive, 1);
  if ((threadIdx.x & 31) == 0) e.h = false;
  return e;
}

// Loads tile `base` coalesced into shared memory and reads back this
// thread's 16 consecutive rows into x; bit j of `heads` flags row j as a
// head. Rows past n are heads of value 0: they come after every real row,
// so they never reach a real result.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ vals,
                                          const uint8_t* __restrict__ flags,
                                          int64_t n, int64_t base, T* s_v,
                                          uint8_t* s_f, T (&x)[kItems],
                                          unsigned& heads) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = k * kThreads + threadIdx.x;
    const int64_t i = base + r;
    T v = T(0);
    uint8_t f = 1;
    if (i < n) {
      v = vals[i];
      f = (i == 0) || flags[i] != 0;
    }
    s_v[r + (r >> 5)] = v;
    s_f[r] = f;
  }
  __syncthreads();
  const uint4 q = reinterpret_cast<const uint4*>(s_f)[threadIdx.x];
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  heads = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int r = threadIdx.x * kItems + j;
    x[j] = s_v[r + (r >> 5)];
    if ((w[j >> 2] >> (8 * (j & 3))) & 0xffu) heads |= 1u << j;
  }
}

// Serial inclusive scan of a thread's rows; returns the thread's pair.
template <typename T, int OP>
__device__ __forceinline__ Acc<T> thread_scan(T (&x)[kItems], unsigned heads) {
#pragma unroll
  for (int j = 1; j < kItems; ++j)
    if (!((heads >> j) & 1u)) x[j] = apply<T, OP>(x[j - 1], x[j]);
  return {x[kItems - 1], heads != 0, true};
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    scan_reduce(const T* __restrict__ vals, const uint8_t* __restrict__ flags,
                int64_t n, T* __restrict__ agg, uint8_t* __restrict__ aflag) {
  __shared__ T s_v[kPadded];
  __shared__ __align__(16) uint8_t s_f[kTile];
  __shared__ Acc<T> s_warp[kWarps];
  T x[kItems];
  unsigned heads;
  load_tile(vals, flags, n, (int64_t)blockIdx.x * kTile, s_v, s_f, x, heads);
  const Acc<T> a = warp_inclusive<T, OP>(thread_scan<T, OP>(x, heads));
  if ((threadIdx.x & 31) == 31) s_warp[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc<T> t = s_warp[0];
    for (int w = 1; w < kWarps; ++w) t = join<T, OP>(t, s_warp[w]);
    agg[blockIdx.x] = t.v;
    aflag[blockIdx.x] = t.f;
  }
}

// One block: each thread folds a contiguous run of tiles, the block scans
// the runs' pairs, and each thread writes its tiles' carry-ins.
template <typename T, int OP>
__global__ void __launch_bounds__(kSpineThreads)
    scan_spine(const T* __restrict__ agg, const uint8_t* __restrict__ aflag,
               int64_t n_tiles, T* __restrict__ carry) {
  __shared__ Acc<T> s_warp[kSpineThreads / 32];
  const int warp = threadIdx.x >> 5;
  const int64_t per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = min64(per * threadIdx.x, n_tiles);
  const int64_t hi = min64(lo + per, n_tiles);
  Acc<T> run = {T(0), false, false};
  for (int64_t t = lo; t < hi; ++t)
    run = join<T, OP>(run, Acc<T>{agg[t], aflag[t] != 0, true});
  const Acc<T> inc = warp_inclusive<T, OP>(run);
  if ((threadIdx.x & 31) == 31) s_warp[warp] = inc;
  __syncthreads();
  Acc<T> cur = {T(0), false, false};
  for (int w = 0; w < warp; ++w) cur = join<T, OP>(cur, s_warp[w]);
  cur = join<T, OP>(cur, warp_exclusive(inc));
  for (int64_t t = lo; t < hi; ++t) {
    carry[t] = cur.v;  // tile 0's carry is never read
    cur = join<T, OP>(cur, Acc<T>{agg[t], aflag[t] != 0, true});
  }
}

// carry: the tiles' carry-ins, or nullptr when there is a single tile.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    scan_down(const T* __restrict__ vals, const uint8_t* __restrict__ flags,
              int64_t n, const T* __restrict__ carry, T* __restrict__ out) {
  __shared__ T s_v[kPadded];
  __shared__ __align__(16) uint8_t s_f[kTile];
  __shared__ Acc<T> s_warp[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  T x[kItems];
  unsigned heads;
  load_tile(vals, flags, n, base, s_v, s_f, x, heads);
  const Acc<T> inc = warp_inclusive<T, OP>(thread_scan<T, OP>(x, heads));
  if ((threadIdx.x & 31) == 31) s_warp[warp] = inc;
  __syncthreads();
  Acc<T> p = {carry ? carry[blockIdx.x] : T(0), false,
              carry != nullptr && blockIdx.x > 0};
  for (int w = 0; w < warp; ++w) p = join<T, OP>(p, s_warp[w]);
  p = join<T, OP>(p, warp_exclusive(inc));
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    // rows after a head of this thread's own run take no prefix
    const bool own_head = (heads & ((2u << j) - 1u)) != 0;
    const T y = (own_head || !p.h) ? x[j] : apply<T, OP>(p.v, x[j]);
    const int r = threadIdx.x * kItems + j;
    s_v[r + (r >> 5)] = y;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = k * kThreads + threadIdx.x;
    const int64_t i = base + r;
    if (i < n) out[i] = s_v[r + (r >> 5)];
  }
}

template <typename T, int OP>
int launch(const void* vals, const void* flags, void* out, int64_t n,
           int64_t n_tiles, void* agg, void* aflag, void* carry,
           cudaStream_t s) {
  const T* v = (const T*)vals;
  const uint8_t* f = (const uint8_t*)flags;
  const T* c = nullptr;
  if (n_tiles > 1) {
    scan_reduce<T, OP><<<(unsigned)n_tiles, kThreads, 0, s>>>(
        v, f, n, (T*)agg, (uint8_t*)aflag);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_spine<T, OP><<<1, kSpineThreads, 0, s>>>(
        (const T*)agg, (const uint8_t*)aflag, n_tiles, (T*)carry);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    c = (const T*)carry;
  }
  scan_down<T, OP><<<(unsigned)n_tiles, kThreads, 0, s>>>(v, f, n, c, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const void* vals, const void* flags, void* out,
              int64_t n, int64_t n_tiles, void* agg, void* aflag, void* carry,
              cudaStream_t s) {
  switch (op) {
    case kSum:
      return launch<T, kSum>(vals, flags, out, n, n_tiles, agg, aflag, carry, s);
    case kMin:
      return launch<T, kMin>(vals, flags, out, n, n_tiles, agg, aflag, carry, s);
    case kMax:
      return launch<T, kMax>(vals, flags, out, n, n_tiles, agg, aflag, carry, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// values, out: n rows of dtype 0 = int32, 1 = uint32, 2 = float32; flags: n
// bytes, non-zero at a head; op: 0 = sum, 1 = min, 2 = max. n_tiles must be
// ceil(n / 4096). agg and carry: 4 B * n_tiles scratch each; aflag: n_tiles
// bytes. out must not alias values.
extern "C" int rs_segmented_scan(const void* values, const void* flags,
                                 void* out, int64_t n, int dtype, int op,
                                 int64_t n_tiles, void* agg, void* aflag,
                                 void* carry, void* stream) {
  if (n == 0) return 0;
  if (n_tiles != (n + kTile - 1) / kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_op<int>(op, values, flags, out, n, n_tiles, agg, aflag, carry, s);
    case 1:
      return launch_op<unsigned>(op, values, flags, out, n, n_tiles, agg, aflag, carry, s);
    case 2:
      return launch_op<float>(op, values, flags, out, n, n_tiles, agg, aflag, carry, s);
  }
  return (int)cudaErrorInvalidValue;
}
