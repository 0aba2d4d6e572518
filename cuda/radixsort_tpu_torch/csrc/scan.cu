// Inclusive segmented scan of i32 / u32 / f32 values under sum, min or max,
// restarting at every head flag (position 0 is always a head).
//
// Replaces: cuda/radixsort_tpu/kernels/scan.py, segmented_scan_pallas (body
// _sscan_kernel). The TPU kernel carries the running value from one grid
// step to the next in SMEM, because that grid runs in order; blocks here run
// in any order, so each tile's carry-in comes from a decoupled lookback over
// the tiles before it (CUB agent/agent_scan_by_key.cuh ConsumeTile, tile
// state agent/single_pass_scan_operators.cuh).
//
// Bound on this card: device memory. The function reads 4 B of value and
// 1 B of flag and writes 4 B per row (8 B without flags): 151 MB at 2^24
// rows, about 45 us at 3.35 TB/s. This kernel reads every row once and
// writes it once, in one launch (plus one memset of the tile states).
//
// Design: one block per tile of 4096 rows (256 threads x 16 rows), taken in
// order from an atomic counter, so every earlier tile's block is already
// running and a lookback cannot wait on a block that never got an SM.
//   1. Load. A warp owns 512 consecutive rows as 4 chunks of 128; a thread
//      loads 4 rows of a chunk as one aligned 16-B vector of values and one
//      4-B word of flags, all 4 chunks before any arithmetic. Rows are
//      counted from the 16-B boundary at or before the values' first row,
//      so a view at any offset loads aligned vectors; rows before the first
//      and after the last are masked (heads of value 0, never stored). The
//      output is allocated with the values' 16-B phase; flags of another
//      phase are read as two aligned words and funnel-shifted.
//   2. Reduce. A thread scans its 4 rows, a warp scans its lanes' pairs
//      with shuffles chunk by chunk, and thread 0 joins the warps' pairs.
//      Every pair is (value, has-head, holds-a-value) under the segmented
//      operator (a,fa) + (b,fb) = (fb ? b : a o b, fa | fb).
//   3. Publish the tile's status as one 64-bit store: 32 value bits, a
//      has-head bit and AGGREGATE / INCLUSIVE bits, so a reader never sees
//      a flag without its value. A tile holding a head publishes INCLUSIVE
//      at once: its aggregate already starts at its last head.
//   4. Lookback (warp 0, only if the tile's first row is not a head): lane
//      i reads the word of tile t-1-i; the warp waits until every word up to
//      the nearest INCLUSIVE one is published, else keeps the window's
//      aggregates in shared memory and steps 32 tiles back (at most
//      kLookMax aggregates, then it waits on its last window). The carry-in
//      is then folded strictly left to right by one lane:
//      ((inc(k) o agg(k+1)) o ...) o agg(t-1). Since inc(k) is itself the
//      left fold from the last head tile, the carry-in is the same whatever
//      k the lookback stopped at: float sums give the same bits every run.
//      A tile without a head then publishes INCLUSIVE = carry o aggregate.
//   5. Each thread joins the carry, its warp's prefix and its chunk prefix
//      into its rows and stores them as aligned vectors: each row written
//      once.
// Offsets are int64. i32 sums wrap (they are added as u32); f32 min/max
// propagate NaN as jnp.minimum/maximum do (fminf/fmaxf would drop it).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;                  // 16-B vectors of values per thread
constexpr int kTile = kThreads * 4 * kChunks;  // keep in step with kernels/scan.py
constexpr int kLookMax = 256;  // aggregates a lookback steps over before it
                               // waits on its last window
constexpr unsigned kFull = 0xffffffffu;

constexpr unsigned long long kValueBits = 0xffffffffull;
constexpr unsigned long long kHead = 1ull << 32;
constexpr unsigned long long kAggregate = 1ull << 33;
constexpr unsigned long long kInclusive = 1ull << 34;

enum { kSum = 0, kMin = 1, kMax = 2 };

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

template <typename T>
__device__ __forceinline__ uint32_t to_bits(T v) {
  if constexpr (std::is_same<T, float>::value)
    return __float_as_uint(v);
  else
    return (uint32_t)v;
}

template <typename T>
__device__ __forceinline__ T from_bits(uint32_t b) {
  if constexpr (std::is_same<T, float>::value)
    return __uint_as_float(b);
  else
    return (T)b;
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

template <typename T>
__device__ __forceinline__ Acc<T> shfl_idx(Acc<T> a, int src) {
  const int bits = __shfl_sync(kFull, (int)a.f | ((int)a.h << 1), src);
  return {__shfl_sync(kFull, a.v, src), (bits & 1) != 0, (bits & 2) != 0};
}

// Inclusive scan of one pair per lane over the warp.
template <typename T, int OP>
__device__ __forceinline__ Acc<T> warp_inclusive(Acc<T> a) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Acc<T> p = shfl_up(a, d);
    if (lane >= d) a = join<T, OP>(p, a);
  }
  return a;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// The 4-B word at a (4-B aligned), or 0 if it holds none of [lo, hi): a word
// that holds a byte of the array lies in that byte's page, so it is safe to
// read; the bytes outside the array are masked by the caller.
__device__ __forceinline__ uint32_t load_word(uintptr_t a, uintptr_t lo,
                                              uintptr_t hi) {
  return (a + 4 > lo && a < hi) ? __ldg((const uint32_t*)a) : 0u;
}

// The flag bytes of 4 rows from byte address a (any phase) as a 4-bit head
// mask, or 0 for flags == nullptr.
__device__ __forceinline__ unsigned load_heads(const uint8_t* flags,
                                               uintptr_t a, uintptr_t lo,
                                               uintptr_t hi) {
  if (flags == nullptr) return 0u;
  const uintptr_t wa = a & ~(uintptr_t)3;
  uint32_t w = load_word(wa, lo, hi);
  if (a != wa)
    w = __funnelshift_r(w, load_word(wa + 4, lo, hi), 8 * (unsigned)(a - wa));
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) m |= ((w >> (8 * j)) & 0xffu) ? 1u << j : 0u;
  return m;
}

// vals, out: 16-B aligned, row r of the caller's arrays at r + phase; flags:
// the caller's flags (row r at flags + r) or nullptr; scratch: word 0 the
// tile counter, then one status word per tile, all zero at launch.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads, 4)
    scan_single_pass(const T* __restrict__ vals, const uint8_t* flags,
                     int64_t n, int phase, T* __restrict__ out,
                     unsigned long long* scratch) {
  __shared__ Acc<T> s_warp[kWarps];
  __shared__ uint32_t s_look[kLookMax + 32];  // the last window's too
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_carry;
  __shared__ bool s_has_carry;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* status = scratch + 1;
  if (tid == 0) s_tile = (int64_t)atomicAdd((unsigned int*)scratch, 1u);
  __syncthreads();
  const int64_t t = s_tile;

  // 1. load: chunk k of this thread holds rows first + 128 k + {0..3}
  const int64_t first = t * kTile + warp * (32 * 4 * kChunks) + 4 * lane;
  const int64_t end = n + phase;  // rows [phase, end) are the caller's
  const uintptr_t f_lo = (uintptr_t)flags, f_hi = f_lo + (uintptr_t)n;
  T x[kChunks][4];
  unsigned heads[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int64_t r = first + 128 * k;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (r + 4 > phase && r < end) q = __ldg((const uint4*)(vals + r));
    x[k][0] = from_bits<T>(q.x);
    x[k][1] = from_bits<T>(q.y);
    x[k][2] = from_bits<T>(q.z);
    x[k][3] = from_bits<T>(q.w);
    heads[k] = load_heads(flags, f_lo + (uintptr_t)(r - phase), f_lo, f_hi);
  }
  // rows outside [phase, end) are heads of value 0; the caller's row 0 is
  // a head
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int64_t r = first + 128 * k;
    if (r >= phase && r + 4 <= end && r != phase) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (r + j <= phase || r + j >= end) heads[k] |= 1u << j;
      if (r + j < phase || r + j >= end) x[k][j] = T(0);
    }
  }

  // 2. reduce: rows within a thread, then lanes chunk by chunk, then warps
  Acc<T> pre[kChunks];  // everything before a thread's chunk in its warp
  Acc<T> run = {T(0), false, false};
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
#pragma unroll
    for (int j = 1; j < 4; ++j)
      if (!((heads[k] >> j) & 1u)) x[k][j] = apply<T, OP>(x[k][j - 1], x[k][j]);
    const Acc<T> inc =
        warp_inclusive<T, OP>(Acc<T>{x[k][3], heads[k] != 0, true});
    Acc<T> excl = shfl_up(inc, 1);
    if (lane == 0) excl.h = false;
    pre[k] = join<T, OP>(run, excl);
    run = join<T, OP>(run, shfl_idx(inc, 31));
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  // 3. publish; 4. lookback
  if (warp == 0) {
    Acc<T> tile = s_warp[0];
    for (int w = 1; w < kWarps; ++w) tile = join<T, OP>(tile, s_warp[w]);
    const uint32_t tile_bits = to_bits(tile.v);
    if (lane == 0)
      store_status(&status[t], tile.f ? kInclusive | kHead | tile_bits
                                      : kAggregate | tile_bits);
    // the tile's first row is thread 0's, chunk 0, row 0
    const bool need_carry = t > 0 && !(__shfl_sync(kFull, heads[0], 0) & 1u);
    if (need_carry) {
      int64_t top = t - 1;
      int depth = 0;
      uint32_t carry = 0;
      while (true) {
        const int64_t u = top - lane;
        const unsigned long long w = u >= 0 ? load_status(&status[u]) : 0ull;
        const unsigned stop =
            __ballot_sync(kFull, (w & (kInclusive | kHead)) != 0);
        const unsigned upto = stop ? ((stop & (0u - stop)) << 1) - 1u : kFull;
        if (__ballot_sync(kFull, w == 0) & upto) continue;  // not published yet
        if (stop) {
          const int at = __ffs(stop) - 1;
          if (lane < at) s_look[depth + lane] = (uint32_t)(w & kValueBits);
          carry = __shfl_sync(kFull, (uint32_t)(w & kValueBits), at);
          __syncwarp();
          if (lane == 0) {  // left fold, oldest first
            T c = from_bits<T>(carry);
            for (int i = depth + at - 1; i >= 0; --i)
              c = apply<T, OP>(c, from_bits<T>(s_look[i]));
            carry = to_bits(c);
          }
          carry = __shfl_sync(kFull, carry, 0);
          break;
        }
        if (depth + 32 <= kLookMax) {  // a window of aggregates: step back
          s_look[depth + lane] = (uint32_t)(w & kValueBits);
          depth += 32;
          top -= 32;
        }
      }
      if (lane == 0) {
        if (!tile.f) {
          store_status(&status[t], kInclusive |
                                       to_bits(apply<T, OP>(from_bits<T>(carry),
                                                            tile.v)));
        }
        s_carry = carry;
      }
    }
    if (lane == 0) s_has_carry = need_carry;
  }
  __syncthreads();

  // 5. join the prefixes into the rows and store them
  Acc<T> base = {from_bits<T>(s_carry), false, s_has_carry};
  for (int w = 0; w < warp; ++w) base = join<T, OP>(base, s_warp[w]);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const Acc<T> p = join<T, OP>(base, pre[k]);
    T y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // rows after a head of this thread's own chunk take no prefix
      const bool own_head = (heads[k] & ((2u << j) - 1u)) != 0;
      y[j] = (own_head || !p.h) ? x[k][j] : apply<T, OP>(p.v, x[k][j]);
    }
    const int64_t r = first + 128 * k;
    if (r >= phase && r + 4 <= end) {
      *(uint4*)(out + r) = make_uint4(to_bits(y[0]), to_bits(y[1]),
                                      to_bits(y[2]), to_bits(y[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r + j >= phase && r + j < end) out[r + j] = y[j];
    }
  }
}

template <typename T, int OP>
cudaError_t launch(const void* vals, const void* flags, void* out, int64_t n,
                   int phase, int64_t n_tiles, unsigned long long* scratch,
                   cudaStream_t s) {
  const uintptr_t mask = ~(uintptr_t)15;
  scan_single_pass<T, OP><<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const T*)((uintptr_t)vals & mask), (const uint8_t*)flags, n, phase,
      (T*)((uintptr_t)out & mask), scratch);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* vals, const void* flags, void* out,
                      int64_t n, int phase, int64_t n_tiles,
                      unsigned long long* scratch, cudaStream_t s) {
  switch (op) {
    case kSum:
      return launch<T, kSum>(vals, flags, out, n, phase, n_tiles, scratch, s);
    case kMin:
      return launch<T, kMin>(vals, flags, out, n, phase, n_tiles, scratch, s);
    case kMax:
      return launch<T, kMax>(vals, flags, out, n, phase, n_tiles, scratch, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// values, out: n rows of dtype 0 = int32, 1 = uint32, 2 = float32, 4-B
// aligned, out at the same offset from a 16-B boundary as values (the
// wrapper allocates it so) and not aliasing it; flags: n bytes, non-zero at a
// head, or nullptr (no heads but row 0); op: 0 = sum, 1 = min, 2 = max.
// scratch: at least 1 + ceil((n + 3) / 4096) 64-bit words, zeroed here (one
// memset per call).
extern "C" int rs_segmented_scan(const void* values, const void* flags,
                                 void* out, int64_t n, int dtype, int op,
                                 void* scratch, int64_t scratch_words,
                                 void* stream) {
  if (n == 0) return 0;
  const uintptr_t v = (uintptr_t)values, o = (uintptr_t)out;
  if ((v & 3) || (v & 15) != (o & 15)) return (int)cudaErrorInvalidValue;
  const int phase = (int)((v & 15) >> 2);
  const int64_t n_tiles = (n + phase + kTile - 1) / kTile;
  if (scratch_words < 1 + n_tiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* st = (unsigned long long*)scratch;
  cudaError_t err = cudaMemsetAsync(
      st, 0, (size_t)(1 + n_tiles) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  switch (dtype) {
    case 0:
      return (int)launch_op<int>(op, values, flags, out, n, phase, n_tiles, st, s);
    case 1:
      return (int)launch_op<unsigned>(op, values, flags, out, n, phase, n_tiles, st, s);
    case 2:
      return (int)launch_op<float>(op, values, flags, out, n, phase, n_tiles, st, s);
  }
  return (int)cudaErrorInvalidValue;
}
