// Inclusive segmented scan of i32 / u32 / f32 and i64 / u64 values under
// sum, min or max, restarting at every head flag (position 0 is always a
// head).
//
// Replaces: cuda/radixsort_tpu/kernels/scan.py, segmented_scan_pallas (body
// _sscan_kernel). The TPU kernel carries the running value from one grid
// step to the next in SMEM, because that grid runs in order; blocks here run
// in any order, so each tile's carry-in comes from a decoupled lookback over
// the tiles before it (CUB agent/agent_scan_by_key.cuh ConsumeTile, tile
// state agent/single_pass_scan_operators.cuh). The 8-byte instances go past
// the TPU kernel, which takes 32-bit values.
//
// Bound on this card: device memory. The function reads S B of value and
// 1 B of flag and writes S B per row (2 S B without flags), S = 4 or 8:
// 151 MB at 2^24 rows of 4 B, about 45 us at 3.35 TB/s (285 MB, 85 us, of
// 8 B). This kernel reads every row once and writes it once, in one launch
// (plus one memset of the tile states).
//
// Design: one block per tile of 16 KiB of values (256 threads x 4 vectors of
// 16 B: 4096 rows of 4 B, 2048 of 8 B), taken in order from an atomic
// counter, so every earlier tile's block is already running and a lookback
// cannot wait on a block that never got an SM. Four blocks an SM for every
// value type (at most 64 registers): a 4096-row tile of 8-B values took 104
// registers, ran two blocks an SM and reached 35-38% of its bound, the
// 2048-row tile 49-54%.
//   1. Load. A warp owns 2 KiB of consecutive rows as 4 chunks of one 16-B
//      vector a lane (4 rows of 4 B or 2 rows of 8 B); a thread loads each
//      chunk's aligned vector of values and the word of its flags, all
//      chunks before any arithmetic. Rows are counted from the 16-B
//      boundary at or before the values' first row, so a view at any offset
//      loads aligned vectors; rows before the first and after the last are
//      masked (heads of value 0, never stored). The output is allocated
//      with the values' 16-B phase; flags of another phase are read as two
//      aligned words and funnel-shifted.
//   2. Reduce. A thread scans its chunk's rows, a warp scans its lanes'
//      pairs with shuffles chunk by chunk, and thread 0 joins the warps'
//      pairs. Every pair is (value, has-head, holds-a-value) under the
//      segmented operator (a,fa) + (b,fb) = (fb ? b : a o b, fa | fb).
//   3. Publish the tile's status as one store: the value's bits, a
//      has-head bit and AGGREGATE / INCLUSIVE bits, so a reader never sees
//      a flag without its value. 4-B values: one 64-bit word, 32 value bits
//      and the flags above them. 8-B values: one 16-B word, the value and
//      the flags, stored and loaded as one vector (CUB's TxnWord for 8-byte
//      T). A tile holding a head publishes INCLUSIVE at once: its aggregate
//      already starts at its last head.
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
// Offsets are int64. Integer sums wrap (they are added as unsigned); f32
// min/max propagate NaN as jnp.minimum/maximum do (fminf/fmaxf would drop
// it).
//
// Reverse direction (REV, a template parameter: the forward instances are
// the code above): the same scan of the rows taken from the last to the
// first, so row i gets the fold of rows [i, end of i's segment], and a
// segment ends at row i where flags[i + 1] is set or i = n - 1: the flags
// are the segments' first rows, as for the forward scan. It equals
// flip -> forward scan -> flip without its copies. Reversed row r is
// the caller's row n-1-r. The steps above run unchanged on the reversed
// rows: tiles claimed from the end of the array, the lookback over them in
// claim order. The phase is the array end's: the reversed rows are counted
// from the 16-B boundary at or after the values' end (span, a multiple of a
// vector's rows), so reversed vector k is the memory vector that ends span -
// V k rows past the values' aligned start, read and stored as one vector
// with its rows swapped. A reversed row's head is its caller row's end
// flag, flags[i + 1], read at a one-byte offset by load_heads with the
// bits swapped; reversed row 0 (the caller's last row) is always a head,
// and the flags of rows past it are masked. Same association as the
// forward kernel on the flipped values at the same phase (bit for bit
// where that phase is 0, as for a fresh flipped copy).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;  // 16-B vectors of values per thread
constexpr int kTileBytes = kThreads * kChunks * 16;  // keep in step with
                                                     // kernels/scan.py
constexpr int kLookMax = 256;  // aggregates a lookback steps over before it
                               // waits on its last window
constexpr unsigned kFull = 0xffffffffu;

// a tile status's flag bits
constexpr unsigned kHead = 1u;
constexpr unsigned kAggregate = 2u;
constexpr unsigned kInclusive = 4u;

enum { kSum = 0, kMin = 1, kMax = 2 };

// The bits of a value, and the rows of one 16-B vector.
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 8, unsigned long long,
                                       uint32_t>::type;

template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {  // a is the earlier operand
  if constexpr (OP == kSum) {
    if constexpr (std::is_same<T, int>::value)
      return (int)((unsigned)a + (unsigned)b);
    else if constexpr (std::is_same<T, long long>::value)
      return (long long)((unsigned long long)a + (unsigned long long)b);
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
__device__ __forceinline__ Bits<T> to_bits(T v) {
  if constexpr (std::is_same<T, float>::value)
    return __float_as_uint(v);
  else
    return (Bits<T>)v;
}

template <typename T>
__device__ __forceinline__ T from_bits(Bits<T> b) {
  if constexpr (std::is_same<T, float>::value)
    return __uint_as_float(b);
  else
    return (T)b;
}

// The rows of a 16-B vector, and back.
template <typename T>
__device__ __forceinline__ void unpack(uint4 q, T (&x)[kVec<T>]) {
  if constexpr (sizeof(T) == 4) {
    x[0] = from_bits<T>(q.x);
    x[1] = from_bits<T>(q.y);
    x[2] = from_bits<T>(q.z);
    x[3] = from_bits<T>(q.w);
  } else {
    x[0] = from_bits<T>((unsigned long long)q.x |
                        ((unsigned long long)q.y << 32));
    x[1] = from_bits<T>((unsigned long long)q.z |
                        ((unsigned long long)q.w << 32));
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const T (&y)[kVec<T>]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(to_bits(y[0]), to_bits(y[1]), to_bits(y[2]),
                      to_bits(y[3]));
  } else {
    const unsigned long long a = to_bits(y[0]), b = to_bits(y[1]);
    return make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)b,
                      (unsigned)(b >> 32));
  }
}

// A vector's rows in the other order.
template <typename T>
__device__ __forceinline__ void swap_rows(T (&x)[kVec<T>]) {
#pragma unroll
  for (int j = 0; j < kVec<T> / 2; ++j) {
    const T v = x[j];
    x[j] = x[kVec<T> - 1 - j];
    x[kVec<T> - 1 - j] = v;
  }
}

// The tiles' status words in the scratch after the tile counter (word 0).
// 4-B values: one 64-bit word a tile, the value's 32 bits below the flags.
template <typename T, bool kWide = sizeof(T) == 8>
struct TileStatus {
  unsigned long long* words;

  __device__ explicit TileStatus(unsigned long long* scratch)
      : words(scratch + 1) {}

  __device__ __forceinline__ void store(int64_t t, Bits<T> v,
                                        unsigned flags) const {
    *(volatile unsigned long long*)(words + t) =
        ((unsigned long long)flags << 32) | v;
  }

  __device__ __forceinline__ void load(int64_t t, Bits<T>& v,
                                       unsigned& flags) const {
    const unsigned long long w = *(const volatile unsigned long long*)(words + t);
    v = (uint32_t)w;
    flags = (unsigned)(w >> 32);
  }
};

// 8-B values: one 16-B word a tile (the value, then the flags), from the
// first 16-B boundary after the tile counter, stored and loaded as one
// vector so that the flags never arrive without their value.
template <typename T>
struct TileStatus<T, true> {
  unsigned long long* words;

  __device__ explicit TileStatus(unsigned long long* scratch)
      : words(scratch + 2) {}

  __device__ __forceinline__ void store(int64_t t, Bits<T> v,
                                        unsigned flags) const {
    asm volatile("st.volatile.v2.u64 [%0], {%1, %2};" ::"l"(words + 2 * t),
                 "l"(v), "l"((unsigned long long)flags)
                 : "memory");
  }

  __device__ __forceinline__ void load(int64_t t, Bits<T>& v,
                                       unsigned& flags) const {
    unsigned long long f;
    asm volatile("ld.volatile.v2.u64 {%0, %1}, [%2];"
                 : "=l"(v), "=l"(f)
                 : "l"(words + 2 * t)
                 : "memory");
    flags = (unsigned)f;
  }
};

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

// The 4-B word at a (4-B aligned), or 0 if it holds none of [lo, hi): a word
// that holds a byte of the array lies in that byte's page, so it is safe to
// read; the bytes outside the array are masked by the caller.
__device__ __forceinline__ uint32_t load_word(uintptr_t a, uintptr_t lo,
                                              uintptr_t hi) {
  return (a + 4 > lo && a < hi) ? __ldg((const uint32_t*)a) : 0u;
}

// The flag bytes of R <= 4 rows from byte address a (any phase) as an R-bit
// head mask, or 0 for flags == nullptr.
template <int R>
__device__ __forceinline__ unsigned load_heads(const uint8_t* flags,
                                               uintptr_t a, uintptr_t lo,
                                               uintptr_t hi) {
  if (flags == nullptr) return 0u;
  const uintptr_t wa = a & ~(uintptr_t)3;
  const unsigned skip = (unsigned)(a - wa);
  uint32_t w = load_word(wa, lo, hi);
  if (skip + R > 4)
    w = __funnelshift_r(w, load_word(wa + 4, lo, hi), 8 * skip);
  else
    w >>= 8 * skip;
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) m |= ((w >> (8 * j)) & 0xffu) ? 1u << j : 0u;
  return m;
}

// vals, out: 16-B aligned, row r of the caller's arrays at r + phase (REV:
// reversed row r at span - 1 - r, span the least multiple of a vector's
// rows at or above n + phase); flags: the caller's flags (row r at
// flags + r) or nullptr; scratch: word 0 the tile counter, then the tiles'
// status words (TileStatus), all zero at launch.
template <typename T, int OP, bool REV>
__global__ void __launch_bounds__(kThreads, 4)
    scan_single_pass(const T* __restrict__ vals, const uint8_t* flags,
                     int64_t n, int phase, T* __restrict__ out,
                     unsigned long long* scratch) {
  constexpr int V = kVec<T>;
  constexpr int kTileRows = kTileBytes / sizeof(T);
  constexpr int kLaneStride = 32 * V;  // rows from one chunk to the next
  using B = Bits<T>;
  __shared__ Acc<T> s_warp[kWarps];
  __shared__ B s_look[kLookMax + 32];  // the last window's too
  __shared__ int64_t s_tile;
  __shared__ B s_carry;
  __shared__ bool s_has_carry;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TileStatus<T> status(scratch);
  if (tid == 0) s_tile = (int64_t)atomicAdd((unsigned int*)scratch, 1u);
  __syncthreads();
  const int64_t t = s_tile;

  // 1. load: chunk k of this thread holds rows first + 32 V k + {0..V-1}
  const int64_t first =
      t * kTileRows + warp * (kLaneStride * kChunks) + V * lane;
  const int64_t end = n + phase;  // rows [phase, end) are the caller's
  const int64_t span = (end + V - 1) / V * V;  // REV: row r at span - 1 - r
  const uintptr_t f_lo = (uintptr_t)flags, f_hi = f_lo + (uintptr_t)n;
  T x[kChunks][V];
  unsigned heads[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int64_t r = first + kLaneStride * k;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (REV) {
      // the memory vector of rows span-V-r .. span-1-r; the head of reversed
      // row r + j is flags[n + phase - r - j], lowest address at j = V - 1
      if (r + V > phase && r < end)
        q = __ldg((const uint4*)(vals + (span - V - r)));
      unpack<T>(q, x[k]);
      swap_rows<T>(x[k]);
      heads[k] = __brev(load_heads<V>(
                     flags, f_lo + (uintptr_t)(n + phase - r - (V - 1)), f_lo,
                     f_hi)) >> (32 - V);
    } else {
      if (r + V > phase && r < end) q = __ldg((const uint4*)(vals + r));
      unpack<T>(q, x[k]);
      heads[k] = load_heads<V>(flags, f_lo + (uintptr_t)(r - phase), f_lo, f_hi);
    }
  }
  // rows outside [phase, end) are heads of value 0; the caller's row 0 is
  // a head
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int64_t r = first + kLaneStride * k;
    if (r >= phase && r + V <= end && r != phase) continue;
#pragma unroll
    for (int j = 0; j < V; ++j) {
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
    for (int j = 1; j < V; ++j)
      if (!((heads[k] >> j) & 1u)) x[k][j] = apply<T, OP>(x[k][j - 1], x[k][j]);
    const Acc<T> inc =
        warp_inclusive<T, OP>(Acc<T>{x[k][V - 1], heads[k] != 0, true});
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
    if (lane == 0)
      status.store(t, to_bits(tile.v),
                   tile.f ? kInclusive | kHead : kAggregate);
    // the tile's first row is thread 0's, chunk 0, row 0
    const bool need_carry = t > 0 && !(__shfl_sync(kFull, heads[0], 0) & 1u);
    if (need_carry) {
      int64_t top = t - 1;
      int depth = 0;
      B carry = 0;
      while (true) {
        const int64_t u = top - lane;
        B v = 0;
        unsigned fl = 0;
        if (u >= 0) status.load(u, v, fl);
        const unsigned stop =
            __ballot_sync(kFull, (fl & (kInclusive | kHead)) != 0);
        const unsigned upto = stop ? ((stop & (0u - stop)) << 1) - 1u : kFull;
        if (__ballot_sync(kFull, fl == 0) & upto) continue;  // not published yet
        if (stop) {
          const int at = __ffs(stop) - 1;
          if (lane < at) s_look[depth + lane] = v;
          carry = __shfl_sync(kFull, v, at);
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
          s_look[depth + lane] = v;
          depth += 32;
          top -= 32;
        }
      }
      if (lane == 0) {
        if (!tile.f)
          status.store(t, to_bits(apply<T, OP>(from_bits<T>(carry), tile.v)),
                       kInclusive);
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
    T y[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      // rows after a head of this thread's own chunk take no prefix
      const bool own_head = (heads[k] & ((2u << j) - 1u)) != 0;
      y[j] = (own_head || !p.h) ? x[k][j] : apply<T, OP>(p.v, x[k][j]);
    }
    const int64_t r = first + kLaneStride * k;
    if constexpr (REV) {
      if (r >= phase && r + V <= end) {
        swap_rows<T>(y);
        *(uint4*)(out + (span - V - r)) = pack<T>(y);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (r + j >= phase && r + j < end) out[span - 1 - r - j] = y[j];
      }
    } else if (r >= phase && r + V <= end) {
      *(uint4*)(out + r) = pack<T>(y);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (r + j >= phase && r + j < end) out[r + j] = y[j];
    }
  }
}

template <typename T, int OP, bool REV>
cudaError_t launch(const void* vals, const void* flags, void* out, int64_t n,
                   int phase, int64_t n_tiles, unsigned long long* scratch,
                   cudaStream_t s) {
  const uintptr_t mask = ~(uintptr_t)15;
  scan_single_pass<T, OP, REV><<<(unsigned)n_tiles, kThreads, 0, s>>>(
      (const T*)((uintptr_t)vals & mask), (const uint8_t*)flags, n, phase,
      (T*)((uintptr_t)out & mask), scratch);
  return cudaGetLastError();
}

template <typename T, bool REV>
cudaError_t launch_op(int op, const void* vals, const void* flags, void* out,
                      int64_t n, int phase, int64_t n_tiles,
                      unsigned long long* scratch, cudaStream_t s) {
  switch (op) {
    case kSum:
      return launch<T, kSum, REV>(vals, flags, out, n, phase, n_tiles, scratch,
                                  s);
    case kMin:
      return launch<T, kMin, REV>(vals, flags, out, n, phase, n_tiles, scratch,
                                  s);
    case kMax:
      return launch<T, kMax, REV>(vals, flags, out, n, phase, n_tiles, scratch,
                                  s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_dir(int reverse, int op, const void* vals, const void* flags,
                       void* out, int64_t n, int phase, int64_t n_tiles,
                       unsigned long long* scratch, cudaStream_t s) {
  return reverse ? launch_op<T, true>(op, vals, flags, out, n, phase, n_tiles,
                                      scratch, s)
                 : launch_op<T, false>(op, vals, flags, out, n, phase, n_tiles,
                                       scratch, s);
}

}  // namespace

// values, out: n rows of dtype 0 = int32, 1 = uint32, 2 = float32, 3 = int64,
// 4 = uint64, aligned to their size, out at the same offset from a 16-B
// boundary as values (the wrapper allocates it so) and not aliasing it;
// flags: n bytes, non-zero at a head, or nullptr (no heads but row 0); op:
// 0 = sum, 1 = min, 2 = max; reverse: 0 = forward, 1 = from the last row to
// the first (row i's segment ends before the next head). scratch: 16-B
// aligned, at least
// 1 + ceil((n + 3) / 4096) 64-bit words for 4-B values and
// 2 + 2 ceil((n + 1) / 2048) for 8-B values, zeroed here (one memset per
// call).
extern "C" int rs_segmented_scan(const void* values, const void* flags,
                                 void* out, int64_t n, int dtype, int op,
                                 int reverse, void* scratch,
                                 int64_t scratch_words, void* stream) {
  if (n == 0) return 0;
  if (dtype < 0 || dtype > 4) return (int)cudaErrorInvalidValue;
  const int size = dtype >= 3 ? 8 : 4;
  const uintptr_t v = (uintptr_t)values, o = (uintptr_t)out;
  if ((v & (size - 1)) || (v & 15) != (o & 15) || ((uintptr_t)scratch & 15))
    return (int)cudaErrorInvalidValue;
  const int vec = 16 / size;
  // the forward rows' phase is the values' start's, the reversed rows' their
  // end's: from the last row to the next 16-B boundary
  int phase = (int)((v & 15) / size);
  if (reverse) phase = (int)((vec - (n + phase) % vec) % vec);
  const int64_t tile_rows = kTileBytes / size;
  const int64_t n_tiles = (n + phase + tile_rows - 1) / tile_rows;
  const int64_t words = size == 8 ? 2 + 2 * n_tiles : 1 + n_tiles;
  if (scratch_words < words) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* st = (unsigned long long*)scratch;
  cudaError_t err = cudaMemsetAsync(
      st, 0, (size_t)words * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  switch (dtype) {
    case 0:
      return (int)launch_dir<int>(reverse, op, values, flags, out, n, phase,
                                  n_tiles, st, s);
    case 1:
      return (int)launch_dir<unsigned>(reverse, op, values, flags, out, n, phase,
                                       n_tiles, st, s);
    case 2:
      return (int)launch_dir<float>(reverse, op, values, flags, out, n, phase,
                                    n_tiles, st, s);
    case 3:
      return (int)launch_dir<long long>(reverse, op, values, flags, out, n, phase,
                                        n_tiles, st, s);
    case 4:
      return (int)launch_dir<unsigned long long>(reverse, op, values, flags, out,
                                                 n, phase, n_tiles, st, s);
  }
  return (int)cudaErrorInvalidValue;
}
