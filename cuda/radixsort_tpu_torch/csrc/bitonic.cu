// Bitonic compare-exchange network over 1-4 u32 planes, in place.
//
// Replaces: cuda/radixsort_tpu/kernels/bitonic.py, _tile_call (bodies
// _tile_sort_body / _tile_merge_body, pallas_call :412) and
// _cross_span_pallas (pallas_call :922 strided, :947 flat), with the
// comparator of _cmpex_planes. The TPU bodies' lane gathers, sublane rolls,
// transposed frames and manual multi-slot DMA rings exist for that VPU's
// (8, 128) layout and are not carried over.
//
// The network. Stage (k, j) of global level k pairs index i (bit j clear)
// with i | 2^j. The pair sorts descending iff bit k of i is set, XOR bit L
// of i for levels k < L: the TPU engine sorts 2^L-row tiles in alternating
// direction, which folds the tile's direction into every level below L.
// Every correct schedule of the same stages gives the same output, so this
// file may cut the stages into launches as it likes: the output is fixed by
// (n, L, n_cmp) alone, and it is the JAX engine's, ties included.
//
// The comparator (lower element a, upper element b, lexicographic over the
// first kcmp = min(|n_cmp|, P) planes; the other planes ride along):
//   xor rule (n_cmp > 0, or no ride planes): a takes b iff lt ^ !desc,
//     b takes a iff gt ^ desc. On a full tie both sides end up with b's
//     rows, so callers never feed ties to it (an index or tag comparand
//     makes the order total).
//   tie-safe rule (n_cmp < 0 with ride planes): the pair swaps iff it is
//     out of order (desc ? lt : gt); tied rows never move.
// Comparisons are unsigned on the raw u32 bits.
//
// Bound on this card: device memory for the cross passes (each reads and
// writes every plane once for c stages). The tile passes are bound by
// instructions: a sort pass runs every stage of its levels on every row
// (105 at 1 plane), while its bytes move once, and a compare-exchange of
// 4 planes is a lexicographic compare and 8 selects. The first tile
// kernel ran each stage through shared memory with a block barrier after
// it (120 barriers a 2^15-row sort pass, one 1024-thread block per SM, so
// no block's copies overlapped another's work) and took 37x its byte
// bound.
//
// Design:
//   bitonic_tile: one block per tile of 2^log_t rows with every plane in
//     dynamic shared memory, padded one word in 32 against bank conflicts;
//     the tile is sized for two 256-thread blocks an SM
//     (kernels/bitonic.py::tile_log_rows). It runs levels k_first..k_last,
//     each over its strides below the tile (sort mode: levels 1..log_t;
//     merge mode: one level k > log_t after its cross strides), in phases
//     separated by one __syncthreads() each; the caller passes the phase
//     list (kernels/bitonic.py::tile_phases) and this file checks that
//     each phase fits the geometry. A thread holds E = 2^e rows of every
//     plane in registers (E * planes <= 32 words) and loops over its
//     units:
//       - strides of 2^(e+5) and more: groups of up to e consecutive
//         strides; a unit gathers the 2^c rows each group connects (as the
//         cross kernel does in device memory), runs the c stages in
//         registers and stores them back;
//       - strides 2^e..2^(e+4): lanes of one warp, __shfl_xor_sync, each
//         lane computing its own side of the pair;
//       - strides below 2^e: registers of one thread.
//     The last two run in one phase on E consecutive rows a unit: the
//     whole of every level whose strides stay below 2^(e+5), the tail of
//     every other. A 2^14-row, 1-plane sort pass runs its 105 stages in 9
//     phases. Tiles move in and out in 16-byte coalesced copies; a merge
//     pass's first group of strides reads device memory itself.
//   bitonic_cross: c consecutive strides 2^(lo+c-1)..2^lo of level k in one
//     round trip. A thread owns the 2^c rows per plane those strides
//     connect (base | m << lo), holds them in registers, runs the c stages
//     and stores them back. Neighbouring threads take neighbouring bases,
//     so every load and store of a warp is one contiguous run.
// Indices are 64-bit throughout.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rs_limits.h"  // config.py's limits, written by utils/build.py

namespace {

constexpr int kMaxPlanes = RS_MAX_PLANES;
constexpr int kMaxRegs = RS_MAX_CROSS_WORDS;  // 2^c * planes words a cross thread holds
constexpr int kMaxTileWords = RS_MAX_TILE_WORDS;  // 2^e * planes words a tile thread holds
constexpr int kMaxTileThreads = RS_MAX_TILE_THREADS;
constexpr int kTileBlocksPerSM = RS_TILE_BLOCKS_PER_SM;
constexpr int kLogWarp = 5;  // a shuffle pairs lanes less than 32 apart
constexpr int kMaxPhases = 16;  // 16 bits each in four 64-bit arguments
constexpr int kCrossThreads = 256;
static_assert(kMaxTileWords <= 32, "tile_for_rows builds E up to 32 rows");

struct Planes {
  uint32_t* p[kMaxPlanes];
};

// The tile kernel's phase list (kernels/bitonic.py::tile_phases), 16 bits
// a phase: shared (1 bit), k, a, b (5 bits each), four phases a word.
//   shared = 1: strides 2^(a+b-1)..2^a of level k, a group through shared
//     memory (lo = a, c = b);
//   shared = 0: a register phase: level k from stride 2^b down, then levels
//     k+1..a whole (k_end = a, top = b).
// The words travel as scalar arguments: an array argument indexed at run
// time would take its address, and that slowed the kernel.
struct Phases {
  uint64_t w0, w1, w2, w3;
  int n;
};

__device__ __forceinline__ uint32_t phase_code(uint64_t w0, uint64_t w1,
                                               uint64_t w2, uint64_t w3,
                                               int i) {
  const uint64_t w = i < 8 ? (i < 4 ? w0 : w1) : (i < 12 ? w2 : w3);
  return (uint32_t)(w >> (16 * (i & 3))) & 0xFFFFu;
}

// Bytes of dynamic shared memory the launch gave this block.
__device__ __forceinline__ uint32_t dynamic_smem_bytes() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(r));
  return r;
}

__device__ __forceinline__ bool level_desc(int64_t i, int k, int L) {
  int64_t b = i >> k;
  if (k < L) b ^= i >> L;
  return b & 1;
}

template <int P>
__device__ __forceinline__ void cmpex(uint32_t (&a)[P], uint32_t (&b)[P],
                                      bool desc, int kcmp, bool xor_rule) {
  if constexpr (P == 1) {
    const uint32_t lo = min(a[0], b[0]), hi = max(a[0], b[0]);
    a[0] = desc ? hi : lo;
    b[0] = desc ? lo : hi;
    return;
  }
  bool lt = false, eq = true;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (q < kcmp) {
      lt = lt || (eq && a[q] < b[q]);
      eq = eq && a[q] == b[q];
    }
  }
  const bool gt = !(lt || eq);
  bool take_a, take_b;
  if (xor_rule) {
    take_a = lt != !desc;
    take_b = gt != desc;
  } else {
    take_a = desc ? lt : gt;
    take_b = take_a;
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const uint32_t x = a[q], y = b[q];
    a[q] = take_a ? y : x;
    b[q] = take_b ? x : y;
  }
}

// One side of a compare-exchange whose other row lies in another lane: the
// result cmpex<P> gives the lower row (upper = false) or the upper row,
// computed from (own, other) without building (a, b).
template <int P>
__device__ __forceinline__ void cmpex_side(uint32_t (&own)[P],
                                           const uint32_t (&other)[P],
                                           bool upper, bool desc, int kcmp,
                                           bool xor_rule) {
  if constexpr (P == 1) {
    own[0] = (desc != upper) ? max(own[0], other[0]) : min(own[0], other[0]);
    return;
  }
  bool lt = false, eq = true;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (q < kcmp) {
      lt = lt || (eq && own[q] < other[q]);
      eq = eq && own[q] == other[q];
    }
  }
  const bool gt = !(lt || eq);
  const bool ab_lt = upper ? gt : lt, ab_gt = upper ? lt : gt;
  bool take;
  if (xor_rule)
    take = upper ? (ab_gt != desc) : (ab_lt != !desc);
  else
    take = desc ? ab_lt : ab_gt;
#pragma unroll
  for (int q = 0; q < P; ++q) own[q] = take ? other[q] : own[q];
}

__host__ __device__ constexpr int log2_of(int x) {
  return x <= 1 ? 0 : 1 + log2_of(x >> 1);
}

// Shared-memory index of tile row r: one word of padding per 32 rows, so
// both access patterns below are free of bank conflicts (a warp reading
// rows u * E + m for E <= 32, or 32 consecutive rows).
__device__ __forceinline__ int padded(int r) { return r + (r >> 5); }

// level_desc(tile0 + r, k, L) for tile-local rows r < 2^log_t, in 32-bit
// arithmetic: b0 ^ bit kpos of r ^ bit lpos of r (a position of 31 reads
// 0; the bits the tile fixes are folded into b0).
struct Dir {
  uint32_t b0;
  int kpos, lpos;
  __device__ __forceinline__ Dir(int64_t tile0, int k, int L, int log_t) {
    b0 = 0;
    kpos = lpos = 31;
    if (k < log_t) kpos = k; else b0 ^= (uint32_t)(tile0 >> k) & 1u;
    if (k < L) {
      if (L < log_t) lpos = L; else b0 ^= (uint32_t)(tile0 >> L) & 1u;
    }
  }
  __device__ __forceinline__ bool of(int r) const {
    return (b0 ^ (((uint32_t)r >> kpos) ^ ((uint32_t)r >> lpos))) & 1u;
  }
};

// Rows m < 32 whose bit b is set, as a bit mask over m (0 for b >= 5).
__device__ __forceinline__ uint32_t bit_rows(int b) {
  switch (b) {
    case 0: return 0xAAAAAAAAu;
    case 1: return 0xCCCCCCCCu;
    case 2: return 0xF0F0F0F0u;
    case 3: return 0xFF00FF00u;
    case 4: return 0xFFFF0000u;
    default: return 0u;
  }
}

// One group of c strides 2^(lo+c-1)..2^lo (lo >= e + 5) of level k. Unit u
// holds the 2^c rows of 2^(e-c) groups, g = u + gi * units, each at
// base(g) | mm << lo; consecutive lanes take consecutive bases.
template <int P, int E>
__device__ __forceinline__ void shared_phase(uint32_t* sm, int pitch,
                                             const Planes& pl, int64_t tile0,
                                             bool from_device, const Dir& dir,
                                             int units, int lo, int c,
                                             int kcmp, bool xor_rule) {
  constexpr int e = log2_of(E);
  const int low = (1 << lo) - 1, in_group = (1 << c) - 1;
  auto row = [&](int u, int m) {
    const int g = u + (m >> c) * units;
    return ((g >> lo) << (lo + c)) | (g & low) | ((m & in_group) << lo);
  };
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    uint32_t v[E][P];
#pragma unroll
    for (int m = 0; m < E; ++m)
#pragma unroll
      for (int q = 0; q < P; ++q)
        v[m][q] = from_device ? pl.p[q][tile0 + row(u, m)]
                              : sm[q * pitch + padded(row(u, m))];
#pragma unroll
    for (int jj = e - 1; jj >= 0; --jj) {
      if (jj >= c) continue;
#pragma unroll
      for (int m = 0; m < E; ++m)
        if (!(m & (1 << jj)))
          cmpex<P>(v[m], v[m | (1 << jj)], dir.of(row(u, m)), kcmp, xor_rule);
    }
#pragma unroll
    for (int m = 0; m < E; ++m)
#pragma unroll
      for (int q = 0; q < P; ++q) sm[q * pitch + padded(row(u, m))] = v[m][q];
  }
}

// Levels k..k_end over their strides below 2^(e+5), the first from stride
// 2^top down: unit u holds rows u * E .. u * E + E - 1. Strides of E and
// more pair lanes (__shfl_xor_sync; each lane keeps its side), smaller
// ones pair registers of one thread. No barrier inside.
template <int P, int E>
__device__ __forceinline__ void register_phase(
    uint32_t* sm, int pitch, int64_t tile0, int units, int k, int k_end,
    int top, int log_t, int L, int kcmp, bool xor_rule, unsigned wmask) {
  constexpr int e = log2_of(E);
  const int lane = threadIdx.x & 31;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int r0 = u * E;
    uint32_t v[E][P];
#pragma unroll
    for (int m = 0; m < E; ++m)
#pragma unroll
      for (int q = 0; q < P; ++q) v[m][q] = sm[q * pitch + padded(r0 + m)];
    for (int kk = k; kk <= k_end; ++kk) {
      // direction of row r0 + m is bit m of dm: r0's own bits and the
      // tile's are the same for every m; the low e bits are m's
      const Dir dir(tile0, kk, L, log_t);
      const uint32_t dm = (dir.of(r0) ? 0xFFFFFFFFu : 0u) ^
                          bit_rows(dir.kpos < e ? dir.kpos : 31) ^
                          bit_rows(dir.lpos < e ? dir.lpos : 31);
      const int hi = kk == k ? top : min(kk, log_t) - 1;
      for (int j = hi; j >= e; --j) {
        const int s = 1 << (j - e);
        const bool upper = lane & s;
#pragma unroll
        for (int m = 0; m < E; ++m) {
          uint32_t o[P];
#pragma unroll
          for (int q = 0; q < P; ++q) o[q] = __shfl_xor_sync(wmask, v[m][q], s);
          cmpex_side<P>(v[m], o, upper, (dm >> m) & 1u, kcmp, xor_rule);
        }
      }
#pragma unroll
      for (int jj = e - 1; jj >= 0; --jj) {
        if (jj > hi) continue;
#pragma unroll
        for (int m = 0; m < E; ++m)
          if (!(m & (1 << jj)))
            cmpex<P>(v[m], v[m | (1 << jj)], (dm >> m) & 1u, kcmp, xor_rule);
      }
    }
#pragma unroll
    for (int m = 0; m < E; ++m)
#pragma unroll
      for (int q = 0; q < P; ++q) sm[q * pitch + padded(r0 + m)] = v[m][q];
  }
}

// Device memory <-> the padded tile in shared memory, 16 bytes a load or
// store where the plane's tile is 16-byte aligned.
template <int P, bool IN>
__device__ __forceinline__ void copy_tile(uint32_t* sm, int pitch,
                                          const Planes& pl, int64_t tile0,
                                          int T) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    uint32_t* g = pl.p[q] + tile0;
    uint32_t* s = sm + q * pitch;
    if (T >= 4 && ((uintptr_t)g & 15) == 0) {
      uint4* g4 = (uint4*)g;
#pragma unroll 4
      for (int i = threadIdx.x; i < (T >> 2); i += blockDim.x) {
        uint32_t* r = s + padded(i << 2);  // 4 rows never straddle a pad
        if (IN) {
          const uint4 v = g4[i];
          r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
        } else {
          g4[i] = make_uint4(r[0], r[1], r[2], r[3]);
        }
      }
    } else {
#pragma unroll 8
      for (int i = threadIdx.x; i < T; i += blockDim.x) {
        if (IN) s[padded(i)] = g[i]; else g[i] = s[padded(i)];
      }
    }
  }
}

// Runs the phases it is given, in order, one barrier before each; the
// caller's list (kernels/bitonic.py::tile_phases) is the schedule.
template <int P, int E>
__global__ void __launch_bounds__(kMaxTileThreads, kTileBlocksPerSM)
    bitonic_tile(Planes pl, int log_t, uint64_t ph0, uint64_t ph1,
                 uint64_t ph2, uint64_t ph3, int n_phases, int L, int kcmp,
                 bool xor_rule) {
  constexpr int e = log2_of(E);
  extern __shared__ uint32_t sm[];  // [P][2^log_t padded]
  const int T = 1 << log_t, pitch = padded(T), units = T >> e;
  // the caller sizes shared memory (kernels/bitonic.py::tile_smem_bytes)
  if (threadIdx.x == 0 && (size_t)P * pitch * 4 > dynamic_smem_bytes()) __trap();
  const int64_t tile0 = (int64_t)blockIdx.x << log_t;
  const unsigned wmask =
      blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
  // merge mode whose first phase is a group of strides: that phase reads
  // device memory itself (consecutive lanes, consecutive rows)
  const uint32_t first = phase_code(ph0, ph1, ph2, ph3, 0);
  bool from_device = (first >> 15) && (int)((first >> 10) & 31) > log_t;
  if (!from_device) copy_tile<P, true>(sm, pitch, pl, tile0, T);

  for (int i = 0; i < n_phases; ++i) {
    const uint32_t code = phase_code(ph0, ph1, ph2, ph3, i);
    const int k = (code >> 10) & 31, a = (code >> 5) & 31, b = code & 31;
    __syncthreads();
    if (code >> 15) {
      shared_phase<P, E>(sm, pitch, pl, tile0, from_device,
                         Dir(tile0, k, L, log_t), units, a, b, kcmp,
                         xor_rule);
      from_device = false;
    } else {
      register_phase<P, E>(sm, pitch, tile0, units, k, a, b, log_t, L, kcmp,
                           xor_rule, wmask);
    }
  }
  __syncthreads();
  copy_tile<P, false>(sm, pitch, pl, tile0, T);
}

template <int P, int C>
__global__ void __launch_bounds__(kCrossThreads)
    bitonic_cross(Planes pl, int64_t n_groups, int lo, int k, int L,
                  int kcmp, bool xor_rule) {
  constexpr int G = 1 << C;
  const int64_t low_mask = ((int64_t)1 << lo) - 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < n_groups; g += stride) {
    const int64_t base = ((g >> lo) << (lo + C)) | (g & low_mask);
    uint32_t v[G][P];
#pragma unroll
    for (int m = 0; m < G; ++m)
#pragma unroll
      for (int q = 0; q < P; ++q) v[m][q] = pl.p[q][base + ((int64_t)m << lo)];
    const bool desc = level_desc(base, k, L);
#pragma unroll
    for (int jj = C - 1; jj >= 0; --jj)
#pragma unroll
      for (int m = 0; m < G; ++m)
        if (!(m & (1 << jj))) cmpex<P>(v[m], v[m | (1 << jj)], desc, kcmp, xor_rule);
#pragma unroll
    for (int m = 0; m < G; ++m)
#pragma unroll
      for (int q = 0; q < P; ++q) pl.p[q][base + ((int64_t)m << lo)] = v[m][q];
  }
}

template <int P, int E>
cudaError_t launch_tile(const Planes& pl, int64_t n, int log_t, int threads,
                        const Phases& ph, int L, int kcmp, bool xor_rule,
                        size_t smem, cudaStream_t s) {
  if constexpr (E * P > kMaxTileWords) {
    return cudaErrorInvalidValue;
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          bitonic_tile<P, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
    bitonic_tile<P, E><<<(unsigned)(n >> log_t), threads, smem, s>>>(
        pl, log_t, ph.w0, ph.w1, ph.w2, ph.w3, ph.n, L, kcmp, xor_rule);
    return cudaGetLastError();
  }
}

template <int P>
cudaError_t tile_for_rows(int log_e, const Planes& pl, int64_t n, int log_t,
                          int threads, const Phases& ph, int L, int kcmp,
                          bool xor_rule, size_t smem, cudaStream_t s) {
  switch (log_e) {
    case 1: return launch_tile<P, 2>(pl, n, log_t, threads, ph, L, kcmp, xor_rule, smem, s);
    case 2: return launch_tile<P, 4>(pl, n, log_t, threads, ph, L, kcmp, xor_rule, smem, s);
    case 3: return launch_tile<P, 8>(pl, n, log_t, threads, ph, L, kcmp, xor_rule, smem, s);
    case 4: return launch_tile<P, 16>(pl, n, log_t, threads, ph, L, kcmp, xor_rule, smem, s);
    case 5: return launch_tile<P, 32>(pl, n, log_t, threads, ph, L, kcmp, xor_rule, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int P, int C>
cudaError_t launch_cross(const Planes& pl, int64_t n, int lo, int k, int L,
                         int kcmp, bool xor_rule, cudaStream_t s) {
  if constexpr ((1 << C) * P > kMaxRegs) {
    return cudaErrorInvalidValue;
  } else {
    const int64_t n_groups = n >> C;
    int64_t blocks = (n_groups + kCrossThreads - 1) / kCrossThreads;
    if (blocks > (1 << 30)) blocks = 1 << 30;
    bitonic_cross<P, C><<<(unsigned)blocks, kCrossThreads, 0, s>>>(
        pl, n_groups, lo, k, L, kcmp, xor_rule);
    return cudaGetLastError();
  }
}

template <int P>
cudaError_t cross_for_width(int c, const Planes& pl, int64_t n, int lo,
                            int k, int L, int kcmp, bool xor_rule,
                            cudaStream_t s) {
  switch (c) {
    case 1: return launch_cross<P, 1>(pl, n, lo, k, L, kcmp, xor_rule, s);
    case 2: return launch_cross<P, 2>(pl, n, lo, k, L, kcmp, xor_rule, s);
    case 3: return launch_cross<P, 3>(pl, n, lo, k, L, kcmp, xor_rule, s);
    case 4: return launch_cross<P, 4>(pl, n, lo, k, L, kcmp, xor_rule, s);
    case 5: return launch_cross<P, 5>(pl, n, lo, k, L, kcmp, xor_rule, s);
    case 6: return launch_cross<P, 6>(pl, n, lo, k, L, kcmp, xor_rule, s);
    default: return cudaErrorInvalidValue;
  }
}

// Unpacks the host array of plane pointers; kcmp and the rule from n_cmp.
bool setup(const void* planes, int n_planes, int n_cmp, Planes* pl,
           int* kcmp, bool* xor_rule) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n_cmp == 0) return false;
  const void* const* ptrs = (const void* const*)planes;
  for (int q = 0; q < kMaxPlanes; ++q)
    pl->p[q] = q < n_planes ? (uint32_t*)ptrs[q] : nullptr;
  const int a = n_cmp < 0 ? -n_cmp : n_cmp;
  *kcmp = a < n_planes ? a : n_planes;
  *xor_rule = n_cmp > 0 || *kcmp == n_planes;
  return true;
}

// Packs the host words (shared, k, a, b per phase) into *out if every
// phase is one the tile kernel can run on E = 2^e rows a thread: a group
// of 1..e strides within the tile; a register phase whose shuffle strides
// stay inside a warp.
bool read_phases(const int* w, int n_phases, int log_t, int e, Phases* out) {
  if (n_phases < 1 || n_phases > kMaxPhases) return false;
  uint64_t words[4] = {0, 0, 0, 0};
  for (int i = 0; i < n_phases; ++i, w += 4) {
    const int shared = w[0], k = w[1], a = w[2], b = w[3];
    const int below = k < log_t ? k : log_t;  // level k's strides in the tile
    if (k < 1 || k > 31) return false;
    if (shared == 1) {
      if (b < 1 || b > e || a < 0 || a + b > below) return false;
    } else if (shared == 0) {
      if (a < k || a > 31 || b < 0 || b >= below || b - e >= kLogWarp)
        return false;
      for (int kk = k + 1; kk <= a; ++kk)
        if ((kk < log_t ? kk : log_t) - 1 - e >= kLogWarp) return false;
    } else {
      return false;
    }
    const uint64_t code = (uint64_t)(shared << 15 | k << 10 | a << 5 | b);
    words[i / 4] |= code << (16 * (i % 4));
  }
  *out = Phases{words[0], words[1], words[2], words[3], n_phases};
  return true;
}

}  // namespace

// planes: host array of n_planes device pointers (u32, n rows each, n a
// power of two and a multiple of 2^log_t). Runs the n_phases phases of
// the host array phases (4 ints each, see Phases) in 2^log_t-row tiles. Each
// thread holds 2^log_e rows per plane (2^log_e * n_planes words, at most
// RS_MAX_TILE_WORDS); threads: a power of two up to RS_MAX_TILE_THREADS and
// up to 2^(log_t - log_e), all of them below 32 (the shuffles then pair
// lanes of one pass). smem: the block's dynamic shared memory, bytes
// (kernels/bitonic.py::tile_geometry, tile_phases, tile_smem_bytes).
// net_tile is L above (0: none).
extern "C" int rs_bitonic_tile(const void* planes, int n_planes, int64_t n,
                               int log_t, int log_e, int threads,
                               const void* phases, int n_phases, int net_tile,
                               int n_cmp, int64_t smem, void* stream) {
  Planes pl;
  Phases ph;
  int kcmp;
  bool xr;
  if (!setup(planes, n_planes, n_cmp, &pl, &kcmp, &xr) || log_t < 1 ||
      log_t > 16 || (n & ((1 << log_t) - 1)) != 0 || log_e < 1 ||
      log_e > log_t || threads < 1 || threads > kMaxTileThreads ||
      (threads & (threads - 1)) != 0 || threads > (1 << (log_t - log_e)) ||
      (threads < 32 && threads != (1 << (log_t - log_e))) || smem < 1 ||
      !read_phases((const int*)phases, n_phases, log_t, log_e, &ph))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_planes) {
    case 1: return (int)tile_for_rows<1>(log_e, pl, n, log_t, threads, ph, net_tile, kcmp, xr, (size_t)smem, s);
    case 2: return (int)tile_for_rows<2>(log_e, pl, n, log_t, threads, ph, net_tile, kcmp, xr, (size_t)smem, s);
    case 3: return (int)tile_for_rows<3>(log_e, pl, n, log_t, threads, ph, net_tile, kcmp, xr, (size_t)smem, s);
    default: return (int)tile_for_rows<4>(log_e, pl, n, log_t, threads, ph, net_tile, kcmp, xr, (size_t)smem, s);
  }
}

// Strides 2^(lo+c-1) .. 2^lo of level k (lo + c <= k), in one pass; c is
// 1..6 with 2^c * n_planes <= 64.
extern "C" int rs_bitonic_cross(const void* planes, int n_planes, int64_t n,
                                int k, int lo, int c, int net_tile, int n_cmp,
                                void* stream) {
  Planes pl;
  int kcmp;
  bool xr;
  if (!setup(planes, n_planes, n_cmp, &pl, &kcmp, &xr) || lo < 0 || c < 1 ||
      lo + c > k || (n & (((int64_t)1 << (lo + c)) - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_planes) {
    case 1: return (int)cross_for_width<1>(c, pl, n, lo, k, net_tile, kcmp, xr, s);
    case 2: return (int)cross_for_width<2>(c, pl, n, lo, k, net_tile, kcmp, xr, s);
    case 3: return (int)cross_for_width<3>(c, pl, n, lo, k, net_tile, kcmp, xr, s);
    default: return (int)cross_for_width<4>(c, pl, n, lo, k, net_tile, kcmp, xr, s);
  }
}
