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
// writes every plane once for c stages); shared memory and instructions
// for the tile passes (each stage moves 2 words per plane per pair through
// shared memory). A 2^24-row, 1-plane sort makes 22 passes over 64 MB plus
// the in-tile stages.
//
// Design:
//   bitonic_tile: one block per tile of 2^log_t rows with every plane in
//     dynamic shared memory (up to 227 KB). It runs levels k_first..k_last,
//     each over its strides below the tile, with one __syncthreads() per
//     stage; each thread handles a share of the tile's 2^(log_t-1) pairs.
//     Sort mode is levels 1..log_t; merge mode is one level k > log_t after
//     its cross strides. A block reads and writes only its own tile.
//   bitonic_cross: c consecutive strides 2^(lo+c-1)..2^lo of level k in one
//     round trip. A thread owns the 2^c rows per plane those strides
//     connect (base | m << lo), holds them in registers, runs the c stages
//     and stores them back. Neighbouring threads take neighbouring bases,
//     so every load and store of a warp is one contiguous run.
// Indices are 64-bit throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 4;
constexpr int kMaxRegs = 64;  // 2^c * planes words a cross thread holds
constexpr int kTileThreads = 1024;
constexpr int kCrossThreads = 256;

struct Planes {
  uint32_t* p[kMaxPlanes];
};

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

template <int P>
__global__ void __launch_bounds__(kTileThreads)
    bitonic_tile(Planes pl, int log_t, int k_first, int k_last, int L,
                 int kcmp, bool xor_rule) {
  extern __shared__ uint32_t sm[];  // [P][2^log_t]
  const int T = 1 << log_t;
  const int64_t base = (int64_t)blockIdx.x << log_t;
#pragma unroll
  for (int q = 0; q < P; ++q)
    for (int e = threadIdx.x; e < T; e += blockDim.x)
      sm[q * T + e] = pl.p[q][base + e];
  __syncthreads();

  for (int k = k_first; k <= k_last; ++k) {
    for (int j = min(k, log_t) - 1; j >= 0; --j) {
      const int s = 1 << j;
      for (int t = threadIdx.x; t < (T >> 1); t += blockDim.x) {
        const int lo = ((t >> j) << (j + 1)) | (t & (s - 1));
        const int hi = lo | s;
        uint32_t a[P], b[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          a[q] = sm[q * T + lo];
          b[q] = sm[q * T + hi];
        }
        cmpex<P>(a, b, level_desc(base + lo, k, L), kcmp, xor_rule);
#pragma unroll
        for (int q = 0; q < P; ++q) {
          sm[q * T + lo] = a[q];
          sm[q * T + hi] = b[q];
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int q = 0; q < P; ++q)
    for (int e = threadIdx.x; e < T; e += blockDim.x)
      pl.p[q][base + e] = sm[q * T + e];
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

template <int P>
cudaError_t launch_tile(const Planes& pl, int64_t n, int log_t, int k_first,
                        int k_last, int L, int kcmp, bool xor_rule,
                        cudaStream_t s) {
  const size_t smem = (size_t)P << log_t << 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bitonic_tile<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int half = 1 << (log_t - 1);
  const int threads = half < kTileThreads ? half : kTileThreads;
  bitonic_tile<P><<<(unsigned)(n >> log_t), threads, smem, s>>>(
      pl, log_t, k_first, k_last, L, kcmp, xor_rule);
  return cudaGetLastError();
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

}  // namespace

// planes: host array of n_planes device pointers (u32, n rows each, n a
// power of two and a multiple of 2^log_t). Runs levels k_first..k_last of
// the network in 2^log_t-row tiles, each level over its strides below the
// tile. net_tile is L above (0: none).
extern "C" int rs_bitonic_tile(const void* planes, int n_planes, int64_t n,
                               int log_t, int k_first, int k_last,
                               int net_tile, int n_cmp, void* stream) {
  Planes pl;
  int kcmp;
  bool xr;
  if (!setup(planes, n_planes, n_cmp, &pl, &kcmp, &xr) || log_t < 1 ||
      log_t > 16 || (n & ((1 << log_t) - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || k_first > k_last) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_planes) {
    case 1: return (int)launch_tile<1>(pl, n, log_t, k_first, k_last, net_tile, kcmp, xr, s);
    case 2: return (int)launch_tile<2>(pl, n, log_t, k_first, k_last, net_tile, kcmp, xr, s);
    case 3: return (int)launch_tile<3>(pl, n, log_t, k_first, k_last, net_tile, kcmp, xr, s);
    default: return (int)launch_tile<4>(pl, n, log_t, k_first, k_last, net_tile, kcmp, xr, s);
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
