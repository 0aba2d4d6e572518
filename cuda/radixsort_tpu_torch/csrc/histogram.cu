// All-digit histograms of the u32 limb columns of one sort: one read of the
// keys yields the histogram of every `width`-bit digit position of every
// limb (stage s of a limb = bits [width*s, width*(s+1)) of limb & mask).
//
// Replaces: cuda/radixsort_tpu/kernels/histogram.py, digit_histograms
// (body _hist_kernel), called once per limb by the JAX pipeline
// (cuda/radixsort_tpu/kernels/pipeline.py); the onesweep histogram of CUB
// agent/agent_radix_sort_histogram.cuh, which counts every pass in one read
// before the first pass: histograms do not change under the permutations
// the earlier passes apply.
//
// Bound on this card: device-memory reads against shared-memory atomics.
// The kernel reads 4 B per key per limb once (a 2^24-key limb is about
// 20 us at 3.35 TB/s); a warp's shared-memory atomic issues about once in
// 4-6 cycles on an SM, so the count of atomics per key decides the rest.
// Design:
//   - Bytes, whatever the width. Every key costs one atomic per 8-bit digit
//     it covers (at most 4), never one per stage: a 2- or 4-bit stage's
//     histogram is a sum over the 256-bin histogram of the byte that holds
//     it, taken by the launch's last block. So widths 2 and 4 cost what
//     width 8 costs (16 and 8 atomics a key counted per stage).
//   - Loads. A grid-stride loop over 16-B vectors: a thread loads 4 aligned
//     uint4 (16 keys) per step, and the next step's 4 before it counts the
//     current ones. Vectors start at the 16-B boundary at or before the
//     limb's first key, so a view at any offset loads aligned vectors; keys
//     before the first and after the last are masked, and so are the bits
//     outside an unaligned bit range.
//   - Counting. One table per block in shared memory with a column per
//     lane (bin d of lane l at d * 32 + l), so a warp's 32 atomics fall in
//     32 banks whatever the digits, equal ones included; with a table per
//     warp, 256 random bins conflict on banks.
//   - Limbs. Up to RS_HIST_MAX_LIMBS limbs in one launch, counted in groups
//     whose bins fit the block's table.
//   - 8-byte columns. The two limbs of a 64-bit key, given as the stride-2
//     halves of its column, are one group read once as 8-byte words (uint4
//     vectors of two rows). Their bins do not fit one table of 32 lanes, so
//     each (byte, value) row of the table holds 16 columns of the low limb
//     and 16 of the high one, and a warp counts in two rounds: lanes below
//     16 count low words while the others count high words, then the roles
//     swap. The atomics of a warp still fall in 32 banks, and a key costs
//     the same atomics as two limbs read apart.
//   - Output in the same launch: each block adds its table to an int32
//     accumulator in scratch with one global atomic per non-zero bin; the
//     last block to finish (a ticket counter) reads it into shared memory
//     limb by limb, writes every stage's histogram from there, and leaves
//     the accumulator and the counter zeroed for the next launch. Integer
//     atomics make the result exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rs_limits.h"

namespace {

constexpr int kVecs = 4;  // uint4 vectors a thread loads per step
constexpr int kKeys = 4 * kVecs;
constexpr int kThreads = 1024;  // a block: 32 warps over one table
// uint4 vectors (2 rows each) of an 8-byte column a thread loads per step:
// 2 beat 1, 3 and 4 on an H100 80GB HBM3 (2^28 rows: 1.081 ms against
// 1.118, 1.135 and 1.128; 8 spills)
constexpr int kPairVecs = 2;

struct Limb {
  const uint32_t* keys;
  uint32_t mask;
  int n_bytes;      // 8-bit digits counted: ceil(n_stages * width / 8)
  int n_stages;     // width-bit stages written to the output
  int acc_offset;   // the limb's first byte bin in the accumulator
  int out_offset;   // the limb's first bin in the output
  int group_first;  // the limb starts a group of limbs counted together
};

struct LimbSet {
  Limb limb[RS_HIST_MAX_LIMBS];
  int n;
};

// Rows [4 idx, 4 idx + 4) of the limb's aligned vectors that are keys, as
// a 4-bit mask; keys are rows [phase, end).
__device__ __forceinline__ unsigned vector_mask(int64_t idx, int phase,
                                                int64_t end) {
  const int64_t r = 4 * idx;
  if (r >= phase && r + 4 <= end) return 0xfu;
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (r + j >= phase && r + j < end) m |= 1u << j;
  return m;
}

__device__ __forceinline__ void load_step(const uint4* base, int64_t v0,
                                          int64_t n_vec, int phase,
                                          int64_t end, uint4 (&q)[kVecs],
                                          unsigned& valid) {
  valid = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t idx = v0 + k * (int64_t)blockDim.x + threadIdx.x;
    if (idx < n_vec) {
      q[k] = __ldg(base + idx);
      valid |= vector_mask(idx, phase, end) << (4 * k);
    }
  }
}

// One step of 16 keys (bit i of valid: key i is one) into the table at
// tab: byte s, value d of this lane at tab[((s << 8) + d) * 32 + lane].
__device__ __forceinline__ void count_step(const uint4 (&q)[kVecs],
                                           unsigned valid, uint32_t mask,
                                           int n_bytes, int* tab) {
  uint32_t key[kKeys];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    key[4 * k + 0] = q[k].x & mask;
    key[4 * k + 1] = q[k].y & mask;
    key[4 * k + 2] = q[k].z & mask;
    key[4 * k + 3] = q[k].w & mask;
  }
  tab += threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    if (!((valid >> i) & 1u)) continue;
    for (int s = 0; s < n_bytes; ++s)
      atomicAdd(&tab[((s << 8) + (int)((key[i] >> (8 * s)) & 0xffu)) << 5], 1);
  }
}

__device__ __forceinline__ void count_limb(const Limb& limb, int64_t n,
                                           int* tab) {
  const uintptr_t p = (uintptr_t)limb.keys;
  const uint4* base = (const uint4*)(p & ~(uintptr_t)15);
  const int phase = (int)((p & 15) >> 2);
  const int64_t end = n + phase;
  const int64_t n_vec = (end + 3) >> 2;
  const int64_t per = (int64_t)blockDim.x * kVecs;
  const int64_t stride = per * gridDim.x;
  uint4 q[kVecs];
  unsigned valid;
  int64_t v0 = blockIdx.x * per;
  load_step(base, v0, n_vec, phase, end, q, valid);
  while (v0 < n_vec) {
    uint4 nq[kVecs];
    unsigned nvalid;
    load_step(base, v0 + stride, n_vec, phase, end, nq, nvalid);
    count_step(q, valid, limb.mask, limb.n_bytes, tab);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) q[k] = nq[k];
    valid = nvalid;
    v0 += stride;
  }
}

// Rows [2 idx, 2 idx + 2) of an 8-byte column's aligned vectors that are
// keys, as a 2-bit mask; keys are rows [phase, end).
__device__ __forceinline__ unsigned pair_mask(int64_t idx, int phase,
                                              int64_t end) {
  const int64_t r = 2 * idx;
  if (r >= phase && r + 2 <= end) return 3u;
  return (r >= phase && r < end ? 1u : 0u) |
         (r + 1 >= phase && r + 1 < end ? 2u : 0u);
}

// One step of an 8-byte column: this lane's kPairVecs vectors (2 rows each;
// bit 2k + j of valid: row j of vector k is a key), both words of a row. A
// row's low word counts in columns 0-15 of the table, its high word in
// columns 16-31, so the lanes take turns: in one round lanes below 16 count
// low words (column lane) while the others count high words (column lane),
// in the next the roles swap (column lane ^ 16). Either way a warp's 32
// atomics fall in 32 banks. mask / n_bytes: this lane's limb in the first
// round (low below 16, high from 16); other_*: the other limb.
__device__ __forceinline__ void count_pair_step(const uint4 (&q)[kPairVecs],
                                                unsigned valid, uint32_t mask,
                                                int n_bytes,
                                                uint32_t other_mask,
                                                int other_n_bytes, int* tab) {
  const int lane = threadIdx.x & 31;
  const bool high = lane >= 16;
  uint32_t key[4 * kPairVecs];
#pragma unroll
  for (int k = 0; k < kPairVecs; ++k) {
    key[4 * k + 0] = high ? q[k].y : q[k].x;  // first round, row 0
    key[4 * k + 1] = high ? q[k].w : q[k].z;  // first round, row 1
    key[4 * k + 2] = high ? q[k].x : q[k].y;  // second round, row 0
    key[4 * k + 3] = high ? q[k].z : q[k].w;  // second round, row 1
  }
#pragma unroll
  for (int i = 0; i < 4 * kPairVecs; ++i) {
    const int k = i >> 2, j = i & 1;
    const bool second = (i & 2) != 0;
    if (!((valid >> (2 * k + j)) & 1u)) continue;
    const uint32_t v = key[i] & (second ? other_mask : mask);
    int* col = tab + (second ? lane ^ 16 : lane);
    for (int s = 0; s < (second ? other_n_bytes : n_bytes); ++s)
      atomicAdd(&col[((s << 8) + (int)((v >> (8 * s)) & 0xffu)) << 5], 1);
  }
}

__device__ __forceinline__ void load_pair_step(const uint4* base, int64_t v0,
                                               int64_t n_vec, int phase,
                                               int64_t end,
                                               uint4 (&q)[kPairVecs],
                                               unsigned& valid) {
  valid = 0;
#pragma unroll
  for (int k = 0; k < kPairVecs; ++k) {
    const int64_t idx = v0 + k * (int64_t)blockDim.x + threadIdx.x;
    q[k] = idx < n_vec ? __ldg(base + idx) : make_uint4(0u, 0u, 0u, 0u);
    if (idx < n_vec) valid |= pair_mask(idx, phase, end) << (2 * k);
  }
}

// Both limbs of an 8-byte column into the table (see count_pair_step); the
// next step's vectors load before the current ones are counted.
__device__ __forceinline__ void count_pair(const Limb& lo, const Limb& hi,
                                           int64_t n, int* tab) {
  const uintptr_t p = (uintptr_t)lo.keys;
  const uint4* base = (const uint4*)(p & ~(uintptr_t)15);
  const int phase = (int)((p & 15) >> 3);
  const int64_t end = n + phase;
  const int64_t n_vec = (end + 1) >> 1;
  const int64_t per = (int64_t)blockDim.x * kPairVecs;
  const int64_t stride = per * gridDim.x;
  const bool high = (threadIdx.x & 31) >= 16;
  const Limb& mine = high ? hi : lo;
  const Limb& other = high ? lo : hi;
  uint4 q[kPairVecs];
  unsigned valid;
  int64_t v0 = blockIdx.x * per;
  load_pair_step(base, v0, n_vec, phase, end, q, valid);
  while (v0 < n_vec) {
    uint4 nq[kPairVecs];
    unsigned nvalid;
    load_pair_step(base, v0 + stride, n_vec, phase, end, nq, nvalid);
    count_pair_step(q, valid, mine.mask, mine.n_bytes, other.mask,
                    other.n_bytes, tab);
#pragma unroll
    for (int k = 0; k < kPairVecs; ++k) q[k] = nq[k];
    valid = nvalid;
    v0 += stride;
  }
}

// scratch: word 0 the ticket counter, then the accumulator's byte bins; all
// zero at launch and left zero. PAIRS (a launch with 8-byte columns): bit l
// of low / high marks limb l as the low / high half of a column whose other
// half is limb l + 1 or l - 1; a launch of plain limbs runs the kernel
// without that branch.
template <bool PAIRS>
__global__ void __launch_bounds__(kThreads, 1)
    hist_kernel(const __grid_constant__ LimbSet set, int64_t n, int width,
                int table_bins, unsigned* __restrict__ scratch,
                unsigned* __restrict__ out, unsigned low, unsigned high) {
  extern __shared__ int s_hist[];  // [table_bins][32 lanes]
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  unsigned* acc = scratch + 1;  // counts up to 2^31 (n <= 2^31): u32
  for (int g = 0; g < set.n;) {
    if (PAIRS && (((low | high) >> g) & 1u)) {  // limbs g, g + 1: a column
      const Limb& lo = set.limb[(low >> g) & 1u ? g : g + 1];
      const Limb& hi = set.limb[(low >> g) & 1u ? g + 1 : g];
      const int rows = (lo.n_bytes > hi.n_bytes ? lo.n_bytes : hi.n_bytes)
                       << 8;
      for (int j = tid; j < (rows << 5); j += blockDim.x) s_hist[j] = 0;
      __syncthreads();
      count_pair(lo, hi, n, s_hist);
      __syncthreads();
      for (int j = tid; j < rows; j += blockDim.x) {
        unsigned sum_lo = 0, sum_hi = 0;  // columns skewed as below
        for (int c = 0; c < 32; ++c) {
          const int col = (c + j) & 31;
          const unsigned v = (unsigned)s_hist[(j << 5) + col];
          if (col < 16) sum_lo += v;
          else sum_hi += v;
        }
        if (sum_lo && j < (lo.n_bytes << 8))
          atomicAdd(&acc[lo.acc_offset + j], sum_lo);
        if (sum_hi && j < (hi.n_bytes << 8))
          atomicAdd(&acc[hi.acc_offset + j], sum_hi);
      }
      __syncthreads();
      g += 2;
      continue;
    }
    int e = g + 1;
    while (e < set.n && !set.limb[e].group_first) ++e;
    const int g_off = set.limb[g].acc_offset;
    const int g_bins =
        set.limb[e - 1].acc_offset + (set.limb[e - 1].n_bytes << 8) - g_off;
    for (int j = tid; j < (table_bins << 5); j += blockDim.x) s_hist[j] = 0;
    __syncthreads();
    for (int l = g; l < e; ++l)
      count_limb(set.limb[l], n,
                 s_hist + ((set.limb[l].acc_offset - g_off) << 5));
    __syncthreads();
    for (int j = tid; j < g_bins; j += blockDim.x) {
      unsigned sum = 0;  // columns in an order skewed by bin: no conflicts
      for (int c = 0; c < 32; ++c)
        sum += (unsigned)s_hist[(j << 5) + ((c + j) & 31)];
      if (sum) atomicAdd(&acc[g_off + j], sum);
    }
    __syncthreads();
    g = e;
  }
  __threadfence();  // this block's sums before its ticket
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(scratch, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // limb by limb: its byte bins into shared memory (the accumulator zeroed
  // behind them), then stage s, bin b = the sum of the byte bins v of the
  // byte holding bits [width*s, width*s + width) whose bits there are b
  const int nb = 1 << width;
  for (int l = 0; l < set.n; ++l) {
    const Limb& limb = set.limb[l];
    unsigned* bytes = acc + limb.acc_offset;
    for (int j = tid; j < (limb.n_bytes << 8); j += blockDim.x) {
      s_hist[j] = (int)__ldcg(bytes + j);
      bytes[j] = 0;
    }
    __syncthreads();
    for (int j = tid; j < (limb.n_stages << width); j += blockDim.x) {
      const int bit = (j >> width) * width, b = j & (nb - 1);
      const int lo = bit & 7;  // the stage's offset in its byte
      const int* row = s_hist + ((bit >> 3) << 8);
      unsigned sum = 0;
      for (int hi = 0; hi < (256 >> (lo + width)); ++hi)
        for (int v = 0; v < (1 << lo); ++v)
          sum += (unsigned)row[(hi << (lo + width)) | (b << lo) | v];
      out[limb.out_offset + j] = sum;
    }
    __syncthreads();
  }
  if (tid == 0) *scratch = 0u;
}

}  // namespace

extern "C" const char* rs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keys: host array of n_limbs device pointers (n u32 each, 4-B aligned;
// element stride 1, or 2 for the halves of an 8-byte column); masks,
// n_stages, halves: host arrays, one per limb (1 <= n_stages, n_stages *
// width <= 32; 0 stages only for a half). halves[l]: -1 for a plain limb;
// 0 or 1 for the low or high half of an 8-byte column (8-B aligned) whose
// other half is limb l + 1, which gives 1 or 0. out: sum(n_stages) * 2^width
// u32 counts (n <= 2^31, so a count of 2^31 fits), limb by limb, written
// whole. A limb counts 256 bins for each of its ceil(n_stages * width / 8)
// bytes; limbs are counted in groups of at most table_bins bins (an 8-byte
// column's two limbs in a group of its own, at most table_bins bins each), a
// block's table in shared memory holding table_bins x 32 ints. scratch: 1 +
// the limbs' byte bins, u32, zero before the first launch on its stream;
// every launch leaves it zero. threads: kThreads.
extern "C" int rs_limb_histograms(const void* keys, const void* masks,
                                  const void* n_stages, const void* halves,
                                  int n_limbs, int64_t n, int width, void* out,
                                  void* scratch, int table_bins, int grid,
                                  int threads, void* stream) {
  if (n_limbs < 1 || n_limbs > RS_HIST_MAX_LIMBS ||
      (width != 2 && width != 4 && width != 8) || threads != kThreads ||
      grid < 1 || table_bins < 1 ||
      (size_t)table_bins * 32 * sizeof(int) > (size_t)RS_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  const void* const* ptrs = (const void* const*)keys;
  const uint32_t* mk = (const uint32_t*)masks;
  const int* st = (const int*)n_stages;
  const int* hv = (const int*)halves;
  LimbSet set;
  set.n = n_limbs;
  int acc = 0, outs = 0, group_bins = 0;
  unsigned low = 0, high = 0;  // bit l: limb l is the low / high half
  bool second = false;         // limb l is the second half of a pair
  for (int l = 0; l < n_limbs; ++l) {
    const int n_bytes = (st[l] * width + 7) / 8, bins = n_bytes << 8;
    if (hv[l] < -1 || hv[l] > 1 || st[l] < (hv[l] >= 0 ? 0 : 1) ||
        st[l] * width > 32 || bins > table_bins || ((uintptr_t)ptrs[l] & 3) ||
        (second && hv[l] < 0))
      return (int)cudaErrorInvalidValue;
    bool first;
    if (hv[l] >= 0 && !second) {  // a pair: this limb and the next
      if (l + 1 >= n_limbs || hv[l + 1] != 1 - hv[l])
        return (int)cudaErrorInvalidValue;
      const uintptr_t lo = (uintptr_t)ptrs[hv[l] == 0 ? l : l + 1];
      const uintptr_t hi = (uintptr_t)ptrs[hv[l] == 0 ? l + 1 : l];
      if ((lo & 7) || hi != lo + 4) return (int)cudaErrorInvalidValue;
      first = second = true;
      group_bins = table_bins;  // no other limb joins the pair's group
    } else if (hv[l] >= 0) {
      first = second = false;
    } else {
      first = l == 0 || group_bins + bins > table_bins;
      group_bins = first ? bins : group_bins + bins;
    }
    if (hv[l] == 0) low |= 1u << l;
    if (hv[l] == 1) high |= 1u << l;
    set.limb[l] = {(const uint32_t*)ptrs[l], mk[l], n_bytes, st[l], acc,
                   outs, first};
    acc += bins;
    outs += st[l] << width;
  }
  const size_t smem = (size_t)table_bins * 32 * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = (low | high) ? hist_kernel<true> : hist_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, s>>>(set, n, width, table_bins,
                                     (unsigned*)scratch, (unsigned*)out, low,
                                     high);
  return (int)cudaGetLastError();
}
