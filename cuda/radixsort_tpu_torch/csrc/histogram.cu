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

// scratch: word 0 the ticket counter, then the accumulator's byte bins; all
// zero at launch and left zero.
__global__ void __launch_bounds__(kThreads, 1)
    hist_kernel(const __grid_constant__ LimbSet set, int64_t n, int width,
                int table_bins, unsigned* __restrict__ scratch,
                unsigned* __restrict__ out) {
  extern __shared__ int s_hist[];  // [table_bins][32 lanes]
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  unsigned* acc = scratch + 1;  // counts up to 2^31 (n <= 2^31): u32
  for (int g = 0; g < set.n;) {
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

// keys: host array of n_limbs device pointers (n u32 each, 4-B aligned);
// masks, n_stages: host arrays, one per limb (1 <= n_stages, n_stages *
// width <= 32). out: sum(n_stages) * 2^width u32 counts (n <= 2^31, so a
// count of 2^31 fits), limb by limb, written whole. A limb counts 256 bins for each of its ceil(n_stages * width / 8)
// bytes; limbs are counted in groups of at most table_bins bins, a block's
// table in shared memory holding table_bins x 32 ints. scratch: 1 + the
// limbs' byte bins, u32, zero before the first launch on its stream;
// every launch leaves it zero. threads: kThreads.
extern "C" int rs_limb_histograms(const void* keys, const void* masks,
                                  const void* n_stages, int n_limbs,
                                  int64_t n, int width, void* out,
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
  LimbSet set;
  set.n = n_limbs;
  int acc = 0, outs = 0, group_bins = 0;
  for (int l = 0; l < n_limbs; ++l) {
    const int n_bytes = (st[l] * width + 7) / 8, bins = n_bytes << 8;
    if (st[l] < 1 || st[l] * width > 32 || bins > table_bins ||
        ((uintptr_t)ptrs[l] & 3))
      return (int)cudaErrorInvalidValue;
    const bool first = l == 0 || group_bins + bins > table_bins;
    group_bins = first ? bins : group_bins + bins;
    set.limb[l] = {(const uint32_t*)ptrs[l], mk[l], n_bytes, st[l], acc,
                   outs, first};
    acc += bins;
    outs += st[l] << width;
  }
  const size_t smem = (size_t)table_bins * 32 * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  hist_kernel<<<grid, threads, smem, s>>>(set, n, width, table_bins,
                                          (unsigned*)scratch, (unsigned*)out);
  return (int)cudaGetLastError();
}
