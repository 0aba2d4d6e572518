// One stable LSD counting pass over u32 planes, by the digit
// (key >> shift) & (2^width - 1) of plane 0; every other plane follows the
// same permutation.
//
// Replaces: cuda/radixsort_tpu/kernels/stage.py, partition_stage (body
// _stage_kernel, with the in-tile rank of kernels/tiles.py). The TPU kernel's
// VMEM carries, MXU byte-plane router and 32-row DMA flushes are not carried
// over: they exist because that VPU has no scatter.
//
// Bound on this card: device memory. A pass must read and write 4 B per
// plane per key; the key plane is read once, and the scan state is 8 B per
// digit per tile (reset with one memset per pass). What held the first
// version back was the store: each lane wrote its word to its own bucket
// run, so one warp's 32 stores touched up to 32 sectors, and the pass read
// the keys three times in three launches. What bounds this one at 2^24 is
// not known yet: it runs several times its byte bound (PERF.md).
//
// Design: a onesweep pass (CUB's agent_radix_sort_onesweep.cuh, the
// function, not the code): one launch per group of up to 8 planes.
//   1. Tile claim: a block takes its tile index from an atomic counter, so
//      tiles run in claim order and a lookback only waits on tiles whose
//      blocks are already running.
//   2. Rank: each warp loads its 32 * ITEMS keys once (coalesced rounds of
//      32) into registers. In each round __match_any_sync groups the lanes of
//      equal digit; popc(peers & lanemask_lt) plus the warp's running count
//      is a key's rank. Rank order is warps, then rounds, then lanes: index
//      order, so the pass is stable. A scan over warps and one over digits
//      give every key its slot in the digit-sorted tile.
//   3. Decoupled lookback: the tile publishes its per-digit counts as
//      PARTIAL in a 64-bit status word per (tile, digit) (two flag bits and a
//      62-bit count), walks back over earlier tiles adding counts until an
//      INCLUSIVE word, publishes its own INCLUSIVE prefix, and adds
//      gbase[d]. Offsets are int64.
//   4. Exchange: each key's slot in the digit-sorted tile is known before
//      the lookback, so the keys and their digits go to shared memory
//      then, and the next plane's values are loaded ahead of the lookback
//      and of each store. After a barrier consecutive threads read
//      consecutive slots and store slot s of digit d at
//      offset[d] + (s - tile_start[d]), so each bucket run is written by
//      contiguous lanes in whole sectors; one plane at a time through one
//      reused buffer.
// Planes beyond the first 8 run in further launches that rank the same keys
// again and read each tile's INCLUSIVE words, which the first launch left;
// they do not look back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rs_limits.h"  // config.py's limits, written by utils/build.py

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kMaxThreads = RS_MAX_STAGE_THREADS;
constexpr int kWindow = 8;  // status words a lookback step loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPartial = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
  int n;
};

// Bytes of dynamic shared memory the launch gave this block.
__device__ __forceinline__ uint32_t dynamic_smem_bytes() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(r));
  return r;
}

// Block-wide inclusive scan of one int64 per thread (blockDim.x <= 1024).
__device__ long long block_inclusive_scan(long long v, long long* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 1; k < 32; k <<= 1) {
    const long long up = __shfl_up_sync(kFull, v, k);
    if (lane >= k) v += up;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    long long w = lane < nw ? s_warp[lane] : 0;
    for (int k = 1; k < 32; k <<= 1) {
      const long long up = __shfl_up_sync(kFull, w, k);
      if (lane >= k) w += up;
    }
    if (lane < nw) s_warp[lane] = w;
  }
  __syncthreads();
  return v + (warp > 0 ? s_warp[warp - 1] : 0);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// status: [1 + n_tiles * nb] words, word 0 the tile counter (zeroed before
// the first launch). lookback: the first launch of a pass (claims tiles,
// looks back, publishes); otherwise tile = blockIdx.x and the offsets come
// from the INCLUSIVE words the first launch left.
template <int ITEMS>
__global__ void __launch_bounds__(kMaxThreads, ITEMS <= 16 ? 2 : 1)
    stage_onesweep(const uint32_t* __restrict__ keys, Planes p, int64_t n,
                   int shift, int nb, const uint32_t* __restrict__ gbase,
                   unsigned long long* status, bool lookback) {
  // the caller sizes shared memory (kernels/stage.py::stage_smem_bytes)
  extern __shared__ unsigned long long smem[];
  const int threads = blockDim.x, warps = threads >> 5;
  const int tile_elems = threads * ITEMS;
  int64_t* s_goff = (int64_t*)smem;                        // [nb]
  long long* s_scan = (long long*)(s_goff + nb);           // [32]
  uint32_t* s_buf = (uint32_t*)(s_scan + 32);              // [tile]
  int* s_wc = (int*)(s_buf + tile_elems);                  // [warps][nb]
  int* s_cnt = s_wc + warps * nb;                          // [nb]
  int* s_dstart = s_cnt + nb;                              // [nb]
  int* s_tile = s_dstart + nb;                             // [4]
  uint8_t* s_dig = (uint8_t*)(s_tile + 4);                 // [tile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0 && (s_dig + tile_elems) - (uint8_t*)smem > dynamic_smem_bytes())
    __trap();
  const unsigned lt = (1u << lane) - 1u;
  const uint32_t mask = nb - 1;
  unsigned long long* tiles = status + 1;

  if (tid == 0)
    s_tile[0] = lookback ? (int)atomicAdd((unsigned int*)status, 1u)
                         : (int)blockIdx.x;
  for (int j = tid; j < warps * nb; j += threads) s_wc[j] = 0;
  __syncthreads();
  const int64_t t = s_tile[0];
  const int64_t start = t * tile_elems;
  const int valid_n = (int)(n - start < tile_elems ? n - start : tile_elems);
  const int wbase = warp * 32 * ITEMS;  // this warp's first key in the tile

  // load the warp's keys once, coalesced rounds of 32
  uint32_t key[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int i = wbase + r * 32 + lane;
    key[r] = i < valid_n ? keys[start + i] : 0u;
  }

  // rank within the warp: warp-running count + rank among equal lanes
  int slot[ITEMS];
  int* mine = s_wc + warp * nb;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool valid = wbase + r * 32 + lane < valid_n;
    const int d = valid ? (int)((key[r] >> shift) & mask) : nb;
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = valid ? mine[d] : 0;
    slot[r] = before + __popc(peers & lt);
    __syncwarp();
    if (valid && (peers & lt) == 0) mine[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // per digit: exclusive scan over warps, the tile's count
  for (int d = tid; d < nb; d += threads) {
    int run = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = s_wc[w * nb + d];
      s_wc[w * nb + d] = run;
      run += c;
    }
    s_cnt[d] = run;
  }
  __syncthreads();

  // publish the tile's counts: INCLUSIVE for tile 0, else PARTIAL
  if (lookback) {
    for (int d = tid; d < nb; d += threads)
      store_status(&tiles[t * nb + d],
                   (t == 0 ? kInclusive : kPartial) | (unsigned)s_cnt[d]);
  }

  // exclusive scan over digits: where each digit's run starts in the tile
  {
    const int per = (nb + threads - 1) / threads;
    const int lo = tid * per < nb ? tid * per : nb;
    const int hi = lo + per < nb ? lo + per : nb;
    long long sum = 0;
    for (int d = lo; d < hi; ++d) sum += s_cnt[d];
    long long run = block_inclusive_scan(sum, s_scan) - sum;
    for (int d = lo; d < hi; ++d) {
      s_dstart[d] = (int)run;
      run += s_cnt[d];
    }
  }
  __syncthreads();

  // each key's slot in the digit-sorted tile; the keys (plane 0 of the
  // first group) and every slot's digit go to shared memory now
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const bool valid = wbase + r * 32 + lane < valid_n;
    const int d = (int)((key[r] >> shift) & mask);
    slot[r] = valid ? s_dstart[d] + s_wc[warp * nb + d] + slot[r] : -1;
    if (valid) {
      if (lookback) s_buf[slot[r]] = key[r];
      s_dig[slot[r]] = (uint8_t)d;
    }
  }
  // the next plane's values, loaded ahead of the lookback and of each
  // store so that their latency overlaps them
  uint32_t val[ITEMS];
  auto prefetch = [&](int q) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
      if (slot[r] >= 0) val[r] = p.in[q][start + wbase + r * 32 + lane];
  };
  if (!lookback) prefetch(0);
  else if (p.n > 1) prefetch(1);

  // the tile's global offset per digit
  for (int d = tid; d < nb; d += threads) {
    long long excl = 0;
    if (lookback) {
      // walk back kWindow tiles at a time: their words load together
      bool done = t == 0;
      for (int64_t u = t - 1; !done; u -= kWindow) {
        unsigned long long w[kWindow];
#pragma unroll
        for (int i = 0; i < kWindow; ++i)
          w[i] = u - i >= 0 ? load_status(&tiles[(u - i) * nb + d]) : 0;
#pragma unroll
        for (int i = 0; i < kWindow; ++i) {
          if (done) continue;
          while ((w[i] & (kPartial | kInclusive)) == 0)
            w[i] = load_status(&tiles[(u - i) * nb + d]);
          excl += (long long)(w[i] & kValue);
          done = (w[i] & kInclusive) != 0;
        }
      }
      if (t > 0) {
        __threadfence();
        store_status(&tiles[t * nb + d],
                     kInclusive | (unsigned long long)(excl + s_cnt[d]));
      }
    } else {
      excl = (long long)(load_status(&tiles[t * nb + d]) & kValue) - s_cnt[d];
    }
    s_goff[d] = (int64_t)gbase[d] + excl - s_dstart[d];  // bases up to 2^31
  }
  __syncthreads();

  // exchange and store, one plane at a time through s_buf: consecutive
  // threads store consecutive slots
  for (int q = 0; q < p.n; ++q) {
    if (q > 0 || !lookback) {  // s_buf does not hold plane q yet
#pragma unroll
      for (int r = 0; r < ITEMS; ++r)
        if (slot[r] >= 0) s_buf[slot[r]] = val[r];
      if (q + 1 < p.n) prefetch(q + 1);
      __syncthreads();
    }
    uint32_t* dst = p.out[q];
#pragma unroll 4
    for (int s = tid; s < valid_n; s += threads)
      dst[s_goff[s_dig[s]] + s] = s_buf[s];
    __syncthreads();
  }
}

template <int ITEMS>
cudaError_t launch(const uint32_t* keys, const Planes& p, int64_t n,
                   int shift, int nb, const uint32_t* gbase,
                   unsigned long long* status, bool lookback, int threads,
                   int64_t n_tiles, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage_onesweep<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  stage_onesweep<ITEMS><<<(unsigned)n_tiles, threads, smem, s>>>(
      keys, p, n, shift, nb, gbase, status, lookback);
  return cudaGetLastError();
}

// launch<ITEMS> for the one of the built ITEMS (RS_STAGE_ITEMS, config.py's
// STAGE_ITEMS) that equals items; cudaErrorInvalidValue for any other.
template <int... ITEMS, typename... Args>
cudaError_t launch_items(int items, Args... args) {
  cudaError_t err = cudaErrorInvalidValue;
  ((items == ITEMS ? (err = launch<ITEMS>(args...), 0) : 0), ...);
  return err;
}

}  // namespace

// in_planes / out_planes: host arrays of n_planes device pointers (u32, n
// each); plane 0 holds the keys. gbase: 2^width u32 exclusive bucket
// bases (up to 2^31: n <= 2^31). status: 1 + n_tiles * 2^width 64-bit words of scratch, zeroed here
// (one memset per pass). threads: a multiple of 32 up to
// RS_MAX_STAGE_THREADS; items: keys per thread, one of RS_STAGE_ITEMS.
// smem: a block's dynamic shared memory, bytes
// (kernels/stage.py::stage_smem_bytes).
extern "C" int rs_partition_stage(const void* in_planes, const void* out_planes,
                                  int n_planes, const void* gbase, int64_t n,
                                  int shift, int width, void* status,
                                  int threads, int items, int64_t smem,
                                  void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || n_planes < 1 ||
      (width != 2 && width != 4 && width != 8) || smem < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const void* const* ins = (const void* const*)in_planes;
  void* const* outs = (void* const*)out_planes;
  const int nb = 1 << width;
  const int64_t tile = (int64_t)threads * items;
  const int64_t n_tiles = (n + tile - 1) / tile;
  const uint32_t* keys = (const uint32_t*)ins[0];
  unsigned long long* st = (unsigned long long*)status;

  cudaError_t err = cudaMemsetAsync(
      st, 0, (size_t)(1 + n_tiles * nb) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  for (int g = 0; g < n_planes; g += kMaxPlanes) {
    Planes p;
    p.n = n_planes - g < kMaxPlanes ? n_planes - g : kMaxPlanes;
    for (int q = 0; q < kMaxPlanes; ++q) {
      p.in[q] = q < p.n ? (const uint32_t*)ins[g + q] : nullptr;
      p.out[q] = q < p.n ? (uint32_t*)outs[g + q] : nullptr;
    }
    const bool first = g == 0;
    err = launch_items<RS_STAGE_ITEMS>(items, keys, p, n, shift, nb,
                                       (const uint32_t*)gbase, st, first,
                                       threads, n_tiles, (size_t)smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
