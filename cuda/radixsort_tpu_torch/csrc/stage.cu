// One stable LSD counting pass over u32 planes, by the digit
// (key >> shift) & (2^width - 1) of plane 0; every other plane follows the
// same permutation.
//
// Replaces: cuda/radixsort_tpu/kernels/stage.py, partition_stage (body
// _stage_kernel, with the in-tile rank of kernels/tiles.py). The TPU kernel's
// VMEM carries, MXU byte-plane router and 32-row DMA flushes are not carried
// over: they exist because that VPU has no scatter.
//
// Bound on this card: device memory. A pass reads and writes 4 B per plane
// per key, reads the key plane a second time (mostly from L2: a tile is
// 16 KB) and moves a spine of 12 B per digit per tile. The direct scatter
// writes each lane's value to its own bucket run, so stores coalesce only
// as far as neighbouring lanes share a digit; that, not the reads, is the
// expected limit of this first version (a shared-memory exchange before the
// store, or a decoupled-lookback onesweep, is later work).
//
// Design: the reference's upsweep / scan / downsweep trio, three launches:
//   1. stage_count: one block per tile counts its digits in shared memory
//      and writes them digit-major (the striped spine, spine[d * T + t]).
//   2. stage_scan: one block per digit takes the exclusive scan over tiles
//      and adds the global bucket base gbase[d]: offsets[d * T + t], int64.
//   3. stage_scatter: one block per tile. Each warp owns a contiguous
//      sub-range of the tile and walks it in rounds of 32 keys. In a round,
//      __match_any_sync groups the lanes of equal digit and
//      popc(peers & lanemask_lt) is a lane's rank among them, so the rank is
//      stable: warps in index order, rounds in index order, lanes in index
//      order. A first walk counts each warp's digits; an exclusive scan over
//      warps plus the tile's offset gives each warp's base per digit; a
//      second walk scatters every plane to base + rank. No element is placed
//      through a global atomic cursor, and the ragged last tile is masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
  int n;
};

__global__ void stage_count(const uint32_t* __restrict__ keys, int64_t n,
                            int shift, int nb, int64_t tile, int64_t n_tiles,
                            int* __restrict__ counts) {
  extern __shared__ int s_cnt[];  // [nb]
  for (int d = threadIdx.x; d < nb; d += blockDim.x) s_cnt[d] = 0;
  __syncthreads();
  const int64_t start = (int64_t)blockIdx.x * tile;
  const int64_t end = min64(start + tile, n);
  const uint32_t mask = nb - 1;
  for (int64_t i = start + threadIdx.x; i < end; i += blockDim.x)
    atomicAdd(&s_cnt[(keys[i] >> shift) & mask], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < nb; d += blockDim.x)
    counts[(int64_t)d * n_tiles + blockIdx.x] = s_cnt[d];
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

__global__ void stage_scan(const int* __restrict__ counts,
                           const int* __restrict__ gbase, int64_t n_tiles,
                           int64_t* __restrict__ offsets) {
  __shared__ long long s_warp[32];
  const int d = blockIdx.x;
  const int* c = counts + (int64_t)d * n_tiles;
  int64_t* o = offsets + (int64_t)d * n_tiles;
  // each thread owns a contiguous run of tiles
  const int64_t per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int64_t lo = min64(per * threadIdx.x, n_tiles);
  const int64_t hi = min64(lo + per, n_tiles);
  long long sum = 0;
  for (int64_t t = lo; t < hi; ++t) sum += c[t];
  int64_t run = (int64_t)gbase[d] + block_inclusive_scan(sum, s_warp) - sum;
  for (int64_t t = lo; t < hi; ++t) {
    o[t] = run;
    run += c[t];
  }
}

__global__ void stage_scatter(const uint32_t* __restrict__ keys, Planes p,
                              int64_t n, int shift, int nb, int items,
                              int64_t n_tiles,
                              const int64_t* __restrict__ offsets) {
  extern __shared__ int64_t s_base[];  // [warps][nb]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const uint32_t mask = nb - 1;
  const int64_t wstart = (int64_t)blockIdx.x * blockDim.x * items +
                         (int64_t)warp * 32 * items;
  int64_t* mine = s_base + warp * nb;

  for (int j = threadIdx.x; j < warps * nb; j += blockDim.x) s_base[j] = 0;
  __syncthreads();

  // walk 1: this warp's digit counts (one leader per digit per round)
  for (int r = 0; r < items; ++r) {
    const int64_t base = wstart + (int64_t)r * 32;
    if (base >= n) break;  // warp-uniform
    const int64_t i = base + lane;
    const bool valid = i < n;
    const int d = valid ? (int)((keys[i] >> shift) & mask) : nb;
    const unsigned peers = __match_any_sync(kFull, d);
    if (valid && (peers & lt) == 0) mine[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // exclusive scan over warps per digit, from the tile's global offset
  for (int d = threadIdx.x; d < nb; d += blockDim.x) {
    int64_t run = offsets[(int64_t)d * n_tiles + blockIdx.x];
    for (int w = 0; w < warps; ++w) {
      const int64_t c = s_base[w * nb + d];
      s_base[w * nb + d] = run;
      run += c;
    }
  }
  __syncthreads();

  // walk 2: stable rank within the round, scatter every plane
  for (int r = 0; r < items; ++r) {
    const int64_t base = wstart + (int64_t)r * 32;
    if (base >= n) break;
    const int64_t i = base + lane;
    const bool valid = i < n;
    const int d = valid ? (int)((keys[i] >> shift) & mask) : nb;
    const unsigned peers = __match_any_sync(kFull, d);
    if (valid) {
      const int64_t pos = mine[d] + __popc(peers & lt);
#pragma unroll
      for (int q = 0; q < kMaxPlanes; ++q)
        if (q < p.n) p.out[q][pos] = p.in[q][i];
    }
    __syncwarp();
    if (valid && (peers & lt) == 0) mine[d] += __popc(peers);
    __syncwarp();
  }
}

}  // namespace

// in_planes / out_planes: host arrays of n_planes device pointers (u32, n
// each); plane 0 holds the keys. gbase: 2^width int32 exclusive bucket
// bases. counts: int32 and offsets: int64 scratch of 2^width * n_tiles
// each. Planes beyond 8 run in further scatter launches that read the same
// key plane, so every group lands in the same order.
extern "C" int rs_partition_stage(const void* in_planes, const void* out_planes,
                                  int n_planes, const void* gbase, int64_t n,
                                  int shift, int width, void* counts,
                                  void* offsets, int threads, int items,
                                  void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const void* const* ins = (const void* const*)in_planes;
  void* const* outs = (void* const*)out_planes;
  const int nb = 1 << width;
  const int64_t tile = (int64_t)threads * items;
  const int64_t n_tiles = (n + tile - 1) / tile;
  const uint32_t* keys = (const uint32_t*)ins[0];

  stage_count<<<(unsigned)n_tiles, threads, nb * sizeof(int), s>>>(
      keys, n, shift, nb, tile, n_tiles, (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  stage_scan<<<nb, kScanThreads, 0, s>>>((const int*)counts,
                                         (const int*)gbase, n_tiles,
                                         (int64_t*)offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = (size_t)(threads / 32) * nb * sizeof(int64_t);
  for (int g = 0; g < n_planes; g += kMaxPlanes) {
    Planes p;
    p.n = n_planes - g < kMaxPlanes ? n_planes - g : kMaxPlanes;
    for (int q = 0; q < kMaxPlanes; ++q) {
      p.in[q] = q < p.n ? (const uint32_t*)ins[g + q] : nullptr;
      p.out[q] = q < p.n ? (uint32_t*)outs[g + q] : nullptr;
    }
    stage_scatter<<<(unsigned)n_tiles, threads, smem, s>>>(
        keys, p, n, shift, nb, items, n_tiles, (const int64_t*)offsets);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
