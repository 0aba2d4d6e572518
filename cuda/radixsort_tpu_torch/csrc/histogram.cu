// All-digit histogram of u32 keys: one read yields the histogram of every
// `width`-bit digit position.
//
// Replaces: cuda/radixsort_tpu/kernels/histogram.py, digit_histograms
// (body _hist_kernel), the onesweep-histogram idea of CUB
// agent/agent_radix_sort_histogram.cuh.
//
// Bound on this card: device-memory reads. The kernel reads 4 B per key once
// and writes n_stages * 2^width counters; at 3.35 TB/s a 2^24-key read is
// about 20 us. Against that, every key costs n_stages shared-memory atomics.
// Design: a grid-stride loop (a few blocks per SM) counts into shared memory
// privatised per warp, which spreads the atomics of skewed inputs over one
// table per warp; each block then folds its warps' tables and adds them to
// the output with one global atomicAdd per non-zero bin. Integer atomics make
// the result exact in any order. The output must be zeroed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void hist_kernel(const uint32_t* __restrict__ keys, int64_t n,
                            int n_stages, int width, int* __restrict__ out) {
  extern __shared__ int s_hist[];  // [warps][n_stages << width]
  const int nb = 1 << width;
  const int per = n_stages * nb;
  const int warps = blockDim.x >> 5;
  for (int j = threadIdx.x; j < warps * per; j += blockDim.x) s_hist[j] = 0;
  __syncthreads();

  int* mine = s_hist + (threadIdx.x >> 5) * per;
  const uint32_t mask = nb - 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t k = keys[i];
    for (int s = 0; s < n_stages; ++s)
      atomicAdd(&mine[s * nb + ((k >> (s * width)) & mask)], 1);
  }
  __syncthreads();

  for (int j = threadIdx.x; j < per; j += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += s_hist[w * per + j];
    if (sum) atomicAdd(&out[j], sum);
  }
}

}  // namespace

extern "C" const char* rs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keys: n u32 on the device; out: n_stages * 2^width zeroed int32.
// Requires n_stages * width <= 32 (checked by the Python wrapper).
extern "C" int rs_digit_histograms(const void* keys, int64_t n, int n_stages,
                                   int width, void* out, int grid, int threads,
                                   void* stream) {
  if (n == 0) return 0;
  const size_t smem = (size_t)(threads / 32) * n_stages * (1 << width) * sizeof(int);
  hist_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, n, n_stages, width, (int*)out);
  return (int)cudaGetLastError();
}
