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
// digit per tile (reset with one memset per pass). The extra planes of a
// pass move at about their byte bound; what a pass spends beyond that is
// work done once per key, whatever the bytes: the rank, the scans, the
// lookback and the barriers (PERF.md splits a block's time by phase).
//
// Design: a onesweep pass (CUB's agent_radix_sort_onesweep.cuh with its
// early-counts rank, block_radix_rank.cuh's BlockRadixRankMatchEarlyCounts:
// the function, not the code): one launch per group of up to 8 planes.
//   1. Tile claim: a block takes its tile index from an atomic counter, so
//      tiles run in claim order and a lookback only waits on tiles whose
//      blocks are already running.
//   2. Count: each warp loads its 32 * ITEMS keys once (coalesced rounds of
//      32) into registers and adds each key to its digit in the warp's row
//      of counts with one shared atomic. The compiler aggregates a warp's
//      increments of one address (ATOMS.POPC.INC), so a digit that most
//      keys share (78% in CCCL's entropy-0.201 keys) costs no more: the
//      counters need no splitting into parts.
//   3. Publish early: per digit, a scan over the warps' rows gives the
//      tile's count, published at once, before any key is ranked, in a
//      64-bit status word per (tile, digit) (two flag bits and a 62-bit
//      count): INCLUSIVE for tile 0, else PARTIAL. A scan over digits then
//      turns each warp's row into the slot of its first key of each digit
//      in the digit-sorted tile.
//   4. Rank: in each round eight ballots (one per digit bit) give each lane
//      the mask of the lanes that share its digit, ANDed with a ballot of
//      the lanes inside the tile on the last tile; the mask's highest lane
//      takes the peers' slots from the warp's entry of the digit with one
//      shared atomic and shuffles the first to them; a key's slot is that
//      plus the peers in lower lanes. No match instruction, no warp barrier
//      and no fix-up after. Order is warps, then rounds, then lanes: index
//      order, so the pass is stable. The keys and the slots' digits go to
//      shared memory as they are ranked. Whole tiles (all but the last) run
//      the count and the rank without bounds checks.
//   5. Decoupled lookback, after the rank and after the next plane's values
//      are loaded ahead: per digit, the thread that published it walks back
//      over earlier tiles, kWindow at a time, adding counts until an
//      INCLUSIVE word, publishes its own INCLUSIVE prefix and adds
//      gbase[d]. Offsets are int64. Each word carries all it tells and the
//      same thread stored the PARTIAL word before, so no fence is needed.
//      The whole rank lies between a tile's publish and its walk, so the
//      tiles claimed just before it have published when it looks.
//   6. Exchange: after a barrier consecutive threads read consecutive
//      slots and store slot s of digit d at offset[d] + (s - tile_start[d]),
//      so each bucket run is written by contiguous lanes in whole sectors;
//      one plane at a time through one reused buffer, the next plane's
//      values loaded ahead of each store.
// Planes beyond the first 8 run in further launches that rank the same keys
// again and read each tile's INCLUSIVE words, which the first launch left;
// they do not look back.
//
// 8-byte columns (a 64-bit key, an 8-byte payload) come as one plane of the
// launch each: the PAIRED instantiation loads each row's 8 bytes as one
// word, exchanges them through 8-byte slots and stores one 8-byte word a
// slot, so every output sector is written whole. The rank reads the key's
// half at element stride 2 (the sectors the column's exchange reads again,
// from L2). A thread holds the words of half its rows at a time, in the
// registers that hold a u32 plane: the first half is loaded ahead, the
// second as the first is exchanged. Launches of u32 planes only run the
// other instantiation: no stride, no wider registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "rs_limits.h"  // config.py's limits, written by utils/build.py

namespace {

constexpr int kMaxPlanes = 8;
constexpr int kMaxThreads = RS_MAX_STAGE_THREADS;
constexpr int kWindow = 8;  // status words a lookback step loads at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPartial = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

// in / out: a plane's first u32, or for an 8-byte column (bit q of wide,
// PAIRED only) the column's first 8-byte word.
struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
  int n;
  unsigned wide;
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

// The lanes whose digit equals this lane's d: one ballot per bit, each
// ANDed in as is or inverted (as CUB's MatchAny; __match_any_sync is slower
// on a few bits). Bits at and above the pass's width are 0 in every lane,
// so their ballots change nothing. The warp must be converged.
__device__ __forceinline__ unsigned match_digit(uint32_t d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    unsigned same;
    asm("{\n\t.reg .pred p;\n\t"
        "and.b32 %0, %1, %2;\n\t"
        "setp.ne.u32 p, %0, 0;\n\t"
        "vote.ballot.sync.b32 %0, p, 0xffffffff;\n\t"
        "@!p not.b32 %0, %0;\n\t}"
        : "=r"(same)
        : "r"(d), "r"(1u << b));
    peers &= same;
  }
  return peers;
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
// from the INCLUSIVE words the first launch left. PAIRED: the keys are
// keys[i * key_stride] (2 where plane 0 is an 8-byte column, keys then
// pointing at the key's half of its first word); unused otherwise.
template <int ITEMS, bool PAIRED>
__global__ void __launch_bounds__(kMaxThreads, ITEMS <= 16 ? 2 : 1)
    stage_onesweep(const uint32_t* __restrict__ keys, Planes p, int64_t n,
                   int shift, int nb, const uint32_t* __restrict__ gbase,
                   unsigned long long* status, bool lookback,
                   int key_stride) {
  // the caller sizes shared memory (kernels/stage.py::stage_smem_bytes)
  extern __shared__ unsigned long long smem[];
  const int threads = blockDim.x, warps = threads >> 5;
  const int tile_elems = threads * ITEMS;
  int64_t* s_goff = (int64_t*)smem;                        // [nb]
  long long* s_scan = (long long*)(s_goff + nb);           // [32]
  uint32_t* s_buf = (uint32_t*)(s_scan + 32);              // [tile] slots
  unsigned long long* s_buf64 = (unsigned long long*)s_buf;
  int* s_wc = (int*)(s_buf + (PAIRED ? 2 : 1) * tile_elems);  // [warps][nb]
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
  // this thread's run of digits [lo, hi): it publishes their counts, scans
  // them and looks back for them
  const int per = (nb + threads - 1) / threads;
  const int lo = tid * per < nb ? tid * per : nb;
  const int hi = lo + per < nb ? lo + per : nb;

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
    if constexpr (PAIRED)
      key[r] = i < valid_n ? keys[(start + i) * key_stride] : 0u;
    else
      key[r] = i < valid_n ? keys[start + i] : 0u;
  }

  // count: one shared atomic a key into the warp's row (the compiler
  // aggregates a warp's increments of one address, so a digit most keys
  // share costs no more). Whole tiles, all but the last, skip the bounds.
  int* mine = s_wc + warp * nb;
  const bool whole = valid_n == tile_elems;
  auto count = [&](auto whole_tile) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
      if (decltype(whole_tile)::value || wbase + r * 32 + lane < valid_n)
        atomicAdd(&mine[(key[r] >> shift) & mask], 1);
  };
  if (whole) count(std::true_type{});
  else count(std::false_type{});
  __syncthreads();

  // per digit (a thread's run of digits): the tile's count, published at
  // once (INCLUSIVE for tile 0, else PARTIAL), and each warp's count before
  // it; then a scan over digits makes each warp's entry the slot of its
  // first key of that digit
  {
    long long sum = 0;
    for (int d = lo; d < hi; ++d) {
      int run = 0;
      for (int w = 0; w < warps; ++w) {
        const int c = s_wc[w * nb + d];
        s_wc[w * nb + d] = run;
        run += c;
      }
      s_cnt[d] = run;
      if (lookback)
        store_status(&tiles[t * nb + d],
                     (t == 0 ? kInclusive : kPartial) | (unsigned)run);
      sum += run;
    }
    long long run = block_inclusive_scan(sum, s_scan) - sum;
    for (int d = lo; d < hi; ++d) {
      s_dstart[d] = (int)run;
      for (int w = 0; w < warps; ++w) s_wc[w * nb + d] += (int)run;
      run += s_cnt[d];
    }
  }
  __syncthreads();

  // rank: in each round the peers' highest lane takes their slots from the
  // warp's entry of the digit with one shared atomic and hands the first
  // to them; the keys (plane 0 of the first group, unless it is an 8-byte
  // column) and every slot's digit go to shared memory now
  const bool keys_held = lookback && !(PAIRED && (p.wide & 1u));
  int slot[ITEMS];
  auto rank = [&](auto whole_tile) {
    constexpr bool kWhole = decltype(whole_tile)::value;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const bool valid = kWhole || wbase + r * 32 + lane < valid_n;
      const uint32_t d = (key[r] >> shift) & mask;
      unsigned peers = match_digit(d);
      if (!kWhole) peers &= __ballot_sync(kFull, valid);
      const int leader = 31 - __clz(peers);
      int first = 0;
      if (valid && lane == leader) first = atomicAdd(&mine[d], __popc(peers));
      first = __shfl_sync(kFull, first, leader);
      slot[r] = valid ? first + __popc(peers & lt) : -1;
      if (valid) {
        if (keys_held) s_buf[slot[r]] = key[r];
        s_dig[slot[r]] = (uint8_t)d;
      }
    }
  };
  if (whole) rank(std::true_type{});
  else rank(std::false_type{});
  // the next plane's values, loaded ahead of the lookback and of each
  // store so that their latency overlaps them (an 8-byte column: the words
  // of rounds [0, ITEMS / 2), two registers each)
  uint32_t val[ITEMS];
  auto row = [&](int r) { return start + wbase + r * 32 + lane; };
  auto prefetch = [&](int q) {
    if (PAIRED && ((p.wide >> q) & 1u)) {
      const unsigned long long* src = (const unsigned long long*)p.in[q];
#pragma unroll
      for (int r = 0; r < ITEMS / 2; ++r) {
        if (slot[r] < 0) continue;
        const unsigned long long w = src[row(r)];
        val[2 * r] = (uint32_t)w;
        val[2 * r + 1] = (uint32_t)(w >> 32);
      }
      return;
    }
#pragma unroll
    for (int r = 0; r < ITEMS; ++r)
      if (slot[r] >= 0) val[r] = p.in[q][row(r)];
  };
  if (!keys_held) prefetch(0);
  else if (p.n > 1) prefetch(1);

  // the tile's global offset per digit, for the digits whose counts this
  // thread published: the INCLUSIVE word follows the PARTIAL one in its
  // program order, so no fence is needed (a word carries all it tells)
  for (int d = lo; d < hi; ++d) {
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
      if (t > 0)
        store_status(&tiles[t * nb + d],
                     kInclusive | (unsigned long long)(excl + s_cnt[d]));
    } else {
      excl = (long long)(load_status(&tiles[t * nb + d]) & kValue) - s_cnt[d];
    }
    s_goff[d] = (int64_t)gbase[d] + excl - s_dstart[d];  // bases up to 2^31
  }
  __syncthreads();

  // exchange and store, one plane at a time through s_buf: consecutive
  // threads store consecutive slots (an 8-byte column: one word a slot)
  for (int q = 0; q < p.n; ++q) {
    const bool wide = PAIRED && ((p.wide >> q) & 1u);
    if (q > 0 || !keys_held) {  // s_buf does not hold plane q yet
      if (wide) {
        const unsigned long long* src = (const unsigned long long*)p.in[q];
#pragma unroll
        for (int r = 0; r < ITEMS / 2; ++r)
          if (slot[r] >= 0)
            s_buf64[slot[r]] =
                val[2 * r] | (unsigned long long)val[2 * r + 1] << 32;
#pragma unroll
        for (int r = ITEMS / 2; r < ITEMS; ++r)
          if (slot[r] >= 0) s_buf64[slot[r]] = src[row(r)];
      } else {
#pragma unroll
        for (int r = 0; r < ITEMS; ++r)
          if (slot[r] >= 0) s_buf[slot[r]] = val[r];
      }
      if (q + 1 < p.n) prefetch(q + 1);
      __syncthreads();
    }
    if (wide) {
      unsigned long long* dst = (unsigned long long*)p.out[q];
#pragma unroll 4
      for (int s = tid; s < valid_n; s += threads)
        dst[s_goff[s_dig[s]] + s] = s_buf64[s];
    } else {
      uint32_t* dst = p.out[q];
#pragma unroll 4
      for (int s = tid; s < valid_n; s += threads)
        dst[s_goff[s_dig[s]] + s] = s_buf[s];
    }
    __syncthreads();
  }
}

template <int ITEMS, bool PAIRED>
cudaError_t launch(const uint32_t* keys, const Planes& p, int64_t n,
                   int shift, int nb, const uint32_t* gbase,
                   unsigned long long* status, bool lookback, int key_stride,
                   int threads, int64_t n_tiles, size_t smem,
                   cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage_onesweep<ITEMS, PAIRED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  stage_onesweep<ITEMS, PAIRED><<<(unsigned)n_tiles, threads, smem, s>>>(
      keys, p, n, shift, nb, gbase, status, lookback, key_stride);
  return cudaGetLastError();
}

// launch<ITEMS, paired> for the one of the built ITEMS (RS_STAGE_ITEMS,
// config.py's STAGE_ITEMS) that equals items; cudaErrorInvalidValue for any
// other.
template <int... ITEMS, typename... Args>
cudaError_t launch_items(int items, bool paired, Args... args) {
  cudaError_t err = cudaErrorInvalidValue;
  ((items == ITEMS ? (err = paired ? launch<ITEMS, true>(args...)
                                   : launch<ITEMS, false>(args...), 0) : 0),
   ...);
  return err;
}

}  // namespace

// in_planes / out_planes: host arrays of n_planes device pointers; plane 0
// holds the keys. wide: host array of n_planes ints, 1 for an 8-byte column
// (both u32 halves of n 8-byte words; the pointers 8-byte aligned), 0 for a
// u32 plane (n words). key_half: which half of plane 0 holds the keys where
// it is an 8-byte column (0 the low, 1 the high word), else -1. A pass with
// any 8-byte column runs the PAIRED instantiation. gbase: 2^width u32
// exclusive bucket bases (up to 2^31: n <= 2^31). status: 1 + n_tiles *
// 2^width 64-bit words of scratch, zeroed here (one memset per pass).
// threads: a multiple of 32 up to RS_MAX_STAGE_THREADS; items: keys per
// thread, one of RS_STAGE_ITEMS. smem: a block's dynamic shared memory,
// bytes (kernels/stage.py::stage_smem_bytes, with 8-byte slots where the
// pass has an 8-byte column).
extern "C" int rs_partition_stage(const void* in_planes, const void* out_planes,
                                  const void* wide, int n_planes, int key_half,
                                  const void* gbase, int64_t n, int shift,
                                  int width, void* status, int threads,
                                  int items, int64_t smem, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || n_planes < 1 ||
      (width != 2 && width != 4 && width != 8) || smem < 1 ||
      key_half < -1 || key_half > 1)
    return (int)cudaErrorInvalidValue;
  const int* wd = (const int*)wide;
  bool paired = false;
  for (int q = 0; q < n_planes; ++q) paired = paired || wd[q] != 0;
  if ((key_half >= 0) != (wd[0] != 0)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const void* const* ins = (const void* const*)in_planes;
  void* const* outs = (void* const*)out_planes;
  const int nb = 1 << width;
  const int64_t tile = (int64_t)threads * items;
  const int64_t n_tiles = (n + tile - 1) / tile;
  // the keys: plane 0, or its key_half-th word of each 8-byte row
  const uint32_t* keys = (const uint32_t*)ins[0] + (key_half > 0 ? 1 : 0);
  const int key_stride = key_half >= 0 ? 2 : 1;
  unsigned long long* st = (unsigned long long*)status;

  cudaError_t err = cudaMemsetAsync(
      st, 0, (size_t)(1 + n_tiles * nb) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  for (int g = 0; g < n_planes; g += kMaxPlanes) {
    Planes p;
    p.n = n_planes - g < kMaxPlanes ? n_planes - g : kMaxPlanes;
    p.wide = 0;
    for (int q = 0; q < kMaxPlanes; ++q) {
      p.in[q] = q < p.n ? (const uint32_t*)ins[g + q] : nullptr;
      p.out[q] = q < p.n ? (uint32_t*)outs[g + q] : nullptr;
      if (q < p.n && wd[g + q]) p.wide |= 1u << q;
    }
    const bool first = g == 0;
    err = launch_items<RS_STAGE_ITEMS>(items, paired, keys, p, n, shift, nb,
                                       (const uint32_t*)gbase, st, first,
                                       key_stride, threads, n_tiles,
                                       (size_t)smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
