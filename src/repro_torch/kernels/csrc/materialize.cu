// materialize.cu — the mask-selected records of some attributes, decoded
// from their bit planes and compacted in record order, in one pass (two
// on the largest relations).
//
// Replaces the Pallas TPU kernel repro/kernels/materialize.py:109
// (materialize_pallas, body _materialize_kernel): bit plane b of word w,
// lane l is bit b of record w*32+l; the selected records' values come out
// as int32, the first `count` columns of each attribute's row, in record
// order (the stable compaction of the reference's _compact). The Pallas
// kernel compacts per tile and stitches the tiles with a searchsorted
// gather, relying on its grid running in order; Hopper blocks run in no
// order.
//
// Bound on an H100 SXM: bytes. The planes and the mask are read once and
// `count` values per attribute written once, at 3.35 TB/s. Three things
// kept the first port (count kernel, torch.cumsum, scatter kernel) far
// from it: a fixed cost of three or more launches per call, a decode of
// all 32 bit positions per selected value (~3 integer ops each, whatever
// the width), and a static 32 KB staging row per block.
//
// Design.
//  * One pass on the card where a call's tiles (kThreads mask words each)
//    all fit on the card at once, else two (the wrapper chooses by the
//    tile count).
//    materialize_lookback is a single-pass scan with decoupled look-back
//    (Merrill & Garland 2016): a block takes its tile from an atomic
//    ticket, not from blockIdx, so it only ever waits on tiles whose
//    blocks are already running (it loads tile blockIdx.x's mask word while
//    the ticket is in flight, and again only if the ticket differs). It
//    popcounts its words once, publishes its aggregate, and warp 0 looks
//    back over its predecessors' status words 32 at a time (adding
//    aggregates until it meets an inclusive prefix) and publishes its
//    inclusive prefix; the last tile writes `count`. The kernel leaves its
//    state as it found it, all zeros: each block counts itself done once
//    its look-back has read what it needs, and the block that counts last
//    zeroes the status words, the ticket and the done counter. So nothing
//    is cleared between calls and no call carries host state: calls on one
//    stream (from any thread, or a CUDA graph's replays) each start from
//    zeros. A look-back that polls for seconds, or a ticket past the last
//    tile, traps: a launch error, not a hang. The two-pass layout
//    (materialize_count, then materialize_scatter, whose blocks each sum
//    the earlier block counts themselves) won on lineitem at SF 1, two
//    waves of tiles, and lost on every one-wave relation, by a few us a
//    call each way (PERF.md).
//  * A decode bounded by the width and by the selection's density. Only
//    bits[a] plane words are loaded, and none where the mask word is 0;
//    the first attribute's loads are issued before the scan, so they
//    overlap it and the look-back. The decode is instantiated for widths
//    <= 8, <= 16 and <= 32 (planes past the bucket are compile-time zeros,
//    planes past 32 add nothing). Per warp, if its densest word has more
//    than kSparseMax selected lanes (8, the best of 0-32 in a study at
//    path b's 16 shapes on an H100, PERF.md), every thread
//    decodes all 32 values of its word at once with a register 32x32 bit
//    transpose (Hacker's Delight transpose32: 5 stages of masked swaps,
//    ~12 integer ops per value at 32 bits, fewer for the narrow buckets)
//    and writes only its selected lanes, in rank order, into the
//    warp's staging tile; else each thread walks its selected lanes
//    (__ffs) and decodes each from the bucket's planes (3 ops per plane),
//    storing straight to global memory, since a sparse warp's values fall
//    in one or two lines.
//  * Residency. A warp compacts into its own 32 x 33-word staging tile (4.1
//    KB; the pad column keeps both the rank-order writes of a dense warp
//    and the coalesced copy-out free of bank conflicts) and copies it to
//    its slice of the output row: 33 KB per 256-thread block, against the
//    first port's 32 KB row per block. Registers set residency: 80 a
//    thread (the 32-word transpose), 3 blocks (768 threads) per SM, which
//    __launch_bounds__ asks for; 2 blocks at 128 registers and 4 at 64
//    measured no faster.
// Values are decoded as uint32 and stored as their int32 bit pattern, so
// a 32-bit attribute wraps exactly as the reference's int32 << 31 does.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;           // mask words per tile, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;           // blocks per SM asked of ptxas
constexpr int kMaxAttrs = 32;           // attributes per launch
constexpr int kWordBits = 32;
constexpr int kStageWords = 32 * 33;    // a warp's padded staging tile
constexpr int kSparseMax = 8;           // densest word's lanes, sparse
constexpr unsigned kFull = 0xffffffffu;

// Status word of a tile: flag << 32 | value (uint32); 0: not published.
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr unsigned long long kFlags = 3ull << 32;
constexpr int kMaxPolls = 1 << 22;      // seconds of polling, never reached

// The look-back's state, all zero between launches: 8-byte words, the
// first holding the ticket counter (its low half) and the done counter
// (its high half), then one status word per tile.

struct Attrs {
  const uint32_t* planes[kMaxAttrs];    // (bits[a], n_words) each
  int bits[kMaxAttrs];                  // planes decoded: <= 32
  int n;
};

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// Warp 0 of tile `tile` > 0: the sum of every earlier tile's count, read
// from their status words (tiles before 0 count as an inclusive 0).
__device__ unsigned look_back(const unsigned long long* status, int tile) {
  const int lane = threadIdx.x & 31;
  unsigned excl = 0;
  for (int end = tile;; end -= 32) {
    const int t = end - 1 - lane;
    unsigned long long s;
    bool ready;
    int polls = 0;
    do {
      // A predecessor publishes its aggregate before it waits on anything,
      // so this ends; if the state were ever corrupted, trap (a launch
      // error) rather than spin forever.
      if (++polls > kMaxPolls) __trap();
      s = t >= 0 ? load_status(status + t) : kInclusive;
      ready = (s & kFlags) != 0;
    } while (!__all_sync(kFull, ready));
    const unsigned incl = __ballot_sync(kFull, (s & kFlags) == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    excl += __reduce_add_sync(kFull, lane <= stop ? (unsigned)s : 0u);
    if (incl) return excl;
  }
}

// 32x32 bit transpose in registers: on entry x[b] bit l is bit b of
// record l; on return x[l] bit b is. Rows >= NB are zero on entry and the
// compiler folds them away.
template <int NB>
__device__ __forceinline__ void transpose32(uint32_t (&x)[kWordBits]) {
  uint32_t m = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j; j >>= 1, m ^= m << j) {
#pragma unroll
    for (int k = 0; k < kWordBits; ++k) {
      if (k & j) continue;
      const uint32_t t = ((x[k] >> j) ^ x[k + j]) & m;
      x[k + j] ^= t;
      x[k] ^= t << j;
    }
  }
}

// This thread's plane words of one attribute (width nb <= NB): none where
// its mask word is 0.
template <int NB>
__device__ __forceinline__ void load_planes(
    uint32_t (&x)[kWordBits], const uint32_t* __restrict__ planes, int nb,
    long long n_words, long long w, uint32_t m) {
#pragma unroll
  for (int b = 0; b < kWordBits; ++b)
    x[b] = (b < NB && b < nb && m) ? __ldg(planes + (long long)b * n_words
                                           + w) : 0u;
}

__device__ __forceinline__ void load_attr(
    uint32_t (&x)[kWordBits], const Attrs& attrs, int a, long long n_words,
    long long w, uint32_t m) {
  const int nb = attrs.bits[a];
  if (nb <= 8)
    load_planes<8>(x, attrs.planes[a], nb, n_words, w, m);
  else if (nb <= 16)
    load_planes<16>(x, attrs.planes[a], nb, n_words, w, m);
  else
    load_planes<32>(x, attrs.planes[a], nb, n_words, w, m);
}

// One attribute's selected values of this thread's word, from its planes
// `in` (rows >= NB ignored): `row` points at the warp's first output slot,
// `rank` is this word's first selected record among the warp's, `n_warp`
// the warp's selected records.
template <int NB>
__device__ __forceinline__ void decode_attr(
    const uint32_t (&in)[kWordBits], uint32_t m, bool dense, int rank,
    int n_warp, uint32_t* stage, int* __restrict__ row) {
  uint32_t x[kWordBits];
#pragma unroll
  for (int b = 0; b < kWordBits; ++b) x[b] = b < NB ? in[b] : 0u;
  const int lane = threadIdx.x & 31;
  if (dense) {
    transpose32<NB>(x);
    int r = rank;
#pragma unroll
    for (int l = 0; l < kWordBits; ++l) {
      if ((m >> l) & 1u) {
        stage[r + (r >> 5)] = x[l];
        ++r;
      }
    }
    __syncwarp();
    for (int i = lane; i < n_warp; i += 32) row[i] = (int)stage[i + (i >> 5)];
    __syncwarp();
  } else {
    int* dst = row + rank;
    for (uint32_t left = m; left; left &= left - 1u) {
      const int l = __ffs(left) - 1;
      uint32_t v = 0u;
#pragma unroll
      for (int b = 0; b < NB; ++b) v |= ((x[b] >> l) & 1u) << b;
      *dst++ = (int)v;
    }
  }
}

// The body both layouts share, over a tile of kThreads mask words, one per
// thread. kLookBack: the tile comes from the ticket and its base from the
// look-back over `state`; else the tile is blockIdx.x and its base the
// sum of the block counts before it (`counts`, from materialize_count).
// The first attribute's plane loads are issued before the scan, so their
// latency overlaps the scan and the look-back.
template <bool kLookBack>
__device__ __forceinline__ void materialize_tile(
    const Attrs& attrs, const uint32_t* __restrict__ mask, long long n_words,
    int* __restrict__ out, long long cap, int* __restrict__ count,
    unsigned long long* state, const int* __restrict__ counts,
    int n_tiles) {
  __shared__ uint32_t stage[kWarps][kStageWords];
  __shared__ int warp_part[kWarps];     // warp's count, then its offset
  __shared__ unsigned warp_before[kWarps];
  __shared__ int s_tile;
  __shared__ unsigned s_base;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned* const ticket = reinterpret_cast<unsigned*>(state);
  unsigned* const done = ticket + 1;
  unsigned long long* const status = state + 1;

  int tile = blockIdx.x;
  long long w = (long long)tile * kThreads + t;
  uint32_t m = w < n_words ? __ldg(mask + w) : 0u;
  if (kLookBack) {
    // Blocks mostly start in blockIdx order, so the mask word of tile
    // blockIdx.x is loaded while the ticket is taken, and again only if
    // the ticket differs.
    if (t == 0) s_tile = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    if (s_tile != tile) {
      tile = s_tile;
      if ((unsigned)tile >= (unsigned)n_tiles) __trap();  // state corrupted
      w = (long long)tile * kThreads + t;
      m = w < n_words ? __ldg(mask + w) : 0u;
    }
  }
  uint32_t x[kWordBits];
  if (attrs.n) load_attr(x, attrs, 0, n_words, w, m);
  const int pc = __popc(m);

  int incl = pc;                        // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  const int n_warp = __shfl_sync(kFull, incl, 31);
  const bool dense = (int)__reduce_max_sync(kFull, (unsigned)pc) >
                     kSparseMax;
  if (lane == 31) warp_part[warp] = incl;
  if (!kLookBack) {                     // the counts of the earlier tiles
    unsigned before = 0;
    for (int i = t; i < tile; i += kThreads) before += (unsigned)counts[i];
    before = __reduce_add_sync(kFull, before);
    if (lane == 0) warp_before[warp] = before;
  }
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? warp_part[lane] : 0;
    int y = v;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const int z = __shfl_up_sync(kFull, y, off);
      if (lane >= off) y += z;
    }
    const unsigned total = (unsigned)__shfl_sync(kFull, y, kWarps - 1);
    __syncwarp();
    if (lane < kWarps) warp_part[lane] = y - v;
    unsigned excl;
    if (kLookBack) {
      if (lane == 0)
        store_status(status + tile, (tile ? kAggregate : kInclusive) | total);
      excl = tile ? look_back(status, tile) : 0u;
      // This block has read every status word it needs and published its
      // own; the block that counts itself done last (the fences order
      // every block's status stores before its count, and its count
      // before the zeroing) returns the state to zeros for the next call.
      unsigned last = 0u;
      if (lane == 0) {
        if (tile) store_status(status + tile, kInclusive | (excl + total));
        __threadfence();
        last = atomicAdd(done, 1u) == (unsigned)n_tiles - 1u;
      }
      if (__shfl_sync(kFull, last, 0)) {
        __threadfence();
        for (int i = lane; i < n_tiles; i += 32)
          store_status(status + i, 0ull);
        if (lane == 0) *ticket = *done = 0u;
      }
    } else {
      excl = __reduce_add_sync(kFull, lane < kWarps ? warp_before[lane]
                                                    : 0u);
    }
    if (lane == 0) {
      s_base = excl;
      if (tile == n_tiles - 1) *count = (int)(excl + total);
    }
  }
  __syncthreads();
  if (n_warp == 0) return;
  const long long base = (long long)s_base + warp_part[warp];
  const int rank = incl - pc;
  for (int a = 0; a < attrs.n; ++a) {
    if (a) load_attr(x, attrs, a, n_words, w, m);
    const int nb = attrs.bits[a];
    int* row = out + (long long)a * cap + base;
    if (nb <= 8)
      decode_attr<8>(x, m, dense, rank, n_warp, stage[warp], row);
    else if (nb <= 16)
      decode_attr<16>(x, m, dense, rank, n_warp, stage[warp], row);
    else
      decode_attr<32>(x, m, dense, rank, n_warp, stage[warp], row);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
materialize_lookback(Attrs attrs, const uint32_t* __restrict__ mask,
                     long long n_words, int* __restrict__ out, long long cap,
                     int* __restrict__ count, unsigned long long* state,
                     int n_tiles) {
  materialize_tile<true>(attrs, mask, n_words, out, cap, count, state,
                         nullptr, n_tiles);
}

__global__ void __launch_bounds__(kThreads)
materialize_count(const uint32_t* __restrict__ mask, long long n_words,
                  int* __restrict__ counts) {
  __shared__ int warp_tot[kWarps];
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int s = __reduce_add_sync(kFull, w < n_words ? __popc(mask[w]) : 0);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int v = threadIdx.x < kWarps ? warp_tot[threadIdx.x] : 0;
    const int total = __reduce_add_sync(kFull, v);
    if (threadIdx.x == 0) counts[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
materialize_scatter(Attrs attrs, const uint32_t* __restrict__ mask,
                    long long n_words, int* __restrict__ out, long long cap,
                    int* __restrict__ count, const int* __restrict__ counts,
                    int n_tiles) {
  materialize_tile<false>(attrs, mask, n_words, out, cap, count, nullptr,
                          counts, n_tiles);
}

static bool load_attrs(const void* const* planes, const int* bits,
                       int n_attrs, Attrs* attrs) {
  if (n_attrs < 0 || n_attrs > kMaxAttrs) return false;
  *attrs = Attrs{};
  attrs->n = n_attrs;
  for (int i = 0; i < n_attrs; ++i) {
    attrs->planes[i] = (const uint32_t*)planes[i];
    attrs->bits[i] = bits[i] < kWordBits ? bits[i] : kWordBits;
  }
  return true;
}

// Tiles (blocks) of a call over n_words mask words: the status words and
// block counts a call needs.
extern "C" int materialize_n_tiles(long long n_words) {
  return (int)((n_words + kThreads - 1) / kThreads);
}

extern "C" int materialize_max_attrs() { return kMaxAttrs; }

extern "C" int materialize_sparse_max() { return kSparseMax; }

// Blocks of materialize_lookback the current device holds at once: its SM
// count times the kernel's resident blocks per SM.
extern "C" int materialize_resident_tiles() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, materialize_lookback,
                                                kThreads, 0);
  return sms * per_sm;
}

// One launch on `stream`: out[a, :count] for the n_attrs <= kMaxAttrs
// attributes (planes[a]: (bits[a], n_words) int32; out: (n_attrs, cap)
// int32) and count[0]. `state` is the look-back's state (1 + n_tiles
// 8-byte words, zero on entry, zero again when the launch ends); launches
// that share it must run one after another, as those of one stream do.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// without launching. Allocates nothing.
extern "C" int materialize_lookback_launch(
    const void* const* planes, const int* bits, int n_attrs,
    const void* mask, long long n_words, void* out, long long cap,
    void* count, void* state, void* stream) {
  Attrs attrs;
  if (n_words < 1 || !load_attrs(planes, bits, n_attrs, &attrs))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = materialize_n_tiles(n_words);
  materialize_lookback<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      attrs, (const uint32_t*)mask, n_words, (int*)out, cap, (int*)count,
      (unsigned long long*)state, n_tiles);
  return (int)cudaGetLastError();
}

// The two-pass layout on `stream`: materialize_count into `counts`
// (n_tiles int32), then materialize_scatter. Same outputs and returns.
extern "C" int materialize_two_pass_launch(
    const void* const* planes, const int* bits, int n_attrs,
    const void* mask, long long n_words, void* out, long long cap,
    void* count, void* counts, void* stream) {
  Attrs attrs;
  if (n_words < 1 || !load_attrs(planes, bits, n_attrs, &attrs))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = materialize_n_tiles(n_words);
  materialize_count<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mask, n_words, (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  materialize_scatter<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      attrs, (const uint32_t*)mask, n_words, (int*)out, cap, (int*)count,
      (const int*)counts, n_tiles);
  return (int)cudaGetLastError();
}
