// bitpack.cu — 32 values per word and back: the column transform (the
// paper's Fig. 6) between one value per record and packed mask words.
//
// Replaces the Pallas TPU kernels repro/kernels/bitpack.py:27 (bitpack,
// body _pack_kernel) and repro/kernels/bitpack.py:48 (bitunpack, body
// _unpack_kernel). Words are int32 tensors carrying the uint32 pattern.
//
// bitpack: (W, 32) -> (W,), word w = sum over j of bits[w, j] << j, mod
// 2^32, as the reference sums (for 0/1 input that is bit j = bits[w, j];
// an OR or __ballot_sync would be wrong for any other input).
// bitunpack: (W,) -> (W, 32), out[w, j] = (word w >> j) & 1.
//
// Bound on an H100 SXM: bytes, W*4 + W*32*4 of them (the 32-wide side
// read or written once, the words the other way) at 3.35 TB/s; a shift
// and an add or an and per element is far below the integer pipes.
//
// Design (the first port gave each thread one element: one 4-byte load
// or store, ~8 KB in flight per SM, where HBM's latency at full rate
// wants ~15-20 KB):
//  - a 128-byte row of the 32-wide side is 8 16-byte vectors; lane q of
//    each group of 8 lanes takes vector q (columns 4q .. 4q+3) of one
//    row, so a warp instruction covers 4 rows, 512 contiguous bytes;
//  - a block takes one tile of 32 x kRows rows: each thread handles
//    kRows rows (u x 32 + threadIdx / 8), and issues all its loads before
//    it uses any (bitpack: 4 vectors, 64 bytes in flight a thread);
//  - bitpack sums its 4 terms v_k << (4q + k), then 3 __shfl_xor_sync
//    steps inside the group of 8 make the word; lane q = 0 stores it;
//  - bitunpack loads its 4 words (8 lanes read one word: a broadcast, a
//    warp's 4 words one 16-byte line), and stores 4 bits as one 16-byte
//    vector a lane;
//  - every lane of a block takes the same steps, so the full-warp
//    shuffles never see an exited lane; a lane past the last row loads
//    zeros and stores nothing;
//  - bitpack reads 16-byte vectors where its input is 16-byte aligned
//    (every tensor torch allocates); otherwise (a view some words into a
//    buffer) the whole call takes the same kernel with 4 scalar loads in
//    place of each vector: same lanes, same arithmetic, one launch.
//    bitunpack's output is allocated by its wrapper, so it always is
//    aligned; the launcher refuses one that is not;
//  - element offsets are 64-bit (W x 32 passes 2^31 past 67 M words);
//  - the 32-wide side is read (bitpack) or written (bitunpack) with
//    streaming (.cs, evict-first) accesses: each byte is touched once.
// On an H100 80GB HBM3 at 700 W (PERF.md §6), 1, 2, 4 or 8 rows a
// thread and a grid of the card's resident blocks grid-striding were
// within a few percent of this design, and streaming accesses were the
// faster; at (188,416, 32) bitpack takes 15.2-15.5 us and bitunpack
// 13.6-13.8 us after chip_smoke.py's write flush, the first port's
// one element a thread 23.5-23.7 and 21.2-21.3.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kRowsPerStep = kThreads / 8;   // rows a block covers per u
constexpr int kRows = 4;                     // rows a thread
constexpr long long kTile = (long long)kRowsPerStep * kRows;
constexpr unsigned kFull = 0xffffffffu;

// The 4 words at `p` (16-byte aligned when Vec), evict-first.
template <bool Vec>
__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  if constexpr (Vec)
    return __ldcs(reinterpret_cast<const uint4*>(p));
  else
    return make_uint4(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2),
                      __ldcs(p + 3));
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads)
bitpack_kernel(const uint32_t* __restrict__ bits, long long n_words,
               uint32_t* __restrict__ words) {
  const int q = threadIdx.x & 7;             // columns 4q .. 4q+3
  const int j = 4 * q;
  const long long first = blockIdx.x * kTile + (threadIdx.x >> 3);
  uint4 v[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const long long row = first + u * kRowsPerStep;
    v[u] = row < n_words ? load4<Vec>(bits + row * 32 + j)
                         : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    uint32_t s = (v[u].x << j) + (v[u].y << (j + 1)) +
                 (v[u].z << (j + 2)) + (v[u].w << (j + 3));
    s += __shfl_xor_sync(kFull, s, 1);
    s += __shfl_xor_sync(kFull, s, 2);
    s += __shfl_xor_sync(kFull, s, 4);
    const long long row = first + u * kRowsPerStep;
    if (q == 0 && row < n_words) words[row] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
bitunpack_kernel(const uint32_t* __restrict__ words, long long n_words,
                 uint32_t* __restrict__ bits) {
  const int q = threadIdx.x & 7;
  const long long first = blockIdx.x * kTile + (threadIdx.x >> 3);
  uint32_t w[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const long long row = first + u * kRowsPerStep;
    w[u] = row < n_words ? __ldg(words + row) : 0u;
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const long long row = first + u * kRowsPerStep;
    const uint32_t x = w[u] >> (4 * q);
    if (row < n_words)
      __stcs(reinterpret_cast<uint4*>(bits + row * 32 + 4 * q),
             make_uint4(x & 1u, (x >> 1) & 1u, (x >> 2) & 1u,
                        (x >> 3) & 1u));
  }
}

// One block a tile; 0 where that passes the grid's limit.
static unsigned grid_for(long long n_words) {
  const long long need = (n_words + kTile - 1) / kTile;
  return need > INT_MAX ? 0u : (unsigned)need;
}

// Launch on `stream`; each returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a word count past the grid's limit, and
// allocates nothing.
extern "C" int bitpack_launch(const void* bits, long long n_words,
                              void* words, void* stream) {
  const unsigned grid = grid_for(n_words);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  auto kernel = (uintptr_t)bits % 16 == 0 ? bitpack_kernel<true>
                                          : bitpack_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, n_words, (uint32_t*)words);
  return (int)cudaGetLastError();
}

// `bits` must be 16-byte aligned (cudaErrorMisalignedAddress otherwise).
extern "C" int bitunpack_launch(const void* words, long long n_words,
                                void* bits, void* stream) {
  const unsigned grid = grid_for(n_words);
  if (grid == 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)bits % 16 != 0) return (int)cudaErrorMisalignedAddress;
  bitunpack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (uint32_t*)bits);
  return (int)cudaGetLastError();
}
