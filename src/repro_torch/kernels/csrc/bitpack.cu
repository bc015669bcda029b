// bitpack.cu — 32 values per word and back: the column transform (the
// paper's Fig. 6) between one value per record and packed mask words.
//
// Replaces the Pallas TPU kernels repro/kernels/bitpack.py:27 (bitpack,
// body _pack_kernel) and repro/kernels/bitpack.py:48 (bitunpack, body
// _unpack_kernel). Words are int32 tensors carrying the uint32 pattern.
//
// bitpack: (W, 32) -> (W,), word w = sum over j of bits[w, j] << j, mod
// 2^32, as the reference sums. One thread per input element, so a warp is
// one output word and its 32 loads are one coalesced 128-byte line; the
// sum is a warp add-reduction (__reduce_add_sync). For 0/1 input that
// equals __ballot_sync(bits != 0); the add-reduction was chosen because it
// also gives the reference's result for any other input.
//
// bitunpack: (W,) -> (W, 32), out[w, j] = (word w >> j) & 1. One thread
// per output element: the warp's 32 stores are one coalesced line, and
// its 32 loads of the same word are one broadcast.
//
// Bound on an H100 SXM: bytes, W*4 + W*32*4 of them (the 0/1 side read or
// written once, the words the other way) at 3.35 TB/s; one shift, and an
// and or an add, per element. The design moves each byte once, coalesced.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bitpack_kernel(const uint32_t* __restrict__ bits, long long n_words,
               uint32_t* __restrict__ words) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long w = i >> 5;               // a warp never straddles words
  if (w >= n_words) return;                 // whole warps leave together
  const int j = (int)(i & 31);
  const uint32_t v = __reduce_add_sync(0xffffffffu, bits[i] << j);
  if (j == 0) words[w] = v;
}

__global__ void __launch_bounds__(kThreads)
bitunpack_kernel(const uint32_t* __restrict__ words, long long n_words,
                 uint32_t* __restrict__ bits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if ((i >> 5) >= n_words) return;
  bits[i] = (words[i >> 5] >> (i & 31)) & 1u;
}

static unsigned n_blocks(long long n_words) {
  return (unsigned)((n_words * 32 + kThreads - 1) / kThreads);
}

// Launch on `stream`; each returns cudaGetLastError() (0 on success) and
// allocates nothing.
extern "C" int bitpack_launch(const void* bits, long long n_words,
                              void* words, void* stream) {
  bitpack_kernel<<<n_blocks(n_words), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)bits, n_words, (uint32_t*)words);
  return (int)cudaGetLastError();
}

extern "C" int bitunpack_launch(const void* words, long long n_words,
                                void* bits, void* stream) {
  bitunpack_kernel<<<n_blocks(n_words), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, n_words, (uint32_t*)bits);
  return (int)cudaGetLastError();
}
