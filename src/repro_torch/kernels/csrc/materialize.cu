// materialize.cu — the mask-selected records of some attributes, decoded
// from their bit planes and compacted in record order.
//
// Replaces the Pallas TPU kernel repro/kernels/materialize.py:109
// (materialize_pallas, body _materialize_kernel): bit plane b of word w,
// lane l is bit b of record w*32+l; the selected records' values come out
// as int32, the first `count` columns of each attribute's row, in record
// order (the stable compaction of the reference's _compact).
//
// Design. The Pallas kernel compacts per tile and stitches the tiles
// afterwards with a searchsorted gather over the decoded values; that
// relies on its grid running in order. Hopper blocks run in no order, so:
//   1. materialize_count: one thread per mask word; per block the popcount
//      of its mask words (warp reduce, then shared memory);
//   2. an inclusive scan of the block counts (torch.cumsum in the wrapper,
//      glue over n_blocks integers; its last entry is `count`);
//   3. materialize_scatter: one thread per record word. The block re-reads
//      its mask words and scans their popcounts (warp shuffles, then the
//      warp totals), so each thread knows the rank of its first selected
//      record in the block. Per attribute, each thread reads the plane
//      words of its record word once (coalesced across the warp; not at
//      all where its mask word is 0), walks its selected lanes with __ffs,
//      decodes each value from registers and writes it to its rank in a
//      shared staging row; the block then copies the row, contiguous, to
//      out[a, block base + i]. No atomics allocate output slots, so the
//      order is record order whatever order the blocks run in.
// Values are decoded as uint32 and stored as their int32 bit pattern, so a
// 32-bit attribute wraps exactly as the reference's int32 << 31 does;
// planes past the 32nd add nothing (XLA's shift by >= 32 gives 0).
//
// Bound on an H100 SXM: bytes. The attributes' planes and the mask are
// read once and `count` values per attribute written once, at 3.35 TB/s;
// the decode is ~3 integer ops per plane per selected record. The design
// keeps to that: every plane word is loaded once, coalesced, and the
// staging row turns the scattered per-thread stores into contiguous ones.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;           // words per block, both passes
constexpr int kMaxAttrs = 16;           // attributes per scatter launch
constexpr int kWordBits = 32;

struct Attrs {
  const uint32_t* planes[kMaxAttrs];    // (bits[a], n_words) each
  int bits[kMaxAttrs];                  // planes decoded: <= 32
  int out_row[kMaxAttrs];               // row of `out` this attribute fills
  int n;
};

__device__ __forceinline__ int block_sum(int v, int* warp_tot) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_tot[warp] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) s += warp_tot[i];
  return s;                              // meaningful in thread 0 only
}

__global__ void __launch_bounds__(kThreads)
materialize_count(const uint32_t* __restrict__ mask, long long n_words,
                  int* __restrict__ counts) {
  __shared__ int warp_tot[kThreads / 32];
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int s = block_sum(w < n_words ? __popc(mask[w]) : 0, warp_tot);
  if (threadIdx.x == 0) counts[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
materialize_scatter(Attrs attrs, const uint32_t* __restrict__ mask,
                    long long n_words, const int* __restrict__ cum,
                    int* __restrict__ out, long long cap) {
  __shared__ int warp_excl[kThreads / 32];
  __shared__ int stage[kThreads * kWordBits];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long w = (long long)blockIdx.x * kThreads + t;
  const uint32_t m = w < n_words ? mask[w] : 0u;
  const int pc = __popc(m);

  // Block-wide exclusive scan of the per-word popcounts.
  int incl = pc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_excl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kThreads / 32 ? warp_excl[lane] : 0;
    int x = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane < kThreads / 32) warp_excl[lane] = x - v;
  }
  __syncthreads();
  const int rank = warp_excl[warp] + incl - pc;
  const long long base = blockIdx.x ? cum[blockIdx.x - 1] : 0;
  const int n_sel = cum[blockIdx.x] - (int)base;

  for (int a = 0; a < attrs.n; ++a) {
    const uint32_t* p = attrs.planes[a] + w;
    const int nb = attrs.bits[a];
    uint32_t pw[kWordBits];
#pragma unroll
    for (int b = 0; b < kWordBits; ++b)
      pw[b] = (m != 0u && b < nb) ? p[(long long)b * n_words] : 0u;
    int r = rank;
    for (uint32_t left = m; left; left &= left - 1u) {
      const int l = __ffs(left) - 1;
      uint32_t v = 0u;
#pragma unroll
      for (int b = 0; b < kWordBits; ++b) v |= ((pw[b] >> l) & 1u) << b;
      stage[r++] = (int)v;
    }
    __syncthreads();
    int* row = out + (long long)attrs.out_row[a] * cap + base;
    for (int i = t; i < n_sel; i += kThreads) row[i] = stage[i];
    __syncthreads();
  }
}

extern "C" int materialize_n_blocks(long long n_words) {
  return (int)((n_words + kThreads - 1) / kThreads);
}

// Pass 1 on `stream`: counts[n_blocks] per-block selected records. Returns
// cudaGetLastError() (0 on success). Allocates nothing.
extern "C" int materialize_count_launch(const void* mask, long long n_words,
                                        void* counts, void* stream) {
  const int n_blocks = materialize_n_blocks(n_words);
  materialize_count<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mask, n_words, (int*)counts);
  return (int)cudaGetLastError();
}

// Pass 3 on `stream`, given `cum`, the inclusive scan of the counts:
// out[a, :count] for every attribute, in launches of kMaxAttrs attributes.
// planes[a] points at attribute a's (bits[a], n_words) planes; out is
// (n_attrs, cap) int32. Returns cudaGetLastError() (0 on success).
extern "C" int materialize_scatter_launch(const void* const* planes,
                                          const int* bits, int n_attrs,
                                          const void* mask, long long n_words,
                                          const void* cum, void* out,
                                          long long cap, void* stream) {
  const int n_blocks = materialize_n_blocks(n_words);
  for (int a0 = 0; a0 < n_attrs; a0 += kMaxAttrs) {
    Attrs attrs{};
    attrs.n = n_attrs - a0 < kMaxAttrs ? n_attrs - a0 : kMaxAttrs;
    for (int i = 0; i < attrs.n; ++i) {
      attrs.planes[i] = (const uint32_t*)planes[a0 + i];
      attrs.bits[i] = bits[a0 + i] < kWordBits ? bits[a0 + i] : kWordBits;
      attrs.out_row[i] = a0 + i;
    }
    materialize_scatter<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        attrs, (const uint32_t*)mask, n_words, (const int*)cum, (int*)out,
        cap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
