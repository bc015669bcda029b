// bitwise_filter.cu — bit-serial comparison of every record of a plane
// stack against an immediate (the paper's Algorithm 1 over packed words),
// and the fused COUNT and SUM(agg) WHERE lo <= key < hi built on it.
//
// Replaces the Pallas TPU kernels repro/kernels/bitwise_filter.py:39
// (eq_imm, body _eq_imm_kernel), :69 (cmp_imm, body _cmp_imm_kernel),
// :110 (range_mask, body _range_kernel) and
// repro/kernels/filter_aggregate.py:63 (filter_sum, body _fused_kernel).
// Planes are int32 tensors carrying the uint32 pattern, (n_bits, W).
//
//   eq_imm:     out = AND over b of (imm bit b ? v_b : ~v_b)    LSB-first
//   cmp_imm:    MSB-first (lt, eq) chains against imm
//   range_mask: ~lt(lo) & lt(hi), both chains over one load of each plane
//   filter_sum: mask = range_mask(filter planes) & valid, then per block
//               its count and popcount(mask & agg plane b) for every b
//
// Bound on an H100 SXM: bytes. Each plane word is read once and each
// output word written once (n_bits*W*4 + W*4 bytes, twice the output for
// cmp_imm; (nf + na + 1)*W*4 for filter_sum, whose partials are a few
// kilobytes) at 3.35 TB/s; a word costs 1-5 logic ops per plane and, in
// filter_sum, 1 and, 1 popcount and 1 add per aggregate plane, below the
// integer pipes' rates (popcount is the scarcer, 16 per clock per SM).
//
// eq_imm (redesigned). The first port gave each thread one word and
// walked a runtime n_bits loop 4 planes at a time: at most 4 loads in
// flight per thread, dependent round trips to memory before the store, a
// branch on the immediate's bit per plane. Now a thread issues the loads
// of all its planes before folding any: the kernel is instantiated for
// stacks of <= 8, <= 16 and <= 32 planes (path d hands it 1-8 bit stacks)
// and reads wider stacks 16 planes at a time, up to kMaxBits. The
// immediate folds without a branch, acc &= ~(v ^ (0 - bit)). The grid is
// at most what the card holds at once (SM count x resident blocks, from
// the occupancy API), grid-striding past it. One launch shape serves
// every stack: 256-thread blocks, two consecutive words a thread in one
// 8-byte load per plane where W is even and the pointers 8-byte aligned
// (every path-d operand), else one word. Two words a thread beat one at
// every path-d shape on an H100 (one word was 10 % slower than the first
// port at (12, 188,416)); four with 16-byte loads, and a rule choosing
// 128-thread blocks for small relations, gained nothing. Measured
// (chip_smoke.py on an H100, PERF.md): a launch costs the timing method's
// floor, an empty kernel's ~5 us, plus the plane bytes at about 2 TB/s,
// so (12, 188,416) takes ~10 us against a 2.9 us bytes bound, and path
// d's launches, on 1-8 bit stacks, 6-7 us each: the floor, not the
// kernel, sets their time.
//
// cmp_imm, range_mask and filter_sum keep the first port's design: one
// thread per word, loads coalesced along the word axis straight into
// registers (no shared memory for the masks), the plane loads independent
// of the chain so they overlap. The Pallas kernels unroll on the
// immediate at trace time; here the immediate is a runtime argument (its
// low n_bits bits, 64 to a word), and the branch on its bit b is uniform
// across the grid, so one build serves every immediate. Bits at or above
// n_bits are ignored, as the Pallas kernels ignore them.
// cmp_imm/range_mask loop grid-stride over the words; filter_sum
// takes one word per thread, reduces each column across the warp with
// __reduce_add_sync into an int32 shared accumulator (at most 32 * 256
// per block, exact) and writes the block's row of partials (n_blocks,
// na + 1) with plain stores, so nothing depends on block order: the
// Pallas kernel's per-tile partials.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

constexpr int kThreads = 256;              // kernels/bitwise_filter.py THREADS
constexpr int kMaxBits = 1024;             // the widest plane stack taken
constexpr int kMaxBlocks = 4096;           // grid-stride beyond this

struct ImmBits {
  unsigned long long w[kMaxBits / 64];     // bit b is w[b/64] >> (b%64)
};

__device__ __forceinline__ bool imm_bit(const ImmBits& imm, int b) {
  return (imm.w[b >> 6] >> (b & 63)) & 1ull;
}

// One MSB-first comparator step: plane word v against immediate bit `set`.
__device__ __forceinline__ void cmp_step(bool set, uint32_t v, uint32_t& lt,
                                         uint32_t& eq) {
  if (set) {
    lt |= eq & ~v;
    eq &= v;
  } else {
    eq &= ~v;
  }
}

// lo <= v < hi for the 32 records of word w: both chains over one load of
// each plane.
__device__ __forceinline__ uint32_t range_word(
    const uint32_t* __restrict__ planes, int n_bits, long long n_words,
    long long w, const ImmBits& lo, const ImmBits& hi) {
  uint32_t lt_lo = 0u, eq_lo = 0xffffffffu;
  uint32_t lt_hi = 0u, eq_hi = 0xffffffffu;
#pragma unroll 4
  for (int b = n_bits - 1; b >= 0; --b) {
    const uint32_t v = planes[(long long)b * n_words + w];
    cmp_step(imm_bit(lo, b), v, lt_lo, eq_lo);
    cmp_step(imm_bit(hi, b), v, lt_hi, eq_hi);
  }
  return ~lt_lo & lt_hi;
}

// eq_imm: every plane of a thread's words in flight at once. Each thread
// takes K consecutive words (one 4K-byte load per plane), issues the loads
// of NB planes before folding any, and folds the immediate without a
// branch: acc &= ~(v ^ m_b), m_b = 0 - bit b. Planes at or past n_bits
// load as 0 against a 0 bit of the immediate (its bits at or above n_bits
// are zero), which leaves acc alone. A stack wider than NB is read NB
// planes at a time.
template <int K> struct WordsOf;
template <> struct WordsOf<1> { using T = uint32_t; };
template <> struct WordsOf<2> { using T = uint2; };

template <int NB, int K>
__global__ void __launch_bounds__(kThreads)
eq_imm_kernel(const uint32_t* __restrict__ planes, int n_bits,
              long long n_words, const __grid_constant__ ImmBits imm,
              uint32_t* __restrict__ out) {
  using Vec = typename WordsOf<K>::T;
  const long long n_groups = n_words / K;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < n_groups; g += (long long)gridDim.x * kThreads) {
    uint32_t acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = ~0u;
    for (int b0 = 0; b0 < n_bits; b0 += NB) {
      uint32_t v[NB][K];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        Vec q;
        if (b0 + i < n_bits)
          q = __ldg(reinterpret_cast<const Vec*>(
                        planes + (long long)(b0 + i) * n_words) + g);
        else
          memset(&q, 0, sizeof q);
        memcpy(v[i], &q, sizeof q);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const uint32_t m = 0u - (uint32_t)imm_bit(imm, b0 + i);
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] &= ~(v[i][k] ^ m);
      }
    }
    Vec q;
    memcpy(&q, acc, sizeof q);
    reinterpret_cast<Vec*>(out)[g] = q;
  }
}

__global__ void __launch_bounds__(kThreads)
cmp_imm_kernel(const uint32_t* __restrict__ planes, int n_bits,
               long long n_words, const __grid_constant__ ImmBits imm,
               uint32_t* __restrict__ lt_out, uint32_t* __restrict__ eq_out) {
  for (long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
       w < n_words; w += (long long)gridDim.x * kThreads) {
    uint32_t lt = 0u, eq = 0xffffffffu;
#pragma unroll 4
    for (int b = n_bits - 1; b >= 0; --b)
      cmp_step(imm_bit(imm, b), planes[(long long)b * n_words + w], lt, eq);
    lt_out[w] = lt;
    eq_out[w] = eq;
  }
}

__global__ void __launch_bounds__(kThreads)
range_mask_kernel(const uint32_t* __restrict__ planes, int n_bits,
                  long long n_words, const __grid_constant__ ImmBits lo,
                  const __grid_constant__ ImmBits hi,
                  uint32_t* __restrict__ out) {
  for (long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
       w < n_words; w += (long long)gridDim.x * kThreads)
    out[w] = range_word(planes, n_bits, n_words, w, lo, hi);
}

__global__ void __launch_bounds__(kThreads)
filter_sum_kernel(const uint32_t* __restrict__ fplanes, int nf,
                  const uint32_t* __restrict__ aplanes, int na,
                  const uint32_t* __restrict__ valid, long long n_words,
                  const __grid_constant__ ImmBits lo,
                  const __grid_constant__ ImmBits hi,
                  int* __restrict__ partials) {
  extern __shared__ int acc[];             // na + 1 block accumulators
  for (int c = threadIdx.x; c <= na; c += kThreads) acc[c] = 0;
  __syncthreads();

  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool in = w < n_words;             // words past the end select none
  const uint32_t mask =
      in ? range_word(fplanes, nf, n_words, w, lo, hi) & valid[w] : 0u;
  const bool lane0 = (threadIdx.x & 31) == 0;
  const unsigned count = __reduce_add_sync(0xffffffffu, __popc(mask));
  if (lane0) atomicAdd(&acc[0], (int)count);
  for (int b = 0; b < na; ++b) {
    const uint32_t v = in ? aplanes[(long long)b * n_words + w] : 0u;
    const unsigned pc = __reduce_add_sync(0xffffffffu, __popc(mask & v));
    if (lane0) atomicAdd(&acc[b + 1], (int)pc);
  }
  __syncthreads();
  for (int c = threadIdx.x; c <= na; c += kThreads)
    partials[(long long)blockIdx.x * (na + 1) + c] = acc[c];
}

// The immediate's low n_bits bits, 64 to a word, from the host array
// `words` (ceil(n_bits / 64) of them); the rest zero.
static bool load_imm(const unsigned long long* words, int n_bits,
                     ImmBits* imm) {
  if (n_bits < 1 || n_bits > kMaxBits) return false;
  for (int i = 0; i < kMaxBits / 64; ++i)
    imm->w[i] = i < (n_bits + 63) / 64 ? words[i] : 0ull;
  return true;
}

static long long blocks_over(long long n_words) {
  return (n_words + kThreads - 1) / kThreads;
}

static unsigned n_blocks(long long n_words) {
  const long long b = blocks_over(n_words);
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

// One eq_imm instance over the stack: a grid of at most the blocks the
// card holds at once (SM count x the instance's resident blocks per SM,
// from the occupancy API, cached per device ordinal), so the stack is
// read in one wave.
template <int NB, int K>
static void eq_imm_run(const uint32_t* planes, int n_bits, long long n_words,
                       const ImmBits& imm, uint32_t* out,
                       cudaStream_t stream) {
  static int most[16];                   // 0: unknown
  int dev = 0;
  cudaGetDevice(&dev);
  int& r = most[dev & 15];
  if (r == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, eq_imm_kernel<NB, K>, kThreads, 0);
    r = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long need = (n_words / K + kThreads - 1) / kThreads;
  eq_imm_kernel<NB, K><<<(unsigned)(need < r ? need : r), kThreads, 0,
                         stream>>>(planes, n_bits, n_words, imm, out);
}

template <int K>
static void eq_imm_widths(const uint32_t* planes, int n_bits,
                          long long n_words, const ImmBits& imm,
                          uint32_t* out, cudaStream_t stream) {
  if (n_bits <= 8)
    eq_imm_run<8, K>(planes, n_bits, n_words, imm, out, stream);
  else if (n_bits <= 16 || n_bits > 32)  // wider: 16 planes at a time
    eq_imm_run<16, K>(planes, n_bits, n_words, imm, out, stream);
  else
    eq_imm_run<32, K>(planes, n_bits, n_words, imm, out, stream);
}

// Launch on `stream`; each returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching when a width is outside
// [1, 1024] (na: [0, 1024]) or filter_sum's partials do not have one row
// per kThreads words; none allocates.
extern "C" int eq_imm_launch(const void* planes, int n_bits,
                             long long n_words,
                             const unsigned long long* imm, void* out,
                             void* stream) {
  ImmBits ib;
  if (!load_imm(imm, n_bits, &ib)) return (int)cudaErrorInvalidValue;
  // Two words a thread where every plane row and the output are 8-byte
  // aligned (W even, as every relation's at SF 1), else one.
  const uint32_t* p = (const uint32_t*)planes;
  uint32_t* o = (uint32_t*)out;
  if (n_words % 2 == 0 && (uintptr_t)p % 8 == 0 && (uintptr_t)o % 8 == 0)
    eq_imm_widths<2>(p, n_bits, n_words, ib, o, (cudaStream_t)stream);
  else
    eq_imm_widths<1>(p, n_bits, n_words, ib, o, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" int cmp_imm_launch(const void* planes, int n_bits,
                              long long n_words,
                              const unsigned long long* imm, void* lt,
                              void* eq, void* stream) {
  ImmBits ib;
  if (!load_imm(imm, n_bits, &ib)) return (int)cudaErrorInvalidValue;
  cmp_imm_kernel<<<n_blocks(n_words), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)planes, n_bits, n_words, ib, (uint32_t*)lt,
      (uint32_t*)eq);
  return (int)cudaGetLastError();
}

extern "C" int range_mask_launch(const void* planes, int n_bits,
                                 long long n_words,
                                 const unsigned long long* lo,
                                 const unsigned long long* hi, void* out,
                                 void* stream) {
  ImmBits lb, hb;
  if (!load_imm(lo, n_bits, &lb) || !load_imm(hi, n_bits, &hb))
    return (int)cudaErrorInvalidValue;
  range_mask_kernel<<<n_blocks(n_words), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)planes, n_bits, n_words, lb, hb, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// Writes partials (n_rows, na + 1) int32; n_rows must be
// ceil(n_words / kThreads).
extern "C" int filter_sum_launch(const void* fplanes, int nf,
                                 const void* aplanes, int na,
                                 const void* valid, long long n_words,
                                 const unsigned long long* lo,
                                 const unsigned long long* hi,
                                 void* partials, long long n_rows,
                                 void* stream) {
  ImmBits lb, hb;
  if (na < 0 || na > kMaxBits || n_rows != blocks_over(n_words) ||
      !load_imm(lo, nf, &lb) || !load_imm(hi, nf, &hb))
    return (int)cudaErrorInvalidValue;
  filter_sum_kernel<<<(unsigned)n_rows, kThreads, (na + 1) * sizeof(int),
                      (cudaStream_t)stream>>>(
      (const uint32_t*)fplanes, nf, (const uint32_t*)aplanes, na,
      (const uint32_t*)valid, n_words, lb, hb, (int*)partials);
  return (int)cudaGetLastError();
}
