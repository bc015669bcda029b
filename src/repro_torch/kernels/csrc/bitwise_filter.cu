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
//   filter_sum: mask = range_mask(filter planes) & valid, then its count
//               and popcount(mask & agg plane b) for every b, summed over
//               the whole stack in int64
//
// Bound on an H100 SXM: bytes. Each plane word is read once and each
// output word written once (n_bits*W*4 + W*4 bytes, twice the output for
// cmp_imm; (nf + na + 1)*W*4 for filter_sum, whose totals are a few
// bytes) at 3.35 TB/s; a word costs 1-5 logic ops per plane and, in
// filter_sum, 1 and, 1 popcount and 1 add per aggregate plane, below the
// integer pipes' rates (popcount is the scarcer, 16 per clock per SM).
// Every launch also pays the timing method's floor, an empty kernel's
// ~4.7 us (csrc/timing.cu), which no kernel design removes.
//
// The immediate is a runtime argument (its low n_bits bits, 64 to a
// word), so one build serves every immediate; bits at or above n_bits
// are ignored, as the Pallas kernels (unrolled on the immediate) do.
//
// eq_imm, cmp_imm, range_mask and filter_sum (redesigned). The first
// port gave each thread one word and walked a runtime n_bits loop 4
// planes at a time: at most 4 loads in flight per thread, dependent round
// trips to memory before the store, a branch on the immediate's bit per
// plane. Now:
//  - a thread issues the loads of all its planes before folding any:
//    eq_imm, cmp_imm and range_mask are instantiated for stacks of <= 8,
//    <= 16 and <= 32 planes (path d hands eq_imm 1-8 bit stacks, cmp_imm
//    4-21) and read wider stacks 16 planes at a time, up to kMaxBits;
//    cmp_imm's and range_mask's chunks run from the top plane down, the
//    top chunk padded past n_bits with planes that read as 0 against 0
//    bits, which leave the chain alone;
//  - the immediate folds without a branch, m = 0 - bit b:
//    eq_imm acc &= ~(v ^ m); cmp_imm lt |= eq & ~v & m, eq &= ~(v ^ m)
//    (cmp_fold); range_mask folds each loaded chunk twice, against lo and
//    against hi, and writes ~lt(lo) & lt(hi). On an H100 the branchy
//    step with the same loads was no faster, so it is not kept;
//  - the grid is at most what the card holds at once (SM count x resident
//    blocks, from the occupancy API, cached per device), grid-striding
//    past it, in 256-thread blocks, two consecutive words a thread in one
//    8-byte load per plane where W is even and the pointers 8-byte
//    aligned (every SF 1 relation), else one word;
//  - filter_sum is one launch (the first port was three: a zero fill of
//    per-block partials, the kernel, a torch sum). A thread's filter
//    planes (chunks of 8 or 16: a 32-plane chunk beside the aggregate
//    planes held 164 registers, one block per SM), its valid words and
//    its first kAggChunk aggregate planes are loaded before any folds,
//    and each later chunk of aggregate planes is loaded while the one
//    before it is summed; each block counts in int32 in shared memory
//    (at most 32 x the words it visits, which the wrapper keeps below
//    2^31), adds its counts into an int64 row of the caller's state with
//    atomics, and the block that finishes last moves the totals out and
//    returns the state to zeros, so every launch finds it zeroed and no
//    call carries host state. Integer sums are exact, so the totals do
//    not depend on the order the blocks add in.
// Measured (chip_smoke.py on an H100 80GB HBM3, 700 W, PERF.md §6): a
// launch costs the floor plus the plane bytes at about 2 TB/s after the
// method's write flush (2.6 TB/s after a read flush, which leaves no
// dirty lines in L2 to write back while the kernel reads). At (12,
// 188,416): cmp_imm 10.7 us against a 3.2 us bound, as fast as the first
// port's; range_mask 11.0-11.2 us against the first port's 10.5 in the same
// call (eq_imm, the same bytes and one fold, 10.1 us: the two folds of
// the padded chunk are the likely cost); filter_sum (12 + 24 + 1 planes)
// 22 us against 38 us.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

constexpr int kThreads = 256;              // threads per block
constexpr int kMaxBits = 1024;             // the widest plane stack taken
constexpr int kAggChunk = 8;               // filter_sum's aggregate planes
                                           // loaded at once
constexpr unsigned kFull = 0xffffffffu;

struct ImmBits {
  unsigned long long w[kMaxBits / 64];     // bit b is w[b/64] >> (b%64)
};

__device__ __forceinline__ bool imm_bit(const ImmBits& imm, int b) {
  return (imm.w[b >> 6] >> (b & 63)) & 1ull;
}

// The immediate's bits b0 .. b0 + NB - 1 in the low bits (NB divides 64
// and b0 is a multiple of NB, so they lie in one word).
template <int NB>
__device__ __forceinline__ uint32_t imm_chunk(const ImmBits& imm, int b0) {
  static_assert(NB <= 32 && 64 % NB == 0, "a chunk lies in one word");
  return (uint32_t)(imm.w[b0 >> 6] >> (b0 & 63));
}

// K consecutive words a thread: one 4K-byte load per plane.
template <int K> struct WordsOf;
template <> struct WordsOf<1> { using T = uint32_t; };
template <> struct WordsOf<2> { using T = uint2; };

// Group g (words g*K .. g*K + K - 1) of planes b0 .. b0 + NB - 1, every
// load issued before any is used; planes at or past n_bits read as 0.
template <int NB, int K>
__device__ __forceinline__ void load_planes(
    const uint32_t* __restrict__ planes, int b0, int n_bits,
    long long n_words, long long g, uint32_t (&v)[NB][K]) {
  using Vec = typename WordsOf<K>::T;
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
}

// The MSB-first comparator over the NB planes of v, top plane first,
// without a branch: with m = 0 - immediate bit (the low NB bits of
// `bits`), lt |= eq & ~v & m; eq &= ~(v ^ m): for a set bit lt |= eq &
// ~v, eq &= v; for a clear one eq &= ~v. A 0 plane against a 0 bit
// leaves both alone.
template <int NB, int K>
__device__ __forceinline__ void cmp_fold(const uint32_t (&v)[NB][K],
                                         uint32_t bits, uint32_t (&lt)[K],
                                         uint32_t (&eq)[K]) {
#pragma unroll
  for (int i = NB - 1; i >= 0; --i) {
    const uint32_t m = 0u - ((bits >> i) & 1u);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lt[k] |= eq[k] & ~v[i][k] & m;
      eq[k] &= ~(v[i][k] ^ m);
    }
  }
}

// (lt, eq) of group g against imm: chunks of NB planes from the top chunk
// down, each chunk's loads all in flight before it folds. The top chunk
// is padded past n_bits with planes that read as 0 (the immediate's bits
// there are 0), so the MSB-first order holds across chunk boundaries.
template <int NB, int K>
__device__ __forceinline__ void cmp_chain(
    const uint32_t* __restrict__ planes, int n_bits, long long n_words,
    long long g, const ImmBits& imm, uint32_t (&lt)[K], uint32_t (&eq)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lt[k] = 0u;
    eq[k] = ~0u;
  }
  for (int b0 = (n_bits - 1) / NB * NB; b0 >= 0; b0 -= NB) {
    uint32_t v[NB][K];
    load_planes<NB, K>(planes, b0, n_bits, n_words, g, v);
    cmp_fold<NB, K>(v, imm_chunk<NB>(imm, b0), lt, eq);
  }
}

// eq_imm: each thread takes K consecutive words, issues the loads of NB
// planes before folding any, and folds the immediate without a branch:
// acc &= ~(v ^ m_b), m_b = 0 - bit b. Planes at or past n_bits load as 0
// against a 0 bit of the immediate (its bits at or above n_bits are
// zero), which leaves acc alone. A stack wider than NB is read NB planes
// at a time.
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
      load_planes<NB, K>(planes, b0, n_bits, n_words, g, v);
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

template <int NB, int K>
__global__ void __launch_bounds__(kThreads)
cmp_imm_kernel(const uint32_t* __restrict__ planes, int n_bits,
               long long n_words, const __grid_constant__ ImmBits imm,
               uint32_t* __restrict__ lt_out, uint32_t* __restrict__ eq_out) {
  using Vec = typename WordsOf<K>::T;
  const long long n_groups = n_words / K;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < n_groups; g += (long long)gridDim.x * kThreads) {
    uint32_t lt[K], eq[K];
    cmp_chain<NB, K>(planes, n_bits, n_words, g, imm, lt, eq);
    Vec q;
    memcpy(&q, lt, sizeof q);
    reinterpret_cast<Vec*>(lt_out)[g] = q;
    memcpy(&q, eq, sizeof q);
    reinterpret_cast<Vec*>(eq_out)[g] = q;
  }
}

// range_mask, K words a thread: each chunk of NB planes, from the top
// down, is loaded once (all loads in flight) and folded against lo and hi.
template <int NB, int K>
__global__ void __launch_bounds__(kThreads)
range_mask_kernel(const uint32_t* __restrict__ planes, int n_bits,
                  long long n_words, const __grid_constant__ ImmBits lo,
                  const __grid_constant__ ImmBits hi,
                  uint32_t* __restrict__ out) {
  using Vec = typename WordsOf<K>::T;
  const long long n_groups = n_words / K;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
       g < n_groups; g += (long long)gridDim.x * kThreads) {
    uint32_t lt_lo[K], eq_lo[K], lt_hi[K], eq_hi[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lt_lo[k] = lt_hi[k] = 0u;
      eq_lo[k] = eq_hi[k] = ~0u;
    }
    for (int b0 = (n_bits - 1) / NB * NB; b0 >= 0; b0 -= NB) {
      uint32_t v[NB][K];
      load_planes<NB, K>(planes, b0, n_bits, n_words, g, v);
      cmp_fold<NB, K>(v, imm_chunk<NB>(lo, b0), lt_lo, eq_lo);
      cmp_fold<NB, K>(v, imm_chunk<NB>(hi, b0), lt_hi, eq_hi);
    }
    uint32_t m[K];
#pragma unroll
    for (int k = 0; k < K; ++k) m[k] = ~lt_lo[k] & lt_hi[k];
    Vec q;
    memcpy(&q, m, sizeof q);
    reinterpret_cast<Vec*>(out)[g] = q;
  }
}

// filter_sum over NB-plane filter chunks, K words a thread. `state` is
// the caller's int64 row, zeros between launches: [0] counts the blocks
// done, [1 + c] collects column c (0 the count, 1 + b agg plane b). The
// last block writes the na + 1 totals to `out` and zeroes the row.
template <int NB, int K>
__global__ void __launch_bounds__(kThreads)
filter_sum_kernel(const uint32_t* __restrict__ fplanes, int nf,
                  const uint32_t* __restrict__ aplanes, int na,
                  const uint32_t* __restrict__ valid, long long n_words,
                  const __grid_constant__ ImmBits lo,
                  const __grid_constant__ ImmBits hi,
                  unsigned long long* __restrict__ state,
                  long long* __restrict__ out) {
  using Vec = typename WordsOf<K>::T;
  extern __shared__ int acc[];             // na + 1 block counts
  __shared__ bool last;
  const int t = threadIdx.x, lane = t & 31;
  for (int c = t; c <= na; c += kThreads) acc[c] = 0;
  __syncthreads();

  const long long n_groups = n_words / K;
  const int top = (nf - 1) / NB * NB;
  // Every lane of a warp takes every step (the warp sums need all 32): a
  // lane past the end reads the last group again and selects nothing.
  for (long long g0 = (long long)blockIdx.x * kThreads; g0 < n_groups;
       g0 += (long long)gridDim.x * kThreads) {
    const bool in = g0 + t < n_groups;
    const long long g = in ? g0 + t : n_groups - 1;
    uint32_t f[NB][K], a[kAggChunk][K], vw[K];
    load_planes<NB, K>(fplanes, top, nf, n_words, g, f);
    const Vec q = __ldg(reinterpret_cast<const Vec*>(valid) + g);
    memcpy(vw, &q, sizeof q);
    load_planes<kAggChunk, K>(aplanes, 0, na, n_words, g, a);

    uint32_t lt_lo[K], eq_lo[K], lt_hi[K], eq_hi[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lt_lo[k] = lt_hi[k] = 0u;
      eq_lo[k] = eq_hi[k] = ~0u;
    }
    for (int b0 = top;;) {
      cmp_fold<NB, K>(f, imm_chunk<NB>(lo, b0), lt_lo, eq_lo);
      cmp_fold<NB, K>(f, imm_chunk<NB>(hi, b0), lt_hi, eq_hi);
      if ((b0 -= NB) < 0) break;
      load_planes<NB, K>(fplanes, b0, nf, n_words, g, f);
    }
    uint32_t mask[K];
    unsigned n = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mask[k] = in ? ~lt_lo[k] & lt_hi[k] & vw[k] : 0u;
      n += __popc(mask[k]);
    }
    n = __reduce_add_sync(kFull, n);
    if (lane == 0 && n) atomicAdd(&acc[0], (int)n);
    for (int a0 = 0; a0 < na; a0 += kAggChunk) {
      uint32_t next[kAggChunk][K];         // in flight while a is summed
      load_planes<kAggChunk, K>(aplanes, a0 + kAggChunk, na, n_words, g,
                                next);
#pragma unroll
      for (int i = 0; i < kAggChunk; ++i) {
        if (a0 + i < na) {                 // uniform across the grid
          unsigned pc = 0;
#pragma unroll
          for (int k = 0; k < K; ++k) pc += __popc(mask[k] & a[i][k]);
          pc = __reduce_add_sync(kFull, pc);
          if (lane == 0 && pc) atomicAdd(&acc[1 + a0 + i], (int)pc);
        }
      }
      memcpy(a, next, sizeof a);
    }
  }
  __syncthreads();

  unsigned long long* const done = state;
  unsigned long long* const sums = state + 1;
  for (int c = t; c <= na; c += kThreads)
    if (acc[c]) atomicAdd(&sums[c], (unsigned long long)acc[c]);
  // Each thread's additions are ordered before the block's count by the
  // fence, so the block that counts itself done last sees every block's.
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done, 1ull) == gridDim.x - 1ull;
  __syncthreads();
  if (last) {
    __threadfence();
    for (int c = t; c <= na; c += kThreads)
      out[c] = (long long)atomicExch(&sums[c], 0ull);
    if (t == 0) *done = 0ull;
  }
}

// The immediate's low n_bits bits, 64 to a word, from the host array
// `words` (ceil(n_bits / 64) of them); the rest zero.
static bool load_imm(const unsigned long long* words, int n_bits,
                     ImmBits* imm) {
  if (n_bits < 1 || n_bits > kMaxBits) return false;
  for (int i = 0; i < kMaxBits / 64; ++i)
    imm->w[i] = i < (n_bits + 63) / 64 ? words[i] : 0ull;
  if (n_bits % 64) imm->w[n_bits / 64] &= (1ull << (n_bits % 64)) - 1ull;
  return true;
}

// A grid of `need` blocks, cut to what the card holds of `kernel` at once
// (SM count x its resident blocks per SM with `smem` bytes of dynamic
// shared memory, from the occupancy API), so the stack is read in one
// wave. `most` caches the card's count per device ordinal (0: unknown).
static unsigned resident_grid(const void* kernel, size_t smem,
                              int (&most)[16], long long need) {
  int dev = 0;
  cudaGetDevice(&dev);
  int& r = most[dev & 15];
  if (r == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  smem);
    r = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return (unsigned)(need < r ? need : r);
}

static long long groups_over(long long n_words, int k) {
  return (n_words / k + kThreads - 1) / kThreads;
}

// Two words a thread where W is even and every pointer 8-byte aligned
// (every relation's stack at SF 1), else one.
static bool two_words(long long n_words, const void* a, const void* b,
                      const void* c) {
  return n_words % 2 == 0 && (uintptr_t)a % 8 == 0 &&
         (uintptr_t)b % 8 == 0 && (uintptr_t)c % 8 == 0;
}

template <int NB, int K>
static void eq_imm_run(const uint32_t* planes, int n_bits, long long n_words,
                       const ImmBits& imm, uint32_t* out,
                       cudaStream_t stream) {
  static int most[16];
  const unsigned grid = resident_grid(
      (const void*)eq_imm_kernel<NB, K>, 0, most, groups_over(n_words, K));
  eq_imm_kernel<NB, K><<<grid, kThreads, 0, stream>>>(planes, n_bits,
                                                      n_words, imm, out);
}

template <int NB, int K>
static void cmp_imm_run(const uint32_t* planes, int n_bits, long long n_words,
                        const ImmBits& imm, uint32_t* lt, uint32_t* eq,
                        cudaStream_t stream) {
  static int most[16];
  const unsigned grid = resident_grid(
      (const void*)cmp_imm_kernel<NB, K>, 0, most, groups_over(n_words, K));
  cmp_imm_kernel<NB, K><<<grid, kThreads, 0, stream>>>(planes, n_bits,
                                                       n_words, imm, lt, eq);
}

template <int NB, int K>
static void range_mask_run(const uint32_t* planes, int n_bits,
                           long long n_words, const ImmBits& lo,
                           const ImmBits& hi, uint32_t* out,
                           cudaStream_t stream) {
  static int most[16];
  const unsigned grid = resident_grid((const void*)range_mask_kernel<NB, K>,
                                      0, most, groups_over(n_words, K));
  range_mask_kernel<NB, K><<<grid, kThreads, 0, stream>>>(
      planes, n_bits, n_words, lo, hi, out);
}

struct SumArgs {
  const uint32_t* fplanes;
  int nf;
  const uint32_t* aplanes;
  int na;
  const uint32_t* valid;
  long long n_words;
  unsigned long long* state;
  long long* out;
};

template <int NB, int K>
static void filter_sum_run(const SumArgs& s, const ImmBits& lo,
                           const ImmBits& hi, cudaStream_t stream) {
  static int most[16];
  // Resident blocks counted with the most shared memory any na takes.
  const unsigned grid = resident_grid(
      (const void*)filter_sum_kernel<NB, K>, (kMaxBits + 1) * sizeof(int),
      most, groups_over(s.n_words, K));
  filter_sum_kernel<NB, K><<<grid, kThreads, (s.na + 1) * sizeof(int),
                             stream>>>(s.fplanes, s.nf, s.aplanes, s.na,
                                       s.valid, s.n_words, lo, hi, s.state,
                                       s.out);
}

// The instance for a stack of n_bits planes: all its planes in flight
// up to 32, wider stacks 16 at a time.
#define BY_WIDTH(run, n_bits, K, ...)                        \
  do {                                                       \
    if ((n_bits) <= 8)                                       \
      run<8, K>(__VA_ARGS__);                                \
    else if ((n_bits) <= 16 || (n_bits) > 32)                \
      run<16, K>(__VA_ARGS__);                               \
    else                                                     \
      run<32, K>(__VA_ARGS__);                               \
  } while (0)

// Launch on `stream`; each returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching when a width is outside
// [1, 1024] (na: [0, 1024]) or filter_sum's int32 block counts could
// reach 2^31 (32 x n_words); none allocates.
extern "C" int eq_imm_launch(const void* planes, int n_bits,
                             long long n_words,
                             const unsigned long long* imm, void* out,
                             void* stream) {
  ImmBits ib;
  if (!load_imm(imm, n_bits, &ib)) return (int)cudaErrorInvalidValue;
  const uint32_t* p = (const uint32_t*)planes;
  uint32_t* o = (uint32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (two_words(n_words, p, o, o))
    BY_WIDTH(eq_imm_run, n_bits, 2, p, n_bits, n_words, ib, o, s);
  else
    BY_WIDTH(eq_imm_run, n_bits, 1, p, n_bits, n_words, ib, o, s);
  return (int)cudaGetLastError();
}

extern "C" int cmp_imm_launch(const void* planes, int n_bits,
                              long long n_words,
                              const unsigned long long* imm, void* lt,
                              void* eq, void* stream) {
  ImmBits ib;
  if (!load_imm(imm, n_bits, &ib)) return (int)cudaErrorInvalidValue;
  const uint32_t* p = (const uint32_t*)planes;
  uint32_t *l = (uint32_t*)lt, *e = (uint32_t*)eq;
  const cudaStream_t s = (cudaStream_t)stream;
  if (two_words(n_words, p, l, e))
    BY_WIDTH(cmp_imm_run, n_bits, 2, p, n_bits, n_words, ib, l, e, s);
  else
    BY_WIDTH(cmp_imm_run, n_bits, 1, p, n_bits, n_words, ib, l, e, s);
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
  const uint32_t* p = (const uint32_t*)planes;
  uint32_t* o = (uint32_t*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  if (two_words(n_words, p, o, o))
    BY_WIDTH(range_mask_run, n_bits, 2, p, n_bits, n_words, lb, hb, o, s);
  else
    BY_WIDTH(range_mask_run, n_bits, 1, p, n_bits, n_words, lb, hb, o, s);
  return (int)cudaGetLastError();
}

// Writes the na + 1 int64 totals (the count, then one per aggregate
// plane) to `out`. `state` is 2 + na int64 words, zero before the launch
// and zero again after it (the kernel returns it so); the launches that
// share a state must be ordered, as launches on one stream are.
extern "C" int filter_sum_launch(const void* fplanes, int nf,
                                 const void* aplanes, int na,
                                 const void* valid, long long n_words,
                                 const unsigned long long* lo,
                                 const unsigned long long* hi, void* state,
                                 void* out, void* stream) {
  ImmBits lb, hb;
  if (na < 0 || na > kMaxBits || n_words < 1 ||
      32 * n_words >= (1ll << 31) || !load_imm(lo, nf, &lb) ||
      !load_imm(hi, nf, &hb))
    return (int)cudaErrorInvalidValue;
  const SumArgs a{(const uint32_t*)fplanes, nf,
                  (const uint32_t*)aplanes, na,
                  (const uint32_t*)valid, n_words,
                  (unsigned long long*)state, (long long*)out};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool two = two_words(n_words, fplanes, aplanes, valid);
  if (nf <= 8 && two)
    filter_sum_run<8, 2>(a, lb, hb, s);
  else if (nf <= 8)
    filter_sum_run<8, 1>(a, lb, hb, s);
  else if (two)
    filter_sum_run<16, 2>(a, lb, hb, s);
  else
    filter_sum_run<16, 1>(a, lb, hb, s);
  return (int)cudaGetLastError();
}
