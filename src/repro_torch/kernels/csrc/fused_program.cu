// fused_program.cu — a whole compiled relation program in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/program.py::fused_program
// (body _program_kernel): comparators, mask logic, carry-save arithmetic,
// grouped masked per-bit popcounts, per-tile MIN/MAX candidates and the
// packed output masks of one relation program, in one pass over the
// relation's bit-planes.
//
// The Pallas kernel is unrolled per program at trace time. Here the program
// arrives as a flat tape of 64-bit entries (kernels/program.py records it
// once per program) and this one kernel interprets any tape, so a single
// nvcc build serves every query. Every thread runs the whole tape on its
// own K consecutive words (K = 2; 1 and 4 for tapes whose launch asks for
// them) of a tile of T*K words: plain ops need no barrier, and the
// block-wide MIN/MAX votes line up because all threads run the same
// entries.
//
// Bound on an H100 SXM: the stacked rows read once plus the stored masks
// written once, at 3.35 TB/s, or the tape's word operations on the integer
// pipes (per SM and clock: 64 logic ops, 16 popcounts), whichever is
// larger. Q1 is set by its popcounts, most programs by their bytes. An
// interpreter also pays, per entry, its decode and its operands' shared
// memory traffic, which the bound does not count; on this card that cost,
// not memory, sets even the light programs (PERF.md).
//
// Design, one part per cause of the first version's distance from it:
//  1. Slots crowded shared memory and starved the SM of warps. The
//     recorder now orders the tape depth-first from its outputs, so a value
//     lives for one cone of the DAG rather than a whole CSA level (Q1: 58
//     slots instead of 249 in the recorded order), and the block choice
//     (kernels/common.py::plan_launch) keeps the most words resident per SM.
//  2. Each LOAD waited out a trip to device memory alone. Now a tile's
//     source rows are copied into shared memory with cp.async, all of them
//     in flight at once, before its tape runs; an operand below n_rows is
//     a staged row, read in place. Blocks are persistent (the host launches
//     SMs x blocks per SM from the occupancy API) and loop over tiles;
//     other blocks' tapes hide one block's staging, so one buffer is
//     enough. Rows move 16 bytes at a time where W % 4 == 0 and 4 bytes at
//     a time otherwise; words past W arrive as zeros (cp.async's zero fill)
//     and are masked out of every mask, popcount and vote.
//  3. Decoding cost more than the work. An entry is one 64-bit word, read
//     with a uniform load while the previous entry runs; its operands are
//     shared-memory byte offsets, each taken out with one mask or shift,
//     and loaded before any branch; the pure ops (AND, OR, XOR, NOT and the
//     constants, most of any tape) are truth tables computed without a
//     branch. One entry serves K words per thread through one 4-, 8- or
//     16-byte shared access per operand ([plane][thread][K], conflict-free).
//  4. Popcounts went to global atomics per block. The int32 accumulators
//     stay in shared memory across all of a block's tiles (the host checks
//     that 32 x its words fit in int32) and are added to the int64 output
//     once per block at the end.
// Shared memory: the n_rows staged rows, then the slots, each a plane of
// T*K words, then n_pc int32 accumulators.
#include <cstdint>
#include <cuda_runtime.h>

// Keep in step with kernels/program.py. A pure op (below POPC) is its own
// truth table: z = ((x & y) & A) ^ ((x ^ y) & X) ^ N, with A, X and N its
// bits 0, 1 and 2 spread over the word (NOT reads its operand as b too).
enum Op : unsigned {
  CONST0 = 0, AND = 1, XOR = 2, OR = 3, CONST1 = 4, NOT = 5,
  POPC = 8, STORE, MAXSTEP, MINSTEP, ANY
};

struct Args {
  const uint32_t* src;             // (n_rows, n_words) stacked input
  long long n_words;
  const uint2* code;               // (n_ops,) packed entries
  int n_ops, n_rows, n_planes;
  uint32_t* masks;                 // (n_masks, n_words)
  unsigned long long* pc;          // (n_pc,) int64 totals
  int n_pc;
  int* mm;                         // (n_tiles, n_mm)
  int n_mm;
  long long n_tiles;
};

__device__ __forceinline__ void cp_async16(unsigned dst, const uint32_t* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const uint32_t* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the n_rows source rows of one tile (tile words from w0) into the
// planes from shared address `dst` on, in word order; words at or past
// n_words arrive as zeros.
__device__ __forceinline__ void stage_tile(const Args& p, long long w0,
                                           int tile, unsigned dst) {
  const int t = threadIdx.x, T = blockDim.x;
  const bool vec = (p.n_words & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.src) & 15) == 0;
  if (vec) {            // 16-byte chunks: W % 4 == 0, w0 % 4 == 0
    const int chunks = tile >> 2;
    for (int i = t; i < p.n_rows * chunks; i += T) {
      const int r = i / chunks;
      const long long w = w0 + ((i - r * chunks) << 2);
      const bool in = w < p.n_words;
      cp_async16(dst + i * 16, p.src + (in ? r * p.n_words + w : 0),
                 in ? 16 : 0);
    }
  } else {
    for (int i = t; i < p.n_rows * tile; i += T) {
      const int r = i / tile;
      const long long w = w0 + (i - r * tile);
      const bool in = w < p.n_words;
      cp_async4(dst + i * 4, p.src + (in ? r * p.n_words + w : 0),
                in ? 4 : 0);
    }
  }
}

// A thread's K consecutive words of one plane, moved with one 4-, 8- or
// 16-byte shared access (a warp's access covers 128, 256 or 512
// consecutive bytes: no bank conflicts).
template <int K>
struct Words {
  uint32_t w[K];
};

template <int K>
__device__ __forceinline__ Words<K> lds(const char* q) {
  Words<K> v;
  if constexpr (K == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(q);
    v.w[0] = x.x; v.w[1] = x.y; v.w[2] = x.z; v.w[3] = x.w;
  } else if constexpr (K == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(q);
    v.w[0] = x.x; v.w[1] = x.y;
  } else {
    v.w[0] = *reinterpret_cast<const uint32_t*>(q);
  }
  return v;
}

template <int K>
__device__ __forceinline__ void sts(char* q, const Words<K>& v) {
  if constexpr (K == 4) {
    *reinterpret_cast<uint4*>(q) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<uint2*>(q) = make_uint2(v.w[0], v.w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(q) = v.w[0];
  }
}

template <int K>
__global__ void __launch_bounds__(1024)
fused_program_kernel(const Args p) {
  extern __shared__ __align__(16) char smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int tile = T * K;
  int* acc = reinterpret_cast<int*>(smem + (size_t)p.n_planes * tile * 4);
  for (int i = t; i < p.n_pc; i += T) acc[i] = 0;
  const unsigned smem_base = (unsigned)__cvta_generic_to_shared(smem);
  char* const mine = smem + t * K * 4;            // this thread's words

  long long tile_idx = blockIdx.x;
  stage_tile(p, tile_idx * tile, tile, smem_base);
  cp_async_commit();
  for (; tile_idx < p.n_tiles; tile_idx += gridDim.x) {
    cp_async_wait<0>();
    __syncthreads();                      // this tile's rows have landed

    // The tape, over this tile. Entry: lo = op | a | d << 14, hi = b |
    // c << 18, where a, b and d are plane byte offsets (multiples of 16
    // below 256 KB, so bits 4-17 hold them) and c is the STORE row / POPC
    // column / MIN/MAX column.
    const long long w0 = tile_idx * tile + (long long)t * K;
    uint32_t in[K];                       // ~0 for words below W
#pragma unroll
    for (int k = 0; k < K; ++k) in[k] = w0 + k < p.n_words ? ~0u : 0u;
    const uint2* e_ptr = p.code;
    const uint2* const e_end = e_ptr + p.n_ops;
    uint2 next_e = p.n_ops ? __ldg(e_ptr) : make_uint2(0u, 0u);
    for (; e_ptr < e_end; ++e_ptr) {
      const uint2 e = next_e;
      if (e_ptr + 1 < e_end) next_e = __ldg(e_ptr + 1);
      const unsigned op = e.x & 15u;
      char* const a = mine + (e.x & 0x3fff0u);
      char* const d = mine + ((e.x >> 14) & 0x3fff0u);
      char* const b = mine + (e.y & 0x3fff0u);
      const unsigned c = e.y >> 18;
      const Words<K> x = lds<K>(a), y = lds<K>(b);
      Words<K> z;
      if (op < POPC) {                    // every pure op, without a branch
        const uint32_t mA = 0u - (op & 1u), mX = 0u - ((op >> 1) & 1u);
        const uint32_t mN = 0u - ((op >> 2) & 1u);
#pragma unroll
        for (int k = 0; k < K; ++k)
          z.w[k] = ((x.w[k] & y.w[k]) & mA) ^ ((x.w[k] ^ y.w[k]) & mX) ^ mN;
        sts<K>(d, z);
        continue;
      }
      switch (op) {
        case POPC: {
          int v = 0;
#pragma unroll
          for (int k = 0; k < K; ++k) v += __popc(x.w[k] & y.w[k] & in[k]);
          v = __reduce_add_sync(0xffffffffu, v);
          if ((t & 31) == 0 && v) atomicAdd(&acc[c], v);
          break;
        }
        case STORE:
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (in[k]) p.masks[(long long)c * p.n_words + w0 + k] = x.w[k];
          break;
        case MAXSTEP:
        case MINSTEP: {                   // x: candidates, y: the plane
          uint32_t any = 0;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            z.w[k] = x.w[k] & (op == MAXSTEP ? y.w[k] : ~y.w[k]) & in[k];
            any |= z.w[k];
          }
          const bool has = __syncthreads_or(any != 0u) != 0;
#pragma unroll
          for (int k = 0; k < K; ++k) z.w[k] = has ? z.w[k] : x.w[k];
          sts<K>(d, z);
          if (t == 0) p.mm[tile_idx * p.n_mm + c] = (op == MAXSTEP) == has;
          break;
        }
        case ANY: {
          uint32_t any = 0;
#pragma unroll
          for (int k = 0; k < K; ++k) any |= x.w[k] & in[k];
          const bool has = __syncthreads_or(any != 0u) != 0;
          if (t == 0) p.mm[tile_idx * p.n_mm + c] = has;
          break;
        }
      }
    }

    __syncthreads();                      // nobody reads the rows now
    if (tile_idx + gridDim.x < p.n_tiles) {
      stage_tile(p, (tile_idx + gridDim.x) * tile, tile, smem_base);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  // The last tile's closing barrier ordered every warp's atomics.
  for (int i = t; i < p.n_pc; i += T)
    if (acc[i]) atomicAdd(&p.pc[i], (unsigned long long)acc[i]);
}

// Shared memory one block may use on Hopper.
static constexpr int kMaxSmemBytes = 232448;

template <int K>
static const void* kernel_of() {
  return (const void*)fused_program_kernel<K>;
}

static const void* kernel_for(int k) {
  return k == 4 ? kernel_of<4>() : k == 2 ? kernel_of<2>()
       : k == 1 ? kernel_of<1>() : nullptr;
}

// Blocks of `threads` threads with `smem_bytes` of shared memory that fit
// one SM, and the kernel's registers per thread, for K = k.
extern "C" int fused_program_occupancy(int k, int threads, int smem_bytes,
                                       int* blocks, int* regs) {
  const void* fn = kernel_for(k);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  *regs = attr.numRegs;
  return (int)err;
}

// Launch `grid` persistent blocks on `stream`; returns cudaGetLastError()
// (0 on success). Allocates nothing: the caller owns every buffer, has
// zeroed `pc`, and has called fused_program_occupancy for this k (which
// lifts the kernel's dynamic shared memory limit to the maximum).
extern "C" int fused_program_launch(const void* src, long long n_words,
                                    const void* code, int n_ops, int n_rows,
                                    int n_planes, void* masks,
                                    void* pc, int n_pc, void* mm, int n_mm,
                                    int k, int threads, int smem_bytes,
                                    long long n_tiles, int grid,
                                    void* stream) {
  const Args p{(const uint32_t*)src, n_words, (const uint2*)code, n_ops,
               n_rows, n_planes, (uint32_t*)masks,
               (unsigned long long*)pc, n_pc, (int*)mm, n_mm, n_tiles};
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 4)
    fused_program_kernel<4><<<grid, threads, smem_bytes, s>>>(p);
  else if (k == 2)
    fused_program_kernel<2><<<grid, threads, smem_bytes, s>>>(p);
  else if (k == 1)
    fused_program_kernel<1><<<grid, threads, smem_bytes, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
