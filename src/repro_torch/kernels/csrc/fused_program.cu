// fused_program.cu — a whole compiled relation program in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/program.py::fused_program
// (body _program_kernel): comparators, mask logic, carry-save arithmetic,
// grouped masked per-bit popcounts, per-block MIN/MAX candidates and the
// packed output masks of one relation program, in one pass over the
// relation's bit-planes.
//
// Design. The Pallas kernel is unrolled per program at trace time. Here the
// program arrives as a flat plane-op tape (kernels/program.py records it
// once per program) and this one kernel interprets any tape, so a single
// nvcc build serves every query:
//   * one thread owns one 32-bit word column (32 records); a block of T
//     threads is one tile; the tape's slots live in shared memory,
//     slot-major ([slot][thread]), so a warp's accesses hit 32 banks;
//   * a thread touches only its own column, so plain ops need no barrier;
//   * popcounts: __popc, a warp reduction, a shared int32 accumulator per
//     column, then one 64-bit atomicAdd per column per block into the
//     int64 output — exact (blocks run in no order, so nothing carries
//     from one block to the next as the TPU's sequential grid did);
//   * MIN/MAX narrowing needs a block-wide "any" per bit: __syncthreads_or.
//     Every thread therefore runs the whole tape: threads past W hold zero
//     words and never return early. The host combines the per-block
//     candidates.
//
// Bound on an H100 SXM: the bytes of the source planes and the valid plane
// read once plus the output masks written once, at 3.35 TB/s — or the
// tape's word operations on the integer pipes (per SM and clock: 64
// logic ops, 16 popcounts), whichever is larger. Q1 is set by its
// popcounts, most programs by their bytes. This first kernel is
// correct first and slow by choice: it re-reads every operand from shared
// memory and decodes the tape per op; specialising or fusing the tape is
// later work.
#include <cstdint>
#include <cuda_runtime.h>

// Keep in step with kernels/program.py.
enum Op : int {
  LOAD = 0, STORE, CONST0, CONST1, NOT, AND, OR, XOR, POPC, MAXSTEP,
  MINSTEP, ANY
};

__global__ void __launch_bounds__(1024)
fused_program_kernel(const uint32_t* __restrict__ src, long long n_words,
                     const int* __restrict__ tape, int n_ops, int n_slots,
                     uint32_t* __restrict__ masks,
                     unsigned long long* __restrict__ pc, int n_pc,
                     int* __restrict__ mm, int n_mm) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  uint32_t* s = smem + t;                      // slot k of this thread: s[k*T]
  int* acc = reinterpret_cast<int*>(smem + (size_t)n_slots * T);
  const long long w = (long long)blockIdx.x * T + t;
  const bool in = w < n_words;
  int* mm_row = mm + (long long)blockIdx.x * n_mm;

  for (int i = t; i < n_pc; i += T) acc[i] = 0;
  __syncthreads();

  for (int i = 0; i < n_ops; ++i) {
    const int* e = tape + 5 * i;
    const int op = e[0], d = e[1], a = e[2], b = e[3], c = e[4];
    switch (op) {
      case LOAD:
        s[d * T] = in ? src[(long long)a * n_words + w] : 0u;
        break;
      case STORE:
        if (in) masks[(long long)c * n_words + w] = s[a * T];
        break;
      case CONST0: s[d * T] = 0u; break;
      case CONST1: s[d * T] = ~0u; break;
      case NOT: s[d * T] = ~s[a * T]; break;
      case AND: s[d * T] = s[a * T] & s[b * T]; break;
      case OR: s[d * T] = s[a * T] | s[b * T]; break;
      case XOR: s[d * T] = s[a * T] ^ s[b * T]; break;
      case POPC: {
        int v = in ? __popc(s[a * T] & s[b * T]) : 0;
        v = __reduce_add_sync(0xffffffffu, v);
        if ((t & 31) == 0 && v) atomicAdd(&acc[c], v);
        break;
      }
      case MAXSTEP:
      case MINSTEP: {
        const uint32_t cand = s[a * T];
        const uint32_t p = s[b * T];
        const uint32_t x = in ? (cand & (op == MAXSTEP ? p : ~p)) : 0u;
        const bool has = __syncthreads_or(x != 0u) != 0;
        s[d * T] = has ? x : cand;
        if (t == 0) mm_row[c] = (op == MAXSTEP) == has;
        break;
      }
      case ANY: {
        const bool has = __syncthreads_or(in && s[a * T] != 0u) != 0;
        if (t == 0) mm_row[c] = has;
        break;
      }
    }
  }

  __syncthreads();
  for (int i = t; i < n_pc; i += T)
    if (acc[i]) atomicAdd(&pc[i], (unsigned long long)acc[i]);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success). Allocates
// nothing: the caller owns every buffer.
extern "C" int fused_program_launch(const void* src, long long n_words,
                                    const void* tape, int n_ops, int n_slots,
                                    void* masks, void* pc, int n_pc, void* mm,
                                    int n_mm, int block, int smem_bytes,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_blocks = (n_words + block - 1) / block;
  fused_program_kernel<<<(unsigned)n_blocks, block, smem_bytes,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)src, n_words, (const int*)tape, n_ops, n_slots,
      (uint32_t*)masks, (unsigned long long*)pc, n_pc, (int*)mm, n_mm);
  return (int)cudaGetLastError();
}
