// timing.cu — a kernel that does nothing, the floor of a timing method.
//
// No TPU kernel is replaced: chip_smoke.py times empty_kernel the way it
// times every kernel of the port (queued behind a spin, the L2 flushed by
// a 64 MB write or read before each launch), so each small kernel's card
// time can be read beside the least any launch costs under that method.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

// n_blocks blocks of 32 threads on `stream`; returns cudaGetLastError().
extern "C" int empty_launch(int n_blocks, void* stream) {
  empty_kernel<<<n_blocks, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
