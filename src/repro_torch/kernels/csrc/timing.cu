// timing.cu — the measuring helpers of chip_smoke.py and the card tests.
//
// No TPU kernel is replaced here.
//
// empty_kernel does nothing: chip_smoke.py times it the way it times every
// kernel of the port (queued behind a spin, the L2 flushed by a 64 MB
// write or read before each launch), so each small kernel's card time can
// be read beside the least any launch costs under that method.
//
// capture_begin / capture_end_count count the kernels one call enqueues
// without CUPTI: the call is captured into a CUDA graph (relaxed mode,
// so nothing runs and the caller's allocations stay legal) and the
// graph's kernel nodes are counted. A capture yields its graph or a CUDA
// error; it cannot come back empty the way a profiler window can.
#include <cuda_runtime.h>

#include <vector>

__global__ void empty_kernel() {}

// n_blocks blocks of 32 threads on `stream`; returns cudaGetLastError().
extern "C" int empty_launch(int n_blocks, void* stream) {
  empty_kernel<<<n_blocks, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Start capturing `stream` into a graph; returns the CUDA error code.
extern "C" int capture_begin(void* stream) {
  return (int)cudaStreamBeginCapture((cudaStream_t)stream,
                                     cudaStreamCaptureModeRelaxed);
}

// End the capture of `stream`, count the graph's kernel nodes into
// *kernels and all its nodes into *nodes, and destroy the graph. Returns
// the first CUDA error code (a capture the call invalidated, for one).
extern "C" int capture_end_count(void* stream, int* kernels, int* nodes) {
  *kernels = *nodes = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture((cudaStream_t)stream, &graph);
  if (err != cudaSuccess) return (int)err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  std::vector<cudaGraphNode_t> all(n);
  if (err == cudaSuccess && n) err = cudaGraphGetNodes(graph, all.data(), &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(all[i], &type);
    if (err == cudaSuccess && type == cudaGraphNodeTypeKernel) ++*kernels;
  }
  *nodes = (int)n;
  cudaError_t destroyed = cudaGraphDestroy(graph);
  return (int)(err != cudaSuccess ? err : destroyed);
}
