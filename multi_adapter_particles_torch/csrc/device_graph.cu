// Captured CUDA graphs instantiated for device launch, and launched from
// the host through the CUDA runtime (runtime/fused.py's DeviceGraph). No
// kernel: host calls only, built like the kernels (ops/_build.py) so that
// a profiler sees each replay as the runtime's cudaGraphLaunch, which ties
// the replayed kernels to the launch by its correlation id.
//
// Why device launch: graphs instantiated with no flags (as
// torch.cuda.CUDAGraph does) ran each kernel boundary of the fused 4M frame
// at one of two latencies on an H100 (~0.46 us or ~0.12 us), switching
// from the slow to the fast one at a moment no seed or frame fixes; graphs
// instantiated for device launch and uploaded once ran every boundary at
// one latency in every process measured (PERF.md section 6).

#include <cuda_runtime.h>

extern "C" {

// the executable graph of `graph` (a cudaGraph_t), instantiated for device
// launch and uploaded on `stream`
int device_graph_instantiate(void* graph, void** exec, void* stream) {
  cudaGraphExec_t e = nullptr;
  cudaError_t rc = cudaGraphInstantiateWithFlags(
      &e, (cudaGraph_t)graph, cudaGraphInstantiateFlagDeviceLaunch);
  if (rc != cudaSuccess) return (int)rc;
  *exec = (void*)e;
  return (int)cudaGraphUpload(e, (cudaStream_t)stream);
}

int device_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

int device_graph_destroy(void* exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

}  // extern "C"
