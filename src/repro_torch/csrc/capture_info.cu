// The device operations a CUDA graph under capture holds so far.
//
// No kernel: a host entry over the CUDA runtime's graph API, beside the
// kernels so that kernels/_build.py builds and loads it like them.  The
// captured executor (core/synthesis.py:CapturedExecutor) calls it after
// each stage of the forward it captures, so that the graph's device
// operations can be put under the stage that enqueued them: the graph
// is one chain captured on one stream, and a replay runs its operations
// in capture order.
//
// counts[0], counts[1], counts[2]: the kernel, memcpy and memset nodes
// of the graph that `stream` is capturing into.  Returns
// cudaErrorIllegalState when the stream is not capturing.

#include <cuda_runtime.h>

#include <vector>

extern "C" int captured_op_counts(void* stream, void* counts) {
  if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &id, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return static_cast<int>(cudaErrorIllegalState);
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  long long* out = static_cast<long long*>(counts);
  out[0] = out[1] = out[2] = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (type == cudaGraphNodeTypeKernel) ++out[0];
    else if (type == cudaGraphNodeTypeMemcpy) ++out[1];
    else if (type == cudaGraphNodeTypeMemset) ++out[2];
  }
  return static_cast<int>(cudaSuccess);
}
