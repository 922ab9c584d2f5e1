// Conditional IF nodes for a CUDA graph that PyTorch is capturing: the
// device side of `utils/control.cond`, the counterpart of the JAX package's
// `lax.cond` inside a compiled step (e.g. badger_amcl_tpu/ops/
// corr_kernel.py:914-922, pf/filter.py:449, pf/cluster.py:170).
//
// `graph_if_begin`, called while `stream` captures into a graph: a kernel
// node sets a new conditional handle from the device predicate (a bool
// byte), an IF node on the handle follows the stream's current capture
// dependencies and becomes its only one, and a new stream starts capturing
// into the node's body graph. The caller makes that stream current, issues
// the arm's work, then calls `graph_if_end`, which ends the body's capture
// and destroys the stream. At every replay the body runs exactly when the
// predicate byte is nonzero; nothing is read back to the host. An if/else
// is two IF nodes, on the predicate and on its negation (as PyTorch's own
// cudagraph_conditional_nodes.py builds it). Needs CUDA 12.4 (conditional
// nodes, capture to a graph).
//
// Bound: one single-thread kernel per node; the handle's cost is the node's
// launch inside the graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_if_handle_kernel(cudaGraphConditionalHandle handle,
                                     const uint8_t* __restrict__ pred) {
  cudaGraphSetConditional(handle, pred[0] != 0 ? 1u : 0u);
}

}  // namespace

// stream: the capturing stream; pred: device bool; body_out: receives the
// body's capturing stream (a cudaStream_t). Returns a cudaError_t.
extern "C" int graph_if_begin(void* stream, const void* pred, void** body_out) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  set_if_handle_kernel<<<1, 1, 0, s>>>(handle, (const uint8_t*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the handle's kernel node is now the stream's dependency
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t body;
  err = cudaStreamCreateWithFlags(&body, cudaStreamNonBlocking);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr,
                                      nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) {
    cudaStreamDestroy(body);
    return (int)err;
  }
  *body_out = (void*)body;
  return (int)cudaSuccess;
}

// body: the stream graph_if_begin returned. Returns a cudaError_t.
extern "C" int graph_if_end(void* body) {
  cudaStream_t b = (cudaStream_t)body;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamEndCapture(b, &graph);
  cudaError_t err2 = cudaStreamDestroy(b);
  return (int)(err != cudaSuccess ? err : err2);
}
