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
// cudagraph_conditional_nodes.py builds it). `graph_while_begin` /
// `graph_while_end` build a WHILE node the same way, `utils/control.
// fori_loop`'s (a loop body captured once, as `lax.map` traces one); the
// body's last node sets the handle from the updated predicate. Needs CUDA
// 12.4 (conditional nodes, capture to a graph).
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

// stream: the capturing stream; pred: device bool; type: cudaGraphCondTypeIf
// or cudaGraphCondTypeWhile; body_out: receives the body's capturing stream
// (a cudaStream_t); handle_out: the node's handle. Returns a cudaError_t.
static int cond_begin(void* stream, const void* pred, cudaGraphConditionalNodeType type,
                      void** body_out, unsigned long long* handle_out) {
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
  params.conditional.type = type;
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
  *handle_out = (unsigned long long)handle;
  return (int)cudaSuccess;
}

extern "C" int graph_if_begin(void* stream, const void* pred, void** body_out) {
  unsigned long long handle;
  return cond_begin(stream, pred, cudaGraphCondTypeIf, body_out, &handle);
}

// A WHILE node on pred: its body runs while the handle is set, which the
// node's predecessor sets from pred and graph_while_end's last body node
// sets from pred again (the body updates it). handle_out: for
// graph_while_end. Returns a cudaError_t.
extern "C" int graph_while_begin(void* stream, const void* pred, void** body_out,
                                 unsigned long long* handle_out) {
  return cond_begin(stream, pred, cudaGraphCondTypeWhile, body_out, handle_out);
}

// body: the stream graph_if_begin returned; nodes_out: receives the body
// graph's node count (its own level: a nested IF node counts one here, its
// body at its own graph_if_end). Returns a cudaError_t.
extern "C" int graph_if_end(void* body, size_t* nodes_out) {
  cudaStream_t b = (cudaStream_t)body;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamEndCapture(b, &graph);
  if (err == cudaSuccess) err = cudaGraphGetNodes(graph, nullptr, nodes_out);
  cudaError_t err2 = cudaStreamDestroy(b);
  return (int)(err != cudaSuccess ? err : err2);
}

// body: the stream graph_while_begin returned; its last node sets the loop's
// handle from pred (the body's updated predicate), then the body's capture
// ends as in graph_if_end. Returns a cudaError_t.
extern "C" int graph_while_end(void* body, unsigned long long handle, const void* pred,
                               size_t* nodes_out) {
  cudaStream_t b = (cudaStream_t)body;
  set_if_handle_kernel<<<1, 1, 0, b>>>((cudaGraphConditionalHandle)handle,
                                       (const uint8_t*)pred);
  cudaError_t launched = cudaGetLastError();
  int ended = graph_if_end(body, nodes_out);
  return launched != cudaSuccess ? (int)launched : ended;
}

// The node count of the graph `stream` is capturing, at its top level (each
// IF node one). Returns a cudaError_t.
extern "C" int graph_capture_nodes(void* stream, size_t* nodes_out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  return (int)cudaGraphGetNodes(graph, nullptr, nodes_out);
}
