// Conditional nodes of a CUDA graph, added while the graph is captured.
//
// Replaces no Pallas kernel.  It is the device side of the reference's
// control flow: paddle_lite_tpu/ops/control_flow.py runs `while` as
// jax.lax.while_loop (:94), its condition and `i < max_iters` evaluated on
// the device (:77-82), and `conditional_block` as jax.lax.cond (:117), both
// inside the one XLA computation of a request.  Here a `while` is a
// conditional node of type cudaGraphCondTypeWhile and a branch one of type
// cudaGraphCondTypeIf, inside the one CUDA graph of a request, so a request
// reads nothing back to the host.
//
// A plain C interface over the CUDA runtime, one function a runtime call,
// run on the stream that torch is capturing (core/conditional_nodes.py
// calls them in order):
//   plt_graph_capture_info   cudaStreamGetCaptureInfo: the graph being
//                            captured and the capture's dependencies;
//   plt_graph_cond_handle    cudaGraphConditionalHandleCreate on that graph;
//   plt_graph_set_cond       the one kernel, below;
//   plt_graph_add_cond_node  cudaGraphAddNode (a conditional node of one
//                            body) after those dependencies: its body graph;
//   plt_graph_set_deps       cudaStreamUpdateCaptureDependencies: the node
//                            becomes the capture's only dependency;
//   plt_graph_begin_body     cudaStreamBeginCaptureToGraph: a side stream
//                            captures into the body;
//   plt_graph_end_body       cudaStreamEndCapture of the side stream;
//   plt_graph_stream         a non-blocking stream (the side streams).
// Graph and stream handles are driver objects, so the runtime that nvcc
// links here acts on the graph and the streams of torch's own runtime, as
// the other kernels of this directory launch on torch's streams.
//
// The kernel (<<<1, 1>>>): reads a one-byte device flag and sets the
// node's condition to it (cudaGraphSetConditional), as torch's
// CUDAGraph::set_conditional_handle does.  Its plain version is the host's
// bool(flag).  What bounds it: nothing but its launch; it reads one byte.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// codes of this library's own, above the runtime's error codes
constexpr int kNotCapturing = 100001;
constexpr int kOtherGraph = 100002;

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* flag) {
  cudaGraphSetConditional(handle, flag[0] != 0 ? 1u : 0u);
}

}  // namespace

extern "C" {

int plt_graph_capture_info(void* stream, void** graph, void** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t* d = nullptr;
  size_t n = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                                             nullptr, &g, &d, &n);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return kNotCapturing;
  *graph = g;
  *deps = const_cast<cudaGraphNode_t*>(d);
  *n_deps = n;
  return 0;
}

int plt_graph_cond_handle(void* graph, unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  // default 0 and no flags: every launch sets the value before the node reads it
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, static_cast<cudaGraph_t>(graph), 0, 0);
  if (err != cudaSuccess) return err;
  *handle = h;
  return 0;
}

int plt_graph_set_cond(void* stream, unsigned long long handle, const void* flag) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const unsigned char*>(flag));
  return cudaGetLastError();
}

// kind: 0 an IF node, 1 a WHILE node
int plt_graph_add_cond_node(void* graph, void* deps, size_t n_deps, unsigned long long handle,
                            int kind, void** node, void** body) {
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t added = nullptr;
  cudaError_t err = cudaGraphAddNode(&added, static_cast<cudaGraph_t>(graph),
                                     static_cast<const cudaGraphNode_t*>(deps), n_deps, &params);
  if (err != cudaSuccess) return err;
  *node = added;
  *body = params.conditional.phGraph_out[0];
  return 0;
}

int plt_graph_set_deps(void* stream, void* node) {
  cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(node);
  return cudaStreamUpdateCaptureDependencies(static_cast<cudaStream_t>(stream), &dep, 1,
                                             cudaStreamSetCaptureDependencies);
}

int plt_graph_begin_body(void* stream, void* body) {
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(stream),
                                       static_cast<cudaGraph_t>(body), nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

int plt_graph_end_body(void* stream, void* body) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &g);
  if (err != cudaSuccess) return err;
  return g == static_cast<cudaGraph_t>(body) ? 0 : kOtherGraph;
}

int plt_graph_stream(void** stream) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  *stream = s;
  return 0;
}

const char* plt_graph_error(int code) {
  if (code == kNotCapturing) return "the stream is not capturing";
  if (code == kOtherGraph) return "the body's capture ended into another graph";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
