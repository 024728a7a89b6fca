// Conditional nodes of CUDA graphs (CUDA 12.3 or later), inserted by hand:
// the port's counterpart of lax.while_loop and lax.cond inside one jitted
// program.
//
// Replaces no Pallas kernel. The reference's QP solve is one
// lax.while_loop (gpu_se_tpu/control/qp.py:404-489) whose cond reads the
// solver's status on the device, with a lax.cond around its adaptive-rho
// refactorization; XLA keeps the loop on the TPU. PyTorch inserts only IF
// nodes, and only by capturing into their bodies, so the port builds the
// loop here: a WHILE node, inserted into the graph the caller's stream is
// capturing, whose body holds clones of graphs captured beforehand (child
// graph nodes), a nested IF node and the kernel that sets each handle.
//
// A handle's value is written on the device by set_cond, a one-thread
// kernel that reads a bool flag that the captured work wrote and calls
// cudaGraphSetConditional. Each handle assigns its default at every launch
// of the graph that holds its node (cudaGraphCondAssignDefault), so every
// launch starts the loop afresh. When given a count, set_cond adds one to
// g_count each time it runs: the WHILE iterations, read after a run
// through gst_cond_count. gst_cond_prepare, called outside any capture,
// loads set_cond's module and takes g_count's address beforehand.
//
// Bound on the H100: none worth the name. set_cond reads one byte and, when
// counting, adds to one 8-byte word: a few bytes an iteration, far below a
// microsecond at 3.35 TB/s. What an iteration costs is the device's
// scheduling of the conditional node and of its body's launches, which
// chip_smoke.py times against the host-driven loop.
//
// Where the nodes go: gst_capture_* act on the capture underway on a
// stream (cudaStreamGetCaptureInfo; the node is added after the capture's
// current dependencies and cudaStreamUpdateCaptureDependencies makes the
// work captured next depend on it); gst_graph_* append to a graph that is
// not captured (a conditional node's body) after the node *last (NULL:
// a root) and make *last the new node.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ unsigned long long g_count = 0;
unsigned long long* g_count_ptr = nullptr;  // its address, once prepared

__global__ void set_cond(cudaGraphConditionalHandle handle, const bool* flag,
                         unsigned long long* count) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
  if (count != nullptr) atomicAdd(count, 1ull);
}

int counter(int counted, unsigned long long** out) {
  *out = nullptr;
  if (!counted) return 0;
  if (g_count_ptr == nullptr) return static_cast<int>(cudaErrorNotReady);
  *out = g_count_ptr;
  return 0;
}

// the graph being captured on `stream` and its current dependencies
int capture_point(cudaStream_t stream, cudaGraph_t* graph,
                  const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err =
      cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  }
  return 0;
}

int add_cond(cudaGraphNode_t* node, cudaGraph_t graph,
             const cudaGraphNode_t* deps, size_t n_deps,
             cudaGraphConditionalHandle handle, int type, cudaGraph_t* body) {
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      type == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t err =
      cudaGraphAddNode(node, graph, deps, nullptr, n_deps, &params);
#else
  cudaError_t err = cudaGraphAddNode(node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  *body = params.conditional.phGraph_out[0];
  return 0;
}

int deps_of(void** last, const cudaGraphNode_t** deps) {
  *deps = *last != nullptr ? reinterpret_cast<cudaGraphNode_t*>(last)
                           : nullptr;
  return *last != nullptr ? 1 : 0;
}

}  // namespace

extern "C" {

// outside any capture, before the first node: loads set_cond's module and
// takes g_count's address, so that no capture has to
int gst_cond_prepare(void) {
  cudaFuncAttributes attrs;
  cudaError_t err = cudaFuncGetAttributes(&attrs, set_cond);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetSymbolAddress(
      reinterpret_cast<void**>(&g_count_ptr), g_count));
}

// ---- the capture underway on a stream ----

// a handle of a conditional node to come in the capture's graph, whose
// value is `dflt` at every launch until a kernel sets it
int gst_capture_handle(void* stream, unsigned dflt,
                       unsigned long long* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  int rc = capture_point(static_cast<cudaStream_t>(stream), &graph, &deps,
                         &n_deps);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGraphConditionalHandleCreate(
      handle, graph, dflt, cudaGraphCondAssignDefault));
}

// captures set_cond(handle, flag) on the stream
int gst_capture_set(void* stream, unsigned long long handle, const bool* flag,
                    int counted) {
  unsigned long long* count;
  int rc = counter(counted, &count);
  if (rc != 0) return rc;
  set_cond<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(handle, flag,
                                                           count);
  return static_cast<int>(cudaGetLastError());
}

// a conditional node (type 0 IF, 1 WHILE) of `handle` after the capture's
// current dependencies; the capture goes on after it; *body its body
int gst_capture_cond(void* stream, unsigned long long handle, int type,
                     void** body) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  int rc = capture_point(st, &graph, &deps, &n_deps);
  if (rc != 0) return rc;
  cudaGraphNode_t node;
  cudaGraph_t inner;
  rc = add_cond(&node, graph, deps, n_deps, handle, type, &inner);
  if (rc != 0) return rc;
  *body = inner;
#if CUDART_VERSION >= 13000
  return static_cast<int>(cudaStreamUpdateCaptureDependencies(
      st, &node, nullptr, 1, cudaStreamSetCaptureDependencies));
#else
  return static_cast<int>(cudaStreamUpdateCaptureDependencies(
      st, &node, 1, cudaStreamSetCaptureDependencies));
#endif
}

// ---- a graph built node by node (a conditional node's body) ----

int gst_graph_handle(void* graph, unsigned dflt, unsigned long long* handle) {
  return static_cast<int>(cudaGraphConditionalHandleCreate(
      handle, static_cast<cudaGraph_t>(graph), dflt,
      cudaGraphCondAssignDefault));
}

// a node that runs a clone of `child`
int gst_graph_child(void* graph, void** last, void* child) {
  const cudaGraphNode_t* deps;
  const size_t n = deps_of(last, &deps);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddChildGraphNode(
      &node, static_cast<cudaGraph_t>(graph), deps, n,
      static_cast<cudaGraph_t>(child));
  if (err != cudaSuccess) return static_cast<int>(err);
  *last = node;
  return 0;
}

// a kernel node: set_cond(handle, flag)
int gst_graph_set(void* graph, void** last, unsigned long long handle,
                  const bool* flag, int counted) {
  unsigned long long* count;
  int rc = counter(counted, &count);
  if (rc != 0) return rc;
  cudaGraphConditionalHandle h = handle;
  void* args[] = {&h, &flag, &count};
  cudaKernelNodeParams params = {};
  params.func = reinterpret_cast<void*>(set_cond);
  params.gridDim = dim3(1);
  params.blockDim = dim3(1);
  params.kernelParams = args;
  const cudaGraphNode_t* deps;
  const size_t n = deps_of(last, &deps);
  cudaGraphNode_t node;
  cudaError_t err = cudaGraphAddKernelNode(
      &node, static_cast<cudaGraph_t>(graph), deps, n, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  *last = node;
  return 0;
}

// a conditional node (type 0 IF, 1 WHILE) of `handle`; *body its body
int gst_graph_cond(void* graph, void** last, unsigned long long handle,
                   int type, void** body) {
  const cudaGraphNode_t* deps;
  const size_t n = deps_of(last, &deps);
  cudaGraphNode_t node;
  cudaGraph_t inner;
  int rc = add_cond(&node, static_cast<cudaGraph_t>(graph), deps, n, handle,
                    type, &inner);
  if (rc != 0) return rc;
  *body = inner;
  *last = node;
  return 0;
}

// ---- the count of counted set_cond runs on the current device ----

int gst_cond_count(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_count, sizeof(*out)));
}

int gst_cond_count_reset(void) {
  const unsigned long long zero = 0;
  return static_cast<int>(cudaMemcpyToSymbol(g_count, &zero, sizeof(zero)));
}

}  // extern "C"
