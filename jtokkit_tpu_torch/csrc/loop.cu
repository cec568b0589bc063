// Device-side loops for CUDA graphs: a WHILE conditional node whose body is
// a graph captured by PyTorch, for Hopper (sm_90a).
//
// Counterpart of the merge loops' lax.while_loop in the JAX package
// (jtokkit_tpu/ops/merge.py merge_rows_t3 and merge_rows,
// jtokkit_tpu/ops/merge_exact.py's phases). It is not a port of a TPU
// kernel: XLA compiles a while loop into the program, and on the card the
// counterpart is a conditional node of the graph (CUDA 12.4 and later), so a
// loop of merge rounds runs to its end with no read by the host.
//
// Protocol (wrapped by jtokkit_tpu_torch/ops/loop.py::device_while), while a
// stream is capturing the outer graph:
//   1. jt_loop_begin makes a conditional handle on the graph being captured.
//   2. jt_loop_step(inc = 0) is captured on that stream: its one thread sets
//      the handle from the loop's first test and zeroes the round counter.
//   3. The body (one round, the state written back in place, the next test
//      and jt_loop_step(inc = 1), which counts the round and sets the handle
//      again) is captured by PyTorch as a graph of its own, on another
//      stream and into its own memory pool.
//   4. jt_loop_end adds a WHILE node on that handle after the captured work,
//      puts a child-graph node holding the body into the node's body graph,
//      and makes the node the stream's only capture dependency, so what the
//      stream captures next runs after the loop.
// The node runs its body while the handle is nonzero; the last jt_loop_step
// of the body decides whether it runs again.
//
// Bound: one thread reads one byte and writes one word per round, about 2 us
// of launch latency inside the graph; the rounds themselves are PyTorch's
// kernels. What the node saves is the host: a read of the loop's test (a
// device synchronisation, 10-30 us of host time and an idle card) per round.

#include <cuda_runtime.h>

namespace {

__global__ void loop_step_kernel(cudaGraphConditionalHandle handle,
                                 const bool* more, int* rounds, int inc) {
  if (inc) {
    *rounds += 1;
  } else {
    *rounds = 0;
  }
  cudaGraphSetConditional(handle, *more ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" {

// CUDA runtime version this library was built against.
int jt_loop_runtime_version() { return CUDART_VERSION; }

// Load the step kernel now, before any capture needs it.
int jt_loop_init(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, loop_step_kernel));
}

// A new conditional handle of the graph that `stream` is capturing.
int jt_loop_begin(void* stream, unsigned long long* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &graph,
                                 &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  *handle = h;
  return static_cast<int>(err);
}

// One launch of the step kernel on `stream` (captured where the stream is
// capturing): inc = 0 zeroes *rounds, inc = 1 adds one; either way the
// handle takes *more.
int jt_loop_step(unsigned long long handle, const void* more, void* rounds,
                 int inc, void* stream) {
  loop_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const bool*>(more), static_cast<int*>(rounds), inc);
  return static_cast<int>(cudaGetLastError());
}

// Add the WHILE node of `handle` to the graph `stream` is capturing, after
// everything captured so far, with `body` (a graph; cloned) as its body,
// and make it the stream's capture dependency.
int jt_loop_end(void* stream, unsigned long long handle, void* body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0, static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return static_cast<int>(err);
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  return static_cast<int>(err);
}

}  // extern "C"
