// Conditional CUDA graphs assembled from captured pieces.
//
// PyTorch captures straight-line work into graphs (torch.cuda.CUDAGraph
// with keep_graph=True); this library strings those pieces together into one
// executable graph and puts some of them under IF conditional nodes (CUDA
// 12.4 or later), so a branch on a device flag costs no host round trip:
//
//   cg_add_child   appends a clone of a captured piece after the tail node;
//   cg_add_if      appends a one-thread kernel that sets a conditional
//                  handle from a device bool and the IF
//                  node it gates, and returns the node's body graph, into
//                  which pieces (and further IF nodes) are appended in turn.
//
// A graph is built once, instantiated once and launched on PyTorch's current
// stream once per replay. Nothing here synchronises.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

int add_after(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t* tail,
              cudaGraphNodeParams* params) {
  const size_t ndeps = *tail == nullptr ? 0 : 1;
  cudaError_t err = cudaGraphAddNode(node, graph, tail, ndeps, params);
  if (err == cudaSuccess) *tail = *node;
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int cg_graph_create(cudaGraph_t* out) { return static_cast<int>(cudaGraphCreate(out, 0)); }

int cg_graph_destroy(cudaGraph_t graph) { return static_cast<int>(cudaGraphDestroy(graph)); }

int cg_node_count(cudaGraph_t graph, size_t* count) {
  return static_cast<int>(cudaGraphGetNodes(graph, nullptr, count));
}

// A clone of `child` after *tail (nullptr: a root node); *tail becomes it.
int cg_add_child(cudaGraph_t graph, cudaGraph_t child, cudaGraphNode_t* tail) {
  cudaGraphNode_t node;
  const size_t ndeps = *tail == nullptr ? 0 : 1;
  cudaError_t err = cudaGraphAddChildGraphNode(&node, graph, tail, ndeps, child);
  if (err == cudaSuccess) *tail = node;
  return static_cast<int>(err);
}

// After *tail: a kernel setting a fresh handle to *pred, then the IF node
// on it; *body is the node's body graph, *tail the IF node.
int cg_add_if(cudaGraph_t graph, const void* pred, cudaGraphNode_t* tail, cudaGraph_t* body) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);

  const bool* pred_ptr = static_cast<const bool*>(pred);
  void* args[] = {&handle, &pred_ptr};
  cudaGraphNodeParams set{};
  set.type = cudaGraphNodeTypeKernel;
  set.kernel.func = reinterpret_cast<void*>(set_if_kernel);
  set.kernel.gridDim = dim3(1);
  set.kernel.blockDim = dim3(1);
  set.kernel.sharedMemBytes = 0;
  set.kernel.kernelParams = args;
  cudaGraphNode_t set_node;
  int rc = add_after(&set_node, graph, tail, &set);
  if (rc != 0) return rc;

  cudaGraphNodeParams cond{};
  cond.type = cudaGraphNodeTypeConditional;
  cond.conditional.handle = handle;
  cond.conditional.type = cudaGraphCondTypeIf;
  cond.conditional.size = 1;
  cudaGraphNode_t if_node;
  rc = add_after(&if_node, graph, tail, &cond);
  if (rc != 0) return rc;
  *body = cond.conditional.phGraph_out[0];
  return 0;
}

int cg_instantiate(cudaGraphExec_t* exec, cudaGraph_t graph) {
  return static_cast<int>(cudaGraphInstantiate(exec, graph, 0));
}

int cg_launch(cudaGraphExec_t exec, cudaStream_t stream) {
  return static_cast<int>(cudaGraphLaunch(exec, stream));
}

int cg_exec_destroy(cudaGraphExec_t exec) { return static_cast<int>(cudaGraphExecDestroy(exec)); }

int cg_runtime_version(int* version) { return static_cast<int>(cudaRuntimeGetVersion(version)); }

const char* cg_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
