// CUDA-graph conditional (IF) nodes inside a stream capture: the GN
// loops' early exit on the card.
//
// Counterpart of the JAX package's lax.while_loop over the GN's refresh
// phases and iterations (loam_velodyne_tpu/models/odometry.py,
// models/mapping.py), which XLA runs on the device and leaves at the
// converged phase. Not a kernel that replaces a TPU kernel: the graph
// layer (models/conditional.py) brackets one phase or iteration of the
// captured GN with these two entry points, and on replay the card skips
// the bracketed work when the predicate, computed on the card, is false.
// Nothing is read back to the host.
//
// loam_if_begin, on a stream that is being captured:
//   1. a conditional handle in the graph being captured (reset to 0 at
//      each launch of the graph);
//   2. a one-thread kernel that sets the handle from the predicate, a
//      bool in device memory;
//   3. an IF node after it, which becomes the stream's only dependency,
//      so the work captured next on the stream runs after the node;
//   4. the capture of the node's body begins on `body`, a second stream.
// loam_if_end ends the body's capture and gives its node count.
//
// Written for the CUDA 12.x runtime API (12.4 or later: conditional
// nodes, cudaGraphAddNode, cudaStreamBeginCaptureToGraph).
#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* __restrict__ pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int loam_if_begin(const void* pred, cudaStream_t body,
                             cudaStream_t stream) {
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr,
                                               &graph, &deps, &n_deps);
    if (err != cudaSuccess) return (int)err;
    if (status != cudaStreamCaptureStatusActive)
        return (int)cudaErrorStreamCaptureImplicit;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                           cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return (int)err;
    set_if_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // The dependencies now end at the kernel that sets the handle.
    err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                                   &n_deps);
    if (err != cudaSuccess) return (int)err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                              cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaStreamBeginCaptureToGraph(
        body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
        cudaStreamCaptureModeGlobal);
}

extern "C" int loam_if_end(size_t* nodes, cudaStream_t body) {
    cudaGraph_t graph;
    cudaError_t err = cudaStreamEndCapture(body, &graph);
    if (err != cudaSuccess) return (int)err;
    *nodes = 0;
    return (int)cudaGraphGetNodes(graph, nullptr, nodes);
}
