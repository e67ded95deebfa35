// The launch floor: an empty kernel, launched through the same ctypes
// path as the kernels that replace the TPU's, so that the least time any
// launch takes on the card can be measured beside them
// (chip_smoke.py's kernel phase). Not a kernel of the pipeline: nothing
// in the engine calls it.
#include <cuda_runtime.h>

namespace {

__global__ void noop_kernel() {}

}  // namespace

extern "C" int loam_noop(cudaStream_t stream) {
    noop_kernel<<<1, 32, 0, stream>>>();
    return (int)cudaGetLastError();
}
