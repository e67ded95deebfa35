// K1: ring-grid window gather, out[r, c, p] = cols[c, starts[r] + p].
//
// Replaces loam_velodyne_tpu/ops/pallas_grid.py:grid_windows
// (_grid_kernel). Pure data movement, bit-exact. Bound by bytes: at
// VLP-16 it moves 16 rings x 4 columns x 2048 floats (512 KB) in and
// out. One block per (ring, column) row; consecutive threads copy
// consecutive floats, so both the read (an unaligned but contiguous
// window) and the write coalesce. The start is clamped to
// [0, npad - P] exactly as a dynamic slice clamps it.
#include <cuda_runtime.h>

__global__ void grid_windows_kernel(const float* __restrict__ cols,
                                    const int* __restrict__ starts,
                                    float* __restrict__ out,
                                    int n_cols, int npad, int p_cap) {
    const int r = blockIdx.x;
    const int c = blockIdx.y;
    int s = starts[r];
    s = max(0, min(s, npad - p_cap));
    const float* src = cols + (size_t)c * npad + s;
    float* dst = out + ((size_t)r * n_cols + c) * p_cap;
    for (int p = threadIdx.x; p < p_cap; p += blockDim.x) {
        dst[p] = src[p];
    }
}

extern "C" int loam_grid_windows(const float* cols, const int* starts,
                                 float* out, int n_rings, int n_cols,
                                 int npad, int p_cap, cudaStream_t stream) {
    dim3 grid(n_rings, n_cols);
    grid_windows_kernel<<<grid, 256, 0, stream>>>(cols, starts, out, n_cols,
                                                  npad, p_cap);
    return (int)cudaGetLastError();
}
