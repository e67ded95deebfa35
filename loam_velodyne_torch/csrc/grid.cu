// K1: ring-grid window gather, out[r, c, p] = cols[c, starts[r] + p].
//
// Replaces loam_velodyne_tpu/ops/pallas_grid.py:grid_windows
// (_grid_kernel). Pure data movement, bit-exact. The start is clamped to
// [0, npad - P] exactly as a dynamic slice clamps it.
//
// Lane form (the batched replay): B lanes of (C, npad) columns and R
// starts each, out (B, R, C, P). The grid's x axis runs over all B * R
// rows; a row's lane picks its own columns, and its start is clamped
// within its own lane before the lane's offset is added, so no start
// can reach another lane. The single-lane call passes B = 1.
//
// What bounds it on the H100: its bytes (16 rings x 4 columns x 2048
// floats at VLP-16, 512 KB out and at most as much in) take 0.3 us at
// 3.35 TB/s, less than a launch, so the latency of its memory round
// trips and the launch itself set its time. The design puts every load
// in flight at once: a grid of (R, C, ceil(P / 1024)) blocks of 256
// threads, each thread issuing its 4 loads (p = t, t + 256, ... within
// the block's 1,024 floats, coalesced across the warp) before any of its
// stores, so the copy waits on memory once and not once per trip. A
// ragged P is masked at the tail.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int PER_BLOCK = THREADS * PER_THREAD;

__global__ void __launch_bounds__(THREADS)
grid_windows_kernel(const float* __restrict__ cols,
                    const int* __restrict__ starts, float* __restrict__ out,
                    int n_rings, int n_cols, int npad, int p_cap) {
    const int r = blockIdx.x;                  // row of all lanes' rows
    const int lane = r / n_rings;
    const int c = blockIdx.y;
    const int s = max(0, min(starts[r], npad - p_cap));
    const float* src = cols + ((size_t)lane * n_cols + c) * npad + s;
    float* dst = out + ((size_t)r * n_cols + c) * p_cap;
    const int p0 = blockIdx.z * PER_BLOCK + threadIdx.x;
    float v[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int p = p0 + i * THREADS;
        v[i] = p < p_cap ? src[p] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
        const int p = p0 + i * THREADS;
        if (p < p_cap) dst[p] = v[i];
    }
}

}  // namespace

extern "C" int loam_grid_windows(const float* cols, const int* starts,
                                 float* out, int lanes, int n_rings,
                                 int n_cols, int npad, int p_cap,
                                 cudaStream_t stream) {
    if (lanes == 0 || n_rings == 0) return 0;
    dim3 grid(lanes * n_rings, n_cols, (p_cap + PER_BLOCK - 1) / PER_BLOCK);
    grid_windows_kernel<<<grid, THREADS, 0, stream>>>(cols, starts, out,
                                                      n_rings, n_cols, npad,
                                                      p_cap);
    return (int)cudaGetLastError();
}
