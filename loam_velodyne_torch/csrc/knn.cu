// K4: exact top-5 per query against its group's window of the
// axis-sorted map cloud.
//
// Replaces loam_velodyne_tpu/ops/pallas_knn.py:grouped_window_knn
// (_knn_kernel). For group t, query g: the K = 5 smallest squared
// distances (difference form, (dx*dx + dy*dy) + dz*dz in float32 with
// -fmad=false) to the W window points, ascending, with their window
// columns; ties go to the lower column.
//
// Bound by the distance arithmetic (G x W per group, 16 or 32 groups
// of 128 x 1024 at VLP-16) and by the per-query insertion into the
// top-5 list. One block per group: the window (W x 3 floats, 12 KB at
// W = 1024) is staged once in shared memory and read by all 128 query
// threads as broadcasts; each thread keeps a sorted top-5 list in
// registers (K is a compile-time constant so the list unrolls), inserting
// with a strict '<' while scanning columns in ascending order, so the
// lower column wins a tie.
#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int K = 5;   // the mapping fits use 5 neighbours

__global__ void knn_kernel(const float* __restrict__ qg,
                           const float* __restrict__ win,
                           float* __restrict__ out_d2,
                           int* __restrict__ out_col, int g, int w) {
    extern __shared__ float s_win[];              // (W, 3)
    const int t = blockIdx.x;
    const float* wsrc = win + (size_t)t * w * 3;
    for (int i = threadIdx.x; i < 3 * w; i += blockDim.x) s_win[i] = wsrc[i];
    __syncthreads();

    for (int qi = threadIdx.x; qi < g; qi += blockDim.x) {
        const size_t qoff = ((size_t)t * g + qi);
        const float qx = qg[3 * qoff], qy = qg[3 * qoff + 1],
                    qz = qg[3 * qoff + 2];
        float bd[K];
        int bc[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
            bd[i] = CUDART_INF_F;
            bc[i] = 0;
        }
        for (int c = 0; c < w; ++c) {
            const float dx = qx - s_win[3 * c];
            const float dy = qy - s_win[3 * c + 1];
            const float dz = qz - s_win[3 * c + 2];
            const float d = dx * dx + dy * dy + dz * dz;
            if (d < bd[K - 1]) {
                bd[K - 1] = d;
                bc[K - 1] = c;
#pragma unroll
                for (int i = K - 1; i > 0; --i) {
                    if (bd[i] < bd[i - 1]) {
                        const float td = bd[i]; bd[i] = bd[i - 1]; bd[i - 1] = td;
                        const int tc = bc[i]; bc[i] = bc[i - 1]; bc[i - 1] = tc;
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
            out_d2[qoff * K + i] = bd[i];
            out_col[qoff * K + i] = bc[i];
        }
    }
}

extern "C" int loam_grouped_window_knn(const float* qg, const float* win,
                                       float* d2, int* col, int t, int g,
                                       int w, cudaStream_t stream) {
    if (t == 0 || g == 0) return 0;
    const size_t smem = (size_t)3 * w * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int threads = g < 128 ? ((g + 31) / 32) * 32 : 128;
    knn_kernel<<<t, threads, smem, stream>>>(qg, win, d2, col, g, w);
    return (int)cudaGetLastError();
}
