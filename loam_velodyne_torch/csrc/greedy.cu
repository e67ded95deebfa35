// K2: greedy suppressed feature pick, one (ring, region) window per row.
//
// Replaces loam_velodyne_tpu/ops/pallas_greedy.py:greedy_pick_rows
// (_greedy_kernel). For k = 0 .. K-1, in order: candidate
// idx = cand_idx[row, k] is eligible if cand_ok, not yet picked, its
// curvature passes the threshold (> for corners, < for flats) and the
// row's quota is not reached; an eligible pick is labelled (corners: 2
// for the first sharp_quota picks, 1 after; flats: -1) and columns
// [idx - left[idx], idx + right[idx]] are marked picked.
//
// Bound by the latency of the sequential chain (96 corner or 64 flat
// steps per row), not by bytes or arithmetic: the row's state (W = 384
// columns at VLP-16) lives in shared memory, one block per row, so the
// 96 rows run in parallel on separate SMs. Per step, thread 0 tests
// eligibility and labels the pick; then all threads mark the span.
// Two barriers per step keep the chain in order.
#include <cuda_runtime.h>

__global__ void greedy_pick_kernel(const float* __restrict__ curv,
                                   const int* __restrict__ cand_idx,
                                   const bool* __restrict__ cand_ok,
                                   const bool* __restrict__ picked0,
                                   const int* __restrict__ left,
                                   const int* __restrict__ right,
                                   int* __restrict__ labels,
                                   bool* __restrict__ marks,
                                   int w, int k_cap,
                                   float threshold, int quota,
                                   int sharp_quota, int is_corner) {
    extern __shared__ int smem[];
    float* s_curv = reinterpret_cast<float*>(smem);
    int* s_left = smem + w;
    int* s_right = s_left + w;
    int* s_label = s_right + w;
    int* s_picked = s_label + w;
    __shared__ int s_lo, s_hi;

    const int row = blockIdx.x;
    const size_t off = (size_t)row * w;
    for (int c = threadIdx.x; c < w; c += blockDim.x) {
        s_curv[c] = curv[off + c];
        s_left[c] = left[off + c];
        s_right[c] = right[off + c];
        s_label[c] = 0;
        s_picked[c] = picked0[off + c] ? 1 : 0;
    }
    __syncthreads();

    int n_picked = 0;                       // meaningful in thread 0 only
    for (int k = 0; k < k_cap; ++k) {
        if (threadIdx.x == 0) {
            const int idx = cand_idx[(size_t)row * k_cap + k];
            int lo = 1, hi = 0;             // empty span
            if (idx >= 0 && idx < w) {
                const float c_i = s_curv[idx];
                const bool passes = is_corner ? (c_i > threshold)
                                              : (c_i < threshold);
                const bool eligible = cand_ok[(size_t)row * k_cap + k]
                                      && s_picked[idx] == 0 && passes
                                      && n_picked < quota;
                if (eligible) {
                    n_picked += 1;
                    s_label[idx] = is_corner
                        ? (n_picked <= sharp_quota ? 2 : 1) : -1;
                    lo = idx - s_left[idx];
                    hi = idx + s_right[idx];
                }
            }
            s_lo = lo;
            s_hi = hi;
        }
        __syncthreads();
        const int lo = s_lo, hi = s_hi;
        for (int c = threadIdx.x; c < w; c += blockDim.x) {
            if (c >= lo && c <= hi) s_picked[c] = 1;
        }
        __syncthreads();
    }

    for (int c = threadIdx.x; c < w; c += blockDim.x) {
        labels[off + c] = s_label[c];
        marks[off + c] = s_picked[c] != 0 && !picked0[off + c];
    }
}

extern "C" int loam_greedy_pick_rows(const float* curv, const int* cand_idx,
                                     const bool* cand_ok, const bool* picked0,
                                     const int* left, const int* right,
                                     int* labels, bool* marks, int rows,
                                     int w, int k_cap,
                                     float threshold, int quota,
                                     int sharp_quota, int is_corner,
                                     cudaStream_t stream) {
    const size_t smem = (size_t)5 * w * sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            greedy_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    greedy_pick_kernel<<<rows, 128, smem, stream>>>(
        curv, cand_idx, cand_ok, picked0, left, right, labels, marks, w,
        k_cap, threshold, quota, sharp_quota, is_corner);
    return (int)cudaGetLastError();
}
