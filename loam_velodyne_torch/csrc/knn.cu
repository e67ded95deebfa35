// K4: exact top-5 per query against its group's window of the
// axis-sorted map cloud.
//
// Replaces loam_velodyne_tpu/ops/pallas_knn.py:grouped_window_knn
// (_knn_kernel). For group t, query g: the K = 5 smallest squared
// distances (difference form, (dx*dx + dy*dy) + dz*dz in float32 with
// -fmad=false) to the W window points, ascending, with their window
// columns; ties go to the lower column.
//
// What bounds it on an H100 (67 TFLOP/s f32, 3.35 TB/s): at VLP-16,
// 32 groups (surf; 16 for corner) of 128 queries x W = 1,024, 8
// operations per distance: 33.6 MFLOP (0.50 us; 0.25 us at T = 16)
// against 0.61 MB (0.18 us). Below one launch's latency; what costs
// time is the serial work per query (1,024 distances and top-5
// inserts), and with one block per group the card had 16-32 blocks.
//
// Design: the grid is (group) x (tiles of 8 queries); T = 32 gives 512
// blocks of 128 threads, T = 16 gives 256. A block stages its group's
// window once in shared memory as float4 rows (16 KB at W = 1,024).
// Each query has S = 16 lanes of one warp; lane s scans the columns
// s, s + S, s + 2S, ... in ascending order and keeps a sorted top-5 in
// registers (K is a compile-time constant, so the list unrolls),
// inserting with a strict '<' on the distance: its list is the 5
// lexicographically smallest (d, column) pairs of its columns. The S
// lists are merged by a butterfly of warp shuffles: each lane keeps the
// 5 least of its and its partner's list, compared lexicographically on
// (d, column), and sorts them; the slices are disjoint, so after
// log2(S) rounds every lane holds the 5 smallest pairs of the whole
// window in ascending order: the result of one sequential scan, bit for
// bit. ptxas (sm_90a, -O3): 34 registers,
// no spills.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {
constexpr int K = 5;       // the mapping fits use 5 neighbours
constexpr int kS = 16;     // lanes per query
constexpr int kTile = 8;   // queries per block: kS * kTile = 128 threads

__device__ __forceinline__ bool before(float d1, int c1, float d2, int c2) {
    return d1 < d2 || (d1 == d2 && c1 < c2);
}

// Puts entries a and b in lexicographic (d, column) order.
__device__ __forceinline__ void exchange(float* d, int* c, int a, int b) {
    if (before(d[b], c[b], d[a], c[a])) {
        const float td = d[a]; d[a] = d[b]; d[b] = td;
        const int tc = c[a]; c[a] = c[b]; c[b] = tc;
    }
}

__global__ void knn_kernel(const float* __restrict__ qg,
                           const float* __restrict__ win,
                           float* __restrict__ out_d2,
                           int* __restrict__ out_col, int g, int w) {
    extern __shared__ float4 s_win[];             // (W,) {x, y, z, 0}
    const int t = blockIdx.x;
    const float* wsrc = win + (size_t)t * w * 3;
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
        s_win[i] = make_float4(wsrc[3 * i], wsrc[3 * i + 1], wsrc[3 * i + 2],
                               0.f);
    }
    __syncthreads();

    const int lane = threadIdx.x % kS;
    const int qi = blockIdx.y * kTile + threadIdx.x / kS;
    // Lanes of a query past the group's end shadow its last query, so
    // that every lane takes part in the shuffles; they write nothing.
    const size_t qoff = (size_t)t * g + min(qi, g - 1);
    const float qx = qg[3 * qoff], qy = qg[3 * qoff + 1],
                qz = qg[3 * qoff + 2];
    float bd[K];
    int bc[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
        bd[i] = CUDART_INF_F;
        bc[i] = 0;
    }
    for (int c = lane; c < w; c += kS) {
        const float4 p = s_win[c];
        const float dx = qx - p.x;
        const float dy = qy - p.y;
        const float dz = qz - p.z;
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

    // Merge with the partner lane's list: entry i against the partner's
    // entry K-1-i keeps the K least of both sorted lists (the lower half
    // of a bitonic merge), then a 9-comparator network sorts them.
#pragma unroll
    for (int off = 1; off < kS; off <<= 1) {
        float od[K];
        int oc[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
            od[i] = __shfl_xor_sync(0xffffffffu, bd[i], off);
            oc[i] = __shfl_xor_sync(0xffffffffu, bc[i], off);
        }
#pragma unroll
        for (int i = 0; i < K; ++i) {
            if (before(od[K - 1 - i], oc[K - 1 - i], bd[i], bc[i])) {
                bd[i] = od[K - 1 - i];
                bc[i] = oc[K - 1 - i];
            }
        }
        exchange(bd, bc, 0, 1); exchange(bd, bc, 3, 4); exchange(bd, bc, 2, 4);
        exchange(bd, bc, 2, 3); exchange(bd, bc, 0, 3); exchange(bd, bc, 0, 2);
        exchange(bd, bc, 1, 4); exchange(bd, bc, 1, 3); exchange(bd, bc, 1, 2);
    }

    if (lane == 0 && qi < g) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
            out_d2[qoff * K + i] = bd[i];
            out_col[qoff * K + i] = bc[i];
        }
    }
}
}  // namespace

extern "C" int loam_grouped_window_knn(const float* qg, const float* win,
                                       float* d2, int* col, int t, int g,
                                       int w, cudaStream_t stream) {
    if (t == 0 || g == 0) return 0;
    const size_t smem = sizeof(float4) * w;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(t, (g + kTile - 1) / kTile);
    knn_kernel<<<grid, kS * kTile, smem, stream>>>(qg, win, d2, col, g, w);
    return (int)cudaGetLastError();
}
