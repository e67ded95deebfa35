// K3: fused odometry correspondence search.
//
// Replaces loam_velodyne_tpu/ops/pallas_corresp.py:_corresp_call
// (_corresp_kernel). Two passes over the reference cloud, whose masked
// and padding rows the caller has moved to the 1e8 sentinel with ring
// 1<<20:
//   pass 1: the nearest point j and its ring;
//   pass 2, corner mode: the nearest point with 0 < |dring| <= bracket
//           (-> l); surf mode: the nearest point on j's ring other than
//           j (-> l) and the nearest with 0 < |dring| <= bracket (-> m).
// Ties go to the first column. Distances are the difference form
// (dx*dx + dy*dy) + dz*dz in float32, compiled with -fmad=false so they
// round exactly as the plain PyTorch version rounds them. Raw results
// are returned; the caller maps d >= 1e12 to (0, inf).
//
// Bound by arithmetic latency of the scan (Q x M distances, twice),
// with few queries (256 corner / 512 surf at VLP-16): one thread per
// query would give the card 2-4 blocks. So a block takes 32 queries
// (one per lane) and splits the reference columns into 8 contiguous
// ranges, one per warp; all lanes of a warp read the same reference
// point (a broadcast load from L1). The 8 partial minima are combined
// in warp order with a strict '<', which keeps first-column ties.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {
constexpr int kQ = 32;     // queries per block (one per lane)
constexpr int kW = 8;      // warps per block, each scans 1/kW of the cloud
}

__global__ void corresp_kernel(const float* __restrict__ q,
                               const float* __restrict__ ref,
                               const int* __restrict__ ring,
                               int* __restrict__ out_j,
                               float* __restrict__ out_dj,
                               int* __restrict__ out_l,
                               float* __restrict__ out_dl,
                               int* __restrict__ out_m,
                               float* __restrict__ out_dm,
                               int nq, int m, float bracket, int surf_mode) {
    __shared__ float s_d[kW][kQ];
    __shared__ int s_c[kW][kQ];
    __shared__ int s_r[kW][kQ];
    __shared__ float s_d2[kW][kQ];
    __shared__ int s_c2[kW][kQ];
    __shared__ int s_j[kQ];
    __shared__ int s_rj[kQ];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int qi = blockIdx.x * kQ + lane;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (qi < nq) {
        qx = q[3 * qi];
        qy = q[3 * qi + 1];
        qz = q[3 * qi + 2];
    }
    const int per = (m + kW - 1) / kW;
    const int c0 = min(m, warp * per);
    const int c1 = min(m, c0 + per);

    // ---- pass 1: nearest point and its ring ----
    float bd = CUDART_INF_F;
    int bc = 0, br = 0;
    for (int c = c0; c < c1; ++c) {
        const float dx = qx - ref[3 * c];
        const float dy = qy - ref[3 * c + 1];
        const float dz = qz - ref[3 * c + 2];
        const float d = dx * dx + dy * dy + dz * dz;
        if (d < bd) {
            bd = d;
            bc = c;
            br = ring[c];
        }
    }
    s_d[warp][lane] = bd;
    s_c[warp][lane] = bc;
    s_r[warp][lane] = br;
    __syncthreads();
    if (warp == 0) {
        float d = s_d[0][lane];
        int c = s_c[0][lane], r = s_r[0][lane];
        for (int w = 1; w < kW; ++w) {
            if (s_d[w][lane] < d) {
                d = s_d[w][lane];
                c = s_c[w][lane];
                r = s_r[w][lane];
            }
        }
        s_j[lane] = c;
        s_rj[lane] = r;
        if (qi < nq) {
            out_j[qi] = c;
            out_dj[qi] = d;
        }
    }
    __syncthreads();

    // ---- pass 2: ring-bracket minima against ring(j) ----
    const int j = s_j[lane];
    const int ring_j = s_rj[lane];
    float bd_l = CUDART_INF_F, bd_m = CUDART_INF_F;
    int bc_l = 0, bc_m = 0;
    for (int c = c0; c < c1; ++c) {
        const int dring = ring[c] - ring_j;
        const bool in_bracket = dring != 0 && (float)abs(dring) <= bracket;
        const bool same = surf_mode && dring == 0 && c != j;
        if (!in_bracket && !same) continue;
        const float dx = qx - ref[3 * c];
        const float dy = qy - ref[3 * c + 1];
        const float dz = qz - ref[3 * c + 2];
        const float d = dx * dx + dy * dy + dz * dz;
        if (surf_mode) {
            if (same && d < bd_l) { bd_l = d; bc_l = c; }
            if (in_bracket && d < bd_m) { bd_m = d; bc_m = c; }
        } else if (d < bd_l) {
            bd_l = d;
            bc_l = c;
        }
    }
    s_d[warp][lane] = bd_l;
    s_c[warp][lane] = bc_l;
    s_d2[warp][lane] = bd_m;
    s_c2[warp][lane] = bc_m;
    __syncthreads();
    if (warp == 0 && qi < nq) {
        float dl = s_d[0][lane], dm = s_d2[0][lane];
        int cl = s_c[0][lane], cm = s_c2[0][lane];
        for (int w = 1; w < kW; ++w) {
            if (s_d[w][lane] < dl) { dl = s_d[w][lane]; cl = s_c[w][lane]; }
            if (s_d2[w][lane] < dm) { dm = s_d2[w][lane]; cm = s_c2[w][lane]; }
        }
        out_l[qi] = cl;
        out_dl[qi] = dl;
        out_m[qi] = cm;
        out_dm[qi] = dm;
    }
}

extern "C" int loam_corresp(const float* q, const float* ref, const int* ring,
                            int* j, float* dj, int* l, float* dl, int* mm,
                            float* dm, int nq, int m, float bracket,
                            int surf_mode, cudaStream_t stream) {
    const int blocks = (nq + kQ - 1) / kQ;
    if (blocks > 0) {
        corresp_kernel<<<blocks, kQ * kW, 0, stream>>>(
            q, ref, ring, j, dj, l, dl, mm, dm, nq, m, bracket, surf_mode);
    }
    return (int)cudaGetLastError();
}
