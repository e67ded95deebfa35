// K3: fused odometry correspondence search.
//
// Replaces loam_velodyne_tpu/ops/pallas_corresp.py:_corresp_call
// (_corresp_kernel). Two passes over the reference cloud, masked rows
// skipped:
//   pass 1: the nearest point j;
//   pass 2, corner mode: the nearest point with 0 < |dring| <= bracket
//           from ring[j] (-> l); surf mode: the nearest point on j's ring
//           other than j (-> l) and the nearest with 0 < |dring| <=
//           bracket (-> m).
// Ties go to the first column. Distances are the difference form
// (dx*dx + dy*dy) + dz*dz in float32, compiled with -fmad=false so they
// round exactly as the plain PyTorch version rounds them. A query with
// no candidate, or with one at d >= 1e12, gets (0, inf).
//
// What bounds it on an H100 (67 TFLOP/s f32, 3.35 TB/s): at VLP-16 the
// surf search is 384 queries x 8,192 rows, two passes of 8 operations
// per distance, 50.3 MFLOP (0.75 us) against 0.15 MB (0.05 us); corner
// is 256 x 1,920, 7.9 MFLOP (0.12 us). Both are below one launch's
// latency, and with so few queries a block per query tile alone gives
// the card 4-6 blocks for 132 SMs. -fmad=false also makes the 8
// operations 8 instructions, where the peak counts an FMA as two.
//
// Design: the grid is (reference chunks) x (query tiles of 64, one
// query per thread). The chunk length is picked so that the grid holds
// about eight blocks per SM, with chunks of at least 32 rows: surf gets
// 128 chunks of 64 rows x 6 tiles = 768 blocks, corner 60 chunks of 32
// rows x 4 tiles = 240 blocks. A
// block stages its chunk once in shared memory as float4 {x, y, z,
// ring bits}; a masked row is staged with x = NaN, so its distance is
// NaN and never passes the strict `d < best` test. Each thread scans the
// chunk in column order and keeps the first minimum, then publishes it
// as one 64-bit key, (float bits of d) << 32 | column, with atomicMin:
// for d >= +0 the unsigned order of the float bits is the numeric order,
// and the low word makes the lower column win a tie, so the minimum over
// all chunks is the plain version's first-column argmin, whatever order
// the blocks run in. Keys start at all ones ("no candidate"). Pass 2 is
// a second launch that reads j from pass 1's key; a third unpacks the
// keys. One call: a memset and three kernels. ptxas (sm_90a, -O3):
// 26-32 registers per kernel, no spills.
//
// Lane form (the batched replay): B lanes of (Q, 3) queries against
// their own (M, 3) reference, ring and mask. A lane's queries see only
// its own reference, so lanes cannot fold into Q: the grid gains a lane
// axis (z), every pointer moves to its lane, and the keys are per
// (lane, query), laid out (B, 3, Q). The chunk length is picked for
// about eight blocks per SM over all lanes: at B = 8, corner 30 chunks
// of 64 rows x 4 tiles x 8 lanes = 960 blocks, surf 22 chunks of 384
// rows x 6 tiles x 8 lanes = 1,056. The single-lane call passes B = 1.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {
typedef unsigned long long Key;
constexpr Key kNone = ~0ull;       // no candidate; above every real key
constexpr int kTile = 64;          // queries per block, one per thread
constexpr int kTargetBlocks = 1056; // eight blocks per SM of an H100
constexpr int kMaxChunk = 2048;    // rows per block: 32 KB of float4
constexpr float kValidD2 = 1e12f;  // every real match is closer than this

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float4 p) {
    const float dx = qx - p.x;
    const float dy = qy - p.y;
    const float dz = qz - p.z;
    return dx * dx + dy * dy + dz * dz;
}

__device__ __forceinline__ Key pack(float d, int col) {
    return ((Key)__float_as_uint(d) << 32) | (unsigned)col;
}

// Rows [c0, c0 + n) of the reference as float4 {x, y, z, ring bits};
// masked rows get x = NaN.
__device__ __forceinline__ void stage(float4* s, const float* ref,
                                      const int* ring,
                                      const unsigned char* mask, int c0,
                                      int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int c = c0 + i;
        s[i] = make_float4(mask[c] ? ref[3 * c] : CUDART_NAN_F,
                           ref[3 * c + 1], ref[3 * c + 2],
                           __int_as_float(ring[c]));
    }
}

__global__ void nearest_kernel(const float* __restrict__ q,
                               const float* __restrict__ ref,
                               const int* __restrict__ ring,
                               const unsigned char* __restrict__ mask,
                               Key* __restrict__ key_j, int nq, int m,
                               int chunk) {
    extern __shared__ float4 s_ref[];
    const size_t lane = blockIdx.z;
    q += lane * 3 * nq;
    ref += lane * 3 * m;
    ring += lane * m;
    mask += lane * m;
    key_j += lane * 3 * nq;
    const int c0 = blockIdx.x * chunk;
    const int n = min(chunk, m - c0);
    stage(s_ref, ref, ring, mask, c0, n);
    __syncthreads();
    const int qi = blockIdx.y * kTile + threadIdx.x;
    if (qi >= nq) return;
    const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
    float bd = CUDART_INF_F;
    int bc = -1;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
        const float d = sq_dist(qx, qy, qz, s_ref[i]);
        if (d < bd) {
            bd = d;
            bc = i;
        }
    }
    if (bc >= 0) atomicMin(&key_j[qi], pack(bd, c0 + bc));
}

template <bool kSurf>
__global__ void bracket_kernel(const float* __restrict__ q,
                               const float* __restrict__ ref,
                               const int* __restrict__ ring,
                               const unsigned char* __restrict__ mask,
                               Key* __restrict__ keys, int nq, int m,
                               int chunk, float bracket) {
    extern __shared__ float4 s_ref[];
    const size_t lane = blockIdx.z;
    q += lane * 3 * nq;
    ref += lane * 3 * m;
    ring += lane * m;
    mask += lane * m;
    keys += lane * 3 * nq;
    const int c0 = blockIdx.x * chunk;
    const int n = min(chunk, m - c0);
    stage(s_ref, ref, ring, mask, c0, n);
    __syncthreads();
    const int qi = blockIdx.y * kTile + threadIdx.x;
    if (qi >= nq) return;
    const Key kj = keys[qi];
    if (kj == kNone) return;                     // no j: no l, no m
    const int j = (int)(unsigned)kj;
    const int ring_j = ring[j];
    const float qx = q[3 * qi], qy = q[3 * qi + 1], qz = q[3 * qi + 2];
    float bd_l = CUDART_INF_F, bd_m = CUDART_INF_F;
    int bc_l = -1, bc_m = -1;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
        const float4 p = s_ref[i];
        const int dring = __float_as_int(p.w) - ring_j;
        const bool in_bracket = dring != 0 && (float)abs(dring) <= bracket;
        // corner: l is the bracket's nearest; surf: l is the same
        // ring's nearest other than j, m the bracket's.
        const bool to_l = kSurf ? (dring == 0 && c0 + i != j) : in_bracket;
        const bool to_m = kSurf && in_bracket;
        if (!to_l && !to_m) continue;
        const float d = sq_dist(qx, qy, qz, p);
        if (to_l && d < bd_l) {
            bd_l = d;
            bc_l = i;
        }
        if (to_m && d < bd_m) {
            bd_m = d;
            bc_m = i;
        }
    }
    if (bc_l >= 0) atomicMin(&keys[nq + qi], pack(bd_l, c0 + bc_l));
    if (bc_m >= 0) atomicMin(&keys[2 * nq + qi], pack(bd_m, c0 + bc_m));
}

__device__ __forceinline__ void unpack(Key key, int* idx, float* d) {
    const float dv = __uint_as_float((unsigned)(key >> 32));
    const bool real = key != kNone && dv < kValidD2;
    *idx = real ? (int)(unsigned)key : 0;
    *d = real ? dv : CUDART_INF_F;
}

__global__ void unpack_kernel(const Key* __restrict__ keys,
                              int* __restrict__ j, float* __restrict__ dj,
                              int* __restrict__ l, float* __restrict__ dl,
                              int* __restrict__ mm, float* __restrict__ dm,
                              int nq, int lanes) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;   // (lane, query)
    if (t >= lanes * nq) return;
    const int lane = t / nq, qi = t - lane * nq;
    const Key* k = keys + (size_t)lane * 3 * nq;
    unpack(k[qi], j + t, dj + t);
    unpack(k[nq + qi], l + t, dl + t);
    unpack(k[2 * nq + qi], mm + t, dm + t);
}
}  // namespace

// keys: scratch of lanes * 3 * nq 64-bit words (each lane's j, l, m
// keys); the outputs are (lanes, nq). The single-lane call passes
// lanes = 1.
extern "C" int loam_corresp(const float* q, const float* ref, const int* ring,
                            const unsigned char* mask, Key* keys, int* j,
                            float* dj, int* l, float* dl, int* mm, float* dm,
                            int lanes, int nq, int m, float bracket,
                            int surf_mode, cudaStream_t stream) {
    if (nq == 0 || lanes == 0) return 0;
    cudaError_t e = cudaMemsetAsync(keys, 0xFF,
                                    sizeof(Key) * 3 * nq * (size_t)lanes,
                                    stream);
    if (e != cudaSuccess) return (int)e;
    if (m > 0) {
        const int tiles = (nq + kTile - 1) / kTile;
        const int want = (kTargetBlocks + tiles * lanes - 1) / (tiles * lanes);
        int chunk = ((m + want - 1) / want + 31) / 32 * 32;
        if (chunk > kMaxChunk) chunk = kMaxChunk;
        const dim3 grid((m + chunk - 1) / chunk, tiles, lanes);
        const size_t smem = sizeof(float4) * chunk;
        nearest_kernel<<<grid, kTile, smem, stream>>>(q, ref, ring, mask, keys,
                                                      nq, m, chunk);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        if (surf_mode) {
            bracket_kernel<true><<<grid, kTile, smem, stream>>>(
                q, ref, ring, mask, keys, nq, m, chunk, bracket);
        } else {
            bracket_kernel<false><<<grid, kTile, smem, stream>>>(
                q, ref, ring, mask, keys, nq, m, chunk, bracket);
        }
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    unpack_kernel<<<(lanes * nq + 255) / 256, 256, 0, stream>>>(
        keys, j, dj, l, dl, mm, dm, nq, lanes);
    return (int)cudaGetLastError();
}
