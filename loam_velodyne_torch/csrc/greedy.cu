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
// What bounds it on the H100: a chain of K dependent steps per row (96
// corner or 64 flat steps at VLP-16), not bytes (a row is ~3 KB) or
// arithmetic. The design keeps only the truly sequential part inside
// the chain:
// - One warp per row, one row per block of 32 threads: the 96 (VLP-16)
//   or 384 (HDL-64E) rows spread over the 132 SMs, at most 3 warps an
//   SM, each on a scheduler of its own; more rows per block would only
//   crowd them onto fewer SMs. No barrier but the warp's own.
// - Before the chain, lane l loads and tests candidates k = l, l + 32,
//   ... all at once: idx, cand_ok, the range and threshold tests and the
//   span [idx - left, idx + right] clamped to the row, packed into one
//   32-bit register per candidate (10-bit idx, lo, hi and a usable bit).
// - The row's picked flags are bits: lane l owns the word of columns
//   [32l, 32l + 32), built from picked0 by ballots (W <= 1024).
// - The packed candidates go to shared memory, and the chain is a loop
//   over groups of 8 steps whose body is unrolled, so that its code
//   stays small: unrolled over all K steps, the chain ran slower, its
//   straight-line code fetched anew at each launch. A group reads its 8
//   candidates (one broadcast read each, none depending on the state);
//   step k fetches the word that owns idx from its lane by one shuffle,
//   tests the bit, and every lane ORs in its share of the span,
//   branch-free. The pick is kept as a warp-uniform bit per candidate;
//   labels are made from those bits after the chain. Once the quota is
//   full, or past the row's last usable candidate, nothing can change,
//   so the chain stops at the end of that group: on real sweeps few
//   points pass the corner threshold, and corner rows run out of usable
//   candidates long before their quota fills.
// Outputs: labels staged in shared memory (zeroed, the picks' labels
// scattered, a later repeat of the same column winning as in the plain
// loop) and stored coalesced; marks = picked & ~picked0 from the words.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_W = 1024;            // one 32-bit word per lane
constexpr int MAX_ROUNDS = 8;          // candidates k < 32 * MAX_ROUNDS
constexpr unsigned FIELD = 1023u;      // 10-bit column fields
constexpr unsigned USABLE = 1u << 30;
constexpr unsigned NO_SPAN = FIELD << 10;   // lo = 1023 > hi = 0

// The bits of the word of columns [base, base + 32) that the packed
// span [lo, hi] covers.
__device__ __forceinline__ unsigned span_bits(unsigned v, int base) {
    const int a = (int)((v >> 10) & FIELD) - base;
    const int e = (int)((v >> 20) & FIELD) - base;
    const unsigned from = FULL << min(max(a, 0), 31);
    const unsigned to = FULL >> (31 - min(max(e, 0), 31));
    return (a <= e && e >= 0 && a <= 31) ? (from & to) : 0u;
}

template <int ROUNDS>
__global__ void __launch_bounds__(32)
greedy_pick_kernel(const float* __restrict__ curv,
                   const int* __restrict__ cand_idx,
                   const bool* __restrict__ cand_ok,
                   const bool* __restrict__ picked0,
                   const int* __restrict__ left,
                   const int* __restrict__ right,
                   int* __restrict__ labels, bool* __restrict__ marks,
                   int w, int k_cap, float threshold, int quota,
                   int sharp_quota, int is_corner) {
    extern __shared__ int s_label[];       // the row's labels, w ints
    __shared__ unsigned s_cand[32 * ROUNDS];   // packed candidates
    __shared__ unsigned char s_pick[4 * ROUNDS];   // picks, 8 steps a byte
    const int lane = threadIdx.x;
    const size_t off = (size_t)blockIdx.x * w;
    const size_t coff = (size_t)blockIdx.x * k_cap;

    // Every load of the row is issued before any is used.
    int idx[ROUNDS];
    bool ok[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int k = 32 * r + lane;
        idx[r] = k < k_cap ? cand_idx[coff + k] : -1;
        ok[r] = k < k_cap ? cand_ok[coff + k] : false;
    }
    bool p0[MAX_W / 32];
#pragma unroll
    for (int i = 0; i < MAX_W / 32; ++i) {
        const int c = 32 * i + lane;
        p0[i] = c < w ? picked0[off + c] : false;
    }
    unsigned cand[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int i = idx[r];
        const bool in = ok[r] && i >= 0 && i < w;
        const float c = in ? curv[off + i] : 0.0f;
        const long long lo = in ? (long long)i - left[off + i] : 1;
        const long long hi = in ? (long long)i + right[off + i] : 0;
        const bool passes = is_corner ? (c > threshold) : (c < threshold);
        const long long a = lo > 0 ? lo : 0;
        const long long e = hi < w - 1 ? hi : w - 1;
        const unsigned span = a <= e ? ((unsigned)a << 10 | (unsigned)e << 20)
                                     : NO_SPAN;
        cand[r] = in && passes ? ((unsigned)i | span | USABLE) : 0u;
    }
    unsigned word = 0;
#pragma unroll
    for (int i = 0; i < MAX_W / 32; ++i) {
        const unsigned b = __ballot_sync(FULL, p0[i]);
        word = lane == i ? b : word;
    }
    const unsigned word0 = word;
    int last = -1;                         // the last usable candidate
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        s_cand[32 * r + lane] = cand[r];
        const unsigned u = __ballot_sync(FULL, (cand[r] & USABLE) != 0u);
        last = u ? 32 * r + 31 - __clz(u) : last;
    }
    if (lane < 4 * ROUNDS) s_pick[lane] = 0;
    __syncwarp();

    // The chain: a loop over groups of 8 steps, its body unrolled (the
    // code stays small). `take` is the same in every lane: v and owner
    // are broadcasts, n counts the same picks.
    const int base = 32 * lane;
    int n = 0;
    const int groups = quota > 0 ? (last + 8) / 8 : 0;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
        unsigned v[8];
#pragma unroll
        for (int s = 0; s < 8; ++s) v[s] = s_cand[8 * g + s];
        unsigned taken = 0;
#pragma unroll
        for (int s = 0; s < 8; ++s) {
            const unsigned span = span_bits(v[s], base);
            const int i = (int)(v[s] & FIELD);
            const unsigned owner = __shfl_sync(FULL, word, i >> 5);
            const bool take = (v[s] & USABLE) && !((owner >> (i & 31)) & 1u)
                              && n < quota;
            word |= take ? span : 0u;
            taken |= (unsigned)take << s;
            n += take;
        }
        if (lane == 0) s_pick[g] = (unsigned char)taken;
        if (n >= quota) break;
    }
    __syncwarp();
    unsigned picks[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int k = 32 * r + lane;
        picks[r] = __ballot_sync(FULL, (s_pick[k >> 3] >> (k & 7)) & 1u);
    }

    for (int c = lane; c < w; c += 32) s_label[c] = 0;
    __syncwarp();
    int before = 0;                        // picks of the earlier rounds
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const unsigned p = picks[r];
        if ((p >> lane) & 1u) {
            const int i = (int)(cand[r] & FIELD);
            // Of the picks of one column in a round, the last one writes.
            const unsigned same = __match_any_sync(p, i);
            if (31 - __clz(same) == lane) {
                const int ord = before + __popc(p & (FULL >> (31 - lane)));
                s_label[i] = is_corner ? (ord <= sharp_quota ? 2 : 1) : -1;
            }
        }
        before += __popc(p);
        __syncwarp();
    }
    for (int c = lane; c < w; c += 32) labels[off + c] = s_label[c];

    const unsigned fresh = word & ~word0;
#pragma unroll
    for (int i = 0; i < MAX_W / 32; ++i) {
        if (32 * i >= w) break;
        const unsigned m = __shfl_sync(FULL, fresh, i);
        const int c = 32 * i + lane;
        if (c < w) marks[off + c] = (m >> lane) & 1u;
    }
}

template <int ROUNDS>
cudaError_t launch(const float* curv, const int* cand_idx,
                   const bool* cand_ok, const bool* picked0,
                   const int* left, const int* right, int* labels,
                   bool* marks, int rows, int w, int k_cap, float threshold,
                   int quota, int sharp_quota, int is_corner,
                   cudaStream_t stream) {
    greedy_pick_kernel<ROUNDS><<<rows, 32, w * sizeof(int), stream>>>(
        curv, cand_idx, cand_ok, picked0, left, right, labels, marks, w,
        k_cap, threshold, quota, sharp_quota, is_corner);
    return cudaGetLastError();
}

}  // namespace

// The wrapper refuses w > 1024 and k_cap > 256 before it gets here.
extern "C" int loam_greedy_pick_rows(const float* curv, const int* cand_idx,
                                     const bool* cand_ok, const bool* picked0,
                                     const int* left, const int* right,
                                     int* labels, bool* marks, int rows,
                                     int w, int k_cap,
                                     float threshold, int quota,
                                     int sharp_quota, int is_corner,
                                     cudaStream_t stream) {
    if (w < 1 || w > MAX_W || k_cap < 0 || k_cap > 32 * MAX_ROUNDS)
        return (int)cudaErrorInvalidValue;
#define LOAM_GREEDY_CASE(R)                                                  \
    case R:                                                                  \
        return (int)launch<R>(curv, cand_idx, cand_ok, picked0, left, right, \
                              labels, marks, rows, w, k_cap, threshold,     \
                              quota, sharp_quota, is_corner, stream);
    switch (k_cap > 0 ? (k_cap + 31) / 32 : 1) {
        LOAM_GREEDY_CASE(1)
        LOAM_GREEDY_CASE(2)
        LOAM_GREEDY_CASE(3)
        LOAM_GREEDY_CASE(4)
        LOAM_GREEDY_CASE(5)
        LOAM_GREEDY_CASE(6)
        LOAM_GREEDY_CASE(7)
        LOAM_GREEDY_CASE(8)
    }
#undef LOAM_GREEDY_CASE
    return (int)cudaErrorInvalidValue;
}
