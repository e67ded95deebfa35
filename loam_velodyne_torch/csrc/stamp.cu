// The on-card stamp: one thread writes the card's nanosecond clock
// (%globaltimer) and a code into a ring in device memory, behind a
// cursor kept on the card. Not a kernel that replaces a TPU kernel:
// the tracing of the port (utils/profiling.py, ops/launches.py) puts
// it at the start and end of each layer, so a CUDA graph that holds it
// stamps each time the card runs it (inside a conditional node, only
// when the card runs the node), and an eager call stamps when the card
// reaches it in its stream. The host reads the ring at a sync it makes
// anyway and maps the clock onto its own by calibration.
//
// The cursor counts every stamp ever written; entry i lands in slot
// i % capacity, so a ring that the host does not read in time is
// overwritten from its oldest entries, and the host counts what it
// lost from the cursor. Bound by the launch (a few microseconds in a
// stream, about one in a graph), not by its 16 bytes.
#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* __restrict__ ring,
                             unsigned long long* __restrict__ cursor,
                             long long capacity, long long code) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    unsigned long long i = atomicAdd(cursor, 1ULL);
    long long* slot = ring + 2 * (long long)(i % (unsigned long long)capacity);
    slot[0] = (long long)now;
    slot[1] = code;
}

}  // namespace

extern "C" int loam_stamp(void* ring, void* cursor, long long capacity,
                          long long code, cudaStream_t stream) {
    stamp_kernel<<<1, 1, 0, stream>>>(
        static_cast<long long*>(ring),
        static_cast<unsigned long long*>(cursor), capacity, code);
    return (int)cudaGetLastError();
}
