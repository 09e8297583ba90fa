// Sorted-membership probe: the Hopper port of the Pallas kernel
// `probe_sorted` (`_probe_kernel`) in src/repro/kernels/hash_probe.py.
//
// out[i] = 1 iff queries[i] occurs in the sorted haystack, found by the
// reference's branch-free binary search of static depth ceil(log2(H+1)).
//
// Bound.  The work is n * depth dependent loads.  The haystack stays in
// device memory, where the 50 MB L2 holds the search tree's upper levels
// for every query (the reference instead copies the whole haystack into
// one VMEM block per grid step); the queries are read once and the flags
// written once.  At the engine's shapes the kernel is bound by the latency
// of the dependent loads rather than by bytes, so it keeps one thread per
// query and many queries in flight.  Caching the top levels in shared
// memory is later work.
#include "common.cuh"

#define PROBE_THREADS 256

template <typename K>
__global__ void probe_kernel(const K* queries, const K* hay, int32_t* out,
                             long long n, long long h, int steps) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        const K q = queries[i];
        long long lo = 0, hi = h;
        for (int s = 0; s < steps; ++s) {
            const long long mid = (lo + hi) >> 1;
            const K v = hay[mid < h - 1 ? mid : h - 1];
            const bool in_range = mid < hi;
            const bool go = in_range && v < q;
            lo = go ? mid + 1 : lo;
            hi = (in_range && !go) ? mid : hi;
        }
        out[i] = (lo < h && hay[lo < h - 1 ? lo : h - 1] == q) ? 1 : 0;
    }
}

// queries (n,), hay (h,) sorted, both of the dtype `code`; out (n,) int32.
// h >= 1.
extern "C" int rt_probe_sorted(int code, const void* queries, const void* hay,
                               void* out, long long n, long long h, int steps,
                               void* stream) {
    RT_DISPATCH_KEY(code, K,
        probe_kernel<K><<<grid_for(n, PROBE_THREADS), PROBE_THREADS, 0,
                          (cudaStream_t)stream>>>(
            (const K*)queries, (const K*)hay, (int32_t*)out, n, h, steps));
    return (int)cudaGetLastError();
}
