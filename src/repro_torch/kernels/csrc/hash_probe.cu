// Sorted-membership probe: the Hopper port of the Pallas kernel
// `probe_sorted` (`_probe_kernel`) in src/repro/kernels/hash_probe.py,
// which copies the whole haystack into one VMEM block per grid step and
// searches it there.
//
// out[i] = 1 iff queries[i] occurs in the sorted haystack (any length
// h >= 1, duplicates and PAD tails allowed).
//
// Bound.  Not bytes: each query is read once and each flag written once,
// and a search reads a few lines of the haystack.  A query's search is a
// chain of dependent loads, and what costs is the loads of that chain that
// miss L1 (each a round trip to L2, or to device memory past the 50 MB
// L2), the lines a warp's loads touch (L1 serves about one 128-byte line a
// cycle per SM, and 32 queries that have spread apart touch 32), and, once
// those are few, the instructions per query.  227 KB of shared memory
// cannot hold the haystack, so the kernel shortens the chain instead:
//
// * It searches line heads, not keys.  Line t of the haystack is its keys
//   in the t-th 128-byte block of memory (U = 128 / sizeof(K) keys; the
//   first and last lines may be short), and its head is its first key.
//   With c the number of heads below the query, the query's first
//   occurrence can only be head c or lie in line c - 1, so the search
//   skips the log2(U) levels inside a line and reads that line whole.
// * The top of the search in shared memory.  Each CTA stages the heads at
//   the 2^L - 1 ranks of an even sample of the M heads in breadth-first
//   (Eytzinger) order, and every query descends them branch-free with L
//   shared loads.  That leaves at most floor(M / 2^L) heads, which the
//   query searches in device memory, one thread per query, with the
//   reference's branch-free binary search; for M < 2^L none.
// * A lane-cooperative end.  Eight lanes read the query's line together,
//   16 bytes each (one 128-byte wavefront), compare their keys and vote
//   with __ballot_sync; each group of 8 lanes takes the 8 queries of its
//   lanes, issuing all 8 loads before the first ballot.
//
// The table's heads are scattered, a line each, so staging it costs a CTA
// 2^L - 1 L2 requests before its first query: the grid is persistent and L
// is chosen by how many queries a CTA answers.  The narrow grid (L = 8,
// two CTAs of 256 per SM) takes calls up to 4 loops of its threads; the
// wide grid (L = 12, one CTA of 1024 per SM) stages its deeper table once
// for more.  The co_rank search of bitonic_sort.cu, with G lanes testing
// G evenly spaced pivots a step, is not shared: each pivot is a line of
// its own, and at G = 4, 8 and 16 below the table it ran 1.5x-3.9x slower
// than the binary search it was to replace.  PERF.md has the measurements
// (scripts/compare_port.py --probe).
#include "common.cuh"

// The narrow grid, for most calls: CTAs of PROBE_THREADS, at most
// PROBE_CTAS_PER_SM a SM, a table of PROBE_LEVELS levels.
#define PROBE_LEVELS 8
#define PROBE_THREADS 256
#define PROBE_CTAS_PER_SM 2
// The wide grid, once the narrow one would loop PROBE_WIDE_FROM times or
// more over its queries: one CTA of 1024 a SM and a deeper table, staged
// once for many queries.
#define PROBE_WIDE_LEVELS 12
#define PROBE_WIDE_THREADS 1024
#define PROBE_WIDE_FROM 4
#define PROBE_LINE 128  // bytes of a line: 8 lanes x 16 bytes
#define PROBE_LANES 8

// The haystack cut into 128-byte lines of memory: a0 keys of the first
// block lie before hay[0], so line t starts at key t * U - a0 (line 0 at
// key 0), and there are m lines, fewer than 2^31 for h < 2^34.
template <typename K>
struct Lines {
    static constexpr int U = PROBE_LINE / sizeof(K);
    int a0, m;
    __host__ __device__ Lines(const K* hay, long long h)
        : a0((int)(((uintptr_t)hay & (PROBE_LINE - 1)) / sizeof(K))),
          m((int)((h + a0 + U - 1) / U)) {}
    __device__ __forceinline__ long long start(int t) const {
        return t ? (long long)t * U - a0 : 0;
    }
};

// x clamped to [0, V]: how many of a lane's V keys lie below an offset.
template <int V>
__device__ __forceinline__ int clamp_keys(int x) {
    return x < 0 ? 0 : x > V ? V : x;
}

// The head index of the table's sample of rank j (j = 0 .. 2^L - 2),
// nondecreasing in j.
template <int L>
__device__ __forceinline__ int sample_head(int j, int m) {
    return (int)(((long long)(j + 1) * m) >> L);
}

template <typename K, int L, int T>
__global__ void __launch_bounds__(T)
    probe_kernel(const K* __restrict__ queries, const K* __restrict__ hay,
                 int32_t* __restrict__ out, long long n, long long h,
                 int steps) {
    constexpr int S = (1 << L) - 1;  // samples in the table
    constexpr int PER = (S + T - 1) / T;
    constexpr int V = 16 / sizeof(K);  // keys in a lane's 16 bytes
    __shared__ K tab[S + 1];           // node k = 1 .. S, breadth-first
    const Lines<K> ln(hay, h);
    const long long stride = (long long)gridDim.x * T;
    long long i = (long long)blockIdx.x * T + threadIdx.x;
    // the first query is loaded before the table, so that the two wait
    // together; every later one during the query before it
    K q_next = i < n ? queries[i] : K(0);
    {
        // a thread's PER samples are all requested before any is stored
        K r[PER];
#pragma unroll
        for (int t = 0; t < PER; ++t) {
            const int k = 1 + threadIdx.x + t * T;
            if (k <= S) {
                // node k, at level lev, holds the sample of in-order rank j
                const int lev = 31 - __clz(k);
                const int j =
                    ((2 * (k - (1 << lev)) + 1) << (L - 1 - lev)) - 1;
                r[t] = hay[ln.start(sample_head<L>(j, ln.m))];
            }
        }
#pragma unroll
        for (int t = 0; t < PER; ++t) {
            const int k = 1 + threadIdx.x + t * T;
            if (k <= S) tab[k] = r[t];
        }
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int base = lane & ~(PROBE_LANES - 1), me = lane & (PROBE_LANES - 1);
    // the 128-byte block that holds hay[0]
    const char* block0 = (const char*)hay - ln.a0 * (int)sizeof(K);
    // lane me reads keys me * V .. me * V + V - 1 of a line's block; of
    // these, line 0 holds those from block offset a0 on and line m - 1 those
    // below offset `end`, every other line all (bit r: key me * V + r)
    const int end = (int)(h + ln.a0 - (long long)(ln.m - 1) * Lines<K>::U);
    const unsigned all = (1u << V) - 1;
    const unsigned first_keys =
        all & ~((1u << clamp_keys<V>(ln.a0 - me * V)) - 1);
    const unsigned last_keys = (1u << clamp_keys<V>(end - me * V)) - 1;
    // the loop bound is the same for the whole CTA, so every lane of a
    // warp reaches every shuffle and ballot; lanes past n carry no query
    for (long long i0 = i - threadIdx.x; i0 < n; i0 += stride, i += stride) {
        const bool live = i < n;
        const K q = q_next;
        if (i + stride < n) q_next = queries[i + stride];

        // the table: cs samples lie below q
        int node = 1;
        bool found = false;
#pragma unroll
        for (int s = 0; s < L; ++s) {
            const K t = tab[node];
            found = found || t == q;
            node = 2 * node + (t < q);
        }
        const int cs = node - (1 << L);
        // the heads strictly between samples cs - 1 and cs
        int lo = cs ? sample_head<L>(cs - 1, ln.m) + 1 : 0;
        int hi = cs < S ? sample_head<L>(cs, ln.m) : ln.m;
        for (int s = 0; s < steps; ++s) {
            const int mid = lo + ((hi - lo) >> 1);
            const bool in_range = mid < hi;
            const K v = in_range ? hay[ln.start(mid)] : K(0);
            const bool go = in_range && v < q;
            found = found || (in_range && v == q);
            lo = go ? mid + 1 : lo;
            hi = (in_range && !go) ? mid : hi;
        }
        // lo heads lie below q, and head lo was tested (in the table or
        // the search): q can only lie in line lo - 1
        const int line = live && !found && lo > 0 ? lo - 1 : -1;

        // the group's 8 lines, lane me's 16 bytes of each (all 8 loads are
        // issued before any ballot waits); bit r of keep[j]: key r counts
        uint4 raw[PROBE_LANES] = {};
        unsigned keep[PROBE_LANES];
#pragma unroll
        for (int j = 0; j < PROBE_LANES; ++j) {
            const int tj = __shfl_sync(0xffffffffu, line, base + j);
            keep[j] = tj < 0 ? 0u : all;
            if (tj == 0) keep[j] &= first_keys;
            if (tj == ln.m - 1) keep[j] &= last_keys;
            if (keep[j])
                raw[j] = *reinterpret_cast<const uint4*>(
                    block0 + (long long)tj * PROBE_LINE + me * 16);
        }
        unsigned hits = 0;  // bit j: query j of the group is in its line
#pragma unroll
        for (int j = 0; j < PROBE_LANES; ++j) {
            const K qj = __shfl_sync(0xffffffffu, q, base + j);
            K keys[V];
            memcpy(keys, &raw[j], 16);
            unsigned eq = 0;
#pragma unroll
            for (int r = 0; r < V; ++r) eq |= (unsigned)(keys[r] == qj) << r;
            if ((__ballot_sync(0xffffffffu, (eq & keep[j]) != 0) >> base) &
                ((1u << PROBE_LANES) - 1))
                hits |= 1u << j;
        }
        found = found || ((hits >> me) & 1u);
        if (live) out[i] = found ? 1 : 0;
    }
}

static int sm_count() {
    static int sms = 0;
    if (!sms) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms < 1) sms = 132;
    }
    return sms;
}

// One grid: at most `ctas` CTAs of T threads, and the steps of the binary
// search below an L-level table, which leaves at most floor(m / 2^L) heads
// (below sample 0, or between two samples ceil(m / 2^L) apart); a range
// of w heads takes bit_length(w) steps.
template <typename K, int L, int T>
static void launch_probe(const K* queries, const K* hay, int32_t* out,
                         long long n, long long h, long long ctas,
                         cudaStream_t stream) {
    int steps = 0;
    for (int w = Lines<K>(hay, h).m >> L; w > 0; w >>= 1) ++steps;
    long long grid = (n + T - 1) / T;
    grid = grid < ctas ? grid : ctas;
    probe_kernel<K, L, T><<<(unsigned)grid, T, 0, stream>>>(queries, hay, out,
                                                            n, h, steps);
}

// queries (n,), hay (h,) sorted, both of the dtype `code`; out (n,) int32.
// n >= 1, 1 <= h < 2^34; hay aligned to its key size, as every tensor is.
// One launch.
extern "C" int rt_probe_sorted(int code, const void* queries, const void* hay,
                               void* out, long long n, long long h,
                               void* stream) {
    if (h < 1 || h >= (1LL << 34)) return (int)cudaErrorInvalidValue;
    const long long sms = sm_count();
    const bool wide = n >= PROBE_WIDE_FROM * PROBE_CTAS_PER_SM * sms *
                               (long long)PROBE_THREADS;
    RT_DISPATCH_KEY(code, K,
        if (wide)
            launch_probe<K, PROBE_WIDE_LEVELS, PROBE_WIDE_THREADS>(
                (const K*)queries, (const K*)hay, (int32_t*)out, n, h, sms,
                (cudaStream_t)stream);
        else
            launch_probe<K, PROBE_LEVELS, PROBE_THREADS>(
                (const K*)queries, (const K*)hay, (int32_t*)out, n, h,
                PROBE_CTAS_PER_SM * sms, (cudaStream_t)stream));
    return (int)cudaGetLastError();
}
