// Tile sort and pairwise merge of (key, int32 payload) pairs: the Hopper
// port of the Pallas kernels `bitonic_sort_tiles` (`_bitonic_kernel`) and
// `bitonic_merge_pairs` (`_merge_kernel`) in
// src/repro/kernels/bitonic_sort.py.
//
// Order.  Pairs are compared as (key, payload), lexicographically,
// everywhere, the co-rank search included.  Equal pairs are equal values,
// so the sorted sequence is unique and equals the plain versions' element
// for element; with row positions as the payload it is a stable argsort.
//
// Design.  Both kernels rest on one merge-path search, `co_rank`: given two
// sorted runs A and B and a diagonal d, how many of the first d outputs of
// their merge come from A.  A thread that knows its co-rank merges its
// ITEMS = 8 consecutive outputs serially into registers, so no step touches
// a whole block.
//
// * sort_tiles_kernel: one CTA per tile, TILE / ITEMS threads.  The tile is
//   loaded coalesced into shared memory, each thread sorts its ITEMS pairs
//   in registers with a fixed network, then log2(TILE / ITEMS) merge rounds
//   run in shared memory: every thread co-ranks its outputs in the pair of
//   runs it belongs to, merges them into registers and writes them to the
//   other of two buffers, with one __syncthreads() per round.  Tile 4096:
//   9 rounds (11 barriers in all), where the bitonic network this replaced
//   ran 78 compare-exchange stages, each ending in a barrier; tile 1024: 7
//   rounds against 55 stages.  The kernel is instantiated per tile: with
//   the tile as a launch argument it took 63 registers instead of 46 at
//   tile 1024 (int32) and ran 3-4% slower on an H100 (PERF.md).
// * merge_pairs_kernel: one pass whatever the width.  Each CTA owns a span
//   of MERGE_SPAN = 2048 outputs.  Inside a wider width-block,
//   merge_cuts_kernel has first co-ranked every span boundary in device
//   memory (CUT_LANES = 8 lanes each, 7 steps at width 2^22 instead of a
//   binary search's 22), so the CTA loads the A and B slices that feed its
//   span at once; every thread then co-ranks and merges its items in
//   shared memory.  A span holding whole width-blocks loads them as they
//   lie; at widths up to ITEMS a thread's items hold whole blocks, which
//   it sorts in registers.  Measured on an H100 (PERF.md): a CTA that
//   searched its own two cuts before loading was slower at every width,
//   and 32 lanes per cut cost more than one thread; 8 lanes cost least.
//
// Bound.  Both kernels read each key and payload once from device memory
// and write them once, so both are bound by device-memory bytes; the
// merge's cuts add one search of about log9(width / 2) + 1 steps of 8
// pair loads per span.  In shared memory a pair is one 8-byte value (16
// for int64 keys), and one spare slot after every 128 bytes puts the
// ITEMS-strided accesses of a warp on distinct banks.
#include "common.cuh"

#define SMEM_BLOCK 4096  // the largest tile
#define ITEMS 8          // pairs per thread
#define MERGE_THREADS 256
#define MERGE_SPAN (MERGE_THREADS * ITEMS)
#define CUT_LANES 8      // lanes that co-rank one span boundary together

// A (key, payload) pair as the kernels hold it: one value whose order is
// the pairs' lexicographic order.  For int16 and int32 keys it is a u64
// with the key above the payload, both sign bits flipped, so that unsigned
// order is signed order.
template <typename K>
struct Pair {
    typedef unsigned long long T;
    static __device__ __forceinline__ T make(K k, int32_t v) {
        return ((T)((uint32_t)(int32_t)k ^ 0x80000000u) << 32) |
               ((uint32_t)v ^ 0x80000000u);
    }
    static __device__ __forceinline__ K key(T p) {
        return (K)(int32_t)((uint32_t)(p >> 32) ^ 0x80000000u);
    }
    static __device__ __forceinline__ int32_t val(T p) {
        return (int32_t)((uint32_t)p ^ 0x80000000u);
    }
    static __device__ __forceinline__ bool less(T a, T b) { return a < b; }
};

struct __align__(16) WidePair {
    unsigned long long k;
    uint32_t v;
};

template <>
struct Pair<int64_t> {
    typedef WidePair T;
    static __device__ __forceinline__ T make(int64_t k, int32_t v) {
        return {(unsigned long long)k ^ (1ULL << 63),
                (uint32_t)v ^ 0x80000000u};
    }
    static __device__ __forceinline__ int64_t key(T p) {
        return (int64_t)(p.k ^ (1ULL << 63));
    }
    static __device__ __forceinline__ int32_t val(T p) {
        return (int32_t)(p.v ^ 0x80000000u);
    }
    static __device__ __forceinline__ bool less(T a, T b) {
        return a.k < b.k || (a.k == b.k && a.v < b.v);
    }
};

// Shared-memory slot of pair i: one spare slot after every 128 bytes.
template <typename T>
__device__ __forceinline__ int padded(int i) {
    return i + (i >> (sizeof(T) == 8 ? 4 : 3));
}

template <typename T>
__host__ __device__ constexpr int padded_len(int len) {
    return len + len / (int)(128 / sizeof(T));
}

// Two buffers of `len` pairs: the merge rounds read one and write the other.
template <typename T>
constexpr size_t pair_smem(int len) {
    return 2 * (size_t)padded_len<T>(len) * sizeof(T);
}

// A sorted run of pairs at `off` in a shared buffer.
template <typename T>
struct SmemRun {
    const T* s;
    int off;
    __device__ __forceinline__ T operator[](int i) const {
        return s[padded<T>(off + i)];
    }
};

// A sorted run of pairs in device memory (keys and payload apart).
template <typename K>
struct GlobalRun {
    const K* k;
    const int32_t* v;
    __device__ __forceinline__ typename Pair<K>::T operator[](
        long long i) const {
        return Pair<K>::make(k[i], v[i]);
    }
};

// Merge path: of the first d outputs of merge(A, B), the number that come
// from A, for sorted runs A of na and B of nb pairs.  Ties go to A, as in
// merge_items.  A[i] is among the first d outputs iff !(B[d-1-i] < A[i]),
// which holds for every i below the answer and none from it on, so a search
// over i in [max(0, d - nb), min(d, na)] finds it.  G lanes of a warp (a
// power of two; G = 1 is one thread) search together: each step they test
// G points that cut the range into G + 1 parts and keep the part where the
// test turns false; with G = 1 that is a binary search.
template <typename P, int G, typename I, typename Run>
__device__ __forceinline__ I co_rank(const Run& a, I na, const Run& b, I nb,
                                     I d) {
    const int k = threadIdx.x & (G - 1);
    const unsigned group = (0xffffffffu >> (32 - G))
                           << (threadIdx.x & 31 & ~(G - 1));
    I lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
    while (lo < hi) {
        const I span = hi - lo;  // G * span fits in I: G <= 32
        const I p = lo + span * (k + 1) / (G + 1);
        const bool in_a = !P::less(b[d - 1 - p], a[p]);
        const int c =
            G == 1 ? in_a : __popc(__ballot_sync(group, in_a) & group);
        const I l0 = lo;
        if (c) lo = l0 + span * c / (G + 1) + 1;
        if (c < G) hi = l0 + span * (c + 1) / (G + 1);
    }
    return lo;
}

// The N outputs of merge(A, B) from diagonal d on, into registers.
template <typename P, int N, typename Run>
__device__ __forceinline__ void merge_items(const Run& a, int na,
                                            const Run& b, int nb, int d,
                                            typename P::T (&x)[N]) {
    typedef typename P::T T;
    int i = co_rank<P, 1>(a, na, b, nb, d), j = d - i;
    T ai = i < na ? a[i] : T(), bj = j < nb ? b[j] : T();
#pragma unroll
    for (int t = 0; t < N; ++t) {
        const bool from_a = j >= nb || (i < na && !P::less(bj, ai));
        x[t] = from_a ? ai : bj;
        if (from_a) {
            if (++i < na) ai = a[i];
        } else {
            if (++j < nb) bj = b[j];
        }
    }
}

template <typename P>
__device__ __forceinline__ void cmp_swap(typename P::T& a,
                                         typename P::T& b) {
    const bool sw = P::less(b, a);
    const typename P::T lo = sw ? b : a, hi = sw ? a : b;
    a = lo;
    b = hi;
}

// Sort every w-block of x in registers (w a power of two; w >= N sorts all
// of x): the bitonic network in its flip form, so each block ends
// ascending.  w is the same in every thread, so the early exit is uniform.
template <typename P, int N>
__device__ __forceinline__ void sort_regs(typename P::T (&x)[N], int w) {
#pragma unroll
    for (int s = 2; s <= N; s <<= 1) {
        if (s > w) break;
#pragma unroll
        for (int i = 0; i < N; ++i)
            if ((i & (s >> 1)) == 0) cmp_swap<P>(x[i], x[i ^ (s - 1)]);
#pragma unroll
        for (int j = s >> 2; j >= 1; j >>= 1)
#pragma unroll
            for (int i = 0; i < N; ++i)
                if ((i & j) == 0) cmp_swap<P>(x[i], x[i | j]);
    }
}

template <typename T, int N>
__device__ __forceinline__ void put_items(T* s, int d, const T (&x)[N]) {
#pragma unroll
    for (int t = 0; t < N; ++t) s[padded<T>(d + t)] = x[t];
}

// Pairs [0, len) of a span into a shared buffer, get(i) giving pair i:
// thread t takes pairs t, t + THREADS, ..., so loads coalesce, and all N
// of a thread's loads are issued before the first is waited for.
template <int THREADS, int N, typename T, typename Get>
__device__ __forceinline__ void load_span(T* s, int len, Get get) {
    T r[N];
#pragma unroll
    for (int t = 0; t < N; ++t) {
        const int i = t * THREADS + threadIdx.x;
        if (i < len) r[t] = get(i);
    }
#pragma unroll
    for (int t = 0; t < N; ++t) {
        const int i = t * THREADS + threadIdx.x;
        if (i < len) s[padded<T>(i)] = r[t];
    }
}

// Pairs [0, len) of a shared buffer to device memory, coalesced.
template <typename P, int THREADS, int N, typename K>
__device__ __forceinline__ void store_span(const typename P::T* s, K* kout,
                                           int32_t* vout, int len) {
#pragma unroll
    for (int t = 0; t < N; ++t) {
        const int i = t * THREADS + threadIdx.x;
        if (i < len) {
            const typename P::T p = s[padded<typename P::T>(i)];
            kout[i] = P::key(p);
            vout[i] = P::val(p);
        }
    }
}

__host__ __device__ constexpr int tile_items(int tile) {
    return tile < ITEMS ? tile : ITEMS;
}

// Sort each TILE-block (one CTA per tile).  Outputs never alias inputs:
// the wrappers allocate them.
template <typename K, int TILE>
__global__ void __launch_bounds__(TILE / tile_items(TILE))
    sort_tiles_kernel(const K* __restrict__ kin,
                      const int32_t* __restrict__ vin, K* __restrict__ kout,
                      int32_t* __restrict__ vout) {
    typedef Pair<K> P;
    typedef typename P::T T;
    constexpr int N = tile_items(TILE), THREADS = TILE / N;
    extern __shared__ __align__(16) unsigned char smem[];
    T* src = reinterpret_cast<T*>(smem);
    T* dst = src + padded_len<T>(TILE);
    const long long base = (long long)blockIdx.x * TILE;
    const int d0 = threadIdx.x * N;
    load_span<THREADS, N>(src, TILE, [&](int i) {
        return P::make(kin[base + i], vin[base + i]);
    });
    __syncthreads();
    T x[N];
#pragma unroll
    for (int t = 0; t < N; ++t) x[t] = src[padded<T>(d0 + t)];
    sort_regs<P>(x, N);
    put_items(dst, d0, x);
#pragma unroll 1
    for (int w = 2 * N; w <= TILE; w <<= 1) {
        T* t = src;
        src = dst;
        dst = t;
        __syncthreads();
        const int blk = d0 & ~(w - 1), h = w >> 1;
        merge_items<P>(SmemRun<T>{src, blk}, h, SmemRun<T>{src, blk + h}, h,
                       d0 - blk, x);
        put_items(dst, d0, x);
    }
    __syncthreads();
    store_span<P, THREADS, N>(dst, kout + base, vout + base, TILE);
}

// Merges wider than the span: the co-rank of every span boundary c *
// MERGE_SPAN inside its width-block, CUT_LANES lanes each, so that the
// merge's CTAs start loading at once instead of each waiting on its own
// searches.
template <typename K>
__global__ void merge_cuts_kernel(const K* __restrict__ kin,
                                  const int32_t* __restrict__ vin,
                                  long long* __restrict__ cuts,
                                  long long spans, long long width) {
    const long long h = width >> 1;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long c = t / CUT_LANES;
    if (c >= spans) return;  // whole groups return together
    const long long pos = c * MERGE_SPAN, blk = pos & ~(width - 1);
    const long long i = co_rank<Pair<K>, CUT_LANES>(
        GlobalRun<K>{kin + blk, vin + blk}, h,
        GlobalRun<K>{kin + blk + h, vin + blk + h}, h, pos - blk);
    if ((t & (CUT_LANES - 1)) == 0) cuts[c] = i;
}

// Merge adjacent sorted halves into sorted width-blocks: outputs
// [base, base + MERGE_SPAN) per CTA, one read and one write of each pair.
template <typename K>
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_pairs_kernel(const K* __restrict__ kin,
                       const int32_t* __restrict__ vin, K* __restrict__ kout,
                       int32_t* __restrict__ vout,
                       const long long* __restrict__ cuts, long long n,
                       long long width) {
    typedef Pair<K> P;
    typedef typename P::T T;
    extern __shared__ __align__(16) unsigned char smem[];
    T* src = reinterpret_cast<T*>(smem);
    T* dst = src + padded_len<T>(MERGE_SPAN);
    const long long base = (long long)blockIdx.x * MERGE_SPAN;
    const int len = (int)min((long long)MERGE_SPAN, n - base);
    const int tid = threadIdx.x, d0 = tid * ITEMS;
    int a0, na, nb, d;  // this thread's runs in src: A at a0, B after it
    if (width > MERGE_SPAN) {
        // The span lies inside one width-block: load the A and B slices
        // that feed it, between its cuts.  A span that ends its block ends
        // both halves.
        const long long blk = base & ~(width - 1), h = width >> 1;
        const long long db = base - blk;
        const GlobalRun<K> a{kin + blk, vin + blk};
        const GlobalRun<K> b{kin + blk + h, vin + blk + h};
        const long long i0 = cuts[blockIdx.x], j0 = db - i0;
        na = (int)((db + len == width ? h : cuts[blockIdx.x + 1]) - i0);
        nb = len - na;
        load_span<MERGE_THREADS, ITEMS>(src, len, [&](int i) {
            return i < na ? a[i0 + i] : b[j0 + (i - na)];
        });
        a0 = 0;
        d = d0;
    } else {
        // The span holds whole width-blocks (the last CTA's may be short).
        load_span<MERGE_THREADS, ITEMS>(src, len, [&](int i) {
            return P::make(kin[base + i], vin[base + i]);
        });
        a0 = d0 & ~((int)width - 1);
        na = nb = (int)width >> 1;
        d = d0 - a0;
    }
    __syncthreads();
    T x[ITEMS];
    if (width <= ITEMS) {
        // this thread's items are whole blocks; slots past len are spare
        // blocks of their own, never stored
#pragma unroll
        for (int t = 0; t < ITEMS; ++t)
            x[t] = d0 + t < len ? src[padded<T>(d0 + t)] : T();
        sort_regs<P>(x, (int)width);
    } else if (d0 < len) {
        merge_items<P>(SmemRun<T>{src, a0}, na, SmemRun<T>{src, a0 + na}, nb,
                       d, x);
    }
    if (d0 < len) put_items(dst, d0, x);
    __syncthreads();
    store_span<P, MERGE_THREADS, ITEMS>(dst, kout + base, vout + base, len);
}

// Above 48 KB a kernel's dynamic shared memory must be asked for first.
template <typename F>
static int allow_smem(F* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename K, int TILE>
static int launch_sort_tiles(const void* kin, const void* vin, void* kout,
                             void* vout, long long n, cudaStream_t s) {
    const size_t bytes = pair_smem<typename Pair<K>::T>(TILE);
    const int err = allow_smem(sort_tiles_kernel<K, TILE>, bytes);
    if (err) return err;
    sort_tiles_kernel<K, TILE>
        <<<(unsigned int)(n / TILE), TILE / tile_items(TILE), bytes, s>>>(
            (const K*)kin, (const int32_t*)vin, (K*)kout, (int32_t*)vout);
    return (int)cudaGetLastError();
}

template <typename K>
static int sort_tiles_impl(const void* kin, const void* vin, void* kout,
                           void* vout, long long n, int tile,
                           cudaStream_t s) {
    switch (tile) {
#define TILE_CASE(t) \
    case t: return launch_sort_tiles<K, t>(kin, vin, kout, vout, n, s);
        TILE_CASE(1) TILE_CASE(2) TILE_CASE(4) TILE_CASE(8) TILE_CASE(16)
        TILE_CASE(32) TILE_CASE(64) TILE_CASE(128) TILE_CASE(256)
        TILE_CASE(512) TILE_CASE(1024) TILE_CASE(2048) TILE_CASE(4096)
#undef TILE_CASE
    }
    return (int)cudaErrorInvalidValue;
}

template <typename K>
static int merge_pairs_impl(const void* kin, const void* vin, void* kout,
                            void* vout, long long n, long long width,
                            void* cuts, cudaStream_t s) {
    const long long spans = (n + MERGE_SPAN - 1) / MERGE_SPAN;
    const size_t bytes = pair_smem<typename Pair<K>::T>(MERGE_SPAN);
    int err = allow_smem(merge_pairs_kernel<K>, bytes);
    if (err) return err;
    if (width > MERGE_SPAN) {
        const long long threads = spans * CUT_LANES;
        merge_cuts_kernel<K>
            <<<(unsigned int)((threads + 127) / 128), 128, 0, s>>>(
                (const K*)kin, (const int32_t*)vin, (long long*)cuts, spans,
                width);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    merge_pairs_kernel<K><<<(unsigned int)spans, MERGE_THREADS, bytes, s>>>(
        (const K*)kin, (const int32_t*)vin, (K*)kout, (int32_t*)vout,
        (const long long*)cuts, n, width);
    return (int)cudaGetLastError();
}

extern "C" int rt_smem_block() { return SMEM_BLOCK; }

extern "C" int rt_merge_span() { return MERGE_SPAN; }

extern "C" const char* rt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// keys (n,) of the dtype `code`, payload (n,) int32; n % tile == 0, tile a
// power of two <= SMEM_BLOCK.
extern "C" int rt_sort_tiles(int code, const void* kin, const void* vin,
                             void* kout, void* vout, long long n, int tile,
                             void* stream) {
    RT_DISPATCH_KEY(code, K,
        return sort_tiles_impl<K>(kin, vin, kout, vout, n, tile,
                                  (cudaStream_t)stream));
    return 0;
}

// Merge adjacent sorted halves into sorted blocks of `width` (a power of
// two >= 2, n % width == 0).  cuts: scratch of ceil(n / MERGE_SPAN) int64
// when width > MERGE_SPAN, else unused.
extern "C" int rt_merge_pairs(int code, const void* kin, const void* vin,
                              void* kout, void* vout, long long n,
                              long long width, void* cuts, void* stream) {
    RT_DISPATCH_KEY(code, K,
        return merge_pairs_impl<K>(kin, vin, kout, vout, n, width, cuts,
                                   (cudaStream_t)stream));
    return 0;
}
