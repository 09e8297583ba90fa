// Bitonic tile sort and pairwise bitonic merge of (key, int32 payload)
// pairs: the Hopper port of the Pallas kernels `bitonic_sort_tiles`
// (`_bitonic_kernel`) and `bitonic_merge_pairs` (`_merge_kernel`) in
// src/repro/kernels/bitonic_sort.py.
//
// Order.  Pairs are compared as (key, payload), lexicographically.  The
// engine's payload is row positions, which are distinct, so the network's
// result is unique and equals a stable argsort by key: the card and the
// plain version agree row for row.
//
// Network.  Each merge of width w is a "flip" stage, pairing p with w-1-p
// inside every w-block (the reference's reverse-the-second-half followed by
// the distance-w/2 compare, without moving data), then half-cleaner stages
// at distances w/4 .. 1.
//
// Bound.  Each stage reads and writes every key and payload once, so the
// sort is bound by device-memory bytes.  Stages whose pairs lie inside one
// block of SMEM_BLOCK elements run in shared memory: a tile sort is one
// load and one store per element, and a merge of width w <= SMEM_BLOCK too.
// Wider merges run their first log2(w / SMEM_BLOCK) stages as one
// grid-wide compare-exchange pass each (one launch per stage), then finish
// the remaining stages in shared memory, SMEM_BLOCK elements per CTA.
#include "common.cuh"

// 4096 * (8 + 4) bytes = 48 KB for int64 keys: within the default limit of
// dynamic shared memory, so no opt-in attribute is needed.
#define SMEM_BLOCK 4096
#define BLOCK_THREADS 1024
#define STAGE_THREADS 256

// Shared-memory layout of a block of `len` pairs: the keys, then the
// payload at the next 16-byte boundary (an int16 tile of odd length would
// otherwise misalign it).
template <typename K>
__host__ __device__ __forceinline__ size_t payload_offset(long long len) {
    return ((size_t)len * sizeof(K) + 15) & ~(size_t)15;
}

template <typename K>
__host__ __device__ __forceinline__ size_t smem_bytes(long long len) {
    return payload_offset<K>(len) + (size_t)len * sizeof(int32_t);
}

template <typename K>
__device__ __forceinline__ void cmp_swap(K* k, int32_t* v, int a, int b) {
    const K ka = k[a], kb = k[b];
    const int32_t va = v[a], vb = v[b];
    if (ka > kb || (ka == kb && va > vb)) {
        k[a] = kb; k[b] = ka;
        v[a] = vb; v[b] = va;
    }
}

// One stage over a shared block of `len` elements.  flip: pair (p, 2h-1-p)
// inside every 2h-block; else pair (a, a+h).  h is a power of two.
template <typename K>
__device__ void smem_stage(K* k, int32_t* v, int len, int h, bool flip) {
    const int lh = __ffs(h) - 1;
    for (int t = threadIdx.x; t < (len >> 1); t += blockDim.x) {
        const int blk = t >> lh, off = t & (h - 1);
        const int a = (blk << (lh + 1)) + off;
        const int b = flip ? (blk << (lh + 1)) + 2 * h - 1 - off : a + h;
        cmp_swap(k, v, a, b);
    }
    __syncthreads();
}

template <typename K>
__device__ void load_block(const K* kin, const int32_t* vin, K* sk,
                           int32_t* sv, long long base, int len) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
        sk[i] = kin[base + i];
        sv[i] = vin[base + i];
    }
    __syncthreads();
}

template <typename K>
__device__ void store_block(K* kout, int32_t* vout, const K* sk,
                            const int32_t* sv, long long base, int len) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
        kout[base + i] = sk[i];
        vout[base + i] = sv[i];
    }
}

// Sort each `tile`-block fully in shared memory (one CTA per tile).
template <typename K>
__global__ void sort_tiles_kernel(const K* kin, const int32_t* vin, K* kout,
                                  int32_t* vout, int tile) {
    extern __shared__ __align__(16) unsigned char smem[];
    K* sk = reinterpret_cast<K*>(smem);
    int32_t* sv = reinterpret_cast<int32_t*>(smem + payload_offset<K>(tile));
    const long long base = (long long)blockIdx.x * tile;
    load_block(kin, vin, sk, sv, base, tile);
    for (int size = 2; size <= tile; size <<= 1) {
        smem_stage(sk, sv, tile, size >> 1, true);
        for (int j = size >> 2; j >= 1; j >>= 1)
            smem_stage(sk, sv, tile, j, false);
    }
    store_block(kout, vout, sk, sv, base, tile);
}

// Finish a merge inside `len`-blocks: with `flip`, the whole merge of width
// len; without, the half-cleaner stages at distances len/2 .. 1 that follow
// the grid-wide stages of a wider merge.
template <typename K>
__global__ void merge_block_kernel(const K* kin, const int32_t* vin, K* kout,
                                   int32_t* vout, int len, int flip) {
    extern __shared__ __align__(16) unsigned char smem[];
    K* sk = reinterpret_cast<K*>(smem);
    int32_t* sv = reinterpret_cast<int32_t*>(smem + payload_offset<K>(len));
    const long long base = (long long)blockIdx.x * len;
    load_block(kin, vin, sk, sv, base, len);
    int j = len >> 1;
    if (flip) {
        smem_stage(sk, sv, len, j, true);
        j >>= 1;
    }
    for (; j >= 1; j >>= 1)
        smem_stage(sk, sv, len, j, false);
    store_block(kout, vout, sk, sv, base, len);
}

// One grid-wide compare-exchange stage at half-width 2^lh over n elements
// (n / 2 pairs).  In place when kin == kout: every pair has one owner.
template <typename K>
__global__ void merge_global_stage(const K* kin, const int32_t* vin, K* kout,
                                   int32_t* vout, long long half_n, int lh,
                                   int flip) {
    const long long step = (long long)gridDim.x * blockDim.x;
    const long long mask = (1LL << lh) - 1;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < half_n; t += step) {
        const long long blk = t >> lh, off = t & mask;
        const long long a = (blk << (lh + 1)) + off;
        const long long b = flip ? (blk << (lh + 1)) + (2LL << lh) - 1 - off
                                 : a + (1LL << lh);
        const K ka = kin[a], kb = kin[b];
        const int32_t va = vin[a], vb = vin[b];
        const bool sw = ka > kb || (ka == kb && va > vb);
        kout[a] = sw ? kb : ka;
        kout[b] = sw ? ka : kb;
        vout[a] = sw ? vb : va;
        vout[b] = sw ? va : vb;
    }
}

static int ilog2(long long x) {
    int r = 0;
    while ((1LL << (r + 1)) <= x) ++r;
    return r;
}

template <typename K>
static int sort_tiles_impl(const void* kin, const void* vin, void* kout,
                           void* vout, long long n, int tile,
                           cudaStream_t s) {
    int threads = tile / 2;
    if (threads > BLOCK_THREADS) threads = BLOCK_THREADS;
    if (threads < 1) threads = 1;
    sort_tiles_kernel<K><<<(unsigned int)(n / tile), threads,
                           smem_bytes<K>(tile), s>>>(
        (const K*)kin, (const int32_t*)vin, (K*)kout, (int32_t*)vout, tile);
    return (int)cudaGetLastError();
}

template <typename K>
static int merge_pairs_impl(const void* kin, const void* vin, void* kout,
                            void* vout, long long n, long long width,
                            cudaStream_t s) {
    if (width <= SMEM_BLOCK) {
        int threads = (int)(width / 2);
        if (threads > BLOCK_THREADS) threads = BLOCK_THREADS;
        merge_block_kernel<K><<<(unsigned int)(n / width), threads,
                                smem_bytes<K>(width), s>>>(
            (const K*)kin, (const int32_t*)vin, (K*)kout, (int32_t*)vout,
            (int)width, 1);
        return (int)cudaGetLastError();
    }
    const unsigned int grid = grid_for(n / 2, STAGE_THREADS);
    merge_global_stage<K><<<grid, STAGE_THREADS, 0, s>>>(
        (const K*)kin, (const int32_t*)vin, (K*)kout, (int32_t*)vout, n / 2,
        ilog2(width) - 1, 1);
    int err = (int)cudaGetLastError();
    if (err) return err;
    for (long long j = width >> 2; j >= SMEM_BLOCK; j >>= 1) {
        merge_global_stage<K><<<grid, STAGE_THREADS, 0, s>>>(
            (const K*)kout, (const int32_t*)vout, (K*)kout, (int32_t*)vout,
            n / 2, ilog2(j), 0);
        err = (int)cudaGetLastError();
        if (err) return err;
    }
    merge_block_kernel<K><<<(unsigned int)(n / SMEM_BLOCK), BLOCK_THREADS,
                            smem_bytes<K>(SMEM_BLOCK), s>>>(
        (const K*)kout, (const int32_t*)vout, (K*)kout, (int32_t*)vout,
        SMEM_BLOCK, 0);
    return (int)cudaGetLastError();
}

extern "C" int rt_smem_block() { return SMEM_BLOCK; }

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
// two, n % width == 0).
extern "C" int rt_merge_pairs(int code, const void* kin, const void* vin,
                              void* kout, void* vout, long long n,
                              long long width, void* stream) {
    RT_DISPATCH_KEY(code, K,
        return merge_pairs_impl<K>(kin, vin, kout, vout, n, width,
                                   (cudaStream_t)stream));
    return 0;
}
