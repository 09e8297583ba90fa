// Adjacent-unique mask over lexsorted rows: the Hopper port of the Pallas
// kernel `unique_mask` (`_unique_kernel`) in src/repro/kernels/unique_mask.py.
//
// mask[i] = 1 iff row i is not PAD (its column 0 is not the dtype max) and
// row i differs from row i-1; row 0 counts as differing.
//
// Bound.  One pass: each row is read once by its own thread and once more
// by the next row's thread (an L1/L2 hit), and one int32 is written per
// row, so the kernel is bound by device-memory bytes.  Row i-1 is read in
// place: there is no shifted copy of the input, which the reference builds
// to feed its block specs.  One thread per row; neighbouring threads read
// neighbouring rows, so loads coalesce.
#include "common.cuh"

#define UNIQUE_THREADS 256

template <typename K>
__global__ void unique_mask_kernel(const K* data, int32_t* out, long long n,
                                   int c) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        const K* row = data + i * c;
        int32_t keep = 0;
        if (row[0] != KeyMax<K>::value) {
            keep = i == 0;
            const K* prev = row - c;
            for (int k = 0; k < c && !keep; ++k)
                keep = row[k] != prev[k];
        }
        out[i] = keep;
    }
}

// data (n, c) row-major of the dtype `code`; out (n,) int32.
extern "C" int rt_unique_mask(int code, const void* data, void* out,
                              long long n, int c, void* stream) {
    RT_DISPATCH_KEY(code, K,
        unique_mask_kernel<K><<<grid_for(n, UNIQUE_THREADS), UNIQUE_THREADS,
                                0, (cudaStream_t)stream>>>(
            (const K*)data, (int32_t*)out, n, c));
    return (int)cudaGetLastError();
}
