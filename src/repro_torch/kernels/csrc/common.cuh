// Shared helpers for the port's hand-written Hopper kernels.
//
// Every C entry point takes a store-dtype code (the key's size in bytes:
// 2 = int16, 4 = int32, 8 = int64), raw device pointers and the caller's
// CUDA stream, launches on that stream without synchronising, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

template <typename K> struct KeyMax;
template <> struct KeyMax<int16_t> { static constexpr int16_t value = INT16_MAX; };
template <> struct KeyMax<int32_t> { static constexpr int32_t value = INT32_MAX; };
template <> struct KeyMax<int64_t> { static constexpr int64_t value = INT64_MAX; };

// Grid for a one-element-per-thread kernel with a grid-stride loop.
static inline unsigned int grid_for(long long n, int threads) {
    long long blocks = (n + threads - 1) / threads;
    const long long cap = 132LL * 32;  // 32 blocks per SM on an H100 covers it
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return (unsigned int)blocks;
}

#define RT_DISPATCH_KEY(code, K, ...)                              \
    switch (code) {                                                \
        case 2: { typedef int16_t K; __VA_ARGS__; break; }         \
        case 4: { typedef int32_t K; __VA_ARGS__; break; }         \
        case 8: { typedef int64_t K; __VA_ARGS__; break; }         \
        default: return (int)cudaErrorInvalidValue;                \
    }
