// Helpers of the wide forms (hnsw_select_wide.cu, graph_wide.cu,
// probe_wide.cu): the kernels that answer past the widths their fast forms
// keep in shared memory or registers. A wide form keeps its per-query (or
// per-target) state in a global scratch slice of its block, which the
// wrapper allocates (the wide beams: in the block's shared memory where it
// fits, graph_wide.cu), and reads rows from device memory at any width.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_util.cuh"

#define WIDE_FULL 0xffffffffu
#define WIDE_INF __int_as_float(0x7f800000)

__host__ __device__ inline int pow2_ge(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

__host__ __device__ inline size_t wide_align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Sort keys[0, n) ascending in place, a bitonic network over the next power
// of two (the tail padded with ~0; keys must have room for it). All threads
// of the block call; a barrier ends it.
__device__ inline void block_sort_keys(u64* keys, int n) {
    const int np = pow2_ge(n);
    for (int i = n + threadIdx.x; i < np; i += blockDim.x) keys[i] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= np; size <<= 1)
        for (int j = size >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < np; i += blockDim.x) {
                const int l = i ^ j;
                if (l > i) {
                    const u64 x = keys[i], y = keys[l];
                    if ((x > y) == ((i & size) == 0)) {
                        keys[i] = y;
                        keys[l] = x;
                    }
                }
            }
            __syncthreads();
        }
}

// x . y over d floats (d % 4 == 0, 16-byte aligned rows) by one warp: lane
// l sums float4 l, l + 32, ... in one fmaf chain, then an xor butterfly
// (K1's order for a probe row). All 32 lanes call; every lane gets the sum.
__device__ __forceinline__ float warp_dot(const float* x, const float* y, int d, int lane) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float acc = 0.0f;
    for (int c = lane; c < (d >> 2); c += 32) {
        const float4 a = __ldg(x4 + c), b = __ldg(y4 + c);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(WIDE_FULL, acc, o);
    return acc;
}
