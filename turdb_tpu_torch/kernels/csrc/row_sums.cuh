// The sums of several rows' partial dots across a warp, shared by K1's
// fast form (ivf_probe.cu), K1's and K5's wide distance passes
// (probe_wide.cu), and K6 wide's rerank and K9 wide (graph_wide.cu):
// a lane holds a partial sum of every row, and a transposing butterfly
// leaves each lane one row's sum, bit for bit the plain butterfly's.
#pragma once
#include <cuda_runtime.h>

// p ? a : b through selp: the optimizer may turn a plain select of two
// array elements into a select of their addresses, which puts the array in
// local memory
__device__ __forceinline__ float pick(bool p, float a, float b) {
    float r;
    asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.f32 %0, %1, %2, q;\n}"
        : "=f"(r)
        : "f"(a), "f"(b), "r"((int)p));
    return r;
}
__device__ __forceinline__ int pick(bool p, int a, int b) {
    int r;
    asm("{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n selp.b32 %0, %1, %2, q;\n}"
        : "=r"(r)
        : "r"(a), "r"(b), "r"((int)p));
    return r;
}

template <int R>
struct Log2 {
    static_assert(R == 1 || R == 2 || R == 4 || R == 8 || R == 16 || R == 32,
                  "a power of two <= 32");
    static constexpr int value = R == 1 ? 0 : R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : R == 16 ? 4 : 5;
};

// The sums of R rows over groups of W lanes (W = 32: the warp), each lane
// holding a partial v[r] of every row of its group. The offsets run W/2,
// ..., 2, 1 as in a plain butterfly; at the first log2(R) of them a lane
// keeps half of its rows (the upper half when its offset bit is set) and
// adds its partner's copy of those, so each addition is own + partner's of
// the same row and lane group: the plain butterfly's value, bit for bit.
// Returns the sum of row (lane % W) >> (log2(W) - log2(R)).
template <int R, int W, class T>
__device__ __forceinline__ T reduce_rows(T (&v)[R], int lane) {
    constexpr int LOG = Log2<R>::value;
#pragma unroll
    for (int s = 0; s < LOG; ++s) {
        const int n = R >> s, o = (W / 2) >> s;
        const bool upper = (lane & o) != 0;
#pragma unroll
        for (int i = 0; i < n / 2; ++i) {
            const T lo = v[i], hi = v[i + n / 2];
            const T send = pick(upper, lo, hi);
            const T keep = pick(upper, hi, lo);
            v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
    }
    T s = v[0];
#pragma unroll
    for (int o = (W / 2) >> LOG; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}
