// K4's int8 row scorers, shared by its fast form (ivf_probe.cu) and its
// wide query-major pass (probe_wide.cu): a warp's rows in flight dotted
// exactly with the query's int8 row (int32 sums, the same in any order),
// and the dequantize epilogue.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_sums.cuh"

// A scorer reads a batch of R rows with the lanes of a warp in groups of W:
// a lane takes SLOTS = R * W / 32 of them (slot i: batch row slot_row(i)),
// and after reduce_rows it holds the sum of batch row held_row(lane).
template <int R_, int W_>
struct RowLayout {
    static constexpr int R = R_, W = W_, SLOTS = R_ * W_ / 32;
    static_assert(SLOTS >= 1 && SLOTS <= W_, "a lane group holds 1..W rows");
    __device__ static int slot_row(int i, int lane) { return i * (32 / W) + lane / W; }
    __device__ static int held_row(int lane) {
        return slot_row((lane % W) >> (Log2<W>::value - Log2<SLOTS>::value), lane);
    }
    // one lane of those holding a row writes its key
    __device__ static bool writer(int lane) { return (lane & (W / SLOTS - 1)) == 0; }
};

// K4's distance from an exact int8 dot: mins*q_sum + scales*(qs*dot), then
// L2 (qn - 2*that) + pnorms, COSINE 1 - that, IP -that
__device__ __forceinline__ float sq8_distance(int dot, float mins, float scales, float pnorm,
                                              float qs, float qsum, float qn, int metric) {
    const float qdx = __fadd_rn(__fmul_rn(mins, qsum),
                                __fmul_rn(scales, __fmul_rn(qs, __int2float_rn(dot))));
    if (metric == 1) return __fsub_rn(1.0f, qdx);
    if (metric == 2) return -qdx;
    return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.0f, qdx)), pnorm);
}

// Rows of any width d % 4 == 0, a warp a row: lane j takes code words j,
// j + 32, ... of each of its SLOTS rows (-1: none) against the query's
// words sw, J words of every row loaded before any is summed.
template <int SLOTS, int J>
__device__ __forceinline__ void sq8_words_partial(const int8_t* __restrict__ codes, const int* sw,
                                                  const int (&rows)[SLOTS], int lane, int d,
                                                  int (&v)[SLOTS]) {
    const int nw = d >> 2;
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) v[r] = 0;
    for (int j0 = lane; j0 < nw; j0 += 32 * J) {
        int w[J][SLOTS];
#pragma unroll
        for (int u = 0; u < J; ++u) {
            const int j = j0 + 32 * u;
#pragma unroll
            for (int r = 0; r < SLOTS; ++r)
                w[u][r] = rows[r] >= 0 && j < nw
                              ? __ldg(reinterpret_cast<const int*>(codes + (size_t)rows[r] * d) + j)
                              : 0;
        }
#pragma unroll
        for (int u = 0; u < J; ++u) {
            const int j = j0 + 32 * u;
            if (j < nw) {
                const int qw = sw[j];
#pragma unroll
                for (int r = 0; r < SLOTS; ++r) v[r] = __dp4a(w[u][r], qw, v[r]);
            }
        }
    }
}

// Rows in 16-byte words (d % 16 == 0, codes 16-byte aligned), eight lanes
// a row: lane j of a group takes words j, j + 8, ... of each of its SLOTS
// rows against the query's words sq, J words of every row loaded before any
// is summed; a warp reads four rows an instruction.
template <int SLOTS, int J>
__device__ __forceinline__ void sq8_groups_partial(const int8_t* __restrict__ codes, const int4* sq,
                                                   const int (&rows)[SLOTS], int lane, int d,
                                                   int (&v)[SLOTS]) {
    const int nw = d >> 4;
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) v[r] = 0;
    for (int j0 = lane & 7; j0 < nw; j0 += 8 * J) {
        int4 w[J][SLOTS];
#pragma unroll
        for (int u = 0; u < J; ++u) {
            const int j = j0 + 8 * u;
#pragma unroll
            for (int r = 0; r < SLOTS; ++r)
                w[u][r] = rows[r] >= 0 && j < nw
                              ? __ldg(reinterpret_cast<const int4*>(codes + (size_t)rows[r] * d) + j)
                              : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < J; ++u) {
            const int j = j0 + 8 * u;
            if (j < nw) {
                const int4 q = sq[j];
#pragma unroll
                for (int r = 0; r < SLOTS; ++r) {
                    v[r] = __dp4a(w[u][r].x, q.x, v[r]);
                    v[r] = __dp4a(w[u][r].y, q.y, v[r]);
                    v[r] = __dp4a(w[u][r].z, q.z, v[r]);
                    v[r] = __dp4a(w[u][r].w, q.w, v[r]);
                }
            }
        }
    }
}
