// The neighbour scorers of the HNSW graph kernels: K8 hnsw_graph_beam and
// K8-SQ hnsw_graph_beam_sq (hnsw_beam.cu) and K9 hnsw_greedy
// (hnsw_greedy.cu). A scorer names the neighbour in slot g of a node's list
// (adj[node, g]) and scores it against the query row held in shared memory,
// then applies gathered_distances' epilogue (L2 clamped at 0, COS 1 - dot,
// IP -dot) with the row's stored norm. Two ways: `score`, one thread reads
// the whole row and sums its fp32 products in order (K9, a lane a
// neighbour); `group_scores`, a group of GROUP lanes takes R rows at once
// (K6 / K8: up to 4 groups x R rows in flight a warp). GraphScorer's group
// reads each row together, each lane 16 bytes in turn (128 contiguous bytes
// of the row a load, so the loads use whole lines), every load of the R rows
// issued before their sums, then a 3-step shuffle sum; SqScorer's lanes
// each score a row of the group's R alone.
//
// GraphScorer reads the f32 rows. SqScorer reads the SQ8 / SQ16 graph store
// (the reference's Sq8Rows: u8 or u16 codes and a per-row min and scale) and
// dequantizes on the gather as min + scale * code in one fused multiply-add,
// which is what the reference's compiled search computes (its eager
// dequantize rounds twice; see ROADMAP queue 3).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define GROUP 8   // lanes that read one row in group_scores

// the sums of a lane group (aligned groups of GROUP lanes; all 32 lanes call)
__device__ __forceinline__ float group_sum(float v) {
    for (int o = GROUP >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
__device__ __forceinline__ int group_sum(int v) {
    for (int o = GROUP >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float gathered_epilogue(float acc, float qnb, float xn, int metric) {
    if (metric == 0) return fmaxf(__fsub_rn(__fadd_rn(qnb, xn), __fmul_rn(2.0f, acc)), 0.0f);
    if (metric == 1) return __fsub_rn(1.0f, acc);
    return -acc;
}

struct GraphScorer {
    const int* adj;            // [cap, deg]
    const float* vectors;      // [cap, d]
    const float* norms;        // [cap]
    const float* q;            // [B, d]
    __host__ __device__ static size_t query_bytes(int d) { return (size_t)d * 4; }
    __device__ void load(size_t b, int d, unsigned char* s) const {
        float* sq = reinterpret_cast<float*>(s);
        for (int i = threadIdx.x; i < d; i += blockDim.x) sq[i] = q[b * d + i];
    }
    __device__ int neighbour(int node, int g, int deg) const {
        return adj[(size_t)node * deg + g];
    }
    // one thread: the distance of neighbour `id` (slot g of `node`'s list)
    __device__ float score(const unsigned char* s, int node, int g, int id, int d, int deg,
                           float qnb, int metric) const {
        const float4* q4 = reinterpret_cast<const float4*>(s);
        const float4* x4 = reinterpret_cast<const float4*>(vectors + (size_t)id * d);
        float acc = 0.0f;
        for (int j = 0; j < (d >> 2); ++j) {
            const float4 x = x4[j], y = q4[j];
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
            acc = fmaf(x.z, y.z, acc);
            acc = fmaf(x.w, y.w, acc);
        }
        return gathered_epilogue(acc, qnb, norms[id], metric);
    }
    // lane `sub` of a group: rows id[0, R) (-1: none; every lane of a group
    // has the same rows), the distances in out[] on every lane of the group
    template <int R>
    __device__ __forceinline__ void group_scores(const unsigned char* s, const int* node,
                                                 const int* g, const int* id, int d, int deg,
                                                 int sub, float qnb, int metric,
                                                 float* out) const {
        const float4* q4 = reinterpret_cast<const float4*>(s);
        float acc[R], xn[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            acc[r] = 0.0f;
            xn[r] = id[r] >= 0 ? __ldg(norms + id[r]) : 0.0f;
        }
#pragma unroll 4
        for (int c = sub; c < (d >> 2); c += GROUP) {
            float4 x[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
                x[r] = id[r] >= 0
                           ? __ldg(reinterpret_cast<const float4*>(vectors + (size_t)id[r] * d) + c)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float4 y = q4[c];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                acc[r] = fmaf(x[r].x, y.x, acc[r]);
                acc[r] = fmaf(x[r].y, y.y, acc[r]);
                acc[r] = fmaf(x[r].z, y.z, acc[r]);
                acc[r] = fmaf(x[r].w, y.w, acc[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
            out[r] = gathered_epilogue(group_sum(acc[r]), qnb, xn[r], metric);
    }
};

// four codes of a row as floats (exact: u8 and u16 fit a float)
__device__ __forceinline__ float4 codes4(const uint8_t* p) {
    const uchar4 v = *reinterpret_cast<const uchar4*>(p);
    return make_float4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ float4 codes4(const uint16_t* p) {
    const ushort4 v = *reinterpret_cast<const ushort4*>(p);
    return make_float4(v.x, v.y, v.z, v.w);
}

template <typename CodeT>
struct SqScorer {
    const int* adj;            // [cap, deg]
    const CodeT* codes;        // [cap, d] u8 or u16
    const float* mins;         // [cap]
    const float* scales;       // [cap]
    const float* norms;        // [cap] the exact f32 norms
    const float* q;            // [B, d]
    __host__ __device__ static size_t query_bytes(int d) { return (size_t)d * 4; }
    __device__ void load(size_t b, int d, unsigned char* s) const {
        float* sq = reinterpret_cast<float*>(s);
        for (int i = threadIdx.x; i < d; i += blockDim.x) sq[i] = q[b * d + i];
    }
    __device__ int neighbour(int node, int g, int deg) const {
        return adj[(size_t)node * deg + g];
    }
    __device__ float score(const unsigned char* s, int node, int g, int id, int d, int deg,
                           float qnb, int metric) const {
        const float4* q4 = reinterpret_cast<const float4*>(s);
        const CodeT* c = codes + (size_t)id * d;
        const float m = mins[id], sc = scales[id];
        float acc = 0.0f;
        for (int j = 0; j < (d >> 2); ++j) {
            const float4 u = codes4(c + 4 * j), y = q4[j];
            acc = fmaf(fmaf(sc, u.x, m), y.x, acc);
            acc = fmaf(fmaf(sc, u.y, m), y.y, acc);
            acc = fmaf(fmaf(sc, u.z, m), y.z, acc);
            acc = fmaf(fmaf(sc, u.w, m), y.w, acc);
        }
        return gathered_epilogue(acc, qnb, norms[id], metric);
    }
    // a lane group's R rows: lane r of the group scores row r alone, in
    // `score`'s order, and the group shares the results. The SQ store keeps
    // that per-row sum: summed by lane groups, one SQ16 query of
    // chip_smoke's 1M check parted from the plain beam beyond the tie band
    // (its expansions split at a near tie, PERF.md).
    template <int R>
    __device__ __forceinline__ void group_scores(const unsigned char* s, const int* node,
                                                 const int* g, const int* id, int d, int deg,
                                                 int sub, float qnb, int metric,
                                                 float* out) const {
        int mine = -1;
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (sub == r) mine = id[r];
        const float v = mine >= 0 ? score(s, 0, 0, mine, d, deg, qnb, metric) : 0.0f;
        const int base = (threadIdx.x & 31) & ~(GROUP - 1);
#pragma unroll
        for (int r = 0; r < R; ++r) out[r] = __shfl_sync(0xffffffffu, v, base + r);
    }
};
