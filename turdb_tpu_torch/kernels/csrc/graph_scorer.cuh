// The neighbour scorers of the HNSW graph kernels: K8 hnsw_graph_beam and
// K8-SQ hnsw_graph_beam_sq (hnsw_beam.cu) and K9 hnsw_greedy
// (hnsw_greedy.cu). A scorer names the neighbour in slot g of a node's list
// (adj[node, g]) and scores it against the query row held in shared memory:
// one thread reads the whole row and sums its fp32 products in order, then
// applies gathered_distances' epilogue (L2 clamped at 0, COS 1 - dot, IP
// -dot) with the row's stored norm.
//
// GraphScorer reads the f32 rows. SqScorer reads the SQ8 / SQ16 graph store
// (the reference's Sq8Rows: u8 or u16 codes and a per-row min and scale) and
// dequantizes on the gather as min + scale * code in one fused multiply-add,
// which is what the reference's compiled search computes (its eager
// dequantize rounds twice; see ROADMAP queue 3).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

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
};
