// The neighbour scorers of the HNSW graph kernels: K8 hnsw_graph_beam and
// K8-SQ hnsw_graph_beam_sq (hnsw_beam.cu) and K9 hnsw_greedy
// (hnsw_greedy.cu). A scorer names the neighbour in slot g of a node's list
// (adj[node, g]) and scores it against the query row held in shared memory,
// then applies gathered_distances' epilogue (L2 clamped at 0, COS 1 - dot,
// IP -dot) with the row's stored norm. Two ways:
// - `group_scores` (K8 over f32 rows; K6 has its own): a group of GROUP
//   lanes takes R rows at once, up to 4 groups x R rows in flight a warp,
//   each lane reading 16 bytes of a row in turn (128 contiguous bytes of the
//   row a load), every load of the R rows issued before their sums, then a
//   3-step shuffle sum;
// - `staged_score` (K8-SQ, and K9 over either store): a warp copies the up
//   to 32 rows it is about to score into its region of shared memory by
//   `cp.async` (stage_rows: neighbouring lanes on neighbouring words, every
//   copy of the batch issued before any is waited for, the rows' norms,
//   mins and scales loaded meanwhile), so a batch pays about one memory
//   round trip; then lane r scores staged row r alone, in one fmaf chain
//   over j = 0 .. d-1 (the dequantizing FMA min + scale * code first), so
//   each distance is the one the same per-row sum gave before the rows were
//   staged: the SQ store keeps that order, because summed by lane groups one
//   SQ16 query of chip_smoke's 1M check parted from the plain beam beyond
//   the tie band (its expansions split at a near tie, PERF.md).
//
// Staged layout: row r of a batch at r * sw 16-byte words, sw =
// stage_words(row bytes), the row's words rounded up to an odd count (K6's
// code rows and rerank rows in hnsw_beam.cu take the same layout). A
// 16-byte shared load runs in four phases of 8 lanes; lanes 8p .. 8p+7 read
// one offset of 8 rows, whose starts (r * sw mod 8 distinct for odd sw) then
// cover the 32 banks once: no conflict (a 128- or 512-byte stride would put
// all 8 on 4 banks). tests/test_torch_greedy_replay.py replays the layout.
//
// GraphScorer reads the f32 rows. SqScorer reads the SQ8 / SQ16 graph store
// (the reference's Sq8Rows: u8 or u16 codes and a per-row min and scale) and
// dequantizes on the gather as min + scale * code in one fused multiply-add,
// which is what the reference's compiled search computes (its eager
// dequantize rounds twice; see ROADMAP queue 3).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

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

// 16-byte words a staged row takes: its bytes rounded up to an odd number
// of words (see the layout above)
__host__ __device__ inline int stage_words(int row_bytes) { return ((row_bytes + 15) >> 4) | 1; }

// a staged row's norm, min and scale (f32 rows: min and scale unused)
struct RowMeta {
    float xn, m, s;
};

// acc + x . y over four elements in order, one fmaf each
__device__ __forceinline__ float dot4(float acc, float4 x, float4 y) {
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    return fmaf(x.w, y.w, acc);
}
// the same over four codes, each dequantized as m + s * code by one fmaf
__device__ __forceinline__ float deq_dot4(float acc, float4 u, float4 y, float m, float s) {
    acc = fmaf(fmaf(s, u.x, m), y.x, acc);
    acc = fmaf(fmaf(s, u.y, m), y.y, acc);
    acc = fmaf(fmaf(s, u.z, m), y.z, acc);
    return fmaf(fmaf(s, u.w, m), y.w, acc);
}
// four codes of a little-endian word (u8) or word pair (u16) as floats
// (exact: u8 and u16 fit a float)
__device__ __forceinline__ float4 u8x4(unsigned w) {
    return make_float4(w & 0xffu, (w >> 8) & 0xffu, (w >> 16) & 0xffu, w >> 24);
}
__device__ __forceinline__ float4 u16x4(unsigned lo, unsigned hi) {
    return make_float4(lo & 0xffffu, lo >> 16, hi & 0xffffu, hi >> 16);
}

struct GraphScorer {
    const int* adj;            // [cap, deg]
    const float* vectors;      // [cap, d]
    const float* norms;        // [cap]
    const float* q;            // [B, d]
    __host__ __device__ static size_t query_bytes(int d) { return (size_t)d * 4; }
    __host__ __device__ static int row_bytes(int d) { return d * 4; }
    // rows are staged by 16-byte copies (d % 4 == 0, 16-byte aligned rows)
    __device__ bool wide() const { return true; }
    __device__ void load(size_t b, int d, unsigned char* s) const {
        float* sq = reinterpret_cast<float*>(s);
        for (int i = threadIdx.x; i < d; i += blockDim.x) sq[i] = q[b * d + i];
    }
    __device__ int neighbour(int node, int g, int deg) const {
        return adj[(size_t)node * deg + g];
    }
    __device__ const unsigned char* row(int id, int d) const {
        return reinterpret_cast<const unsigned char*>(vectors + (size_t)id * d);
    }
    __device__ RowMeta meta(int id) const { return RowMeta{__ldg(norms + id), 0.0f, 0.0f}; }
    // a staged row's dot with the query, j = 0 .. d-1 in order
    __device__ float staged_dot(const unsigned char* srow, const unsigned char* s, int d,
                                const RowMeta&) const {
        const float4* x4 = reinterpret_cast<const float4*>(srow);
        const float4* q4 = reinterpret_cast<const float4*>(s);
        float acc = 0.0f;
        for (int j = 0; j < (d >> 2); ++j) acc = dot4(acc, x4[j], q4[j]);
        return acc;
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

template <typename CodeT>
struct SqScorer {
    const int* adj;            // [cap, deg]
    const CodeT* codes;        // [cap, d] u8 or u16
    const float* mins;         // [cap]
    const float* scales;       // [cap]
    const float* norms;        // [cap] the exact f32 norms
    const float* q;            // [B, d]
    int wide16;                // rows are staged by 16-byte copies (else 4-byte)
    int srows, sw;             // K8-SQ: rows a warp stages at once, 16-byte words a row
    __host__ __device__ static size_t query_bytes(int d) { return (size_t)d * 4; }
    __host__ __device__ static int row_bytes(int d) { return d * (int)sizeof(CodeT); }
    __device__ bool wide() const { return wide16 != 0; }
    __device__ void load(size_t b, int d, unsigned char* s) const {
        float* sq = reinterpret_cast<float*>(s);
        for (int i = threadIdx.x; i < d; i += blockDim.x) sq[i] = q[b * d + i];
    }
    __device__ int neighbour(int node, int g, int deg) const {
        return adj[(size_t)node * deg + g];
    }
    __device__ const unsigned char* row(int id, int d) const {
        return reinterpret_cast<const unsigned char*>(codes + (size_t)id * d);
    }
    __device__ RowMeta meta(int id) const {
        return RowMeta{__ldg(norms + id), __ldg(mins + id), __ldg(scales + id)};
    }
    // a staged row's dot with the query: the codes in order 0 .. d-1, read
    // a 16-byte word (16 u8 or 8 u16 codes) at a time, the last d % 16 (u8)
    // or d % 8 (u16) codes four at a time
    __device__ float staged_dot(const unsigned char* srow, const unsigned char* s, int d,
                                const RowMeta& rm) const {
        const float4* q4 = reinterpret_cast<const float4*>(s);
        const uint4* w = reinterpret_cast<const uint4*>(srow);
        float acc = 0.0f;
        if constexpr (sizeof(CodeT) == 1) {
            int c = 0;
            for (; c < (d >> 4); ++c) {
                const uint4 v = w[c];
                acc = deq_dot4(acc, u8x4(v.x), q4[4 * c], rm.m, rm.s);
                acc = deq_dot4(acc, u8x4(v.y), q4[4 * c + 1], rm.m, rm.s);
                acc = deq_dot4(acc, u8x4(v.z), q4[4 * c + 2], rm.m, rm.s);
                acc = deq_dot4(acc, u8x4(v.w), q4[4 * c + 3], rm.m, rm.s);
            }
            const unsigned* w1 = reinterpret_cast<const unsigned*>(srow);
            for (int j = 4 * c; j < (d >> 2); ++j)
                acc = deq_dot4(acc, u8x4(w1[j]), q4[j], rm.m, rm.s);
        } else {
            int c = 0;
            for (; c < (d >> 3); ++c) {
                const uint4 v = w[c];
                acc = deq_dot4(acc, u16x4(v.x, v.y), q4[2 * c], rm.m, rm.s);
                acc = deq_dot4(acc, u16x4(v.z, v.w), q4[2 * c + 1], rm.m, rm.s);
            }
            const uint2* w2 = reinterpret_cast<const uint2*>(srow);
            for (int j = 2 * c; j < (d >> 2); ++j) {
                const uint2 v = w2[j];
                acc = deq_dot4(acc, u16x4(v.x, v.y), q4[j], rm.m, rm.s);
            }
        }
        return acc;
    }
};

// Copy the rows of a warp's batch into `stage` (row r at r * sw words):
// lane r < n holds row r's id (-1: none; K6 passes a code row's 64-bit
// index, sc.row's argument). The copies are 16-byte words (4-byte where a
// row is not whole, aligned 16-byte words), copy e of the batch (row e /
// rw, word e % rw) by lane e % 32, so that neighbouring lanes read
// neighbouring words; none is waited for here. All 32 lanes call.
template <class Scorer, class Id>
__device__ __forceinline__ void stage_rows(const Scorer& sc, unsigned char* stage, int sw, Id id,
                                           int n, int d, int lane) {
    const int wb = sc.wide() ? 16 : 4;
    const int rw = Scorer::row_bytes(d) / wb;    // copies a row
    const int total = n * rw;
    const bool pow2 = (rw & (rw - 1)) == 0;      // d = 128: 8, 16 or 32 copies a row
    const int sh = __popc(rw - 1);
    for (int e0 = 0; e0 < total; e0 += 32) {
        const int e = e0 + lane;
        const int r = e >= total ? 0 : pow2 ? e >> sh : e / rw;
        const Id rid = __shfl_sync(0xffffffffu, id, r);
        if (e < total && rid >= 0) {
            const int w = e - r * rw;
            unsigned char* dst = stage + ((size_t)r * sw << 4) + (size_t)w * wb;
            const unsigned char* src = sc.row(rid, d) + (size_t)w * wb;
            if (sc.wide()) stage_copy16(dst, src);
            else stage_copy4(dst, src);
        }
    }
}

// The distance of lane r's row (r < n, id >= 0; +inf for a lane with none)
// among a batch of a warp's rows: staged by stage_rows (with the rows' norm,
// min and scale loaded while the copies fly), then scored from shared
// memory in the row's own order. `s` is the query row (f32) in shared
// memory, `stage` the warp's region of n * sw words. All 32 lanes call.
template <class Scorer>
__device__ __forceinline__ float staged_score(const Scorer& sc, unsigned char* stage, int sw,
                                              int id, int n, const unsigned char* s, int d,
                                              float qnb, int metric, int lane) {
    __syncwarp();   // the last batch's reads of the region are done
    stage_rows(sc, stage, sw, id, n, d, lane);
    const RowMeta rm = id >= 0 ? sc.meta(id) : RowMeta{0.0f, 0.0f, 0.0f};
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    if (id < 0) return __int_as_float(0x7f800000);
    const float acc = sc.staged_dot(stage + ((size_t)lane * sw << 4), s, d, rm);
    return gathered_epilogue(acc, qnb, rm.xn, metric);
}
