// The wide forms of the IVF probes and the rerank: K1 ivf_probe_f32 and
// K4 ivf_probe_sq8 (query-major) past m = SEL_MAX winners, the dedup tail
// of both probes (and of K4's cell-major pass) past it, and K5 ivf_rerank
// past r = SEL_MAX candidates. The fast forms (ivf_probe.cu, ivf_rerank.cu)
// select inside one block over shared memory, m or r at most SEL_MAX.
//
// Replaces, as the fast forms do: turdb_tpu/models/ivf.py ivf_search_impl
// (the probe, mask_duplicates and the top-k; the rerank branch). Reached by
// an IVF search with k or rerank past 2048 and by SQL `ORDER BY emb <-> ...
// LIMIT 513` and deeper on a USING IVF index (fetch = 4*LIMIT).
//
// What bounds it on an H100: the rows read (P*L of 4d or d bytes a query;
// r rows for the rerank) and the [rows, P*L] or [B, r] f32 distances
// written and read back by the selection. A correctness path, not tuned.
//
// Design: write-then-select, as K4's cell-major pass already runs.
//  - probe_dist_*_kernel: one block a (query, probe), a warp a lane: every
//    lane's distance, +inf for empty, dead and unallowed lanes, to
//    dist[b, p*L + lane], the query's own lane order. K1's dot is its fast
//    form's (lane j over float4 j, j + 32, ... in one fmaf chain, an xor
//    butterfly) and epilogue, K4's the exact int8 dot and its epilogue, so
//    the distances are the fast forms' bit for bit.
//  - K2 (topk_rows.cu) selects each row's m best by (value, position).
//  - probe_tail_wide_kernel: one block a row, the fast tail over the
//    selection (ivf_probe.cu probe_tail) with its winners in global
//    scratch: the first copy of an id wins, then the first k survivors; or
//    all m with their flat positions cell*L + lane.
//  - rerank_dist_wide_kernel: one block a query, a warp a candidate: K5's
//    exact distance in K5's order, +inf where the probe's was, and under
//    replicas +inf on later copies of an id and on id -1. K2 then selects
//    the k smallest by (distance, candidate index).
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_util.cuh"

#define PW_THREADS 256
#define PW_WARPS (PW_THREADS / 32)

enum { PW_TOPK = 0, PW_CAND = 1 };

struct ProbeCells {
    const int* cells;          // [B, P]
    int P, L;
    const int* members;        // [NB, L] ids, -1 empty
    const uint8_t* alive;      // [NB, L]
    const uint8_t* allowed;    // [NB, L] or null
};

__device__ __forceinline__ bool lane_live(const ProbeCells& c, size_t row) {
    return c.members[row] >= 0 && c.alive[row] != 0 && (c.allowed == nullptr || c.allowed[row] != 0);
}

// K1's distances: block (b, p), warps over the cell's lanes
__global__ void __launch_bounds__(PW_THREADS)
probe_dist_f32_kernel(ProbeCells c, const float* __restrict__ q, const float* __restrict__ qn,
                      const float* __restrict__ pvecs, const float* __restrict__ pnorms, int d,
                      int metric, float* __restrict__ dist) {
    const size_t b = blockIdx.x / c.P;
    const int p = blockIdx.x - (int)(b * c.P);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t cell = (size_t)c.cells[b * c.P + p];
    const float qnb = qn[b];
    float* out = dist + (b * c.P + p) * (size_t)c.L;
    for (int l = warp; l < c.L; l += PW_WARPS) {
        const size_t row = cell * c.L + l;
        float v = WIDE_INF;
        if (lane_live(c, row)) {
            const float dot = warp_dot(pvecs + row * d, q + b * d, d, lane);
            if (metric == 0) v = __fsub_rn(__fadd_rn(qnb, pnorms[row]), __fmul_rn(2.0f, dot));
            else if (metric == 1) v = __fsub_rn(1.0f, dot);
            else v = -dot;
        }
        if (lane == 0) out[l] = v;
    }
}

// K4's distances: the exact int8 dot (lane j over words j, j + 32, ...) and
// the dequantize epilogue, rounded as ivf_probe.cu sq8_distance
__global__ void __launch_bounds__(PW_THREADS)
probe_dist_sq8_kernel(ProbeCells c, const int8_t* __restrict__ qc, const float* __restrict__ qs,
                      const float* __restrict__ qsum, const float* __restrict__ qn,
                      const int8_t* __restrict__ codes, const float* __restrict__ mins,
                      const float* __restrict__ scales, const float* __restrict__ pnorms, int d,
                      int metric, float* __restrict__ dist) {
    const size_t b = blockIdx.x / c.P;
    const int p = blockIdx.x - (int)(b * c.P);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t cell = (size_t)c.cells[b * c.P + p];
    const float qnb = qn[b], qsb = qs[b], qsumb = qsum[b];
    const int* qw = reinterpret_cast<const int*>(qc + b * d);
    float* out = dist + (b * c.P + p) * (size_t)c.L;
    for (int l = warp; l < c.L; l += PW_WARPS) {
        const size_t row = cell * c.L + l;
        float v = WIDE_INF;
        if (lane_live(c, row)) {
            const int* xw = reinterpret_cast<const int*>(codes + row * d);
            int dot = 0;
            for (int j = lane; j < (d >> 2); j += 32) dot = __dp4a(__ldg(xw + j), __ldg(qw + j), dot);
            for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(WIDE_FULL, dot, o);
            const float qdx = __fadd_rn(__fmul_rn(mins[row], qsumb),
                                        __fmul_rn(scales[row], __fmul_rn(qsb, __int2float_rn(dot))));
            if (metric == 1) v = __fsub_rn(1.0f, qdx);
            else if (metric == 2) v = -qdx;
            else v = __fadd_rn(__fsub_rn(qnb, __fmul_rn(2.0f, qdx)), pnorms[row]);
        }
        if (lane == 0) out[l] = v;
    }
}

// The m winners of row b (K2's selection: sel_d ascending, sel_pos their
// columns p*L + lane) -> the probe's outputs, as ivf_probe.cu probe_tail.
// wid / flag: [B, m] scratch.
__global__ void __launch_bounds__(PW_THREADS)
probe_tail_wide_kernel(ProbeCells c, const float* __restrict__ sel_d,
                       const int* __restrict__ sel_pos, int k, int m, int replicated, int mode,
                       int* __restrict__ wid, int* __restrict__ flag, float* __restrict__ out_d,
                       int* __restrict__ out_i, int* __restrict__ out_pos) {
    const size_t b = blockIdx.x;
    const int tid = threadIdx.x;
    int* ids = wid + b * m;
    int* keep = flag + b * m;
    for (int i = tid; i < m; i += PW_THREADS) {
        const int col = sel_pos[b * m + i];
        const int p = col / c.L, l = col - p * c.L;
        const int cell = c.cells[b * c.P + p];
        const int id = c.members[(size_t)cell * c.L + l];
        const uint32_t key = f2key(sel_d[b * m + i]);
        if (mode == PW_CAND) {
            out_d[b * m + i] = key2f(key);
            out_i[b * m + i] = id;
            out_pos[b * m + i] = cell * c.L + l;
        }
        ids[i] = id;
        keep[i] = key < INF_KEY;
    }
    if (mode == PW_CAND) return;
    __syncthreads();
    if (replicated)
        for (int i = tid; i < m; i += PW_THREADS) {
            bool k1 = keep[i] != 0;
            const int id = ids[i];
            for (int j = 0; j < i && k1; ++j) k1 = ids[j] != id;
            keep[i] = k1;   // a later copy reads only earlier entries' ids
        }
    __syncthreads();
    if (tid == 0) {
        int o = 0;
        for (int i = 0; i < m && o < k; ++i)
            if (keep[i]) {
                out_d[b * k + o] = key2f(f2key(sel_d[b * m + i]));
                out_i[b * k + o] = ids[i];
                ++o;
            }
        for (; o < k; ++o) {
            out_d[b * k + o] = WIDE_INF;
            out_i[b * k + o] = -1;
        }
    }
}

// K5's exact distances of query b's r candidates to ex[b, r]
template <bool SQ16>
__global__ void __launch_bounds__(PW_THREADS)
rerank_dist_wide_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                        const float* __restrict__ cand_d, const int* __restrict__ cand_i,
                        const int* __restrict__ cand_pos, int r, const void* __restrict__ rows,
                        const float* __restrict__ pnorms, const float* __restrict__ mins,
                        const float* __restrict__ scales, int d, int replicated,
                        float* __restrict__ ex) {
    const size_t b = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float qnb = qn[b];
    const float4* q4 = reinterpret_cast<const float4*>(q + b * d);
    const float s16_ratio = (float)(255.0 / 65535.0);
    for (int i = warp; i < r; i += PW_WARPS) {
        const size_t o = b * r + i;
        const int pos = isinf(cand_d[o]) ? -1 : cand_pos[o];
        float v = WIDE_INF;
        if (pos >= 0) {
            float acc = 0.0f;
            if (SQ16) {
                const ushort4* u4 =
                    reinterpret_cast<const ushort4*>(static_cast<const uint16_t*>(rows) + (size_t)pos * d);
                const float sr = scales[pos];
                const float base = __fsub_rn(mins[pos], __fmul_rn(128.0f, sr));
                const float s16 = __fmul_rn(sr, s16_ratio);
                for (int j = lane; j < (d >> 2); j += 32) {
                    const ushort4 u = u4[j];
                    const float4 y = q4[j];
                    acc = fmaf(__fadd_rn(base, __fmul_rn(s16, (float)u.x)), y.x, acc);
                    acc = fmaf(__fadd_rn(base, __fmul_rn(s16, (float)u.y)), y.y, acc);
                    acc = fmaf(__fadd_rn(base, __fmul_rn(s16, (float)u.z)), y.z, acc);
                    acc = fmaf(__fadd_rn(base, __fmul_rn(s16, (float)u.w)), y.w, acc);
                }
                for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(WIDE_FULL, acc, off);
            } else {
                acc = warp_dot(static_cast<const float*>(rows) + (size_t)pos * d, q + b * d, d, lane);
            }
            v = __fsub_rn(__fadd_rn(qnb, pnorms[pos]), __fmul_rn(2.0f, acc));
        }
        if (replicated) {  // mask_duplicates: later copies of an id, and id -1
            const int id = cand_i[o];
            bool dup = id == -1;
            for (int j = lane; j < i && !dup; j += 32) dup = cand_i[b * r + j] == id;
            if (__any_sync(WIDE_FULL, dup)) v = WIDE_INF;
        }
        if (lane == 0) ex[o] = v;
    }
}

struct ProbeWideCheck {
    static bool ok(int B, int P, int L, int d, int metric) {
        return B >= 1 && P >= 1 && L >= 1 && d >= 4 && d % 4 == 0 && metric >= 0 && metric <= 2 &&
               (long long)B * P <= 0x7fffffffLL;
    }
};

// every lane's K1 distance of queries [0, B) to dist [B, P*L]
extern "C" int ivf_probe_f32_dist(const float* q, const float* qn, const int* cells, int B, int P,
                                  const float* pvecs, const float* pnorms, const int* members,
                                  const uint8_t* alive, const uint8_t* allowed, int L, int d,
                                  int metric, float* dist, void* stream) {
    if (!ProbeWideCheck::ok(B, P, L, d, metric) || (size_t)pvecs % 16 || (size_t)q % 16)
        return (int)cudaErrorInvalidValue;
    probe_dist_f32_kernel<<<B * P, PW_THREADS, 0, (cudaStream_t)stream>>>(
        ProbeCells{cells, P, L, members, alive, allowed}, q, qn, pvecs, pnorms, d, metric, dist);
    return (int)cudaGetLastError();
}

// every lane's K4 distance (query-major) of queries [0, B) to dist [B, P*L]
extern "C" int ivf_probe_sq8_dist(const int8_t* qc, const float* qs, const float* qsum,
                                  const float* qn, const int* cells, int B, int P,
                                  const int8_t* codes, const float* mins, const float* scales,
                                  const float* pnorms, const int* members, const uint8_t* alive,
                                  const uint8_t* allowed, int L, int d, int metric, float* dist,
                                  void* stream) {
    if (!ProbeWideCheck::ok(B, P, L, d, metric) || (size_t)codes % 4 || (size_t)qc % 4)
        return (int)cudaErrorInvalidValue;
    probe_dist_sq8_kernel<<<B * P, PW_THREADS, 0, (cudaStream_t)stream>>>(
        ProbeCells{cells, P, L, members, alive, allowed}, qc, qs, qsum, qn, codes, mins, scales,
        pnorms, d, metric, dist);
    return (int)cudaGetLastError();
}

// the probe's outputs from K2's selection of m winners a row (any m)
extern "C" int ivf_probe_tail_wide(const int* cells, int B, int P, const int* members, int L,
                                   const float* sel_d, const int* sel_pos, int k, int m,
                                   int replicated, int mode, int* wid, int* flag, float* out_d,
                                   int* out_i, int* out_pos, void* stream) {
    if (B < 1 || P < 1 || L < 1 || k < 1 || m < k || (mode != PW_TOPK && mode != PW_CAND) ||
        (mode == PW_CAND && (m != k || out_pos == nullptr)))
        return (int)cudaErrorInvalidValue;
    probe_tail_wide_kernel<<<B, PW_THREADS, 0, (cudaStream_t)stream>>>(
        ProbeCells{cells, P, L, members, nullptr, nullptr}, sel_d, sel_pos, k, m, replicated,
        mode, wid, flag, out_d, out_i, out_pos);
    return (int)cudaGetLastError();
}

// K5's exact distances ex [B, r] (any r); K2 selects from them
extern "C" int ivf_rerank_dist(const float* q, const float* qn, const float* cand_d,
                               const int* cand_i, const int* cand_pos, int B, int r,
                               const void* rows, int sq16, const float* pnorms, const float* mins,
                               const float* scales, int d, int replicated, float* ex,
                               void* stream) {
    if (B < 1 || r < 1 || d < 4 || d % 4 != 0 || (size_t)q % 16 || (size_t)rows % (sq16 ? 8 : 16) ||
        (sq16 && (mins == nullptr || scales == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (sq16)
        rerank_dist_wide_kernel<true><<<B, PW_THREADS, 0, (cudaStream_t)stream>>>(
            q, qn, cand_d, cand_i, cand_pos, r, rows, pnorms, mins, scales, d, replicated, ex);
    else
        rerank_dist_wide_kernel<false><<<B, PW_THREADS, 0, (cudaStream_t)stream>>>(
            q, qn, cand_d, cand_i, cand_pos, r, rows, pnorms, mins, scales, d, replicated, ex);
    return (int)cudaGetLastError();
}
