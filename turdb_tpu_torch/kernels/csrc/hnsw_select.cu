// K7 hnsw_select: the HNSW alpha-diversity neighbour selection.
//
// Replaces: turdb_tpu/models/hnsw.py _select_from_candidates and the
// _select_neighbors_heuristic it calls (the bulk build's forward selection
// at every layer, the refinement's, and the wave inserts' re-selection of
// the rows that take reverse edges, _prune_rows); in its presorted mode
// (hnsw_select_sorted) _select_neighbors_heuristic alone, over a beam's
// buffer as _wave_level_core hands it over. For each target: drop duplicate
// candidates (the first copy wins), the target itself and -1; sort the
// rest by their exact distance to the target (gathered_distances: L2
// clamped at 0 over the stored norms, COS 1 - dot, IP -dot; ties to the
// earlier candidate, +inf last); keep the first sel_cap; then scan them in
// order and take a candidate while fewer than deg are taken, if its
// distance is below alpha times its distance to every candidate taken
// before (L2 (sum v^2 + sum v^2) - 2 dot over the rows themselves, clamped
// at 0; COS; IP). The output is the taken candidates, then the others as
// backfill, both in sorted order, -1 / +inf padded to deg (an entry at
// +inf is -1, as the reference's). The presorted mode takes the candidates
// with their distances as given (a beam buffer: ascending, -1 / +inf at the
// end), with no dedup, no sort and no window (sel_cap = W): the same scan,
// the same output order.
//
// What bounds it on an H100: the gathers of W candidate rows per target
// (W*4d bytes, scattered) and the fp32 dots (W for the distances, one per
// later candidate for each take), about equally at the build's shapes.
//
// Design: one 128-thread block per target. The W candidate rows are
// gathered once into shared memory (float4 loads), so every later dot
// reads them from there; a warp computes one dot (lanes over the
// dimensions, a shuffle sum). The sort ranks each candidate by (distance,
// position). The scan is sequential in the candidate axis, as in the
// reference, but the W x W pair matrix is never formed: the scan reads
// column j only after it takes candidate j, so a take computes that one
// column against the candidates after it, and the scan stops at deg takes.
#include <cuda_runtime.h>
#include <stdint.h>

#define SELECT_THREADS 128
#define SELECT_WARPS (SELECT_THREADS / 32)
#define F_INF __int_as_float(0x7f800000)

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// warp-collective dot of two rows in shared memory
__device__ __forceinline__ float row_dot(const float* a, const float* b, int d, int lane) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float acc = 0.0f;
    for (int j = lane; j < (d >> 2); j += 32) {
        const float4 x = a4[j], y = b4[j];
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
    }
    return warp_sum(acc);
}

__host__ __device__ inline size_t select_smem(int W, int d) {
    return (size_t)4 * ((size_t)W * d + d + 7 * W);
}

__global__ void __launch_bounds__(SELECT_THREADS)
select_kernel(const float* __restrict__ vectors, const float* __restrict__ norms,
              const int* __restrict__ targets, const int* __restrict__ cand,
              const float* __restrict__ cand_d, int W, int d, int deg, int sel_cap, float alpha,
              int metric, int* __restrict__ out_i, float* __restrict__ out_d,
              int* __restrict__ out_pairs) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* rows = reinterpret_cast<float*>(smem);  // [W, d] candidate rows
    float* tq = rows + (size_t)W * d;               // [d] the target's row
    float* dist = tq + d;                           // [W] distance to the target
    float* nrm = dist + W;                          // [W] sum v^2 of each row
    float* mins = nrm + W;                          // [W] min pair distance to a take (sorted)
    int* ids = reinterpret_cast<int*>(mins + W);    // [W] candidate ids, -1 when dropped
    int* order = ids + W;                           // [W] sorted position -> candidate
    int* taken = order + W;                         // [W] the sorted entry was taken
    int* vsuf = taken + W;                          // [W] valid sorted entries from j on

    const size_t u = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool presorted = cand_d != nullptr;
    const int t = presorted ? -1 : targets[u];
    for (int w = tid; w < W; w += blockDim.x) ids[w] = cand[u * W + w];
    if (!presorted) {
        for (int i = tid; i < d; i += blockDim.x) tq[i] = vectors[(size_t)t * d + i];
        __syncthreads();
        // duplicates (the first copy wins), the target itself and -1 drop out
        for (int w = tid; w < W; w += blockDim.x) {
            const int id = ids[w];
            bool drop = id < 0 || id == t;
            for (int v = 0; v < w && !drop; ++v) drop = ids[v] == id;
            taken[w] = drop;
        }
        __syncthreads();
        for (int w = tid; w < W; w += blockDim.x)
            if (taken[w]) ids[w] = -1;
    }
    __syncthreads();
    const int q4 = d >> 2;
    for (int i = tid; i < W * q4; i += blockDim.x) {
        const int w = i / q4;
        if (ids[w] >= 0)
            reinterpret_cast<float4*>(rows)[i] =
                reinterpret_cast<const float4*>(vectors + (size_t)ids[w] * d)[i - w * q4];
    }
    __syncthreads();
    const float tn = presorted ? 0.0f : norms[t];
    for (int w = warp; w < W; w += SELECT_WARPS) {
        const int id = ids[w];
        if (id < 0) {
            if (lane == 0) { dist[w] = F_INF; nrm[w] = 0.0f; }
            continue;
        }
        const float* r = rows + (size_t)w * d;
        const float dot = presorted ? 0.0f : row_dot(tq, r, d, lane);
        const float nv = row_dot(r, r, d, lane);
        if (lane == 0) {
            float v;
            if (presorted) v = cand_d[u * W + w];
            else if (metric == 0)
                v = fmaxf(__fsub_rn(__fadd_rn(tn, norms[id]), __fmul_rn(2.0f, dot)), 0.0f);
            else if (metric == 1) v = __fsub_rn(1.0f, dot);
            else v = -dot;
            dist[w] = v;
            nrm[w] = nv;
        }
    }
    __syncthreads();
    // stable sort by distance: rank of each candidate by (distance, position)
    for (int w = tid; w < W; w += blockDim.x) {
        int r = w;
        if (!presorted) {
            const float v = dist[w];
            r = 0;
            for (int x = 0; x < W; ++x) r += dist[x] < v || (dist[x] == v && x < w);
        }
        order[r] = w;
        mins[w] = F_INF;
        taken[w] = 0;
    }
    __syncthreads();
    if (tid == 0) {
        int c = 0;
        for (int j = sel_cap - 1; j >= 0; --j) {
            c += ids[order[j]] >= 0;
            vsuf[j] = c;
        }
    }
    __syncthreads();
    // the scan: every thread makes the same decision from shared memory
    int count = 0, pairs = 0;
    for (int j = 0; j < sel_cap && count < deg; ++j) {
        const int cj = order[j];
        const bool take = ids[cj] >= 0 && dist[cj] < __fmul_rn(alpha, mins[j]);
        if (!take) continue;
        ++count;
        if (tid == 0) taken[j] = 1;
        if (count < deg) {
            // column j of the pair matrix, against the candidates after it
            pairs += j + 1 < sel_cap ? vsuf[j + 1] : 0;
            const float* rj = rows + (size_t)cj * d;
            for (int i = j + 1 + warp; i < sel_cap; i += SELECT_WARPS) {
                const int ci = order[i];
                if (ids[ci] < 0) continue;
                const float dot = row_dot(rows + (size_t)ci * d, rj, d, lane);
                if (lane == 0) {
                    float p;
                    if (metric == 0)
                        p = fmaxf(__fsub_rn(__fadd_rn(nrm[ci], nrm[cj]), __fmul_rn(2.0f, dot)),
                                  0.0f);
                    else if (metric == 1) p = __fsub_rn(1.0f, dot);
                    else p = -dot;
                    mins[i] = fminf(mins[i], p);
                }
            }
        }
        __syncthreads();
    }
    __syncthreads();
    if (tid == 0) {
        int o = 0;
        for (int pass = 0; pass < 2; ++pass)
            for (int j = 0; j < sel_cap && o < deg; ++j) {
                const int cj = order[j];
                if (ids[cj] < 0 || taken[j] != (pass == 0)) continue;
                out_i[u * deg + o] = dist[cj] < F_INF ? ids[cj] : -1;
                out_d[u * deg + o] = dist[cj];
                ++o;
            }
        for (; o < deg; ++o) {
            out_i[u * deg + o] = -1;
            out_d[u * deg + o] = F_INF;
        }
        out_pairs[u] = pairs;
    }
}

static int launch_select(const float* vectors, const float* norms, const int* targets,
                         const int* cand, const float* cand_d, int U, int W, int d, int deg,
                         int sel_cap, float alpha, int metric, int* out_i, float* out_d,
                         int* out_pairs, void* stream) {
    if (U < 0 || W < 1 || d % 4 != 0 || deg < 1 || sel_cap < 1 || sel_cap > W || metric < 0 ||
        metric > 2)
        return (int)cudaErrorInvalidValue;
    const size_t smem = select_smem(W, d);
    cudaError_t e = cudaFuncSetAttribute(select_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    select_kernel<<<U, SELECT_THREADS, smem, (cudaStream_t)stream>>>(
        vectors, norms, targets, cand, cand_d, W, d, deg, sel_cap, alpha, metric, out_i, out_d,
        out_pairs);
    return (int)cudaGetLastError();
}

extern "C" int hnsw_select(const float* vectors, const float* norms, const int* targets,
                           const int* cand, int U, int W, int d, int deg, int sel_cap,
                           float alpha, int metric, int* out_i, float* out_d, int* out_pairs,
                           void* stream) {
    return launch_select(vectors, norms, targets, cand, nullptr, U, W, d, deg, sel_cap, alpha,
                         metric, out_i, out_d, out_pairs, stream);
}

// the presorted mode: `cand` [U, W] with its distances `cand_d` [U, W]
extern "C" int hnsw_select_sorted(const float* vectors, const int* cand, const float* cand_d,
                                  int U, int W, int d, int deg, float alpha, int metric,
                                  int* out_i, float* out_d, int* out_pairs, void* stream) {
    if (cand_d == nullptr) return (int)cudaErrorInvalidValue;
    return launch_select(vectors, nullptr, nullptr, cand, cand_d, U, W, d, deg, W, alpha, metric,
                         out_i, out_d, out_pairs, stream);
}
