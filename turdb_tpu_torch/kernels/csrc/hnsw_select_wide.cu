// K7's wide form: hnsw_select and its presorted mode past the widths the
// fast kernel (hnsw_select.cu) stages in shared memory (W <= 256
// candidates, W*d*4 <= 160 KB of rows).
//
// Replaces, as K7 does: turdb_tpu/models/hnsw.py _select_from_candidates
// and _select_neighbors_heuristic (presorted: the heuristic alone). The
// contract is K7's (hnsw_select.cu:1-21): drop duplicates (the first copy
// wins), the target and -1; sort by (distance, position); keep the first
// sel_cap; the alpha scan; the taken, then the rest as backfill; n_pairs.
// Reached by the bulk build at d = 384 upper levels (W = 8*16 = 128, 196 KB
// of rows) and d = 768 level 0 (W = 64), and by the wave inserts and the
// refinement past 256 candidates.
//
// What bounds it on an H100: the W candidate rows read from device memory
// (W*4d bytes, scattered; L2 catches the re-reads of the scan) and the fp32
// dots, as the fast form. A correctness path, not tuned.
//
// Design: one 256-thread block per target (a grid of at most `grid` blocks
// walking the targets), each block's scalars in a global scratch slice:
// about 36 bytes a candidate (ids, distances, sorted ids and distances,
// norms, running mins, taken flags) and 8 a sort key, so W runs into the
// thousands. Rows stay in device memory:
//  1. dedup by a scan of the earlier candidates (thread a candidate);
//  2. each candidate's distance to the target by a warp (lane l over float4
//     l, l + 32, ...; an xor butterfly), the epilogue over the stored norms;
//  3. a bitonic sort of (f2key(distance) << 32 | position) over the scratch;
//  4. the scan in sorted order: a take's pair distances (L2 over the rows'
//     own sums of squares, clamped at 0) fold into the running mins of the
//     later candidates, a warp a candidate, one barrier a take. A candidate
//     already at or above alpha times its min can never be taken (the min
//     only falls), so its pairs are skipped: the takes are the reference's.
//     n_pairs counts what the reference's scan needs, from the valid counts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_util.cuh"

#define SW_THREADS 256
#define SW_WARPS (SW_THREADS / 32)

// scratch bytes of one block: the sort keys, then seven arrays of W words
__host__ __device__ inline size_t select_wide_bytes(int W) {
    return wide_align16((size_t)8 * pow2_ge(W) + (size_t)4 * 7 * W);
}

__device__ __forceinline__ float sel_epilogue(float dot, float na, float nb, int metric) {
    if (metric == 0) return fmaxf(__fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.0f, dot)), 0.0f);
    if (metric == 1) return __fsub_rn(1.0f, dot);
    return -dot;
}

__global__ void __launch_bounds__(SW_THREADS)
select_wide_kernel(const float* __restrict__ vectors, const float* __restrict__ norms,
                   const int* __restrict__ targets, const int* __restrict__ cand,
                   const float* __restrict__ cand_d, int U, int W, int d, int deg, int sel_cap,
                   float alpha, int metric, unsigned char* scratch, size_t stride,
                   int* __restrict__ out_i, float* __restrict__ out_d, int* __restrict__ out_pairs) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    u64* keys = reinterpret_cast<u64*>(scratch + blockIdx.x * stride);
    int* ids = reinterpret_cast<int*>(keys + pow2_ge(W));  // [W] ids, -1 when dropped
    float* dist = reinterpret_cast<float*>(ids + W);       // [W] distance to the target
    int* sids = reinterpret_cast<int*>(dist + W);          // [W] ids in sorted order
    float* sdist = reinterpret_cast<float*>(sids + W);     // [W] distances in sorted order
    float* nrm = sdist + W;                                // [W] sum v^2 of a sorted row
    float* mins = nrm + W;                                 // [W] min pair distance to a take
    int* taken = reinterpret_cast<int*>(mins + W);         // [W] the sorted entry was taken
    const bool presorted = cand_d != nullptr;
    const int C = sel_cap;
    for (size_t u = blockIdx.x; u < (size_t)U; u += gridDim.x) {
        const int t = presorted ? -1 : targets[u];
        const int* cu = cand + u * W;
        // 1. dedup: duplicates (the first copy wins), the target itself, -1
        for (int w = tid; w < W; w += SW_THREADS) {
            int id = cu[w];
            if (!presorted && id >= 0) {
                if (id == t) id = -1;
                for (int j = 0; j < w && id >= 0; ++j)
                    if (cu[j] == id) id = -1;
            }
            ids[w] = id;
        }
        __syncthreads();
        // 2. the distance to the target, a warp a candidate
        const float tn = presorted ? 0.0f : norms[t];
        for (int w = warp; w < W; w += SW_WARPS) {
            const int id = ids[w];
            float v = WIDE_INF;
            if (id >= 0) {
                if (presorted) v = cand_d[u * W + w];
                else
                    v = sel_epilogue(warp_dot(vectors + (size_t)t * d, vectors + (size_t)id * d, d,
                                              lane),
                                     tn, norms[id], metric);
            }
            if (lane == 0) dist[w] = v;
        }
        __syncthreads();
        // 3. the sort by (distance, position)
        const int* sid = ids;
        const float* sd = dist;
        if (!presorted) {
            for (int w = tid; w < W; w += SW_THREADS)
                keys[w] = ((u64)f2key(dist[w]) << 32) | (unsigned)w;
            block_sort_keys(keys, W);
            for (int r = tid; r < W; r += SW_THREADS) {
                const int w = (int)(keys[r] & 0xffffffffu);
                sids[r] = ids[w];
                sdist[r] = dist[w];
            }
            sid = sids;
            sd = sdist;
        }
        __syncthreads();
        // the window's rows: sums of squares, running mins, flags
        for (int r = warp; r < C; r += SW_WARPS) {
            const int id = sid[r];
            const float nv = id >= 0 ? warp_dot(vectors + (size_t)id * d,
                                                vectors + (size_t)id * d, d, lane) : 0.0f;
            if (lane == 0) {
                nrm[r] = nv;
                mins[r] = WIDE_INF;
                taken[r] = 0;
            }
        }
        int n_valid = 0;
        for (int r0 = 0; r0 < C; r0 += SW_THREADS)
            n_valid += __syncthreads_count(r0 + tid < C && sid[r0 + tid] >= 0);
        // 4. the scan: every thread walks the same entries and decisions
        int count = 0, pairs = 0, seen = 0;
        for (int j = 0; j < C && count < deg; ++j) {
            const int id = sid[j];
            if (id < 0) continue;
            ++seen;
            if (!(sd[j] < __fmul_rn(alpha, mins[j]))) continue;
            if (tid == 0) taken[j] = 1;
            if (++count == deg) break;
            pairs += n_valid - seen;   // the take's pair column, as the reference counts it
            for (int j2 = j + 1 + warp; j2 < C; j2 += SW_WARPS) {
                const int id2 = sid[j2];
                if (id2 < 0) continue;
                const float m = mins[j2];
                if (alpha > 0.0f && !(sd[j2] < __fmul_rn(alpha, m))) continue;
                const float dot = warp_dot(vectors + (size_t)id * d, vectors + (size_t)id2 * d, d,
                                           lane);
                if (lane == 0) mins[j2] = fminf(m, sel_epilogue(dot, nrm[j2], nrm[j], metric));
            }
            __syncthreads();
        }
        __syncthreads();
        // 5. the taken, then the rest as backfill, both in sorted order
        if (warp == 0) {
            int o = 0;
            for (int pass = 0; pass < 2; ++pass)
                for (int base = 0; base < C && o < deg; base += 32) {
                    const int j = base + lane;
                    const bool f = j < C && sid[j] >= 0 && (taken[j] != 0) == (pass == 0);
                    const unsigned bal = __ballot_sync(WIDE_FULL, f);
                    const int r = o + __popc(bal & ((1u << lane) - 1u));
                    if (f && r < deg) {
                        out_i[u * deg + r] = sd[j] < WIDE_INF ? sid[j] : -1;
                        out_d[u * deg + r] = sd[j];
                    }
                    o += __popc(bal);
                }
            for (int r = min(o, deg) + lane; r < deg; r += 32) {
                out_i[u * deg + r] = -1;
                out_d[u * deg + r] = WIDE_INF;
            }
            if (lane == 0) out_pairs[u] = pairs;
        }
        __syncthreads();   // the scratch is the next target's
    }
}

// bytes of one block's scratch at W candidates (the wrapper allocates grid x this)
extern "C" long long hnsw_select_wide_bytes(int W) { return (long long)select_wide_bytes(W); }

static int launch_select_wide(const float* vectors, const float* norms, const int* targets,
                              const int* cand, const float* cand_d, int U, int W, int d, int deg,
                              int sel_cap, float alpha, int metric, unsigned char* scratch,
                              int grid, int* out_i, float* out_d, int* out_pairs, void* stream) {
    if (U < 1 || W < 1 || d < 4 || d % 4 != 0 || deg < 1 || sel_cap < 1 || sel_cap > W ||
        metric < 0 || metric > 2 || grid < 1 || scratch == nullptr)
        return (int)cudaErrorInvalidValue;
    select_wide_kernel<<<grid, SW_THREADS, 0, (cudaStream_t)stream>>>(
        vectors, norms, targets, cand, cand_d, U, W, d, deg, sel_cap, alpha, metric, scratch,
        select_wide_bytes(W), out_i, out_d, out_pairs);
    return (int)cudaGetLastError();
}

extern "C" int hnsw_select_wide(const float* vectors, const float* norms, const int* targets,
                                const int* cand, int U, int W, int d, int deg, int sel_cap,
                                float alpha, int metric, unsigned char* scratch, int grid,
                                int* out_i, float* out_d, int* out_pairs, void* stream) {
    return launch_select_wide(vectors, norms, targets, cand, nullptr, U, W, d, deg, sel_cap,
                              alpha, metric, scratch, grid, out_i, out_d, out_pairs, stream);
}

extern "C" int hnsw_select_sorted_wide(const float* vectors, const int* cand,
                                       const float* cand_d, int U, int W, int d, int deg,
                                       float alpha, int metric, unsigned char* scratch, int grid,
                                       int* out_i, float* out_d, int* out_pairs, void* stream) {
    if (cand_d == nullptr) return (int)cudaErrorInvalidValue;
    return launch_select_wide(vectors, nullptr, nullptr, cand, cand_d, U, W, d, deg, W, alpha,
                              metric, scratch, grid, out_i, out_d, out_pairs, stream);
}
