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
// The scan is sequential in the candidate axis; a take's pair column is
// known only once the take is decided.
//
// Design: one 128-thread block per target, no barrier per take.
//  1. Dedup through a claim table in shared memory (graph_util.cuh: each
//     candidate claims its id with atomicMin of its position; the lowest
//     keeps it). The rows of the kept candidates arrive by 16-byte cp.async
//     copies into rows padded to d + 4 floats, so that float4 reads of 8
//     consecutive rows hit distinct banks.
//  2. One thread per candidate: its distance to the target (eight FMA
//     chains summed as a tree) and its sum of squares (one chain, as the
//     pair products below), read from shared memory.
//  3. The sort: keys (f2key(distance) << 32 | position) in runs of 32
//     sorted by warps (a bitonic network of shuffles), each key ranked by
//     binary searches of the other runs; the rows, distances and ids then
//     move to their sorted places (through registers, a column chunk at a
//     time), so that the pair products below read consecutive rows.
//  4. The scan, by tiles of 32 sorted candidates, no barrier per take: one
//     warp scans a tile (lane l holds candidate t0 + l and its running min;
//     lane k decides, a shuffle broadcasts it), and a take computes its
//     pair column against the later lanes at once, each lane a whole fp32
//     FMA chain over its own row and the take's (no TF32: the parity
//     contract keeps distance products in true fp32). Then the block folds
//     the tile's takes into the mins of the candidates after the tile (a
//     thread a later candidate, its products with up to 4 takes a pass).
//     Two barriers a tile; tiles after the deg-th take never run (one or two
//     at the build's shapes). Only the pair columns the scan needs are
//     computed: the whole 32 x 32 tile of products, computed up front in
//     one pass, held the kernel to its shared-memory bandwidth on the H100
//     (PERF.md). n_pairs counts those columns' pairs, as the
//     reference's _diversity_scan does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_util.cuh"

#define SELECT_THREADS 128
#define SELECT_WARPS (SELECT_THREADS / 32)
#define TILE 32
#define MOVE_REG 8        // float4s a thread holds while the rows move to sorted order
#define F_INF __int_as_float(0x7f800000)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

__device__ __forceinline__ float pair_epilogue(float dot, float na, float nb, int metric) {
    if (metric == 0) return fmaxf(__fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.0f, dot)), 0.0f);
    if (metric == 1) return __fsub_rn(1.0f, dot);
    return -dot;
}

__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    return fmaf(x.w, y.w, acc);
}

// a += x * y, component by component
__device__ __forceinline__ void fma4(float4& a, float4 x, float4 y) {
    a.x = fmaf(x.x, y.x, a.x);
    a.y = fmaf(x.y, y.y, a.y);
    a.z = fmaf(x.z, y.z, a.z);
    a.w = fmaf(x.w, y.w, a.w);
}

__host__ __device__ inline int select_runs(int W) { return (W + 31) / 32; }

// Bytes of shared memory for W candidates of d floats (the carve below).
__host__ __device__ inline size_t select_smem(int W, int d) {
    return (size_t)4 * ((size_t)W * (d + 4) + d + 6 * W + 8) +
           (size_t)8 * (32 * select_runs(W) + (1 << table_bits(W)));
}

__global__ void __launch_bounds__(SELECT_THREADS)
select_kernel(const float* __restrict__ vectors, const float* __restrict__ norms,
              const int* __restrict__ targets, const int* __restrict__ cand,
              const float* __restrict__ cand_d, int W, int d, int deg, int sel_cap, float alpha,
              int metric, int* __restrict__ out_i, float* __restrict__ out_d,
              int* __restrict__ out_pairs) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int rs = d + 4;                                   // padded row stride (floats)
    float* rows = reinterpret_cast<float*>(smem);           // [W, rs] candidate rows
    unsigned* hid = reinterpret_cast<unsigned*>(rows + (size_t)W * rs);  // claim table: ids,
    unsigned* htag = hid + (1 << table_bits(W));                         // tags
    u64* keys = reinterpret_cast<u64*>(htag + (1 << table_bits(W)));  // [32 * runs] sort keys
    float* tq = reinterpret_cast<float*>(keys + 32 * select_runs(W));  // [d] the target's row
    float* dist = tq + d;                                   // [W] distance to the target
    float* nrm = dist + W;                                  // [W] sum v^2 of each row
    float* mins = nrm + W;                                  // [W] min pair distance to a take
    int* ids = reinterpret_cast<int*>(mins + W);            // [W] candidate ids, -1 when dropped
    int* rank = ids + W;                                    // [W] sorted position of a candidate
    int* taken = rank + W;                                  // [W] the sorted entry was taken
    int* misc = taken + W;                                  // [8]: 0 takes so far, 1 a tile's takes

    const size_t u = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const bool presorted = cand_d != nullptr;
    const int t = presorted ? -1 : targets[u];
    const int q4 = d >> 2, rs4 = rs >> 2;
    const int hbits = table_bits(W);

    // 1. dedup: duplicates (the first copy wins), the target itself and -1
    for (int w = tid; w < W; w += SELECT_THREADS) {
        ids[w] = cand[u * W + w];
        mins[w] = F_INF;
        taken[w] = 0;
    }
    if (!presorted) {
        table_clear(hid, htag, hbits);
        for (int i = tid; i < q4; i += SELECT_THREADS)
            cp_async16(tq + 4 * i, vectors + (size_t)t * d + 4 * i);
        __syncthreads();
        int pos[(256 + SELECT_THREADS - 1) / SELECT_THREADS];
#pragma unroll
        for (int k = 0; k < (256 + SELECT_THREADS - 1) / SELECT_THREADS; ++k) {
            const int w = tid + k * SELECT_THREADS;
            const int id = w < W ? ids[w] : -1;
            pos[k] = id >= 0 && id != t ? table_claim(hid, htag, hbits, id, w) : -1;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < (256 + SELECT_THREADS - 1) / SELECT_THREADS; ++k) {
            const int w = tid + k * SELECT_THREADS;
            if (w < W && (pos[k] < 0 || htag[pos[k]] != (unsigned)(w + 1))) ids[w] = -1;
        }
    }
    __syncthreads();
    for (int i = tid; i < W * q4; i += SELECT_THREADS) {
        const int w = i / q4, c = i - w * q4;
        if (ids[w] >= 0)
            cp_async16(rows + (size_t)w * rs + 4 * c, vectors + (size_t)ids[w] * d + 4 * c);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // 2. distance to the target and sum of squares, a thread a candidate
    const float tn = presorted ? 0.0f : norms[t];
    for (int w = tid; w < W; w += SELECT_THREADS) {
        const int id = ids[w];
        if (id < 0) {
            dist[w] = F_INF;
            nrm[w] = 0.0f;
            continue;
        }
        const float4* r4 = reinterpret_cast<const float4*>(rows + (size_t)w * rs);
        const float4* t4 = reinterpret_cast<const float4*>(tq);
        // eight short FMA chains (columns mod 8), summed as a tree: the L2
        // distance cancels its norms, so the dot's rounding is what shows
        float4 a0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), a1 = a0;
        float nv = 0.0f;
        int c = 0;
        for (; c + 1 < q4; c += 2) {
            const float4 x0 = r4[c], x1 = r4[c + 1];
            if (!presorted) {
                fma4(a0, x0, t4[c]);
                fma4(a1, x1, t4[c + 1]);
            }
            nv = dot4(x1, x1, dot4(x0, x0, nv));
        }
        if (c < q4) {
            const float4 x0 = r4[c];
            if (!presorted) fma4(a0, x0, t4[c]);
            nv = dot4(x0, x0, nv);
        }
        const float dot = ((a0.x + a0.y) + (a0.z + a0.w)) + ((a1.x + a1.y) + (a1.z + a1.w));
        float v;
        if (presorted) v = cand_d[u * W + w];
        else if (metric == 0)
            v = fmaxf(__fsub_rn(__fadd_rn(tn, norms[id]), __fmul_rn(2.0f, dot)), 0.0f);
        else if (metric == 1) v = __fsub_rn(1.0f, dot);
        else v = -dot;
        dist[w] = v;
        nrm[w] = nv;
    }
    __syncthreads();

    // 3. the sort by (distance, position), then the move to sorted order
    if (!presorted) {
        const int runs = select_runs(W);
        for (int w = tid; w < 32 * runs; w += SELECT_THREADS)
            keys[w] = w < W ? ((u64)f2key(dist[w]) << 32) | (unsigned)w : ~0ull;
        __syncthreads();
        for (int r = warp; r < runs; r += SELECT_WARPS) warp_sort_run(keys + 32 * r, 32, lane);
        __syncthreads();
        for (int j = tid; j < W; j += SELECT_THREADS) {
            const u64 key = keys[j];
            int r = j & 31;
            for (int o = 0; o < runs; ++o)
                if (o != (j >> 5)) r += count_below(keys + 32 * o, 32, key);
            rank[(int)(key & 0xffffffffu)] = r;
        }
        __syncthreads();
        // rows move a chunk of columns at a time (at most MOVE_REG float4s a
        // thread); only the kept candidates inside the window are needed
        const int cw = max(1, (MOVE_REG * SELECT_THREADS) / W);
        for (int c0 = 0; c0 < q4; c0 += cw) {
            const int cn = min(cw, q4 - c0);
            float4 buf[MOVE_REG];
            int dst[MOVE_REG];
#pragma unroll
            for (int k = 0; k < MOVE_REG; ++k) {
                const int e = tid + k * SELECT_THREADS;
                dst[k] = -1;
                if (e < W * cn) {
                    const int w = e / cn, c = c0 + e - (e / cn) * cn;
                    if (ids[w] >= 0 && rank[w] < sel_cap) {
                        dst[k] = rank[w] * rs4 + c;
                        buf[k] = reinterpret_cast<const float4*>(rows)[w * rs4 + c];
                    }
                }
            }
            // the small arrays move with the last chunk: until then ids and
            // rank stay in candidate order
            const bool last = c0 + cw >= q4;
            float sv_d[2], sv_n[2];
            int sv_i[2], sv_r[2];
            if (last)
                for (int k = 0; k < 2; ++k) {
                    const int w = tid + k * SELECT_THREADS;
                    sv_r[k] = w < W ? rank[w] : -1;
                    if (w < W) { sv_d[k] = dist[w]; sv_n[k] = nrm[w]; sv_i[k] = ids[w]; }
                }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < MOVE_REG; ++k)
                if (dst[k] >= 0) reinterpret_cast<float4*>(rows)[dst[k]] = buf[k];
            if (last)
                for (int k = 0; k < 2; ++k)
                    if (sv_r[k] >= 0) {
                        dist[sv_r[k]] = sv_d[k];
                        nrm[sv_r[k]] = sv_n[k];
                        ids[sv_r[k]] = sv_i[k];
                    }
            __syncthreads();
        }
    }

    // 4. the scan by tiles. Warp 0 keeps the valid count before the tile
    // and the pairs counted; misc[0] the takes so far (read by every thread)
    int n_valid = 0, before = 0, pairs = 0;
    if (warp == 0) {
        for (int base = 0; base < sel_cap; base += 32)
            n_valid += __popc(
                __ballot_sync(0xffffffffu, base + lane < sel_cap && ids[base + lane] >= 0));
        if (lane == 0) misc[0] = 0;
    }
    __syncthreads();
    for (int t0 = 0; t0 < sel_cap && misc[0] < deg; t0 += TILE) {
        const int nt = min(TILE, sel_cap - t0);
        // one warp scans the tile: lane l holds candidate t0 + l and its
        // running min; lane k decides, a shuffle broadcasts it, and a take
        // computes its pair column against the later lanes right there
        if (warp == 0) {
            const int j = t0 + lane;
            const bool v = lane < nt && ids[j] >= 0;
            const float dj = v ? dist[j] : F_INF;
            float m = lane < nt ? mins[j] : F_INF;
            const unsigned vb = __ballot_sync(0xffffffffu, v);
            // valid candidates after j inside the window
            const int later = n_valid - before - __popc(vb & (0xffffffffu >> (31 - lane)));
            const float4* rl = reinterpret_cast<const float4*>(rows + (size_t)(v ? j : t0) * rs);
            int cnt = misc[0];
            unsigned takes = 0;
            for (int k = 0; k < nt && cnt < deg; ++k) {
                const bool tk = __shfl_sync(0xffffffffu, v && dj < __fmul_rn(alpha, m), k);
                if (!tk) continue;
                takes |= 1u << k;
                ++cnt;
                // the pair column of a take but the deg-th, as the reference counts
                if (cnt < deg) {
                    pairs += __shfl_sync(0xffffffffu, later, k);
                    if (lane > k && v) {
                        const float4* rk =
                            reinterpret_cast<const float4*>(rows + (size_t)(t0 + k) * rs);
                        float dot = 0.0f;
                        for (int c = 0; c < q4; ++c) dot = dot4(rk[c], rl[c], dot);
                        m = fminf(m, pair_epilogue(dot, nrm[j], nrm[t0 + k], metric));
                    }
                }
            }
            before += __popc(vb);
            if (lane < nt) taken[j] = (takes >> lane) & 1u;
            __syncwarp();
            if (lane == 0) { misc[0] = cnt; misc[1] = (int)takes; }
        }
        __syncthreads();
        // fold the tile's takes into the mins of the candidates after it
        const unsigned takes = (unsigned)misc[1];
        if (takes && misc[0] < deg) {
            for (int i = t0 + TILE + tid; i < sel_cap; i += SELECT_THREADS) {
                if (ids[i] < 0) continue;
                const float4* rb4 = reinterpret_cast<const float4*>(rows + (size_t)i * rs);
                float m = mins[i];
                for (unsigned tb = takes; tb;) {
                    // up to 4 takes at a time against this row
                    int kk[4];
                    int nk = 0;
                    for (; tb && nk < 4; tb &= tb - 1) kk[nk++] = __ffs(tb) - 1;
                    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                    for (int c = 0; c < q4; ++c) {
                        const float4 b = rb4[c];
#pragma unroll
                        for (int x = 0; x < 4; ++x)
                            if (x < nk)
                                acc[x] = dot4(reinterpret_cast<const float4*>(
                                                  rows + (size_t)(t0 + kk[x]) * rs)[c],
                                              b, acc[x]);
                    }
#pragma unroll
                    for (int x = 0; x < 4; ++x)
                        if (x < nk)
                            m = fminf(m, pair_epilogue(acc[x], nrm[i], nrm[t0 + kk[x]], metric));
                }
                mins[i] = m;
            }
        }
        __syncthreads();
    }

    // 5. the taken, then the rest as backfill, both in sorted order
    if (warp == 0) {
        int o = 0;
        for (int pass = 0; pass < 2; ++pass)
            for (int base = 0; base < sel_cap && o < deg; base += 32) {
                const int j = base + lane;
                const bool f = j < sel_cap && ids[j] >= 0 && (taken[j] != 0) == (pass == 0);
                const unsigned bal = __ballot_sync(0xffffffffu, f);
                const int r = o + __popc(bal & ((1u << lane) - 1u));
                if (f && r < deg) {
                    out_i[u * deg + r] = dist[j] < F_INF ? ids[j] : -1;
                    out_d[u * deg + r] = dist[j];
                }
                o += __popc(bal);
            }
        for (int r = min(o, deg) + lane; r < deg; r += 32) {
            out_i[u * deg + r] = -1;
            out_d[u * deg + r] = F_INF;
        }
        if (lane == 0) out_pairs[u] = pairs;
    }
}

static int launch_select(const float* vectors, const float* norms, const int* targets,
                         const int* cand, const float* cand_d, int U, int W, int d, int deg,
                         int sel_cap, float alpha, int metric, int* out_i, float* out_d,
                         int* out_pairs, void* stream) {
    if (U < 0 || W < 1 || W > 256 || d % 4 != 0 || deg < 1 || sel_cap < 1 || sel_cap > W ||
        metric < 0 || metric > 2)
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
