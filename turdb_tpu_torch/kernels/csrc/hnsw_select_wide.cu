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
// of rows) and d = 768 level 0 (W = 64), by the 768-d waves (presorted, W
// = 100, 300 KB), and by the wave inserts and the refinement past 256
// candidates.
//
// What bounds it on an H100: the fp32 dots (W for the distances, one pair
// column of the later candidates for each take) and the W candidate rows
// read (W*4d bytes, scattered), as the fast form. The scan is sequential
// in the candidate axis: a take's pair column is known only once the take
// is decided.
//
// The cluster form (select_cluster_kernel): a target's window of rows on
// chip. A thread block cluster of `ctas` CTAs a target (1 where the window
// fits one CTA's opted-in shared memory: the bulk build's 196,608 B; 2 for
// the waves' 307,200 B; up to 16, hnsw_select_wide_ctas picks the least
// that fits), each holding an equal share of the candidates' rows in
// position order, staged by one cp.async.bulk a row onto an mbarrier. The
// clusters are persistent: each walks targets u, u + clusters, ..., the
// next target's ids arriving during this one's scan and its rows staged
// while this one's output is written. Bit for bit the global form below
// (the wide form's first design): every dot in warp_dot's order (wide_util.cuh: lane l
// sums float4 l, l + 32, ... in one fmaf chain, then an xor butterfly).
//  1. every CTA dedups all W ids through a claim table in shared memory
//     (graph_util.cuh; O(W)), while the rows land;
//  2. each own row's distance to the target and sum of squares, a warp 8
//     rows at once (their butterflies merged by reduce_rows, row_sums.cuh);
//     the CTAs' values exchanged through distributed shared memory;
//  3. every CTA sorts the W keys (f2key(distance) << 32 | position) in
//     warp-sorted runs of 32 ranked by binary searches;
//  4. the scan in batches of up to 8 alive candidates (valid, undecided,
//     below alpha times their min: a candidate at or above it can never be
//     taken, as the min only falls). A batch's pair columns against every
//     later alive candidate and against each other run at once, a warp a
//     tile of 4 rows x the batch's 8 (32 chains a lane), so a batch costs
//     one pass over the rows where one take at a time cost one a take;
//     then every CTA decides the batch in order (a lane a member) from the
//     members' mins before it and the triangle of their own pairs, exactly
//     as a scan one at a time would, and each CTA folds the takes into its
//     own candidates' mins. A batch's rows held by other CTAs are copied in
//     through distributed shared memory; each CTA publishes its
//     candidates' mins and alive bits (two buffers, one cluster barrier a
//     batch). n_pairs counts what the reference's scan needs, from the
//     valid counts.
//
// The global form (select_wide_kernel), past what 16 CTAs hold: one
// 256-thread block per target (a grid of at most `grid` blocks walking the
// targets), each block's scalars in a global scratch slice: about 36 bytes
// a candidate (ids, distances, sorted ids and distances, norms, running
// mins, taken flags) and 8 a sort key, so W runs into the thousands. Rows
// stay in device memory:
//  1. dedup by a scan of the earlier candidates (thread a candidate);
//  2. each candidate's distance to the target by a warp (lane l over float4
//     l, l + 32, ...; an xor butterfly), the epilogue over the stored norms;
//  3. a bitonic sort of (f2key(distance) << 32 | position) over the scratch;
//  4. the scan in sorted order: a take's pair distances (L2 over the rows'
//     own sums of squares, clamped at 0) fold into the running mins of the
//     later candidates, a warp a candidate, one barrier a take, dominated
//     candidates' pairs skipped.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch_util.cuh"
#include "row_sums.cuh"
#include "wide_util.cuh"

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// The global form: past what a cluster holds
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The cluster form: a target's window of rows on chip
// ---------------------------------------------------------------------------

#define SC_THREADS 256
#define SC_SPEC 8           // candidates a batch of the scan decides
#define SC_TILE 4           // rows a warp pairs with a batch at once (32 chains a lane)
#define SC_DIST 8           // rows a warp takes to the target at once
static_assert(SC_SPEC * SC_TILE == 32, "a tile's sums are one reduce_rows of 32");
#define SC_CLUSTER 8        // CTAs a cluster by choice (portable)
#define SC_CTAS_MAX 16      // and at most (non-portable)

// One CTA's shared memory at W candidates of d floats over `ctas` CTAs:
// offsets in bytes, every piece 16-byte aligned.
struct SelCarve {
    size_t bar, rows, stage, cid, dist, nrm, sidx, order, mins, pub_mins, pub_alive, alive,
        valid, keys, table, pbuf, act, chunk, tri, spec, total;
    int share, rs, words, hbits;
    __host__ __device__ static size_t take(size_t& o, size_t bytes) {
        const size_t at = o;
        o += wide_align16(bytes);
        return at;
    }
    __host__ __device__ SelCarve(int W, int d, int ctas, bool presorted, int nspec) {
        share = (W + ctas - 1) / ctas;
        rs = d;                           // a row's floats (lanes read consecutive float4s)
        words = (W + 31) / 32;
        hbits = table_bits(W);
        // the target's row while the distances run, then a batch's rows
        // copied from the other CTAs (nspec of them at most)
        const size_t target = presorted ? 0 : (size_t)4 * d;
        const size_t copies = ctas > 1 ? (size_t)4 * nspec * rs : 0;
        size_t o = 0;
        bar = take(o, 16);
        rows = take(o, (size_t)4 * share * rs);
        stage = take(o, target > copies ? target : copies);
        cid = take(o, (size_t)8 * W);         // [2][W]: this target's ids, the next's
        dist = take(o, (size_t)4 * W);
        nrm = take(o, (size_t)4 * W);
        sidx = take(o, (size_t)4 * W);        // position -> sorted place
        order = take(o, (size_t)4 * W);       // sorted place -> position
        mins = take(o, (size_t)4 * W);        // a position's min pair distance to a take
        pub_mins = take(o, (size_t)8 * W);    // [2][W]: the mins the other CTAs read
        pub_alive = take(o, (size_t)8 * words);   // [2][words]: alive bits by sorted place
        alive = take(o, (size_t)4 * words);
        valid = take(o, (size_t)4 * words);
        keys = take(o, (size_t)8 * 32 * words);
        table = take(o, presorted ? 0 : (size_t)8 << hbits);
        pbuf = take(o, (size_t)4 * share * SC_SPEC);
        act = take(o, (size_t)4 * 32 * ((share + 31) / 32));   // a batch's own rows to pair,
        chunk = take(o, (size_t)4 * ((share + 31) / 32));     // a chunk of 32 positions each
        tri = take(o, (size_t)4 * SC_SPEC * SC_SPEC);
        spec = take(o, (size_t)4 * 6 * SC_SPEC);   // the batch's places, row offsets,
        // mins, norms, distances, later counts
        total = o;
    }
};

// a CTA's barrier, or the cluster's
__device__ __forceinline__ void sel_sync(int ctas) {
    if (ctas > 1) cg::this_cluster().sync();
    else __syncthreads();
}

// valid candidates in sorted places [0, s]
__device__ __forceinline__ int valid_upto(const unsigned* valid, int s) {
    int n = 0;
    for (int w = 0; w < (s >> 5); ++w) n += __popc(valid[w]);
    return n + __popc(valid[s >> 5] & (0xffffffffu >> (31 - (s & 31))));
}

__global__ void __launch_bounds__(SC_THREADS, 1)
select_cluster_kernel(const float* __restrict__ vectors, const float* __restrict__ norms,
                      const int* __restrict__ targets, const int* __restrict__ cand,
                      const float* __restrict__ cand_d, int U, int W, int d, int deg, int sel_cap,
                      float alpha, int metric, int ctas, int nspec, int* __restrict__ out_i,
                      float* __restrict__ out_d, int* __restrict__ out_pairs) {
    extern __shared__ __align__(16) unsigned char smem[];
    const bool presorted = cand_d != nullptr;
    const SelCarve cv(W, d, ctas, presorted, nspec);
    const int rank = ctas > 1 ? (int)cg::this_cluster().block_rank() : 0;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int share = cv.share, rs = cv.rs, q4 = d >> 2, nw = cv.words;
    const int w0 = rank * share, nown = max(0, min(share, W - w0));
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + cv.bar);
    float* rows = reinterpret_cast<float*>(smem + cv.rows);
    float* stage = reinterpret_cast<float*>(smem + cv.stage);
    int* const cidbuf = reinterpret_cast<int*>(smem + cv.cid);
    float* dist = reinterpret_cast<float*>(smem + cv.dist);
    float* nrm = reinterpret_cast<float*>(smem + cv.nrm);
    int* sidx = reinterpret_cast<int*>(smem + cv.sidx);
    int* order = reinterpret_cast<int*>(smem + cv.order);
    float* mins = reinterpret_cast<float*>(smem + cv.mins);
    float* pub_mins = reinterpret_cast<float*>(smem + cv.pub_mins);
    unsigned* pub_alive = reinterpret_cast<unsigned*>(smem + cv.pub_alive);
    unsigned* alive = reinterpret_cast<unsigned*>(smem + cv.alive);
    unsigned* valid = reinterpret_cast<unsigned*>(smem + cv.valid);
    u64* keys = reinterpret_cast<u64*>(smem + cv.keys);
    unsigned* hid = reinterpret_cast<unsigned*>(smem + cv.table);
    unsigned* htag = hid + (1 << cv.hbits);
    float* pbuf = reinterpret_cast<float*>(smem + cv.pbuf);   // [share][SC_SPEC]
    int* act = reinterpret_cast<int*>(smem + cv.act);
    int* chunkn = reinterpret_cast<int*>(smem + cv.chunk);   // a chunk's rows in act
    float* tri = reinterpret_cast<float*>(smem + cv.tri);     // [SC_SPEC][SC_SPEC]
    int* spec = reinterpret_cast<int*>(smem + cv.spec);       // the batch's sorted places
    int* spec_off = spec + SC_SPEC;                           // their rows (floats from smem)
    float* spec_min = reinterpret_cast<float*>(spec_off + SC_SPEC);
    float* spec_nrm = spec_min + SC_SPEC;
    float* spec_d = spec_nrm + SC_SPEC;                       // their distances
    int* spec_later = reinterpret_cast<int*>(spec_d + SC_SPEC);  // valid candidates after each
    float* base_f = reinterpret_cast<float*>(smem);
    const unsigned row_bytes = 4u * (unsigned)d;
    // the rows of this CTA's share that hold an id (and the target's) onto
    // the mbarrier, one cp.async.bulk a row (a dropped copy's row is staged
    // and never read); all threads call
    auto stage_rows = [&](int t_row, const int* ids) {
        int kept = 0;
        for (int i0 = 0; i0 < nown; i0 += SC_THREADS)
            kept += __syncthreads_count(i0 + tid < nown && ids[w0 + i0 + tid] >= 0);
        if (tid == 0) mbar_arrive_tx(bar, (unsigned)(kept + !presorted) * row_bytes);
        __syncthreads();
        if (tid == 0 && !presorted) bulk_copy(stage, vectors + (size_t)t_row * d, row_bytes, bar);
        for (int i = tid; i < nown; i += SC_THREADS) {
            const int id = ids[w0 + i];
            if (id >= 0) bulk_copy(rows + (size_t)i * rs, vectors + (size_t)id * d, row_bytes, bar);
        }
    };

    // Persistent: a cluster walks the targets u, u + clusters, ...; the next
    // target's ids arrive (4-byte cp.async) during this one's scan, and its
    // rows are staged as soon as this one's scan is done, under the output.
    const size_t stride_u = gridDim.x / ctas;
    size_t u = blockIdx.x / ctas;
    if (tid == 0) mbar_init(bar);
    for (int w = tid; w < W; w += SC_THREADS) cidbuf[w] = cand[u * W + w];
    int t_cur = presorted ? -1 : targets[u];
    float tn_cur = presorted ? 0.0f : norms[t_cur];
    __syncthreads();
    stage_rows(t_cur, cidbuf);
    for (int it = 0; u < (size_t)U; ++it, u += stride_u) {
        int* cid = cidbuf + (it & 1) * W;
        int* cid_next = cidbuf + ((it + 1) & 1) * W;
        const size_t un = u + stride_u;
        // this target and its norm, loaded during the last one; the next's
        const int t = t_cur;
        const float tn = tn_cur;
        if (un < (size_t)U) {
            for (int w = tid; w < W; w += SC_THREADS) stage_copy4(cid_next + w, cand + un * W + w);
            if (!presorted) t_cur = targets[un];
        }
        // 1. the dedup, while the rows land: duplicates (the first copy wins),
        // the target itself and -1
        for (int w = tid; w < W; w += SC_THREADS) pub_mins[w] = WIDE_INF;
        if (!presorted) {
            table_clear(hid, htag, cv.hbits);
            __syncthreads();
            for (int w = tid; w < W; w += SC_THREADS) {
                const int id = cid[w];
                if (id >= 0 && id != t) table_claim(hid, htag, cv.hbits, id, w);
            }
            __syncthreads();
            for (int w = tid; w < W; w += SC_THREADS) {
                const int id = cid[w];
                if (id >= 0 &&
                    (id == t || htag[table_insert(hid, cv.hbits, id)] != (unsigned)(w + 1)))
                    cid[w] = -1;
            }
        }
        __syncthreads();
        // 2. the rows
        mbar_wait(bar, it & 1);
        // a target with no candidate (an empty beam buffer) has only padding
        int any = 0;
        for (int x = 0; x < W; x += SC_THREADS)
            any |= __syncthreads_or(x + tid < W && cid[x + tid] >= 0);
        int pairs = 0;
        unsigned* taken = reinterpret_cast<unsigned*>(keys);   // by sorted place, once sorted
        if (!any) {
            for (int x = tid; x < nw; x += SC_THREADS) valid[x] = 0;
        } else {
            // 3. each own row's distance to the target and its sum of squares in
            // warp_dot's order (wide_util.cuh, the global form's): lane l sums
            // float4 l, l + 32, ... in one fmaf chain and the lanes' sums meet
            // in a butterfly; a warp takes SC_DIST rows at once (reduce_rows)
            const float4* t4 = reinterpret_cast<const float4*>(stage);
            for (int b0 = warp * SC_DIST; b0 < nown; b0 += SC_THREADS / 32 * SC_DIST) {
                const float4* r4[SC_DIST];
#pragma unroll
                for (int r = 0; r < SC_DIST; ++r)
                    r4[r] =
                        reinterpret_cast<const float4*>(rows + (size_t)min(b0 + r, nown - 1) * rs);
                float v[SC_DIST], n[SC_DIST];
#pragma unroll
                for (int r = 0; r < SC_DIST; ++r) v[r] = n[r] = 0.0f;
                for (int c = lane; c < q4; c += 32) {
                    const float4 y = presorted ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : t4[c];
#pragma unroll
                    for (int r = 0; r < SC_DIST; ++r) {
                        const float4 x = r4[r][c];
                        v[r] = fmaf(y.x, x.x, v[r]);
                        v[r] = fmaf(y.y, x.y, v[r]);
                        v[r] = fmaf(y.z, x.z, v[r]);
                        v[r] = fmaf(y.w, x.w, v[r]);
                        if (metric == 0) {   // the pairs' L2 epilogue reads the rows' own norms
                            n[r] = fmaf(x.x, x.x, n[r]);
                            n[r] = fmaf(x.y, x.y, n[r]);
                            n[r] = fmaf(x.z, x.z, n[r]);
                            n[r] = fmaf(x.w, x.w, n[r]);
                        }
                    }
                }
                const float dot = reduce_rows<SC_DIST, 32>(v, lane);
                const float nv = reduce_rows<SC_DIST, 32>(n, lane);
                const int i = b0 + lane / (32 / SC_DIST);   // the row this lane's sums are of
                if (lane % (32 / SC_DIST) == 0 && i < nown) {
                    const int w = w0 + i, id = cid[w];
                    dist[w] = id < 0       ? WIDE_INF
                              : presorted ? cand_d[u * W + w]
                                          : sel_epilogue(dot, tn, norms[id], metric);
                    nrm[w] = id < 0 ? 0.0f : nv;
                }
            }
            if (ctas > 1) {
                // every CTA's distances and norms
                cg::cluster_group cluster = cg::this_cluster();
                cluster.sync();
                for (int w = tid; w < W; w += SC_THREADS) {
                    const int r = w / share;
                    if (r != rank) {
                        dist[w] = *cluster.map_shared_rank(dist + w, r);
                        nrm[w] = *cluster.map_shared_rank(nrm + w, r);
                    }
                }
            }
            __syncthreads();

            // 4. the sort by (distance, position): warp-sorted runs of 32 keys, each
            // key ranked by binary searches of the other runs
            if (presorted) {
                for (int w = tid; w < W; w += SC_THREADS) sidx[w] = order[w] = w;
            } else {
                for (int w = tid; w < 32 * nw; w += SC_THREADS)
                    keys[w] = w < W ? ((u64)f2key(dist[w]) << 32) | (unsigned)w : ~0ull;
                __syncthreads();
                for (int r = warp; r < nw; r += SC_THREADS / 32)
                    warp_sort_run(keys + 32 * r, 32, lane);
                __syncthreads();
                for (int j = tid; j < W; j += SC_THREADS) {
                    const u64 key = keys[j];
                    int r = j & 31;
                    for (int o = 0; o < nw; ++o)
                        if (o != (j >> 5)) r += count_below(keys + 32 * o, 32, key);
                    const int w = (int)(key & 0xffffffffu);
                    sidx[w] = r;
                    order[r] = w;
                }
            }
            __syncthreads();
            // validity and the first alive set (every min still +inf), by sorted place
            for (int x = warp; x < nw; x += SC_THREADS / 32) {
                const int s = 32 * x + lane;
                const bool v = s < sel_cap && cid[order[s]] >= 0;
                const bool a = v && dist[order[s]] < __fmul_rn(alpha, WIDE_INF);
                const unsigned vb = __ballot_sync(WIDE_FULL, v), ab = __ballot_sync(WIDE_FULL, a);
                if (lane == 0) {
                    valid[x] = vb;
                    alive[x] = ab;
                }
            }
            for (int w = tid; w < W; w += SC_THREADS) mins[w] = WIDE_INF;
            __syncthreads();
            int n_valid = 0;
            for (int x = 0; x < nw; ++x) n_valid += __popc(valid[x]);

            // 5. the scan in batches: a batch is the next SC_SPEC alive candidates
            // (valid, not decided, below alpha times their min: a candidate at or
            // above it can never be taken, the min only falls). Their pair columns
            // against every later alive candidate, and against each other, are
            // computed first; then each is decided in order from its min before
            // the batch and the columns of the batch's takes before it; then the
            // takes fold into the mins.
            // Every CTA decides the same; each keeps its own candidates' mins and
            // publishes them and their alive bits for the next batch.
            int next = 0, cnt = 0, batch = 0;
            for (int x = tid; x < nw; x += SC_THREADS) taken[x] = 0;
            while (cnt < deg) {
                const int par = batch & 1, npar = par ^ 1;
                // the alive bits: the first batch's from the distances, then those
                // the owners published after the last batch
                const unsigned* live = batch == 0 ? alive : pub_alive + par * nw;
                if (ctas > 1 && batch > 0) {
                    cg::cluster_group cluster = cg::this_cluster();
                    for (int x = tid; x < nw; x += SC_THREADS) {
                        unsigned a = 0;
                        for (int r = 0; r < ctas; ++r)
                            a |= *cluster.map_shared_rank(pub_alive + par * nw + x, r);
                        alive[x] = a;
                    }
                    live = alive;
                    __syncthreads();
                }
                // every warp finds the batch's members (the next nspec alive
                // candidates; lane j holds the j-th); warp 0 writes their rows,
                // mins before the batch, norms, distances and later counts, and
                // clears the next alive bits; a warp a chunk of 32 own positions
                // lists its later alive rows, in order
                int ns = 0, mine = -1;
                for (int x = next >> 5; x < nw && ns < nspec; ++x) {
                    unsigned a = live[x];
                    if (x == next >> 5) a &= ~0u << (next & 31);
                    for (; a && ns < nspec; a &= a - 1, ++ns)
                        if (lane == ns) mine = 32 * x + __ffs(a) - 1;
                }
                if (ns == 0) break;
                const int last = __shfl_sync(WIDE_FULL, mine, ns - 1);
                if (warp == 0) {
                    cg::cluster_group cluster = cg::this_cluster();
                    if (lane < ns) {
                        const int w = order[mine];
                        const int r = w / share;
                        spec[lane] = mine;
                        spec_nrm[lane] = nrm[w];
                        spec_d[lane] = dist[w];
                        spec_later[lane] = n_valid - valid_upto(valid, mine);
                        if (r == rank) {
                            spec_min[lane] = mins[w];
                            spec_off[lane] = (int)((cv.rows >> 2) + (size_t)(w - w0) * rs);
                        } else {
                            spec_min[lane] = *cluster.map_shared_rank(pub_mins + par * W + w, r);
                            spec_off[lane] = (int)((cv.stage >> 2) + (size_t)lane * rs);
                        }
                    }
                    for (int x = lane; x < nw; x += 32) pub_alive[npar * nw + x] = 0;
                }
                const int nch = (nown + 31) / 32;
                for (int c = warp; c < nch; c += SC_THREADS / 32) {
                    const int i = 32 * c + lane;
                    bool f = false;
                    if (i < nown) {
                        const int s = sidx[w0 + i];
                        f = s > last && s < sel_cap && ((live[s >> 5] >> (s & 31)) & 1u);
                    }
                    const unsigned bal = __ballot_sync(WIDE_FULL, f);
                    if (f) act[32 * c + __popc(bal & ((1u << lane) - 1u))] = i;
                    if (lane == 0) chunkn[c] = __popc(bal);
                }
                __syncthreads();
                if (ctas > 1) {
                    // the batch's rows the other CTAs hold, copied here
                    cg::cluster_group cluster = cg::this_cluster();
                    for (int e = tid; e < ns * q4; e += SC_THREADS) {
                        const int k = e / q4, c = e - k * q4;
                        const int w = order[spec[k]];
                        const int r = w / share;
                        if (r != rank) {
                            const float4* src = reinterpret_cast<const float4*>(
                                cluster.map_shared_rank(rows + (size_t)(w - r * share) * rs, r));
                            reinterpret_cast<float4*>(stage + (size_t)k * rs)[c] = src[c];
                        }
                    }
                    __syncthreads();
                }
                // the pair columns in warp_dot's order: a warp takes a tile of up
                // to SC_TILE own rows (or, last, of the batch's own rows) against
                // the batch's rows: 32 fmaf chains a lane over its float4s, then
                // one reduce_rows (rows past a tile's run on a stand-in and are
                // dropped)
                // tiles of SC_TILE rows within a chunk
                int own_tiles = 0, n_act = 0;
                for (int c = 0; c < nch; ++c) {
                    n_act += chunkn[c];
                    own_tiles += (chunkn[c] + SC_TILE - 1) / SC_TILE;
                }
                const int n_tiles = own_tiles + (ns > 1 ? (ns + SC_TILE - 1) / SC_TILE : 0);
                for (int tile = warp; tile < n_tiles; tile += SC_THREADS / 32) {
                    const bool tri_tile = tile >= own_tiles;
                    int o0 = (tile - own_tiles) * SC_TILE, n_o = ns;   // the tile's first row, rows
                    if (!tri_tile) {
                        int c = 0, lt = tile;
                        for (; lt >= (chunkn[c] + SC_TILE - 1) / SC_TILE; ++c)
                            lt -= (chunkn[c] + SC_TILE - 1) / SC_TILE;
                        o0 = 32 * c + lt * SC_TILE;
                        n_o = 32 * c + chunkn[c];
                    }
                    const float4* o4[SC_TILE];
                    const float4* s4[SC_SPEC];
#pragma unroll
                    for (int o = 0; o < SC_TILE; ++o) {
                        const int e = o0 + o < n_o ? o0 + o : o0;
                        o4[o] = reinterpret_cast<const float4*>(
                            tri_tile ? base_f + spec_off[e] : rows + (size_t)act[e] * rs);
                    }
#pragma unroll
                    for (int k = 0; k < SC_SPEC; ++k)
                        s4[k] = reinterpret_cast<const float4*>(base_f + spec_off[k < ns ? k : 0]);
                    float v[SC_TILE * SC_SPEC];   // pair (o, k) at o * SC_SPEC + k
#pragma unroll
                    for (int p = 0; p < SC_TILE * SC_SPEC; ++p) v[p] = 0.0f;
                    for (int c = lane; c < q4; c += 32) {
                        float4 a[SC_SPEC];
#pragma unroll
                        for (int k = 0; k < SC_SPEC; ++k) a[k] = s4[k][c];
#pragma unroll
                        for (int o = 0; o < SC_TILE; ++o) {
                            const float4 b = o4[o][c];
#pragma unroll
                            for (int k = 0; k < SC_SPEC; ++k) {
                                v[o * SC_SPEC + k] = fmaf(a[k].x, b.x, v[o * SC_SPEC + k]);
                                v[o * SC_SPEC + k] = fmaf(a[k].y, b.y, v[o * SC_SPEC + k]);
                                v[o * SC_SPEC + k] = fmaf(a[k].z, b.z, v[o * SC_SPEC + k]);
                                v[o * SC_SPEC + k] = fmaf(a[k].w, b.w, v[o * SC_SPEC + k]);
                            }
                        }
                    }
                    // reduce_rows<32, 32> written out a level at a time (an array
                    // of 32 passed by reference stays in local memory): lane l
                    // ends with pair l, row o0 + l / 8, batch member l % 8
                    float h16[16], h8[8], h4[4], h2[2];
#pragma unroll
                    for (int i = 0; i < 16; ++i) {
                        const bool up = (lane & 16) != 0;
                        h16[i] = pick(up, v[i + 16], v[i]) +
                                 __shfl_xor_sync(WIDE_FULL, pick(up, v[i], v[i + 16]), 16);
                    }
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        const bool up = (lane & 8) != 0;
                        h8[i] = pick(up, h16[i + 8], h16[i]) +
                                __shfl_xor_sync(WIDE_FULL, pick(up, h16[i], h16[i + 8]), 8);
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const bool up = (lane & 4) != 0;
                        h4[i] = pick(up, h8[i + 4], h8[i]) +
                                __shfl_xor_sync(WIDE_FULL, pick(up, h8[i], h8[i + 4]), 4);
                    }
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const bool up = (lane & 2) != 0;
                        h2[i] = pick(up, h4[i + 2], h4[i]) +
                                __shfl_xor_sync(WIDE_FULL, pick(up, h4[i], h4[i + 2]), 2);
                    }
                    const bool up1 = (lane & 1) != 0;
                    const float sum = pick(up1, h2[1], h2[0]) +
                                      __shfl_xor_sync(WIDE_FULL, pick(up1, h2[0], h2[1]), 1);
                    const int o = o0 + lane / SC_SPEC, k = lane % SC_SPEC;
                    if (k < ns && o < n_o) {
                        if (tri_tile) {
                            if (k < o)
                                tri[k * SC_SPEC + o] =
                                    sel_epilogue(sum, spec_nrm[o], spec_nrm[k], metric);
                        } else {
                            const int i = act[o];
                            pbuf[(size_t)i * SC_SPEC + k] =
                                sel_epilogue(sum, nrm[w0 + i], spec_nrm[k], metric);
                        }
                    }
                }
                __syncthreads();
                // the decisions, the same in every warp and CTA: lane k holds batch
                // member k's min before the batch and its pairs with the members
                // before it; the members are decided in order
                unsigned tk = 0;
                {
                    // every thread holds the batch's mins, distances, later counts
                    // and triangle, and decides the members in order
                    float pm[SC_SPEC], pd[SC_SPEC], tr[SC_SPEC][SC_SPEC];
                    int pl[SC_SPEC];
#pragma unroll
                    for (int k = 0; k < SC_SPEC; ++k) {
                        pm[k] = spec_min[k];
                        pd[k] = spec_d[k];
                        pl[k] = spec_later[k];
#pragma unroll
                        for (int i = 0; i < k; ++i) tr[i][k] = tri[i * SC_SPEC + k];
                    }
#pragma unroll
                    for (int k = 0; k < SC_SPEC; ++k) {
                        if (k >= ns || cnt >= deg) break;
                        float m = pm[k];
#pragma unroll
                        for (int i = 0; i < k; ++i)
                            if ((tk >> i) & 1u) m = fminf(m, tr[i][k]);
                        if (pd[k] < __fmul_rn(alpha, m)) {
                            tk |= 1u << k;
                            if (++cnt < deg) pairs += pl[k];
                        }
                    }
                }
                if (tid < ns && ((tk >> tid) & 1u))
                    atomicOr(taken + (spec[tid] >> 5), 1u << (spec[tid] & 31));
                next = last + 1;
                ++batch;
                if (cnt >= deg) break;
                // the takes fold into the mins of the own later alive candidates,
                // whose alive bits the next batch reads (cleared in the set-up)
                unsigned* my_alive = pub_alive + npar * nw;
                for (int e = tid; e < 32 * nch; e += SC_THREADS) {
                    if (e % 32 >= chunkn[e / 32]) continue;
                    const int i = act[e], w = w0 + i, s = sidx[w];
                    float m = mins[w];
                    for (int k = 0; k < ns; ++k)
                        if ((tk >> k) & 1u) m = fminf(m, pbuf[(size_t)i * SC_SPEC + k]);
                    mins[w] = m;
                    if (ctas > 1) pub_mins[npar * W + w] = m;
                    if (dist[w] < __fmul_rn(alpha, m))
                        atomicOr(my_alive + (s >> 5), 1u << (s & 31));
                }
                sel_sync(ctas);
            }
        }
        // no CTA reads another's rows, ids or published state of this target
        // after this: the next target's rows may land
        sel_sync(ctas);
        if (un < (size_t)U) {
            stage_wait();
            __syncthreads();
            stage_rows(t_cur, cid_next);
            if (!presorted) tn_cur = norms[t_cur];
        }

        // 6. the taken, then the rest as backfill, both in sorted order
        if (rank == 0 && warp == 0) {
            int o = 0;
            for (int pass = 0; pass < 2; ++pass)
                for (int base = 0; base < sel_cap && o < deg; base += 32) {
                    const int s = base + lane;
                    const bool f = s < sel_cap && ((valid[s >> 5] >> (s & 31)) & 1u) &&
                                   (((taken[s >> 5] >> (s & 31)) & 1u) != 0) == (pass == 0);
                    const unsigned bal = __ballot_sync(WIDE_FULL, f);
                    const int r = o + __popc(bal & ((1u << lane) - 1u));
                    if (f && r < deg) {
                        const int w = order[s];
                        out_i[u * deg + r] = dist[w] < WIDE_INF ? cid[w] : -1;
                        out_d[u * deg + r] = dist[w];
                    }
                    o += __popc(bal);
                }
            for (int r = min(o, deg) + lane; r < deg; r += 32) {
                out_i[u * deg + r] = -1;
                out_d[u * deg + r] = WIDE_INF;
            }
            if (lane == 0) out_pairs[u] = pairs;
        }
        __syncthreads();   // the output read this target's ids: the buffer is the next's
    }

}

// The batch's rows a CTA copies at most (the most of 8, 4, 2, 1 whose room
// fits) and its shared memory, at `ctas` CTAs a target; 0 when none fits a
// block's opted-in shared memory on the current device or a CTA would hold
// no candidate.
static int select_cluster_nspec(int W, int d, int ctas, bool presorted, size_t* smem) {
    if (ctas < 1 || ctas > SC_CTAS_MAX || ctas > W) return 0;
    if ((long long)(ctas - 1) * ((W + ctas - 1) / ctas) >= W) return 0;
    const size_t room = launch_util::smem_optin();
    for (int nspec = SC_SPEC; nspec >= 1; nspec >>= 1) {
        *smem = SelCarve(W, d, ctas, presorted, nspec).total;
        if (*smem <= room) return nspec;
        if (ctas == 1) return 0;   // one CTA copies no rows: its room is the same
    }
    return 0;
}

// CTAs a target of the cluster form at W candidates of d floats: the least
// whose share of the window's rows (with the scalars and a batch's copied
// rows) fits a block's opted-in shared memory on the current device, up to
// SC_CTAS_MAX; 0: the global form
extern "C" long long hnsw_select_wide_ctas(int W, int d, int presorted) {
    if (W < 1 || d < 4 || d % 4 != 0) return 0;
    size_t smem = 0;
    for (int ctas = 1; ctas <= SC_CTAS_MAX; ++ctas)
        if (select_cluster_nspec(W, d, ctas, presorted != 0, &smem)) return ctas;
    return 0;
}

// The clusters of `ctas` CTAs at `smem` bytes the current device holds at
// once (the occupancy calculator's answer, asked once a (device, ctas, smem))
static int select_cluster_fit(const cudaLaunchConfig_t* cfg, int ctas, size_t smem, int* fit) {
    struct Entry {
        int dev, ctas, fit;
        size_t smem;
    };
    static Entry seen[64];
    static int n = 0;
    static std::mutex mu;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    {
        std::lock_guard<std::mutex> lock(mu);
        for (int i = 0; i < n; ++i)
            if (seen[i].dev == dev && seen[i].ctas == ctas && seen[i].smem == smem) {
                *fit = seen[i].fit;
                return 0;
            }
    }
    e = cudaOccupancyMaxActiveClusters(fit, select_cluster_kernel, cfg);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    std::lock_guard<std::mutex> lock(mu);
    if (n < 64) seen[n++] = Entry{dev, ctas, *fit, smem};
    return 0;
}

static int launch_select_cluster(const float* vectors, const float* norms, const int* targets,
                                 const int* cand, const float* cand_d, int U, int W, int d,
                                 int deg, int sel_cap, float alpha, int metric, int ctas,
                                 int* out_i, float* out_d, int* out_pairs, void* stream) {
    if (U < 1 || W < 1 || d < 4 || d % 4 != 0 || deg < 1 || sel_cap < 1 || sel_cap > W ||
        metric < 0 || metric > 2)
        return (int)cudaErrorInvalidValue;
    size_t smem = 0;
    const int nspec = select_cluster_nspec(W, d, ctas, cand_d != nullptr, &smem);
    if (nspec == 0) return (int)cudaErrorInvalidValue;
    const int err = raise_smem(select_cluster_kernel, smem);
    if (err) return err;
    if (ctas > SC_CLUSTER) {
        const cudaError_t e = cudaFuncSetAttribute(
            select_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)ctas);
    cfg.blockDim = dim3(SC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // persistent clusters: as many as the card holds at once, at most U
    int fit = 0;
    const int q = select_cluster_fit(&cfg, ctas, smem, &fit);
    if (q) return q;
    if (fit < 1) return (int)cudaErrorInvalidValue;
    cfg.gridDim = dim3((unsigned)(fit < U ? fit : U) * (unsigned)ctas);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, select_cluster_kernel, vectors, norms, targets,
                                             cand, cand_d, U, W, d, deg, sel_cap, alpha, metric,
                                             ctas, nspec, out_i, out_d, out_pairs);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" int hnsw_select_cluster(const float* vectors, const float* norms, const int* targets,
                                   const int* cand, int U, int W, int d, int deg, int sel_cap,
                                   float alpha, int metric, int ctas, int* out_i, float* out_d,
                                   int* out_pairs, void* stream) {
    return launch_select_cluster(vectors, norms, targets, cand, nullptr, U, W, d, deg, sel_cap,
                                 alpha, metric, ctas, out_i, out_d, out_pairs, stream);
}

extern "C" int hnsw_select_sorted_cluster(const float* vectors, const int* cand,
                                          const float* cand_d, int U, int W, int d, int deg,
                                          float alpha, int metric, int ctas, int* out_i,
                                          float* out_d, int* out_pairs, void* stream) {
    if (cand_d == nullptr) return (int)cudaErrorInvalidValue;
    return launch_select_cluster(vectors, nullptr, nullptr, cand, cand_d, U, W, d, deg, W, alpha,
                                 metric, ctas, out_i, out_d, out_pairs, stream);
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
