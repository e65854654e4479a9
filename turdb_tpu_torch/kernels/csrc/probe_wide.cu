// The wide forms of the IVF probes and the rerank: K1 ivf_probe_f32 and
// K4 ivf_probe_sq8 (query-major) past m = SEL_MAX winners, the dedup tail
// of both probes (and of K4's cell-major pass) past it, and K5 ivf_rerank
// past r = SEL_MAX candidates. The fast forms (ivf_probe.cu, ivf_rerank.cu)
// select inside one block over shared memory, m or r at most SEL_MAX.
//
// Replaces, as the fast forms do: turdb_tpu/models/ivf.py ivf_search_impl
// (the probe, mask_duplicates and the top-k; the rerank branch; ops/topk.py
// mask_duplicates). Reached by an IVF search with k or rerank past 2048 and
// by SQL `ORDER BY emb <-> ... LIMIT 513` and deeper on a USING IVF index
// (fetch = 4*LIMIT).
//
// What bounds it on an H100: the rows read (P*L of 4d or d bytes a query;
// r rows for the rerank) and the [rows, P*L] or [B, r] f32 distances
// written and read back by the selection. At B = 1 (a SQL statement) the
// latency of dependent trips to device memory, and how many SMs a row's
// work spreads over, decide the time.
//
// Design: write-then-select, as K4's cell-major pass already runs.
//  - probe_dist_f32_kernel: one 128-thread block a (query, probe); a warp
//    takes a run of 32 lanes and reads their member ids and flags in one
//    coalesced step, writes +inf for the dead ones (their rows are never
//    read), and scores the live ones PD_R rows in flight at a time, as K1's
//    fast form does: lane j sums float4 j, j + 32, ... of each row in one
//    fmaf chain and the rows' sums meet in reduce_rows (row_sums.cuh), so
//    every distance is the one warp_dot (wide_util.cuh) gave, bit for bit.
//  - probe_dist_sq8_run_kernel (K4's query-major route; the cell-major one
//    is ivf_probe.cu's): K1's pass in shape, on K4's fast-form scorers
//    (sq8_rows.cuh): a 128-thread block a (query, probe, chunk of lanes),
//    the chunks sized from the SM count so that one query spreads over the
//    card (B = 1, P = 50, L = 128: 200 CTAs of one run each); every warp
//    reads a run of 32 lanes' ids, flags and metadata in one step, the
//    dead lanes +inf and unread, the live ones in groups of PQ_R rows, the
//    block's warps taking the groups in turn, eight lanes a row in 16-byte
//    words (else a warp a row), each row's first words all in flight; the
//    query row in shared memory. Exact int32 dots: the plain version's
//    distances bit for bit.
//  - K2 (topk_rows.cu) selects each row's m best by (value, position).
//  - probe_tail_wide_kernel: one 1024-thread block a row. Every winner's id
//    is looked up at once; under replicas every winner claims its id in a
//    table (graph_util.cuh: atomicMin of the winner's rank, so the first
//    copy wins, O(m) in all) and a finite winner holding its claim
//    survives; the survivors' places come from a
//    block-wide prefix count (a ballot and popc a warp, one scan of the
//    warps' counts a tile of 1024 winners), and every thread writes its
//    own. The ids and the table live in shared memory where the row's m
//    winners fit a block's opted-in shared memory (m <= 8,192 on an H100),
//    else in a global scratch (`ivf_probe_tail_wide_words`). Or, in
//    candidate mode, all m with their flat positions cell*L + lane.
//  - rerank_dist_chunk_kernel: K5's exact distance in K5's order, +inf
//    where the probe's was, and under replicas +inf on later copies of an
//    id and on id -1 (mask_duplicates: an earlier copy counts whether its
//    probe distance is finite or not). A grid of (query, chunk of
//    candidates), sized from the SM count so that one query spreads over
//    the card (B = 1, r = 2,400: 75 CTAs of 32 candidates); a warp reads a
//    run of 32 candidates' metadata in one step and skips the dead ones
//    before touching their rows; the live ones go PD_R rows in flight a
//    warp, the block's warps taking the groups in turn, the sums meeting
//    in reduce_rows (warp_dot's bit for bit; the SQ16 decode and its
//    butterfly likewise). The dedup is O(r) a CTA: its chunk's query's ids
//    up to the chunk's end claim in a table in its shared memory (r <=
//    8,192 on an H100), else in a global table that one claim pass fills
//    (`ivf_rerank_dist_table_words`); a candidate keeps its row iff its
//    claim is its own. K2 then selects the k smallest by (distance,
//    candidate index).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch_util.cuh"
#include "row_sums.cuh"
#include "sq8_rows.cuh"
#include "wide_util.cuh"

enum { PW_TOPK = 0, PW_CAND = 1 };

struct ProbeCells {
    const int* cells;          // [B, P]
    int P, L;
    const int* members;        // [NB, L] ids, -1 empty
    const uint8_t* alive;      // [NB, L]
    const uint8_t* allowed;    // [NB, L] or null
};

#define PD_THREADS 128   // K1's distance pass: four warps a (query, probe) block
#define PD_R 4           // live rows in flight a warp
#define PD_J 4           // float4 columns of each a lane loads at once (512 floats a row)

// K1's distances: block (b, p); a warp takes a run of 32 lanes at a time
__global__ void __launch_bounds__(PD_THREADS)
probe_dist_f32_kernel(ProbeCells c, const float* __restrict__ q, const float* __restrict__ qn,
                      const float* __restrict__ pvecs, const float* __restrict__ pnorms, int d,
                      int metric, float* __restrict__ dist) {
    const size_t b = blockIdx.x / c.P;
    const int p = blockIdx.x - (int)(b * c.P);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t cell = (size_t)c.cells[b * c.P + p];
    const float qnb = qn[b];
    const float4* q4 = reinterpret_cast<const float4*>(q + b * d);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int d4 = d >> 2;
    float* out = dist + (b * c.P + p) * (size_t)c.L;
    for (int base = warp * 32; base < c.L; base += PD_THREADS) {
        // the run's member ids and flags in one step; dead lanes are +inf
        const int l = base + lane;
        const size_t row = cell * c.L + l;
        bool live = false;
        float pn = 0.0f;
        if (l < c.L) {
            const int mem = c.members[row];
            const uint8_t al = c.alive[row];
            const uint8_t ok = c.allowed == nullptr ? (uint8_t)1 : c.allowed[row];
            live = mem >= 0 && al != 0 && ok != 0;
            if (live && metric == 0) pn = pnorms[row];
            if (!live) out[l] = WIDE_INF;
        }
        unsigned left = __ballot_sync(WIDE_FULL, live);
        while (left) {
            // the next PD_R live lanes of the run, in order
            int src[PD_R];
            const float4* r4[PD_R];
#pragma unroll
            for (int r = 0; r < PD_R; ++r) {
                src[r] = left ? __ffs(left) - 1 : -1;
                left &= left - 1;
                r4[r] = reinterpret_cast<const float4*>(
                    pvecs + (cell * c.L + base + (src[r] < 0 ? 0 : src[r])) * d);
            }
            // lane j sums float4 j, j + 32, ... of each row in one fmaf chain,
            // PD_J of them a row loaded before any is summed
            float v[PD_R];
#pragma unroll
            for (int r = 0; r < PD_R; ++r) v[r] = 0.0f;
            for (int j0 = lane; j0 < d4; j0 += 32 * PD_J) {
                float4 x[PD_J][PD_R], y[PD_J];
#pragma unroll
                for (int u = 0; u < PD_J; ++u) {
                    const int j = j0 + 32 * u;
                    y[u] = j < d4 ? __ldg(q4 + j) : zero;
#pragma unroll
                    for (int r = 0; r < PD_R; ++r)
                        x[u][r] = src[r] >= 0 && j < d4 ? __ldg(r4[r] + j) : zero;
                }
#pragma unroll
                for (int u = 0; u < PD_J; ++u)
                    if (j0 + 32 * u < d4) {
#pragma unroll
                        for (int r = 0; r < PD_R; ++r) {
                            v[r] = fmaf(x[u][r].x, y[u].x, v[r]);
                            v[r] = fmaf(x[u][r].y, y[u].y, v[r]);
                            v[r] = fmaf(x[u][r].z, y[u].z, v[r]);
                            v[r] = fmaf(x[u][r].w, y[u].w, v[r]);
                        }
                    }
            }
            const float dot = reduce_rows<PD_R, 32>(v, lane);
            // lane t holds slot t / (32 / PD_R)'s sum; its first lane writes it
            const int h = lane / (32 / PD_R);
            int s = -1;
#pragma unroll
            for (int r = 0; r < PD_R; ++r)
                if (r == h) s = src[r];
            const float pnh = __shfl_sync(WIDE_FULL, pn, s < 0 ? 0 : s);
            if (lane % (32 / PD_R) == 0 && s >= 0) {
                float val = -dot;
                if (metric == 0) val = __fsub_rn(__fadd_rn(qnb, pnh), __fmul_rn(2.0f, dot));
                else if (metric == 1) val = __fsub_rn(1.0f, dot);
                out[base + s] = val;
            }
        }
    }
}

#define PQ_THREADS 128   // K4's query-major pass: four warps a (query, probe, lane chunk) block
#define PQ_WARPS (PQ_THREADS / 32)
#define PQ_R 8           // live rows a warp scores at once (a group)
#define PQ_JG 8          // 16-byte words of each row a lane loads before any is summed
#define PQ_JW 2          // 4-byte words likewise, where rows are no 16-byte words

// K4's distances: block (query, probe, chunk s of `chunk` lanes). Every
// warp reads a run of 32 lanes' member, flags and metadata in one step
// (warp 0 writes +inf for the dead ones, whose rows are never read); the
// live lanes go in groups of PQ_R, the block's warps taking the groups in
// turn, with K4's fast-form scorer (sq8_rows.cuh): GROUPS eight lanes a row
// in 16-byte words, else a warp a row in 4-byte words, every row's first
// PQ_JG / PQ_JW words loaded before any is summed. The exact int32 dot and
// the epilogue's scalars (shuffled from the run lane that read them) give
// sq8_distance, so every distance is the plain version's bit for bit.
template <bool GROUPS>
__global__ void __launch_bounds__(PQ_THREADS, 4)
probe_dist_sq8_run_kernel(ProbeCells c, int split, int chunk, const int8_t* __restrict__ qc,
                          const float* __restrict__ qs, const float* __restrict__ qsum,
                          const float* __restrict__ qn, const int8_t* __restrict__ codes,
                          const float* __restrict__ mins, const float* __restrict__ scales,
                          const float* __restrict__ pnorms, int d, int metric, int q_in_smem,
                          float* __restrict__ dist) {
    using Lay = RowLayout<PQ_R, GROUPS ? 8 : 32>;
    constexpr int SLOTS = Lay::SLOTS;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_src[PQ_WARPS][32];   // a warp's live run lanes, in order
    const size_t bp = blockIdx.x / split;
    const int s = (int)(blockIdx.x - bp * split);
    const size_t b = bp / c.P;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t cell = (size_t)c.cells[bp];
    const float qnb = qn[b], qsb = qs[b], qsumb = qsum[b];
    // the query's int8 row in shared memory where it fits
    const int8_t* qrow = qc + b * d;
    if (q_in_smem) {
        if constexpr (GROUPS) {
            for (int i = threadIdx.x; i < (d >> 4); i += PQ_THREADS)
                reinterpret_cast<int4*>(smem)[i] = reinterpret_cast<const int4*>(qrow)[i];
        } else {
            for (int i = threadIdx.x; i < (d >> 2); i += PQ_THREADS)
                reinterpret_cast<int*>(smem)[i] = reinterpret_cast<const int*>(qrow)[i];
        }
        qrow = reinterpret_cast<const int8_t*>(smem);
    }
    __syncthreads();
    float* out = dist + bp * (size_t)c.L;
    const int l1 = min(c.L, (s + 1) * chunk);
    for (int base = s * chunk; base < l1; base += 32) {
        const int l = base + lane;
        const size_t row = cell * c.L + l;
        bool live = false;
        float mn = 0.0f, sc = 0.0f, pn = 0.0f;
        if (l < l1) {
            const int mem = c.members[row];
            const uint8_t al = c.alive[row];
            const uint8_t ok = c.allowed == nullptr ? (uint8_t)1 : c.allowed[row];
            mn = mins[row];
            sc = scales[row];
            if (metric == 0) pn = pnorms[row];
            live = mem >= 0 && al != 0 && ok != 0;
            if (!live && warp == 0) out[l] = WIDE_INF;
        }
        const unsigned bal = __ballot_sync(WIDE_FULL, live);
        if (live) s_src[warp][__popc(bal & ((1u << lane) - 1u))] = lane;
        __syncwarp();
        const int nlive = __popc(bal);
        for (int g0 = warp * PQ_R; g0 < nlive; g0 += PQ_R * PQ_WARPS) {
            int rows[SLOTS];
#pragma unroll
            for (int j = 0; j < SLOTS; ++j) {
                const int r = g0 + Lay::slot_row(j, lane);
                rows[j] = r < nlive ? (int)(cell * c.L) + base + s_src[warp][r] : -1;
            }
            int v[SLOTS];
            if constexpr (GROUPS)
                sq8_groups_partial<SLOTS, PQ_JG>(codes, reinterpret_cast<const int4*>(qrow), rows,
                                                 lane, d, v);
            else
                sq8_words_partial<SLOTS, PQ_JW>(codes, reinterpret_cast<const int*>(qrow), rows,
                                                lane, d, v);
            const int dot = reduce_rows<SLOTS, Lay::W>(v, lane);
            const int h = g0 + Lay::held_row(lane);
            const int src = h < nlive ? s_src[warp][h] : 0;
            const float mh = __shfl_sync(WIDE_FULL, mn, src);
            const float sh = __shfl_sync(WIDE_FULL, sc, src);
            const float ph = __shfl_sync(WIDE_FULL, pn, src);
            if (Lay::writer(lane) && h < nlive)
                out[base + src] = sq8_distance(dot, mh, sh, ph, qsb, qsumb, qnb, metric);
        }
        __syncwarp();   // s_src is the next run's
    }
}

#define PT_THREADS 1024   // the tail: one block a row
#define PT_WARPS (PT_THREADS / 32)

// Shared bytes of the tail's block when a row's m winners live there: their
// ids, under replicas the claim table (ids and tags, graph_util.cuh's size
// for m), and the warps' counts.
__host__ __device__ inline size_t tail_smem(int m, int replicated) {
    return wide_align16((size_t)4 * m) + (replicated ? (size_t)8 << table_bits(m) : 0) +
           4 * (PT_WARPS + 1);
}

// The m winners of row b (K2's selection: sel_d ascending, sel_pos their
// columns p*L + lane) -> the probe's outputs, as ivf_probe.cu probe_tail:
// under replicas the first copy of an id wins (an id claims with id + 1,
// so -1 claims too, as the reference's mask_duplicates compares it), then
// the first k survivors, +inf / -1 past them. in_smem 0: the ids in
// wid_ids [B, m] and the table in table [B, 2 << table_bits(m)].
__global__ void __launch_bounds__(PT_THREADS)
probe_tail_wide_kernel(ProbeCells c, const float* __restrict__ sel_d,
                       const int* __restrict__ sel_pos, int k, int m, int replicated, int mode,
                       int in_smem, int* table, int* wid_ids, float* __restrict__ out_d,
                       int* __restrict__ out_i, int* __restrict__ out_pos) {
    extern __shared__ __align__(16) unsigned char smem[];
    const size_t b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bits = table_bits(m);
    int* ids = in_smem ? reinterpret_cast<int*>(smem) : wid_ids + b * m;
    unsigned* hid = in_smem ? reinterpret_cast<unsigned*>(smem + wide_align16((size_t)4 * m))
                            : reinterpret_cast<unsigned*>(table) + b * ((size_t)2 << bits);
    unsigned* htag = hid + (1 << bits);
    int* wsum = in_smem ? reinterpret_cast<int*>(smem + tail_smem(m, replicated)) - (PT_WARPS + 1)
                        : reinterpret_cast<int*>(smem);
    for (int i = tid; i < m; i += PT_THREADS) {
        const int col = sel_pos[b * m + i];
        const int p = col / c.L, l = col - p * c.L;
        const int cell = c.cells[b * c.P + p];
        const int id = c.members[(size_t)cell * c.L + l];
        if (mode == PW_CAND) {
            out_d[b * m + i] = key2f(f2key(sel_d[b * m + i]));
            out_i[b * m + i] = id;
            out_pos[b * m + i] = cell * c.L + l;
        } else {
            ids[i] = id;
        }
    }
    if (mode == PW_CAND) return;
    if (replicated) {
        table_clear(hid, htag, bits);
        __syncthreads();
        for (int i = tid; i < m; i += PT_THREADS) table_claim(hid, htag, bits, ids[i] + 1, i);
    }
    __syncthreads();
    // the survivors in order, a tile of PT_THREADS winners at a time
    int base = 0;
    for (int t0 = 0; t0 < m && base < k; t0 += PT_THREADS) {
        const int i = t0 + tid;
        bool keep = false;
        float v = 0.0f;
        int id = -1;
        if (i < m) {
            const uint32_t key = f2key(sel_d[b * m + i]);
            id = ids[i];
            keep = key < INF_KEY &&
                   (!replicated || htag[table_insert(hid, bits, id + 1)] == (unsigned)(i + 1));
            v = key2f(key);
        }
        const unsigned bal = __ballot_sync(WIDE_FULL, keep);
        if (lane == 0) wsum[warp] = __popc(bal);
        __syncthreads();
        if (warp == 0) {
            const int n = wsum[lane];
            int incl = n;
            for (int o = 1; o < 32; o <<= 1) {
                const int x = __shfl_up_sync(WIDE_FULL, incl, o);
                if (lane >= o) incl += x;
            }
            wsum[lane] = incl - n;
            if (lane == 31) wsum[PT_WARPS] = incl;
        }
        __syncthreads();
        const int o = base + wsum[warp] + __popc(bal & ((1u << lane) - 1u));
        if (keep && o < k) {
            out_d[b * k + o] = v;
            out_i[b * k + o] = id;
        }
        base += wsum[PT_WARPS];
        __syncthreads();   // wsum is the next tile's
    }
    for (int o = min(base, k) + tid; o < k; o += PT_THREADS) {
        out_d[b * k + o] = WIDE_INF;
        out_i[b * k + o] = -1;
    }
}

#define RD_THREADS 256   // K5 wide's distance pass: eight warps a (query, chunk) block
#define RD_WARPS (RD_THREADS / 32)
#define RD_CLAIM 256     // the global table's claim pass: a candidate a thread

// The replica dedup's claim table: in each CTA's shared memory (the ids of
// candidates [0, end) of its chunk's query, so every earlier copy claims),
// or, past what a CTA holds, a global table [B, 2 << bits] filled once by
// rerank_claim_kernel. Candidate i keeps its row iff its id is not -1 and
// its claim (the lowest index of the id, graph_util.cuh) is its own.
struct RerankDedup {
    const unsigned* gtab;      // [B, 2 << gbits] or null: the table in shared memory
    int gbits;
};

__device__ __forceinline__ bool first_copy(const unsigned* hid, const unsigned* htag, int bits,
                                           int id, int i) {
    const int mask = (1 << bits) - 1;
    for (int p = (int)(((unsigned)id * 0x9E3779B1u) >> (32 - bits));; p = (p + 1) & mask) {
        const unsigned k = hid[p];
        if (k == (unsigned)id) return htag[p] == (unsigned)(i + 1);
        if (k == EMPTY_ID) return false;   // unreachable: every id claimed
    }
}

// every candidate's id claims its lowest index in query b's global table
__global__ void __launch_bounds__(RD_CLAIM)
rerank_claim_kernel(const int* __restrict__ cand_i, int r, int per, int bits, unsigned* table) {
    const size_t b = blockIdx.x / per;
    const int i = (int)(blockIdx.x - b * per) * RD_CLAIM + threadIdx.x;
    if (i >= r) return;
    const int id = cand_i[b * r + i];
    unsigned* hid = table + b * ((size_t)2 << bits);
    if (id != -1) table_claim(hid, hid + (1 << bits), bits, id, i);
}

// K5's exact distances of the candidates [c0, c1) of query b to ex[b, r]:
// a warp reads a run of 32 candidates' probe distance, id and position in
// one step; a dead one (+inf probe distance, id -1, a later copy of an id)
// is +inf and its row never read; the live ones go in groups of PD_R, the
// block's warps taking the groups in turn, each group's rows loaded before
// any is summed. f32: lane j sums float4 j, j + 32, ... in one fmaf chain
// and the rows' sums meet in reduce_rows, so every distance is warp_dot's
// bit for bit; SQ16: the same over ushort4 words, each code decoded as
// base + s16 * u, which is the earlier one-row kernel's order too.
template <bool SQ16>
__global__ void __launch_bounds__(RD_THREADS)
rerank_dist_chunk_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                         const float* __restrict__ cand_d, const int* __restrict__ cand_i,
                         const int* __restrict__ cand_pos, int r, int chunks, int chunk,
                         const void* __restrict__ rows, const float* __restrict__ pnorms,
                         const float* __restrict__ mins, const float* __restrict__ scales, int d,
                         int replicated, RerankDedup dd, float* __restrict__ ex) {
    extern __shared__ __align__(16) unsigned char smem[];
    const size_t b = blockIdx.x / chunks;
    const int c0 = (int)(blockIdx.x - b * chunks) * chunk, c1 = min(r, c0 + chunk);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int* ids = cand_i + b * r;
    int bits = dd.gbits;
    const unsigned* hid = dd.gtab ? dd.gtab + b * ((size_t)2 << bits) : nullptr;
    if (replicated && dd.gtab == nullptr) {
        // the ids of [0, c1) claim in this CTA's table
        bits = table_bits(c1);
        unsigned* sid = reinterpret_cast<unsigned*>(smem);
        table_clear(sid, sid + (1 << bits), bits);
        __syncthreads();
        for (int i = threadIdx.x; i < c1; i += RD_THREADS) {
            const int id = ids[i];
            if (id != -1) table_claim(sid, sid + (1 << bits), bits, id, i);
        }
        __syncthreads();
        hid = sid;
    }
    const float qnb = qn[b];
    const float4* q4 = reinterpret_cast<const float4*>(q + b * d);
    const int d4 = d >> 2;
    const float s16_ratio = (float)(255.0 / 65535.0);
    for (int base = c0; base < c1; base += 32) {
        const int i = base + lane;
        const size_t o = b * r + i;
        bool live = false;
        int pos = 0;
        float pn = 0.0f;
        if (i < c1) {
            live = !isinf(cand_d[o]);
            if (replicated) {
                const int id = ids[i];
                live = live && id != -1 && first_copy(hid, hid + (1 << bits), bits, id, i);
            }
            if (live) {
                pos = cand_pos[o];
                pn = pnorms[pos];
            } else if (warp == 0) {
                ex[o] = WIDE_INF;
            }
        }
        unsigned left = __ballot_sync(WIDE_FULL, live);
        for (int g = 0; left; ++g) {
            // group g: the next PD_R live candidates of the run, in order
            int src[PD_R];
#pragma unroll
            for (int k = 0; k < PD_R; ++k) {
                src[k] = left ? __ffs(left) - 1 : -1;
                left &= left - 1;
            }
            if (g % RD_WARPS != warp) continue;
            // each row's words (f32: float4, SQ16: ushort4) and SQ16's decode
            using Raw = typename std::conditional<SQ16, ushort4, float4>::type;
            const Raw* xr[PD_R];
            float rb[PD_R], rs[PD_R];
#pragma unroll
            for (int k = 0; k < PD_R; ++k) {
                const int row = __shfl_sync(WIDE_FULL, pos, src[k] < 0 ? 0 : src[k]);
                xr[k] = static_cast<const Raw*>(rows) + (size_t)row * d4;
                if constexpr (SQ16) {
                    const float sr = __ldg(scales + row);
                    rb[k] = __fsub_rn(__ldg(mins + row), __fmul_rn(128.0f, sr));
                    rs[k] = __fmul_rn(sr, s16_ratio);
                }
            }
            float v[PD_R];
#pragma unroll
            for (int k = 0; k < PD_R; ++k) v[k] = 0.0f;
            for (int j0 = lane; j0 < d4; j0 += 32 * PD_J) {
                Raw x[PD_J][PD_R];
                float4 y[PD_J];
#pragma unroll
                for (int u = 0; u < PD_J; ++u) {
                    const int j = j0 + 32 * u;
                    y[u] = j < d4 ? __ldg(q4 + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
                    for (int k = 0; k < PD_R; ++k)
                        x[u][k] = src[k] >= 0 && j < d4 ? __ldg(xr[k] + j) : Raw{};
                }
#pragma unroll
                for (int u = 0; u < PD_J; ++u)
                    if (j0 + 32 * u < d4) {
#pragma unroll
                        for (int k = 0; k < PD_R; ++k) {
                            float4 e;
                            if constexpr (SQ16) {
                                const ushort4 c = x[u][k];
                                e = make_float4(__fadd_rn(rb[k], __fmul_rn(rs[k], (float)c.x)),
                                                __fadd_rn(rb[k], __fmul_rn(rs[k], (float)c.y)),
                                                __fadd_rn(rb[k], __fmul_rn(rs[k], (float)c.z)),
                                                __fadd_rn(rb[k], __fmul_rn(rs[k], (float)c.w)));
                            } else {
                                e = x[u][k];
                            }
                            v[k] = fmaf(e.x, y[u].x, v[k]);
                            v[k] = fmaf(e.y, y[u].y, v[k]);
                            v[k] = fmaf(e.z, y[u].z, v[k]);
                            v[k] = fmaf(e.w, y[u].w, v[k]);
                        }
                    }
            }
            const float dot = reduce_rows<PD_R, 32>(v, lane);
            // lane t holds group slot t / (32 / PD_R)'s sum; its first lane writes it
            const int h = lane / (32 / PD_R);
            int sl = -1;
#pragma unroll
            for (int k = 0; k < PD_R; ++k)
                if (k == h) sl = src[k];
            const float pnh = __shfl_sync(WIDE_FULL, pn, sl < 0 ? 0 : sl);
            if (lane % (32 / PD_R) == 0 && sl >= 0)
                ex[b * r + base + sl] = __fsub_rn(__fadd_rn(qnb, pnh), __fmul_rn(2.0f, dot));
        }
    }
}

// Of `rows` rows of n entries, the entries a CTA takes: runs of 32, as few
// a CTA as spread the rows over about two CTAs an SM (K5 wide's candidates
// of a query, K4 wide's lanes of a (query, probe))
static int run_chunk(long long rows, int n) {
    const long long runs = (n + 31) / 32;
    const long long want = 2LL * launch_util::sm_count();
    long long per = (want + rows - 1) / rows;    // chunks a row
    per = per < 1 ? 1 : per > runs ? runs : per;
    return (int)((runs + per - 1) / per) * 32;
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
    probe_dist_f32_kernel<<<B * P, PD_THREADS, 0, (cudaStream_t)stream>>>(
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
    const long long pairs = (long long)B * P;
    const int chunk = run_chunk(pairs, L);
    const int split = (L + chunk - 1) / chunk;
    if (pairs * split > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const bool groups = d % 16 == 0 && (size_t)codes % 16 == 0 && (size_t)qc % 16 == 0;
    const size_t qbytes = wide_align16((size_t)d);
    const int q_in_smem = qbytes + (size_t)4 * 32 * PQ_WARPS <= launch_util::smem_optin();
    const size_t smem = q_in_smem ? qbytes : 0;
    const ProbeCells c{cells, P, L, members, alive, allowed};
    const unsigned grid = (unsigned)(pairs * split);
    const cudaStream_t st = (cudaStream_t)stream;
    if (groups) {
        const int err = raise_smem(probe_dist_sq8_run_kernel<true>, smem);
        if (err) return err;
        probe_dist_sq8_run_kernel<true><<<grid, PQ_THREADS, smem, st>>>(
            c, split, chunk, qc, qs, qsum, qn, codes, mins, scales, pnorms, d, metric, q_in_smem,
            dist);
    } else {
        const int err = raise_smem(probe_dist_sq8_run_kernel<false>, smem);
        if (err) return err;
        probe_dist_sq8_run_kernel<false><<<grid, PQ_THREADS, smem, st>>>(
            c, split, chunk, qc, qs, qsum, qn, codes, mins, scales, pnorms, d, metric, q_in_smem,
            dist);
    }
    return (int)cudaGetLastError();
}

// Where the tail keeps a row's winners: 0 in the block's shared memory
// (candidate mode needs none), else the words a row of the global claim
// table (the `wid` scratch [B, words]; the ids go to `flag` [B, m]).
static bool tail_in_smem(int m, int replicated, int mode) {
    return mode == PW_CAND || tail_smem(m, replicated) <= launch_util::smem_optin();
}

extern "C" long long ivf_probe_tail_wide_words(int m, int replicated, int mode) {
    return m < 1 || tail_in_smem(m, replicated, mode) ? 0 : (long long)2 << table_bits(m);
}

// the probe's outputs from K2's selection of m winners a row (any m)
extern "C" int ivf_probe_tail_wide(const int* cells, int B, int P, const int* members, int L,
                                   const float* sel_d, const int* sel_pos, int k, int m,
                                   int replicated, int mode, int* wid, int* flag, float* out_d,
                                   int* out_i, int* out_pos, void* stream) {
    if (B < 1 || P < 1 || L < 1 || k < 1 || m < k || (mode != PW_TOPK && mode != PW_CAND) ||
        (mode == PW_CAND && (m != k || out_pos == nullptr)))
        return (int)cudaErrorInvalidValue;
    const bool in_smem = tail_in_smem(m, replicated, mode);
    if (!in_smem && (wid == nullptr || flag == nullptr)) return (int)cudaErrorInvalidValue;
    const size_t smem = mode == PW_CAND ? 0
                        : in_smem       ? tail_smem(m, replicated)
                                        : 4 * (PT_WARPS + 1);
    const int err = raise_smem(probe_tail_wide_kernel, smem);
    if (err) return err;
    probe_tail_wide_kernel<<<B, PT_THREADS, smem, (cudaStream_t)stream>>>(
        ProbeCells{cells, P, L, members, nullptr, nullptr}, sel_d, sel_pos, k, m, replicated,
        mode, (int)in_smem, wid, flag, out_d, out_i, out_pos);
    return (int)cudaGetLastError();
}

// Where K5 wide's dedup keeps its claim table: 0 in each CTA's shared
// memory (a table over r ids fits), else the words of a query's global
// table (the wrapper's `table` [B, words]).
static bool rerank_table_in_smem(int r) {
    return ((size_t)8 << table_bits(r)) <= launch_util::smem_optin();
}

extern "C" long long ivf_rerank_dist_table_words(int r, int replicated) {
    return r < 1 || !replicated || rerank_table_in_smem(r) ? 0 : (long long)2 << table_bits(r);
}


// K5's exact distances ex [B, r] (any r); K2 selects from them. Under
// replicas past what a CTA's table holds, `table` [B, words] (words =
// ivf_rerank_dist_table_words) is cleared and filled by a claim pass first.
extern "C" int ivf_rerank_dist(const float* q, const float* qn, const float* cand_d,
                               const int* cand_i, const int* cand_pos, int B, int r,
                               const void* rows, int sq16, const float* pnorms, const float* mins,
                               const float* scales, int d, int replicated, unsigned* table,
                               float* ex, void* stream) {
    if (B < 1 || r < 1 || d < 4 || d % 4 != 0 || (size_t)q % 16 || (size_t)rows % (sq16 ? 8 : 16) ||
        (sq16 && (mins == nullptr || scales == nullptr)))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    RerankDedup dd{nullptr, 0};
    size_t smem = 0;
    if (replicated && rerank_table_in_smem(r)) {
        smem = (size_t)8 << table_bits(r);
    } else if (replicated) {
        if (table == nullptr) return (int)cudaErrorInvalidValue;
        dd = RerankDedup{table, table_bits(r)};
        // EMPTY_ID ids and 0xffffffff tags: every byte 0xff
        cudaError_t e = cudaMemsetAsync(table, 0xff, (size_t)B * ((size_t)8 << dd.gbits), st);
        if (e != cudaSuccess) return (int)e;
        const int per = (r + RD_CLAIM - 1) / RD_CLAIM;
        rerank_claim_kernel<<<(unsigned)((long long)B * per), RD_CLAIM, 0, st>>>(
            cand_i, r, per, dd.gbits, table);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const int chunk = run_chunk(B, r);
    const int chunks = (r + chunk - 1) / chunk;
    const long long grid = (long long)B * chunks;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (sq16) {
        const int err = raise_smem(rerank_dist_chunk_kernel<true>, smem);
        if (err) return err;
        rerank_dist_chunk_kernel<true><<<(unsigned)grid, RD_THREADS, smem, st>>>(
            q, qn, cand_d, cand_i, cand_pos, r, chunks, chunk, rows, pnorms, mins, scales, d,
            replicated, dd, ex);
    } else {
        const int err = raise_smem(rerank_dist_chunk_kernel<false>, smem);
        if (err) return err;
        rerank_dist_chunk_kernel<false><<<(unsigned)grid, RD_THREADS, smem, st>>>(
            q, qn, cand_d, cand_i, cand_pos, r, chunks, chunk, rows, pnorms, mins, scales, d,
            replicated, dd, ex);
    }
    return (int)cudaGetLastError();
}
