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
//  - probe_dist_sq8_kernel: one block a (query, probe), a warp a lane: K4's
//    exact int8 dot and epilogue.
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
    probe_dist_sq8_kernel<<<B * P, PW_THREADS, 0, (cudaStream_t)stream>>>(
        ProbeCells{cells, P, L, members, alive, allowed}, qc, qs, qsum, qn, codes, mins, scales,
        pnorms, d, metric, dist);
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

// Candidates a CTA of the distance pass takes: runs of 32, as few a CTA as
// spread the batch's candidates over about two CTAs an SM
static int rerank_chunk(int B, int r) {
    const long long runs = (r + 31) / 32;
    const long long want = 2LL * launch_util::sm_count();
    long long per = (want + B - 1) / B;    // chunks a query
    per = per < 1 ? 1 : per > runs ? runs : per;
    return (int)((runs + per - 1) / per) * 32;
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
    const int chunk = rerank_chunk(B, r);
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
