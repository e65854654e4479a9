// The wide forms of the HNSW beams and the greedy descent: K8
// hnsw_graph_beam (f32 rows), K8-SQ (the SQ8 / SQ16 store) and K6
// hnsw_serve_beam past what hnsw_beam.cu keeps in shared memory and
// registers (ef or k_res > 1024, expand*deg > 1024 slots, more than 2048
// expansions, rows past 4096), and K9 hnsw_greedy past the rows
// hnsw_greedy.cu stages (d > 4096).
//
// Replaces, as the fast forms do: turdb_tpu/models/hnsw.py _beam_level and
// _greedy_level, turdb_tpu/models/hnsw_serve.py serve_search_impl (stage 1b
// and the rerank). Reached by SQL `ORDER BY emb <-> ... LIMIT 129` and
// deeper on a USING HNSW index (fetch = 4*LIMIT at ef = 2*fetch: LIMIT 200
// is B = 1, ef 1,600, k_res 800, 600 steps of expand 4), by searches with
// ef > 1024, and by rows wider than 4096.
//
// What bounds it on an H100: the latency of the beam's dependent steps (a
// step reads its nodes' lists, then their rows), as the fast form's; a
// step's own work is O(expand·deg) beyond the merge's shift. K9 wide: a
// step's deg rows of 4·d bytes (295 KB at deg 16, 4,608-d), through one SM
// at B = 1, and the card's memory at a full batch.
//
// Design: one 256-thread block a query, its state in the block's dynamic
// shared memory (opted in up to 227 KB: at iters = 1.5·ef about ef 4,000,
// 73 KB at the LIMIT 200 shape, 85 KB with K6's rerank keys), past that
// in a global scratch slice of the block (`hnsw_beam_wide_bytes` > 0; K6:
// `hnsw_serve_beam_wide_bytes`; a grid of at most `grid` blocks walking the
// queries): the sorted candidate buffer and its expanded
// flags, the filtered result buffer, the member set, the step's claim
// table, the slots' ids, distances and claims, the survivors' keys, the
// expanded ids. The loop (wide_beam) keeps the fast form's step order and
// sums, with the bookkeeping made incremental:
// - one member set across steps (open addressing with tombstones): the
//   ids that enter the buffer join it, the ones the merge evicts
//   unexpanded leave it, expanded ids stay; rebuilt from the buffer and
//   the expanded ids before its entries in use pass three quarters of it.
//   A slot drops a member and claims the others in a claim table of
//   2·slots entries, reset entry by entry after the claims are read;
// - a cursor of the first unexpanded entry, so warp 0's ballot scan starts
//   there;
// - the merge in place from the first place a new key takes (each key's
//   place by binary searches of the warp-sorted runs of 32 and of the
//   buffer, then the old entries moved up a block at a time from the top);
// - K8's rows scored by lane groups of 8 with 4 rows each in flight: every
//   kept slot of a step (of 128 at expand 4, deg 32) in one round, the kept
//   slots compacted first so that no group takes more rows than it must;
// - K8-SQ's kept slots compacted too, their code rows copied into a stage
//   in the block's shared memory by cp.async (a warp a row, neighbouring
//   lanes on neighbouring 16-byte words, stage_rows' layout of an odd word
//   count a row, every copy of a batch issued before any is waited for,
//   the rows' norms, mins and scales loaded meanwhile), then thread j
//   scores staged row j against the query row, which the block copies into
//   its shared memory once a query. The stage holds a step's slots where
//   the state leaves room (128 rows of 784 bytes beside the 69 KB state at
//   ef 1,600, 768-d SQ8), fewer rows a batch where less fits; where the
//   state lies in the global scratch the stage still takes the block's
//   shared memory (`sq_stage` sizes both before the launch);
// - K6's stage: once warp 0 has chosen a step's nodes it starts one
//   cp.async.bulk of each node's meta block ([deg] int4, onto one
//   mbarrier) and of each node's code block ([deg, d] int8, one contiguous
//   run, onto another) into the block's shared memory, so the copies fly
//   while the claims run; the claims read the slots' ids from the staged
//   meta; the kept slots, compacted, are scored from the stage by lane
//   groups of 8 (16-byte words, four __dp4a a word, a shuffle sum) against
//   the query's int8 row, which the block copies into its shared memory
//   once a query. The stage holds a step's blocks beside the state where
//   they fit (4 nodes, 51 KB, beside the 85 KB state at the LIMIT 200
//   shape), fewer nodes a batch where less fits, and the state moves to
//   the global scratch where one node's block does not fit beside it
//   (`serve_stage` sizes both before the launch).
// The scores are the fast forms' to the bit: K8 by lane groups of 8 in
// K8's order (graph_scorer.cuh group_scores), K8-SQ by one thread a row in
// SqScorer::staged_dot's order (the fast form's staged_score; the sum order
// is kept because lane-group sums moved one SQ16 query of the 1M check
// past the tie band, graph_scorer.cuh), K6 by the exact int8 dot (any order
// gives the same sum) and its epilogue. K6's rerank reads a warp a row, 4
// rows of a warp at once, in warp_dot's order (row_sums.cuh reduce_rows);
// the fast form's one fmaf chain a row is not kept, so its distances agree
// with the plain version's within the fp32 tolerance. K9 wide is a block a
// query, a warp a neighbour row on 16-byte words, in warp_dot's order (d >
// 4,096 has no fast form to agree with). A seed list that repeats an id is
// not supported (an evicted copy would leave the member set), as in the
// fast forms; the system's seeds never repeat.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "graph_scorer.cuh"
#include "launch_util.cuh"
#include "row_sums.cuh"
#include "wide_util.cuh"

#define WB_THREADS 256
#define WB_WARPS (WB_THREADS / 32)
#define WB_ROWS 4           // rows a lane group of K8 wide scores at once
#define RR_ROWS 4           // rows a warp of K6 wide's rerank reads at once
#define WG_THREADS 256
#define WG_WARPS (WG_THREADS / 32)
#define WG_ROWS 2           // rows a warp of K9 wide reads at once
#define WG_WORDS 8          // 16-byte words a lane of K9 wide keeps in flight a row
#define WG_CAP 128          // steps of one level's walk (kernels.GREEDY_CAP)
#define WG_LEVELS_MAX 8     // kernels/build.py GREEDY_LEVELS_MAX
#define MSET_TOMB 0xfffffffeu   // a member set entry whose id left the set
#define SQ_STAGE_MIN 32     // K8-SQ: the fewest rows a batch beside a state in shared memory

// how a beam scores a step's kept slots
enum { SCORE_GROUPS, SCORE_STAGED, SCORE_SERVE };

extern __shared__ __align__(16) unsigned char wide_state[];

// The waits each of a block's mbarriers has seen (K6 wide: the meta
// blocks', the code rows'), so that a wait knows the parity of the phase it
// expects; kept across the block's queries.
struct WidePhases {
    unsigned meta, code;
};

struct WideArgs {
    int B, S, d, deg, ef, loops, expand, exp_cap, slots, k_res, metric;
    int mbits;                 // the member set holds 1 << mbits entries
    int cbits;                 // the step's claim table 1 << cbits
    int ins;                   // ids a step can add to the member set: min(slots, ef)
    int rpow;                  // K6: the rerank's sort keys (0: none)
    const int* seed_i;         // [B, S]
    const float* seed_d;       // [B, S]
    const uint8_t* allowed;    // [cap] or null
    const float* qn;           // [B]
};

// One query's state, laid out in this order, in the block's shared memory
// or (past it) in the block's slice of a global scratch.
struct WideBufs {
    u64* kc; u64* kr;          // [slots] survivors' keys: buffer, results
    u64* rk;                   // [rpow] K6's rerank keys
    unsigned* mid;             // [1 << mbits] the member set
    unsigned* cid; unsigned* ctag;   // [1 << cbits] the step's claim table
    float* cd; int* ci; int* cx;     // [ef] the buffer: distance, id, expanded
    float* rd; int* ri;              // [k_res] the filtered results
    int* nid; float* nd; int* ppos; int* kept;   // [slots] id, distance, claim, K8's kept slots
    int* crank; int* rrank;    // [slots] a new key's place in the buffer / results
    int* sel;                  // [expand] ids expanded this step (-1: none)
    int* exp;                  // [exp_cap] expanded ids
    int* misc;                 // [8]: 0 found, 1 kept, 2 / 3 survivors (buffer / results),
                               // 4 / 5 the first place a new key takes (buffer / results),
                               // 6 member set entries in use, 7 the cursor
};

__host__ __device__ inline size_t wide_beam_bytes(const WideArgs& a) {
    const size_t words = ((size_t)1 << a.mbits) + ((size_t)2 << a.cbits) + 3 * (size_t)a.ef +
                         2 * (size_t)a.k_res + 6 * (size_t)a.slots + a.expand + a.exp_cap + 8;
    return wide_align16((size_t)8 * (2 * (size_t)a.slots + a.rpow) + 4 * words);
}

__device__ inline WideBufs wide_carve(unsigned char* p, const WideArgs& a) {
    WideBufs s;
    u64* w = reinterpret_cast<u64*>(p);
    s.kc = w; w += a.slots;
    s.kr = w; w += a.slots;
    s.rk = w; w += a.rpow;
    unsigned* u = reinterpret_cast<unsigned*>(w);
    s.mid = u; u += 1 << a.mbits;
    s.cid = u; u += 1 << a.cbits;
    s.ctag = u; u += 1 << a.cbits;
    float* f = reinterpret_cast<float*>(u);
    s.cd = f; f += a.ef;
    s.ci = reinterpret_cast<int*>(f); f += a.ef;
    s.cx = reinterpret_cast<int*>(f); f += a.ef;
    s.rd = f; f += a.k_res;
    s.ri = reinterpret_cast<int*>(f); f += a.k_res;
    s.nid = reinterpret_cast<int*>(f); f += a.slots;
    s.nd = f; f += a.slots;
    s.ppos = reinterpret_cast<int*>(f); f += a.slots;
    s.kept = reinterpret_cast<int*>(f); f += a.slots;
    s.crank = reinterpret_cast<int*>(f); f += a.slots;
    s.rrank = reinterpret_cast<int*>(f); f += a.slots;
    s.sel = reinterpret_cast<int*>(f); f += a.expand;
    s.exp = reinterpret_cast<int*>(f); f += a.exp_cap;
    s.misc = reinterpret_cast<int*>(f);
    return s;
}

// The member set: open addressing over ids (linear probing from the
// multiplicative hash, graph_util.cuh's), an id that leaves it overwritten
// by MSET_TOMB, which a lookup probes past and an insert never reuses, so
// two inserts of one id meet at one entry. `used` counts the entries that
// are no longer empty; the set is rebuilt from its members before it
// passes three quarters of its size.
__device__ __forceinline__ int mset_home(int id, int bits) {
    return (int)(((unsigned)id * 0x9E3779B1u) >> (32 - bits));
}

__device__ __forceinline__ bool mset_has(const unsigned* ids, int bits, int id) {
    const int mask = (1 << bits) - 1;
    for (int p = mset_home(id, bits);; p = (p + 1) & mask) {
        const unsigned k = ids[p];
        if (k == (unsigned)id) return true;
        if (k == EMPTY_ID) return false;
    }
}

__device__ __forceinline__ void mset_add(unsigned* ids, int bits, int id, int* used) {
    const int mask = (1 << bits) - 1;
    for (int p = mset_home(id, bits);; p = (p + 1) & mask) {
        const unsigned k = *reinterpret_cast<volatile unsigned*>(ids + p);
        if (k == (unsigned)id) return;
        if (k == EMPTY_ID) {
            const unsigned old = atomicCAS(ids + p, EMPTY_ID, (unsigned)id);
            if (old == EMPTY_ID) {
                atomicAdd(used, 1);
                return;
            }
            if (old == (unsigned)id) return;
        }
    }
}

__device__ __forceinline__ void mset_del(unsigned* ids, int bits, int id) {
    const int mask = (1 << bits) - 1;
    for (int p = mset_home(id, bits);; p = (p + 1) & mask) {
        const unsigned k = ids[p];
        if (k == (unsigned)id) {
            ids[p] = MSET_TOMB;
            return;
        }
        if (k == EMPTY_ID) return;
    }
}

// The beam's scorers: neighbour(node, g) names slot g of node's list;
// SCORE says how the kept slots are scored: by lane groups (K8's order),
// from rows staged in shared memory (K8-SQ), or from the expanded nodes'
// code and meta blocks staged in shared memory (K6)
struct BeamF32 {
    static constexpr int SCORE = SCORE_GROUPS;
    GraphScorer sc;
    __device__ int neighbour(int node, int g, int deg) const { return sc.neighbour(node, g, deg); }
};

// K8-SQ: sc.srows rows a batch of sc.sw 16-byte words each, staged at
// `roff` bytes into the block's dynamic shared memory, the query row at
// `qoff` (sq_stage)
template <class CodeT>
struct BeamSq {
    static constexpr int SCORE = SCORE_STAGED;
    SqScorer<CodeT> sc;
    unsigned qoff, roff;
    __device__ int neighbour(int node, int g, int deg) const { return sc.neighbour(node, g, deg); }
};

// K6: a node's neighbours are one [deg, d] int8 code block and one [deg]
// int4 meta block (base, scale, norm bits, id) of the pack. Its stage lies
// at `soff` bytes into the block's dynamic shared memory (serve_stage): qs
// and qsum, the query's int8 row, two mbarriers (the meta blocks', the code
// rows'), a step's meta blocks ([expand][deg] int4: slot t at t), then
// `srows` code rows a batch, row i of a batch at i * d bytes (the pack's
// own layout, so a node's rows are one copy).
struct BeamServe {
    static constexpr int SCORE = SCORE_SERVE;
    const int8_t* codes;       // [cap, deg, d]
    const int4* meta;          // [cap, deg] (base, scale, norm bits, id)
    const float* vectors;      // [cap, d] the rerank store
    const float* norms;        // [cap]
    const float* q;            // [B, d]
    const int8_t* qc;          // [B, d]
    const float* qs;           // [B]
    const float* qsum;         // [B]
    unsigned soff;             // the stage's offset in dynamic shared memory
    int srows;                 // code rows a batch
    int bulk;                  // code rows copied by cp.async.bulk (else 4-byte cp.async)

    __device__ float* qf() const { return reinterpret_cast<float*>(wide_state + soff); }
    __device__ int* qw() const { return reinterpret_cast<int*>(wide_state + soff + 16); }
    __device__ uint64_t* bars(int d) const {
        return reinterpret_cast<uint64_t*>(wide_state + soff + 16 + wide_align16(d));
    }
    __device__ int4* smeta(int d) const {
        return reinterpret_cast<int4*>(wide_state + soff + 32 + wide_align16(d));
    }
    __device__ unsigned char* rows(int d, int slots) const {
        return wide_state + soff + 32 + wide_align16(d) + (size_t)slots * 16;
    }
    // once a kernel, thread 0; a barrier follows
    __device__ void init(int d) const {
        mbar_init(bars(d));
        mbar_init(bars(d) + 1);
    }
    // query b's int8 row, qs and qsum into the stage (all threads; a barrier follows)
    __device__ void load(size_t b, int d) const {
        const int* src = reinterpret_cast<const int*>(qc + b * d);
        for (int i = threadIdx.x; i < (d >> 2); i += blockDim.x) qw()[i] = src[i];
        if (threadIdx.x == 0) {
            qf()[0] = qs[b];
            qf()[1] = qsum[b];
        }
    }
    // Warp 0 (all lanes, `found` > 0 and warp-uniform): one cp.async.bulk
    // of each selected node's meta block (deg x 16 bytes) into the stage,
    // completing on the first mbarrier; lane 0 arrives first with the bytes
    // to expect.
    __device__ void fetch_meta(const int* sel, int found, int deg, int d, int lane) const {
        uint64_t* bar = bars(d);
        const unsigned bytes = (unsigned)deg * 16;
        if (lane == 0) mbar_arrive_tx(bar, (unsigned)found * bytes);
        __syncwarp();
        for (int e = lane; e < found; e += 32)
            bulk_copy(smeta(d) + (size_t)e * deg, meta + (size_t)sel[e] * deg, bytes, bar);
    }
    // Warp 0 (all lanes): code rows [r0, r1) of the step's slots (slot t =
    // node t / deg's row t % deg; every node there selected) into the stage,
    // one cp.async.bulk a node's run of rows, completing on the second
    // mbarrier.
    __device__ void fetch_rows(const int* sel, int r0, int r1, int deg, int d, int slots,
                               int lane) const {
        uint64_t* bar = bars(d) + 1;
        if (lane == 0) mbar_arrive_tx(bar, (unsigned)(r1 - r0) * d);
        __syncwarp();
        unsigned char* st = rows(d, slots);
        for (int e = r0 / deg + lane; e * deg < r1; e += 32) {
            const int lo = max(r0, e * deg), hi = min(r1, (e + 1) * deg);
            bulk_copy(st + (size_t)(lo - r0) * d,
                      codes + ((size_t)sel[e] * deg + (lo - e * deg)) * d,
                      (unsigned)(hi - lo) * d, bar);
        }
    }
    // the same by every thread's 4-byte cp.async (rows that are no whole
    // aligned 16-byte words), waited for by stage_wait
    __device__ void copy_rows4(const int* sel, int r0, int r1, int deg, int d, int slots) const {
        unsigned char* st = rows(d, slots);
        const int wr = d >> 2;
        for (int e = threadIdx.x; e < (r1 - r0) * wr; e += blockDim.x) {
            const int i = e / wr, w = e - i * wr, t = r0 + i;
            stage_copy4(st + (size_t)i * d + 4 * w,
                        codes + ((size_t)sel[t / deg] * deg + t % deg) * d + 4 * w);
        }
    }
    // the exact int8 dot of a staged row (null: none, 0) with the query row,
    // lane `sub` of a lane group on 16-byte words sub, sub + 8, ... (4-byte
    // words where d % 16 != 0), four __dp4a a word, summed over the group
    // (any order gives the same sum). All 32 lanes call.
    __device__ int group_dot(const unsigned char* row, int d, int sub) const {
        int dot = 0;
        if (row != nullptr) {
            if ((d & 15) == 0) {
                const int4* x4 = reinterpret_cast<const int4*>(row);
                const int4* y4 = reinterpret_cast<const int4*>(qw());
                for (int j = sub; j < (d >> 4); j += GROUP) {
                    const int4 x = x4[j], y = y4[j];
                    dot = __dp4a(x.x, y.x, dot);
                    dot = __dp4a(x.y, y.y, dot);
                    dot = __dp4a(x.z, y.z, dot);
                    dot = __dp4a(x.w, y.w, dot);
                }
            } else {
                const int* x1 = reinterpret_cast<const int*>(row);
                for (int j = sub; j < (d >> 2); j += GROUP) dot = __dp4a(x1[j], qw()[j], dot);
            }
        }
        return group_sum(dot);
    }
    // _approx_dist's epilogue of an exact dot, rounded as hnsw_beam.cu
    // staged_block_score rounds it
    __device__ float finish(int dot, int4 m, float qnb, int metric) const {
        const float* f = qf();
        const float qdx = __fadd_rn(__fmul_rn(__int_as_float(m.x), f[1]),
                                    __fmul_rn(__int_as_float(m.y),
                                              __fmul_rn(f[0], __int2float_rn(dot))));
        if (metric == 0) return __fadd_rn(__fsub_rn(qnb, __fmul_rn(2.0f, qdx)), __int_as_float(m.z));
        if (metric == 1) return __fsub_rn(1.0f, qdx);
        return -qdx;
    }
};

// n (distance, id) seed pairs sorted by (distance, position) into od / oi:
// hnsw_beam.cu's sorted_seeds over the wide form's buffers
__device__ void wide_sorted_seeds(const float* d, const int* id, int n, float* od, int* oi) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const float v = d[j];
        int r = 0;
        for (int i = 0; i < n; ++i) r += d[i] < v || (d[i] == v && i < j);
        od[r] = v;
        oi[r] = id[j];
    }
}

// Each new key's place in the sorted buffer (od, n entries) once the keys
// [0, nk) (runs of 32, each sorted) merge into it: its rank among the keys
// plus the old entries at or below its distance (an old entry stays ahead
// of a new one of the same distance); into rank[j] (n or more: it does not
// enter), and the least place into *first. All threads.
__device__ void wide_new_places(const float* od, int n, const u64* keys, int nk, const float* nd,
                                int* rank, int* first) {
    for (int j = threadIdx.x; j < nk; j += blockDim.x) {
        const u64 key = keys[j];
        int r = j & 31;   // its place in its own run
        for (int base = 0; base < nk && r < n; base += 32)
            if (base != (j & ~31)) r += count_below(keys + base, min(32, nk - base), key);
        if (r < n) {
            const float v = nd[(int)(key & 0xffffffffu)];
            int lo = 0, hi = n;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (od[mid] <= v) lo = mid + 1; else hi = mid;
            }
            r += lo;
        }
        rank[j] = r;
        if (r < n) atomicMin(first, r);
    }
}

// The merge in place, old entries first: each entry at or past `first`
// moves up by the new keys below it, a block of WIDE_SHIFT entries a thread
// at a time from the top (an entry only moves up, past the ones above it
// that have moved already), and an entry pushed past n is dropped:
// evicted(id, flag). Then the caller writes the new keys at their places.
// All threads.
#define WIDE_SHIFT 4
template <class Evicted>
__device__ void wide_shift(float* od, int* oi, int* ox, int n, int first, const u64* keys, int nk,
                           Evicted evicted) {
    const int span = WIDE_SHIFT * (int)blockDim.x;
    for (int hi = n; hi > first; hi -= span) {
        float v[WIDE_SHIFT];
        int id[WIDE_SHIFT], x[WIDE_SHIFT], r[WIDE_SHIFT];
#pragma unroll
        for (int e = 0; e < WIDE_SHIFT; ++e) {
            const int i = hi - span + e * (int)blockDim.x + (int)threadIdx.x;
            r[e] = -1;
            if (i >= first) {
                v[e] = od[i];
                id[e] = oi[i];
                x[e] = ox ? ox[i] : 0;
                r[e] = i + count_below_runs(keys, nk, (u64)f2key(v[e]) << 32);
            }
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < WIDE_SHIFT; ++e) {
            if (r[e] < 0) continue;
            if (r[e] < n) {
                od[r[e]] = v[e];
                oi[r[e]] = id[e];
                if (ox) ox[r[e]] = x[e];
            } else {
                evicted(id[e], x[e]);
            }
        }
        __syncthreads();
    }
}

// The beam of query b over its state `s` (shared memory or the block's
// global slice): leaves the buffer, the results and the expanded ids there,
// returns (expanded nodes, scored neighbours). A step:
//  1. warp 0 takes the `expand` first unflagged finite entries from the
//     cursor on (every entry before the cursor is expanded or no candidate);
//     K6: warp 0 then starts the copies of their meta blocks and of the
//     first batch of their code rows into the stage;
//  2. each slot drops a neighbour that is in the member set (the buffer's
//     ids and every id expanded before) and claims the others in the step's
//     claim table (the lowest slot of an id wins, graph_util.cuh); K6 reads
//     the slots' ids from the staged meta blocks;
//  3. the kept slots are scored (K8-SQ and K6: in batches staged in shared
//     memory), and those below the buffer's worst (and,
//     with `allowed`, the allowed ones below the result buffer's worst)
//     become (f2key(distance) << 32 | slot) keys, sorted by warps in runs
//     of 32 once the claims are reset (an entry per claiming slot);
//  4. each key's place (its rank plus the old entries at or below it), then
//     the merge in place from the first place a key takes: the entries the
//     merge evicts unexpanded leave the member set, the keys that enter
//     join it, the cursor falls back to that first place. The filtered
//     results merge the same way.
// The member set is rebuilt (the buffer's ids and the expanded ones) when
// its entries in use could pass three quarters of it in the next step.
template <class Sc>
__device__ int2 wide_beam(const WideArgs& a, const Sc& sc, const WideBufs& s, size_t b,
                          WidePhases& ph) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int MT = 1 << a.mbits;
    const int* si = a.seed_i + b * a.S;
    const float* sd = a.seed_d + b * a.S;
    for (int j = tid; j < (1 << a.cbits); j += WB_THREADS) {
        s.cid[j] = EMPTY_ID;
        s.ctag[j] = 0xffffffffu;
    }
    for (int j = tid; j < a.ef; j += WB_THREADS) { s.cd[j] = WIDE_INF; s.ci[j] = -1; s.cx[j] = 0; }
    for (int j = tid; j < a.k_res; j += WB_THREADS) { s.rd[j] = WIDE_INF; s.ri[j] = -1; }
    for (int j = tid; j < a.exp_cap; j += WB_THREADS) s.exp[j] = -1;
    if (tid < 8) s.misc[tid] = 0;
    __syncthreads();   // the seeds land at their ranks, any thread's entries
    if (a.k_res) {
        // the allowed seeds, sorted, through the member set's room
        const int sk = a.S < a.k_res ? a.S : a.k_res;
        float* td = reinterpret_cast<float*>(s.mid);
        int* ti = reinterpret_cast<int*>(s.mid) + sk;
        for (int j = tid; j < sk; j += WB_THREADS) {
            const bool ok = si[j] >= 0 && a.allowed[si[j]];
            td[j] = ok ? sd[j] : WIDE_INF;
            ti[j] = ok ? si[j] : -1;
        }
        __syncthreads();
        wide_sorted_seeds(td, ti, sk, s.rd, s.ri);
    }
    wide_sorted_seeds(sd, si, a.S, s.cd, s.ci);
    __syncthreads();
    for (int j = tid; j < MT; j += WB_THREADS) s.mid[j] = EMPTY_ID;
    bool any_seed = false;
    for (int j = tid; j < a.S; j += WB_THREADS) any_seed |= si[j] >= 0;
    if (!__syncthreads_or(any_seed)) return make_int2(0, 0);
    for (int j = tid; j < a.S; j += WB_THREADS)
        if (s.ci[j] >= 0) mset_add(s.mid, a.mbits, s.ci[j], s.misc + 6);
    __syncthreads();

    const float qnb = a.qn[b];
    int n_exp = 0, n_kept = 0;
    for (int it = 0; it < a.loops; ++it) {
        // 1. warp 0: the nodes to expand
        if (warp == 0) {
            int found = 0, last = 0;
            for (int base = s.misc[7]; base < a.ef && found < a.expand; base += 32) {
                const int j = base + lane;
                const bool c = j < a.ef && s.ci[j] >= 0 && !s.cx[j] && s.cd[j] < WIDE_INF;
                unsigned m = __ballot_sync(WIDE_FULL, c);
                while (m && found < a.expand) {
                    const int l = __ffs(m) - 1;
                    m &= m - 1;
                    if (lane == 0) {
                        s.sel[found] = s.ci[base + l];
                        s.cx[base + l] = 1;
                    }
                    last = base + l;
                    ++found;
                }
            }
            __syncwarp();
            for (int e = found + lane; e < a.expand; e += 32) s.sel[e] = -1;
            __syncwarp();
            for (int e = lane; e < a.expand; e += 32) s.exp[it * a.expand + e] = s.sel[e];
            if constexpr (Sc::SCORE == SCORE_SERVE) {
                // the copies fly while the claims run
                if (found) {
                    sc.fetch_meta(s.sel, found, a.deg, a.d, lane);
                    if (sc.bulk)
                        sc.fetch_rows(s.sel, 0, min(sc.srows, found * a.deg), a.deg, a.d, a.slots,
                                      lane);
                }
            }
            if (lane == 0) {
                s.misc[0] = found;
                s.misc[1] = s.misc[2] = s.misc[3] = 0;
                s.misc[4] = a.ef;
                s.misc[5] = a.k_res;
                s.misc[7] = found == a.expand ? last + 1 : a.ef;
            }
            n_exp += found;
        }
        __syncthreads();
        if (s.misc[0] == 0) break;
        // 2. each slot: a member drops out, the others claim their id
        if constexpr (Sc::SCORE == SCORE_SERVE) {
            mbar_wait(sc.bars(a.d), ph.meta & 1);
            ++ph.meta;
        }
        for (int t = tid; t < a.slots; t += WB_THREADS) {
            const int node = s.sel[t / a.deg];
            int id = -1;
            if (node >= 0) {
                if constexpr (Sc::SCORE == SCORE_SERVE) id = sc.smeta(a.d)[t].w;
                else id = sc.neighbour(node, t % a.deg, a.deg);
            }
            s.nid[t] = id;
            s.ppos[t] = id >= 0 && !mset_has(s.mid, a.mbits, id)
                            ? table_claim(s.cid, s.ctag, a.cbits, id, t) : -1;
        }
        __syncthreads();
        // 3. the kept slots (each the lowest claim of its id) scored; the
        // survivors' keys
        const float worst_c = s.cd[a.ef - 1];
        const float worst_r = a.k_res ? s.rd[a.k_res - 1] : 0.0f;
        auto kept = [&](int t) {
            const int p = s.ppos[t];
            return p >= 0 && s.ctag[p] == (unsigned)(t + 1);
        };
        auto survive = [&](int t, int id, float v) {
            s.nd[t] = v;
            const u64 key = ((u64)f2key(v) << 32) | (unsigned)t;
            if (v < worst_c) s.kc[atomicAdd(s.misc + 2, 1)] = key;
            if (a.k_res && v < worst_r && a.allowed[id]) s.kr[atomicAdd(s.misc + 3, 1)] = key;
        };
        if constexpr (Sc::SCORE == SCORE_GROUPS) {
            // the kept slots compacted, then lane groups of 8 with WB_ROWS
            // rows each in flight: every kept row of a step at once, as few
            // as can be a group (K8's sums, R rows or one)
            for (int t = tid; t < a.slots; t += WB_THREADS)
                if (kept(t)) s.kept[atomicAdd(s.misc + 1, 1)] = t;
            __syncthreads();
            const int nk = s.misc[1];
            constexpr int NG = WB_WARPS * (32 / GROUP);
            const int gi = warp * (32 / GROUP) + lane / GROUP, sub = lane % GROUP;
            const unsigned char* qrow =
                reinterpret_cast<const unsigned char*>(sc.sc.q + b * (size_t)a.d);
            for (int base = 0; base < nk; base += NG * WB_ROWS) {
                int t[WB_ROWS], id[WB_ROWS], node[WB_ROWS], g[WB_ROWS];
#pragma unroll
                for (int r = 0; r < WB_ROWS; ++r) {
                    const int row = base + r * NG + gi;
                    t[r] = row < nk ? s.kept[row] : 0;
                    id[r] = row < nk ? s.nid[t[r]] : -1;
                    node[r] = row < nk ? s.sel[t[r] / a.deg] : 0;
                    g[r] = t[r] % a.deg;
                }
                float v[WB_ROWS];
                sc.sc.template group_scores<WB_ROWS>(qrow, node, g, id, a.d, a.deg, sub, qnb,
                                                     a.metric, v);
#pragma unroll
                for (int r = 0; r < WB_ROWS; ++r)
                    if (sub == 0 && id[r] >= 0) survive(t[r], id[r], v[r]);
            }
        } else if constexpr (Sc::SCORE == SCORE_STAGED) {
            // the kept slots compacted; then a batch of rows at a time,
            // copied into the stage (a warp a row, every copy of the batch
            // issued before any is waited for, the first row's norm, min
            // and scale loaded meanwhile), thread j scoring staged row j
            for (int t = tid; t < a.slots; t += WB_THREADS)
                if (kept(t)) s.kept[atomicAdd(s.misc + 1, 1)] = t;
            __syncthreads();
            const int nk = s.misc[1];
            const auto& q = sc.sc;
            const bool w16 = q.wide();
            const int rw = q.row_bytes(a.d) / (w16 ? 16 : 4);   // copies a row
            const size_t pitch = (size_t)q.sw << 4;
            unsigned char* stage = wide_state + sc.roff;
            const unsigned char* qs = wide_state + sc.qoff;
            for (int base = 0; base < nk; base += q.srows) {
                const int n = min(q.srows, nk - base);
                for (int r = warp; r < n; r += WB_WARPS) {
                    const unsigned char* src = q.row(s.nid[s.kept[base + r]], a.d);
                    unsigned char* dst = stage + r * pitch;
                    for (int w = lane; w < rw; w += 32) {
                        if (w16) stage_copy16(dst + 16 * w, src + 16 * w);
                        else stage_copy4(dst + 4 * w, src + 4 * w);
                    }
                }
                RowMeta rm0{0.0f, 0.0f, 0.0f};
                if (tid < n) rm0 = q.meta(s.nid[s.kept[base + tid]]);
                stage_wait();
                __syncthreads();
                for (int j = tid; j < n; j += WB_THREADS) {
                    const int t = s.kept[base + j], id = s.nid[t];
                    const RowMeta rm = j == tid ? rm0 : q.meta(id);
                    survive(t, id, gathered_epilogue(q.staged_dot(stage + j * pitch, qs, a.d, rm),
                                                     qnb, rm.xn, a.metric));
                }
                __syncthreads();   // the stage is the next batch's
            }
        } else {
            // the kept slots compacted; then the code rows a batch of srows
            // at a time from the stage (the first batch's copies issued in
            // step 1, a later one's once the last is scored), a lane group
            // a kept slot of the batch
            for (int t = tid; t < a.slots; t += WB_THREADS)
                if (kept(t)) s.kept[atomicAdd(s.misc + 1, 1)] = t;
            const int live = s.misc[0] * a.deg;   // the selected nodes' rows
            const unsigned char* stage = sc.rows(a.d, a.slots);
            const int4* sm = sc.smeta(a.d);
            constexpr int NG = WB_WARPS * (32 / GROUP);
            const int gi = warp * (32 / GROUP) + lane / GROUP, sub = lane % GROUP;
            for (int r0 = 0; r0 < live; r0 += sc.srows) {
                const int r1 = min(live, r0 + sc.srows);
                if (sc.bulk) {
                    if (r0 > 0 && warp == 0)
                        sc.fetch_rows(s.sel, r0, r1, a.deg, a.d, a.slots, lane);
                    mbar_wait(sc.bars(a.d) + 1, ph.code & 1);
                    ++ph.code;
                } else {
                    sc.copy_rows4(s.sel, r0, r1, a.deg, a.d, a.slots);
                    stage_wait();
                }
                __syncthreads();
                const int nk = s.misc[1];
                for (int j0 = 0; j0 < nk; j0 += NG) {
                    const int j = j0 + gi;
                    const int t = j < nk ? s.kept[j] : -1;
                    const bool in = t >= r0 && t < r1;
                    const int dot =
                        sc.group_dot(in ? stage + (size_t)(t - r0) * a.d : nullptr, a.d, sub);
                    if (in && sub == 0) survive(t, s.nid[t], sc.finish(dot, sm[t], qnb, a.metric));
                }
                __syncthreads();   // the stage is the next batch's
            }
        }
        __syncthreads();
        // the claims reset, an entry a claiming slot; the keys in runs
        for (int t = tid; t < a.slots; t += WB_THREADS) {
            const int p = s.ppos[t];
            if (p >= 0) {
                s.cid[p] = EMPTY_ID;
                s.ctag[p] = 0xffffffffu;
            }
        }
        n_kept += s.misc[1];
        const int nc = s.misc[2], nr = s.misc[3];
        for (int base = warp * 32; base < nc; base += WB_THREADS)
            warp_sort_run(s.kc + base, min(32, nc - base), lane);
        for (int base = warp * 32; base < nr; base += WB_THREADS)
            warp_sort_run(s.kr + base, min(32, nr - base), lane);
        __syncthreads();
        // 4. the merges in place, from the first place a new key takes
        wide_new_places(s.cd, a.ef, s.kc, nc, s.nd, s.crank, s.misc + 4);
        if (a.k_res) wide_new_places(s.rd, a.k_res, s.kr, nr, s.nd, s.rrank, s.misc + 5);
        __syncthreads();
        wide_shift(s.cd, s.ci, s.cx, a.ef, s.misc[4], s.kc, nc, [&](int id, int x) {
            if (!x && id >= 0) mset_del(s.mid, a.mbits, id);
        });
        if (a.k_res)
            wide_shift(s.rd, s.ri, nullptr, a.k_res, s.misc[5], s.kr, nr, [](int, int) {});
        for (int j = tid; j < nc; j += WB_THREADS) {
            const int r = s.crank[j];
            if (r < a.ef) {
                const int t = (int)(s.kc[j] & 0xffffffffu);
                s.cd[r] = s.nd[t];
                s.ci[r] = s.nid[t];
                s.cx[r] = 0;
                mset_add(s.mid, a.mbits, s.nid[t], s.misc + 6);
            }
        }
        for (int j = tid; j < nr; j += WB_THREADS) {
            const int r = s.rrank[j];
            if (r < a.k_res) {
                const int t = (int)(s.kr[j] & 0xffffffffu);
                s.rd[r] = s.nd[t];
                s.ri[r] = s.nid[t];
            }
        }
        if (tid == 0 && s.misc[4] < s.misc[7]) s.misc[7] = s.misc[4];
        __syncthreads();
        if (s.misc[6] > 3 * (MT >> 2) - a.ins) {
            // the member set from its members: the buffer's ids and the
            // expanded ones (the claim table is empty)
            __syncthreads();
            for (int j = tid; j < MT; j += WB_THREADS) s.mid[j] = EMPTY_ID;
            if (tid == 0) s.misc[6] = 0;
            __syncthreads();
            for (int j = tid; j < a.ef; j += WB_THREADS)
                if (s.ci[j] >= 0) mset_add(s.mid, a.mbits, s.ci[j], s.misc + 6);
            for (int j = tid; j < (it + 1) * a.expand; j += WB_THREADS)
                if (s.exp[j] >= 0) mset_add(s.mid, a.mbits, s.exp[j], s.misc + 6);
            __syncthreads();
        }
    }
    return make_int2(n_exp, n_kept);
}

// a block's state: its slice of the global scratch, or (scratch null) its
// dynamic shared memory
__device__ __forceinline__ WideBufs wide_state_of(unsigned char* scratch, size_t stride,
                                                  const WideArgs& a) {
    return wide_carve(scratch ? scratch + blockIdx.x * stride : wide_state, a);
}

// At least one block an SM, so up to 255 registers a thread: K8's four rows
// a lane group in flight stay in registers. Capped at 128 (two blocks an
// SM) K8 wide spilled and took 3.25 ms in place of 2.99-3.09 at the SQL
// LIMIT 200 shape on an H100, and 16.6 in place of 23.2 at B = 1,024
// (PERF.md §6).
template <class Sc>
__global__ void __launch_bounds__(WB_THREADS, 1)
graph_beam_wide_kernel(WideArgs a, Sc sc, float* out_d, int* out_i, float* out_rd, int* out_ri,
                       int* out_exp, int* out_stats, unsigned char* scratch, size_t stride) {
    const WideBufs s = wide_state_of(scratch, stride, a);
    WidePhases ph{0u, 0u};
    for (size_t b = blockIdx.x; b < (size_t)a.B; b += gridDim.x) {
        // K8-SQ scores against the query row in shared memory (wide_beam's
        // first barrier comes before any score)
        if constexpr (Sc::SCORE == SCORE_STAGED) sc.sc.load(b, a.d, wide_state + sc.qoff);
        const int2 stats = wide_beam(a, sc, s, b, ph);
        __syncthreads();
        for (int j = threadIdx.x; j < a.ef; j += WB_THREADS) {
            out_d[b * a.ef + j] = s.cd[j];
            out_i[b * a.ef + j] = s.ci[j];
        }
        for (int j = threadIdx.x; j < a.k_res; j += WB_THREADS) {
            out_rd[b * a.k_res + j] = s.rd[j];
            out_ri[b * a.k_res + j] = s.ri[j];
        }
        if (out_exp)
            for (int j = threadIdx.x; j < a.exp_cap; j += WB_THREADS)
                out_exp[b * a.exp_cap + j] = s.exp[j];
        if (threadIdx.x == 0) reinterpret_cast<int2*>(out_stats)[b] = stats;
        __syncthreads();   // the state is the next query's
    }
}

// K6 wide: the beam (its scorer on the stage), then the exact rerank of
// the r best (unclamped L2, +inf outside `allowed`; their distances and ids
// over the member set, which holds at least 2·ef words) and the k smallest
// by (distance, position). The rerank reads a warp a row, RR_ROWS rows of a
// warp at once: lane l sums the row's float4 words l, l + 32, ... in one
// fmaf chain, and reduce_rows adds the lanes' sums in warp_dot's butterfly.
// At most one block an SM, so the rows in flight stay in registers.
__global__ void __launch_bounds__(WB_THREADS, 1)
serve_beam_wide_kernel(WideArgs a, BeamServe sc, const uint8_t* allowed, int r, int k,
                       float* out_d, int* out_i, int* out_stats, unsigned char* scratch,
                       size_t stride) {
    const WideBufs s = wide_state_of(scratch, stride, a);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int SH = 5 - Log2<RR_ROWS>::value;   // a row's sum lands on lanes e << SH
    if (threadIdx.x == 0) sc.init(a.d);
    __syncthreads();
    WidePhases ph{0u, 0u};
    for (size_t b = blockIdx.x; b < (size_t)a.B; b += gridDim.x) {
        sc.load(b, a.d);   // wide_beam's first barrier comes before any score
        const int2 stats = wide_beam(a, sc, s, b, ph);
        __syncthreads();
        const float qnb = a.qn[b];
        const float4* q4 = reinterpret_cast<const float4*>(sc.q + b * a.d);
        float* td = reinterpret_cast<float*>(s.mid);
        int* ti = reinterpret_cast<int*>(s.mid) + r;
        for (int j0 = warp * RR_ROWS; j0 < r; j0 += WB_WARPS * RR_ROWS) {
            int id[RR_ROWS];
            float acc[RR_ROWS];
#pragma unroll
            for (int e = 0; e < RR_ROWS; ++e) {
                const int v = j0 + e < r ? s.ci[j0 + e] : -1;
                id[e] = v >= 0 && (allowed == nullptr || allowed[v]) ? v : -1;
                acc[e] = 0.0f;
            }
#pragma unroll 4
            for (int c = lane; c < (a.d >> 2); c += 32) {
                float4 x[RR_ROWS];
#pragma unroll
                for (int e = 0; e < RR_ROWS; ++e)
                    x[e] = id[e] >= 0
                               ? __ldg(reinterpret_cast<const float4*>(sc.vectors +
                                                                       (size_t)id[e] * a.d) + c)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                const float4 y = __ldg(q4 + c);
#pragma unroll
                for (int e = 0; e < RR_ROWS; ++e) acc[e] = dot4(acc[e], x[e], y);
            }
            const float dot = reduce_rows<RR_ROWS, 32>(acc, lane);
            const int j = j0 + (lane >> SH);
            if ((lane & ((1 << SH) - 1)) == 0 && j < r) {
                const int id_j = s.ci[j];
                float v = WIDE_INF;
                if (id_j >= 0 && (allowed == nullptr || allowed[id_j])) {
                    if (a.metric == 0)
                        v = __fsub_rn(__fadd_rn(qnb, sc.norms[id_j]), __fmul_rn(2.0f, dot));
                    else if (a.metric == 1) v = __fsub_rn(1.0f, dot);
                    else v = -dot;
                }
                td[j] = v;
                ti[j] = id_j;
                s.rk[j] = ((u64)f2key(v) << 32) | (unsigned)j;
            }
        }
        __syncthreads();
        block_sort_keys(s.rk, r);
        for (int j = threadIdx.x; j < k; j += WB_THREADS) {
            const int p = (int)(s.rk[j] & 0xffffffffu);
            const float v = td[p];
            out_d[b * k + j] = v;
            out_i[b * k + j] = v < WIDE_INF ? ti[p] : -1;
        }
        if (threadIdx.x == 0) reinterpret_cast<int2*>(out_stats)[b] = stats;
        __syncthreads();
    }
}

static WideArgs wide_args(int B, int S, int d, int deg, int ef, int iters, int expand, int k_res,
                          int metric, int rerank, const int* seed_i, const float* seed_d,
                          const uint8_t* allowed, const float* qn) {
    WideArgs a;
    a.B = B; a.S = S; a.d = d; a.deg = deg; a.ef = ef; a.expand = expand;
    a.loops = expand > 0 ? (iters + expand - 1) / expand : 0;
    a.exp_cap = a.loops * expand;
    a.slots = expand * deg;
    a.k_res = k_res; a.metric = metric;
    // members: at most the buffer's ef ids and every expanded id, at most
    // half the set, with room for a step's inserts
    a.ins = a.slots < ef ? a.slots : ef;
    a.mbits = 1;
    while ((1ll << a.mbits) < 2ll * (ef + a.exp_cap) + a.ins) ++a.mbits;
    a.cbits = table_bits(a.slots);
    a.rpow = rerank > 0 ? pow2_ge(rerank) : 0;
    a.seed_i = seed_i; a.seed_d = seed_d; a.allowed = allowed; a.qn = qn;
    return a;
}

static bool wide_args_ok(const WideArgs& a) {
    return a.B >= 1 && a.S >= 1 && a.S <= a.ef && a.expand >= 1 && a.expand <= a.ef &&
           a.loops >= 1 && a.d >= 4 && a.d % 4 == 0 && a.deg >= 1 && a.k_res >= 0 &&
           (a.k_res == 0 || a.allowed != nullptr) && a.metric >= 0 && a.metric <= 2 &&
           a.mbits < 30;
}

// bytes of one block's global scratch (the wrapper allocates grid x this),
// 0 where a query's state fits a block's shared memory; rerank 0 for K8 /
// K8-SQ, K6's rerank width otherwise
extern "C" long long hnsw_beam_wide_bytes(int deg, int ef, int iters, int expand, int k_res,
                                          int rerank) {
    const WideArgs a = wide_args(1, 1, 4, deg, ef, iters, expand, k_res, 0, rerank, nullptr,
                                 nullptr, nullptr, nullptr);
    const size_t bytes = wide_beam_bytes(a);
    return bytes <= launch_util::smem_optin() ? 0 : (long long)bytes;
}

// K8-SQ wide's shared memory: the state where it fits beside the query row
// and at least min(slots, SQ_STAGE_MIN) staged rows (else the state lies in
// the global scratch), then the query row, then the stage of as many rows
// as fit, up to a step's slots.
struct SqStage {
    bool global_state;
    size_t qoff, roff, smem;
    int srows;
};

static SqStage sq_stage(const WideArgs& a, int row_bytes) {
    const size_t optin = launch_util::smem_optin();
    const size_t pitch = (size_t)stage_words(row_bytes) << 4;
    const size_t qb = wide_align16((size_t)4 * a.d);
    const size_t state = wide_beam_bytes(a);
    const int least = a.slots < SQ_STAGE_MIN ? a.slots : SQ_STAGE_MIN;
    SqStage st;
    st.global_state = state + qb + least * pitch > optin;
    st.qoff = st.global_state ? 0 : state;
    st.roff = st.qoff + qb;
    const long long fit = optin > st.roff ? (long long)((optin - st.roff) / pitch) : 0;
    st.srows = (int)(fit < a.slots ? fit : a.slots);
    st.smem = st.roff + (size_t)st.srows * pitch;
    return st;
}

// K8-SQ wide's bytes of one block's global scratch, 0 where its state lies
// in shared memory beside the query row and the stage (bits 8 or 16)
extern "C" long long hnsw_beam_sq_wide_bytes(int deg, int ef, int iters, int expand, int k_res,
                                             int d, int bits) {
    const WideArgs a = wide_args(1, 1, d, deg, ef, iters, expand, k_res, 0, 0, nullptr, nullptr,
                                 nullptr, nullptr);
    return sq_stage(a, d * (bits / 8)).global_state ? (long long)wide_beam_bytes(a) : 0;
}

// K6 wide's shared memory: the state where it fits beside the stage's fixed
// part (qs and qsum, the query row, the mbarriers, a step's meta blocks)
// and one node's code block (else the state lies in the global scratch),
// then the fixed part, then the code rows of a step's slots where they fit,
// else of as many whole nodes as fit, else (a node past what is left) as
// many rows as fit.
struct ServeStage {
    bool global_state;
    size_t soff, smem;
    int srows;
};

static ServeStage serve_stage(const WideArgs& a) {
    const size_t optin = launch_util::smem_optin();
    const size_t state = wide_beam_bytes(a);
    const size_t fixed = 32 + wide_align16(a.d) + (size_t)16 * a.slots;
    ServeStage st;
    st.global_state = state + fixed + (size_t)a.deg * a.d > optin;
    st.soff = st.global_state ? 0 : state;
    const size_t used = st.soff + fixed;
    const long long fit = optin > used ? (long long)((optin - used) / a.d) : 0;
    int rows = (int)(fit < a.slots ? fit : a.slots);
    if (rows < a.slots && rows >= a.deg) rows -= rows % a.deg;
    st.srows = rows;
    st.smem = used + (size_t)rows * a.d;
    return st;
}

static WideArgs serve_args(int deg, int ef, int iters, int expand, int rerank, int d) {
    return wide_args(1, 1, d, deg, ef, iters, expand, 0, 0, rerank, nullptr, nullptr, nullptr,
                     nullptr);
}

// K6 wide's bytes of one block's global scratch, 0 where its state lies in
// shared memory beside the stage (d a multiple of 4)
extern "C" long long hnsw_serve_beam_wide_bytes(int deg, int ef, int iters, int expand,
                                                int rerank, int d) {
    const WideArgs a = serve_args(deg, ef, iters, expand, rerank, d);
    return serve_stage(a).global_state ? (long long)wide_beam_bytes(a) : 0;
}

// K6 wide's code rows a batch of its stage (a step's slots, whole nodes, or
// rows of one node)
extern "C" long long hnsw_serve_beam_wide_rows(int deg, int ef, int iters, int expand,
                                               int rerank, int d) {
    return serve_stage(serve_args(deg, ef, iters, expand, rerank, d)).srows;
}

// How a wide beam launches: a block a query over its state in shared
// memory where it fits, else `grid` blocks over their slices of `scratch`,
// each walking its share of the queries.
struct WideLaunch {
    unsigned blocks;
    size_t smem, stride;
    unsigned char* scratch;
    int err;
};

template <class K>
static WideLaunch wide_launch(K kernel, const WideArgs& a, unsigned char* scratch, int grid) {
    WideLaunch l{0u, 0, 0, nullptr, 0};
    const size_t bytes = wide_beam_bytes(a);
    if (bytes <= launch_util::smem_optin()) {
        l.err = raise_smem(kernel, bytes);
        l.blocks = (unsigned)a.B;
        l.smem = bytes;
    } else if (scratch == nullptr || grid < 1) {
        l.err = (int)cudaErrorInvalidValue;
    } else {
        l.blocks = (unsigned)grid;
        l.stride = bytes;
        l.scratch = scratch;
    }
    return l;
}

template <class Sc>
static int launch_beam_wide(const WideArgs& a, const Sc& sc, unsigned char* scratch, int grid,
                            float* out_d, int* out_i, float* out_rd, int* out_ri, int* out_exp,
                            int* out_stats, void* stream) {
    if (!wide_args_ok(a) || (a.k_res && (out_rd == nullptr || out_ri == nullptr)))
        return (int)cudaErrorInvalidValue;
    const WideLaunch l = wide_launch(graph_beam_wide_kernel<Sc>, a, scratch, grid);
    if (l.err) return l.err;
    graph_beam_wide_kernel<Sc><<<l.blocks, WB_THREADS, l.smem, (cudaStream_t)stream>>>(
        a, sc, out_d, out_i, out_rd, out_ri, out_exp, out_stats, l.scratch, l.stride);
    return (int)cudaGetLastError();
}

extern "C" int hnsw_graph_beam_wide(const int* adj, const float* vectors, const float* norms,
                                    const float* q, const float* qn, const int* seed_i,
                                    const float* seed_d, int B, int S, const uint8_t* allowed,
                                    int d, int deg, int ef, int iters, int expand, int k_res,
                                    int metric, float* out_d, int* out_i, float* out_rd,
                                    int* out_ri, int* out_exp, int* out_stats,
                                    unsigned char* scratch, int grid, void* stream) {
    if ((size_t)vectors % 16 || (size_t)q % 16) return (int)cudaErrorInvalidValue;
    const WideArgs a = wide_args(B, S, d, deg, ef, iters, expand, k_res, metric, 0, seed_i,
                                 seed_d, allowed, qn);
    return launch_beam_wide(a, BeamF32{GraphScorer{adj, vectors, norms, q}}, scratch, grid,
                            out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
}

template <class CodeT>
static int launch_beam_sq_wide(const WideArgs& a, BeamSq<CodeT> sc, unsigned char* scratch,
                               int grid, float* out_d, int* out_i, float* out_rd, int* out_ri,
                               int* out_exp, int* out_stats, void* stream) {
    if (!wide_args_ok(a) || (a.k_res && (out_rd == nullptr || out_ri == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int row_bytes = SqScorer<CodeT>::row_bytes(a.d);
    const SqStage st = sq_stage(a, row_bytes);
    if (st.srows < 1 || (st.global_state && (scratch == nullptr || grid < 1)))
        return (int)cudaErrorInvalidValue;
    sc.sc.srows = st.srows;
    sc.sc.sw = stage_words(row_bytes);
    sc.qoff = (unsigned)st.qoff;
    sc.roff = (unsigned)st.roff;
    const int err = raise_smem(graph_beam_wide_kernel<BeamSq<CodeT>>, st.smem);
    if (err) return err;
    const size_t stride = st.global_state ? wide_beam_bytes(a) : 0;
    graph_beam_wide_kernel<BeamSq<CodeT>>
        <<<st.global_state ? (unsigned)grid : (unsigned)a.B, WB_THREADS, st.smem,
           (cudaStream_t)stream>>>(a, sc, out_d, out_i, out_rd, out_ri, out_exp, out_stats,
                                   st.global_state ? scratch : nullptr, stride);
    return (int)cudaGetLastError();
}

extern "C" int hnsw_graph_beam_sq_wide(const int* adj, const void* codes, int bits,
                                       const float* mins, const float* scales, const float* norms,
                                       const float* q, const float* qn, const int* seed_i,
                                       const float* seed_d, int B, int S, const uint8_t* allowed,
                                       int d, int deg, int ef, int iters, int expand, int k_res,
                                       int metric, float* out_d, int* out_i, float* out_rd,
                                       int* out_ri, int* out_exp, int* out_stats,
                                       unsigned char* scratch, int grid, void* stream) {
    const WideArgs a = wide_args(B, S, d, deg, ef, iters, expand, k_res, metric, 0, seed_i,
                                 seed_d, allowed, qn);
    if ((size_t)q % 16 || (size_t)codes % 4) return (int)cudaErrorInvalidValue;
    // 16-byte copies where the rows are whole aligned 16-byte words
    const int w16 = (size_t)codes % 16 == 0 && (size_t)d * (bits / 8) % 16 == 0;
    if (bits == 8)
        return launch_beam_sq_wide(
            a,
            BeamSq<uint8_t>{{adj, static_cast<const uint8_t*>(codes), mins, scales, norms, q, w16},
                            0u, 0u},
            scratch, grid, out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
    if (bits == 16)
        return launch_beam_sq_wide(
            a, BeamSq<uint16_t>{{adj, static_cast<const uint16_t*>(codes), mins, scales, norms, q,
                                 w16},
                                0u, 0u},
            scratch, grid, out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
    return (int)cudaErrorInvalidValue;
}

extern "C" int hnsw_serve_beam_wide(const int8_t* codes, const int* meta, const float* vectors,
                                    const float* norms, const float* q, const float* qn,
                                    const int8_t* qc, const float* qs, const float* qsum,
                                    const int* seed_i, const float* seed_d, int B, int S,
                                    const uint8_t* allowed, int d, int deg, int ef, int iters,
                                    int expand, int rerank, int k, int metric, float* out_d,
                                    int* out_i, int* out_stats, unsigned char* scratch, int grid,
                                    void* stream) {
    const WideArgs a = wide_args(B, S, d, deg, ef, iters, expand, 0, metric, rerank, seed_i,
                                 seed_d, nullptr, qn);
    if (!wide_args_ok(a) || rerank < 1 || rerank > ef || k < 1 || k > rerank ||
        (size_t)meta % 16 || (size_t)codes % 4 || (size_t)qc % 4 || (size_t)vectors % 16 ||
        (size_t)q % 16)
        return (int)cudaErrorInvalidValue;
    const ServeStage st = serve_stage(a);
    if (st.srows < 1 || (st.global_state && (scratch == nullptr || grid < 1)))
        return (int)cudaErrorInvalidValue;
    // whole nodes' rows by the bulk copy where they are 16-byte words
    const int bulk = (size_t)codes % 16 == 0 && d % 16 == 0;
    const BeamServe sc{codes, reinterpret_cast<const int4*>(meta), vectors, norms, q, qc, qs, qsum,
                       (unsigned)st.soff, st.srows, bulk};
    const int err = raise_smem(serve_beam_wide_kernel, st.smem);
    if (err) return err;
    serve_beam_wide_kernel<<<st.global_state ? (unsigned)grid : (unsigned)B, WB_THREADS, st.smem,
                             (cudaStream_t)stream>>>(
        a, sc, allowed, rerank, k, out_d, out_i, out_stats, st.global_state ? scratch : nullptr,
        st.global_state ? wide_beam_bytes(a) : 0);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9 wide: the greedy descent, a block a query, a warp a neighbour row
// ---------------------------------------------------------------------------

struct GreedyLevelsWide {   // kernels/build.py GreedyLevels
    const int* adj[WG_LEVELS_MAX];
    int n;
};

// K9 wide's rows: a lane loads a row's Word c (words(d) a row), and `dot`
// adds that word's products with the query (f32 in shared memory) to acc in
// column order, the SQ codes each dequantized as min + scale * code by one
// fmaf. f32 rows are float4 words; the SQ store 16-byte words (16 u8 or 8
// u16 codes) where its rows are whole aligned 16-byte words, else 4 codes a
// word.
struct GreedyF32 {
    using Word = float4;
    const float* vectors;
    const float* norms;
    __device__ static int words(int d) { return d >> 2; }
    __device__ Word word(int id, int d, int c) const {
        return __ldg(reinterpret_cast<const float4*>(vectors + (size_t)id * d) + c);
    }
    __device__ RowMeta meta(int id) const { return RowMeta{__ldg(norms + id), 0.0f, 0.0f}; }
    __device__ static float dot(float acc, Word x, const float4* q4, int c, const RowMeta&) {
        return dot4(acc, x, q4[c]);
    }
};

template <class CodeT, bool W16>
struct GreedySq {
    static constexpr int CODES = W16 ? 16 / (int)sizeof(CodeT) : 4;   // codes a word
    using Word = std::conditional_t<W16, uint4,
                                    std::conditional_t<sizeof(CodeT) == 1, unsigned, uint2>>;
    const CodeT* codes;
    const float* mins;
    const float* scales;
    const float* norms;
    __device__ static int words(int d) { return d / CODES; }
    __device__ Word word(int id, int d, int c) const {
        return __ldg(reinterpret_cast<const Word*>(codes + (size_t)id * d) + c);
    }
    __device__ RowMeta meta(int id) const {
        return RowMeta{__ldg(norms + id), __ldg(mins + id), __ldg(scales + id)};
    }
    __device__ static float dot(float acc, Word x, const float4* q4, int c, const RowMeta& rm) {
        if constexpr (W16 && sizeof(CodeT) == 1) {
            acc = deq_dot4(acc, u8x4(x.x), q4[4 * c], rm.m, rm.s);
            acc = deq_dot4(acc, u8x4(x.y), q4[4 * c + 1], rm.m, rm.s);
            acc = deq_dot4(acc, u8x4(x.z), q4[4 * c + 2], rm.m, rm.s);
            return deq_dot4(acc, u8x4(x.w), q4[4 * c + 3], rm.m, rm.s);
        } else if constexpr (W16) {
            acc = deq_dot4(acc, u16x4(x.x, x.y), q4[2 * c], rm.m, rm.s);
            return deq_dot4(acc, u16x4(x.z, x.w), q4[2 * c + 1], rm.m, rm.s);
        } else if constexpr (sizeof(CodeT) == 1) {
            return deq_dot4(acc, u8x4(x), q4[c], rm.m, rm.s);
        } else {
            return deq_dot4(acc, u16x4(x.x, x.y), q4[c], rm.m, rm.s);
        }
    }
};

// Query b walks the levels in a block of WG_THREADS: its f32 row in shared
// memory, then per step the deg neighbours of cur, warp w on slots w, w +
// WG_WARPS, ... WG_ROWS at a time, lane l on words l, l + 32, ... of each
// row (WG_WORDS of each row's loads issued before their sums), one fmaf
// chain a lane and row, the lanes' sums by reduce_rows (warp_dot's
// butterfly). The distances go to a double buffer in shared memory; after
// one barrier every warp takes the same argmin (the lower slot on ties) and
// the ids scored, and moves on or stops as the fast form does. Shared
// memory: the query row, then [2][deg] distances and [2][deg] ids.
template <class Rows>
__global__ void __launch_bounds__(WG_THREADS, 2)
greedy_wide_kernel(Rows rows, GreedyLevelsWide lv, const float* __restrict__ q,
                   const float* __restrict__ qn, const int* __restrict__ cur_i,
                   const float* __restrict__ cur_d, const int* __restrict__ lowest, int B, int d,
                   int deg, int metric, int* __restrict__ out_i, float* __restrict__ out_d,
                   int* __restrict__ out_stats) {
    using Word = typename Rows::Word;
    constexpr int SH = 5 - Log2<WG_ROWS>::value;   // a row's sum lands on lanes e << SH
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t b = blockIdx.x;
    float4* sq = reinterpret_cast<float4*>(wide_state);
    float* cv = reinterpret_cast<float*>(wide_state + wide_align16((size_t)4 * d));
    int* cid = reinterpret_cast<int*>(cv + 2 * deg);
    const float4* qb = reinterpret_cast<const float4*>(q + b * d);
    for (int i = threadIdx.x; i < (d >> 2); i += WG_THREADS) sq[i] = qb[i];
    int cur = cur_i[b];
    float cd = cur_d[b];
    const float qnb = qn[b];
    const int walk = lv.n - (lowest ? min(max(lowest[b], 0), lv.n) : 0);
    const int nw = Rows::words(d);
    int steps = 0, scored = 0, par = 0;
    __syncthreads();
    for (int l = 0; l < walk; ++l) {
        const int* adj = lv.adj[l];
        for (int s = 0; s < WG_CAP; ++s) {
            const int* list = adj + (size_t)(cur < 0 ? 0 : cur) * deg;
            float* pv = cv + par * deg;
            int* pid = cid + par * deg;
            for (int g0 = warp; g0 < deg; g0 += WG_WARPS * WG_ROWS) {
                int id[WG_ROWS];
                RowMeta rm[WG_ROWS];
                float acc[WG_ROWS];
#pragma unroll
                for (int e = 0; e < WG_ROWS; ++e) {
                    const int g = g0 + e * WG_WARPS;
                    id[e] = g < deg ? __ldg(list + g) : -1;
                    rm[e] = id[e] >= 0 ? rows.meta(id[e]) : RowMeta{0.0f, 0.0f, 0.0f};
                    acc[e] = 0.0f;
                }
                for (int c0 = lane; c0 < nw; c0 += 32 * WG_WORDS) {
                    Word x[WG_ROWS][WG_WORDS];
#pragma unroll
                    for (int u = 0; u < WG_WORDS; ++u)
#pragma unroll
                        for (int e = 0; e < WG_ROWS; ++e)
                            if (c0 + 32 * u < nw && id[e] >= 0)
                                x[e][u] = rows.word(id[e], d, c0 + 32 * u);
#pragma unroll
                    for (int u = 0; u < WG_WORDS; ++u)
#pragma unroll
                        for (int e = 0; e < WG_ROWS; ++e)
                            if (c0 + 32 * u < nw && id[e] >= 0)
                                acc[e] = Rows::dot(acc[e], x[e][u], sq, c0 + 32 * u, rm[e]);
                }
                const float v = reduce_rows<WG_ROWS, 32>(acc, lane);
                const int e = lane >> SH, g = g0 + e * WG_WARPS;
                if ((lane & ((1 << SH) - 1)) == 0 && g < deg) {
                    // the lane's row: pick, so that id[] and rm[] stay in registers
                    int ide = id[0];
                    float xn = rm[0].xn;
#pragma unroll
                    for (int i = 1; i < WG_ROWS; ++i) {
                        ide = pick(e == i, id[i], ide);
                        xn = pick(e == i, rm[i].xn, xn);
                    }
                    pv[g] = ide >= 0 ? gathered_epilogue(v, qnb, xn, metric) : WIDE_INF;
                    pid[g] = ide;
                }
            }
            __syncthreads();
            // every warp: the nearest, the lower slot on ties, and the ids scored
            float bv = WIDE_INF;
            int bg = 0x7fffffff, n = 0;
            for (int g = lane; g < deg; g += 32) {
                const int id = pid[g];
                n += id >= 0;
                const float v = pv[g];
                if (id >= 0 && v < bv) { bv = v; bg = g; }
            }
            for (int o = 16; o > 0; o >>= 1) {
                const float ov = __shfl_xor_sync(WIDE_FULL, bv, o);
                const int og = __shfl_xor_sync(WIDE_FULL, bg, o);
                n += __shfl_xor_sync(WIDE_FULL, n, o);
                if (ov < bv || (ov == bv && og < bg)) { bv = ov; bg = og; }
            }
            par ^= 1;
            ++steps;
            scored += n;
            if (!(bv < cd)) break;
            cur = pid[bg];
            cd = bv;
        }
    }
    if (threadIdx.x == 0) {
        out_i[b] = cur;
        out_d[b] = cd;
        reinterpret_cast<int2*>(out_stats)[b] = make_int2(steps, scored);
    }
}

template <class Rows>
static int launch_greedy_wide(const Rows& rows, const GreedyLevelsWide& lv, const float* q,
                              const float* qn, const int* cur_i, const float* cur_d,
                              const int* lowest, int B, int d, int deg, int metric, int* out_i,
                              float* out_d, int* out_stats, void* stream) {
    const size_t smem = wide_align16((size_t)4 * d) + (size_t)16 * deg;
    const int err = raise_smem(greedy_wide_kernel<Rows>, smem);
    if (err) return err;
    greedy_wide_kernel<Rows><<<(unsigned)B, WG_THREADS, smem, (cudaStream_t)stream>>>(
        rows, lv, q, qn, cur_i, cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats);
    return (int)cudaGetLastError();
}

template <class CodeT>
static int launch_greedy_sq(const void* codes, const float* mins, const float* scales,
                            const float* norms, const GreedyLevelsWide& lv, const float* q,
                            const float* qn, const int* cur_i, const float* cur_d,
                            const int* lowest, int B, int d, int deg, int metric, int* out_i,
                            float* out_d, int* out_stats, void* stream) {
    const CodeT* c = static_cast<const CodeT*>(codes);
    if ((size_t)codes % 16 == 0 && (size_t)d * sizeof(CodeT) % 16 == 0)
        return launch_greedy_wide(GreedySq<CodeT, true>{c, mins, scales, norms}, lv, q, qn, cur_i,
                                  cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats,
                                  stream);
    return launch_greedy_wide(GreedySq<CodeT, false>{c, mins, scales, norms}, lv, q, qn, cur_i,
                              cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats, stream);
}

// the arguments of hnsw_greedy (hnsw_greedy.cu), at any d (a multiple of 4;
// q and f32 rows 16-byte aligned, codes aligned to 4 codes)
extern "C" int hnsw_greedy_wide(GreedyLevelsWide levels, const float* vectors, const void* codes,
                                int bits, const float* mins, const float* scales,
                                const float* norms, const float* q, const float* qn,
                                const int* cur_i, const float* cur_d, const int* lowest, int B,
                                int d, int deg, int metric, int* out_i, float* out_d,
                                int* out_stats, void* stream) {
    if (B < 1 || d < 4 || d % 4 || deg < 1 || metric < 0 || metric > 2 || levels.n < 1 ||
        levels.n > WG_LEVELS_MAX || (size_t)q % 16)
        return (int)cudaErrorInvalidValue;
    if (bits == 0) {
        if ((size_t)vectors % 16) return (int)cudaErrorInvalidValue;
        return launch_greedy_wide(GreedyF32{vectors, norms}, levels, q, qn, cur_i, cur_d, lowest,
                                  B, d, deg, metric, out_i, out_d, out_stats, stream);
    }
    if (bits == 8)
        return launch_greedy_sq<uint8_t>(codes, mins, scales, norms, levels, q, qn, cur_i, cur_d,
                                         lowest, B, d, deg, metric, out_i, out_d, out_stats,
                                         stream);
    if (bits == 16)
        return launch_greedy_sq<uint16_t>(codes, mins, scales, norms, levels, q, qn, cur_i, cur_d,
                                          lowest, B, d, deg, metric, out_i, out_d, out_stats,
                                          stream);
    return (int)cudaErrorInvalidValue;
}
