// K6 hnsw_serve_beam, K8 hnsw_graph_beam and K8-SQ hnsw_graph_beam_sq: the
// HNSW beam over one level.
//
// Replaces: turdb_tpu/models/hnsw_serve.py serve_search_impl (stage 1b, the
// int8 beam over the packed neighbour blocks, and stage 2, the exact
// rerank) and turdb_tpu/models/hnsw.py _beam_level (the graph beam over
// one adjacency level, with its multi-seed, `active`, filtered-result and
// expanded-id outputs; the refinement, the wave inserts and
// hnsw_search_impl run it), over the f32 rows or, inside the search, over
// the SQ8 / SQ16 graph store (Sq8Rows.__getitem__, hnsw.py:130). All are
// the same loop: expand the `expand` nearest unexpanded candidates of
// an ef-wide sorted buffer, score their neighbours that are neither in the
// buffer nor expanded before (the first copy of a neighbour wins), merge
// them into the buffer by (distance, position), and stop when nothing is
// left to expand or ceil(iters/expand) steps are spent. The neighbour
// scorer is the template parameter: K8 and K8-SQ read adj[sel] and the
// rows (graph_scorer.cuh: f32, or u8 / u16 codes dequantized on the
// gather; gathered_distances' epilogue); K6 (ServeScorer) reads one
// [deg, d] int8 code block and one [deg, 4] int32 meta block (f32 base,
// scale, norm as bits, the neighbour id) per expanded node, takes the
// exact int32 dot with __dp4a and rounds _approx_dist's epilogue in the
// plain expression's order (__fmul_rn / __fadd_rn, no FMA contraction).
//
// What bounds it on an H100: memory latency, not bandwidth or arithmetic.
// A step reads expand*deg scattered rows (K8, 4d bytes each; K8-SQ, d or
// 2d bytes of codes and 8 of min and scale) or expand
// contiguous blocks (K6, deg*(d+16) bytes each) that depend on the step
// before, and a query takes tens of steps in sequence. What a step costs
// beyond that latency is its serial shared-memory work and its barriers;
// so a step makes as few dependent trips to device memory as it can: K6
// two (its meta blocks, then its kept code rows), each one coalesced copy.
//
// Design: one 128-thread block per query, a persistent loop, and every
// buffer in shared memory. Each query stops on its own: a finished query
// of the reference is frozen too, so the result is the same. The seeds are
// sorted by (distance, position) on entry, which keeps the reference's tie
// order; from then on the buffer stays sorted, so the nearest unexpanded
// candidates are its first unflagged entries (a warp ballot scan), and the
// reference's bound reduces to "nothing left to expand". A step is four
// phases and four barriers (K8-SQ five):
//  1. warp 0 selects the nodes to expand and reads their neighbour lists
//     (K6: one `cp.async.bulk` of each node's deg x 16-byte meta block into
//     shared memory, completing on an mbarrier that phase 2 waits for, its
//     phase bit flipping once a step) while the other warps insert the
//     buffer's ids and every id expanded before into a hash table
//     (graph_util.cuh, cleared in phase 4);
//  2. each neighbour slot claims its id in the table (atomicMin of its slot
//     index): a member is dropped, and of several slots with one id the
//     lowest wins. That is the reference's member_mask of the buffer and of
//     the expanded ids, then mask_duplicates, in O(1) a slot. A node that
//     left the buffer unexpanded is scored again, as in the reference;
//  3. each warp compacts its kept slots (ballot), scores them (K8 by lane
//     groups, graph_scorer.cuh group_scores: 8 lanes a row, 16 rows a warp
//     in flight; K8-SQ by staged_score and K6 by staged_block_score: after
//     a barrier, the warp stages `srows` rows at a time in its region of
//     shared memory, which overlays the step's table, by coalesced
//     cp.async, and scores them one lane a row, K6 from the staged meta
//     blocks), keeps
//     those below the buffer's worst (a new entry at or above it cannot
//     enter: a tie goes to the old entry) and, with `allowed`, the allowed
//     ones below the result buffer's worst, and sorts them in runs of 32 (a
//     bitonic network of shuffles);
//  4. the merge: each old entry moves by the new entries below it, each new
//     one to its rank among the new plus the old entries at or below it
//     (binary searches of the runs and of the buffer), into the other half
//     of a double buffer. The filtered result buffer merges the same way.
// K6 ends with its rerank: the r best of the buffer, their f32 rows staged
// in chunks of up to 32 by every thread's cp.async at once (over the dead
// table), an fp32 dot by one thread a row in the row's own fmaf order, the
// metric's exact distance (unclamped L2), +inf outside `allowed`, and the
// k smallest by (distance, position): runs of 32 keys sorted by warps,
// ranked by their place plus binary searches of the other runs. Each query
// reports how many nodes it expanded and how many neighbours it scored.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "async_copy.cuh"
#include "graph_scorer.cuh"
#include "graph_util.cuh"
#include "launch_util.cuh"

#define BEAM_THREADS 128
#define BEAM_WARPS (BEAM_THREADS / 32)
// blocks an SM must hold by K8-SQ's and K6's registers (64 a thread): B =
// 1024 queries on 132 SMs run in one wave only at eight
#define WAVE_BLOCKS 8
static_assert(BEAM_WARPS == 4, "merge_into splits the new entries among 4 warps");
#define SLOTS_MAX 1024                                   // kernels.SLOTS_MAX
#define SLOT_REG ((SLOTS_MAX + BEAM_THREADS - 1) / BEAM_THREADS)
#define GROUP_ROWS 4                                     // rows a lane group scores at once
#define F_INF __int_as_float(0x7f800000)

// Built with -DBEAM_PHASE_CLOCKS (scripts/exp_torch_beam_phases.py), thread
// 0 of every block adds the cycles of each phase of run_beam to
// beam_clocks: 0 the seeds, 1 the selection and the members, 2 the claims
// (with the lists' reads), 3 the scoring and the runs, 4 the merge; 5
// counts the steps; 6 K6's rerank and its ranks, 7 counts the blocks that
// ran them. hnsw_beam_clocks reads and clears them.
#ifdef BEAM_PHASE_CLOCKS
__device__ unsigned long long beam_clocks[8];
#define BEAM_MARK(i)                                                                  \
    do {                                                                              \
        if (threadIdx.x == 0) {                                                       \
            const long long now = clock64();                                          \
            atomicAdd(beam_clocks + (i), (unsigned long long)(now - mark));           \
            if ((i) == 4) atomicAdd(beam_clocks + 5, 1ull);                           \
            if ((i) == 6) atomicAdd(beam_clocks + 7, 1ull);                           \
            mark = now;                                                               \
        }                                                                             \
    } while (0)

extern "C" int hnsw_beam_clocks(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, beam_clocks, sizeof(beam_clocks));
    if (e == cudaSuccess) {
        const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        e = cudaMemcpyToSymbol(beam_clocks, zero, sizeof(zero));
    }
    return (int)e;
}
#else
#define BEAM_MARK(i) \
    do {             \
    } while (0)
#endif

struct BeamArgs {
    int B, S, d, deg, ef, loops, expand, exp_cap, slots, k_res, metric;
    int hbits;                 // the hash table holds 1 << hbits entries
    int wcap;                  // a warp's share of the per-warp lists
    const int* seed_i;         // [B, S]
    const float* seed_d;       // [B, S]
    const uint8_t* allowed;    // [cap] or null
    const float* qn;           // [B]
};

// Shared-memory buffers of one query.
struct Smem {
    float* cd[2]; int* ci[2]; int* cx[2];   // candidate buffer [ef] x 2: distance, id, expanded
    float* rd[2]; int* ri[2];               // filtered results [k_res] x 2
    unsigned* hid; unsigned* htag; // [1 << hbits] the step's table: ids, tags
    u64* kc;                       // [BEAM_WARPS * wcap] a warp's runs of survivors (buffer)
    u64* kr;                       // [BEAM_WARPS * wcap] ... of allowed survivors (results)
    int* wt; int* wi;              // [BEAM_WARPS * wcap] a warp's kept slots: slot, id
    int* nid; float* nd;           // [slots] the scored neighbour of each slot: id, distance
    int* selp;                     // [expand] buffer positions selected this step
    int* sel;                      // [expand] ids expanded this step (-1: none)
    int* exp;                      // [exp_cap] expanded ids
    int* misc;                     // [16]: 0 selected; 1-4 / 5-8 a warp's survivors
                                   // (buffer / results); 9-12 a warp's kept slots
    unsigned char* q;              // the scorer's query bytes
};

// the scorers whose rows phase 3 stages (graph_scorer.cuh staged_score)
template <class S> struct stages_rows : std::false_type {};
template <class C> struct stages_rows<SqScorer<C>> : std::true_type {};
struct ServeScorer;
// K6: phase 1 copies the meta blocks, phase 3 stages the kept code rows
template <class S> struct stages_blocks : std::is_same<S, ServeScorer> {};

// one half of a double buffer (a select, so that Smem stays in registers)
template <class T>
__device__ __forceinline__ T* half(T* const (&p)[2], int h) {
    return h ? p[1] : p[0];
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// K8-SQ's stage: [BEAM_WARPS][srows * sw] 16-byte words; K6's, the bytes
// pick_serve_stage sets (0 for the other scorers)
template <class Scorer>
__host__ __device__ inline size_t stage_bytes(const Scorer& sc) {
    if constexpr (stages_rows<Scorer>::value) return (size_t)BEAM_WARPS * sc.srows * sc.sw * 16;
    if constexpr (stages_blocks<Scorer>::value) return (size_t)sc.stage;
    return 0;
}

// Bytes of Smem for these widths; `carve` lays it out in the same order.
// K8-SQ's and K6's stages share the step table's bytes: phase 3 stages rows
// only after a barrier behind the table's last read (the claims' tags), and
// phase 4 clears the whole table for the next step. K6's rerank stages its
// rows there too, after the beam, with the survivor runs that follow.
__host__ __device__ inline size_t table_bytes(const BeamArgs& a, size_t stage) {
    const size_t table = (size_t)8 << a.hbits;
    return table > stage ? table : stage;
}

__host__ __device__ inline size_t smem_bytes(const BeamArgs& a, size_t qbytes, size_t stage) {
    return align16(qbytes) + table_bytes(a, stage) + (size_t)8 * (2 * BEAM_WARPS * a.wcap) +
           (size_t)4 * (6 * a.ef + 4 * a.k_res + 2 * BEAM_WARPS * a.wcap + 2 * a.slots +
                        2 * a.expand + a.exp_cap + 16);
}

template <bool Staged>
__device__ inline Smem carve(unsigned char* p, const BeamArgs& a, size_t qbytes, size_t stage) {
    Smem s;
    s.q = p;
    u64* w = reinterpret_cast<u64*>(p + align16(qbytes));
    s.hid = reinterpret_cast<unsigned*>(w);
    s.htag = s.hid + (1 << a.hbits);
    if constexpr (Staged) w = reinterpret_cast<u64*>(p + align16(qbytes) + table_bytes(a, stage));
    else w += 1 << a.hbits;
    s.kc = w; w += BEAM_WARPS * a.wcap;
    s.kr = w; w += BEAM_WARPS * a.wcap;
    float* f = reinterpret_cast<float*>(w);
    for (int h = 0; h < 2; ++h) {
        s.cd[h] = f; f += a.ef;
        s.ci[h] = reinterpret_cast<int*>(f); f += a.ef;
        s.cx[h] = reinterpret_cast<int*>(f); f += a.ef;
        s.rd[h] = f; f += a.k_res;
        s.ri[h] = reinterpret_cast<int*>(f); f += a.k_res;
    }
    s.wt = reinterpret_cast<int*>(f); f += BEAM_WARPS * a.wcap;
    s.wi = reinterpret_cast<int*>(f); f += BEAM_WARPS * a.wcap;
    s.nid = reinterpret_cast<int*>(f); f += a.slots;
    s.nd = f; f += a.slots;
    s.selp = reinterpret_cast<int*>(f); f += a.expand;
    s.sel = reinterpret_cast<int*>(f); f += a.expand;
    s.exp = reinterpret_cast<int*>(f); f += a.exp_cap;
    s.misc = reinterpret_cast<int*>(f);
    return s;
}

// K6's neighbour scorer: packed int8 code and meta blocks; the query row
// is kept in f32 (for the rerank) and as int8 words. The host fills the
// stage's shape (pick_serve_stage); `meta_off` is the offset of the step's
// meta blocks in shared memory ([expand][deg] int4, then their mbarrier).
struct ServeScorer {
    const int8_t* codes;       // [cap, deg, d]
    const int4* meta;          // [cap, deg] of (base, scale, norm bits, id)
    const float* vectors;      // [cap, d] the rerank store
    const float* norms;        // [cap]
    const float* q;            // [B, d]
    const int8_t* qc;          // [B, d]
    const float* qs;           // [B]
    const float* qsum;         // [B]
    int wide16;                // code rows staged by 16-byte copies (else 4-byte)
    int srows, sw;             // code rows a warp stages at once, 16-byte words a staged row
    int rc, rw;                // rerank rows a chunk, 16-byte words a staged f32 row
    int stage;                 // bytes the table's region must hold for the stages
    unsigned meta_off;         // the meta blocks' offset in shared memory
    __host__ __device__ static size_t query_bytes(int d) { return (size_t)d * 4 + d + 8; }
    __device__ void load(size_t b, int d, unsigned char* s) const {
        float* sq = reinterpret_cast<float*>(s);
        for (int i = threadIdx.x; i < d; i += blockDim.x) sq[i] = q[b * d + i];
        int* sw = reinterpret_cast<int*>(s + (size_t)d * 4);
        const int* qw = reinterpret_cast<const int*>(qc + b * d);
        for (int i = threadIdx.x; i < (d >> 2); i += blockDim.x) sw[i] = qw[i];
        float* sf = reinterpret_cast<float*>(s + (size_t)d * 5);
        if (threadIdx.x == 0) { sf[0] = qs[b]; sf[1] = qsum[b]; }
    }
    __device__ int4* smeta(unsigned char* base) const {
        return reinterpret_cast<int4*>(base + meta_off);
    }
    __device__ uint64_t* bar(unsigned char* base, int slots) const {
        return reinterpret_cast<uint64_t*>(base + meta_off + (size_t)slots * 16);
    }
    // Phase 1, warp 0 (all lanes, `found` warp-uniform): one bulk copy of
    // each selected node's meta block, deg * 16 contiguous bytes, into row
    // e of the staged blocks, completing on the mbarrier; lane 0 arrives
    // first with the bytes to expect (none when nothing was selected: the
    // phase then completes at once)
    __device__ void fetch_meta(unsigned char* base, const int* sel, int found, int deg,
                               int slots, int lane) const {
        uint64_t* b = bar(base, slots);
        const unsigned bytes = (unsigned)deg * 16;
        if (lane == 0) mbar_arrive_tx(b, (unsigned)found * bytes);
        __syncwarp();
        int4* sm = smeta(base);
        for (int e = lane; e < found; e += 32)
            bulk_copy(sm + (size_t)e * deg, meta + (size_t)sel[e] * deg, bytes, b);
    }
    // the staged rows' interface of graph_scorer.cuh stage_rows: a code row
    // by its index node * deg + g
    __host__ __device__ static int row_bytes(int d) { return d; }
    __device__ bool wide() const { return wide16 != 0; }
    __device__ const unsigned char* row(long long blk, int d) const {
        return reinterpret_cast<const unsigned char*>(codes + blk * d);
    }
    // Phase 3: the distance of lane r's kept slot t (-1: none; +inf) among
    // a batch of n of a warp's slots. The batch's code rows are copied into
    // `stage` (row r at r * sw words) by stage_rows (16-byte or 4-byte
    // cp.async, neighbouring lanes on neighbouring words); then lane r
    // takes row r's exact int32 dot by __dp4a (any order gives the same
    // sum) and _approx_dist's epilogue from its staged meta entry, rounded
    // as the plain expression rounds it. All 32 lanes call.
    __device__ float staged_block_score(unsigned char* base, unsigned char* stage, int t, int n,
                                        const int* sel, int d, int deg, float qnb, int metric,
                                        int lane) const {
        __syncwarp();  // the last batch's reads of the region are done
        stage_rows(*this, stage, sw, t >= 0 ? (long long)sel[t / deg] * deg + t % deg : -1ll,
                   n, d, lane);
        const int4 m = t >= 0 ? smeta(base)[t] : make_int4(0, 0, 0, 0);
        stage_wait();
        __syncwarp();
        if (t < 0) return F_INF;
        const unsigned char* srow = stage + ((size_t)lane * sw << 4);
        const int* qw = reinterpret_cast<const int*>(base + (size_t)d * 4);
        int dot = 0;
        int j = 0;
        if (wide16) {
            const int4* x4 = reinterpret_cast<const int4*>(srow);
            const int4* y4 = reinterpret_cast<const int4*>(qw);
            for (; j < (d >> 4); ++j) {
                const int4 x = x4[j], y = y4[j];
                dot = __dp4a(x.x, y.x, dot);
                dot = __dp4a(x.y, y.y, dot);
                dot = __dp4a(x.z, y.z, dot);
                dot = __dp4a(x.w, y.w, dot);
            }
            j <<= 2;
        }
        const int* x1 = reinterpret_cast<const int*>(srow);
        for (; j < (d >> 2); ++j) dot = __dp4a(x1[j], qw[j], dot);
        const float* sf = reinterpret_cast<const float*>(base + (size_t)d * 5);
        // base*q_sum + scale*(qs*dot), as _approx_dist rounds it
        const float qdx = __fadd_rn(__fmul_rn(__int_as_float(m.x), sf[1]),
                                    __fmul_rn(__int_as_float(m.y),
                                              __fmul_rn(sf[0], __int2float_rn(dot))));
        if (metric == 0) return __fadd_rn(__fsub_rn(qnb, __fmul_rn(2.0f, qdx)), __int_as_float(m.z));
        if (metric == 1) return __fsub_rn(1.0f, qdx);
        return -qdx;
    }
    // the rerank's exact distance of a staged f32 row (no clamp): one fmaf
    // chain over j = 0 .. d-1, the order of the per-row sum before the rows
    // were staged
    __device__ float staged_exact(const unsigned char* s, const unsigned char* srow, int d,
                                  float qnb, float xn, int metric) const {
        const float4* q4 = reinterpret_cast<const float4*>(s);
        const float4* x4 = reinterpret_cast<const float4*>(srow);
        float acc = 0.0f;
#pragma unroll 8
        for (int j = 0; j < (d >> 2); ++j) acc = dot4(acc, x4[j], q4[j]);
        if (metric == 0) return __fsub_rn(__fadd_rn(qnb, xn), __fmul_rn(2.0f, acc));
        if (metric == 1) return __fsub_rn(1.0f, acc);
        return -acc;
    }
};

// Sort n (distance, id) pairs from global memory by (distance, position)
// into od/oi[0, n). Ranks are distinct, so every slot is written once.
__device__ void sorted_seeds(const float* d, const int* id, int n, float* od, int* oi) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const float v = d[j];
        int r = 0;
        for (int i = 0; i < n; ++i) r += d[i] < v || (d[i] == v && i < j);
        od[r] = v;
        oi[r] = id[j];
    }
}

// Merge the new entries, runs of 32 keys (distance, slot) sorted by warps
// (warp w's keys[w * wcap, + counts[w])), into the sorted buffer (od, oi,
// ox)[n], keeping its n smallest by (distance, position) with every old
// entry before every new one: the reference's top-k over [old || new].
// Writes the result to (td, ti, tx); ox / tx may be null, new entries get
// 0. The caller has dropped new entries at or above od[n - 1].
__device__ void merge_into(const float* od, const int* oi, const int* ox, int n, const u64* keys,
                           const int* counts, int wcap, const int* nid, const float* nd,
                           float* td, int* ti, int* tx) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        // below every new key of the same distance
        const u64 x = (u64)f2key(od[i]) << 32;
        int r = i;
        for (int w = 0; w < BEAM_WARPS && r < n; ++w)
            r += count_below_runs(keys + w * wcap, counts[w], x);
        if (r < n) {
            td[r] = od[i];
            ti[r] = oi[i];
            if (tx) tx[r] = ox[i];
        }
    }
    // the new entries, warp w's after warp w - 1's
    const int o1 = counts[0], o2 = o1 + counts[1], o3 = o2 + counts[2], total = o3 + counts[3];
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int w = (e >= o1) + (e >= o2) + (e >= o3);
        const int j = e - (w == 0 ? 0 : w == 1 ? o1 : w == 2 ? o2 : o3);
        const u64 key = keys[w * wcap + j];
        int r = j & 31;  // its place in its own run
        for (int w2 = 0; w2 < BEAM_WARPS && r < n; ++w2) {
            const u64* k2 = keys + w2 * wcap;
            for (int base = 0; base < counts[w2]; base += 32)
                if (w2 != w || base != (j & ~31))
                    r += count_below(k2 + base, min(32, counts[w2] - base), key);
        }
        if (r >= n) continue;
        const int t = (int)(key & 0xffffffffu);
        const float v = nd[t];
        int lo = 0, hi = n;  // old entries <= v
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (od[mid] <= v) lo = mid + 1; else hi = mid;
        }
        r += lo;
        if (r < n) {
            td[r] = v;
            ti[r] = nid[t];
            if (tx) tx[r] = 0;
        }
    }
}

// The beam of query b: seeds, then the loop. Leaves the sorted buffer in
// s.cd[0] / s.ci[0] and the filtered results in s.rd[0] / s.ri[0]; returns
// the numbers of expanded nodes and scored neighbours (valid in thread 0).
template <class Scorer>
__device__ int2 run_beam(const BeamArgs& a, const Scorer& sc, const Smem& s, size_t b) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef BEAM_PHASE_CLOCKS
    long long mark = clock64();
#endif
    table_clear(s.hid, s.htag, a.hbits);
    for (int j = tid; j < a.ef; j += BEAM_THREADS) {
        s.cd[0][j] = F_INF; s.ci[0][j] = -1; s.cx[0][j] = 0;
    }
    for (int j = tid; j < a.k_res; j += BEAM_THREADS) { s.rd[0][j] = F_INF; s.ri[0][j] = -1; }
    for (int j = tid; j < a.exp_cap; j += BEAM_THREADS) s.exp[j] = -1;
    __syncthreads();
    const int* si = a.seed_i + b * a.S;
    const float* sd = a.seed_d + b * a.S;
    sorted_seeds(sd, si, a.S, s.cd[0], s.ci[0]);
    if (a.k_res) {
        // the result buffer starts from the first min(S, k_res) seeds that
        // are allowed, sorted as the buffer is
        const int sk = a.S < a.k_res ? a.S : a.k_res;
        float* td = s.rd[1];
        int* ti = s.ri[1];
        for (int j = tid; j < sk; j += BEAM_THREADS) {
            const bool ok = si[j] >= 0 && a.allowed[si[j]];
            td[j] = ok ? sd[j] : F_INF;
            ti[j] = ok ? si[j] : -1;
        }
        __syncthreads();
        sorted_seeds(td, ti, sk, s.rd[0], s.ri[0]);
    }
    bool any_seed = false;
    for (int j = tid; j < a.S; j += BEAM_THREADS) any_seed |= si[j] >= 0;
    if (!__syncthreads_or(any_seed)) return make_int2(0, 0);
    BEAM_MARK(0);

    const float qnb = a.qn[b];
    const int grp = lane / GROUP, sub = lane % GROUP;
    int n_exp = 0, n_kept = 0, cur = 0;
    for (int it = 0; it < a.loops; ++it) {
        const float* cd = half(s.cd, cur);
        const int* ci = half(s.ci, cur);
        int* cx = half(s.cx, cur);
        // 1. warp 0: the `expand` nearest unexpanded candidates (the buffer
        // is sorted, so they are its first unflagged finite entries) and
        // their neighbour lists; the other warps: the buffer's ids and the
        // ids expanded before into the table (this step's are in the buffer)
        if (warp == 0) {
            int found = 0;
            for (int base = 0; base < a.ef && found < a.expand; base += 32) {
                const int j = base + lane;
                const bool c = j < a.ef && ci[j] >= 0 && !cx[j] && cd[j] < F_INF;
                unsigned m = __ballot_sync(0xffffffffu, c);
                while (m && found < a.expand) {
                    const int l = __ffs(m) - 1;
                    m &= m - 1;
                    if (lane == 0) s.selp[found] = base + l;
                    ++found;
                }
            }
            __syncwarp();
            for (int e = lane; e < a.expand; e += 32) {
                int id = -1;
                if (e < found) {
                    const int p = s.selp[e];
                    id = ci[p];
                    cx[p] = 1;
                }
                s.sel[e] = id;
                s.exp[it * a.expand + e] = id;
            }
            if (lane == 0) s.misc[0] = found;
            n_exp += found;
            __syncwarp();
            if constexpr (stages_blocks<Scorer>::value) {
                // K6: the selected nodes' meta blocks, in flight while the
                // other warps fill the table
                sc.fetch_meta(s.q, s.sel, found, a.deg, a.slots, lane);
            } else {
                // the lists' reads all issued before their stores
                for (int t0 = 0; t0 < a.slots; t0 += 4 * 32) {
                    int nb[4];
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int t = t0 + k * 32 + lane;
                        const int node = t < a.slots ? s.sel[t / a.deg] : -1;
                        nb[k] = node >= 0 ? sc.neighbour(node, t % a.deg, a.deg) : -1;
                    }
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        if (t0 + k * 32 + lane < a.slots) s.nid[t0 + k * 32 + lane] = nb[k];
                }
            }
        } else {
            const int n_mem = a.ef + it * a.expand;
            for (int j = tid - 32; j < n_mem; j += BEAM_THREADS - 32) {
                const int id = j < a.ef ? ci[j] : s.exp[j - a.ef];
                if (id >= 0) table_member(s.hid, s.htag, a.hbits, id);
            }
        }
        __syncthreads();
        BEAM_MARK(1);
        // the reference's bound (a query is done when its best unexpanded
        // candidate is worse than its worst buffered one, and expands only
        // candidates no worse than that) never binds on a sorted buffer
        // that holds them: a query is done when nothing is left to expand
        if (s.misc[0] == 0) break;
        // 2. each slot claims its neighbour: not in the buffer, not expanded
        // before, and the lowest slot of its id
        int pid[SLOT_REG], ppos[SLOT_REG];
        if constexpr (stages_blocks<Scorer>::value) {
            // K6: the ids from the staged meta blocks, once they are in
            // (the barrier's phase `it` of the copies this step issued)
            mbar_wait(sc.bar(s.q, a.slots), it & 1);
            const int4* sm = sc.smeta(s.q);
            const int n_sl = s.misc[0] * a.deg;
#pragma unroll
            for (int k = 0; k < SLOT_REG; ++k) {
                const int t = tid + k * BEAM_THREADS;
                pid[k] = t < n_sl ? sm[t].w : -1;
                ppos[k] = pid[k] >= 0 ? table_claim(s.hid, s.htag, a.hbits, pid[k], t) : -1;
            }
        } else {
#pragma unroll
            for (int k = 0; k < SLOT_REG; ++k) {
                const int t = tid + k * BEAM_THREADS;
                pid[k] = t < a.slots ? s.nid[t] : -1;
                ppos[k] = pid[k] >= 0 ? table_claim(s.hid, s.htag, a.hbits, pid[k], t) : -1;
            }
        }
        __syncthreads();
        BEAM_MARK(2);
        // 3. a warp's kept slots (its lanes' slots of phase 2), compacted in
        // slot order, scored by lane groups
        const float worst_c = cd[a.ef - 1];
        const float worst_r = a.k_res ? half(s.rd, cur)[a.k_res - 1] : 0.0f;
        int* wt = s.wt + warp * a.wcap;
        int* wi = s.wi + warp * a.wcap;
        u64* kc = s.kc + warp * a.wcap;
        u64* kr = s.kr + warp * a.wcap;
        int nw = 0;
#pragma unroll
        for (int k = 0; k < SLOT_REG; ++k) {
            const int t = tid + k * BEAM_THREADS;
            if (t - lane >= a.slots) break;  // the warp's slots end here
            const bool keep = ppos[k] >= 0 && s.htag[ppos[k]] == (unsigned)(t + 1);
            const unsigned bal = __ballot_sync(0xffffffffu, keep);
            if (keep) {
                const int o = nw + __popc(bal & ((1u << lane) - 1u));
                wt[o] = t;
                wi[o] = pid[k];
            }
            nw += __popc(bal);
        }
        n_kept += nw;
        __syncwarp();
        int nc = 0, nr = 0;   // the warp's survivors, appended in a fixed order
        if constexpr (stages_rows<Scorer>::value || stages_blocks<Scorer>::value) {
            // batches of srows kept slots, lane r scoring the batch's row r
            // (K6 from its staged code row and meta entry), staged over the
            // table once every warp has read its tags
            constexpr bool k6 = stages_blocks<Scorer>::value;
            __syncthreads();
            unsigned char* stage =
                reinterpret_cast<unsigned char*>(s.hid) + ((size_t)warp * sc.srows * sc.sw << 4);
            for (int base = 0; base < nw; base += sc.srows) {
                const int row = base + lane;
                const bool mine = lane < sc.srows && row < nw;
                const int t = mine ? wt[row] : k6 ? -1 : 0;
                const int id = mine ? wi[row] : -1;
                float v;
                if constexpr (k6) {
                    v = sc.staged_block_score(s.q, stage, t, min(sc.srows, nw - base), s.sel, a.d,
                                              a.deg, qnb, a.metric, lane);
                    if (mine) s.nid[t] = id;
                } else {
                    v = staged_score(sc, stage, sc.sw, id, min(sc.srows, nw - base), s.q, a.d, qnb,
                                     a.metric, lane);
                }
                if (mine) s.nd[t] = v;
                const u64 key = ((u64)f2key(v) << 32) | (unsigned)t;
                const bool in_c = mine && v < worst_c;
                const bool in_r = mine && a.k_res && v < worst_r && a.allowed[id];
                const unsigned bc = __ballot_sync(0xffffffffu, in_c);
                const unsigned br = __ballot_sync(0xffffffffu, in_r);
                const unsigned below = (1u << lane) - 1u;
                if (in_c) kc[nc + __popc(bc & below)] = key;
                if (in_r) kr[nr + __popc(br & below)] = key;
                nc += __popc(bc);
                nr += __popc(br);
            }
        } else {
            for (int base = 0; base < nw; base += (32 / GROUP) * GROUP_ROWS) {
                int t[GROUP_ROWS], id[GROUP_ROWS], node[GROUP_ROWS], g[GROUP_ROWS];
                float v[GROUP_ROWS];
#pragma unroll
                for (int r = 0; r < GROUP_ROWS; ++r) {
                    const int row = base + r * (32 / GROUP) + grp;
                    t[r] = row < nw ? wt[row] : 0;
                    id[r] = row < nw ? wi[row] : -1;
                    node[r] = row < nw ? s.sel[t[r] / a.deg] : 0;
                    g[r] = t[r] % a.deg;
                }
                sc.template group_scores<GROUP_ROWS>(s.q, node, g, id, a.d, a.deg, sub, qnb,
                                                     a.metric, v);
                // the group leaders (sub 0) hold the distances; ballots place
                // the survivors
#pragma unroll
                for (int r = 0; r < GROUP_ROWS; ++r) {
                    const bool lead = sub == 0 && id[r] >= 0;
                    if (lead) s.nd[t[r]] = v[r];
                    const u64 key = ((u64)f2key(v[r]) << 32) | (unsigned)t[r];
                    const bool in_c = lead && v[r] < worst_c;
                    const bool in_r = lead && a.k_res && v[r] < worst_r && a.allowed[id[r]];
                    const unsigned bc = __ballot_sync(0xffffffffu, in_c);
                    const unsigned br = __ballot_sync(0xffffffffu, in_r);
                    const unsigned below = (1u << lane) - 1u;
                    if (in_c) kc[nc + __popc(bc & below)] = key;
                    if (in_r) kr[nr + __popc(br & below)] = key;
                    nc += __popc(bc);
                    nr += __popc(br);
                }
            }
        }
        if (lane == 0) { s.misc[1 + warp] = nc; s.misc[5 + warp] = nr; }
        __syncwarp();
        for (int base = 0; base < nc; base += 32)
            warp_sort_run(kc + base, min(32, nc - base), lane);
        for (int base = 0; base < nr; base += 32)
            warp_sort_run(kr + base, min(32, nr - base), lane);
        __syncthreads();
        BEAM_MARK(3);
        // 4. merge into the other half of the double buffers
        const int nxt = cur ^ 1;
        merge_into(cd, ci, cx, a.ef, s.kc, s.misc + 1, a.wcap, s.nid, s.nd, half(s.cd, nxt),
                   half(s.ci, nxt), half(s.cx, nxt));
        if (a.k_res)
            merge_into(half(s.rd, cur), half(s.ri, cur), nullptr, a.k_res, s.kr, s.misc + 5,
                       a.wcap, s.nid, s.nd, half(s.rd, nxt), half(s.ri, nxt), nullptr);
        table_clear(s.hid, s.htag, a.hbits);  // for the next step
        __syncthreads();
        BEAM_MARK(4);
        cur = nxt;
    }
    if (lane == 0) s.misc[9 + warp] = n_kept;
    if (cur == 1) {
        for (int j = tid; j < a.ef; j += BEAM_THREADS) {
            s.cd[0][j] = s.cd[1][j]; s.ci[0][j] = s.ci[1][j]; s.cx[0][j] = s.cx[1][j];
        }
        for (int j = tid; j < a.k_res; j += BEAM_THREADS) {
            s.rd[0][j] = s.rd[1][j];
            s.ri[0][j] = s.ri[1][j];
        }
    }
    __syncthreads();
    int n_scored = 0;
    for (int w = 0; w < BEAM_WARPS; ++w) n_scored += s.misc[9 + w];
    return make_int2(n_exp, n_scored);
}

// one query's beam and its outputs (the body of K8 and K8-SQ)
template <class Scorer>
__device__ __forceinline__ void graph_beam_block(const BeamArgs& a, const Scorer& sc,
                                                 float* out_d, int* out_i, float* out_rd,
                                                 int* out_ri, int* out_exp, int* out_stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Smem s = carve<stages_rows<Scorer>::value>(smem, a, Scorer::query_bytes(a.d),
                                                     stage_bytes(sc));
    const size_t b = blockIdx.x;
    sc.load(b, a.d, s.q);
    __syncthreads();
    const int2 stats = run_beam(a, sc, s, b);
    __syncthreads();
    for (int j = threadIdx.x; j < a.ef; j += blockDim.x) {
        out_d[b * a.ef + j] = s.cd[0][j];
        out_i[b * a.ef + j] = s.ci[0][j];
    }
    for (int j = threadIdx.x; j < a.k_res; j += blockDim.x) {
        out_rd[b * a.k_res + j] = s.rd[0][j];
        out_ri[b * a.k_res + j] = s.ri[0][j];
    }
    if (out_exp)
        for (int j = threadIdx.x; j < a.exp_cap; j += blockDim.x)
            out_exp[b * a.exp_cap + j] = s.exp[j];
    if (threadIdx.x == 0) reinterpret_cast<int2*>(out_stats)[b] = stats;
}

template <class Scorer>
__global__ void __launch_bounds__(BEAM_THREADS)
graph_beam_kernel(BeamArgs a, Scorer sc, float* out_d, int* out_i, float* out_rd,
                  int* out_ri, int* out_exp, int* out_stats) {
    graph_beam_block(a, sc, out_d, out_i, out_rd, out_ri, out_exp, out_stats);
}

// K8-SQ: eight blocks an SM by its registers
template <class Scorer>
__global__ void __launch_bounds__(BEAM_THREADS, WAVE_BLOCKS)
graph_beam_sq_kernel(BeamArgs a, Scorer sc, float* out_d, int* out_i, float* out_rd,
                     int* out_ri, int* out_exp, int* out_stats) {
    graph_beam_block(a, sc, out_d, out_i, out_rd, out_ri, out_exp, out_stats);
}

// K6: its own kernel and bound, so that K8's code keeps its registers
__global__ void __launch_bounds__(BEAM_THREADS, WAVE_BLOCKS)
serve_beam_kernel(BeamArgs a, ServeScorer sc, const uint8_t* allowed, int r, int k,
                  float* out_d, int* out_i, int* out_stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Smem s = carve<true>(smem, a, ServeScorer::query_bytes(a.d), stage_bytes(sc));
    const size_t b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    sc.load(b, a.d, s.q);
    if (tid == 0) mbar_init(sc.bar(s.q, a.slots));
    __syncthreads();
    const int2 stats = run_beam(a, sc, s, b);
    __syncthreads();
#ifdef BEAM_PHASE_CLOCKS
    long long mark = clock64();
#endif
    // Exact rerank of the r best (the buffer is sorted: its first r), in
    // chunks of rc rows staged over the dead table and survivor runs (rows
    // of rw 16-byte words, an odd count: a 16-byte load's 8 lanes of a phase
    // fall on the 32 banks once): every thread's 16-byte copies of the
    // chunk in flight at once, the rows' ids, norms and `allowed` loaded
    // meanwhile, then thread j scores row j of the chunk. Distances land
    // in the other half of the double buffer.
    const float qnb = a.qn[b];
    float* td = s.cd[1];
    int* ti = s.ci[1];
    const int* best = s.ci[0];
    unsigned char* stage = reinterpret_cast<unsigned char*>(s.hid);
    const int words = a.d >> 2;  // 16-byte words of an f32 row (d % 4 == 0, 16-byte aligned)
    const bool pow2 = (words & (words - 1)) == 0;  // d = 128: 32 words
    const int sh = __popc(words - 1);
    for (int c0 = 0; c0 < r; c0 += sc.rc) {
        const int n = min(sc.rc, r - c0);
        for (int e = tid; e < n * words; e += BEAM_THREADS) {
            const int row = pow2 ? e >> sh : e / words, w = e - row * words;
            const int id = best[c0 + row];
            if (id >= 0)
                stage_copy16(stage + ((size_t)row * sc.rw << 4) + ((size_t)w << 4),
                             sc.vectors + (size_t)id * a.d + 4 * w);
        }
        int id = -1;
        bool bad = true;
        float xn = 0.0f;
        if (tid < n) {
            id = best[c0 + tid];
            bad = id < 0 || (allowed != nullptr && !allowed[id]);
            if (!bad && a.metric == 0) xn = sc.norms[id];
        }
        stage_wait();
        __syncthreads();
        if (tid < n) {
            td[c0 + tid] = bad ? F_INF
                               : sc.staged_exact(s.q, stage + ((size_t)tid * sc.rw << 4), a.d,
                                                 qnb, xn, a.metric);
            ti[c0 + tid] = id;
        }
        __syncthreads();  // the chunk's reads of the stage are done
    }
    // The k smallest by (distance, position): keys sorted in runs of 32 by
    // warps (the beam's bitonic network); a key's rank is its place in its
    // run plus the keys below it in every other run.
    u64* keys = reinterpret_cast<u64*>(s.hid);
    for (int base = warp * 32; base < r; base += BEAM_THREADS) {
        const int j = base + lane;
        u64 key = j < r ? ((u64)f2key(td[j]) << 32) | (unsigned)j : ~0ull;
        key = warp_sort32(key, lane);
        if (j < r) keys[j] = key;
    }
    __syncthreads();
    for (int j = tid; j < r; j += BEAM_THREADS) {
        const u64 key = keys[j];
        int rank = j & 31;
        for (int o = 0; o < r && rank < k; o += 32)
            if (o != (j & ~31)) rank += count_below(keys + o, min(32, r - o), key);
        if (rank < k) {
            const int p = (int)(key & 0xffffffffu);
            const float v = td[p];
            out_d[b * k + rank] = v;
            out_i[b * k + rank] = v < F_INF ? ti[p] : -1;
        }
    }
    if (tid == 0) reinterpret_cast<int2*>(out_stats)[b] = stats;
#ifdef BEAM_PHASE_CLOCKS
    __syncthreads();
#endif
    BEAM_MARK(6);
}

static BeamArgs beam_args(int B, int S, int d, int deg, int ef, int iters, int expand,
                          int k_res, int metric, const int* seed_i, const float* seed_d,
                          const uint8_t* allowed, const float* qn) {
    BeamArgs a;
    a.B = B; a.S = S; a.d = d; a.deg = deg; a.ef = ef; a.expand = expand;
    a.loops = (iters + expand - 1) / expand;
    a.exp_cap = a.loops * expand;
    a.slots = expand * deg;
    a.k_res = k_res; a.metric = metric;
    // members (the buffer, every expanded id) and claims (the slots) of a step
    a.hbits = table_bits(ef + a.exp_cap + a.slots);
    a.wcap = 32 * ((a.slots + BEAM_THREADS - 1) / BEAM_THREADS);
    a.seed_i = seed_i; a.seed_d = seed_d; a.allowed = allowed; a.qn = qn;
    return a;
}

static bool beam_args_ok(const BeamArgs& a) {
    return a.B >= 0 && a.S >= 1 && a.S <= a.ef && a.expand >= 1 && a.expand <= a.ef &&
           a.loops >= 1 && a.slots <= SLOTS_MAX && a.d % 4 == 0 &&
           a.deg >= 1 && a.k_res >= 0 &&
           (a.k_res == 0 || a.allowed != nullptr) && a.metric >= 0 && a.metric <= 2;
}

// Blocks of `kernel` an SM runs with `smem` bytes of shared memory (0 when
// it cannot run one); launch_util.cuh asks once for each size.
template <class K>
static int blocks_per_sm(K kernel, size_t smem) {
    return sm_blocks(kernel, BEAM_THREADS, smem);
}

// K8-SQ's stage: 32 rows a warp (every lane scores in phase 3) unless that
// cuts the blocks an SM runs below what this launch needs (all of its B
// blocks at once) and 16 rows would run more; then halves of 16. `fits`
// (or null) gets the blocks an SM runs at 16 and at 32 rows.
template <class Scorer>
static void pick_stage(const BeamArgs& a, Scorer& sc, int* fits = nullptr) {
    sc.sw = stage_words(Scorer::row_bytes(a.d));
    const int sms = launch_util::sm_count();
    const int need = (a.B + sms - 1) / sms;
    const size_t qb = Scorer::query_bytes(a.d);
    sc.srows = 16;
    const int half_fit = blocks_per_sm(graph_beam_sq_kernel<Scorer>,
                                       smem_bytes(a, qb, stage_bytes(sc)));
    sc.srows = 32;
    const int full_fit = blocks_per_sm(graph_beam_sq_kernel<Scorer>,
                                       smem_bytes(a, qb, stage_bytes(sc)));
    if (full_fit < need && full_fit < half_fit) sc.srows = 16;
    if (fits) { fits[0] = half_fit; fits[1] = full_fit; }
}

template <class K, class Scorer>
static int launch_beam(K kernel, const BeamArgs& a, const Scorer& sc, float* out_d, int* out_i,
                       float* out_rd, int* out_ri, int* out_exp, int* out_stats, void* stream) {
    if (!beam_args_ok(a) || (a.k_res && (out_rd == nullptr || out_ri == nullptr)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(a, Scorer::query_bytes(a.d), stage_bytes(sc));
    int e = raise_smem(kernel, smem);
    if (e) return e;
    kernel<<<a.B, BEAM_THREADS, smem, (cudaStream_t)stream>>>(a, sc, out_d, out_i, out_rd,
                                                              out_ri, out_exp, out_stats);
    return (int)cudaGetLastError();
}

extern "C" int hnsw_graph_beam(const int* adj, const float* vectors, const float* norms,
                               const float* q, const float* qn, const int* seed_i,
                               const float* seed_d, int B, int S, const uint8_t* allowed, int d,
                               int deg, int ef, int iters, int expand, int k_res, int metric,
                               float* out_d, int* out_i, float* out_rd, int* out_ri,
                               int* out_exp, int* out_stats, void* stream) {
    const BeamArgs a = beam_args(B, S, d, deg, ef, iters, expand, k_res, metric, seed_i, seed_d,
                                 allowed, qn);
    return launch_beam(graph_beam_kernel<GraphScorer>, a, GraphScorer{adj, vectors, norms, q},
                       out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
}

// K8-SQ at these widths: the stage picked, then the launch
template <class CodeT>
static int launch_beam_sq(const BeamArgs& a, SqScorer<CodeT> sc, float* out_d, int* out_i,
                          float* out_rd, int* out_ri, int* out_exp, int* out_stats,
                          void* stream) {
    pick_stage(a, sc);
    return launch_beam(graph_beam_sq_kernel<SqScorer<CodeT>>, a, sc, out_d, out_i, out_rd, out_ri,
                       out_exp, out_stats, stream);
}

// rows of whole, aligned 16-byte words are staged by 16-byte copies
static int wide_rows(const void* codes, int d, int bits) {
    return (size_t)codes % 16 == 0 && (size_t)d * (bits / 8) % 16 == 0;
}

// K8 over the SQ store: `codes` [cap, d] u8 (bits 8) or u16 (bits 16)
extern "C" int hnsw_graph_beam_sq(const int* adj, const void* codes, int bits, const float* mins,
                                  const float* scales, const float* norms, const float* q,
                                  const float* qn, const int* seed_i, const float* seed_d, int B,
                                  int S, const uint8_t* allowed, int d, int deg, int ef, int iters,
                                  int expand, int k_res, int metric, float* out_d, int* out_i,
                                  float* out_rd, int* out_ri, int* out_exp, int* out_stats,
                                  void* stream) {
    const BeamArgs a = beam_args(B, S, d, deg, ef, iters, expand, k_res, metric, seed_i, seed_d,
                                 allowed, qn);
    const int wide = wide_rows(codes, d, bits);
    if (bits == 8)
        return launch_beam_sq(
            a, SqScorer<uint8_t>{adj, static_cast<const uint8_t*>(codes), mins, scales, norms, q,
                                 wide},
            out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
    if (bits == 16)
        return launch_beam_sq(
            a, SqScorer<uint16_t>{adj, static_cast<const uint16_t*>(codes), mins, scales, norms,
                                  q, wide},
            out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
    return (int)cudaErrorInvalidValue;
}

// K8-SQ's stage at these widths on the current device: out[0] the rows a
// warp stages at once, out[1] / out[2] the blocks an SM runs at 16 / 32
extern "C" int hnsw_graph_beam_sq_stage(int B, int S, int d, int deg, int ef, int iters,
                                        int expand, int k_res, int bits, int* out) {
    const BeamArgs a = beam_args(B, S, d, deg, ef, iters, expand, k_res, 0, nullptr, nullptr,
                                 nullptr, nullptr);
    if (bits == 8) {
        SqScorer<uint8_t> sc{};
        pick_stage(a, sc, out + 1);
        out[0] = sc.srows;
    } else if (bits == 16) {
        SqScorer<uint16_t> sc{};
        pick_stage(a, sc, out + 1);
        out[0] = sc.srows;
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// K6's rerank stage: at most RERANK_STAGE_BYTES of staged f32 rows a
// chunk (32 rows of d = 128), at least one
#define RERANK_STAGE_BYTES (32 * 33 * 16)

// K6's shared memory: the beam's (the stages over the table), then the meta
// blocks of a step and their mbarrier
static size_t serve_smem(const BeamArgs& a, ServeScorer& sc) {
    sc.meta_off = (unsigned)align16(smem_bytes(a, ServeScorer::query_bytes(a.d), stage_bytes(sc)));
    return (size_t)sc.meta_off + (size_t)a.slots * 16 + 16;
}

// K6's stages at these widths, as K8-SQ's (pick_stage): 32 code rows a
// warp unless that cuts the blocks an SM runs below what the launch needs
// (all of its B blocks at once) and half as many would run more; halved
// again while the stage would not fit at all (wide rows). The table's
// region also holds a rerank chunk of rc rows (less the survivor runs
// after it). Returns the shared memory; `fits` (or null) gets the blocks
// an SM runs at 16 and at 32 rows.
static size_t pick_serve_stage(const BeamArgs& a, ServeScorer& sc, int r, int* fits = nullptr) {
    sc.sw = stage_words(a.d);
    sc.rw = stage_words(4 * a.d);
    sc.rc = std::max(1, std::min({32, r, RERANK_STAGE_BYTES / (sc.rw * 16)}));
    const long rerank = (long)sc.rc * sc.rw * 16 - 16L * BEAM_WARPS * a.wcap;
    const int sms = launch_util::sm_count();
    const int need = (a.B + sms - 1) / sms;
    auto fit = [&](int srows) {
        sc.srows = srows;
        sc.stage = (int)std::max((long)BEAM_WARPS * srows * sc.sw * 16, rerank);
        return blocks_per_sm(serve_beam_kernel, serve_smem(a, sc));
    };
    if (fits) { fits[0] = fit(16); fits[1] = fit(32); }
    int rows = 32, here = fit(32);
    while (rows > 1) {
        const int half = fit(rows / 2);
        if (here > 0 && (here >= need || here >= half)) break;
        rows /= 2;
        here = half;
    }
    fit(rows);
    return serve_smem(a, sc);
}

extern "C" int hnsw_serve_beam(const int8_t* codes, const int* meta, const float* vectors,
                               const float* norms, const float* q, const float* qn,
                               const int8_t* qc, const float* qs, const float* qsum,
                               const int* seed_i, const float* seed_d, int B, int S,
                               const uint8_t* allowed, int d, int deg, int ef, int iters,
                               int expand, int rerank, int k, int metric, float* out_d,
                               int* out_i, int* out_stats, void* stream) {
    BeamArgs a = beam_args(B, S, d, deg, ef, iters, expand, 0, metric, seed_i, seed_d, nullptr,
                           qn);
    if (!beam_args_ok(a) || rerank < 1 || rerank > ef || k < 1 || k > rerank ||
        (size_t)meta % 16 || (size_t)vectors % 16)
        return (int)cudaErrorInvalidValue;
    ServeScorer sc{codes, reinterpret_cast<const int4*>(meta), vectors, norms, q, qc, qs, qsum};
    sc.wide16 = wide_rows(codes, d, 8);
    const size_t smem = pick_serve_stage(a, sc, rerank);
    int e = raise_smem(serve_beam_kernel, smem);
    if (e) return e;
    serve_beam_kernel<<<B, BEAM_THREADS, smem, (cudaStream_t)stream>>>(
        a, sc, allowed, rerank, k, out_d, out_i, out_stats);
    return (int)cudaGetLastError();
}

// K6's stages at these widths on the current device: out[0] the code rows
// a warp stages at once, out[1] the rerank's rows a chunk, out[2] the
// shared memory a block, out[3] / out[4] the blocks an SM runs at 16 / 32
// code rows
extern "C" int hnsw_serve_beam_stage(int B, int S, int d, int deg, int ef, int iters, int expand,
                                     int rerank, int* out) {
    const BeamArgs a = beam_args(B, S, d, deg, ef, iters, expand, 0, 0, nullptr, nullptr,
                                 nullptr, nullptr);
    ServeScorer sc{};
    out[2] = (int)pick_serve_stage(a, sc, rerank, out + 3);
    out[0] = sc.srows;
    out[1] = sc.rc;
    return (int)cudaGetLastError();
}
