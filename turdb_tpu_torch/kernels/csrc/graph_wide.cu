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
// deeper on a USING HNSW index (fetch = 4*LIMIT at ef = 2*fetch), by
// searches with ef > 1024, and by rows wider than 4096.
//
// What bounds it on an H100: the latency of the beam's dependent steps, as
// the fast form, plus the step's bookkeeping in device memory (L2). A
// correctness path, not tuned.
//
// Design: the fast form's loop and step order, with every buffer in a global
// scratch slice of the block (one 128-thread block per query, a grid of at
// most `grid` blocks walking the queries): the sorted candidate buffer and
// its expanded flags (double-buffered), the filtered result buffer, the
// expanded ids, the step's claim table (graph_util.cuh), the slots' ids,
// distances and claims, the survivors' keys. A step: warp 0 takes the first
// `expand` unflagged finite entries of the sorted buffer while the other
// warps insert the buffer's ids and every earlier expanded id into the
// table; each slot claims its neighbour (the lowest slot of an id wins, a
// member is dropped); the kept slots are scored and those below the
// buffer's worst (and, with `allowed`, the allowed ones below the result
// buffer's worst) become (f2key(distance) << 32 | slot) keys, sorted by a
// bitonic network; each old entry moves by the keys below it and each key
// to its rank plus the old entries at or below it. The scores are the fast
// forms' to the bit: K8 by lane groups of 8 in K8's order
// (graph_scorer.cuh group_scores), K8-SQ and K9 by one thread a row in the
// row's own fmaf order (what staged_score computes), K6 by the exact int8
// dot and its epilogue; K6's rerank is one fmaf chain a row, as
// staged_exact. K9 wide is one warp a query with each neighbour scored by
// one lane from device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_scorer.cuh"
#include "wide_util.cuh"

#define WB_THREADS 128
#define WB_WARPS (WB_THREADS / 32)
#define WG_THREADS 128
#define WG_WARPS (WG_THREADS / 32)
#define WG_CAP 128          // steps of one level's walk (kernels.GREEDY_CAP)
#define WG_LEVELS_MAX 8     // kernels/build.py GREEDY_LEVELS_MAX

struct WideArgs {
    int B, S, d, deg, ef, loops, expand, exp_cap, slots, k_res, metric;
    int hbits;                 // the claim table holds 1 << hbits entries
    int rpow;                  // K6: the rerank's sort keys (0: none)
    const int* seed_i;         // [B, S]
    const float* seed_d;       // [B, S]
    const uint8_t* allowed;    // [cap] or null
    const float* qn;           // [B]
};

// One block's scratch, laid out in this order.
struct WideBufs {
    u64* kc; u64* kr;          // [pow2(slots)] survivors' keys: buffer, results
    u64* rk;                   // [rpow] K6's rerank keys
    unsigned* hid; unsigned* htag;          // [1 << hbits] the step's table
    float* cd[2]; int* ci[2]; int* cx[2];   // [ef] x 2 the buffer: distance, id, expanded
    float* rd[2]; int* ri[2];               // [k_res] x 2 the filtered results
    int* nid; float* nd; int* ppos; int* kept;   // [slots] id, distance, claim, kept slots
    int* sel;                  // [expand] ids expanded this step (-1: none)
    int* exp;                  // [exp_cap] expanded ids
    int* misc;                 // [8]: 0 found, 1 kept, 2 / 3 survivors (buffer / results)
};

__host__ __device__ inline size_t wide_beam_bytes(const WideArgs& a) {
    const size_t words = (size_t)2 * (1 << a.hbits) + 6 * (size_t)a.ef + 4 * (size_t)a.k_res +
                         4 * (size_t)a.slots + a.expand + a.exp_cap + 8;
    return wide_align16((size_t)8 * (2 * pow2_ge(a.slots) + a.rpow) + 4 * words);
}

__device__ inline WideBufs wide_carve(unsigned char* p, const WideArgs& a) {
    WideBufs s;
    u64* w = reinterpret_cast<u64*>(p);
    const int sp = pow2_ge(a.slots);
    s.kc = w; w += sp;
    s.kr = w; w += sp;
    s.rk = w; w += a.rpow;
    unsigned* u = reinterpret_cast<unsigned*>(w);
    s.hid = u; u += 1 << a.hbits;
    s.htag = u; u += 1 << a.hbits;
    float* f = reinterpret_cast<float*>(u);
    for (int h = 0; h < 2; ++h) {
        s.cd[h] = f; f += a.ef;
        s.ci[h] = reinterpret_cast<int*>(f); f += a.ef;
        s.cx[h] = reinterpret_cast<int*>(f); f += a.ef;
        s.rd[h] = f; f += a.k_res;
        s.ri[h] = reinterpret_cast<int*>(f); f += a.k_res;
    }
    s.nid = reinterpret_cast<int*>(f); f += a.slots;
    s.nd = f; f += a.slots;
    s.ppos = reinterpret_cast<int*>(f); f += a.slots;
    s.kept = reinterpret_cast<int*>(f); f += a.slots;
    s.sel = reinterpret_cast<int*>(f); f += a.expand;
    s.exp = reinterpret_cast<int*>(f); f += a.exp_cap;
    s.misc = reinterpret_cast<int*>(f);
    return s;
}

// f32 rows scored one thread a row (K9 wide): x . q in order j = 0 .. d-1,
// one fmaf chain (the staged scorer's sum)
struct RowsF32 {
    const float* vectors;
    const float* norms;
    __device__ float row_score(int id, const float* q, int d, float qnb, int metric) const {
        const float* x = vectors + (size_t)id * d;
        float acc = 0.0f;
        for (int j = 0; j < d; ++j) acc = fmaf(__ldg(x + j), q[j], acc);
        return gathered_epilogue(acc, qnb, __ldg(norms + id), metric);
    }
};

// the SQ store (u8 / u16 codes): each code dequantized as min + scale * code
// by one fmaf, then the chain, in order (SqScorer::staged_dot's sum)
template <class CodeT>
struct RowsSq {
    const int* adj;
    const CodeT* codes;
    const float* mins;
    const float* scales;
    const float* norms;
    __device__ float row_score(int id, const float* q, int d, float qnb, int metric) const {
        const CodeT* c = codes + (size_t)id * d;
        const float m = __ldg(mins + id), s = __ldg(scales + id);
        float acc = 0.0f;
        for (int j = 0; j < d; ++j) acc = fmaf(fmaf(s, (float)c[j], m), q[j], acc);
        return gathered_epilogue(acc, qnb, __ldg(norms + id), metric);
    }
};

// The beam's scorers: neighbour(node, g) names slot g of node's list; a
// scorer with GROUPS scores by lane groups (K8's order), else one thread a
// slot by score(...)
struct BeamF32 {
    static constexpr bool GROUPS = true;
    GraphScorer sc;
    __device__ int neighbour(int node, int g, int deg) const { return sc.neighbour(node, g, deg); }
};

template <class CodeT>
struct BeamSq {
    static constexpr bool GROUPS = false;
    RowsSq<CodeT> rows;
    const float* q;            // [B, d]
    __device__ int neighbour(int node, int g, int deg) const {
        return rows.adj[(size_t)node * deg + g];
    }
    __device__ float score(int id, int, int, size_t b, int d, int, float qnb, int metric) const {
        return rows.row_score(id, q + b * d, d, qnb, metric);
    }
};

struct BeamServe {
    static constexpr bool GROUPS = false;
    const int8_t* codes;       // [cap, deg, d]
    const int4* meta;          // [cap, deg] (base, scale, norm bits, id)
    const float* vectors;      // [cap, d] the rerank store
    const float* norms;        // [cap]
    const float* q;            // [B, d]
    const int8_t* qc;          // [B, d]
    const float* qs;           // [B]
    const float* qsum;         // [B]
    __device__ int neighbour(int node, int g, int deg) const {
        return meta[(size_t)node * deg + g].w;
    }
    // the exact int8 dot (any order gives the same sum) and _approx_dist's
    // epilogue, rounded as hnsw_beam.cu staged_block_score rounds it
    __device__ float score(int, int node, int g, size_t b, int d, int deg, float qnb,
                           int metric) const {
        const size_t blk = (size_t)node * deg + g;
        const int* x = reinterpret_cast<const int*>(codes + blk * d);
        const int* y = reinterpret_cast<const int*>(qc + b * d);
        int dot = 0;
        for (int j = 0; j < (d >> 2); ++j) dot = __dp4a(__ldg(x + j), __ldg(y + j), dot);
        const int4 m = __ldg(meta + blk);
        const float qdx = __fadd_rn(__fmul_rn(__int_as_float(m.x), qsum[b]),
                                    __fmul_rn(__int_as_float(m.y),
                                              __fmul_rn(qs[b], __int2float_rn(dot))));
        if (metric == 0) return __fadd_rn(__fsub_rn(qnb, __fmul_rn(2.0f, qdx)), __int_as_float(m.z));
        if (metric == 1) return __fsub_rn(1.0f, qdx);
        return -qdx;
    }
};

// n (distance, id) seed pairs sorted by (distance, position) into od / oi.
// This helper and wide_merge repeat hnsw_beam.cu's sorted_seeds and
// merge_into over global buffers; they are copies so that the fast beam
// kernels' code (and registers) stay as they are.
__device__ void wide_sorted_seeds(const float* d, const int* id, int n, float* od, int* oi) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const float v = d[j];
        int r = 0;
        for (int i = 0; i < n; ++i) r += d[i] < v || (d[i] == v && i < j);
        od[r] = v;
        oi[r] = id[j];
    }
}

// The sorted buffer (od, oi, ox)[n] merged with the sorted keys[0, nk)
// (distance, slot), keeping its n smallest by (distance, position), every
// old entry before every new one of the same distance: into (td, ti, tx)
__device__ void wide_merge(const float* od, const int* oi, const int* ox, int n, const u64* keys,
                           int nk, const int* nid, const float* nd, float* td, int* ti, int* tx) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i + count_below(keys, nk, (u64)f2key(od[i]) << 32);
        if (r < n) {
            td[r] = od[i];
            ti[r] = oi[i];
            if (tx) tx[r] = ox[i];
        }
    }
    for (int j = threadIdx.x; j < nk; j += blockDim.x) {
        const int t = (int)(keys[j] & 0xffffffffu);
        const float v = nd[t];
        int lo = 0, hi = n;  // old entries <= v
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (od[mid] <= v) lo = mid + 1; else hi = mid;
        }
        const int r = j + lo;
        if (r < n) {
            td[r] = v;
            ti[r] = nid[t];
            if (tx) tx[r] = 0;
        }
    }
}

// The beam of query b over the block's scratch; leaves the buffer and the
// results in half `*cur_out`, returns (expanded nodes, scored neighbours).
template <class Sc>
__device__ int2 wide_beam(const WideArgs& a, const Sc& sc, const WideBufs& s, size_t b,
                          int* cur_out) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int T = 1 << a.hbits;
    table_clear(s.hid, s.htag, a.hbits);
    for (int j = tid; j < a.ef; j += WB_THREADS) {
        s.cd[0][j] = WIDE_INF; s.ci[0][j] = -1; s.cx[0][j] = 0;
    }
    for (int j = tid; j < a.k_res; j += WB_THREADS) { s.rd[0][j] = WIDE_INF; s.ri[0][j] = -1; }
    for (int j = tid; j < a.exp_cap; j += WB_THREADS) s.exp[j] = -1;
    __syncthreads();
    const int* si = a.seed_i + b * a.S;
    const float* sd = a.seed_d + b * a.S;
    wide_sorted_seeds(sd, si, a.S, s.cd[0], s.ci[0]);
    if (a.k_res) {
        const int sk = a.S < a.k_res ? a.S : a.k_res;
        for (int j = tid; j < sk; j += WB_THREADS) {
            const bool ok = si[j] >= 0 && a.allowed[si[j]];
            s.rd[1][j] = ok ? sd[j] : WIDE_INF;
            s.ri[1][j] = ok ? si[j] : -1;
        }
        __syncthreads();
        wide_sorted_seeds(s.rd[1], s.ri[1], sk, s.rd[0], s.ri[0]);
    }
    *cur_out = 0;
    bool any_seed = false;
    for (int j = tid; j < a.S; j += WB_THREADS) any_seed |= si[j] >= 0;
    if (!__syncthreads_or(any_seed)) return make_int2(0, 0);

    const float qnb = a.qn[b];
    int n_exp = 0, n_kept = 0, cur = 0;
    for (int it = 0; it < a.loops; ++it) {
        const float* cd = s.cd[cur];
        const int* ci = s.ci[cur];
        int* cx = s.cx[cur];
        // 1. warp 0: the `expand` nearest unexpanded candidates (the first
        // unflagged finite entries); the others: the buffer's ids and every
        // id expanded before into the table
        if (warp == 0) {
            int found = 0;
            for (int base = 0; base < a.ef && found < a.expand; base += 32) {
                const int j = base + lane;
                const bool c = j < a.ef && ci[j] >= 0 && !cx[j] && cd[j] < WIDE_INF;
                unsigned m = __ballot_sync(WIDE_FULL, c);
                while (m && found < a.expand) {
                    const int l = __ffs(m) - 1;
                    m &= m - 1;
                    if (lane == 0) {
                        s.sel[found] = ci[base + l];
                        cx[base + l] = 1;
                    }
                    ++found;
                }
            }
            __syncwarp();
            for (int e = found + lane; e < a.expand; e += 32) s.sel[e] = -1;
            __syncwarp();
            for (int e = lane; e < a.expand; e += 32) s.exp[it * a.expand + e] = s.sel[e];
            if (lane == 0) {
                s.misc[0] = found;
                s.misc[1] = s.misc[2] = s.misc[3] = 0;
            }
            n_exp += found;
        } else {
            const int n_mem = a.ef + it * a.expand;
            for (int j = tid - 32; j < n_mem; j += WB_THREADS - 32) {
                const int id = j < a.ef ? ci[j] : s.exp[j - a.ef];
                if (id >= 0) table_member(s.hid, s.htag, a.hbits, id);
            }
        }
        __syncthreads();
        if (s.misc[0] == 0) break;
        // 2. each slot claims its neighbour: not a member, the lowest slot
        for (int t = tid; t < a.slots; t += WB_THREADS) {
            const int node = s.sel[t / a.deg];
            const int id = node >= 0 ? sc.neighbour(node, t % a.deg, a.deg) : -1;
            s.nid[t] = id;
            s.ppos[t] = id >= 0 ? table_claim(s.hid, s.htag, a.hbits, id, t) : -1;
        }
        __syncthreads();
        for (int t = tid; t < a.slots; t += WB_THREADS) {
            const int p = s.ppos[t];
            if (p >= 0 && s.htag[p] == (unsigned)(t + 1)) s.kept[atomicAdd(s.misc + 1, 1)] = t;
        }
        __syncthreads();
        // 3. score the kept slots; the survivors' keys
        const int nk = s.misc[1];
        n_kept += nk;
        const float worst_c = cd[a.ef - 1];
        const float worst_r = a.k_res ? s.rd[cur][a.k_res - 1] : 0.0f;
        auto survive = [&](int t, int id, float v) {
            s.nd[t] = v;
            const u64 key = ((u64)f2key(v) << 32) | (unsigned)t;
            if (v < worst_c) s.kc[atomicAdd(s.misc + 2, 1)] = key;
            if (a.k_res && v < worst_r && a.allowed[id]) s.kr[atomicAdd(s.misc + 3, 1)] = key;
        };
        if constexpr (Sc::GROUPS) {
            const int grp = lane / GROUP, sub = lane % GROUP;
            const unsigned char* qrow =
                reinterpret_cast<const unsigned char*>(sc.sc.q + b * (size_t)a.d);
            for (int base = warp * (32 / GROUP); base < nk; base += WB_WARPS * (32 / GROUP)) {
                const int row = base + grp;
                const int t = row < nk ? s.kept[row] : 0;
                int id[1] = {row < nk ? s.nid[t] : -1};
                int node[1] = {row < nk ? s.sel[t / a.deg] : 0};
                int g[1] = {t % a.deg};
                float v[1];
                sc.sc.template group_scores<1>(qrow, node, g, id, a.d, a.deg, sub, qnb, a.metric,
                                               v);
                if (sub == 0 && row < nk) survive(t, id[0], v[0]);
            }
        } else {
            for (int i = tid; i < nk; i += WB_THREADS) {
                const int t = s.kept[i];
                const int id = s.nid[t];
                survive(t, id, sc.score(id, s.sel[t / a.deg], t % a.deg, b, a.d, a.deg, qnb,
                                        a.metric));
            }
        }
        __syncthreads();
        const int nc = s.misc[2], nr = s.misc[3];
        block_sort_keys(s.kc, nc);
        block_sort_keys(s.kr, nr);
        // 4. merge into the other halves; clear the table for the next step
        const int nxt = cur ^ 1;
        wide_merge(cd, ci, cx, a.ef, s.kc, nc, s.nid, s.nd, s.cd[nxt], s.ci[nxt], s.cx[nxt]);
        if (a.k_res)
            wide_merge(s.rd[cur], s.ri[cur], nullptr, a.k_res, s.kr, nr, s.nid, s.nd, s.rd[nxt],
                       s.ri[nxt], nullptr);
        for (int j = tid; j < T; j += WB_THREADS) {
            s.hid[j] = EMPTY_ID;
            s.htag[j] = 0xffffffffu;
        }
        __syncthreads();
        cur = nxt;
    }
    *cur_out = cur;
    return make_int2(n_exp, n_kept);
}

template <class Sc>
__global__ void __launch_bounds__(WB_THREADS)
graph_beam_wide_kernel(WideArgs a, Sc sc, unsigned char* scratch, size_t stride, float* out_d,
                       int* out_i, float* out_rd, int* out_ri, int* out_exp, int* out_stats) {
    const WideBufs s = wide_carve(scratch + blockIdx.x * stride, a);
    for (size_t b = blockIdx.x; b < (size_t)a.B; b += gridDim.x) {
        int cur = 0;
        const int2 stats = wide_beam(a, sc, s, b, &cur);
        __syncthreads();
        for (int j = threadIdx.x; j < a.ef; j += WB_THREADS) {
            out_d[b * a.ef + j] = s.cd[cur][j];
            out_i[b * a.ef + j] = s.ci[cur][j];
        }
        for (int j = threadIdx.x; j < a.k_res; j += WB_THREADS) {
            out_rd[b * a.k_res + j] = s.rd[cur][j];
            out_ri[b * a.k_res + j] = s.ri[cur][j];
        }
        if (out_exp)
            for (int j = threadIdx.x; j < a.exp_cap; j += WB_THREADS)
                out_exp[b * a.exp_cap + j] = s.exp[j];
        if (threadIdx.x == 0) reinterpret_cast<int2*>(out_stats)[b] = stats;
        __syncthreads();   // the scratch is the next query's
    }
}

// K6 wide: the beam, then the exact rerank of the r best (one fmaf chain a
// row, unclamped L2, +inf outside `allowed`) and the k smallest by
// (distance, position)
__global__ void __launch_bounds__(WB_THREADS)
serve_beam_wide_kernel(WideArgs a, BeamServe sc, const uint8_t* allowed, int r, int k,
                       unsigned char* scratch, size_t stride, float* out_d, int* out_i,
                       int* out_stats) {
    const WideBufs s = wide_carve(scratch + blockIdx.x * stride, a);
    for (size_t b = blockIdx.x; b < (size_t)a.B; b += gridDim.x) {
        int cur = 0;
        const int2 stats = wide_beam(a, sc, s, b, &cur);
        __syncthreads();
        const float qnb = a.qn[b];
        const float* qb = sc.q + b * a.d;
        const int* best = s.ci[cur];
        float* td = s.cd[cur ^ 1];
        int* ti = s.ci[cur ^ 1];
        for (int j = threadIdx.x; j < r; j += WB_THREADS) {
            const int id = best[j];
            const bool bad = id < 0 || (allowed != nullptr && !allowed[id]);
            float v = WIDE_INF;
            if (!bad) {
                const float* x = sc.vectors + (size_t)id * a.d;
                float acc = 0.0f;
                for (int c = 0; c < a.d; ++c) acc = fmaf(__ldg(x + c), qb[c], acc);
                if (a.metric == 0) v = __fsub_rn(__fadd_rn(qnb, sc.norms[id]), __fmul_rn(2.0f, acc));
                else if (a.metric == 1) v = __fsub_rn(1.0f, acc);
                else v = -acc;
            }
            td[j] = v;
            ti[j] = id;
            s.rk[j] = ((u64)f2key(v) << 32) | (unsigned)j;
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
    a.hbits = table_bits(ef + a.exp_cap + a.slots);
    a.rpow = rerank > 0 ? pow2_ge(rerank) : 0;
    a.seed_i = seed_i; a.seed_d = seed_d; a.allowed = allowed; a.qn = qn;
    return a;
}

static bool wide_args_ok(const WideArgs& a) {
    return a.B >= 1 && a.S >= 1 && a.S <= a.ef && a.expand >= 1 && a.expand <= a.ef &&
           a.loops >= 1 && a.d >= 4 && a.d % 4 == 0 && a.deg >= 1 && a.k_res >= 0 &&
           (a.k_res == 0 || a.allowed != nullptr) && a.metric >= 0 && a.metric <= 2 &&
           a.hbits < 30;
}

// bytes of one block's scratch (the wrapper allocates grid x this); rerank
// 0 for K8 / K8-SQ, K6's rerank width otherwise
extern "C" long long hnsw_beam_wide_bytes(int deg, int ef, int iters, int expand, int k_res,
                                          int rerank) {
    const WideArgs a = wide_args(1, 1, 4, deg, ef, iters, expand, k_res, 0, rerank, nullptr,
                                 nullptr, nullptr, nullptr);
    return (long long)wide_beam_bytes(a);
}

template <class Sc>
static int launch_beam_wide(const WideArgs& a, const Sc& sc, unsigned char* scratch, int grid,
                            float* out_d, int* out_i, float* out_rd, int* out_ri, int* out_exp,
                            int* out_stats, void* stream) {
    if (!wide_args_ok(a) || grid < 1 || scratch == nullptr ||
        (a.k_res && (out_rd == nullptr || out_ri == nullptr)))
        return (int)cudaErrorInvalidValue;
    graph_beam_wide_kernel<Sc><<<grid, WB_THREADS, 0, (cudaStream_t)stream>>>(
        a, sc, scratch, wide_beam_bytes(a), out_d, out_i, out_rd, out_ri, out_exp, out_stats);
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
    if (bits == 8)
        return launch_beam_wide(
            a, BeamSq<uint8_t>{{adj, static_cast<const uint8_t*>(codes), mins, scales, norms}, q},
            scratch, grid, out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
    if (bits == 16)
        return launch_beam_wide(
            a, BeamSq<uint16_t>{{adj, static_cast<const uint16_t*>(codes), mins, scales, norms}, q},
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
    if (!wide_args_ok(a) || rerank < 1 || rerank > ef || k < 1 || k > rerank || grid < 1 ||
        scratch == nullptr || (size_t)meta % 16 || (size_t)codes % 4 || (size_t)qc % 4)
        return (int)cudaErrorInvalidValue;
    const BeamServe sc{codes, reinterpret_cast<const int4*>(meta), vectors, norms, q, qc, qs, qsum};
    serve_beam_wide_kernel<<<grid, WB_THREADS, 0, (cudaStream_t)stream>>>(
        a, sc, allowed, rerank, k, scratch, wide_beam_bytes(a), out_d, out_i, out_stats);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9 wide: the greedy descent, one warp a query, each neighbour of a step
// scored by one lane from device memory (the fast form stages 16 rows a
// warp in shared memory)
// ---------------------------------------------------------------------------

struct GreedyLevelsWide {   // kernels/build.py GreedyLevels
    const int* adj[WG_LEVELS_MAX];
    int n;
};

template <class Rows>
__global__ void __launch_bounds__(WG_THREADS)
greedy_wide_kernel(Rows rows, GreedyLevelsWide lv, const float* __restrict__ q,
                   const float* __restrict__ qn, const int* __restrict__ cur_i,
                   const float* __restrict__ cur_d, const int* __restrict__ lowest, int B, int d,
                   int deg, int metric, int* __restrict__ out_i, float* __restrict__ out_d,
                   int* __restrict__ out_stats) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t b = (size_t)blockIdx.x * WG_WARPS + warp;
    if (b >= (size_t)B) return;
    const float* qb = q + b * d;
    int cur = cur_i[b];
    float cd = cur_d[b];
    const float qnb = qn[b];
    const int walk = lv.n - (lowest ? min(max(lowest[b], 0), lv.n) : 0);
    int steps = 0, scored = 0;
    for (int l = 0; l < walk; ++l) {
        const int* adj = lv.adj[l];
        for (int s = 0; s < WG_CAP; ++s) {
            const int node = cur < 0 ? 0 : cur;
            float bv = WIDE_INF;
            int bg = 0x7fffffff, bid = -1;
            for (int g0 = 0; g0 < deg; g0 += 32) {
                const int g = g0 + lane;
                const int id = g < deg ? adj[(size_t)node * deg + g] : -1;
                scored += __popc(__ballot_sync(WIDE_FULL, id >= 0));
                if (id >= 0) {
                    const float v = rows.row_score(id, qb, d, qnb, metric);
                    if (v < bv) { bv = v; bg = g; bid = id; }
                }
            }
            for (int o = 16; o > 0; o >>= 1) {
                const float ov = __shfl_xor_sync(WIDE_FULL, bv, o);
                const int og = __shfl_xor_sync(WIDE_FULL, bg, o);
                const int oid = __shfl_xor_sync(WIDE_FULL, bid, o);
                if (ov < bv || (ov == bv && og < bg)) { bv = ov; bg = og; bid = oid; }
            }
            ++steps;
            if (!(bv < cd)) break;
            cur = bid;
            cd = bv;
        }
    }
    if (lane == 0) {
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
    const int blocks = (B + WG_WARPS - 1) / WG_WARPS;
    greedy_wide_kernel<Rows><<<blocks, WG_THREADS, 0, (cudaStream_t)stream>>>(
        rows, lv, q, qn, cur_i, cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats);
    return (int)cudaGetLastError();
}

// the arguments of hnsw_greedy (hnsw_greedy.cu), at any d
extern "C" int hnsw_greedy_wide(GreedyLevelsWide levels, const float* vectors, const void* codes,
                                int bits, const float* mins, const float* scales,
                                const float* norms, const float* q, const float* qn,
                                const int* cur_i, const float* cur_d, const int* lowest, int B,
                                int d, int deg, int metric, int* out_i, float* out_d,
                                int* out_stats, void* stream) {
    if (B < 1 || d < 1 || deg < 1 || metric < 0 || metric > 2 || levels.n < 1 ||
        levels.n > WG_LEVELS_MAX)
        return (int)cudaErrorInvalidValue;
    if (bits == 0)
        return launch_greedy_wide(RowsF32{vectors, norms}, levels, q, qn, cur_i, cur_d,
                                  lowest, B, d, deg, metric, out_i, out_d, out_stats, stream);
    if (bits == 8)
        return launch_greedy_wide(
            RowsSq<uint8_t>{nullptr, static_cast<const uint8_t*>(codes), mins, scales, norms},
            levels, q, qn, cur_i, cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats,
            stream);
    if (bits == 16)
        return launch_greedy_wide(
            RowsSq<uint16_t>{nullptr, static_cast<const uint16_t*>(codes), mins, scales, norms},
            levels, q, qn, cur_i, cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats,
            stream);
    return (int)cudaErrorInvalidValue;
}
