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
// gather; gathered_distances' epilogue); K6 reads one
// [deg, d] int8 code block and one [deg, 4] int32 meta block (f32 base,
// scale, norm as bits, the neighbour id) per expanded node, takes the
// exact int32 dot with __dp4a and rounds _approx_dist's epilogue in the
// plain expression's order (__fmul_rn / __fadd_rn, no FMA contraction).
//
// What bounds it on an H100: memory latency, not bandwidth or arithmetic.
// A step reads expand*deg scattered rows (K8, 4d bytes each; K8-SQ, d or
// 2d bytes of codes and 8 of min and scale) or expand
// contiguous blocks (K6, deg*(d+16) bytes each) that depend on the step
// before, and a query takes tens of steps in sequence.
//
// Design: one 128-thread block per query, a persistent loop, and every
// buffer in shared memory (the sorted candidates with an expanded flag,
// the expanded ids, the step's neighbour slots, the filtered results).
// Each query stops on its own: a finished query of the reference is frozen
// too, so the result is the same. The seeds are sorted by (distance,
// position) on entry, which keeps the reference's tie order; from then on
// the buffer stays sorted, so the nearest unexpanded candidates are its
// first unflagged entries (a warp ballot scan), the reference's bound
// reduces to "nothing left to expand", and a merge ranks each old
// entry by the new ones below it and each new one by a binary search of
// the old plus a count of the new, so that no sort runs in the loop. A
// thread scores one neighbour at a time (the whole row from its own
// loads), so a step keeps up to 128 rows in flight. K6 ends with its
// rerank: the r best of the buffer, their f32 rows, an fp32 dot, the
// metric's exact distance (unclamped L2), +inf outside `allowed`, and the
// k smallest by (distance, position). Each query reports how many nodes
// it expanded and how many neighbours it scored.
#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_scorer.cuh"

#define BEAM_THREADS 128
#define BEAM_WARPS (BEAM_THREADS / 32)
#define F_INF __int_as_float(0x7f800000)

struct BeamArgs {
    int B, S, d, deg, ef, loops, expand, exp_cap, slots, k_res, metric;
    const int* seed_i;         // [B, S]
    const float* seed_d;       // [B, S]
    const uint8_t* allowed;    // [cap] or null
    const float* qn;           // [B]
};

// Shared-memory buffers of one query.
struct Smem {
    float* cd; int* ci; int* cx;   // candidate buffer [ef]: distance, id, expanded
    float* td; int* ti; int* tx;   // merge output [max(ef, k_res)]
    float* rd; int* ri;            // filtered results [k_res]
    int* exp;                      // expanded ids [exp_cap]
    int* nb;                       // [slots] neighbour id of each slot (-1: none)
    int* keep;                     // [slots] the slot holds a new neighbour
    int* ni; float* nd; int* ns;   // [slots] new neighbours compacted: id, distance, slot
    int* nu;                       // [slots] the new neighbour is allowed
    int* selp;                     // [expand] buffer positions selected this step
    int* sel;                      // [expand] ids expanded this step (-1: none)
    int* misc;                     // [8 + BEAM_WARPS]
    unsigned char* q;              // the scorer's query bytes
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// Bytes of Smem for these widths; `carve` lays it out in the same order.
__host__ __device__ inline size_t smem_bytes(int ef, int k_res, int exp_cap, int slots,
                                             int expand, size_t qbytes) {
    const int wide = ef > k_res ? ef : k_res;
    return align16(qbytes) + (size_t)4 * (3 * ef + 3 * wide + 2 * k_res + exp_cap + 6 * slots +
                                          2 * expand + 8 + BEAM_WARPS);
}

__device__ inline Smem carve(unsigned char* p, const BeamArgs& a, size_t qbytes) {
    Smem s;
    const int wide = a.ef > a.k_res ? a.ef : a.k_res;
    s.q = p;
    float* f = reinterpret_cast<float*>(p + align16(qbytes));
    s.cd = f; f += a.ef;
    s.ci = reinterpret_cast<int*>(f); f += a.ef;
    s.cx = reinterpret_cast<int*>(f); f += a.ef;
    s.td = f; f += wide;
    s.ti = reinterpret_cast<int*>(f); f += wide;
    s.tx = reinterpret_cast<int*>(f); f += wide;
    s.rd = f; f += a.k_res;
    s.ri = reinterpret_cast<int*>(f); f += a.k_res;
    s.exp = reinterpret_cast<int*>(f); f += a.exp_cap;
    s.nb = reinterpret_cast<int*>(f); f += a.slots;
    s.keep = reinterpret_cast<int*>(f); f += a.slots;
    s.ni = reinterpret_cast<int*>(f); f += a.slots;
    s.nd = f; f += a.slots;
    s.ns = reinterpret_cast<int*>(f); f += a.slots;
    s.nu = reinterpret_cast<int*>(f); f += a.slots;
    s.selp = reinterpret_cast<int*>(f); f += a.expand;
    s.sel = reinterpret_cast<int*>(f); f += a.expand;
    s.misc = reinterpret_cast<int*>(f);
    return s;
}

// K6's neighbour scorer: packed int8 code and meta blocks; the query row
// is kept in f32 (for the rerank) and as int8 words.
struct ServeScorer {
    const int8_t* codes;       // [cap, deg, d]
    const int4* meta;          // [cap, deg] of (base, scale, norm bits, id)
    const float* vectors;      // [cap, d] the rerank store
    const float* norms;        // [cap]
    const float* q;            // [B, d]
    const int8_t* qc;          // [B, d]
    const float* qs;           // [B]
    const float* qsum;         // [B]
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
    __device__ int neighbour(int node, int g, int deg) const {
        return meta[(size_t)node * deg + g].w;
    }
    __device__ float score(const unsigned char* s, int node, int g, int id, int d, int deg,
                           float qnb, int metric) const {
        const size_t blk = (size_t)node * deg + g;
        const int* cw = reinterpret_cast<const int*>(codes + blk * d);
        const int* qw = reinterpret_cast<const int*>(s + (size_t)d * 4);
        const float* sf = reinterpret_cast<const float*>(s + (size_t)d * 5);
        int acc = 0;
        for (int j = 0; j < (d >> 2); ++j) acc = __dp4a(cw[j], qw[j], acc);
        const int4 m = meta[blk];
        // base*q_sum + scale*(qs*dot), as _approx_dist rounds it
        const float qdx = __fadd_rn(__fmul_rn(__int_as_float(m.x), sf[1]),
                                    __fmul_rn(__int_as_float(m.y),
                                              __fmul_rn(sf[0], __int2float_rn(acc))));
        if (metric == 0) return __fadd_rn(__fsub_rn(qnb, __fmul_rn(2.0f, qdx)), __int_as_float(m.z));
        if (metric == 1) return __fsub_rn(1.0f, qdx);
        return -qdx;
    }
    // the exact distance of row `id` for the rerank (no clamp)
    __device__ float exact(const unsigned char* s, int id, int d, float qnb, int metric) const {
        const float4* q4 = reinterpret_cast<const float4*>(s);
        const float4* x4 = reinterpret_cast<const float4*>(vectors + (size_t)id * d);
        float acc = 0.0f;
        for (int j = 0; j < (d >> 2); ++j) {
            const float4 x = x4[j], y = q4[j];
            acc = fmaf(x.x, y.x, acc);
            acc = fmaf(x.y, y.y, acc);
            acc = fmaf(x.z, y.z, acc);
            acc = fmaf(x.w, y.w, acc);
        }
        if (metric == 0) return __fsub_rn(__fadd_rn(qnb, norms[id]), __fmul_rn(2.0f, acc));
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

// Merge the new neighbours (nd, ni)[n_new], where `use` allows (null: all),
// into the sorted buffer (od, oi, ox)[n_old], keeping its n_old smallest by
// (distance, position) with every old entry before every new one: the
// reference's top-k over [old || new]. ox may be null; new entries get 0.
__device__ void merge(float* od, int* oi, int* ox, int n_old, const float* nd, const int* ni,
                      const int* use, int n_new, float* td, int* ti, int* tx) {
    for (int i = threadIdx.x; i < n_old; i += blockDim.x) {
        const float v = od[i];
        int r = i;
        for (int j = 0; j < n_new; ++j) r += (use == nullptr || use[j]) && nd[j] < v;
        if (r < n_old) {
            td[r] = v;
            ti[r] = oi[i];
            if (ox) tx[r] = ox[i];
        }
    }
    for (int j = threadIdx.x; j < n_new; j += blockDim.x) {
        if (use != nullptr && !use[j]) continue;
        const float v = nd[j];
        int lo = 0, hi = n_old;  // old entries <= v
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (od[mid] <= v) lo = mid + 1; else hi = mid;
        }
        int r = lo;
        for (int i = 0; i < n_new && r < n_old; ++i)
            r += (use == nullptr || use[i]) && (nd[i] < v || (nd[i] == v && i < j));
        if (r < n_old) {
            td[r] = v;
            ti[r] = ni[j];
            if (ox) tx[r] = 0;
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_old; i += blockDim.x) {
        od[i] = td[i];
        oi[i] = ti[i];
        if (ox) ox[i] = tx[i];
    }
    __syncthreads();
}

// Compact the kept slots, in slot order, into s.ni / s.ns; returns the count.
__device__ int compact(const Smem& s, int slots) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int total = 0;
    for (int base = 0; base < slots; base += blockDim.x) {
        const int t = base + tid;
        const bool k = t < slots && s.keep[t];
        const unsigned bal = __ballot_sync(0xffffffffu, k);
        if (lane == 0) s.misc[8 + warp] = __popc(bal);
        __syncthreads();
        int off = total;
        for (int w = 0; w < warp; ++w) off += s.misc[8 + w];
        off += __popc(bal & ((1u << lane) - 1u));
        if (k) {
            s.ni[off] = s.nb[t];
            s.ns[off] = t;
        }
        for (int w = 0; w < BEAM_WARPS; ++w) total += s.misc[8 + w];
        __syncthreads();
    }
    return total;
}

// The beam of query b: seeds, then the loop. Leaves the sorted buffer in
// s.cd / s.ci and the filtered results in s.rd / s.ri; returns the numbers
// of expanded nodes and scored neighbours (valid in thread 0).
template <class Scorer>
__device__ int2 run_beam(const BeamArgs& a, const Scorer& sc, const Smem& s, size_t b) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int j = tid; j < a.ef; j += blockDim.x) { s.cd[j] = F_INF; s.ci[j] = -1; s.cx[j] = 0; }
    for (int j = tid; j < a.k_res; j += blockDim.x) { s.rd[j] = F_INF; s.ri[j] = -1; }
    for (int j = tid; j < a.exp_cap; j += blockDim.x) s.exp[j] = -1;
    __syncthreads();
    const int* si = a.seed_i + b * a.S;
    const float* sd = a.seed_d + b * a.S;
    sorted_seeds(sd, si, a.S, s.cd, s.ci);
    if (a.k_res) {
        // the result buffer starts from the first min(S, k_res) seeds that
        // are allowed, sorted as the buffer is
        const int sk = a.S < a.k_res ? a.S : a.k_res;
        for (int j = tid; j < sk; j += blockDim.x) {
            const bool ok = si[j] >= 0 && a.allowed[si[j]];
            s.td[j] = ok ? sd[j] : F_INF;
            s.ti[j] = ok ? si[j] : -1;
        }
        __syncthreads();
        for (int j = tid; j < sk; j += blockDim.x) {
            const float v = s.td[j];
            int r = 0;
            for (int i = 0; i < sk; ++i) r += s.td[i] < v || (s.td[i] == v && i < j);
            s.rd[r] = v;
            s.ri[r] = s.ti[j];
        }
    }
    bool any_seed = false;
    for (int j = tid; j < a.S; j += blockDim.x) any_seed |= si[j] >= 0;
    if (!__syncthreads_or(any_seed)) return make_int2(0, 0);

    const float qnb = a.qn[b];
    int n_exp = 0, n_scored = 0;
    for (int it = 0; it < a.loops; ++it) {
        // the `expand` nearest unexpanded candidates: the buffer is sorted,
        // so they are its first unflagged finite entries
        if (warp == 0) {
            int found = 0;
            for (int base = 0; base < a.ef && found < a.expand; base += 32) {
                const int j = base + lane;
                const bool c = j < a.ef && s.ci[j] >= 0 && !s.cx[j] && s.cd[j] < F_INF;
                unsigned m = __ballot_sync(0xffffffffu, c);
                while (m && found < a.expand) {
                    const int l = __ffs(m) - 1;
                    m &= m - 1;
                    if (lane == 0) s.selp[found] = base + l;
                    ++found;
                }
            }
            if (lane == 0) s.misc[0] = found;
        }
        __syncthreads();
        // the reference's bound (a query is done when its best unexpanded
        // candidate is worse than its worst buffered one, and expands only
        // candidates no worse than that) never binds on a sorted buffer
        // that holds them: a query is done when nothing is left to expand
        const int nsel = s.misc[0];
        if (nsel == 0) break;
        for (int e = tid; e < a.expand; e += blockDim.x) {
            int id = -1;
            if (e < nsel) {
                const int p = s.selp[e];
                id = s.ci[p];
                s.cx[p] = 1;
            }
            s.sel[e] = id;
            s.exp[it * a.expand + e] = id;
        }
        __syncthreads();
        if (tid == 0)
            for (int e = 0; e < a.expand; ++e) n_exp += s.sel[e] >= 0;
        // neighbour slots: not in the buffer and not expanded before
        const int n_listed = (it + 1) * a.expand;
        for (int t = tid; t < a.slots; t += blockDim.x) {
            const int node = s.sel[t / a.deg];
            int id = node >= 0 ? sc.neighbour(node, t % a.deg, a.deg) : -1;
            for (int j = 0; j < a.ef && id >= 0; ++j) if (s.ci[j] == id) id = -1;
            for (int j = 0; j < n_listed && id >= 0; ++j) if (s.exp[j] == id) id = -1;
            s.nb[t] = id;
        }
        __syncthreads();
        // lists of different expanded nodes overlap: the first copy wins
        for (int t = tid; t < a.slots; t += blockDim.x) {
            const int id = s.nb[t];
            bool k = id >= 0;
            for (int u = 0; u < t && k; ++u) k = s.nb[u] != id;
            s.keep[t] = k;
        }
        __syncthreads();
        const int n_new = compact(s, a.slots);
        n_scored += n_new;
        for (int j = tid; j < n_new; j += blockDim.x) {
            const int t = s.ns[j];
            s.nd[j] = sc.score(s.q, s.sel[t / a.deg], t % a.deg, s.ni[j], a.d, a.deg, qnb,
                               a.metric);
            if (a.k_res) s.nu[j] = a.allowed[s.ni[j]] != 0;
        }
        __syncthreads();
        merge(s.cd, s.ci, s.cx, a.ef, s.nd, s.ni, nullptr, n_new, s.td, s.ti, s.tx);
        if (a.k_res) merge(s.rd, s.ri, nullptr, a.k_res, s.nd, s.ni, s.nu, n_new, s.td, s.ti, s.tx);
    }
    return make_int2(n_exp, n_scored);
}

template <class Scorer>
__global__ void __launch_bounds__(BEAM_THREADS)
graph_beam_kernel(BeamArgs a, Scorer sc, float* out_d, int* out_i, float* out_rd,
                  int* out_ri, int* out_exp, int* out_stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Smem s = carve(smem, a, Scorer::query_bytes(a.d));
    const size_t b = blockIdx.x;
    sc.load(b, a.d, s.q);
    __syncthreads();
    const int2 stats = run_beam(a, sc, s, b);
    __syncthreads();
    for (int j = threadIdx.x; j < a.ef; j += blockDim.x) {
        out_d[b * a.ef + j] = s.cd[j];
        out_i[b * a.ef + j] = s.ci[j];
    }
    for (int j = threadIdx.x; j < a.k_res; j += blockDim.x) {
        out_rd[b * a.k_res + j] = s.rd[j];
        out_ri[b * a.k_res + j] = s.ri[j];
    }
    if (out_exp)
        for (int j = threadIdx.x; j < a.exp_cap; j += blockDim.x)
            out_exp[b * a.exp_cap + j] = s.exp[j];
    if (threadIdx.x == 0) reinterpret_cast<int2*>(out_stats)[b] = stats;
}

__global__ void __launch_bounds__(BEAM_THREADS)
serve_beam_kernel(BeamArgs a, ServeScorer sc, const uint8_t* allowed, int r, int k,
                  float* out_d, int* out_i, int* out_stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const Smem s = carve(smem, a, ServeScorer::query_bytes(a.d));
    const size_t b = blockIdx.x;
    sc.load(b, a.d, s.q);
    __syncthreads();
    const int2 stats = run_beam(a, sc, s, b);
    __syncthreads();
    // exact rerank of the r best (the buffer is sorted: its first r)
    const float qnb = a.qn[b];
    for (int j = threadIdx.x; j < r; j += blockDim.x) {
        const int id = s.ci[j];
        const bool bad = id < 0 || (allowed != nullptr && !allowed[id]);
        s.td[j] = bad ? F_INF : sc.exact(s.q, id, a.d, qnb, a.metric);
        s.ti[j] = id;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < r; j += blockDim.x) {
        const float v = s.td[j];
        int rank = 0;
        for (int i = 0; i < r && rank < k; ++i) rank += s.td[i] < v || (s.td[i] == v && i < j);
        if (rank < k) {
            out_d[b * k + rank] = v;
            out_i[b * k + rank] = v < F_INF ? s.ti[j] : -1;
        }
    }
    if (threadIdx.x == 0) reinterpret_cast<int2*>(out_stats)[b] = stats;
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
    a.seed_i = seed_i; a.seed_d = seed_d; a.allowed = allowed; a.qn = qn;
    return a;
}

static bool beam_args_ok(const BeamArgs& a) {
    return a.B >= 0 && a.S >= 1 && a.S <= a.ef && a.expand >= 1 && a.expand <= a.ef &&
           a.loops >= 1 && a.d % 4 == 0 && a.deg >= 1 && a.k_res >= 0 &&
           (a.k_res == 0 || a.allowed != nullptr) && a.metric >= 0 && a.metric <= 2;
}

template <class K>
static int set_smem(K kernel, size_t smem) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) cudaGetLastError();  // clear it for the next launch
    return (int)e;
}

template <class Scorer>
static int launch_graph_beam(const BeamArgs& a, const Scorer& sc, float* out_d, int* out_i,
                             float* out_rd, int* out_ri, int* out_exp, int* out_stats,
                             void* stream) {
    if (!beam_args_ok(a) || (a.k_res && (out_rd == nullptr || out_ri == nullptr)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(a.ef, a.k_res, a.exp_cap, a.slots, a.expand,
                                   Scorer::query_bytes(a.d));
    int e = set_smem(graph_beam_kernel<Scorer>, smem);
    if (e) return e;
    graph_beam_kernel<Scorer><<<a.B, BEAM_THREADS, smem, (cudaStream_t)stream>>>(
        a, sc, out_d, out_i, out_rd, out_ri, out_exp, out_stats);
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
    return launch_graph_beam(a, GraphScorer{adj, vectors, norms, q}, out_d, out_i, out_rd,
                             out_ri, out_exp, out_stats, stream);
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
    if (bits == 8)
        return launch_graph_beam(
            a, SqScorer<uint8_t>{adj, static_cast<const uint8_t*>(codes), mins, scales, norms, q},
            out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
    if (bits == 16)
        return launch_graph_beam(
            a, SqScorer<uint16_t>{adj, static_cast<const uint16_t*>(codes), mins, scales, norms,
                                  q},
            out_d, out_i, out_rd, out_ri, out_exp, out_stats, stream);
    return (int)cudaErrorInvalidValue;
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
    if (!beam_args_ok(a) || rerank < 1 || rerank > ef || k < 1 || k > rerank)
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(a.ef, 0, a.exp_cap, a.slots, a.expand,
                                   ServeScorer::query_bytes(d));
    int e = set_smem(serve_beam_kernel, smem);
    if (e) return e;
    serve_beam_kernel<<<B, BEAM_THREADS, smem, (cudaStream_t)stream>>>(
        a, ServeScorer{codes, reinterpret_cast<const int4*>(meta), vectors, norms, q, qc, qs, qsum},
        allowed, rerank, k, out_d, out_i, out_stats);
    return (int)cudaGetLastError();
}
