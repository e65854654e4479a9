// K1 ivf_probe_f32 and K4 ivf_probe_sq8: the fused IVF probe.
//
// Replaces: turdb_tpu/models/ivf.py ivf_search_impl, the probe of both
// stores. K1 is the f32 branch (the [B,P,L,d] block gather, the PRECISE
// fp32 dot, the L2 / cosine / IP epilogue); K4 is the sq8 branch (the
// s8 x s8 -> s32 einsum over the int8 codes and the dequantize epilogue
// qn - 2*(m'*sum(q) + scale*(qs*dot)) + pnorms, L2 whatever the index's
// metric, as the reference computes it), and the cell-probe seeding of
// turdb_tpu/models/hnsw_serve.py serve_search_impl, whose _approx_dist
// epilogue is that L2, COSINE 1 - q.x or IP -q.x. Both fuse the dead /
// unallowed mask and the selection that follows: the top copies*k,
// mask_duplicates from turdb_tpu/ops/topk.py and the final top-k ("top-k
// mode"), or the r best lanes that the exact rerank gathers ("candidate
// mode").
//
// What bounds them on an H100: device-memory bandwidth. A query reads its
// P probed cells of L rows (K1: 4d bytes a row, 2 flops a byte; K4: d
// bytes of codes plus 12 of metadata, 2 int8 ops a byte), far below what
// the fp32 or int8 units could consume.
//
// Design: the query row sits in shared memory (f32, or the int8 codes as
// 32-bit words); each warp scores one stored row at a time with 16-byte
// (K1) or 4-byte (K4, __dp4a with an exact int32 sum) loads and a shuffle
// reduction. The epilogues round as the plain expressions do
// (__fmul_rn / __fadd_rn, no FMA contraction). Empty, dead and unallowed
// lanes are never read: they are +inf. A block keeps the keys and ids of at
// most `chunk` lanes (the wrapper's PROBE_CHUNK_LANES, 32 KB) in shared
// memory and selects its m best by (distance, lane position) with
// block_select (select.cuh). When P*L fits one chunk, that block finishes
// the query itself. Wider probes (the hard row: P = 512, L = 128) run one
// block per (query, chunk): each writes its m best (key, lane position,
// id) to a scratch row, and a merge kernel selects the m best of those by
// (key, column). Chunks are laid out in lane order and each chunk's
// winners are sorted, so a lower column is a lower lane: the tie order is
// the reference's. The tail then either drops later copies of an id (the
// first copy wins) and writes the first k survivors, or writes all m
// winners with their flat store positions cell*L + lane.
#include "select.cuh"

#include <climits>

enum { MODE_TOPK = 0, MODE_CAND = 1 };

struct ProbeArgs {
    const int* cells;          // [B, P] probed cells
    int B, P, L, d;
    const int* members;        // [NB, L] ids, -1 empty
    const uint8_t* alive;      // [NB, L]
    const uint8_t* allowed;    // [NB, L] or null
    const float* qn;           // [B]
    const float* pnorms;       // [NB, L]
    int k, m, replicated, mode;
    int chunk, nchunks;        // lanes per block, blocks per query
    uint32_t* sc_key;          // [B, nchunks * m] scratch when nchunks > 1
    int* sc_pos;
    int* sc_id;
    float* out_d;              // [B, k] (top-k) or [B, m] (candidates)
    int* out_i;
    int* out_pos;              // [B, m] flat positions (candidates)
};

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// K1's row scorer: fp32 rows, metric L2 / cosine / IP.
struct F32Scorer {
    const float* q;            // [B, d]
    const float* pvecs;        // [NB, L, d]
    int metric;
    __host__ __device__ static size_t query_bytes(int d) { return (size_t)d * 4; }
    __device__ void load(size_t b, int d, unsigned char* s) const {
        float* sq = reinterpret_cast<float*>(s);
        for (int i = threadIdx.x; i < d; i += blockDim.x) sq[i] = q[b * d + i];
    }
    // warp-collective: every lane returns the distance of `row`
    __device__ float score(const unsigned char* s, size_t row, int lane,
                           float qnb, const ProbeArgs& a) const {
        const float* sq = reinterpret_cast<const float*>(s);
        const float4* xr = reinterpret_cast<const float4*>(pvecs + row * a.d);
        float acc = 0.0f;
        for (int j = lane; j < (a.d >> 2); j += 32) {
            const float4 x = xr[j];
            acc = fmaf(x.x, sq[4 * j], acc);
            acc = fmaf(x.y, sq[4 * j + 1], acc);
            acc = fmaf(x.z, sq[4 * j + 2], acc);
            acc = fmaf(x.w, sq[4 * j + 3], acc);
        }
        acc = warp_sum(acc);
        if (metric == 0) return __fsub_rn(__fadd_rn(qnb, a.pnorms[row]), __fmul_rn(2.0f, acc));
        if (metric == 1) return __fsub_rn(1.0f, acc);
        return -acc;
    }
};

// K4's row scorer: centred int8 codes with the row's m' = min + 128*scale
// and scale; the query is symmetric int8 (qc, qs) with q_sum = sum(q).
struct Sq8Scorer {
    const int8_t* qc;          // [B, d]
    const float* qs;           // [B]
    const float* qsum;         // [B]
    const int8_t* codes;       // [NB, L, d]
    const float* mins;         // [NB, L] m'
    const float* scales;       // [NB, L]
    int metric;                // 0 L2, 1 COSINE, 2 IP
    __host__ __device__ static size_t query_bytes(int d) { return (size_t)d + 8; }
    __device__ void load(size_t b, int d, unsigned char* s) const {
        int* sw = reinterpret_cast<int*>(s);
        const int* qw = reinterpret_cast<const int*>(qc + b * d);
        for (int i = threadIdx.x; i < (d >> 2); i += blockDim.x) sw[i] = qw[i];
        float* sf = reinterpret_cast<float*>(s + d);
        if (threadIdx.x == 0) { sf[0] = qs[b]; sf[1] = qsum[b]; }
    }
    __device__ float score(const unsigned char* s, size_t row, int lane,
                           float qnb, const ProbeArgs& a) const {
        const int* sw = reinterpret_cast<const int*>(s);
        const float* sf = reinterpret_cast<const float*>(s + a.d);
        const int* cr = reinterpret_cast<const int*>(codes + row * a.d);
        int acc = 0;
        for (int j = lane; j < (a.d >> 2); j += 32) acc = __dp4a(cr[j], sw[j], acc);
        acc = warp_sum(acc);
        // mins*q_sum + scales*(qs*dot), then (qn - 2*that) + pnorms
        const float qdx = __fadd_rn(__fmul_rn(mins[row], sf[1]),
                                    __fmul_rn(scales[row], __fmul_rn(sf[0], __int2float_rn(acc))));
        if (metric == 1) return __fsub_rn(1.0f, qdx);
        if (metric == 2) return -qdx;
        return __fadd_rn(__fsub_rn(qnb, __fmul_rn(2.0f, qdx)), a.pnorms[row]);
    }
};

// Winner arrays in dynamic shared memory after the SelectScratch: key,
// lane position (global in P*L), id and a flag, sel_pow2(m) entries each.
struct Winners {
    uint32_t* key;
    int* pos;
    int* id;
    int* flag;
    __device__ Winners(unsigned char* smem, int m) {
        const int s = sel_pow2(m);
        key = reinterpret_cast<uint32_t*>(reinterpret_cast<SelectScratch*>(smem) + 1);
        pos = reinterpret_cast<int*>(key + s);
        id = pos + s;
        flag = id + s;
    }
    __host__ __device__ static size_t bytes(int m) {
        return sizeof(SelectScratch) + (size_t)sel_pow2(m) * 4 * sizeof(int);
    }
};

// The m winners of query b, sorted by (key, lane position) -> the output.
__device__ void probe_tail(const ProbeArgs& a, size_t b, Winners w) {
    const int tid = threadIdx.x;
    if (a.mode == MODE_CAND) {
        for (int i = tid; i < a.m; i += blockDim.x) {
            const int g = w.pos[i];
            const int p = g / a.L;
            const size_t o = b * a.m + i;
            a.out_d[o] = key2f(w.key[i]);
            a.out_i[o] = w.id[i];
            a.out_pos[o] = a.cells[b * a.P + p] * a.L + (g - p * a.L);
        }
        return;
    }
    for (int i = tid; i < a.m; i += blockDim.x) {
        bool keep = w.key[i] < INF_KEY;
        if (keep && a.replicated) {
            const int id = w.id[i];
            for (int j = 0; j < i && keep; ++j) keep = w.id[j] != id;
        }
        w.flag[i] = keep;
    }
    __syncthreads();
    if (tid == 0) {
        int o = 0;
        for (int i = 0; i < a.m && o < a.k; ++i) {
            if (w.flag[i]) {
                a.out_d[b * a.k + o] = key2f(w.key[i]);
                a.out_i[b * a.k + o] = w.id[i];
                ++o;
            }
        }
        for (; o < a.k; ++o) {
            a.out_d[b * a.k + o] = __int_as_float(0x7f800000);
            a.out_i[b * a.k + o] = -1;
        }
    }
}

template <class Scorer>
__global__ void __launch_bounds__(SEL_THREADS)
probe_chunk_kernel(ProbeArgs a, Scorer sc) {
    extern __shared__ __align__(16) unsigned char smem[];
    Winners w(smem, a.m);
    unsigned char* s_q = smem + Winners::bytes(a.m);
    uint32_t* s_lkey = reinterpret_cast<uint32_t*>(s_q + ((Scorer::query_bytes(a.d) + 15) & ~(size_t)15));
    int* s_lid = reinterpret_cast<int*>(s_lkey + a.chunk);

    const size_t b = blockIdx.x / a.nchunks;
    const int chunk = blockIdx.x % a.nchunks;
    const int start = chunk * a.chunk;
    const int n = min(a.chunk, a.P * a.L - start);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    sc.load(b, a.d, s_q);
    const float qnb = a.qn[b];
    __syncthreads();

    for (int i = warp; i < n; i += nwarps) {
        const int pos = start + i;
        const int p = pos / a.L;
        const size_t row = (size_t)a.cells[b * a.P + p] * a.L + (pos - p * a.L);
        const int mem = a.members[row];
        const bool live = mem >= 0 && a.alive[row] != 0 &&
                          (a.allowed == nullptr || a.allowed[row] != 0);
        uint32_t key = INF_KEY;
        if (live) key = f2key(sc.score(s_q, row, lane, qnb, a));  // warp-uniform
        if (lane == 0) {
            s_lkey[i] = key;
            s_lid[i] = mem;
        }
    }
    __syncthreads();

    const int msel = min(a.m, n);
    block_select(ArrayKey{s_lkey}, n, msel, w.key, w.pos, reinterpret_cast<SelectScratch*>(smem));
    for (int i = tid; i < msel; i += blockDim.x) {
        w.id[i] = s_lid[w.pos[i]];
        w.pos[i] += start;
    }
    __syncthreads();
    if (a.nchunks == 1) {
        probe_tail(a, b, w);
        return;
    }
    // a chunk of a wide probe: its m best (padded past its lanes with keys
    // above every real one) go to the scratch row for the merge
    const size_t base = (b * a.nchunks + chunk) * a.m;
    for (int i = tid; i < a.m; i += blockDim.x) {
        const bool v = i < msel;
        a.sc_key[base + i] = v ? w.key[i] : 0xffffffffu;
        a.sc_pos[base + i] = v ? w.pos[i] : INT_MAX;
        a.sc_id[base + i] = v ? w.id[i] : -1;
    }
}

__global__ void __launch_bounds__(SEL_THREADS)
probe_merge_kernel(ProbeArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    Winners w(smem, a.m);
    const size_t b = blockIdx.x;
    const int ncand = a.nchunks * a.m;
    const size_t row = b * ncand;
    block_select(ArrayKey{a.sc_key + row}, ncand, a.m, w.key, w.pos,
                 reinterpret_cast<SelectScratch*>(smem));
    for (int i = threadIdx.x; i < a.m; i += blockDim.x) {
        const int col = w.pos[i];
        w.id[i] = a.sc_id[row + col];
        w.pos[i] = a.sc_pos[row + col];
    }
    __syncthreads();
    probe_tail(a, b, w);
}

template <class Scorer>
static int launch_probe(ProbeArgs a, Scorer sc, cudaStream_t stream) {
    const int lanes = a.P * a.L;
    if (a.k < 1 || a.m < a.k || a.m > SEL_MAX || a.m > lanes || a.chunk < 1 ||
        a.d % 4 != 0 || (a.mode == MODE_CAND && a.k != a.m))
        return (int)cudaErrorInvalidValue;
    a.chunk = min(a.chunk, lanes);
    a.nchunks = (lanes + a.chunk - 1) / a.chunk;
    if (a.nchunks > 1 && (a.sc_key == nullptr || a.sc_pos == nullptr || a.sc_id == nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem = Winners::bytes(a.m) + ((Scorer::query_bytes(a.d) + 15) & ~(size_t)15) +
                        (size_t)a.chunk * 2 * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        probe_chunk_kernel<Scorer>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch would report it
        return (int)e;
    }
    probe_chunk_kernel<Scorer><<<a.B * a.nchunks, SEL_THREADS, smem, stream>>>(a, sc);
    e = cudaGetLastError();
    if (e != cudaSuccess || a.nchunks == 1) return (int)e;
    probe_merge_kernel<<<a.B, SEL_THREADS, Winners::bytes(a.m), stream>>>(a);
    return (int)cudaGetLastError();
}

static ProbeArgs probe_args(const int* cells, int B, int P, const float* pnorms,
                            const int* members, const uint8_t* alive, const uint8_t* allowed,
                            int L, int d, const float* qn, int k, int m, int replicated,
                            int mode, int chunk, uint32_t* sc_key, int* sc_pos, int* sc_id,
                            float* out_d, int* out_i, int* out_pos) {
    ProbeArgs a;
    a.cells = cells; a.B = B; a.P = P; a.L = L; a.d = d;
    a.members = members; a.alive = alive; a.allowed = allowed;
    a.qn = qn; a.pnorms = pnorms;
    a.k = k; a.m = m; a.replicated = replicated; a.mode = mode;
    a.chunk = chunk; a.nchunks = 1;
    a.sc_key = sc_key; a.sc_pos = sc_pos; a.sc_id = sc_id;
    a.out_d = out_d; a.out_i = out_i; a.out_pos = out_pos;
    return a;
}

extern "C" int ivf_probe_f32(const float* q, const float* qn, const int* cells, int B, int P,
                             const float* pvecs, const float* pnorms, const int* members,
                             const uint8_t* alive, const uint8_t* allowed, int L, int d,
                             int metric, int k, int m, int replicated, int mode, int chunk,
                             uint32_t* sc_key, int* sc_pos, int* sc_id, float* out_d,
                             int* out_i, int* out_pos, void* stream) {
    ProbeArgs a = probe_args(cells, B, P, pnorms, members, alive, allowed, L, d, qn, k, m,
                             replicated, mode, chunk, sc_key, sc_pos, sc_id, out_d, out_i,
                             out_pos);
    return launch_probe(a, F32Scorer{q, pvecs, metric}, (cudaStream_t)stream);
}

extern "C" int ivf_probe_sq8(const int8_t* qc, const float* qs, const float* qsum,
                             const float* qn, const int* cells, int B, int P,
                             const int8_t* codes, const float* mins, const float* scales,
                             const float* pnorms, const int* members, const uint8_t* alive,
                             const uint8_t* allowed, int L, int d, int metric, int k, int m,
                             int replicated, int mode, int chunk, uint32_t* sc_key,
                             int* sc_pos, int* sc_id, float* out_d, int* out_i,
                             int* out_pos, void* stream) {
    if (metric < 0 || metric > 2) return (int)cudaErrorInvalidValue;
    ProbeArgs a = probe_args(cells, B, P, pnorms, members, alive, allowed, L, d, qn, k, m,
                             replicated, mode, chunk, sc_key, sc_pos, sc_id, out_d, out_i,
                             out_pos);
    return launch_probe(a, Sq8Scorer{qc, qs, qsum, codes, mins, scales, metric},
                        (cudaStream_t)stream);
}
