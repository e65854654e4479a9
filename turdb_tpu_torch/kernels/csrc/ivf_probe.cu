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
// the fp32 or int8 units could consume. What held them back was latency:
// a warp that scores one row at a time waits on three or four dependent
// reads a row (cell, member, flags, row, metadata).
//
// Query-major pass (K1, and K4 up to one chunk of lanes): a block takes a
// query (or one chunk of a wide query's lanes), with the query row and its
// cells in shared memory. A warp walks its lanes in runs of 32: lane t
// reads lane t's member, flags and metadata in one coalesced step, a run
// ahead of the rows it scores; a ballot ranks the live lanes into shared
// memory, and the warp scores them R at a time (K1: 8, K4: 16), every row
// load issued before any sum. A K1 row is summed as before (lane j takes
// float4 j, j+32, ... in one fmaf chain, so its bits are K1's of old); K4
// reads rows of 16-byte words eight lanes a row (four rows a load
// instruction; rows of other widths a warp a row). The partial sums meet
// in a transposing butterfly: at each of the offsets 16, 8, ... a lane
// keeps half of its rows and adds its partner's copy of them, so every
// addition pairs the same two values as the plain butterfly of one row
// would, and the lane ends holding one row's sum. The epilogues round as
// the plain expressions do (__fmul_rn / __fadd_rn, no FMA contraction).
// Rows of empty, dead and unallowed lanes are never read: they are +inf.
// A block keeps the keys
// and ids of at most `chunk` lanes (the wrapper's PROBE_CHUNK_LANES) in
// shared memory and selects its m best by (distance, lane position) with
// block_select (select.cuh). When P*L fits one chunk, that block finishes
// the query itself. Wider probes run one block per (query, chunk): each
// writes its m best (key, lane position, id) to a scratch row, and a merge
// kernel selects the m best of those by (key, column). Chunks are laid out
// in lane order and each chunk's winners are sorted, so a lower column is a
// lower lane: the tie order is the reference's.
//
// Cell-major pass (K4 for probes wider than one chunk, the wrapper's
// probe_route): query-major, the hard row (P = 256) reads every probed cell
// once per query that probes it, about 17 times. Here the (query, probe
// index) pairs are grouped by cell on the device (a histogram with atomics,
// one scan, a scatter), and one block per cell reads the cell's codes and
// lane metadata into shared memory once, then scores its pairs in tiles of
// 16 queries with mma.sync.m16n8k32 s8 x s8 -> s32 (exact integer sums,
// so the distances are the query-major ones bit for bit). Each distance
// goes to a [B, P*L] f32 buffer at column p*L + lane, the query's own lane
// order; K2 (topk_rows.cu) selects each row's m best by (value, position),
// and a tail kernel writes the outputs as the query-major pass does. A
// query that lists one cell twice has two pairs, and both are scored.
//
// Every path ends in probe_tail: it either drops later copies of an id
// (the first copy wins) and writes the first k survivors, or writes all m
// winners with their flat store positions cell*L + lane.
#include "row_sums.cuh"
#include "select.cuh"
#include "sq8_rows.cuh"

#include <climits>

enum { MODE_TOPK = 0, MODE_CAND = 1 };

#define FULL_MASK 0xffffffffu
#define CELL_TILE 16        // queries a tile: the m of mma.m16n8k32
#define CELL_THREADS 128    // a cell block: four warps, each every fourth 8-lane tile
// The query-major kernels' rows in flight a warp (K1; K4 in 16-byte words,
// eight lanes a row) and the blocks an SM must hold of each (a register
// cap: K1 at 4 spills). K4's word layout (rows not in 16-byte words) keeps
// 8 rows in flight under K1's cap.
constexpr int PROBE_R_F32 = 8, PROBE_R_SQ8 = 16;
constexpr int PROBE_MIN_BLOCKS_F32 = 3, PROBE_MIN_BLOCKS_SQ8 = 4;

// Built with -DPROBE_PHASE_CLOCKS (scripts/exp_torch_probe_kernels.py),
// thread 0 of every block adds the cycles of its phases to probe_clocks:
// query-major 0 the query and cells, 1 the scoring, 2 the selection, 3 the
// outputs, 4 counts the blocks; cell-major 5 the lane metadata, 6 the
// tiles (codes and query copies, mma, writes), 7 counts the blocks with
// pairs. ivf_probe_clocks reads and clears them.
#ifdef PROBE_PHASE_CLOCKS
__device__ unsigned long long probe_clocks[8];
#define PROBE_MARK(i)                                                                 \
    do {                                                                              \
        if (threadIdx.x == 0) {                                                       \
            const long long now = clock64();                                          \
            atomicAdd(probe_clocks + (i), (unsigned long long)(now - mark));          \
            mark = now;                                                               \
        }                                                                             \
    } while (0)
#define PROBE_COUNT(i) \
    do {               \
        if (threadIdx.x == 0) atomicAdd(probe_clocks + (i), 1ull); \
    } while (0)
#define PROBE_MARK_START long long mark = clock64()

extern "C" int ivf_probe_clocks(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, probe_clocks, sizeof(probe_clocks));
    if (e == cudaSuccess) {
        const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        e = cudaMemcpyToSymbol(probe_clocks, zero, sizeof(zero));
    }
    return (int)e;
}
#else
#define PROBE_MARK(i) \
    do {              \
    } while (0)
#define PROBE_COUNT(i) \
    do {               \
    } while (0)
#define PROBE_MARK_START \
    do {                 \
    } while (0)
#endif

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
    int chunk_cells;           // cells a chunk's lanes touch, at most
    uint32_t* sc_key;          // [B, nchunks * m] scratch when nchunks > 1
    int* sc_pos;
    int* sc_id;
    float* out_d;              // [B, k] (top-k) or [B, m] (candidates)
    int* out_i;
    int* out_pos;              // [B, m] flat positions (candidates)
};

// K1's row scorer: fp32 rows, metric L2 / cosine / IP.
struct F32Scorer : RowLayout<PROBE_R_F32, 32> {
    static constexpr int MIN_BLOCKS = PROBE_MIN_BLOCKS_F32;
    using Acc = float;
    struct Meta { float pnorm; };
    const float* q;            // [B, d]
    const float* pvecs;        // [NB, L, d]
    int metric;
    __host__ __device__ static size_t query_bytes(int d) { return (size_t)d * 4; }
    __device__ void load(size_t b, int d, unsigned char* s) const {
        float* sq = reinterpret_cast<float*>(s);
        for (int i = threadIdx.x; i < d; i += blockDim.x) sq[i] = q[b * d + i];
    }
    __device__ Meta meta(int row, const ProbeArgs& a) const {
        return {metric == 0 ? a.pnorms[row] : 0.0f};
    }
    __device__ static Meta shfl(Meta m, int src) { return {__shfl_sync(FULL_MASK, m.pnorm, src)}; }
    // this lane's partial dots of rows[0, R) (-1: none), each in K1's order:
    // float4 lane, lane + 32, ..., four fmaf a float4
    __device__ void partial(const unsigned char* s, const int (&rows)[R], int lane, int d,
                            float (&v)[R]) const {
        const float* sq = reinterpret_cast<const float*>(s);
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = 0.0f;
        for (int j = lane; j < (d >> 2); j += 32) {
            float4 x[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
                x[r] = rows[r] >= 0
                           ? __ldg(reinterpret_cast<const float4*>(pvecs + (size_t)rows[r] * d) + j)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float q0 = sq[4 * j], q1 = sq[4 * j + 1], q2 = sq[4 * j + 2], q3 = sq[4 * j + 3];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                v[r] = fmaf(x[r].x, q0, v[r]);
                v[r] = fmaf(x[r].y, q1, v[r]);
                v[r] = fmaf(x[r].z, q2, v[r]);
                v[r] = fmaf(x[r].w, q3, v[r]);
            }
        }
    }
    __device__ float distance(float dot, float qnb, const unsigned char*, int, Meta m) const {
        if (metric == 0) return __fsub_rn(__fadd_rn(qnb, m.pnorm), __fmul_rn(2.0f, dot));
        if (metric == 1) return __fsub_rn(1.0f, dot);
        return -dot;
    }
};

// K4's row scorers: centred int8 codes with the row's m' = min + 128*scale
// and scale; the query is symmetric int8 (qc, qs) with q_sum = sum(q).
struct Sq8Data {
    using Acc = int;
    struct Meta { float mins, scales, pnorm; };
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
    __device__ Meta meta(int row, const ProbeArgs& a) const {
        return {mins[row], scales[row], metric == 0 ? a.pnorms[row] : 0.0f};
    }
    __device__ static Meta shfl(Meta m, int src) {
        return {__shfl_sync(FULL_MASK, m.mins, src), __shfl_sync(FULL_MASK, m.scales, src),
                __shfl_sync(FULL_MASK, m.pnorm, src)};
    }
    __device__ float distance(int dot, float qnb, const unsigned char* s, int d, Meta m) const {
        const float* sf = reinterpret_cast<const float*>(s + d);
        return sq8_distance(dot, m.mins, m.scales, m.pnorm, sf[0], sf[1], qnb, metric);
    }
};

// Rows of any width d % 4 == 0: a warp a row, lane j taking code words
// j, j + 32, ... (exact int32 sums, in any order).
struct Sq8Words : Sq8Data, RowLayout<8, 32> {
    static constexpr int MIN_BLOCKS = PROBE_MIN_BLOCKS_F32;
    __device__ void partial(const unsigned char* s, const int (&rows)[SLOTS], int lane, int d,
                            int (&v)[SLOTS]) const {
        sq8_words_partial<SLOTS, 1>(codes, reinterpret_cast<const int*>(s), rows, lane, d, v);
    }
};

// Rows in 16-byte words (d % 16 == 0, codes 16-byte aligned): eight lanes
// a row, lane j of a group taking words j, j + 8, ...; a warp reads four
// rows an instruction and holds R rows in R / 4 16-byte registers a lane.
struct Sq8Groups : Sq8Data, RowLayout<PROBE_R_SQ8, 8> {
    static constexpr int MIN_BLOCKS = PROBE_MIN_BLOCKS_SQ8;
    __device__ void partial(const unsigned char* s, const int (&rows)[SLOTS], int lane, int d,
                            int (&v)[SLOTS]) const {
        sq8_groups_partial<SLOTS, 1>(codes, reinterpret_cast<const int4*>(s), rows, lane, d, v);
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

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

template <class Scorer>
__global__ void __launch_bounds__(SEL_THREADS, Scorer::MIN_BLOCKS)
probe_chunk_kernel(ProbeArgs a, Scorer sc) {
    constexpr int R = Scorer::R;
    extern __shared__ __align__(16) unsigned char smem[];
    Winners w(smem, a.m);
    unsigned char* s_q = smem + Winners::bytes(a.m);
    uint32_t* s_lkey = reinterpret_cast<uint32_t*>(s_q + align16(Scorer::query_bytes(a.d)));
    int* s_lid = reinterpret_cast<int*>(s_lkey + a.chunk);
    int* s_cell = s_lid + a.chunk;
    // a warp's live rows and their run lanes, in order
    int* s_brow = s_cell + a.chunk_cells + 64 * (threadIdx.x >> 5);
    int* s_bsrc = s_brow + 32;

    const size_t b = blockIdx.x / a.nchunks;
    const int chunk = blockIdx.x % a.nchunks;
    const int start = chunk * a.chunk;
    const int n = min(a.chunk, a.P * a.L - start);
    const int p0 = start / a.L;
    const int ncell = (start + n - 1) / a.L - p0 + 1;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    PROBE_MARK_START;
    sc.load(b, a.d, s_q);
    for (int i = tid; i < ncell; i += blockDim.x) s_cell[i] = a.cells[b * a.P + p0 + i];
    const float qnb = a.qn[b];
    __syncthreads();
    PROBE_MARK(0);

    // a run of 32 lanes: every lane's member, flags and metadata in one
    // step, fetched a run ahead, so that no row read waits on its own
    // member check and the next run's metadata is in flight under the rows
    struct Run {
        int row = -1, mem = -1;
        bool live = false;
        typename Scorer::Meta meta{};
    };
    auto fetch = [&](int base) {
        Run f;
        const int i = base + lane;
        if (i < n) {
            const int pos = start + i;
            const int p = pos / a.L;
            f.row = s_cell[p - p0] * a.L + (pos - p * a.L);
            f.mem = a.members[f.row];
            const uint8_t al = a.alive[f.row];
            const uint8_t ok = a.allowed == nullptr ? (uint8_t)1 : a.allowed[f.row];
            f.meta = sc.meta(f.row, a);
            f.live = f.mem >= 0 && al != 0 && ok != 0;
        }
        return f;
    };
    const int stride = nwarps * 32;
    Run cur = fetch(warp * 32);
    for (int base = warp * 32; base < n; base += stride) {
        const Run next = base + stride < n ? fetch(base + stride) : Run{};
        const int i = base + lane;
        if (i < n) {
            s_lid[i] = cur.mem;
            if (!cur.live) s_lkey[i] = INF_KEY;
        }
        // the live lanes in order: batch row r of the run is its r-th live lane
        const unsigned live = __ballot_sync(FULL_MASK, cur.live);
        if (cur.live) {
            const int r = __popc(live & ((1u << lane) - 1u));
            s_brow[r] = cur.row;
            s_bsrc[r] = lane;
        }
        __syncwarp();
        const int nlive = __popc(live);
        for (int b0 = 0; b0 < nlive; b0 += R) {
            // R rows in flight at once
            int rows[Scorer::SLOTS];
#pragma unroll
            for (int j = 0; j < Scorer::SLOTS; ++j) {
                const int r = b0 + Scorer::slot_row(j, lane);
                rows[j] = r < nlive ? s_brow[r] : -1;
            }
            typename Scorer::Acc v[Scorer::SLOTS];
            sc.partial(s_q, rows, lane, a.d, v);
            const auto dot = reduce_rows<Scorer::SLOTS, Scorer::W>(v, lane);
            const int h = b0 + Scorer::held_row(lane);
            const int src = h < nlive ? s_bsrc[h] : 0;
            const typename Scorer::Meta ms = Scorer::shfl(cur.meta, src);
            if (Scorer::writer(lane) && h < nlive)
                s_lkey[base + src] = f2key(sc.distance(dot, qnb, s_q, a.d, ms));
        }
        __syncwarp();   // the next run reuses the batch rows
        cur = next;
    }
    __syncthreads();
    PROBE_MARK(1);

    const int msel = min(a.m, n);
    block_select(ArrayKey{s_lkey}, n, msel, w.key, w.pos, reinterpret_cast<SelectScratch*>(smem));
    for (int i = tid; i < msel; i += blockDim.x) {
        w.id[i] = s_lid[w.pos[i]];
        w.pos[i] += start;
    }
    __syncthreads();
    PROBE_MARK(2);
    PROBE_COUNT(4);
    if (a.nchunks == 1) {
        probe_tail(a, b, w);
        PROBE_MARK(3);
        return;
    }
    // a chunk of a wide probe: its m best (padded past its lanes with keys
    // above every real one) go to the scratch row for the merge
    const size_t sbase = (b * a.nchunks + chunk) * a.m;
    for (int i = tid; i < a.m; i += blockDim.x) {
        const bool v = i < msel;
        a.sc_key[sbase + i] = v ? w.key[i] : 0xffffffffu;
        a.sc_pos[sbase + i] = v ? w.pos[i] : INT_MAX;
        a.sc_id[sbase + i] = v ? w.id[i] : -1;
    }
    PROBE_MARK(3);
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

static int check_args(const ProbeArgs& a) {
    const long long lanes = (long long)a.P * a.L;
    if (a.k < 1 || a.m < a.k || a.m > SEL_MAX || a.m > lanes || lanes > INT_MAX ||
        a.d % 4 != 0 || (a.mode == MODE_CAND && a.k != a.m))
        return (int)cudaErrorInvalidValue;
    return 0;
}

template <class Scorer>
static int launch_probe(ProbeArgs a, Scorer sc, cudaStream_t stream) {
    if (check_args(a) != 0 || a.chunk < 1) return (int)cudaErrorInvalidValue;
    const int lanes = a.P * a.L;
    a.chunk = min(a.chunk, lanes);
    a.nchunks = (lanes + a.chunk - 1) / a.chunk;
    a.chunk_cells = min(a.P, a.chunk / a.L + 2);
    if (a.nchunks > 1 && (a.sc_key == nullptr || a.sc_pos == nullptr || a.sc_id == nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem = Winners::bytes(a.m) + align16(Scorer::query_bytes(a.d)) +
                        ((size_t)a.chunk * 2 + a.chunk_cells + 64 * (SEL_THREADS / 32)) * sizeof(int);
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

// ---------------------------------------------------------------------------
// K4's cell-major pass
// ---------------------------------------------------------------------------

struct CellWork {
    int nb;                    // cells of the store
    int* count;                // [nb] pairs probing each cell
    int* cursor;               // [nb] a cell's start in `list`, its end after the scatter
    int* list;                 // [B*P] pair indices b*P + p, grouped by cell
    float* dist;               // [B, P*L]
};

// shared-memory row of a cell's codes or a query: d rounded up to the k of
// one mma (32), plus 16 bytes so that the fragment loads hit 32 banks
__host__ __device__ inline int cell_stride(int d) { return ((d + 31) & ~31) + 16; }

// codes [lp][stride], the tile's queries [16][stride], lane metadata
// (m', scale, pnorm, live: 16 bytes a lane), the tile's query scalars and
// output offsets
__host__ __device__ inline size_t cell_smem(int L, int d) {
    const int lp = (L + 7) & ~7;
    return (size_t)(lp + CELL_TILE) * cell_stride(d) + (size_t)lp * 16 + CELL_TILE * 32;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void pair_count_kernel(const int* __restrict__ cells, int npairs, int* count) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < npairs) atomicAdd(&count[cells[i]], 1);
}

// one block of 1024: cursor[c] = the pairs of the cells before c, in tiles
// of 1024 cells (16 tiles' counts read at once), each tile a block scan
__global__ void __launch_bounds__(1024) pair_scan_kernel(const int* __restrict__ count, int nb,
                                                         int* __restrict__ cursor) {
    __shared__ int warp_tot[32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int carry = 0;
    for (int base = 0; base < nb; base += 16 * 1024) {
        int v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            const int c = base + u * 1024 + tid;
            v[u] = c < nb ? count[c] : 0;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            int incl = v[u];
            for (int o = 1; o < 32; o <<= 1) {
                const int t = __shfl_up_sync(FULL_MASK, incl, o);
                if (lane >= o) incl += t;
            }
            if (lane == 31) warp_tot[warp] = incl;
            __syncthreads();
            if (warp == 0) {
                int t = warp_tot[lane];
                for (int o = 1; o < 32; o <<= 1) {
                    const int x = __shfl_up_sync(FULL_MASK, t, o);
                    if (lane >= o) t += x;
                }
                warp_tot[lane] = t;
            }
            __syncthreads();
            const int c = base + u * 1024 + tid;
            if (c < nb) cursor[c] = carry + incl - v[u] + (warp > 0 ? warp_tot[warp - 1] : 0);
            carry += warp_tot[31];
            __syncthreads();   // warp_tot is reused
        }
    }
}

__global__ void pair_scatter_kernel(const int* __restrict__ cells, int npairs, int* cursor,
                                    int* __restrict__ list) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < npairs) list[atomicAdd(&cursor[cells[i]], 1)] = i;
}

// One block a cell: its codes and lane metadata into shared memory once,
// then its pairs in tiles of 16 queries on the int8 tensor cores, each
// distance written to dist[b, p*L + lane] (+inf for empty, dead,
// unallowed lanes and those past the cell's last live lane).
__global__ void __launch_bounds__(CELL_THREADS)
cell_score_kernel(ProbeArgs a, Sq8Data sc, CellWork g) {
    const int c = blockIdx.x;
    const int cnt = g.count[c];
    if (cnt == 0) return;
    const int end = g.cursor[c], beg = end - cnt;
    extern __shared__ __align__(16) unsigned char smem[];
    const int lp = (a.L + 7) & ~7, stride = cell_stride(a.d);
    const int wpr = ((a.d + 31) & ~31) >> 4, wd = a.d >> 4;   // 16-byte words a row: padded, real
    unsigned char* s_codes = smem;
    unsigned char* s_qc = smem + (size_t)lp * stride;
    float* s_min = reinterpret_cast<float*>(s_qc + CELL_TILE * stride);
    float* s_scale = s_min + lp;
    float* s_pn = s_scale + lp;
    int* s_live = reinterpret_cast<int*>(s_pn + lp);
    float* s_qs = reinterpret_cast<float*>(s_live + lp);
    float* s_qsum = s_qs + CELL_TILE;
    float* s_qn = s_qsum + CELL_TILE;
    int* s_qb = reinterpret_cast<int*>(s_qn + CELL_TILE);
    long long* s_out = reinterpret_cast<long long*>(s_qb + CELL_TILE);
    __shared__ int s_ext;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const long long PL = (long long)a.P * a.L;
    // a tile's pairs (pair b*P + p, -1 past the tile): query and output row
    auto place = [&](int pair) {
        if (tid < CELL_TILE) {
            const int qb = pair / a.P;
            s_qb[tid] = qb;
            s_out[tid] = pair < 0 ? -1 : (long long)qb * PL + (long long)(pair - qb * a.P) * a.L;
        }
    };
    PROBE_MARK_START;
    PROBE_COUNT(7);
    if (tid == 0) s_ext = 0;
    // the first tile's pairs are read beside the lane metadata
    const int first = tid < min(CELL_TILE, cnt) ? g.list[beg + tid] : -1;
    __syncthreads();
    const size_t row0 = (size_t)c * a.L;
    for (int l = tid; l < lp; l += blockDim.x) {
        int live = 0;
        if (l < a.L) {
            const size_t row = row0 + l;
            const int mem = a.members[row];
            const uint8_t al = a.alive[row];
            const uint8_t ok = a.allowed == nullptr ? (uint8_t)1 : a.allowed[row];
            s_min[l] = sc.mins[row];
            s_scale[l] = sc.scales[row];
            s_pn[l] = a.pnorms[row];
            live = mem >= 0 && al != 0 && ok != 0;
        }
        s_live[l] = live;
        if (live) atomicMax(&s_ext, l + 1);
    }
    place(first);
    __syncthreads();
    PROBE_MARK(5);
    // the codes of lanes [0, ext8): lanes past the last live one are not read
    const int ext = s_ext, ext8 = (ext + 7) & ~7;
    for (int t = tid; t < ext8 * wpr; t += blockDim.x) {
        const int l = t / wpr, j = t - l * wpr;
        const bool ok = l < ext && j < wd;
        cp_async16(s_codes + l * stride + 16 * j,
                   ok ? sc.codes + (row0 + l) * a.d + 16 * j : sc.codes, ok);
    }
    const int g8 = lane >> 2, tig = lane & 3;
    const int ksteps = (a.d + 31) >> 5;
    const float inf = __int_as_float(0x7f800000);
    for (int t0 = beg; t0 < end; t0 += CELL_TILE) {
        const int nt = min(CELL_TILE, end - t0);
        if (t0 != beg) {
            place(tid < nt ? g.list[t0 + tid] : -1);
            __syncthreads();
        }
        for (int t = tid; t < CELL_TILE * wpr; t += blockDim.x) {
            const int r = t / wpr, j = t - r * wpr;
            const bool ok = r < nt && j < wd;
            cp_async16(s_qc + r * stride + 16 * j,
                       ok ? sc.qc + (size_t)s_qb[r] * a.d + 16 * j : sc.qc, ok);
        }
        if (tid < nt) {   // the query scalars, read under the copies
            const int qb = s_qb[tid];
            s_qs[tid] = sc.qs[qb];
            s_qsum[tid] = sc.qsum[qb];
            s_qn[tid] = a.qn[qb];
        }
        cp_async_wait_all();
        __syncthreads();
        const unsigned char* arow0 = s_qc + g8 * stride + tig * 4;
        const unsigned char* arow1 = arow0 + 8 * stride;
        for (int ntile = warp; ntile < (ext8 >> 3); ntile += nwarps) {
            int acc[4] = {0, 0, 0, 0};
            const unsigned char* brow = s_codes + (ntile * 8 + g8) * stride + tig * 4;
            for (int ks = 0; ks < ksteps; ++ks) {
                const int k0 = ks * 32;
                mma_s8(acc, *reinterpret_cast<const uint32_t*>(arow0 + k0),
                       *reinterpret_cast<const uint32_t*>(arow1 + k0),
                       *reinterpret_cast<const uint32_t*>(arow0 + k0 + 16),
                       *reinterpret_cast<const uint32_t*>(arow1 + k0 + 16),
                       *reinterpret_cast<const uint32_t*>(brow + k0),
                       *reinterpret_cast<const uint32_t*>(brow + k0 + 16));
            }
            // acc[0..1]: query row g8, lanes 2*tig + {0, 1}; acc[2..3]: row g8 + 8
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = g8 + 8 * h;
                const long long o = s_out[r];
                if (o < 0) continue;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int l = ntile * 8 + 2 * tig + e;
                    if (l >= a.L) continue;
                    g.dist[o + l] = s_live[l] ? sq8_distance(acc[2 * h + e], s_min[l], s_scale[l],
                                                             s_pn[l], s_qs[r], s_qsum[r],
                                                             s_qn[r], sc.metric)
                                              : inf;
                }
            }
        }
        const int rest = a.L - ext8;
        for (int t = tid; t < nt * max(rest, 0); t += blockDim.x) {
            const int r = t / rest;
            g.dist[s_out[r] + ext8 + (t - r * rest)] = inf;
        }
        __syncthreads();   // the next tile reuses the query rows
    }
    PROBE_MARK(6);
}

// The m best of each row, as K2 selected them from the [B, P*L] distances
// (sel_d ascending, sel_pos their columns) -> the probe's outputs.
__global__ void __launch_bounds__(SEL_THREADS)
cell_tail_kernel(ProbeArgs a, const float* __restrict__ sel_d, const int* __restrict__ sel_pos) {
    extern __shared__ __align__(16) unsigned char smem[];
    Winners w(smem, a.m);
    const size_t b = blockIdx.x;
    for (int i = threadIdx.x; i < a.m; i += blockDim.x) {
        const int col = sel_pos[b * a.m + i];
        const int p = col / a.L;
        w.key[i] = f2key(sel_d[b * a.m + i]);
        w.pos[i] = col;
        w.id[i] = a.members[(size_t)a.cells[b * a.P + p] * a.L + (col - p * a.L)];
    }
    __syncthreads();
    probe_tail(a, b, w);
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
    a.chunk = chunk; a.nchunks = 1; a.chunk_cells = 0;
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
    return launch_probe(a, F32Scorer{{}, q, pvecs, metric}, (cudaStream_t)stream);
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
    const Sq8Data data{qc, qs, qsum, codes, mins, scales, metric};
    if (d % 16 == 0 && (uintptr_t)codes % 16 == 0)
        return launch_probe(a, Sq8Groups{data, {}}, (cudaStream_t)stream);
    return launch_probe(a, Sq8Words{data, {}}, (cudaStream_t)stream);
}

// Whether one cell-major block takes a cell of L lanes at width d on
// `device`: codes in 16-byte words, and cell_smem beside the kernel's
// static shared memory within the device's opt-in limit. The wrapper's
// route (kernels.probe_route) asks this through ivf_probe_sq8_cell_ok.
static cudaError_t cell_fits(int L, int d, int device, bool* ok) {
    *ok = false;
    if (L < 1 || d < 16 || d % 16 != 0) return cudaSuccess;
    int limit = 0;
    cudaError_t e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaFuncAttributes fa;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, cell_score_kernel);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return e;
    }
    *ok = cell_smem(L, d) + fa.sharedSizeBytes <= (size_t)limit;
    return cudaSuccess;
}

extern "C" int ivf_probe_sq8_cell_ok(int L, int d, int device, int* ok) {
    bool fits = false;
    const cudaError_t e = cell_fits(L, d, device, &fits);
    *ok = fits ? 1 : 0;
    return (int)e;
}

// K4's cell-major scoring: groups the B*P pairs by cell (work: 2*NB + B*P
// ints) and writes every lane's distance to dist [B, P*L]. The selection
// (K2) and ivf_probe_cells_finish follow.
extern "C" int ivf_probe_sq8_cells(const int8_t* qc, const float* qs, const float* qsum,
                                   const float* qn, const int* cells, int B, int P,
                                   const int8_t* codes, const float* mins, const float* scales,
                                   const float* pnorms, const int* members,
                                   const uint8_t* alive, const uint8_t* allowed, int NB, int L,
                                   int d, int metric, int* work, float* dist, void* stream) {
    const long long npairs = (long long)B * P;
    if (metric < 0 || metric > 2 || npairs < 1 || npairs > INT_MAX ||
        (long long)NB * L > INT_MAX)
        return (int)cudaErrorInvalidValue;
    int device = 0;
    bool fits = false;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cell_fits(L, d, device, &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    CellWork g{NB, work, work + NB, work + 2 * NB, dist};
    e = cudaMemsetAsync(g.count, 0, (size_t)NB * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
    const int grid = (int)((npairs + 255) / 256);
    pair_count_kernel<<<grid, 256, 0, s>>>(cells, (int)npairs, g.count);
    pair_scan_kernel<<<1, 1024, 0, s>>>(g.count, NB, g.cursor);
    pair_scatter_kernel<<<grid, 256, 0, s>>>(cells, (int)npairs, g.cursor, g.list);
    const size_t smem = cell_smem(L, d);
    e = cudaFuncSetAttribute(cell_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    ProbeArgs a = probe_args(cells, B, P, pnorms, members, alive, allowed, L, d, qn, 1, 1, 0,
                             MODE_TOPK, 1, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
    cell_score_kernel<<<NB, CELL_THREADS, smem, s>>>(
        a, Sq8Data{qc, qs, qsum, codes, mins, scales, metric}, g);
    return (int)cudaGetLastError();
}

// The outputs of a cell-major probe from K2's selection of its rows.
extern "C" int ivf_probe_cells_finish(const int* cells, int B, int P, const int* members, int L,
                                      const float* sel_d, const int* sel_pos, int k, int m,
                                      int replicated, int mode, float* out_d, int* out_i,
                                      int* out_pos, void* stream) {
    ProbeArgs a = probe_args(cells, B, P, nullptr, members, nullptr, nullptr, L, 4, nullptr, k,
                             m, replicated, mode, 1, nullptr, nullptr, nullptr, out_d, out_i,
                             out_pos);
    if (check_args(a) != 0 || B < 1) return (int)cudaErrorInvalidValue;
    cell_tail_kernel<<<B, SEL_THREADS, Winners::bytes(m), (cudaStream_t)stream>>>(a, sel_d,
                                                                                  sel_pos);
    return (int)cudaGetLastError();
}
