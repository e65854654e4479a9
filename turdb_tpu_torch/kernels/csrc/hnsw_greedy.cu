// K9 hnsw_greedy: the HNSW greedy descent through one level or several.
//
// Replaces: turdb_tpu/models/hnsw.py _greedy_level (the wave inserts'
// descent through the levels where a node does not connect, and
// hnsw_search_impl's descent at descent_ef 1, which the graphs the waves
// build use), over the f32 rows or the SQ8 / SQ16 graph store. Per query
// and level: score the deg neighbours of `cur` (gathered_distances'
// epilogue), take the first slot of the minimum, and move only if it is
// strictly nearer than cur_d; stop when it does not move, or after
// GREEDY_CAP steps. The reference runs a batched while_loop until no query
// moves; a query that stopped never moves again (the step is
// deterministic), so a loop per query with its own exit gives the same
// result and needs no host sync. As the reference clips the index, a query
// whose cur is -1 reads row 0's list (against its cur_d, +inf). One launch
// walks a list of levels (top first, at most GREEDY_LEVELS_MAX), each query
// from the first down to its own lowest level, each level from where the
// last one ended: the chain of one-level walks, in one launch.
//
// What bounds it on an H100: the latency of a chain of dependent reads. A
// step reads one adjacency row and then the deg rows it names (4d bytes
// each, or d / 2d bytes of codes), and the next step's row depends on
// them: a query takes a few dozen such steps in sequence, far from the
// card's bandwidth or arithmetic.
//
// Design: one warp per query (GREEDY_WARPS queries to a 128-thread block)
// with its query row and a stage of GREEDY_ROWS neighbour rows in shared
// memory.
// A step reads the node's list (lane g slot g, one coalesced read), stages
// the listed rows by cp.async with the whole warp (graph_scorer.cuh
// staged_score: every copy issued before any is waited for, so a step pays
// about two memory round trips, the list and the rows), and lane g scores
// row g in the row's own order; the argmin is a shuffle butterfly that
// keeps the lower slot on ties (the first index, as jnp.argmin). Warps
// never wait on each other. Each query reports the lists it read and the
// neighbours it scored, over all its levels (the work its bound counts).
#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_scorer.cuh"

#define GREEDY_THREADS 128
#define GREEDY_WARPS (GREEDY_THREADS / 32)
#define GREEDY_CAP 128
#define GREEDY_LEVELS_MAX 8   // kernels/build.py GREEDY_LEVELS_MAX
#define GREEDY_ROWS 16        // rows a warp stages at once (the upper levels' deg m = 16)
#define F_INF __int_as_float(0x7f800000)

// the levels of one launch, passed by value: adj[0] is walked first
struct GreedyLevels {
    const int* adj[GREEDY_LEVELS_MAX];
    int n;
};

// bytes of a warp's region: its query row, then its stage
template <class Scorer>
__host__ __device__ inline size_t greedy_warp_bytes(int d) {
    return ((Scorer::query_bytes(d) + 15) & ~(size_t)15) +
           (size_t)GREEDY_ROWS * stage_words(Scorer::row_bytes(d)) * 16;
}

template <class Scorer>
__global__ void __launch_bounds__(GREEDY_THREADS)
greedy_kernel(Scorer sc, GreedyLevels lv, const float* __restrict__ qn,
              const int* __restrict__ cur_i, const float* __restrict__ cur_d,
              const int* __restrict__ lowest, int B, int d, int deg, int metric,
              int* __restrict__ out_i, float* __restrict__ out_d, int* __restrict__ out_stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t b = (size_t)blockIdx.x * GREEDY_WARPS + warp;
    if (b >= (size_t)B) return;
    unsigned char* sq = smem + (size_t)warp * greedy_warp_bytes<Scorer>(d);
    unsigned char* stage = sq + ((Scorer::query_bytes(d) + 15) & ~(size_t)15);
    const int sw = stage_words(Scorer::row_bytes(d));
    float* qf = reinterpret_cast<float*>(sq);
    for (int i = lane; i < d; i += 32) qf[i] = sc.q[b * d + i];
    __syncwarp();
    int cur = cur_i[b];
    float cd = cur_d[b];
    const float qnb = qn[b];
    // levels numbered lv.n - 1 (the first) down to 0: this query walks those
    // at or above its lowest
    const int walk = lv.n - (lowest ? min(max(lowest[b], 0), lv.n) : 0);
    int steps = 0, scored = 0;
    for (int l = 0; l < walk; ++l) {
        const int* adj = lv.adj[l];
        for (int s = 0; s < GREEDY_CAP; ++s) {
            const int node = cur < 0 ? 0 : cur;
            float bv = F_INF;
            int bg = 0x7fffffff, bid = -1;
            // slots in batches of GREEDY_ROWS, ascending: a lane keeps the
            // first of its ties
            for (int g0 = 0; g0 < deg; g0 += GREEDY_ROWS) {
                const int g = g0 + lane;
                const int id = lane < GREEDY_ROWS && g < deg ? adj[(size_t)node * deg + g] : -1;
                scored += __popc(__ballot_sync(0xffffffffu, id >= 0));
                const float v = staged_score(sc, stage, sw, id, min(GREEDY_ROWS, deg - g0), sq,
                                             d, qnb, metric, lane);
                if (id >= 0 && v < bv) { bv = v; bg = g; bid = id; }
            }
            for (int o = 16; o > 0; o >>= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
                const int og = __shfl_xor_sync(0xffffffffu, bg, o);
                const int oid = __shfl_xor_sync(0xffffffffu, bid, o);
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

template <class Scorer>
static int launch_greedy(const Scorer& sc, const GreedyLevels& lv, const float* qn,
                         const int* cur_i, const float* cur_d, const int* lowest, int B, int d,
                         int deg, int metric, int* out_i, float* out_d, int* out_stats,
                         void* stream) {
    const size_t smem = GREEDY_WARPS * greedy_warp_bytes<Scorer>(d);
    cudaError_t e = cudaFuncSetAttribute(greedy_kernel<Scorer>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    const int blocks = (B + GREEDY_WARPS - 1) / GREEDY_WARPS;
    greedy_kernel<Scorer><<<blocks, GREEDY_THREADS, smem, (cudaStream_t)stream>>>(
        sc, lv, qn, cur_i, cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats);
    return (int)cudaGetLastError();
}

// `levels`: the adjacencies [cap, deg] walked, top first; `lowest` [B]
// (null: 0) the lowest level each query walks, counting the last of the
// list as 0 (lowest >= levels.n: none, the start passes through). bits 0:
// f32 rows `vectors`; 8 / 16: the SQ store (`codes` u8 / u16, `mins`,
// `scales`), staged by 16-byte copies where its rows are whole aligned
// 16-byte words, else by 4-byte copies.
extern "C" int hnsw_greedy(GreedyLevels levels, const float* vectors, const void* codes, int bits,
                           const float* mins, const float* scales, const float* norms,
                           const float* q, const float* qn, const int* cur_i, const float* cur_d,
                           const int* lowest, int B, int d, int deg, int metric, int* out_i,
                           float* out_d, int* out_stats, void* stream) {
    if (B < 1 || d % 4 != 0 || deg < 1 || metric < 0 || metric > 2 || levels.n < 1 ||
        levels.n > GREEDY_LEVELS_MAX)
        return (int)cudaErrorInvalidValue;
    const bool wide = (size_t)codes % 16 == 0 && (size_t)d * (bits / 8) % 16 == 0;
    if (bits == 0)
        return launch_greedy(GraphScorer{nullptr, vectors, norms, q}, levels, qn, cur_i,
                             cur_d, lowest, B, d, deg, metric, out_i, out_d, out_stats, stream);
    if (bits == 8)
        return launch_greedy(SqScorer<uint8_t>{nullptr, static_cast<const uint8_t*>(codes), mins,
                                               scales, norms, q, wide},
                             levels, qn, cur_i, cur_d, lowest, B, d, deg, metric, out_i, out_d,
                             out_stats, stream);
    if (bits == 16)
        return launch_greedy(SqScorer<uint16_t>{nullptr, static_cast<const uint16_t*>(codes),
                                                mins, scales, norms, q, wide},
                             levels, qn, cur_i, cur_d, lowest, B, d, deg, metric, out_i, out_d,
                             out_stats, stream);
    return (int)cudaErrorInvalidValue;
}
