// K9 hnsw_greedy: the HNSW greedy descent through one level.
//
// Replaces: turdb_tpu/models/hnsw.py _greedy_level (the wave inserts'
// descent through the levels where a node does not connect, and
// hnsw_search_impl's descent at descent_ef 1, which the graphs the waves
// build use), over the f32 rows or the SQ8 / SQ16 graph store. Per query:
// score the deg neighbours of `cur` (gathered_distances' epilogue), take
// the first slot of the minimum, and move only if it is strictly nearer
// than cur_d; stop when it does not move, or after GREEDY_CAP steps. The
// reference runs a batched while_loop until no query moves; a query that
// stopped never moves again (the step is deterministic), so a loop per
// query with its own exit gives the same result and needs no host sync.
// As the reference clips the index, a query whose cur is -1 reads row 0's
// list (against its cur_d, +inf).
//
// What bounds it on an H100: the latency of a chain of dependent reads. A
// step reads one adjacency row and then the deg rows it names (4d bytes
// each, or d / 2d bytes of codes), and the next step's row depends on
// them: a query takes a few dozen such steps in sequence, far from the
// card's bandwidth or arithmetic.
//
// Design: one warp per query (GREEDY_WARPS queries to a 128-thread block)
// with its query row in shared memory; a lane scores one neighbour at a
// time with the scorers K8 uses (graph_scorer.cuh: the whole row from its
// own loads), so a step keeps the warp's deg rows in flight at once; the
// argmin is a shuffle butterfly that keeps the lower slot on ties (the
// first index, as jnp.argmin). Warps never wait on each other. Each query
// reports the lists it read and the neighbours it scored (the work its
// bound counts).
#include <cuda_runtime.h>
#include <stdint.h>

#include "graph_scorer.cuh"

#define GREEDY_THREADS 128
#define GREEDY_WARPS (GREEDY_THREADS / 32)
#define GREEDY_CAP 128
#define F_INF __int_as_float(0x7f800000)

template <class Scorer>
__global__ void __launch_bounds__(GREEDY_THREADS)
greedy_kernel(Scorer sc, const float* __restrict__ qn, const int* __restrict__ cur_i,
              const float* __restrict__ cur_d, int B, int d, int deg, int metric,
              int* __restrict__ out_i, float* __restrict__ out_d, int* __restrict__ out_stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const size_t b = (size_t)blockIdx.x * GREEDY_WARPS + warp;
    if (b >= (size_t)B) return;
    unsigned char* sq = smem + (size_t)warp * Scorer::query_bytes(d);
    float* qf = reinterpret_cast<float*>(sq);
    for (int i = lane; i < d; i += 32) qf[i] = sc.q[b * d + i];
    __syncwarp();
    int cur = cur_i[b];
    float cd = cur_d[b];
    const float qnb = qn[b];
    int steps = 0, scored = 0;
    while (steps < GREEDY_CAP) {
        const int node = cur < 0 ? 0 : cur;
        float bv = F_INF;
        int bg = 0x7fffffff, bid = -1;
        // slots in ascending order: a lane keeps the first of its ties
        for (int g0 = 0; g0 < deg; g0 += 32) {
            const int g = g0 + lane;
            const int id = g < deg ? sc.neighbour(node, g, deg) : -1;
            scored += __popc(__ballot_sync(0xffffffffu, id >= 0));
            if (id < 0) continue;
            const float v = sc.score(sq, node, g, id, d, deg, qnb, metric);
            if (v < bv) { bv = v; bg = g; bid = id; }
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
    if (lane == 0) {
        out_i[b] = cur;
        out_d[b] = cd;
        reinterpret_cast<int2*>(out_stats)[b] = make_int2(steps, scored);
    }
}

template <class Scorer>
static int launch_greedy(const Scorer& sc, const float* qn, const int* cur_i, const float* cur_d,
                         int B, int d, int deg, int metric, int* out_i, float* out_d,
                         int* out_stats, void* stream) {
    const size_t smem = GREEDY_WARPS * Scorer::query_bytes(d);
    cudaError_t e = cudaFuncSetAttribute(greedy_kernel<Scorer>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    const int blocks = (B + GREEDY_WARPS - 1) / GREEDY_WARPS;
    greedy_kernel<Scorer><<<blocks, GREEDY_THREADS, smem, (cudaStream_t)stream>>>(
        sc, qn, cur_i, cur_d, B, d, deg, metric, out_i, out_d, out_stats);
    return (int)cudaGetLastError();
}

// bits 0: f32 rows `vectors`; 8 / 16: the SQ store (`codes` u8 / u16,
// `mins`, `scales`)
extern "C" int hnsw_greedy(const int* adj, const float* vectors, const void* codes, int bits,
                           const float* mins, const float* scales, const float* norms,
                           const float* q, const float* qn, const int* cur_i, const float* cur_d,
                           int B, int d, int deg, int metric, int* out_i, float* out_d,
                           int* out_stats, void* stream) {
    if (B < 1 || d % 4 != 0 || deg < 1 || metric < 0 || metric > 2)
        return (int)cudaErrorInvalidValue;
    if (bits == 0)
        return launch_greedy(GraphScorer{adj, vectors, norms, q}, qn, cur_i, cur_d, B, d, deg,
                             metric, out_i, out_d, out_stats, stream);
    if (bits == 8)
        return launch_greedy(
            SqScorer<uint8_t>{adj, static_cast<const uint8_t*>(codes), mins, scales, norms, q},
            qn, cur_i, cur_d, B, d, deg, metric, out_i, out_d, out_stats, stream);
    if (bits == 16)
        return launch_greedy(
            SqScorer<uint16_t>{adj, static_cast<const uint16_t*>(codes), mins, scales, norms, q},
            qn, cur_i, cur_d, B, d, deg, metric, out_i, out_d, out_stats, stream);
    return (int)cudaErrorInvalidValue;
}
