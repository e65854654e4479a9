// K12 cell_select: the IVF cell selection, q·Cᵀ and each query's P nearest
// cells, in one launch.
//
// Replaces: turdb_tpu/models/ivf.py ivf_search_impl's cell scoring
// (ivf.py:261-273: `qn + cnorms − 2·dot_general(q, C)`, unclamped, then
// `topk_smallest_wide` of the nprobe nearest) and the same step of the
// serving pack's seeding (turdb_tpu/models/hnsw_serve.py:179-188). On the
// card it takes the place of the library's fp32 GEMM, which wrote the [B, C]
// dot matrix to device memory, and of K2, which read it back.
//
// What bounds it on an H100: operations. 2·B·C·d fp32 FLOP (51 GFLOP at
// B = 10,000, C = 20,000, d = 128: 0.76 ms at 67 TFLOP/s) against a few MB of
// queries and centroids, which stay in L2, and the [B, P] outputs; the [B, C]
// distances (0.8 GB there) are never written. The products stay fp32 FFMA,
// as the library's SIMT GEMM ran them: only their summation order differs.
//
// Design. A 256-thread block owns TQ = 16·MI queries (MI = 1, 2 or 4, from
// the batch: kernels.cell_select_plan) and one segment of the centroids, which
// it sweeps in tiles of CS_TC = 128. The block's query rows stay in shared
// memory (rows padded by 4 floats); the centroid tiles stream through a
// three-stage `cp.async` ring in chunks of 32 dims (rows padded to 36 floats,
// so a warp's 16 rows fall on 32 distinct banks), one barrier a chunk, each
// tile's centroid norms with its last chunk. A warp owns 2·MI queries (rows
// 2w, 2w + 1, then every 16th) and all 128 centroids of a tile: a thread
// holds an MI × 8 micro-tile of dot products (rows tm + 16i, columns
// tn + 16j), one fp32 FMA chain an output in dim order; a step of 4 dims
// reads 8 centroid float4s and MI query float4s from shared memory.
//
// The epilogue is K2's, rounded op by op: (qn + cn) − 2·dot, unclamped. The
// selection is warp-private, as K11's: each query keeps a threshold and a
// buffer of CS_CAP = 48 (distance key << 32 | column) candidates in shared
// memory; its 16 threads hold the buffer's count and the threshold in
// registers. A tile's distances are tested against the thresholds it
// starts with, a bit each. Where the passes fit every buffer of the warp,
// each is written at its query's count plus its rank among the query's
// passes (a scan over the 16 threads, no atomics); else the tile goes 16
// columns at a time in ascending order, each pass ranked by a ballot; a
// buffer the next 16 could overflow is compacted (a warp bitonic sort, the
// P best kept, the threshold their P-th), so a later column equal to the
// threshold loses to every kept one: ties go to the lower column, as in K2.
// A segment's first tile sets each query's threshold from the P-th least of
// its 16 threads' two least distances each, taken inclusively: it is at or
// above the tile's P-th least distance, so no distance that can make the P
// best is refused, and few others pass (where the tile holds fewer than P
// finite distances, every column passes, +inf cells included, until the
// first compaction). On the IVF cells' index the tests take 6 % of a
// warp's cycles, the stores and compactions 15-17 % (PERF.md).
//
// A batch too small to fill the card with query tiles alone runs S segments
// of the tiles in separate blocks (S from the batch, C and the SM count,
// kernels.cell_select_plan); each writes its P best (key, column) to a
// scratch row [B, S, P], and the last block of a query tile to finish (a
// per-tile counter after __threadfence, reset by that block) merges its
// queries' S·P candidates, a warp a query, into a running list of P held
// across lanes, in the 64-bit (key, column) order, so the merge keeps the
// tie rule. One launch a call.
//
// Shared memory of a block: the buffers (TQ·CS_CAP·8), the ring and its
// norms (3·128·37·4 = 56 KB), the queries (TQ·(d + 4)·4) and a count a
// query: 113 KB at MI = 4, d = 128. Blocks hold at most 128 registers a
// thread and run two an SM where their shared memory fits (to d = 128 at
// MI = 4): one block's epilogue, whose shuffles and stores wait on each
// other, overlaps the other's products. Two blocks of 64 queries beat one
// of 128 (8 queries a thread, up to 255 registers) by 7-10 % on the IVF
// cells' index (PERF.md).
// Built with -DCS_CLOCKS (scripts/exp_torch_cell_select.py --variant), lane
// 0 of every warp adds its cycles in each phase to cs_clocks, which
// cell_select_clocks reads and clears.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch_util.cuh"
#include "select.cuh"

#define CS_THREADS 256
#define CS_TC 128           // centroids a tile
#define CS_KC 32            // dims a stage of the ring
#define CS_KS (CS_KC + 4)   // floats a staged centroid row
#define CS_STAGES 3
#define CS_CAP 48           // candidates a query's buffer holds
#define CS_P_MAX 32         // widest P (a compaction keeps P, a column group adds 16)
#define CS_D_MAX 256
#define CS_CT 16            // centroid threads a query: a warp is 2 queries x 16
#define CS_NJ (CS_TC / CS_CT)
#define CS_KUNROLL 2        // steps of 4 dims a loop iteration (4 or 8 spill at 128 registers)

typedef unsigned long long u64;

#ifdef CS_CLOCKS
// lane 0 of every warp adds its cycles in each phase: 0 the wait for a chunk
// and the barrier, 1 the products, 2 the epilogue's tests, 3 its stores
// and compactions, 4 its column groups (a tile that could overflow a
// buffer), 5 the emission and merge; 6 counts the warps
__device__ unsigned long long cs_clocks[7];
#define CS_MARK(i)                                                         \
    do {                                                                   \
        if (lane == 0) {                                                   \
            const long long now = clock64();                               \
            atomicAdd(cs_clocks + (i), (unsigned long long)(now - mark));  \
            mark = now;                                                    \
        }                                                                  \
    } while (0)
#else
#define CS_MARK(i) \
    do {           \
    } while (0)
#endif

__device__ __forceinline__ void cs_copy16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cs_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cs_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes of a block's dynamic shared memory (kernels.cell_select_smem mirrors it)
__host__ __device__ inline size_t cs_smem(int mi, int d) {
    const size_t tq = 16 * (size_t)mi;
    return tq * CS_CAP * 8 + (size_t)CS_STAGES * CS_TC * (CS_KS + 1) * 4 + tq * (d + 4) * 4 +
           tq * 4 + 16;
}

// The warp's buffer `buf` of n (> P) candidates: sorted, its P best kept at
// its head. Returns the P-th (key << 32 | column), in every lane.
__device__ __forceinline__ u64 cs_compact(u64* buf, int n, int P, int lane) {
    u64 v[2];
    v[0] = lane < n ? buf[lane] : ~0ull;
    v[1] = lane + 32 < n ? buf[lane + 32] : ~0ull;
    warp_bitonic<2>(v, lane);
    __syncwarp();   // every lane has read the buffer
    if (lane < P) buf[lane] = v[0];
    if (lane + 32 < P) buf[lane + 32] = v[1];
    __syncwarp();
    return __shfl_sync(0xffffffffu, P <= 32 ? v[0] : v[1], (P - 1) & 31);
}

// A query's buffer of n sorted, its P best to the outputs: distances and
// columns, or (part set) the (key, column) pairs of segment `seg` (~0 past
// the buffer: they rank after every real candidate).
__device__ __forceinline__ void cs_emit(const u64* buf, int n, int P, int lane, int gq, int S,
                                        int seg, float* out_d, int* out_i, u64* part) {
    u64 v[2];
    v[0] = lane < n ? buf[lane] : ~0ull;
    v[1] = lane + 32 < n ? buf[lane + 32] : ~0ull;
    warp_bitonic<2>(v, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int e = 32 * h + lane;
        if (e >= P) continue;
        if (part != nullptr) {
            part[((size_t)gq * S + seg) * P + e] = v[h];
        } else {
            out_d[(size_t)gq * P + e] = key2f((uint32_t)(v[h] >> 32));
            out_i[(size_t)gq * P + e] = (int)(uint32_t)v[h];
        }
    }
}

// c += a · b over 4 dims: a thread's MI query rows (16 apart, stride qs) x
// its 8 centroid rows (16 apart, stride CS_KS), one FMA chain an output in
// dim order
template <int MI>
__device__ __forceinline__ void cs_step(float (&acc)[MI][CS_NJ], const float* cb, const float* qb,
                                        int qs, int k) {
    float4 b[CS_NJ];
#pragma unroll
    for (int j = 0; j < CS_NJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(cb + CS_CT * j * CS_KS + k);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qb + 16 * i * qs + k);
#pragma unroll
        for (int j = 0; j < CS_NJ; ++j) {
            acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
    }
}

// v[j] for a j known only at run time, without indexing the registers
__device__ __forceinline__ float cs_pick(const float (&v)[CS_NJ], int j) {
    float x = v[0];
#pragma unroll
    for (int k = 1; k < CS_NJ; ++k) x = j == k ? v[k] : x;
    return x;
}

// The warp's merge of a query's n (key << 32 | column) candidates at src
// (written by the other blocks of its tile): lane r < P returns the r-th
// smallest (~0 past the real ones). A running list, sorted across lanes
// 0..P-1: a batch of 32·CS_MJ candidates is read at once, and each one
// below the list's P-th goes in at its rank, the P-th falling out.
#define CS_MJ 8
__device__ __forceinline__ u64 cs_merge(const u64* __restrict__ src, int n, int P, int lane) {
    const unsigned FULL = 0xffffffffu;
    u64 top = ~0ull, kth = ~0ull;
#pragma unroll 1
    for (int base = 0; base < n; base += 32 * CS_MJ) {
        u64 v[CS_MJ];
#pragma unroll
        for (int u = 0; u < CS_MJ; ++u) {
            const int e = base + 32 * u + lane;
            v[u] = e < n ? __ldcg(src + e) : ~0ull;
        }
#pragma unroll
        for (int u = 0; u < CS_MJ; ++u) {
            unsigned m = __ballot_sync(FULL, v[u] < kth);
            while (m) {
                const int from = __ffs(m) - 1;
                const u64 x = __shfl_sync(FULL, v[u], from);
                // lanes past P hold ~0, never below x
                const int pos = __popc(__ballot_sync(FULL, top < x));
                const u64 up = __shfl_up_sync(FULL, top, 1);
                if (lane < P) top = lane < pos ? top : (lane == pos ? x : up);
                kth = __shfl_sync(FULL, top, P - 1);
                if (lane == from) v[u] = ~0ull;
                m = __ballot_sync(FULL, v[u] < kth);
            }
        }
    }
    return top;
}

// q [B, d] and cents [C, d] f32 rows (d a multiple of 4, 16-byte aligned),
// qn [B], cn [C]. Block x: query tile x / S, segment x % S of tps tiles.
template <int MI>
__global__ void __launch_bounds__(CS_THREADS, 2)
cellsel_gemm_topk_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                         const float* __restrict__ cents, const float* __restrict__ cn, int B,
                         int C, int d, int P, int S, int tps, float* __restrict__ out_d,
                         int* __restrict__ out_i, u64* __restrict__ part,
                         int* __restrict__ counters) {
    constexpr int TQ = 16 * MI;
    const unsigned FULL = 0xffffffffu;
    const float NAN_F = __int_as_float(0x7fc00000), INF = __int_as_float(0x7f800000);
    extern __shared__ __align__(16) unsigned char smem[];
    u64* s_buf = reinterpret_cast<u64*>(smem);                         // [TQ][CS_CAP]
    float* s_c = reinterpret_cast<float*>(s_buf + TQ * CS_CAP);         // [stages][CS_TC][CS_KS]
    float* s_cn = s_c + CS_STAGES * CS_TC * CS_KS;                      // [stages][CS_TC]
    const int qs = d + 4;
    float* s_q = s_cn + CS_STAGES * CS_TC;                              // [TQ][qs]
    int* s_cnt = reinterpret_cast<int*>(s_q + TQ * qs);                // [TQ], at the end
    int* s_last = s_cnt + TQ;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int seg = blockIdx.x % S, qtile = blockIdx.x / S;
    const int q0 = qtile * TQ;
    const int nt = (C + CS_TC - 1) / CS_TC;
    const int t0 = seg * tps, t1 = min(nt, t0 + tps);
    const int nk = (d + CS_KC - 1) / CS_KC;
    const int nchunks = max(0, t1 - t0) * nk;
    // a warp: queries 2w and 2w + 1 (then every 16th) x the tile's 128
    // centroids; lane: query thread lm, centroid thread tn (columns tn + 16j)
    const int tn = lane & 15, lm = lane >> 4, tm = 2 * warp + lm;
    const unsigned below = (1u << tn) - 1u;
#ifdef CS_CLOCKS
    long long mark = clock64();
#endif

    // the block's queries, in the first copy group (rows past B stay unread:
    // their sums are never used)
    {
        const int words = d >> 2;
        for (int e = tid; e < TQ * words; e += CS_THREADS) {
            const int r = e / words, w = e - r * words;
            if (q0 + r < B) cs_copy16(s_q + r * qs + 4 * w, q + (size_t)(q0 + r) * d + 4 * w);
        }
    }
    // chunk g of the segment (tile t0 + g / nk, dims (g % nk)·32 ..) into ring
    // slot g % 4, and with a tile's last chunk its centroids' norms, which
    // its epilogue reads; rows past C stay unread (their columns are never
    // selected). Every call commits a group, empty past the last chunk.
    auto stage = [&](int g) {
        if (g < nchunks) {
            const int c0 = (t0 + g / nk) * CS_TC, k0 = (g % nk) * CS_KC;
            const int words = min(CS_KC, d - k0) >> 2;
            float* dst = s_c + (g % CS_STAGES) * (CS_TC * CS_KS);
#pragma unroll
            for (int it = 0; it < CS_TC * (CS_KC / 4) / CS_THREADS; ++it) {
                const int e = tid + it * CS_THREADS, r = e >> 3, w = e & 7;
                if (w < words && c0 + r < C)
                    cs_copy16(dst + r * CS_KS + 4 * w, cents + (size_t)(c0 + r) * d + k0 + 4 * w);
            }
            if (g % nk == nk - 1 && tid < CS_TC && c0 + tid < C)
                stage_copy4(s_cn + (g % CS_STAGES) * CS_TC + tid, cn + c0 + tid);
        }
        cs_commit();
    };
#pragma unroll
    for (int g = 0; g < CS_STAGES - 1; ++g) stage(g);

    // each of the thread's queries: its norm, the count of its buffer and its
    // threshold: NaN (every column passes) until the query's first tile sets
    // it, -inf past B (none passes); the 16 threads of a query hold the same
    float rq[MI], thr[MI];
    int cnt[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        const int gq = q0 + tm + 16 * i;
        rq[i] = gq < B ? qn[gq] : 0.0f;
        thr[i] = gq < B ? NAN_F : -INF;
        cnt[i] = 0;
    }
    float acc[MI][CS_NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < CS_NJ; ++j) acc[i][j] = 0.0f;

    // the buffers of the warp's queries whose count passes `limit`, compacted
    // to their P best, their thresholds the P-th
    auto compact_over = [&](int limit) {
        __syncwarp();
#pragma unroll
        for (int i = 0; i < MI; ++i) {
            const unsigned m = __ballot_sync(FULL, cnt[i] > limit);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                if (!((m >> (16 * r)) & 1u)) continue;
                const int n = __shfl_sync(FULL, cnt[i], 16 * r);
                const u64 kth = cs_compact(s_buf + (2 * warp + r + 16 * i) * CS_CAP, n, P, lane);
                if (lm == r) {
                    cnt[i] = P;
                    thr[i] = key2f((uint32_t)(kth >> 32));
                }
            }
        }
    };

    for (int g = 0; g < nchunks; ++g) {
        cs_wait<CS_STAGES - 2>();
        __syncthreads();   // chunk g in its slot for every thread; slot (g - 1) % 4 free
        CS_MARK(0);
        stage(g + CS_STAGES - 1);
        const int kc = g % nk, k0 = kc * CS_KC;
        const float* cb = s_c + (g % CS_STAGES) * (CS_TC * CS_KS) + tn * CS_KS;
        const float* qb = s_q + tm * qs + k0;
        if (d - k0 >= CS_KC) {
#pragma unroll 1
            for (int k = 0; k < CS_KC; k += 4 * CS_KUNROLL) {
#pragma unroll
                for (int u = 0; u < CS_KUNROLL; ++u) cs_step<MI>(acc, cb, qb, qs, k + 4 * u);
            }
        } else {
#pragma unroll 1
            for (int k = 0; k < d - k0; k += 4) cs_step<MI>(acc, cb, qb, qs, k);
        }
        CS_MARK(1);
        if (kc != nk - 1) continue;

        // The tile's epilogue: (qn + cn) − 2·dot, rounded as K2's, into acc.
        const int c0 = (t0 + g / nk) * CS_TC;
        const float* cn_t = s_cn + (g % CS_STAGES) * CS_TC + tn;
#pragma unroll
        for (int j = 0; j < CS_NJ; ++j) {
            const float cnj = cn_t[CS_CT * j];
#pragma unroll
            for (int i = 0; i < MI; ++i)
                acc[i][j] = __fsub_rn(__fadd_rn(rq[i], cnj), __fmul_rn(2.0f, acc[i][j]));
        }
        if (g < nk) {
            // the segment's first tile: a query's threshold from the P-th least
            // of its 16 threads' two least distances each (32 of the tile's),
            // at or above the tile's P-th least distance, so at or above the
            // segment's, taken inclusively (the next float up): every distance
            // that can make the P best passes, and few others do (+inf: every
            // column passes)
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                float v[2] = {INF, INF};   // element e = 16h + tn in v[h]
#pragma unroll
                for (int j = 0; j < CS_NJ; ++j) {
                    if (c0 + CS_CT * j + tn >= C) continue;
                    const float x = acc[i][j];
                    v[1] = fminf(v[1], fmaxf(v[0], x));
                    v[0] = fminf(v[0], x);
                }
                // a bitonic sort of the query's 32 across its 16 threads
#pragma unroll
                for (int len = 2; len <= 32; len <<= 1)
#pragma unroll
                    for (int st = len >> 1; st > 0; st >>= 1) {
                        if (st == 16) {
                            const float a = fminf(v[0], v[1]), b = fmaxf(v[0], v[1]);
                            v[0] = a;
                            v[1] = b;
                            continue;
                        }
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const float o = __shfl_xor_sync(FULL, v[h], st);
                            const bool up = ((16 * h + tn) & len) == 0, low = (tn & st) == 0;
                            v[h] = (low == up) ? fminf(v[h], o) : fmaxf(v[h], o);
                        }
                    }
                const float t = __shfl_sync(FULL, P <= 16 ? v[0] : v[1], (lm << 4) + ((P - 1) & 15));
                if (thr[i] != thr[i]) thr[i] = t == INF ? NAN_F : nextafterf(t, INF);
            }
        }
        // each distance against its query's threshold, a bit a column
        unsigned pm[MI];
        bool any = false;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
            pm[i] = 0;
#pragma unroll
            for (int j = 0; j < CS_NJ; ++j)
                pm[i] |= (unsigned)(c0 + CS_CT * j + tn < C && !(acc[i][j] >= thr[i])) << j;
            any |= pm[i] != 0;
        }
        CS_MARK(2);
        if (__any_sync(FULL, any)) {
            // where the tile's passes fit every buffer of the warp: each goes in
            // at its query's count plus its rank among the query's passes (a
            // scan over the query's 16 threads), the thread's own in a loop
            // over its set bits; then a buffer the next 16 could overflow is
            // compacted (a compaction costs more than the passes it saves)
            int excl[MI], tot[MI];
            bool fits = true;
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                const int c = __popc(pm[i]);
                int sum = c;
#pragma unroll
                for (int o = 1; o < 16; o <<= 1) {
                    const int t = __shfl_up_sync(FULL, sum, o, 16);
                    if (tn >= o) sum += t;
                }
                excl[i] = cnt[i] + sum - c;
                tot[i] = __shfl_sync(FULL, sum, 15, 16);
                fits &= cnt[i] + tot[i] <= CS_CAP;
            }
            if (__all_sync(FULL, fits)) {
#pragma unroll
                for (int i = 0; i < MI; ++i) {
                    u64* buf = s_buf + (tm + 16 * i) * CS_CAP + excl[i];
                    for (unsigned m = pm[i]; m; m &= m - 1) {
                        const int j = __ffs(m) - 1;
                        *buf++ = ((u64)f2key(cs_pick(acc[i], j)) << 32) |
                                 (uint32_t)(c0 + CS_CT * j + tn);
                    }
                }
                bool over = false;
#pragma unroll
                for (int i = 0; i < MI; ++i) {
                    cnt[i] += tot[i];
                    over |= cnt[i] > CS_CAP - CS_CT;
                }
                if (__any_sync(FULL, over)) compact_over(CS_CAP - CS_CT);
                CS_MARK(3);
            } else {
                // else 16 columns at a time in ascending order (column group j
                // holds 16j .. 16j + 15), each pass's rank a ballot, a buffer
                // the next group could overflow compacted between groups, so a
                // later column equal to a tightened threshold loses to every
                // kept one: ties go to the lower column, as in K2
#pragma unroll
                for (int j = 0; j < CS_NJ; ++j) {
                    bool over = false;
#pragma unroll
                    for (int i = 0; i < MI; ++i) {
                        const bool pass = ((pm[i] >> j) & 1u) && !(acc[i][j] >= thr[i]);
                        const unsigned mine = (__ballot_sync(FULL, pass) >> (16 * lm)) & 0xffffu;
                        if (pass)
                            s_buf[(tm + 16 * i) * CS_CAP + cnt[i] + __popc(mine & below)] =
                                ((u64)f2key(acc[i][j]) << 32) | (uint32_t)(c0 + CS_CT * j + tn);
                        cnt[i] += __popc(mine);
                        over |= cnt[i] > CS_CAP - CS_CT;
                    }
                    if (__any_sync(FULL, over)) compact_over(CS_CAP - CS_CT);
                }
                CS_MARK(4);
            }
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < CS_NJ; ++j) acc[i][j] = 0.0f;
    }
    cs_wait<0>();
    if (tn == 0) {
#pragma unroll
        for (int i = 0; i < MI; ++i) s_cnt[tm + 16 * i] = cnt[i];
    }
    __syncwarp();

    // each of the warp's rows (lane l < 2·MI: row 2w + l % 2 + 16 (l / 2)): its
    // P best to the outputs, or to its segment's scratch row
#pragma unroll 1
    for (int l = 0; l < 2 * MI; ++l) {
        const int row = 2 * warp + (l & 1) + 16 * (l >> 1);
        const int gq = q0 + row;
        if (gq >= B) continue;
        cs_emit(s_buf + row * CS_CAP, s_cnt[row], P, lane, gq, S, seg, out_d, out_i,
                S > 1 ? part : nullptr);
    }
    CS_MARK(5);
#ifdef CS_CLOCKS
    if (lane == 0) atomicAdd(cs_clocks + 6, 1ull);
#endif
    if (S == 1) return;

    // the last block of the query tile merges the segments' lists
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        const int done = atomicAdd(counters + qtile, 1);
        *s_last = done == S - 1;
        if (done == S - 1) counters[qtile] = 0;   // zero for the next launch
    }
    __syncthreads();
    if (!*s_last) return;
    __threadfence();
    const int n = S * P;
#pragma unroll 1
    for (int l = 0; l < 2 * MI; ++l) {
        const int row = 2 * warp + (l & 1) + 16 * (l >> 1);
        const int gq = q0 + row;
        if (gq >= B) continue;
        const u64 top = cs_merge(part + (size_t)gq * n, n, P, lane);
        if (lane < P) {
            out_d[(size_t)gq * P + lane] = key2f((uint32_t)(top >> 32));
            out_i[(size_t)gq * P + lane] = (int)(uint32_t)top;
        }
    }
}

template <int MI>
static int cs_launch(int grid, cudaStream_t s, const float* q, const float* qn, const float* cents,
                     const float* cn, int B, int C, int d, int P, int S, int tps, float* out_d,
                     int* out_i, u64* part, int* counters) {
    const size_t smem = cs_smem(MI, d);
    const int err = raise_smem(cellsel_gemm_topk_kernel<MI>, smem);
    if (err) return err;
    cellsel_gemm_topk_kernel<MI><<<grid, CS_THREADS, smem, s>>>(q, qn, cents, cn, B, C, d, P, S,
                                                               tps, out_d, out_i, part, counters);
    return (int)cudaGetLastError();
}

// q [B, d], qn [B], cents [C, d], cn [C] f32 (q and cents 16-byte aligned, d
// a multiple of 4 up to CS_D_MAX); P <= min(C, CS_P_MAX). mi (1, 2, 4): the
// query tile is 16·mi; S segments of ceil(tiles / S) tiles, none empty; with
// S > 1 `part` holds [B, S, P] 64-bit pairs and `counters` a zero int a
// query tile (left zero). out_d / out_i [B, P]: distances ascending, columns.
extern "C" int cell_select(const float* q, const float* qn, const float* cents, const float* cn,
                           int B, int C, int d, int P, int mi, int S, float* out_d, int* out_i,
                           u64* part, int* counters, void* stream) {
    if (B < 1 || C < 1 || P < 1 || P > CS_P_MAX || P > C || d < 4 || d > CS_D_MAX || d % 4 ||
        S < 1 || (S > 1 && (part == nullptr || counters == nullptr)) || ((uintptr_t)q & 15) ||
        ((uintptr_t)cents & 15))
        return (int)cudaErrorInvalidValue;
    const int nt = (C + CS_TC - 1) / CS_TC;
    const int tps = (nt + S - 1) / S;
    if (S > nt || (S - 1) * tps >= nt) return (int)cudaErrorInvalidValue;   // an empty segment
    const long long grid = (long long)((B + 16 * mi - 1) / (16 * mi)) * S;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (mi) {
        case 1: return cs_launch<1>((int)grid, s, q, qn, cents, cn, B, C, d, P, S, tps, out_d, out_i, part, counters);
        case 2: return cs_launch<2>((int)grid, s, q, qn, cents, cn, B, C, d, P, S, tps, out_d, out_i, part, counters);
        case 4: return cs_launch<4>((int)grid, s, q, qn, cents, cn, B, C, d, P, S, tps, out_d, out_i, part, counters);
        default: return (int)cudaErrorInvalidValue;
    }
}

// bytes of dynamic shared memory a block of query tile 16·mi takes at d
// (no stream: a query of the plan's rule, which kernels.cell_select_smem
// repeats)
extern "C" long long cell_select_smem(int mi, int d) { return (long long)cs_smem(mi, d); }

#ifdef CS_CLOCKS
extern "C" int cell_select_clocks(unsigned long long* out) {
    unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
    cudaError_t e = cudaMemcpyFromSymbol(out, cs_clocks, sizeof(zero));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(cs_clocks, zero, sizeof(zero));
    return (int)e;
}
#endif
