// K11 sq8_scan: asymmetric L2² k-NN over a u8 (SQ8) store, per row chunk.
//
// Replaces: turdb_tpu/ops/quantize.py `sq8_search` (quantize.py:42-76):
// with x̂ = min + scale·u,
//   d(q, x̂) = qn − 2·(min·Σq + scale·(q·u)) + (d·min² + 2·min·scale·Σu + scale²·Σu²),
// clamped at 0, +inf where `valid` is false, then the k smallest. The
// reference's q·u is a `dot_general` with no `precision`: one bf16 pass of
// its TPU's matrix unit (full fp32 only on the CPU).
//
// What bounds it on an H100: operations. B x N x d multiply-adds (268
// GFLOP at B = 1024, N = 1M, d = 128: 4.0 ms on the fp32 unit at 67
// TFLOP/s) against N·d code bytes (128 MB, 0.04 ms at 3.35 TB/s). Here the
// products run on the int8 tensor cores, four passes (0.54 ms at 1,979
// TOP/s): the u8 codes are the A operand as they are (mma .u8 x .s8), and
// each query is written under a power-of-two scale S (max|q| / S <= 127)
// as four int8 fixed-point digits, q̃ = S·(D0 + D1·2^-7 + D2·2^-14 +
// D3·2^-21) (D0 in [-127, 127], the others in [-64, 64]: each digit is the
// rounded remainder of the last, scaled by 2^7, all exact in fp32). Each
// pass's s32 sum At = Σ u·Dt is exact; they are joined in s32 as
// T = A0·2^7 + A1 + round((A2·2^7 + A3)·2^-14) (exact below 2^31 up to
// SQ_D_MAX but for the last rounding, half a unit of T), and q·u = S·2^-7·T
// with one rounding, in the conversion of T to fp32. So q·u is exact up
// to q − q̃, at most S·2^-22 an element (28 bits below the query's largest
// element; an element within 2^-4 of it is exact), half a unit of T
// (S·2^-8: below the fp32 rounding of a sum of d products), and the
// conversion.
// The reference's own product is one bf16 pass on its TPU.
//
// Design. Two launches. A pre-pass writes each row's record (‖x̂‖², min,
// scale): Σu and Σu² as exact `__dp4a` sums, ‖x̂‖² rounded op by op as the
// plain version, +inf for a row that is not valid. Then a 256-thread block
// owns 64 queries and one chunk of rows, which it sweeps in tiles of 64
// rows; the blocks of one chunk are neighbours in the grid (the query tile
// varies fastest), so a chunk's codes (1 MB at 8192 x 128) cross device
// memory about once and the other query tiles read them from L2. The code
// tiles and their row records are staged by `cp.async` (16-byte words,
// rows padded 16 bytes past a multiple of 32: no bank conflicts) into a
// three-stage ring, two tiles ahead: a tile costs one block barrier, and
// two blocks share an SM. Each of the 8 warps owns 8 queries (one n8
// tile), their digits in shared memory, and all 64 rows of a tile:
// mma.sync.m16n8k32 (u8 x s8, s32 accumulate), one accumulator a digit,
// fragments by ldmatrix. The epilogue works on the accumulator fragments
// and keeps the reference's rounding, op by op.
//
// The selection (k <= SQ_LIST_MAX) is warp-private: each query keeps a
// running threshold, the k-th best distance so far (+inf until it has k),
// and a buffer of CAP (64 or 128) (distance key, row) candidates in shared
// memory. A distance below the threshold is appended (an atomic slot); at
// k = 10 almost every distance is one compare. After each 16 rows, a query
// whose next 16 appends could overflow its buffer is compacted by its
// warp: a warp bitonic sort of (key, row), the k best kept, the threshold
// tightened. The warp meets its rows in ascending order, so a later row
// equal to the threshold loses to every kept one: ties go to the lower
// row. At the chunk's end each buffer is sorted and its k best written;
// one K2 launch (topk_rows) merges the chunks, ties to the lower chunk,
// i.e. the lower row. Wider k (any k: K2 takes it) runs the same product
// with the distances written out ([rows, N] for a slice of queries) and
// one K2 selection a slice.
//
// Rows wider than SQ_D_MAX (whose tiles and digits would not fit a block)
// run in the distance mode in column slices of at most SQ_D_MAX, one
// launch each: every slice's digits share the scale S of the whole row,
// a slice's joined sum T_s goes to the distance buffer as fp32 and the
// next slice adds its own (one more fp32 rounding a slice), and the last
// slice applies the epilogue to the sum.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch_util.cuh"
#include "select.cuh"

#define SQ_TQ 64          // queries a block
#define SQ_TN 64          // rows a tile
#define SQ_THREADS 256
#define SQ_QW 8           // queries a warp: one n8 tile
#define SQ_STAGES 3       // code tiles in the cp.async ring
#define SQ_LIST_MAX 64    // widest k of the list mode
#define SQ_D_MAX 320      // widest row whose tiles, digits and buffers fit a block
#define SQ_SMALL_K 24     // widest k that takes CAP = 64 (room for 24 appends)

typedef unsigned long long u64;

// Built with -DSQ8_PHASE_CLOCKS (scripts/exp_torch_probe_kernels.py
// --k11-only), thread 0 of every block adds the cycles of each phase to
// sq8_clocks: 0 the tensor-core product, 1 the epilogue and the threshold
// compares (the selection) with its compactions, 2 the wait for the next
// tile's copy, 3 the barrier, 4 the final sort and outputs; 5 counts the
// blocks. sq8_scan_clocks reads and clears them.
#ifdef SQ8_PHASE_CLOCKS
__device__ unsigned long long sq8_clocks[6];
#define SQ_MARK(i)                                                                    \
    do {                                                                              \
        if (threadIdx.x == 0) {                                                       \
            const long long now = clock64();                                          \
            atomicAdd(sq8_clocks + (i), (unsigned long long)(now - mark));            \
            mark = now;                                                               \
        }                                                                             \
    } while (0)
#else
#define SQ_MARK(i) \
    do {           \
    } while (0)
#endif

__device__ __forceinline__ void sq_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void sq_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void sq_ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// c += a (16 x 32 u8, row-major) · b (32 x 8 s8, column-major), s32
__device__ __forceinline__ void sq_mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A row's record: ‖x̂‖² (+inf where the row is not valid), min, scale.
// Rows are `ld` codes apart, the first d of them the row's (the rest zero).
__global__ void __launch_bounds__(256)
sq8_rows_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ mins,
                const float* __restrict__ scales, const uint8_t* __restrict__ valid, int N,
                int d, int ld, float4* __restrict__ rec) {
    const int row = blockIdx.x * 32 + (threadIdx.x >> 3), part = threadIdx.x & 7;
    uint32_t su = 0, sq = 0;
    if (row < N) {
        const uint8_t* c = codes + (size_t)row * ld;
        for (int w = part; 4 * w < ld; w += 8) {   // ld is a multiple of 16
            const uint32_t word = *reinterpret_cast<const uint32_t*>(c + 4 * w);
            su = __dp4a(word, 0x01010101u, su);
            sq = __dp4a(word, word, sq);
        }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
        su += __shfl_xor_sync(0xffffffffu, su, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    if (part == 0 && row < N) {
        const float m = mins[row], s = scales[row];
        // (d·min² + (2·min)·scale·Σu) + scale²·Σu², rounded op by op (the
        // integer sums are exact in fp32)
        const float t0 = __fmul_rn((float)d, __fmul_rn(m, m));
        const float t1 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, m), s), (float)su);
        const float t2 = __fmul_rn(__fmul_rn(s, s), (float)sq);
        const float xn = __fadd_rn(__fadd_rn(t0, t1), t2);
        const bool ok = valid == nullptr || valid[row];
        rec[row] = make_float4(ok ? xn : __int_as_float(0x7f800000), m, s, 0.0f);
    }
}

struct SqLayout {
    int dp;        // ld rounded up to 32 (the k32 steps)
    int rsb;       // bytes a shared row (a code row or a query's digits): dp + 16
    int cap;       // a query's candidate buffer (0: the distance mode)
    __host__ __device__ SqLayout(int ld, int cap_)
        : dp((ld + 31) / 32 * 32), rsb(dp + 16), cap(cap_) {}
    __host__ __device__ size_t buf_bytes() const { return (size_t)SQ_TQ * cap * sizeof(u64); }
    __host__ __device__ size_t digit_bytes() const { return (size_t)4 * SQ_TQ * rsb; }
    __host__ __device__ size_t tile_bytes() const { return (size_t)SQ_TN * rsb; }
    __host__ __device__ size_t bytes() const {
        return buf_bytes() + digit_bytes() + SQ_STAGES * tile_bytes() +
               (size_t)SQ_STAGES * SQ_TN * sizeof(float4) + (size_t)SQ_TQ * 3 * sizeof(int);
    }
};

// A column slice's part in a d-sliced distance pass: PART_IN adds the
// partial sums the earlier slices left in `dist`, PART_OUT leaves the
// partial sums there for the next slice (no epilogue).
#define PART_IN 1
#define PART_OUT 2

// CAP = 32·J candidates a query in the list mode (out_d set); the distance
// mode (dist set) keeps none. q [B, ldr] and codes [N, ldr] hold the rows,
// ldr a multiple of 16, zero past the data; a launch reads the columns
// [c0, c0 + ld) (all of them but in a d-sliced pass, SLICED: only its
// instance reads `part`, so the others keep their registers).
template <int J, bool SLICED>
__global__ void __launch_bounds__(SQ_THREADS, 2)
sq8_scan_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                const float* __restrict__ qsum, int B, const uint8_t* __restrict__ codes,
                const float4* __restrict__ rec, int N, int ldr, int c0, int ld, int chunk, int k,
                float* __restrict__ out_d, int* __restrict__ out_i, float* __restrict__ dist,
                long long ld_dist, int part) {
    constexpr int CAP = 32 * J;
    extern __shared__ __align__(16) unsigned char smem[];
    const bool list = out_d != nullptr;
    const SqLayout L(ld, list ? CAP : 0);
    u64* s_buf = reinterpret_cast<u64*>(smem);
    int8_t* s_qd = reinterpret_cast<int8_t*>(smem + L.buf_bytes());       // [4][SQ_TQ][rsb]
    uint8_t* s_u8 = reinterpret_cast<uint8_t*>(s_qd + L.digit_bytes());  // [stages][SQ_TN][rsb]
    float4* s_rec = reinterpret_cast<float4*>(s_u8 + SQ_STAGES * L.tile_bytes());
    int* s_cnt = reinterpret_cast<int*>(s_rec + SQ_STAGES * SQ_TN);
    float* s_thr = reinterpret_cast<float*>(s_cnt + SQ_TQ);
    float* s_qs = s_thr + SQ_TQ;                                         // the queries' S

    const float INF = __int_as_float(0x7f800000);
    const unsigned FULL = 0xffffffffu;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = blockIdx.x * SQ_TQ;
    const int wq0 = warp * SQ_QW;               // the warp's first query in the block
    const int r_begin = blockIdx.y * chunk;
    const int r_end = min(N, r_begin + chunk);
    const int ntiles = (r_end - r_begin + SQ_TN - 1) / SQ_TN;
    const int words = ld / 16;                  // 16-byte words of a row
#ifdef SQ8_PHASE_CLOCKS
    long long mark = clock64();
#endif

    // tile t of the chunk (codes and row records) into ring slot t % 3
    auto stage = [&](int t) {
        const int slot = t % SQ_STAGES;
        const int r0 = r_begin + t * SQ_TN;
        const int nrows = min(SQ_TN, r_end - r0);
        const uint8_t* src = codes + (size_t)r0 * ldr + c0;
        uint8_t* dst = s_u8 + slot * L.tile_bytes();
        for (int e = tid; e < nrows * words; e += SQ_THREADS) {
            const int r = e / words, w = e % words;
            stage_copy16(dst + r * L.rsb + 16 * w, src + (size_t)r * ldr + 16 * w);
        }
        if (tid < SQ_TN) {
            float4* r = s_rec + slot * SQ_TN + tid;
            if (tid < nrows) stage_copy16(r, rec + r0 + tid);
            else *r = make_float4(INF, 0.0f, 0.0f, 0.0f);   // past the chunk: +inf
        }
        sq_commit();
    };

    stage(0);
    if (ntiles > 1) stage(1);
    // the warp's queries: their scale S = 2^e (max|q| / S <= 127, over the
    // whole row) and the four digits of the slice, zero past it and past B
    for (int j = 0; j < SQ_QW; ++j) {
        const int qq = wq0 + j, gq = q0 + qq;
        const float* row = q + (size_t)gq * ldr;
        uint32_t mx = 0;
        if (gq < B)
            for (int c = lane; c < ldr; c += 32) mx = max(mx, __float_as_uint(fabsf(row[c])));
        mx = __reduce_max_sync(FULL, mx);
        int ex = 0;
        frexpf(__uint_as_float(mx) / 127.0f, &ex);
        if (lane == 0) s_qs[qq] = ldexpf(1.0f, ex);
        for (int c = lane; c < L.dp; c += 32) {
            float x = (gq < B && c < ld) ? ldexpf(row[c0 + c], -ex) : 0.0f;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const float dt = rintf(x);
                s_qd[(t * SQ_TQ + qq) * L.rsb + c] = (int8_t)(int)dt;
                x = (x - dt) * 128.0f;
            }
        }
    }
    if (list && tid < SQ_TQ) {
        s_cnt[tid] = 0;
        s_thr[tid] = INF;
    }
    __syncwarp();
    // this lane's two queries: fragment columns 2·(lane & 3) + h; their
    // qn, Σq / S' and −2·S' (S' = S·2^-7), and the threshold of the
    // clamped distance as a test of the unclamped one (a threshold of 0
    // admits nothing: -inf)
    float tqn[2], tqs[2], tm2s[2], thr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qq = wq0 + 2 * (lane & 3) + h, gq = q0 + qq;
        const float sp = s_qs[qq] * 0.0078125f;
        tqn[h] = gq < B ? qn[gq] : 0.0f;
        tqs[h] = gq < B ? qsum[gq] / sp : 0.0f;
        tm2s[h] = -2.0f * sp;
        thr[h] = INF;
    }
    if (ntiles > 1) sq_wait<1>();
    else sq_wait<0>();
    __syncthreads();

    // the warp's query `qq` (in the block): its buffer sorted, the k best kept,
    // the threshold their k-th
    auto compact = [&](int qq) {
        u64* buf = s_buf + (size_t)qq * CAP;
        const int cnt = s_cnt[qq];
        u64 v[J];
#pragma unroll
        for (int i = 0; i < J; ++i) {
            const int e = i * 32 + lane;
            v[i] = e < cnt ? buf[e] : ~0ull;
        }
        warp_bitonic<J>(v, lane);
        u64 kth = 0;
#pragma unroll
        for (int i = 0; i < J; ++i) {
            const int e = i * 32 + lane;
            if (e < k) buf[e] = v[i];
            const u64 x = __shfl_sync(FULL, v[i], (k - 1) & 31);
            if (i == (k - 1) >> 5) kth = x;
        }
        __syncwarp();
        if (lane == 0) {
            s_cnt[qq] = k;
            s_thr[qq] = key2f((uint32_t)(kth >> 32));
        }
        __syncwarp();
    };

    const uint8_t* a_lane = s_u8 + (lane & 15) * L.rsb + (lane >> 4) * 16;
    // digits 0 and 1 by one x4 (lanes 16-31 address digit 1), 2 and 3 by another
    const int8_t* b_lane =
        s_qd + ((lane >> 4) * SQ_TQ + wq0 + (lane & 7)) * L.rsb + ((lane >> 3) & 1) * 16;

    for (int t = 0; t < ntiles; ++t) {
        const int r0 = r_begin + t * SQ_TN;
        if (t + 2 < ntiles) stage(t + 2);
        int acc[4][4][4];   // [digit][m-tile][fragment]
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[g][mi][c] = 0;
        const uint8_t* a_base = a_lane + (t % SQ_STAGES) * L.tile_bytes();
#pragma unroll 1
        for (int k0 = 0; k0 < L.dp; k0 += 32) {
            uint32_t b01[4], b23[4], a[4][4];
            sq_ldmatrix_x4(b01, b_lane + k0);
            sq_ldmatrix_x4(b23, b_lane + 2 * SQ_TQ * L.rsb + k0);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) sq_ldmatrix_x4(a[mi], a_base + mi * 16 * L.rsb + k0);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                sq_mma(acc[0][mi], a[mi], b01[0], b01[1]);
                sq_mma(acc[1][mi], a[mi], b01[2], b01[3]);
                sq_mma(acc[2][mi], a[mi], b23[0], b23[1]);
                sq_mma(acc[3][mi], a[mi], b23[2], b23[3]);
            }
        }
        SQ_MARK(0);
        // epilogue: q·u = S'·T (S' = S·2^-7, T the joined sums), then
        // qn − 2·(min·Σq + scale·(q·u)) + ‖x̂‖², rounded op by op: with
        // the power of two S' moved out of the products (qs' = Σq / S'),
        // min·qs' + scale·T is (min·Σq + scale·(q·u)) / S' exactly, and the
        // product by −2·S' is exact inside the fused multiply-add
        const float4* recs = s_rec + (t % SQ_STAGES) * SQ_TN;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
                const int rr = 16 * mi + (lane >> 2) + 8 * h2;
                const int gr = r0 + rr;
                const float4 R = recs[rr];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int f = 2 * h2 + h;
                    const int qq = wq0 + 2 * (lane & 3) + h;
                    const int t = acc[0][mi][f] * 128 + acc[1][mi][f] +
                                  ((acc[2][mi][f] * 128 + acc[3][mi][f] + 8192) >> 14);
                    float tf = __int2float_rn(t);
                    if constexpr (SLICED) {   // a slice of a d-sliced distance pass
                        const bool in = gr < r_end && q0 + qq < B;
                        float* o = dist + (size_t)(q0 + qq) * ld_dist + gr;
                        if ((part & PART_IN) && in) tf = __fadd_rn(*o, tf);
                        if (part & PART_OUT) {
                            if (in) *o = tf;
                            continue;
                        }
                    }
                    const float q2 = __fadd_rn(__fmul_rn(R.y, tqs[h]), __fmul_rn(R.z, tf));
                    // (qn − 2·qdx) + ‖x̂‖², before the clamp at 0
                    const float x = __fadd_rn(__fmaf_rn(tm2s[h], q2, tqn[h]), R.x);
                    if (list) {
                        if (x < thr[h]) {   // thr > 0, or -inf: as the clamped value's test
                            const int slot = atomicAdd(s_cnt + qq, 1);
                            s_buf[(size_t)qq * CAP + slot] =
                                ((u64)f2key(fmaxf(x, 0.0f)) << 32) | (uint32_t)gr;
                        }
                    } else if (gr < r_end && q0 + qq < B) {
                        dist[(size_t)(q0 + qq) * ld_dist + gr] = fmaxf(x, 0.0f);
                    }
                }
            }
            if (list) {
                // a buffer the next 16 rows could overflow is compacted now
                __syncwarp();
                const int cnt = lane < SQ_QW ? s_cnt[wq0 + lane] : 0;
                unsigned need = __ballot_sync(FULL, cnt > CAP - 16);
                if (need) {
                    while (need) {
                        compact(wq0 + __ffs(need) - 1);
                        need &= need - 1;
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float t = s_thr[wq0 + 2 * (lane & 3) + h];
                        thr[h] = t > 0.0f ? t : -INF;
                    }
                }
            }
        }
        SQ_MARK(1);
        if (t + 1 < ntiles) {
            if (t + 2 < ntiles) sq_wait<1>();
            else sq_wait<0>();
        }
        SQ_MARK(2);
        __syncthreads();   // tile t + 1 in shared memory; tile t's slot free
        SQ_MARK(3);
    }
    if (!list) return;
    // each of the warp's queries: its buffer sorted by (key, row), its k best
    // (+inf / -1 past the buffer) to the chunk's list
    const size_t nch = gridDim.y;
#pragma unroll 1
    for (int j = 0; j < SQ_QW; ++j) {
        const int qq = wq0 + j;
        const int gq = q0 + qq;
        if (gq >= B) break;
        const int cnt = s_cnt[qq];
        const u64* buf = s_buf + (size_t)qq * CAP;
        u64 v[J];
#pragma unroll
        for (int i = 0; i < J; ++i) {
            const int e = i * 32 + lane;
            v[i] = e < cnt ? buf[e] : ~0ull;
        }
        warp_bitonic<J>(v, lane);
        const size_t o = ((size_t)gq * nch + blockIdx.y) * k;
#pragma unroll
        for (int i = 0; i < J; ++i) {
            const int e = i * 32 + lane;
            if (e < k) {
                const bool has = e < cnt;
                out_d[o + e] = has ? key2f((uint32_t)(v[i] >> 32)) : INF;
                out_i[o + e] = has ? (int)(uint32_t)v[i] : -1;
            }
        }
    }
    SQ_MARK(4);
#ifdef SQ8_PHASE_CLOCKS
    if (tid == 0) atomicAdd(sq8_clocks + 5, 1ull);
#endif
}

template <int J, bool SLICED>
static int sq8_launch(dim3 grid, size_t smem, cudaStream_t s, const float* q, const float* qn,
                      const float* qsum, int B, const uint8_t* codes, const float4* rec, int N,
                      int ldr, int c0, int ld, int chunk, int k, float* out_d, int* out_i,
                      float* dist, long long ld_dist, int part) {
    const int err = raise_smem(sq8_scan_kernel<J, SLICED>, smem);
    if (err) return err;
    sq8_scan_kernel<J, SLICED><<<grid, SQ_THREADS, smem, s>>>(
        q, qn, qsum, B, codes, rec, N, ldr, c0, ld, chunk, k, out_d, out_i, dist, ld_dist, part);
    return (int)cudaGetLastError();
}

// List mode (out_d, out_i set; k <= SQ_LIST_MAX): a [B, chunks x k] list.
// Distance mode (dist set, row stride ld_dist): every distance of the
// B x N block. q [B, ldr] and codes [N, ldr] (16-byte aligned) hold the
// d-wide rows zero-padded to ldr, a multiple of 16; a launch reads the
// columns [c0, c0 + ld), ld a multiple of 16 up to SQ_D_MAX: all of them
// (part 0), or one slice of a d-sliced distance pass (`part`: PART_IN
// past the first slice, PART_OUT before the last). `rec` [N] float4 holds
// the row records, written first (over all ldr columns) unless
// `rec_ready`. chunk a multiple of SQ_TN.
extern "C" int sq8_scan(const float* q, const float* qn, const float* qsum, int B,
                        const uint8_t* codes, const float* mins, const float* scales,
                        const uint8_t* valid, int N, int d, int ldr, int c0, int ld, int chunk,
                        int k, float* out_d, int* out_i, float* dist, long long ld_dist,
                        float* rec, int rec_ready, int part, void* stream) {
    const bool list = out_d != nullptr;
    if (B < 1 || N < 1 || d < 1 || ldr < d || ldr % 16 || ld < 16 || ld % 16 ||
        ld > SQ_D_MAX || c0 < 0 || c0 % 16 || c0 + ld > ldr || part < 0 || part > 3 ||
        (part == 0 && (c0 != 0 || ld != ldr)) || chunk < 1 || chunk % SQ_TN || rec == nullptr ||
        (list ? (k < 1 || k > SQ_LIST_MAX || out_i == nullptr || part != 0)
              : (dist == nullptr || ld_dist < N)) ||
        ((uintptr_t)codes & 15))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((B + SQ_TQ - 1) / SQ_TQ, (N + chunk - 1) / chunk);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    float4* rec4 = reinterpret_cast<float4*>(rec);
    if (!rec_ready) {
        sq8_rows_kernel<<<(N + 31) / 32, 256, 0, s>>>(codes, mins, scales, valid, N, d, ldr, rec4);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    // the smallest CAP that leaves room for 24 appends between compactions
    if (part != 0)
        return sq8_launch<2, true>(grid, SqLayout(ld, 0).bytes(), s, q, qn, qsum, B, codes, rec4,
                                   N, ldr, c0, ld, chunk, k, out_d, out_i, dist, ld_dist, part);
    if (!list || k <= SQ_SMALL_K)
        return sq8_launch<2, false>(grid, SqLayout(ld, list ? 64 : 0).bytes(), s, q, qn, qsum, B,
                                    codes, rec4, N, ldr, c0, ld, chunk, k, out_d, out_i, dist,
                                    ld_dist, 0);
    return sq8_launch<4, false>(grid, SqLayout(ld, 128).bytes(), s, q, qn, qsum, B, codes, rec4,
                                N, ldr, c0, ld, chunk, k, out_d, out_i, dist, ld_dist, 0);
}

#ifdef SQ8_PHASE_CLOCKS
extern "C" int sq8_scan_clocks(unsigned long long* out) {
    unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
    cudaError_t e = cudaMemcpyFromSymbol(out, sq8_clocks, sizeof(zero));
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(sq8_clocks, zero, sizeof(zero));
    return (int)e;
}
#endif
