// K5 ivf_rerank: the exact rerank of an IVF probe's candidates.
//
// Replaces: turdb_tpu/models/ivf.py ivf_search_impl, the rerank branch
// (the gather of r rows by flat position from the f32 row store or the
// SQ16 compact store, dequantized with base = m' - 128*scale and
// s16 = scale*255/65535; the PRECISE fp32 dots; qn + pnorms - 2*dot, +inf
// where the probe's candidate was +inf; mask_duplicates under replicas;
// the final top-k). Like the reference, the exact distance is L2 whatever
// the index's metric.
//
// What bounds it on an H100: memory latency. A query reads r rows of 4d
// (f32) or 2d (SQ16) bytes plus 12 bytes of candidate and 4-12 of row
// metadata, scattered over the store: little of the card's bandwidth, but
// every row depends on its candidate's position, so a query's time is its
// chain of dependent trips to device memory.
//
// Design: one 128-thread block per query (eight blocks an SM by its bound,
// so B = 1024 queries run in one wave on 132 SMs; 256 threads at 40
// registers ran six, two waves) and two dependent trips. First
// the query's r (distance, id, position) triples in one coalesced pass into
// shared memory (a candidate whose probe distance is +inf keeps no
// position and is not read). Then, a chunk of up to K5_STAGE_BYTES of rows
// at a time (all r rows at the sq8 rows' r = 40), every row load in flight
// at once: each thread's 16-byte (or 8-byte) cp.async of neighbouring
// words of the chunk's rows into shared memory, and one thread a row the
// row's norm (and SQ16 min and scale). Each warp then sums its candidates
// from shared memory, K5_ROWS rows at once (their loads, sums and
// butterflies interleaved), each as before the rows were staged: lane j
// over elements 4m .. 4m+3 for m = j, j + 32, ... in order (dequantizing
// SQ16 elements as the plain expression rounds them, __fadd_rn(base,
// __fmul_rn(s16, u))), then an xor butterfly; the exact distances are
// those of the kernel that read each row from device memory a warp at a
// time. Under replicas a candidate is dropped when an earlier candidate
// holds its id (copies of a row are encoded alike, so their exact
// distances tie: the reference keeps the first by candidate order). The k
// smallest by (exact distance, candidate index), ties to the earlier
// candidate: up to K5_THREADS candidates as runs of 32 (key, index) pairs
// sorted by a warp each and ranked by binary searches of the other runs
// (block_select's radix passes held a third of the block's cycles at r = 40);
// wider, block_select (select.cuh).
#include <algorithm>

#include "async_copy.cuh"
#include "graph_util.cuh"
#include "launch_util.cuh"
#include "select.cuh"

// bytes of staged rows a chunk (f32 d = 128: 48 rows; SQ16: 96)
#define K5_STAGE_BYTES 24576
#define K5_THREADS 128   // a query's block (block_select takes up to SEL_THREADS)
#define K5_ROWS 4        // rows a warp sums at once (8 spilled at the bound)

// Built with -DRERANK_PHASE_CLOCKS (scripts/exp_torch_probe_kernels.py
// --variant), thread 0 of every block adds the cycles of each phase to
// rerank_clocks: 0 the query and candidates, 1 the rows' copies and
// metadata, 2 the dots, 3 the duplicates, 4 the selection, 5 the outputs;
// 6 counts the blocks; and rerank_span keeps the launch's first block start
// and last block end (%globaltimer, ns). ivf_rerank_clocks reads and clears
// them: out[0..7] the clocks, out[8] the span in ns.
#ifdef RERANK_PHASE_CLOCKS
__device__ unsigned long long rerank_clocks[8];
__device__ unsigned long long rerank_span[2] = {~0ull, 0ull};
__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define RERANK_MARK(i)                                                                \
    do {                                                                              \
        if (threadIdx.x == 0) {                                                       \
            const long long now = clock64();                                          \
            atomicAdd(rerank_clocks + (i), (unsigned long long)(now - mark));         \
            mark = now;                                                               \
        }                                                                             \
    } while (0)

extern "C" int ivf_rerank_clocks(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, rerank_clocks, sizeof(rerank_clocks));
    unsigned long long span[2];
    if (e == cudaSuccess) e = cudaMemcpyFromSymbol(span, rerank_span, sizeof(span));
    if (e == cudaSuccess) {
        out[8] = span[1] > span[0] ? span[1] - span[0] : 0;
        const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0}, reset[2] = {~0ull, 0ull};
        e = cudaMemcpyToSymbol(rerank_clocks, zero, sizeof(zero));
        if (e == cudaSuccess) e = cudaMemcpyToSymbol(rerank_span, reset, sizeof(reset));
    }
    return (int)e;
}
#else
#define RERANK_MARK(i) \
    do {               \
    } while (0)
#endif

__host__ __device__ inline size_t k5_align16(size_t n) { return (n + 15) & ~(size_t)15; }

// the layout of a block's shared memory, in bytes from its start
struct RerankSmem {
    size_t key, pos, q, ex, id, row, meta, stage, total;
};

__host__ __device__ inline RerankSmem rerank_smem(int r, int d, int k, int chunk, int row_bytes) {
    RerankSmem m;
    const int kp = sel_pow2(k);
    m.key = sizeof(SelectScratch);
    m.pos = m.key + (size_t)kp * 4;
    m.q = k5_align16(m.pos + (size_t)kp * 4);
    m.ex = m.q + (size_t)d * 4;
    m.id = m.ex + (size_t)r * 4;
    m.row = m.id + (size_t)r * 4;
    m.meta = m.row + (size_t)r * 4;
    m.stage = k5_align16(m.meta + (size_t)chunk * 12);
    // the rows, then (r <= K5_THREADS) the sorted keys
    const size_t rows = (size_t)chunk * row_bytes, keys = (size_t)r * 8;
    m.total = m.stage + (rows > keys ? rows : keys);
    return m;
}

template <bool SQ16>
__global__ void __launch_bounds__(K5_THREADS, 8)
rerank_kernel(const float* __restrict__ q, const float* __restrict__ qn,
              const float* __restrict__ cand_d, const int* __restrict__ cand_i,
              const int* __restrict__ cand_pos, int r, const void* __restrict__ rows,
              const float* __restrict__ pnorms, const float* __restrict__ mins,
              const float* __restrict__ scales, int d, int k, int replicated, int chunk,
              int wb, float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int row_bytes = SQ16 ? 2 * d : 4 * d;
    const RerankSmem m = rerank_smem(r, d, k, chunk, row_bytes);
    SelectScratch* sc = reinterpret_cast<SelectScratch*>(smem);
    uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + m.key);
    int* s_pos = reinterpret_cast<int*>(smem + m.pos);
    float* s_q = reinterpret_cast<float*>(smem + m.q);
    const float4* q4 = reinterpret_cast<const float4*>(s_q);
    uint32_t* s_ex = reinterpret_cast<uint32_t*>(smem + m.ex);
    int* s_id = reinterpret_cast<int*>(smem + m.id);
    int* s_row = reinterpret_cast<int*>(smem + m.row);       // flat position, -1: not read
    float* s_meta = reinterpret_cast<float*>(smem + m.meta);  // [chunk][3] norm, base, s16
    unsigned char* stage = smem + m.stage;                    // [chunk] rows of row_bytes

    const size_t b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
#ifdef RERANK_PHASE_CLOCKS
    long long mark = clock64();
    if (tid == 0) atomicMin(rerank_span, global_ns());
#endif
    // trip 1: the query row and the candidates
    for (int i = tid; i < d; i += blockDim.x) s_q[i] = q[b * d + i];
    for (int i = tid; i < r; i += blockDim.x) {
        const float cd = cand_d[b * r + i];
        s_id[i] = cand_i[b * r + i];
        s_row[i] = isinf(cd) ? -1 : cand_pos[b * r + i];
    }
    const float qnb = qn[b];
    __syncthreads();
    RERANK_MARK(0);

    const float s16_ratio = (float)(255.0 / 65535.0);
    const int words = row_bytes / wb;  // copies a row
    const bool pow2 = (words & (words - 1)) == 0;  // d = 128: 32 (f32) or 16 (SQ16)
    const int sh = __popc(words - 1);
    for (int c0 = 0; c0 < r; c0 += chunk) {
        const int n = min(chunk, r - c0);
        // trip 2: every copy of the chunk's rows, and their metadata
        for (int e = tid; e < n * words; e += blockDim.x) {
            const int i = pow2 ? e >> sh : e / words, w = e - i * words;
            const int pos = s_row[c0 + i];
            if (pos >= 0) {
                unsigned char* dst = stage + (size_t)i * row_bytes + (size_t)w * wb;
                const unsigned char* src =
                    static_cast<const unsigned char*>(rows) + (size_t)pos * row_bytes +
                    (size_t)w * wb;
                if (wb == 16) stage_copy16(dst, src);
                else stage_copy8(dst, src);
            }
        }
        float pn = 0.0f, base = 0.0f, s16 = 0.0f;
        const int pos = tid < n ? s_row[c0 + tid] : -1;
        if (pos >= 0) {
            pn = pnorms[pos];
            if (SQ16) {
                const float sr = scales[pos];
                base = __fsub_rn(mins[pos], __fmul_rn(128.0f, sr));
                s16 = __fmul_rn(sr, s16_ratio);
            }
        }
        stage_wait();
        if (tid < n) {
            s_meta[3 * tid] = pn;
            s_meta[3 * tid + 1] = base;
            s_meta[3 * tid + 2] = s16;
        }
        __syncthreads();
        RERANK_MARK(1);
        // a warp's rows K5_ROWS at a time, their loads, sums and
        // butterflies interleaved (each row's own order unchanged)
        for (int i0 = warp; i0 < n; i0 += nwarps * K5_ROWS) {
            float acc[K5_ROWS], rb[K5_ROWS], rs[K5_ROWS];
            bool live[K5_ROWS];  // warp-uniform
            int soff[K5_ROWS];   // the row's byte offset in the stage
#pragma unroll
            for (int g = 0; g < K5_ROWS; ++g) {
                const int i = i0 + g * nwarps;
                live[g] = i < n && s_row[c0 + i] >= 0;
                soff[g] = (live[g] ? i : 0) * row_bytes;
                acc[g] = 0.0f;
                rb[g] = SQ16 && live[g] ? s_meta[3 * i + 1] : 0.0f;
                rs[g] = SQ16 && live[g] ? s_meta[3 * i + 2] : 0.0f;
            }
            for (int j = lane; j < (d >> 2); j += 32) {
                const float4 y = q4[j];
#pragma unroll
                for (int g = 0; g < K5_ROWS; ++g) {
                    if (!live[g]) continue;
                    if (SQ16) {
                        const ushort4 u = reinterpret_cast<const ushort4*>(stage + soff[g])[j];
                        acc[g] = fmaf(__fadd_rn(rb[g], __fmul_rn(rs[g], (float)u.x)), y.x, acc[g]);
                        acc[g] = fmaf(__fadd_rn(rb[g], __fmul_rn(rs[g], (float)u.y)), y.y, acc[g]);
                        acc[g] = fmaf(__fadd_rn(rb[g], __fmul_rn(rs[g], (float)u.z)), y.z, acc[g]);
                        acc[g] = fmaf(__fadd_rn(rb[g], __fmul_rn(rs[g], (float)u.w)), y.w, acc[g]);
                    } else {
                        const float4 x = reinterpret_cast<const float4*>(stage + soff[g])[j];
                        acc[g] = fmaf(x.x, y.x, acc[g]);
                        acc[g] = fmaf(x.y, y.y, acc[g]);
                        acc[g] = fmaf(x.z, y.z, acc[g]);
                        acc[g] = fmaf(x.w, y.w, acc[g]);
                    }
                }
            }
            for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
                for (int g = 0; g < K5_ROWS; ++g) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
            }
#pragma unroll
            for (int g = 0; g < K5_ROWS; ++g) {
                const int i = i0 + g * nwarps;
                if (lane == 0 && i < n)
                    s_ex[c0 + i] =
                        live[g] ? f2key(__fsub_rn(__fadd_rn(qnb, s_meta[3 * i]), __fmul_rn(2.0f, acc[g])))
                                : INF_KEY;
            }
        }
        __syncthreads();  // the chunk's reads of the stage are done
        RERANK_MARK(2);
    }
    if (replicated) {  // mask_duplicates: later copies of an id, and id -1
        for (int i = tid; i < r; i += blockDim.x) {
            const int id = s_id[i];
            bool dup = id == -1;
            for (int j = 0; j < i; ++j) dup |= s_id[j] == id;  // no early exit: loads in flight
            if (dup) s_ex[i] = INF_KEY;
        }
        __syncthreads();
    }
    RERANK_MARK(3);
    if (r <= K5_THREADS) {
        // (key, candidate) runs of 32 sorted by one warp each; a key's rank
        // is its place in its run plus the keys below it in the other runs
        u64* keys = reinterpret_cast<u64*>(stage);
        if (warp * 32 < r) {  // warp-uniform
            const int j = warp * 32 + lane;
            const u64 key = warp_sort32(j < r ? ((u64)s_ex[j] << 32) | (unsigned)j : ~0ull, lane);
            if (j < r) keys[j] = key;
        }
        __syncthreads();
        RERANK_MARK(4);
        if (tid < r) {
            const u64 key = keys[tid];
            int rank = tid & 31;
            for (int o = 0; o < r && rank < k; o += 32)
                if (o != (tid & ~31)) rank += count_below(keys + o, min(32, r - o), key);
            if (rank < k) {
                const uint32_t kk = (uint32_t)(key >> 32);
                out_d[b * k + rank] = key2f(kk);
                out_i[b * k + rank] = kk < INF_KEY ? s_id[(int)(key & 0xffffffffu)] : -1;
            }
        }
    } else {
        block_select(ArrayKey{s_ex}, r, k, s_key, s_pos, sc);
        RERANK_MARK(4);
        for (int i = tid; i < k; i += blockDim.x) {
            const bool fin = s_key[i] < INF_KEY;
            out_d[b * k + i] = key2f(s_key[i]);
            out_i[b * k + i] = fin ? s_id[s_pos[i]] : -1;
        }
    }
#ifdef RERANK_PHASE_CLOCKS
    __syncthreads();
    RERANK_MARK(5);
    if (tid == 0) {
        atomicAdd(rerank_clocks + 6, 1ull);
        atomicMax(rerank_span + 1, global_ns());
    }
#endif
}

extern "C" int ivf_rerank(const float* q, const float* qn, const float* cand_d,
                          const int* cand_i, const int* cand_pos, int B, int r,
                          const void* rows, int sq16, const float* pnorms, const float* mins,
                          const float* scales, int d, int k, int replicated, float* out_d,
                          int* out_i, void* stream) {
    if (k < 1 || k > r || r > SEL_MAX || d % 4 != 0 || (size_t)rows % 16 ||
        (sq16 && (mins == nullptr || scales == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int row_bytes = sq16 ? 2 * d : 4 * d;
    // rows of whole 16-byte words are copied by 16 bytes, others (SQ16 at
    // d % 8 == 4) by 8; one thread loads each row's metadata, so a chunk
    // holds at most K5_THREADS rows
    const int wb = row_bytes % 16 == 0 ? 16 : 8;
    const int chunk = std::max(1, std::min({r, K5_THREADS, K5_STAGE_BYTES / row_bytes}));
    const size_t smem = rerank_smem(r, d, k, chunk, row_bytes).total;
    int e = sq16 ? raise_smem(rerank_kernel<true>, smem) : raise_smem(rerank_kernel<false>, smem);
    if (e) return e;
    if (sq16)
        rerank_kernel<true><<<B, K5_THREADS, smem, (cudaStream_t)stream>>>(
            q, qn, cand_d, cand_i, cand_pos, r, rows, pnorms, mins, scales, d, k, replicated,
            chunk, wb, out_d, out_i);
    else
        rerank_kernel<false><<<B, K5_THREADS, smem, (cudaStream_t)stream>>>(
            q, qn, cand_d, cand_i, cand_pos, r, rows, pnorms, mins, scales, d, k, replicated,
            chunk, wb, out_d, out_i);
    return (int)cudaGetLastError();
}
