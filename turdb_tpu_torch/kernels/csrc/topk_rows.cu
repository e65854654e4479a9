// K2 topk_rows: exact per-row k-smallest with an optional fused epilogue.
//
// Replaces: turdb_tpu/ops/topk.py topk_smallest / topk_smallest_wide /
// merge_topk, which serve the IVF cell selection
// (turdb_tpu/models/ivf.py ivf_search_impl, the q·Cᵀ top-nprobe), the flat
// oracle's per-chunk selection (turdb_tpu/models/flat.py flat_search) and
// the merges of top-k lists (the oracle's running merge, the mesh's
// cross-shard merge, sq8_search's chunk merge).
//
// What bounds it on an H100: device-memory bandwidth. The dot matrix comes
// from a cuBLAS fp32 product ([1024, ~24.6k] at the cell selection,
// [256, 131072] per flat chunk) and is read once; the selection itself is
// a few integer operations per value.
//
// Design. Each value is read from device memory once; every later pass
// runs on chip.
// - Long rows (N > SHORT_MAX): the grid is rows x segments of up to SEG_W
//   = 8192 columns. A 256-thread block reads its segment once (32 values a
//   thread, all loads issued before any is used, streamed past L1),
//   applies the L2 / cosine / IP epilogue and the column-valid mask as the
//   values arrive, and keeps the order-preserving 32-bit keys in shared
//   memory (32 KB), where every later pass reads them; registers stay few,
//   so several blocks share an SM and one block's loads overlap another's
//   passes. It finds its k smallest (key, position) pairs by radix select:
//   one pass counts the keys below +inf and takes their range, and when k
//   of them exist the +inf keys (masked lanes) stay out of every count;
//   8-bit digits of key - min then start at the top bit of the range, so
//   the first digit spreads the keys over the histogram instead of piling
//   them on one bin, and the passes stop as soon as the threshold's bin
//   holds exactly the keys still wanted. Only where more keys equal the
//   threshold than are wanted does a second select run, on their
//   positions, so the lower positions win. The segment's k winners go to
//   a scratch buffer; the last block of a row to finish (a per-row counter
//   after __threadfence, reset by that block) selects the k smallest of
//   the row's segments x k candidates the same way, reading them from L2,
//   and sorts them. One launch a call.
// - Short rows (N <= SHORT_MAX = 2048: the merges of [B, 2k], [B, S·k]):
//   a warp takes a row, several rows share a block, the (key, position)
//   pairs sit in registers (N rounded up to a power of two, at most 64 a
//   lane) and a warp bitonic sort orders them, with no radix passes.
// Ties go to the lower position, as lax.top_k does; the winners of a long
// row are sorted in shared memory (k <= SEL_MAX = 2048: 16 KB).
// - Wide k (k > SEL_MAX: the wide probes' [B, P·L] distances, K5 wide's
//   [B, r], a flat search or an SQ8 scan asked for thousands of
//   neighbours): `topk_cluster_kernel`, the row's keys in shared memory
//   over a thread block cluster of `ctas` CTAs (topk_rows_wide_ctas picks
//   it: a CTA per 8,192 columns or 1,024 winners, so at least 3, up to 8
//   portable, 16 where a row needs them to fit; cudaLaunchKernelEx with a
//   cluster dimension), each CTA an equal segment of the row. One CTA a
//   row lost to 3 at [64, 5000] k = 3000 and is not taken at any batch.
//   The row is read from device memory once. Every radix pass histograms each CTA's keys
//   in its own shared memory and sums the cluster's histograms through
//   distributed shared memory after a cluster barrier (two histogram
//   buffers, by pass parity, so one barrier a pass keeps a CTA from
//   clearing a histogram another still reads), so each CTA finds the same
//   threshold, the tie among equal keys included (its positions are the
//   row's). Each CTA then collects and sorts its own winners (a bitonic
//   sort of a few hundred to a thousand, 512 threads), copies the other
//   CTAs' sorted lists through distributed shared memory into its winners'
//   room after its own, and writes each of its winners at its place there
//   plus the other CTAs' winners below it (a binary search of each list):
//   no CTA sorts the row's k. Past what 16 CTAs hold (k >
//   16,384: the winners' room alone passes 227 KB; or more than 16 x
//   ~48k columns at k = 3000) the row runs the global form: a 256-thread
//   block a row writes its keys to a scratch row and reads them back from
//   L2 for each pass, and sorts its winners in a second scratch row.
// - K10 `dense_blocks`, fused (the dense IVF path's cell selection): given
//   `cell_block`, the block (or warp) that holds a row's sorted winners maps
//   them to their physical blocks and keeps the first u distinct ones
//   (`dense_ranks`, select.cuh), so the [B, P] cells never make a round
//   trip through device memory and the dense path makes one launch fewer.
//   A long row's blocks go through the keys' shared memory (free once the
//   winners are sorted); a short row's through 2·k ints a warp of dynamic
//   shared memory; a wide row's, read back from the row it wrote, through
//   CTA 0's winners' room.
// Shared memory of a long-row block: 1.1 KB + 32 KB of keys + 8·pow2(k),
// past the 48 KB default from k = 2048 (the entry point opts in); of a wide
// CTA, 3.5 KB + 4 bytes a column of its segment + 8·pow2(k) (its winners'
// room, which CTA 0 reuses for K10).
#include <cooperative_groups.h>

#include "launch_util.cuh"
#include "select.cuh"

namespace cg = cooperative_groups;

typedef unsigned long long u64;

#define SEG_THREADS 256
#define SEG_ITEMS 32
#define SEG_W (SEG_THREADS * SEG_ITEMS)   // columns of one segment
#define SHORT_MAX 2048
#define SHORT_WARPS 4                     // rows of one short-row block
#define WIDE_THREADS 512                  // a wide-k CTA
#define WIDE_SEG_COLS 8192                // columns a wide CTA takes at most by choice
#define WIDE_WIN 1024                     // winners a wide CTA sorts about, by choice
#define WIDE_CLUSTER 8                    // CTAs of a wide row's cluster by choice (portable)
#define WIDE_CTAS_MAX 16                  // and where its keys need them (non-portable)

// The distance the epilogue makes of x[row, j], as its order-preserving key:
// rounded as the reference (and the plain version) round it.
__device__ __forceinline__ uint32_t epi_key(float v, float rn, const float* __restrict__ coln,
                                            const uint8_t* __restrict__ valid, int j,
                                            int epi, int clamp) {
    if (epi == 1) {
        // (rown + coln) - 2*dot
        v = __fsub_rn(__fadd_rn(rn, __ldg(coln + j)), __fmul_rn(2.0f, v));
        if (clamp) v = fmaxf(v, 0.0f);
    } else if (epi == 2) {
        v = __fsub_rn(1.0f, v);
    } else if (epi == 3) {
        v = -v;
    }
    if (valid != nullptr && __ldg(valid + j) == 0) v = __int_as_float(0x7f800000);
    return f2key(v);
}

// 16-byte aligned: the keys and the u64 winners follow it in shared memory
template <int WARPS>
struct __align__(16) TopkSharedW {
    int hist[256];
    uint32_t st[5][WARPS];   // per-warp partial statistics
    int misc[4];
    int count;
};
typedef TopkSharedW<SEG_THREADS / 32> TopkShared;

__device__ __forceinline__ uint32_t shr(uint32_t v, int s) { return s >= 32 ? 0u : v >> s; }

// The block's sum / min / max of each v[j] (op[j] = 0, 1, 2), in every thread.
template <int NV, class Sh>
__device__ __forceinline__ void block_combine(uint32_t (&v)[NV], const int (&op)[NV], Sh* sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        v[j] = op[j] == 0 ? __reduce_add_sync(0xffffffffu, v[j])
             : op[j] == 1 ? __reduce_min_sync(0xffffffffu, v[j])
                          : __reduce_max_sync(0xffffffffu, v[j]);
        if (lane == 0) sh->st[j][warp] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        uint32_t r = sh->st[j][0];
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
            const uint32_t x = sh->st[j][w];
            r = op[j] == 0 ? r + x : op[j] == 1 ? min(r, x) : max(r, x);
        }
        v[j] = r;
    }
    __syncthreads();
}

// Where a selection's items live: one block holds them all (BlockSet), or
// each CTA of a cluster holds a segment (ClusterSet, topk_cluster_kernel).
// hist() is this pass's histogram of the block's own items, total(h) the
// set's histogram once every block's is in, combine() the set's sum / min
// / max of each block's values.
struct BlockSet {
    template <class Sh>
    __device__ __forceinline__ int* hist(Sh* sh) { return sh->hist; }
    __device__ __forceinline__ const int* total(int* h) { return h; }
    template <int NV, class Sh>
    __device__ __forceinline__ void combine(uint32_t (&v)[NV], const int (&op)[NV], Sh* sh) {
        block_combine(v, op, sh);
    }
};

// Radix select over 32-bit values: `val(key, pos, v)` says whether an item
// belongs to the set and gives its value v in [0, span]; `want` >= 1 of
// the set's smallest are wanted. 8-bit digits from the top bit of `span`
// down narrow (prefix, rem) until the bin of the want-th value holds
// exactly the values still wanted (returns true: every value v with
// v >> rem <= prefix wins) or every bit is fixed (returns false: the
// want-th value is `prefix` and more than `want` items hold it). All
// threads call it; `want` ends as the number still wanted from the last bin.
template <class Items, class Val, class Sh, class Set>
__device__ bool radix_narrow(const Items& items, Val val, uint32_t span, int& want,
                             uint32_t& prefix, int& rem, Sh* sh, Set& set) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    rem = 32 - __clz(span);
    prefix = 0;
    while (rem > 0) {
        const int w = rem < 8 ? rem : 8;
        const int shift = rem - w;
        const uint32_t dmask = (1u << w) - 1u;
        int* hist = set.hist(sh);
        for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0;
        __syncthreads();
        items.each([&](uint32_t key, uint32_t pos, bool ok) {
            uint32_t v;
            if (ok && val(key, pos, v) && shr(v, rem) == prefix)
                atomicAdd(&hist[(v >> shift) & dmask], 1);
        });
        __syncthreads();
        const int* tot = set.total(hist);
        if (warp == 0) {
            int cnt = 0;
#pragma unroll
            for (int i = 0; i < 8; ++i) cnt += tot[lane * 8 + i];
            int incl = cnt;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int x = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += x;
            }
            const unsigned hit = __ballot_sync(0xffffffffu, incl >= want);
            if (lane == __ffs(hit) - 1) {   // want <= the set's size: hit != 0
                int before = incl - cnt;
                int bin = lane * 8;
                while (before + tot[bin] < want) before += tot[bin++];
                sh->misc[0] = bin;
                sh->misc[1] = before;
                sh->misc[2] = tot[bin];
            }
        }
        __syncthreads();
        // every thread reads misc before warp 0 can write it again (two
        // barriers into the next pass)
        want -= sh->misc[1];
        prefix = (prefix << w) | (uint32_t)sh->misc[0];
        rem = shift;
        if (sh->misc[2] == want) return true;   // the whole bin wins
    }
    return false;
}

// The m smallest (key, position) pairs of a block's items are those for
// which win() holds (see radix_select).
struct Threshold {
    bool finite_set;     // the select ran on the keys below +inf
    uint32_t lo, span;   // the set: keys with key - lo <= span
    uint32_t prefix;     // on (key - lo) >> rem
    int rem;
    bool by_pos;         // the last key ties: its lowest positions win
    uint32_t plo, pprefix;
    int prem;
    __device__ __forceinline__ bool win(uint32_t key, uint32_t pos) const {
        if (!finite_set && key < INF_KEY) return true;
        const uint32_t rel = key - lo;
        if (rel > span) return false;
        const uint32_t r = shr(rel, rem);
        if (r != prefix) return r < prefix;
        return !by_pos || shr(pos - plo, prem) <= pprefix;
    }
};

// Exact select of the `want` smallest (key, position) pairs among the
// items of the block, by key and then, only where the last key ties, by
// position; positions are distinct. `items.each(f)` calls f(key, pos, ok)
// for every item slot of this thread (ok false for a padding slot), the
// same number of times in every thread of a warp. Whenever at least
// `want` keys lie below +inf only those are counted (so a masked lane
// never crowds the histogram); otherwise all of them win and the select
// runs on the +inf (and NaN) keys for the rest. The key range is taken
// from the set's smallest and largest key, so the first digit spreads the
// set over the histogram. All threads call it.
template <class Items, class Sh, class Set>
__device__ Threshold radix_select(const Items& items, int want, Sh* sh, Set& set) {
    uint32_t st[5] = {0u, ~0u, 0u, ~0u, 0u};   // finite: count, min, max; others: min, max
    items.each([&](uint32_t key, uint32_t, bool ok) {
        if (!ok) return;
        if (key < INF_KEY) {
            ++st[0];
            st[1] = min(st[1], key);
            st[2] = max(st[2], key);
        } else {
            st[3] = min(st[3], key);
            st[4] = max(st[4], key);
        }
    });
    const int ops5[5] = {0, 1, 2, 1, 2};
    set.combine(st, ops5, sh);
    Threshold t;
    t.finite_set = (int)st[0] >= want;
    if (!t.finite_set) want -= (int)st[0];
    t.lo = t.finite_set ? st[1] : st[3];
    t.span = (t.finite_set ? st[2] : st[4]) - t.lo;
    t.by_pos = false;
    t.plo = t.pprefix = 0;
    t.prem = 0;
    const uint32_t lo = t.lo, span = t.span;
    t.by_pos = !radix_narrow(
        items, [=](uint32_t key, uint32_t, uint32_t& v) { v = key - lo; return v <= span; },
        span, want, t.prefix, t.rem, sh, set);
    if (t.by_pos) {
        // more keys equal T than are wanted: the lowest positions of them
        const uint32_t T = lo + t.prefix;
        uint32_t ps[2] = {~0u, 0u};
        items.each([&](uint32_t key, uint32_t pos, bool ok) {
            if (ok && key == T) {
                ps[0] = min(ps[0], pos);
                ps[1] = max(ps[1], pos);
            }
        });
        const int ops2[2] = {1, 2};
        set.combine(ps, ops2, sh);
        const uint32_t plo = ps[0];
        t.plo = plo;
        radix_narrow(
            items, [=](uint32_t key, uint32_t pos, uint32_t& v) { v = pos - plo; return key == T; },
            ps[1] - plo, want, t.pprefix, t.prem, sh, set);
    }
    return t;
}

// Append the winners to `out` (warp-aggregated slots from sh->count, which
// the caller zeroed): out(slot, key, pos) for each.
template <class Items, class Sh, class Out>
__device__ __forceinline__ void collect(const Items& items, const Threshold& t, Sh* sh, Out out) {
    const int lane = threadIdx.x & 31;
    items.each([&](uint32_t key, uint32_t pos, bool ok) {
        const bool w = ok && t.win(key, pos);
        const unsigned bal = __ballot_sync(0xffffffffu, w);
        if (bal) {
            int base = 0;
            if (lane == 0) base = atomicAdd(&sh->count, __popc(bal));
            base = __shfl_sync(0xffffffffu, base, 0);
            if (w) out(base + __popc(bal & ((1u << lane) - 1u)), key, pos);
        }
    });
}

// Sort s[0, size) ascending; size is a power of two.
__device__ void bitonic_sort64(u64* s, int size) {
    for (int len = 2; len <= size; len <<= 1) {
        for (int stride = len >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < size; i += blockDim.x) {
                const int j = i ^ stride;
                if (j > i) {
                    const u64 a = s[i], b = s[j];
                    if ((a > b) == ((i & len) == 0)) {
                        s[i] = b;
                        s[j] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// A segment's keys in shared memory: slot j of thread t is column
// j*256 + t (consecutive threads on consecutive banks).
struct SegItems {
    const uint32_t* keys;   // [SEG_W], shared
    int sn;
    template <class F>
    __device__ __forceinline__ void each(F f) const {
#pragma unroll 8
        for (int j = 0; j < SEG_ITEMS; ++j) {
            const int i = j * SEG_THREADS + (int)threadIdx.x;
            f(keys[i], (uint32_t)i, i < sn);
        }
    }
};

// A row's candidates (key, global position) in the scratch buffer, read
// from L2: other blocks wrote them.
struct CandItems {
    const uint32_t* key;
    const int* pos;
    int n;
    template <class F>
    __device__ __forceinline__ void each(F f) const {
        for (int base = 0; base < n; base += blockDim.x) {
            const int i = base + (int)threadIdx.x;
            const bool ok = i < n;
            uint32_t k = 0, p = 0;
            if (ok) {
                k = __ldcg(key + i);
                p = (uint32_t)__ldcg(pos + i);
            }
            f(k, p, ok);
        }
    }
};

// Sort the m collected (key << 32 | position) winners and write row b.
__device__ __forceinline__ void sort_and_write(u64* win, int m, size_t b, float* out_d,
                                               int* out_i) {
    const int size = sel_pow2(m);
    for (int i = m + threadIdx.x; i < size; i += blockDim.x) win[i] = ~0ull;
    __syncthreads();
    bitonic_sort64(win, size);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
        out_d[b * m + i] = key2f((uint32_t)(win[i] >> 32));
        out_i[b * m + i] = (int)(uint32_t)win[i];
    }
}

// K10 on a long row's sorted winners `win` [m]: their blocks gathered into
// `scratch` (the segment's keys, free by now: 2·m ints), then the first u
// distinct by one warp (row b of out_blocks, width min(u, m)).
__device__ __forceinline__ void row_blocks(const u64* win, int m, size_t b,
                                           const int* __restrict__ cell_block, int u,
                                           int* __restrict__ out_blocks, uint32_t* scratch) {
    int* blk = reinterpret_cast<int*>(scratch);
    for (int i = threadIdx.x; i < m; i += blockDim.x) blk[i] = cell_block[(int)(uint32_t)win[i]];
    __syncthreads();
    if (threadIdx.x < 32)
        dense_ranks(blk, blk + m, m, u, out_blocks + b * (size_t)min(u, m), threadIdx.x);
}

__global__ void __launch_bounds__(SEG_THREADS)
topk_seg_kernel(const float* __restrict__ vals, int n, const float* __restrict__ rown,
                const float* __restrict__ coln, const uint8_t* __restrict__ valid, int epi,
                int clamp, int k, int nseg, int segw, float* __restrict__ out_d,
                int* __restrict__ out_i, uint32_t* __restrict__ cand_key,
                int* __restrict__ cand_pos, int* __restrict__ counters,
                const int* __restrict__ cell_block, int u, int* __restrict__ out_blocks) {
    extern __shared__ __align__(16) unsigned char smem[];
    TopkShared* sh = reinterpret_cast<TopkShared*>(smem);
    uint32_t* s_key = reinterpret_cast<uint32_t*>(sh + 1);   // [SEG_W]
    u64* win = reinterpret_cast<u64*>(s_key + SEG_W);
    const int tid = threadIdx.x;
    const size_t row = blockIdx.x / nseg;
    const int seg = blockIdx.x % nseg;
    const int c0 = seg * segw;
    const int sn = min(segw, n - c0);
    const float* rp = vals + row * (size_t)n + c0;
    const float rn = epi == 1 ? rown[row] : 0.0f;

    // the one read of the segment: every load in flight before any is used
    float v[SEG_ITEMS];
#pragma unroll
    for (int j = 0; j < SEG_ITEMS; ++j) {
        const int i = j * SEG_THREADS + tid;
        v[j] = i < sn ? __ldcs(rp + i) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < SEG_ITEMS; ++j) {
        const int i = j * SEG_THREADS + tid;
        s_key[i] = i < sn ? epi_key(v[j], rn, coln, valid, c0 + i, epi, clamp) : 0xffffffffu;
    }
    __syncthreads();
    const SegItems items{s_key, sn};
    const int kp = min(k, sn);
    BlockSet block;
    const Threshold t = radix_select(items, kp, sh, block);
    if (tid == 0) sh->count = 0;
    __syncthreads();
    if (nseg == 1) {
        collect(items, t, sh, [&](int slot, uint32_t key, uint32_t pos) {
            win[slot] = ((u64)key << 32) | pos;
        });
        __syncthreads();
        sort_and_write(win, kp, row, out_d, out_i);
        if (cell_block != nullptr) row_blocks(win, kp, row, cell_block, u, out_blocks, s_key);
        return;
    }
    // k <= SHORT_MAX < segw: every segment sends exactly k candidates
    const size_t cbase = row * (size_t)nseg * k;
    collect(items, t, sh, [&](int slot, uint32_t key, uint32_t pos) {
        const size_t o = cbase + (size_t)seg * k + slot;
        cand_key[o] = key;
        cand_pos[o] = c0 + (int)pos;
    });
    __threadfence();
    __syncthreads();
    if (tid == 0) sh->misc[3] = atomicAdd(counters + row, 1) == nseg - 1;
    __syncthreads();
    if (!sh->misc[3]) return;
    // the row's last block: merge its segments' candidates
    __threadfence();
    if (tid == 0) {
        counters[row] = 0;   // ready for the next launch
        sh->count = 0;
    }
    const CandItems cand{cand_key + cbase, cand_pos + cbase, nseg * k};
    const Threshold t2 = radix_select(cand, k, sh, block);
    collect(cand, t2, sh, [&](int slot, uint32_t key, uint32_t pos) {
        win[slot] = ((u64)key << 32) | pos;
    });
    __syncthreads();
    sort_and_write(win, k, row, out_d, out_i);
    if (cell_block != nullptr) row_blocks(win, k, row, cell_block, u, out_blocks, s_key);
}

template <int J>
__global__ void __launch_bounds__(SHORT_WARPS * 32)
topk_short_kernel(const float* __restrict__ vals, int B, int n, const float* __restrict__ rown,
                  const float* __restrict__ coln, const uint8_t* __restrict__ valid, int epi,
                  int clamp, int k, float* __restrict__ out_d, int* __restrict__ out_i,
                  const int* __restrict__ cell_block, int u, int* __restrict__ out_blocks) {
    extern __shared__ int short_blk[];   // 2·k ints a warp, with cell_block only
    const int lane = threadIdx.x & 31;
    const size_t row = (size_t)blockIdx.x * SHORT_WARPS + (threadIdx.x >> 5);
    if (row >= (size_t)B) return;   // the whole warp
    const float* rp = vals + row * (size_t)n;
    const float rn = epi == 1 ? rown[row] : 0.0f;
    float x[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int e = j * 32 + lane;
        x[j] = e < n ? __ldcs(rp + e) : 0.0f;
    }
    u64 v[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int e = j * 32 + lane;
        v[j] = e < n ? ((u64)epi_key(x[j], rn, coln, valid, e, epi, clamp) << 32) | (u64)e
                     : ~0ull;
    }
    warp_bitonic<J>(v, lane);
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int e = j * 32 + lane;
        if (e < k) {
            out_d[row * k + e] = key2f((uint32_t)(v[j] >> 32));
            out_i[row * k + e] = (int)(uint32_t)v[j];
        }
    }
    if (cell_block != nullptr) {
        int* blk = short_blk + (threadIdx.x >> 5) * 2 * k;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int e = j * 32 + lane;
            if (e < k) blk[e] = cell_block[(int)(uint32_t)v[j]];
        }
        __syncwarp();
        dense_ranks(blk, blk + k, k, u, out_blocks + row * (size_t)min(u, k), lane);
    }
}

// K10 on a wide row's written winners, through its winners' array win
// (2·pow2(k) ints, free once the row is written)
__device__ void wide_blocks(u64* win, int k, size_t row, const int* out_i,
                            const int* __restrict__ cell_block, int u,
                            int* __restrict__ out_blocks) {
    __syncthreads();
    int* blk = reinterpret_cast<int*>(win);
    for (int i = threadIdx.x; i < k; i += blockDim.x) blk[i] = cell_block[out_i[row * k + i]];
    __syncthreads();
    if (threadIdx.x < 32)
        dense_ranks(blk, blk + k, k, u, out_blocks + row * (size_t)min(u, k), threadIdx.x);
}

// A row's keys in its scratch row, written by this block before; read
// from L2.
struct RowItems {
    const uint32_t* key;
    int n;
    template <class F>
    __device__ __forceinline__ void each(F f) const {
        for (int base = 0; base < n; base += blockDim.x) {
            const int i = base + (int)threadIdx.x;
            const bool ok = i < n;
            f(ok ? __ldcg(key + i) : 0u, (uint32_t)i, ok);
        }
    }
};

// K2's wide form (k > SEL_MAX): block b takes row b; keys [B, n] and win
// [B, pow2(k)] are its scratch rows.
__global__ void __launch_bounds__(SEG_THREADS)
topk_wide_kernel(const float* __restrict__ vals, int n, const float* __restrict__ rown,
                 const float* __restrict__ coln, const uint8_t* __restrict__ valid, int epi,
                 int clamp, int k, float* __restrict__ out_d, int* __restrict__ out_i,
                 uint32_t* __restrict__ keys, u64* __restrict__ win,
                 const int* __restrict__ cell_block, int u, int* __restrict__ out_blocks) {
    __shared__ TopkShared sh;
    const size_t row = blockIdx.x;
    const float* rp = vals + row * (size_t)n;
    uint32_t* rk = keys + row * (size_t)n;
    u64* w = win + row * (size_t)sel_pow2(k);
    const float rn = epi == 1 ? rown[row] : 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        rk[i] = epi_key(__ldcs(rp + i), rn, coln, valid, i, epi, clamp);
    __syncthreads();
    const RowItems items{rk, n};
    BlockSet block;
    const Threshold t = radix_select(items, k, &sh, block);
    if (threadIdx.x == 0) sh.count = 0;
    __syncthreads();
    collect(items, t, &sh, [&](int slot, uint32_t key, uint32_t pos) {
        w[slot] = ((u64)key << 32) | pos;
    });
    __syncthreads();
    sort_and_write(w, k, row, out_d, out_i);
    if (cell_block != nullptr) wide_blocks(w, k, row, out_i, cell_block, u, out_blocks);
}

// ---------------------------------------------------------------------------
// K2's wide form over shared memory: one block a row, or a cluster a row
// ---------------------------------------------------------------------------

// A wide block's shared memory ahead of its keys: the block's selection
// state, the second histogram buffer and the cluster's sums (16-byte
// aligned: read 16 bytes at a time across the cluster), what the block
// hands the others (its partials of a combine) and the CTAs' winner counts.
struct __align__(16) WideShared {
    TopkSharedW<WIDE_THREADS / 32> sh;
    int hist1[256];
    int tot[256];
    uint32_t part[8];
    uint32_t red[8];
    int cnt[WIDE_CTAS_MAX];   // the CTAs' winners
};

__host__ __device__ inline size_t wide_key_bytes(int segw) {
    return ((size_t)segw * 4 + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t wide_smem(int segw, int k) {
    return sizeof(WideShared) + wide_key_bytes(segw) + (size_t)sel_pow2(k) * sizeof(u64);
}

// A CTA's segment of a row in shared memory; positions are the row's.
struct WideItems {
    const uint32_t* keys;
    int sn;
    uint32_t c0;   // the segment's first column
    template <class F>
    __device__ __forceinline__ void each(F f) const {
        for (int base = 0; base < sn; base += WIDE_THREADS) {
            const int i = base + (int)threadIdx.x;
            const bool ok = i < sn;
            f(ok ? keys[i] : 0u, c0 + (uint32_t)i, ok);
        }
    }
};

// The row's segments over the `ranks` CTAs of a cluster: histograms and
// combines summed across the cluster through distributed shared memory,
// each CTA computing the same sums.
struct ClusterSet {
    WideShared* ws;
    int ranks;
    int pass;   // histogram buffer of the next pass: a CTA may still read
                // the other one (the last pass's) until the next barrier
    template <class Sh>
    __device__ __forceinline__ int* hist(Sh*) {
        return (pass & 1) ? ws->hist1 : ws->sh.hist;
    }
    __device__ const int* total(int* h) {
        ++pass;
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();   // every CTA's histogram is in
        if (threadIdx.x < 64) {
            int4 x[WIDE_CTAS_MAX];   // every CTA's four bins in flight at once
#pragma unroll
            for (int r = 0; r < WIDE_CTAS_MAX; ++r)
                if (r < ranks)
                    x[r] = reinterpret_cast<const int4*>(cluster.map_shared_rank(h, r))
                        [threadIdx.x];
            int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll
            for (int r = 0; r < WIDE_CTAS_MAX; ++r)
                if (r < ranks) {
                    acc.x += x[r].x; acc.y += x[r].y; acc.z += x[r].z; acc.w += x[r].w;
                }
            reinterpret_cast<int4*>(ws->tot)[threadIdx.x] = acc;
        }
        __syncthreads();
        return ws->tot;
    }
    template <int NV, class Sh>
    __device__ void combine(uint32_t (&v)[NV], const int (&op)[NV], Sh* sh) {
        block_combine(v, op, sh);
        cg::cluster_group cluster = cg::this_cluster();
        if (threadIdx.x == 0)
            for (int j = 0; j < NV; ++j) ws->part[j] = v[j];
        cluster.sync();
        if (threadIdx.x < 32) {
            const int lane = threadIdx.x;
#pragma unroll
            for (int j = 0; j < NV; ++j) {
                const uint32_t id = op[j] == 1 ? ~0u : 0u;
                const uint32_t x = lane < ranks ? cluster.map_shared_rank(ws->part, lane)[j] : id;
                const uint32_t r = op[j] == 0 ? __reduce_add_sync(0xffffffffu, x)
                                 : op[j] == 1 ? __reduce_min_sync(0xffffffffu, x)
                                              : __reduce_max_sync(0xffffffffu, x);
                if (lane == 0) ws->red[j] = r;
            }
        }
        cluster.sync();   // every CTA has read the parts before any rewrites them
#pragma unroll
        for (int j = 0; j < NV; ++j) v[j] = ws->red[j];
    }
};

// Row blockIdx.x / ctas; this CTA's segment is columns [rank·segw, +segw).
// Each CTA sorts its own winners, copies the others' sorted lists after
// them, and writes each of its winners at its place there plus the other
// CTAs' winners below it. Two CTAs an SM (64 registers a thread).
__global__ void __launch_bounds__(WIDE_THREADS, 2)
topk_cluster_kernel(const float* __restrict__ vals, int n, const float* __restrict__ rown,
                    const float* __restrict__ coln, const uint8_t* __restrict__ valid, int epi,
                    int clamp, int k, int ctas, int segw, float* __restrict__ out_d,
                    int* __restrict__ out_i, const int* __restrict__ cell_block, int u,
                    int* __restrict__ out_blocks) {
    extern __shared__ __align__(16) unsigned char smem[];
    WideShared* ws = reinterpret_cast<WideShared*>(smem);
    TopkSharedW<WIDE_THREADS / 32>* sh = &ws->sh;
    uint32_t* s_key = reinterpret_cast<uint32_t*>(ws + 1);
    u64* win = reinterpret_cast<u64*>(smem + sizeof(WideShared) + wide_key_bytes(segw));
    const int tid = threadIdx.x;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const size_t row = blockIdx.x / ctas;
    const int c0 = rank * segw;
    const int sn = min(segw, n - c0);
    const float* rp = vals + row * (size_t)n + c0;
    const float rn = epi == 1 ? rown[row] : 0.0f;
    // the one read of the segment, four loads in flight a thread
    for (int base = 0; base < sn; base += 4 * WIDE_THREADS) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int i = base + j * WIDE_THREADS + tid;
            v[j] = i < sn ? __ldcs(rp + i) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int i = base + j * WIDE_THREADS + tid;
            if (i < sn) s_key[i] = epi_key(v[j], rn, coln, valid, c0 + i, epi, clamp);
        }
    }
    __syncthreads();
    const WideItems items{s_key, sn, (uint32_t)c0};
    ClusterSet set{ws, ctas, 0};
    const Threshold t = radix_select(items, k, sh, set);
    // this CTA's winners, sorted here
    if (tid == 0) sh->count = 0;
    __syncthreads();
    collect(items, t, sh, [&](int slot, uint32_t key, uint32_t pos) {
        win[slot] = ((u64)key << 32) | pos;
    });
    __syncthreads();
    const int c = sh->count;
    const int size = sel_pow2(c);
    for (int i = c + tid; i < size; i += WIDE_THREADS) win[i] = ~0ull;
    __syncthreads();
    bitonic_sort64(win, size);
    if (tid == 0) ws->part[0] = (uint32_t)c;
    cluster.sync();   // every CTA's winners sorted, its count out
    if (tid < ctas) ws->cnt[tid] = (int)cluster.map_shared_rank(ws->part, tid)[0];
    __syncthreads();
    // the other CTAs' lists, in rank order, after this one's: [c, k) of the
    // winners' room, four remote loads in flight a thread
    const int rest = k - c;
    for (int j0 = 0; j0 < rest; j0 += 4 * WIDE_THREADS) {
        u64 v[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            int j = j0 + q * WIDE_THREADS + tid, r = 0;
            if (j >= rest) continue;
            for (;; ++r) {
                if (r == rank) continue;
                if (j < ws->cnt[r]) break;
                j -= ws->cnt[r];
            }
            v[q] = cluster.map_shared_rank(win, r)[j];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int j = j0 + q * WIDE_THREADS + tid;
            if (j < rest) win[c + j] = v[q];
        }
    }
    __syncthreads();
    // each winner's place: its own plus the other CTAs' winners below it
    for (int i = tid; i < c; i += WIDE_THREADS) {
        const u64 x = win[i];
        int place = i;
        for (int r = 0, at = c; r < ctas; ++r) {
            if (r == rank) continue;
            int lo = 0, hi = ws->cnt[r];
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (win[at + mid] < x) lo = mid + 1; else hi = mid;
            }
            place += lo;
            at += ws->cnt[r];
        }
        out_d[row * k + place] = key2f((uint32_t)(x >> 32));
        out_i[row * k + place] = (int)(uint32_t)x;
    }
    if (cell_block == nullptr) {
        cluster.sync();   // no CTA leaves while another copies its list
        return;
    }
    // K10 on the written row, by CTA 0 through its winners' room (2·pow2(k)
    // ints)
    __threadfence();
    cluster.sync();
    if (rank == 0) wide_blocks(win, k, row, out_i, cell_block, u, out_blocks);
}

// The segments of a long row: as many as SEG_W needs, of equal width.
static inline int seg_count(int n) { return (n + SEG_W - 1) / SEG_W; }

extern "C" int topk_rows(const float* vals, int B, int N, const float* rown,
                         const float* coln, const uint8_t* valid, int epi,
                         int clamp, int k, float* out_d, int* out_i, uint32_t* cand_key,
                         int* cand_pos, int* counters, const int* cell_block, int u,
                         int* out_blocks, void* stream) {
    if (k < 1 || k > N) return (int)cudaErrorInvalidValue;
    if (cell_block != nullptr && (u < 1 || out_blocks == nullptr)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (k > SEL_MAX) {
        // the global wide form (rows past what a cluster holds): cand_key
        // holds [B, N] keys and cand_pos the [B, pow2(k)] 64-bit winners
        // (2·pow2(k) ints a row, 8-byte aligned)
        if (cand_key == nullptr || cand_pos == nullptr || ((uintptr_t)cand_pos & 7))
            return (int)cudaErrorInvalidValue;
        topk_wide_kernel<<<(unsigned)B, SEG_THREADS, 0, s>>>(
            vals, N, rown, coln, valid, epi, clamp, k, out_d, out_i, cand_key,
            reinterpret_cast<u64*>(cand_pos), cell_block, u, out_blocks);
        return (int)cudaGetLastError();
    }
    if (N <= SHORT_MAX) {
        const dim3 grid((B + SHORT_WARPS - 1) / SHORT_WARPS);
        const int J = sel_pow2((N + 31) / 32);
        const size_t smem = cell_block != nullptr ? (size_t)SHORT_WARPS * 2 * k * sizeof(int) : 0;
#define SHORT_CASE(JJ)                                                                        \
    case JJ:                                                                                  \
        if (smem > (48 << 10)) {                                                              \
            const int err = raise_smem(topk_short_kernel<JJ>, smem);                          \
            if (err) return err;                                                              \
        }                                                                                     \
        topk_short_kernel<JJ><<<grid, SHORT_WARPS * 32, smem, s>>>(                           \
            vals, B, N, rown, coln, valid, epi, clamp, k, out_d, out_i, cell_block, u,        \
            out_blocks);                                                                      \
        break;
        switch (J) {
            SHORT_CASE(1) SHORT_CASE(2) SHORT_CASE(4) SHORT_CASE(8) SHORT_CASE(16)
            SHORT_CASE(32) SHORT_CASE(64)
            default: return (int)cudaErrorInvalidValue;
        }
#undef SHORT_CASE
        return (int)cudaGetLastError();
    }
    const int nseg = seg_count(N);
    if (nseg > 1 && (cand_key == nullptr || cand_pos == nullptr || counters == nullptr))
        return (int)cudaErrorInvalidValue;
    const int segw = (N + nseg - 1) / nseg;
    if ((long long)(nseg - 1) * segw + k > N) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(TopkShared) + SEG_W * sizeof(uint32_t) +
                        (size_t)sel_pow2(k) * sizeof(u64);
    if (smem > (48 << 10)) {
        const cudaError_t err = cudaFuncSetAttribute(
            topk_seg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    topk_seg_kernel<<<(unsigned)((size_t)B * nseg), SEG_THREADS, smem, s>>>(
        vals, N, rown, coln, valid, epi, clamp, k, nseg, segw, out_d, out_i, cand_key,
        cand_pos, counters, cell_block, u, out_blocks);
    return (int)cudaGetLastError();
}

// CTAs a row of K2's wide form over a row of N columns and k > SEL_MAX
// winners (kernels.topk_wide_ctas asks): one per WIDE_SEG_COLS columns or
// WIDE_WIN winners, at most WIDE_CLUSTER; more, up to WIDE_CTAS_MAX, where
// a CTA's segment and the winners' room would pass a block's opted-in
// shared memory on the current device; 0 past that (the global form).
extern "C" long long topk_rows_wide_ctas(int N, int k) {
    if (k <= SEL_MAX || k > N) return 0;
    const size_t room = launch_util::smem_optin();
    const int by_cols = (N + WIDE_SEG_COLS - 1) / WIDE_SEG_COLS;
    const int by_win = (k + WIDE_WIN - 1) / WIDE_WIN;
    const int want = by_cols > by_win ? by_cols : by_win;
    for (int ctas = want < WIDE_CLUSTER ? want : WIDE_CLUSTER; ctas <= WIDE_CTAS_MAX; ++ctas)
        if (wide_smem((N + ctas - 1) / ctas, k) <= room) return ctas;
    return 0;
}

// K2's wide form over shared memory (k > SEL_MAX): a cluster of `ctas`
// CTAs a row (topk_rows_wide_ctas), each a segment of ceil(N / ctas)
// columns; refused where a CTA would hold no column or its segment and the
// winners pass a block's opted-in shared memory.
extern "C" int topk_rows_wide(const float* vals, int B, int N, const float* rown,
                              const float* coln, const uint8_t* valid, int epi, int clamp, int k,
                              int ctas, float* out_d, int* out_i, const int* cell_block, int u,
                              int* out_blocks, void* stream) {
    if (k <= SEL_MAX || k > N || ctas < 2 || ctas > WIDE_CTAS_MAX)
        return (int)cudaErrorInvalidValue;
    if (cell_block != nullptr && (u < 1 || out_blocks == nullptr))
        return (int)cudaErrorInvalidValue;
    const int segw = (N + ctas - 1) / ctas;
    if ((long long)(ctas - 1) * segw >= N) return (int)cudaErrorInvalidValue;
    const size_t smem = wide_smem(segw, k);
    if (smem > launch_util::smem_optin()) return (int)cudaErrorInvalidValue;
    const int err = raise_smem(topk_cluster_kernel, smem);
    if (err) return err;
    cudaStream_t s = (cudaStream_t)stream;
    if (ctas > WIDE_CLUSTER) {
        const cudaError_t e = cudaFuncSetAttribute(
            topk_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)B * (unsigned)ctas);
    cfg.blockDim = dim3(WIDE_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, topk_cluster_kernel, vals, N, rown, coln, valid,
                                             epi, clamp, k, ctas, segw, out_d, out_i, cell_block,
                                             u, out_blocks);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
