// Exact block-wide selection of the m smallest (key, position) pairs.
//
// Shared by K1/K4 (ivf_probe.cu) and K5 (ivf_rerank.cu); K2 (topk_rows.cu)
// takes only its keys (f2key / key2f) and limits. K2 and K11 (sq8_scan.cu)
// share `warp_bitonic`; K2 runs K10's ranks (`dense_ranks`) on its winners. One thread block selects
// from n candidates whose keys come from a functor (`ArrayKey`: an array
// in shared or global memory).
//
// Method: radix select on order-preserving 32-bit keys, 8 bits per pass
// (4 histogram passes find the m-th smallest key T exactly), one collect
// pass (all keys < T, then keys == T in position order until m are taken:
// each thread a contiguous run of positions, ranked by a block scan), and a
// bitonic sort of the <= SEL_MAX winners by (key, position). Ties
// therefore go to the lower position, as lax.top_k does. The winners live
// in shared memory arrays of sel_pow2(m) entries (16 KB for both at
// m = SEL_MAX), which the caller sizes from m.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SEL_MAX 2048
#define SEL_THREADS 256
#define INF_KEY 0xff800000u   // f2key(+inf)

// capacity of the winner arrays for a selection of m: the bitonic sort's
// power of two
__host__ __device__ __forceinline__ int sel_pow2(int m) {
    int s = 1;
    while (s < m) s <<= 1;
    return s;
}

// float -> uint32 with the same order; -0.0 is folded into +0.0 first so
// that the two compare equal, as they do for a float sort.
__device__ __forceinline__ uint32_t f2key(float f) {
    if (f == 0.0f) f = 0.0f;
    uint32_t u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(uint32_t k) {
    uint32_t u = (k & 0x80000000u) ? (k & 0x7fffffffu) : ~k;
    return __uint_as_float(u);
}

// Keys already in an array (shared or global memory).
struct ArrayKey {
    const uint32_t* keys;
    __device__ __forceinline__ uint32_t operator()(int j) const { return keys[j]; }
};

struct SelectScratch {
    int hist[256];
    int wcnt[SEL_THREADS / 32];
    int misc[4];
};

// Sort s_key/s_pos[0, size) ascending by (key, pos); size is a power of two.
__device__ __forceinline__ void bitonic_sort(uint32_t* s_key, int* s_pos, int size) {
    for (int len = 2; len <= size; len <<= 1) {
        for (int stride = len >> 1; stride > 0; stride >>= 1) {
            for (int i = threadIdx.x; i < size; i += blockDim.x) {
                int j = i ^ stride;
                if (j > i) {
                    bool up = (i & len) == 0;
                    uint32_t ki = s_key[i], kj = s_key[j];
                    int pi = s_pos[i], pj = s_pos[j];
                    bool gt = ki > kj || (ki == kj && pi > pj);
                    if (gt == up) {
                        s_key[i] = kj; s_key[j] = ki;
                        s_pos[i] = pj; s_pos[j] = pi;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// Select the m smallest of n keys (1 <= m <= min(n, SEL_MAX)); on return
// s_key/s_pos[0, m) hold them sorted by (key, position). Needs blockDim.x a
// multiple of 32 up to SEL_THREADS (K1 / K4 run SEL_THREADS, K5 128) and
// s_key/s_pos of sel_pow2(m) entries. All threads call it.
template <class KeyFn>
__device__ void block_select(KeyFn key_of, int n, int m, uint32_t* s_key,
                             int* s_pos, SelectScratch* sc) {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    uint32_t prefix = 0, mask = 0;
    int want = m;  // still needed among keys matching `prefix` on `mask`
    for (int shift = 24; shift >= 0; shift -= 8) {
        for (int i = tid; i < 256; i += blockDim.x) sc->hist[i] = 0;
        __syncthreads();
        for (int j = tid; j < n; j += blockDim.x) {
            uint32_t k = key_of(j);
            if ((k & mask) == prefix) atomicAdd(&sc->hist[(k >> shift) & 255u], 1);
        }
        __syncthreads();
        if (warp == 0) {
            int c = 0;
            for (int i = 0; i < 8; ++i) c += sc->hist[lane * 8 + i];
            int incl = c;
            for (int o = 1; o < 32; o <<= 1) {
                int v = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += v;
            }
            unsigned hit = __ballot_sync(0xffffffffu, incl >= want);
            int first = __ffs(hit) - 1;  // want <= total, so hit != 0
            if (lane == first) {
                int before = incl - c;
                int bin = lane * 8;
                while (before + sc->hist[bin] < want) before += sc->hist[bin++];
                sc->misc[0] = bin;
                sc->misc[1] = before;
            }
        }
        __syncthreads();
        want -= sc->misc[1];
        prefix |= (uint32_t)sc->misc[0] << shift;
        mask |= 255u << shift;
        __syncthreads();
    }
    // prefix == T, the m-th smallest key; m - want keys are < T. Each
    // thread collects a contiguous run of positions: the keys < T in any
    // order, the first `want` keys == T in position order (a block scan of
    // the runs' counts ranks them).
    const uint32_t T = prefix;
    const int n_lt = m - want;
    const int per = (n + blockDim.x - 1) / blockDim.x;
    const int lo = min(n, tid * per), hi = min(n, lo + per);
    int n_eq = 0;
    for (int j = lo; j < hi; ++j) n_eq += key_of(j) == T;
    int incl = n_eq;
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) sc->wcnt[warp] = incl;
    if (tid == 0) sc->misc[2] = 0;
    __syncthreads();
    int r = incl - n_eq;
    for (int w = 0; w < warp; ++w) r += sc->wcnt[w];
    for (int j = lo; j < hi; ++j) {
        const uint32_t k = key_of(j);
        if (k < T) {
            const int slot = atomicAdd(&sc->misc[2], 1);
            s_key[slot] = k;
            s_pos[slot] = j;
        } else if (k == T) {
            if (r < want) {
                s_key[n_lt + r] = k;
                s_pos[n_lt + r] = j;
            }
            ++r;
        }
    }
    const int size = sel_pow2(m);
    for (int i = m + tid; i < size; i += blockDim.x) {
        s_key[i] = 0xffffffffu;
        s_pos[i] = 0x7fffffff;
    }
    __syncthreads();
    bitonic_sort(s_key, s_pos, size);
}

// Bitonic sort of a warp's 32*J (key << 32 | position) values: element e
// = j*32 + lane sits in v[j] of that lane.
template <int J>
__device__ __forceinline__ void warp_bitonic(unsigned long long (&v)[J], int lane) {
    constexpr int N = 32 * J;
#pragma unroll
    for (int len = 2; len <= N; len <<= 1) {
#pragma unroll
        for (int s = len >> 1; s > 0; s >>= 1) {
            if (s >= 32) {
                // partner in the same lane, register j ^ (s / 32)
#pragma unroll
                for (int j = 0; j < J; ++j) {
                    const int p = j ^ (s >> 5);
                    if (p > j) {
                        const bool up = ((j * 32) & len) == 0;
                        const unsigned long long a = v[j], b = v[p];
                        if ((a > b) == up) {
                            v[j] = b;
                            v[p] = a;
                        }
                    }
                }
            } else {
#pragma unroll
                for (int j = 0; j < J; ++j) {
                    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v[j], s);
                    const bool up = ((j * 32 + lane) & len) == 0;
                    const bool lower = (lane & s) == 0;
                    const unsigned long long mn = v[j] < o ? v[j] : o;
                    const unsigned long long mx = v[j] < o ? o : v[j];
                    v[j] = lower == up ? mn : mx;
                }
            }
        }
    }
}

// K10 dense_blocks, fused into K2 (topk_rows.cu): the physical blocks a
// dense IVF probe gathers (the reference's `_first_unique` of
// `cell_block[top]`, turdb_tpu/models/ivf.py:225-237, :277-284). `blk`
// [P] (shared memory) holds the blocks of a row's P winners in K2's order
// ((distance, position), ties to the lower position: the reference's
// order). With u >= P they are written as they are; else the first u
// distinct blocks in first-occurrence order, followed, where a row has
// fewer, by its repeats in their own order (the reference's stable
// argsort on `P + 1 if duplicate else position`). One warp: it flags each
// position that repeats an earlier one (in `first` [P], shared memory)
// and writes each position to its rank, a first occurrence to the count
// of first occurrences before it, a repeat to (first occurrences) +
// (repeats before it), both counted by ballots over 32 positions at a
// time; ranks >= u are dropped. The callers' barrier (or __syncwarp) has
// made `blk` visible to the warp.
static __device__ void dense_ranks(const int* blk, int* first, int P, int u, int* o, int lane) {
    if (u >= P) {
        for (int p = lane; p < P; p += 32) o[p] = blk[p];
        return;
    }
    int n_first = 0;
    for (int base = 0; base < P; base += 32) {
        const int p = base + lane;
        int f = 0;
        if (p < P) {
            const int v = blk[p];
            f = 1;
            for (int j = 0; j < p; ++j) {
                if (blk[j] == v) { f = 0; break; }
            }
            first[p] = f;
        }
        n_first += __popc(__ballot_sync(0xffffffffu, f));
    }
    __syncwarp();
    const unsigned below = (1u << lane) - 1u;
    int seen_first = 0, seen_dup = 0;
    for (int base = 0; base < P; base += 32) {
        const int p = base + lane;
        const int f = p < P ? first[p] : 0;
        const unsigned mf = __ballot_sync(0xffffffffu, p < P && f);
        const unsigned md = __ballot_sync(0xffffffffu, p < P && !f);
        if (p < P) {
            const int r = f ? seen_first + __popc(mf & below)
                            : n_first + seen_dup + __popc(md & below);
            if (r < u) o[r] = blk[p];
        }
        seen_first += __popc(mf);
        seen_dup += __popc(md);
    }
}
