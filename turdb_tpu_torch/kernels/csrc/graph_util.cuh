// Block-level helpers of the HNSW graph kernels K6 / K8 (hnsw_beam.cu) and
// K7 (hnsw_select.cu), and of K5's selection (ivf_rerank.cu): sorted runs
// of 64-bit keys and an open-addressing table in shared memory.
//
// Keys: (f2key(distance) << 32) | position. f2key (select.cuh) keeps the
// float order (negative COS / IP distances included) and folds -0.0 into
// +0.0, so comparing keys compares (distance, position) as the reference's
// stable top-k and argsort do. A warp sorts runs of 32 keys in registers
// (a bitonic network of shuffles); a merge ranks each key by its place in
// its run plus a binary search of every other run, so no block-wide
// network and its barriers run.
//
// The table maps ids to a claim: two arrays of 32-bit words, the ids (an
// empty entry holds EMPTY_ID) and their tags. A member of a set gets tag
// 0; a claim by position t lowers the tag to t + 1 with atomicMin, so the
// lowest claim of an id holds it and a member's stays 0. Linear probing
// from a multiplicative hash; a table holds at most half its size and is
// cleared (table_clear) before each use.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "select.cuh"

typedef unsigned long long u64;

// Sort one key per lane ascending across the warp.
__device__ __forceinline__ u64 warp_sort32(u64 v, int lane) {
    for (int k = 2; k <= 32; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
            const u64 o = __shfl_xor_sync(0xffffffffu, v, j);
            const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
            v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
        }
    return v;
}

// Sort run[0, n) (n <= 32) in place: one warp, all lanes.
__device__ __forceinline__ void warp_sort_run(u64* run, int n, int lane) {
    u64 v = lane < n ? run[lane] : ~0ull;
    v = warp_sort32(v, lane);
    __syncwarp();
    if (lane < n) run[lane] = v;
    __syncwarp();
}

// Keys of a sorted run[0, n) below x.
__device__ __forceinline__ int count_below(const u64* run, int n, u64 x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Keys below x in the sorted runs of 32 that cover keys[0, n).
__device__ __forceinline__ int count_below_runs(const u64* keys, int n, u64 x) {
    int c = 0;
    for (int base = 0; base < n; base += 32) c += count_below(keys + base, min(32, n - base), x);
    return c;
}

#define EMPTY_ID 0xffffffffu

__host__ __device__ __forceinline__ int table_bits(int members) {
    int b = 1;
    while ((1 << b) < 2 * members) ++b;
    return b;
}

// all threads of the block
__device__ __forceinline__ void table_clear(unsigned* ids, unsigned* tags, int bits) {
    for (int j = threadIdx.x; j < (1 << bits); j += blockDim.x) {
        ids[j] = EMPTY_ID;
        tags[j] = 0xffffffffu;
    }
}

// The entry of id (>= 0), inserted if it is not there yet.
__device__ __forceinline__ int table_insert(unsigned* ids, int bits, int id) {
    const unsigned key = (unsigned)id;
    const int mask = (1 << bits) - 1;
    int p = (int)((key * 0x9E3779B1u) >> (32 - bits));
    for (;;) {
        const unsigned k = *reinterpret_cast<volatile unsigned*>(ids + p);
        if (k == key) return p;
        if (k == EMPTY_ID) {
            const unsigned old = atomicCAS(ids + p, EMPTY_ID, key);
            if (old == EMPTY_ID || old == key) return p;
        }
        p = (p + 1) & mask;
    }
}

// id is a member of the set
__device__ __forceinline__ void table_member(unsigned* ids, unsigned* tags, int bits, int id) {
    tags[table_insert(ids, bits, id)] = 0u;
}

// Position t claims id; returns the entry, whose tag is t + 1 once every
// claim is in (a barrier later) only when t is the lowest claim of an id
// that is no member.
__device__ __forceinline__ int table_claim(unsigned* ids, unsigned* tags, int bits, int id, int t) {
    const int p = table_insert(ids, bits, id);
    atomicMin(tags + p, (unsigned)(t + 1));
    return p;
}
