// Host-side HNSW bulk-build helpers.
//
// turdb_reverse_topk: reverse-edge lists for the bulk reverse merge
// (models/hnsw.py _bulk_reverse_lists). For every node, collect the
// up-to-rcap NEAREST sources that selected it as a forward edge — the
// batched analog of the reference's bidirectional edge write
// (reference src/hnsw/mod.rs:1067-1077).
//
// The numpy version radix-argsorts 32M packed (tgt, distbits) uint64
// keys and materializes half a dozen 32M-element temps (~43s of the 1M
// build's 126s warm wall on the burst-throttled VM). This is one pass of
// bounded insertion into per-target sorted lists: O(E * rcap) with
// rcap=16, no temps beyond the 8-bytes-per-(target,lane) output state.
//
// Ordering contract (must match the numpy path bit-for-bit):
//  - distance order = order-flipped IEEE-754 bit pattern compared as u32
//    (exactly the numpy path's `u ^ flip` key; total order incl. inf/nan)
//  - ties keep edge enumeration order (row-major over [ns, deg]), i.e.
//    the numpy stable argsort order: insertion goes AFTER equal keys.

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint32_t dist_key(float f) {
    uint32_t u;
    memcpy(&u, &f, 4);
    return u ^ ((u >> 31) ? 0xFFFFFFFFu : 0x80000000u);
}

extern "C" void turdb_reverse_topk(
    const int64_t* slots,   // [ns] slot id of each row (source ids)
    const int32_t* adj,     // [ns, deg] forward edges (slot ids; <0 none)
    const float* dist,      // [ns, deg] forward edge distances
    int64_t ns, int32_t deg,
    const int64_t* pos,     // [pos_len] slot -> row index, -1 absent
    int64_t pos_len,
    int32_t* rev,           // [ns, rcap] out; caller prefills -1
    int32_t rcap) {
    uint32_t* kbuf = (uint32_t*)malloc((size_t)ns * rcap * 4);
    uint8_t* cnt = (uint8_t*)calloc((size_t)ns, 1);
    if (!kbuf || !cnt) { free(kbuf); free(cnt); return; }
    for (int64_t r = 0; r < ns; r++) {
        const int32_t src = (int32_t)slots[r];
        const int64_t base_in = r * deg;
        for (int32_t j = 0; j < deg; j++) {
            const int32_t t = adj[base_in + j];
            if (t < 0 || (int64_t)t >= pos_len) continue;
            const int64_t row = pos[t];
            if (row < 0) continue;
            const uint32_t dk = dist_key(dist[base_in + j]);
            uint32_t* kb = kbuf + row * rcap;
            int32_t* rb = rev + row * rcap;
            int32_t c = cnt[row];
            if (c == rcap) {
                if (dk >= kb[rcap - 1]) continue;   // after-equal: skip
                c--;                                 // drop the worst
            }
            int32_t p = c;
            while (p > 0 && kb[p - 1] > dk) {       // stable: > not >=
                kb[p] = kb[p - 1];
                rb[p] = rb[p - 1];
                p--;
            }
            kb[p] = dk;
            rb[p] = src;
            if (cnt[row] < rcap) cnt[row]++;
        }
    }
    free(kbuf);
    free(cnt);
}
