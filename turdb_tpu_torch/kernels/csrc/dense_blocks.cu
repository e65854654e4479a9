// K10 dense_blocks: the physical blocks a dense IVF probe gathers.
//
// Replaces: turdb_tpu/models/ivf.py `_first_unique` together with the
// `cell_block[top]` gather of the dense branch of `ivf_search_impl`
// (ivf.py:225-237, :277-284): each query's top-P cells are mapped to
// their physical blocks, and when u < P only the first u distinct blocks
// are kept, in first-occurrence order; later duplicates sink to the tail
// in their own order (the reference's stable argsort on the key
// `P + 1 if duplicate else position`), so a row with fewer than u
// distinct blocks ends in repeats.
//
// What bounds it on an H100: nothing the card notices. It reads B x P
// int32 ids and a [C] table and writes B x u ids (12 KB at B = 1024,
// P = 16); its cost is its launch. The O(P^2) duplicate test (P is a few
// hundred at most) runs from shared memory.
//
// Design: one warp per query, four queries per 128-thread block. The warp
// gathers its P blocks into shared memory, flags each position that
// repeats an earlier one, and writes each position to its rank: a first
// occurrence to the count of first occurrences before it, a duplicate to
// (number of first occurrences) + (duplicates before it), both counted by
// ballots over 32 positions at a time. Ranks >= u are dropped. With
// u >= P the gather is written as it is, in probe order.
#include <cuda_runtime.h>
#include <stdint.h>

#define DB_WARPS 4
#define DB_PMAX 4096

__global__ void __launch_bounds__(DB_WARPS * 32)
dense_blocks_kernel(const int* __restrict__ cell_block, const int* __restrict__ top,
                    int B, int P, int u, int* __restrict__ out) {
    extern __shared__ int smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * DB_WARPS + warp;
    if (b >= B) return;                       // whole warps only: no block barrier below
    int* blk = smem + warp * 2 * P;
    int* first = blk + P;
    const int* row = top + (size_t)b * P;
    int* o = out + (size_t)b * u;
    for (int p = lane; p < P; p += 32) blk[p] = cell_block[row[p]];
    __syncwarp();
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

extern "C" int dense_blocks(const int* cell_block, const int* top, int B, int P, int u,
                            int* out, void* stream) {
    if (P < 1 || P > DB_PMAX || u < 1) return (int)cudaErrorInvalidValue;
    // two int arrays of P per warp: at most 128 KB at P = DB_PMAX
    const size_t smem = (size_t)DB_WARPS * 2 * P * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(dense_blocks_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int grid = (B + DB_WARPS - 1) / DB_WARPS;
    dense_blocks_kernel<<<grid, DB_WARPS * 32, smem, (cudaStream_t)stream>>>(
        cell_block, top, B, P, u, out);
    return (int)cudaGetLastError();
}
