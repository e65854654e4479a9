// K2 topk_rows: exact per-row k-smallest with an optional fused epilogue.
//
// Replaces: turdb_tpu/ops/topk.py topk_smallest / topk_smallest_wide /
// merge_topk, which serve the IVF cell selection
// (turdb_tpu/models/ivf.py ivf_search_impl, the q·Cᵀ top-nprobe) and the
// flat oracle's per-chunk selection (turdb_tpu/models/flat.py flat_search).
//
// What bounds it on an H100: device-memory bandwidth. The dot matrix comes
// from a cuBLAS fp32 product ([1024, ~24.6k] at the cell selection,
// [256, 131072] per flat chunk), and each block re-reads its row once per
// radix pass. Four 8-bit passes plus one collect pass read a row five
// times; the passes of a block run back to back, so a cell-selection row
// (96 KB) is still in L2 for the later ones.
//
// Design: one 256-thread block per row. The L2 / cosine / IP epilogue and
// the column-valid mask are applied as each value is read, so the
// distance matrix is never written. block_select (select.cuh) finds the
// k-th smallest key exactly by radix select, collects the winners and
// sorts them by (value, position): ties go to the lower position. The
// winners sit in dynamic shared memory sized from k (k <= SEL_MAX = 2048:
// 16 KB), so a small k keeps the block small.
#include "select.cuh"

struct RowKey {
    const float* row;
    const float* coln;
    const uint8_t* valid;
    float rn;
    int epi;
    int clamp;
    __device__ __forceinline__ uint32_t operator()(int j) const {
        float v = row[j];
        if (epi == 1) {
            // (rown + coln) - 2*dot, rounded as the reference rounds it
            v = __fsub_rn(__fadd_rn(rn, coln[j]), __fmul_rn(2.0f, v));
            if (clamp) v = fmaxf(v, 0.0f);
        } else if (epi == 2) {
            v = __fsub_rn(1.0f, v);
        } else if (epi == 3) {
            v = -v;
        }
        if (valid != nullptr && valid[j] == 0) v = __int_as_float(0x7f800000);
        return f2key(v);
    }
};

__global__ void __launch_bounds__(SEL_THREADS)
topk_rows_kernel(const float* __restrict__ vals, int n, const float* __restrict__ rown,
                 const float* __restrict__ coln, const uint8_t* __restrict__ valid,
                 int epi, int clamp, int k, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    SelectScratch* sc = reinterpret_cast<SelectScratch*>(smem);
    uint32_t* s_key = reinterpret_cast<uint32_t*>(sc + 1);
    int* s_pos = reinterpret_cast<int*>(s_key + sel_pow2(k));
    const size_t b = blockIdx.x;
    RowKey f{vals + b * n, coln, valid, epi == 1 ? rown[b] : 0.0f, epi, clamp};
    block_select(f, n, k, s_key, s_pos, sc);
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        out_d[b * k + i] = key2f(s_key[i]);
        out_i[b * k + i] = s_pos[i];
    }
}

extern "C" int topk_rows(const float* vals, int B, int N, const float* rown,
                         const float* coln, const uint8_t* valid, int epi,
                         int clamp, int k, float* out_d, int* out_i, void* stream) {
    if (k < 1 || k > N || k > SEL_MAX) return (int)cudaErrorInvalidValue;
    // at most 1 KB + 16 KB: under the 48 KB a block gets without opt-in
    const size_t smem = sizeof(SelectScratch) + (size_t)sel_pow2(k) * 2 * sizeof(int);
    topk_rows_kernel<<<B, SEL_THREADS, smem, (cudaStream_t)stream>>>(
        vals, N, rown, coln, valid, epi, clamp, k, out_d, out_i);
    return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
