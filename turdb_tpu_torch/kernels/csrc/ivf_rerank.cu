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
// What bounds it on an H100: device-memory bandwidth, and little of it: a
// query reads r rows of 4d (f32) or 2d (SQ16) bytes plus 12 bytes of
// candidate and 4-12 of row metadata, scattered over the store.
//
// Design: one 256-thread block per query. The query row sits in shared
// memory; each warp computes one candidate's fp32 dot at a time with
// 16-byte (f32) or 8-byte (four uint16) loads and a shuffle reduction, and
// dequantizes SQ16 elements as the plain expression rounds them
// (__fadd_rn(base, __fmul_rn(s16, u))). Candidates whose probe distance is
// +inf are not read. Under replicas a candidate is dropped when an earlier
// candidate holds its id (copies of a row are encoded alike, so their
// exact distances tie: the reference keeps the first by candidate order).
// block_select (select.cuh) then takes the k smallest by (exact distance,
// candidate index), ties to the earlier candidate.
#include "select.cuh"

template <bool SQ16>
__global__ void __launch_bounds__(SEL_THREADS)
rerank_kernel(const float* __restrict__ q, const float* __restrict__ qn,
              const float* __restrict__ cand_d, const int* __restrict__ cand_i,
              const int* __restrict__ cand_pos, int r, const void* __restrict__ rows,
              const float* __restrict__ pnorms, const float* __restrict__ mins,
              const float* __restrict__ scales, int d, int k, int replicated,
              float* __restrict__ out_d, int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    SelectScratch* sc = reinterpret_cast<SelectScratch*>(smem);
    const int kp = sel_pow2(k);
    uint32_t* s_key = reinterpret_cast<uint32_t*>(sc + 1);
    int* s_pos = reinterpret_cast<int*>(s_key + kp);
    float* s_q = reinterpret_cast<float*>(s_pos + kp);
    uint32_t* s_ex = reinterpret_cast<uint32_t*>(s_q + d);
    int* s_id = reinterpret_cast<int*>(s_ex + r);

    const size_t b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int i = tid; i < d; i += blockDim.x) s_q[i] = q[b * d + i];
    for (int i = tid; i < r; i += blockDim.x) s_id[i] = cand_i[b * r + i];
    const float qnb = qn[b];
    __syncthreads();

    const float s16_ratio = (float)(255.0 / 65535.0);
    for (int i = warp; i < r; i += nwarps) {
        const float cd = cand_d[b * r + i];
        uint32_t key = INF_KEY;
        if (!isinf(cd)) {  // warp-uniform
            const size_t pos = (size_t)cand_pos[b * r + i];
            float acc = 0.0f;
            if (SQ16) {
                const float sr = scales[pos];
                const float base = __fsub_rn(mins[pos], __fmul_rn(128.0f, sr));
                const float s16 = __fmul_rn(sr, s16_ratio);
                const ushort4* xr = reinterpret_cast<const ushort4*>(
                    static_cast<const uint16_t*>(rows) + pos * d);
                for (int j = lane; j < (d >> 2); j += 32) {
                    const ushort4 u = xr[j];
                    acc = fmaf(__fadd_rn(base, __fmul_rn(s16, (float)u.x)), s_q[4 * j], acc);
                    acc = fmaf(__fadd_rn(base, __fmul_rn(s16, (float)u.y)), s_q[4 * j + 1], acc);
                    acc = fmaf(__fadd_rn(base, __fmul_rn(s16, (float)u.z)), s_q[4 * j + 2], acc);
                    acc = fmaf(__fadd_rn(base, __fmul_rn(s16, (float)u.w)), s_q[4 * j + 3], acc);
                }
            } else {
                const float4* xr = reinterpret_cast<const float4*>(
                    static_cast<const float*>(rows) + pos * d);
                for (int j = lane; j < (d >> 2); j += 32) {
                    const float4 x = xr[j];
                    acc = fmaf(x.x, s_q[4 * j], acc);
                    acc = fmaf(x.y, s_q[4 * j + 1], acc);
                    acc = fmaf(x.z, s_q[4 * j + 2], acc);
                    acc = fmaf(x.w, s_q[4 * j + 3], acc);
                }
            }
            for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
            key = f2key(__fsub_rn(__fadd_rn(qnb, pnorms[pos]), __fmul_rn(2.0f, acc)));
        }
        if (lane == 0) s_ex[i] = key;
    }
    __syncthreads();
    if (replicated) {  // mask_duplicates: later copies of an id, and id -1
        for (int i = tid; i < r; i += blockDim.x) {
            const int id = s_id[i];
            bool dup = id == -1;
            for (int j = 0; j < i && !dup; ++j) dup = s_id[j] == id;
            if (dup) s_ex[i] = INF_KEY;
        }
        __syncthreads();
    }
    block_select(ArrayKey{s_ex}, r, k, s_key, s_pos, sc);
    for (int i = tid; i < k; i += blockDim.x) {
        const bool fin = s_key[i] < INF_KEY;
        out_d[b * k + i] = key2f(s_key[i]);
        out_i[b * k + i] = fin ? s_id[s_pos[i]] : -1;
    }
}

extern "C" int ivf_rerank(const float* q, const float* qn, const float* cand_d,
                          const int* cand_i, const int* cand_pos, int B, int r,
                          const void* rows, int sq16, const float* pnorms, const float* mins,
                          const float* scales, int d, int k, int replicated, float* out_d,
                          int* out_i, void* stream) {
    if (k < 1 || k > r || r > SEL_MAX || d % 4 != 0 || (sq16 && (mins == nullptr || scales == nullptr)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(SelectScratch) + (size_t)sel_pow2(k) * 2 * sizeof(int) +
                        (size_t)d * sizeof(float) + (size_t)r * 2 * sizeof(int);
    cudaError_t e = sq16 ? cudaFuncSetAttribute(rerank_kernel<true>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                         : cudaFuncSetAttribute(rerank_kernel<false>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return (int)e;
    }
    if (sq16)
        rerank_kernel<true><<<B, SEL_THREADS, smem, (cudaStream_t)stream>>>(
            q, qn, cand_d, cand_i, cand_pos, r, rows, pnorms, mins, scales, d, k, replicated,
            out_d, out_i);
    else
        rerank_kernel<false><<<B, SEL_THREADS, smem, (cudaStream_t)stream>>>(
            q, qn, cand_d, cand_i, cand_pos, r, rows, pnorms, mins, scales, d, k, replicated,
            out_d, out_i);
    return (int)cudaGetLastError();
}
