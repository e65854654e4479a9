// K1 ivf_probe_f32: the fused f32 IVF probe, one thread block per query.
//
// Replaces: turdb_tpu/models/ivf.py ivf_search_impl, f32 branch (the
// [B,P,L,d] block gather, the PRECISE fp32 dot, the L2 / cosine / IP
// epilogue, the dead / unallowed mask, the top copies*k, mask_duplicates
// from turdb_tpu/ops/topk.py and the final top-k).
//
// What bounds it on an H100: device-memory bandwidth. A query reads its P
// probed cells of L rows x d floats (P=5, L=256, d=128: 640 KB) and does
// 2 flops per byte, far below the card's ~20 fp32 flops per byte.
//
// Design: the query row sits in shared memory; each warp scores one
// stored row at a time with 16-byte loads and a shuffle reduction in
// plain fp32 FFMA (no TF32). Empty, dead and unallowed lanes are not read
// at all: they are +inf, which saves the bandwidth of the padding lanes
// the reference gathers and discards. The P*L keys and ids live in
// dynamic shared memory (10 KB at P=5, 128 KB at P=64, above 48 KB by
// opt-in), so the distances never reach device memory. block_select
// (select.cuh) then takes the m smallest by (distance, lane position) -
// the reference's tie order - and, with replicas, a lane keeps its id
// only if no earlier winner holds it; the first k survivors are written.
#include "select.cuh"

struct SharedKey {
    const uint32_t* keys;
    __device__ __forceinline__ uint32_t operator()(int j) const { return keys[j]; }
};

__global__ void __launch_bounds__(SEL_THREADS)
ivf_probe_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                 const int* __restrict__ cells, int P,
                 const float* __restrict__ pvecs, const float* __restrict__ pnorms,
                 const int* __restrict__ members, const uint8_t* __restrict__ alive,
                 const uint8_t* __restrict__ allowed, int L, int d, int metric,
                 int k, int m, int replicated, float* __restrict__ out_d,
                 int* __restrict__ out_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    SelectScratch* sc = reinterpret_cast<SelectScratch*>(smem);
    uint32_t* s_key = reinterpret_cast<uint32_t*>(sc + 1);
    int* s_pos = reinterpret_cast<int*>(s_key + SEL_MAX);
    int* s_cid = s_pos + SEL_MAX;
    float* s_q = reinterpret_cast<float*>(s_cid + SEL_MAX);
    const int n = P * L;
    uint32_t* s_lkey = reinterpret_cast<uint32_t*>(s_q + d);
    int* s_lid = reinterpret_cast<int*>(s_lkey + n);

    const size_t b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const uint32_t inf_key = f2key(__int_as_float(0x7f800000));
    for (int i = tid; i < d; i += blockDim.x) s_q[i] = q[b * d + i];
    const float qnb = qn[b];
    __syncthreads();

    const int d4 = d >> 2;
    for (int pos = warp; pos < n; pos += nwarps) {
        const int p = pos / L;
        const int l = pos - p * L;
        const size_t row = (size_t)cells[b * P + p] * L + l;
        const int mem = members[row];
        const bool live = mem >= 0 && alive[row] != 0 &&
                          (allowed == nullptr || allowed[row] != 0);
        uint32_t key = inf_key;
        if (live) {  // warp-uniform: every lane reads the same row
            const float4* xr = reinterpret_cast<const float4*>(pvecs + row * d);
            float acc = 0.0f;
            for (int j = lane; j < d4; j += 32) {
                const float4 x = xr[j];
                acc = fmaf(x.x, s_q[4 * j], acc);
                acc = fmaf(x.y, s_q[4 * j + 1], acc);
                acc = fmaf(x.z, s_q[4 * j + 2], acc);
                acc = fmaf(x.w, s_q[4 * j + 3], acc);
            }
            for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
            float dist;
            if (metric == 0) {
                dist = __fsub_rn(__fadd_rn(qnb, pnorms[row]), __fmul_rn(2.0f, acc));
            } else if (metric == 1) {
                dist = __fsub_rn(1.0f, acc);
            } else {
                dist = -acc;
            }
            key = f2key(dist);
        }
        if (lane == 0) {
            s_lkey[pos] = key;
            s_lid[pos] = mem;
        }
    }
    __syncthreads();

    block_select(SharedKey{s_lkey}, n, m, s_key, s_pos, sc);
    for (int i = tid; i < m; i += blockDim.x) s_cid[i] = s_lid[s_pos[i]];
    __syncthreads();
    // s_pos is free now: reuse it as the keep flag of each winner
    for (int i = tid; i < m; i += blockDim.x) {
        bool keep = s_key[i] < inf_key;
        if (keep && replicated) {
            const int id = s_cid[i];
            for (int j = 0; j < i && keep; ++j) keep = s_cid[j] != id;
        }
        s_pos[i] = keep;
    }
    __syncthreads();
    if (tid == 0) {
        int o = 0;
        for (int i = 0; i < m && o < k; ++i) {
            if (s_pos[i]) {
                out_d[b * k + o] = key2f(s_key[i]);
                out_i[b * k + o] = s_cid[i];
                ++o;
            }
        }
        for (; o < k; ++o) {
            out_d[b * k + o] = __int_as_float(0x7f800000);
            out_i[b * k + o] = -1;
        }
    }
}

extern "C" int ivf_probe_f32(const float* q, const float* qn, const int* cells,
                             int B, int P, const float* pvecs, const float* pnorms,
                             const int* members, const uint8_t* alive,
                             const uint8_t* allowed, int L, int d, int metric,
                             int k, int m, int replicated, float* out_d, int* out_i,
                             void* stream) {
    // the selection keeps at most SEL_MAX winners; the P*L keys must fit
    // the shared memory one block may opt into (cudaFuncSetAttribute fails)
    if (k < 1 || m < k || m > SEL_MAX || m > P * L) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(SelectScratch) + 3 * SEL_MAX * sizeof(int) +
                        (size_t)d * sizeof(float) + (size_t)P * L * 2 * sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        ivf_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
        cudaGetLastError();  // clear it, or the next launch would report it
        return (int)e;
    }
    ivf_probe_kernel<<<B, SEL_THREADS, smem, (cudaStream_t)stream>>>(
        q, qn, cells, P, pvecs, pnorms, members, alive, allowed, L, d, metric,
        k, m, replicated, out_d, out_i);
    return (int)cudaGetLastError();
}
