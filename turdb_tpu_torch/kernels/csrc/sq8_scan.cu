// K11 sq8_scan: asymmetric L2² k-NN over a u8 (SQ8) store, per row chunk.
//
// Replaces: turdb_tpu/ops/quantize.py `sq8_search` (quantize.py:42-76):
// with x̂ = min + scale·u,
//   d(q, x̂) = qn − 2·(min·Σq + scale·(q·u)) + (d·min² + 2·min·scale·Σu + scale²·Σu²),
// clamped at 0, +inf where `valid` is false, then the k smallest.
//
// What bounds it on an H100: operations. B x N x d multiply-adds (268
// GFLOP at B = 1024, N = 1M, d = 128: 4.0 ms at fp32's 67 TFLOP/s) against
// N·d code bytes (128 MB, 0.04 ms at 3.35 TB/s). The products stay fp32,
// as the reference's f32 `dot_general`: u8 codes are exact in bf16, but
// the f32 query is not, so the tensor-core route (wgmma) is later work.
//
// Design: a 256-thread block owns 64 queries and one chunk of rows, which
// it sweeps in tiles of 64 rows. A tile's product is staged through
// shared memory in depth slices of 32: the queries as f32, the codes
// widened from u8 to f32; each thread accumulates a 4 x 4 micro-tile with
// fp32 FMAs. The epilogue is fused: Σu and Σu² (exact integer sums) and
// the row's ‖x̂‖² are computed once per row tile, then the clamp and the
// valid mask, and the tile's 64 x 64 distances go to shared memory. Each
// warp keeps the running k best (k <= 32) of 8 queries as one sorted list
// per query spread over the lanes (lane i holds the i-th best): a tile's
// candidates below the list's k-th enter in row order, by a ballot for
// the position and a shuffle of the tail, so ties go to the lower row.
// Each chunk writes its [B, k] list; one K2 launch (topk_rows) merges the
// chunks, ties to the lower chunk, i.e. the lower row.
#include <cuda_runtime.h>
#include <stdint.h>

#define SQ_TQ 64
#define SQ_TN 64
#define SQ_KC 32
#define SQ_KMAX 32
#define SQ_THREADS 256
#define SQ_QPW (SQ_TQ / (SQ_THREADS / 32))   // queries a warp selects for: 8

__global__ void __launch_bounds__(SQ_THREADS)
sq8_scan_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                const float* __restrict__ qsum, int B, const uint8_t* __restrict__ codes,
                const float* __restrict__ mins, const float* __restrict__ scales,
                const uint8_t* __restrict__ valid, int N, int d, int chunk, int k,
                float* __restrict__ out_d, int* __restrict__ out_i) {
    __shared__ __align__(16) float s_q[SQ_KC][SQ_TQ];
    __shared__ __align__(16) float s_u[SQ_KC][SQ_TN];
    __shared__ float s_dist[SQ_TQ][SQ_TN + 1];
    __shared__ float s_xn[SQ_TN], s_min[SQ_TN], s_scale[SQ_TN];
    __shared__ int s_ok[SQ_TN];
    const float INF = __int_as_float(0x7f800000);
    const unsigned FULL = 0xffffffffu;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;   // rows tx*4.., queries ty*4..
    const int warp = tid >> 5, lane = tid & 31;
    const int q0 = blockIdx.x * SQ_TQ;
    const int r_begin = blockIdx.y * chunk;
    const int r_end = min(N, r_begin + chunk);

    float best_d[SQ_QPW];
    int best_i[SQ_QPW];
#pragma unroll
    for (int j = 0; j < SQ_QPW; ++j) {
        best_d[j] = INF;
        best_i[j] = -1;
    }

    for (int r0 = r_begin; r0 < r_end; r0 += SQ_TN) {
        {   // row terms: four threads a row, integer sums (exact in fp32)
            const int rr = tid >> 2, part = tid & 3;
            const int gr = r0 + rr;
            float su = 0.0f, sq = 0.0f;
            if (gr < r_end) {
                const uint8_t* c = codes + (size_t)gr * d;
                for (int j = part; j < d; j += 4) {
                    const float u = (float)c[j];
                    su += u;
                    sq = fmaf(u, u, sq);
                }
            }
            su += __shfl_xor_sync(FULL, su, 1);
            su += __shfl_xor_sync(FULL, su, 2);
            sq += __shfl_xor_sync(FULL, sq, 1);
            sq += __shfl_xor_sync(FULL, sq, 2);
            if (part == 0) {
                if (gr < r_end) {
                    const float m = mins[gr], s = scales[gr];
                    // (d·min² + (2·min)·scale·Σu) + scale²·Σu², rounded op by op
                    const float t0 = __fmul_rn((float)d, __fmul_rn(m, m));
                    const float t1 = __fmul_rn(__fmul_rn(__fmul_rn(2.0f, m), s), su);
                    const float t2 = __fmul_rn(__fmul_rn(s, s), sq);
                    s_xn[rr] = __fadd_rn(__fadd_rn(t0, t1), t2);
                    s_min[rr] = m;
                    s_scale[rr] = s;
                    s_ok[rr] = (valid == nullptr || valid[gr]) ? 1 : 0;
                } else {
                    s_ok[rr] = 0;
                }
            }
        }
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        for (int k0 = 0; k0 < d; k0 += SQ_KC) {
            __syncthreads();
            for (int e = tid; e < SQ_TQ * SQ_KC; e += SQ_THREADS) {
                const int qq = e / SQ_KC, kk = e % SQ_KC;
                const int gq = q0 + qq, gk = k0 + kk;
                s_q[kk][qq] = (gq < B && gk < d) ? q[(size_t)gq * d + gk] : 0.0f;
            }
            for (int e = tid; e < SQ_TN * SQ_KC; e += SQ_THREADS) {
                const int rr = e / SQ_KC, kk = e % SQ_KC;
                const int gr = r0 + rr, gk = k0 + kk;
                s_u[kk][rr] = (gr < r_end && gk < d) ? (float)codes[(size_t)gr * d + gk] : 0.0f;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < SQ_KC; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(&s_q[kk][ty * 4]);
                const float4 u = *reinterpret_cast<const float4*>(&s_u[kk][tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float uv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], uv[j], acc[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qq = ty * 4 + i, gq = q0 + qq;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int rr = tx * 4 + j;
                float v = INF;
                if (gq < B && s_ok[rr]) {
                    // qn − 2·(min·Σq + scale·(q·u)) + ‖x̂‖², rounded op by op
                    const float qdx = __fadd_rn(__fmul_rn(s_min[rr], qsum[gq]),
                                                __fmul_rn(s_scale[rr], acc[i][j]));
                    const float dist = __fadd_rn(__fsub_rn(qn[gq], __fmul_rn(2.0f, qdx)), s_xn[rr]);
                    v = fmaxf(dist, 0.0f);
                }
                s_dist[qq][rr] = v;
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < SQ_QPW; ++j) {
            const int qq = warp * SQ_QPW + j;
            for (int half = 0; half < SQ_TN; half += 32) {
                const float v = s_dist[qq][half + lane];
                const int gid = r0 + half + lane;
                unsigned m = __ballot_sync(FULL, v < __shfl_sync(FULL, best_d[j], k - 1));
                while (m) {
                    const int src = __ffs(m) - 1;
                    m &= m - 1;
                    const float cv = __shfl_sync(FULL, v, src);
                    const int ci = __shfl_sync(FULL, gid, src);
                    if (cv < __shfl_sync(FULL, best_d[j], k - 1)) {
                        // after every equal value already held: ties keep the lower row
                        const int pos = __popc(__ballot_sync(FULL, lane < k && best_d[j] <= cv));
                        const float up_d = __shfl_up_sync(FULL, best_d[j], 1);
                        const int up_i = __shfl_up_sync(FULL, best_i[j], 1);
                        if (lane < k && lane > pos) {
                            best_d[j] = up_d;
                            best_i[j] = up_i;
                        } else if (lane == pos) {
                            best_d[j] = cv;
                            best_i[j] = ci;
                        }
                    }
                }
            }
        }
    }
    const size_t nch = gridDim.y;
#pragma unroll
    for (int j = 0; j < SQ_QPW; ++j) {
        const int gq = q0 + warp * SQ_QPW + j;
        if (gq < B && lane < k) {
            const size_t o = ((size_t)gq * nch + blockIdx.y) * k + lane;
            out_d[o] = best_d[j];
            out_i[o] = best_i[j];
        }
    }
}

extern "C" int sq8_scan(const float* q, const float* qn, const float* qsum, int B,
                        const uint8_t* codes, const float* mins, const float* scales,
                        const uint8_t* valid, int N, int d, int chunk, int k,
                        float* out_d, int* out_i, void* stream) {
    if (k < 1 || k > SQ_KMAX || chunk < 1 || chunk % SQ_TN || B < 1 || N < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((B + SQ_TQ - 1) / SQ_TQ, (N + chunk - 1) / chunk);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    sq8_scan_kernel<<<grid, SQ_THREADS, 0, (cudaStream_t)stream>>>(
        q, qn, qsum, B, codes, mins, scales, valid, N, d, chunk, k, out_d, out_i);
    return (int)cudaGetLastError();
}
