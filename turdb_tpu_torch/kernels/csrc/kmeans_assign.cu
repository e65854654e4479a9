// K3 kmeans_assign: nearest-centroid assignment (argmin or top-R, R <= 4).
//
// Replaces: turdb_tpu/models/ivf.py _assign_chunk / _assign_all /
// _assign_topk_all (and so the assignment step of _kmeans): a bf16
// x·Cᵀ with fp32 accumulation, `(xn + cn) - 2·dot`, then argmin or top-R.
//
// What bounds it on an H100: arithmetic. At the 1M-row build
// (x [1M,128], C ~ 8k then ~24.6k) a pass is 2-6 TFLOP against 0.5 GB of
// rows, so it is compute-bound; this first version runs the products on
// the fp32 FMA pipes (bf16 x bf16 is exact in fp32), not on the tensor
// cores, which is the later work.
//
// Design: a 256-thread block owns 64 rows and sweeps all centroids in
// tiles of 64, staging 32-wide slices of both operands in shared memory
// after rounding them to bf16 (as the reference casts them). Each thread
// accumulates a 4x4 micro-tile in registers and folds each finished tile
// into a running top-R of its 4 rows, kept in registers, so the [n, C]
// distance matrix is never materialised. The 16 threads that share a row
// sit in one warp and merge their top-R lists with shuffles at the end.
// Ordering is by (distance, centroid id): lowest id on ties, as
// jnp.argmin and lax.top_k; cn = +inf never wins unless a row is all +inf,
// which then returns ids 0..R-1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TM 64
#define TN 64
#define KC 32

__device__ __forceinline__ bool lex_less(float a, int ia, float b, int ib) {
    return a < b || (a == b && ia < ib);
}

template <int R>
__device__ __forceinline__ void insert(float (&bd)[R], int (&bi)[R], float v, int j) {
    if (!lex_less(v, j, bd[R - 1], bi[R - 1])) return;
    bd[R - 1] = v;
    bi[R - 1] = j;
#pragma unroll
    for (int s = R - 1; s > 0; --s) {
        if (lex_less(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
            float tv = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = tv;
            int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
        }
    }
}

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <int R>
__global__ void __launch_bounds__(256)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ xn, int n,
                     const float* __restrict__ cents, const float* __restrict__ cn,
                     int C, int d, int* __restrict__ out_i, float* __restrict__ out_d) {
    __shared__ float xs[TM][KC + 1];
    __shared__ float cs[TN][KC + 1];
    const int tid = threadIdx.x;
    const int tx = tid & 15, ty = tid >> 4;
    const int row0 = blockIdx.x * TM;

    float bd[4][R];
    int bi[4][R];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            bd[i][r] = __int_as_float(0x7f800000);
            bi[i][r] = 0x7fffffff;
        }
    }
    float rxn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int gr = row0 + ty + 16 * i;
        rxn[i] = gr < n ? xn[gr] : 0.0f;
    }

    for (int c0 = 0; c0 < C; c0 += TN) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        for (int k0 = 0; k0 < d; k0 += KC) {
            for (int e = tid; e < TM * KC; e += 256) {
                const int r = e / KC, kk = e % KC;
                const int gr = row0 + r, gk = k0 + kk;
                xs[r][kk] = (gr < n && gk < d) ? bf16_round(x[(size_t)gr * d + gk]) : 0.0f;
                const int gc = c0 + r;
                cs[r][kk] = (gc < C && gk < d) ? bf16_round(cents[(size_t)gc * d + gk]) : 0.0f;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < KC; ++kk) {
                float a[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = cs[tx + 16 * j][kk];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
            }
            __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = c0 + tx + 16 * j;
            if (col >= C) continue;
            const float cnj = cn[col];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float v = __fsub_rn(__fadd_rn(rxn[i], cnj), __fmul_rn(2.0f, acc[i][j]));
                insert<R>(bd[i], bi[i], v, col);
            }
        }
    }

    // merge the 16 partial lists of each row (lanes tx = 0..15 of a half-warp)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float pd[R];
            int pi[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                pd[r] = __shfl_xor_sync(0xffffffffu, bd[i][r], off);
                pi[r] = __shfl_xor_sync(0xffffffffu, bi[i][r], off);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) insert<R>(bd[i], bi[i], pd[r], pi[r]);
        }
    }
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int gr = row0 + ty + 16 * i;
            if (gr >= n) continue;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                out_i[(size_t)gr * R + r] = bi[i][r];
                out_d[(size_t)gr * R + r] = bd[i][r];
            }
        }
    }
}

extern "C" int kmeans_assign(const float* x, const float* xn, int n, const float* cents,
                             const float* cn, int C, int d, int r, int* out_i,
                             float* out_d, void* stream) {
    const dim3 grid((n + TM - 1) / TM);
    cudaStream_t s = (cudaStream_t)stream;
    switch (r) {
        case 1: kmeans_assign_kernel<1><<<grid, 256, 0, s>>>(x, xn, n, cents, cn, C, d, out_i, out_d); break;
        case 2: kmeans_assign_kernel<2><<<grid, 256, 0, s>>>(x, xn, n, cents, cn, C, d, out_i, out_d); break;
        case 3: kmeans_assign_kernel<3><<<grid, 256, 0, s>>>(x, xn, n, cents, cn, C, d, out_i, out_d); break;
        case 4: kmeans_assign_kernel<4><<<grid, 256, 0, s>>>(x, xn, n, cents, cn, C, d, out_i, out_d); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
