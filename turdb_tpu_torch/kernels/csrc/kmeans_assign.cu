// K3 kmeans_assign: nearest-centroid assignment (argmin or top-R, R <= 4).
//
// Replaces: turdb_tpu/models/ivf.py _assign_chunk / _assign_all /
// _assign_topk_all (and so the assignment step of _kmeans): a bf16
// x·Cᵀ with fp32 accumulation, `(xn + cn) - 2·dot`, then argmin or top-R.
//
// What bounds it on an H100: arithmetic. At the 1M-row build
// (x [1M,128], C ~ 8k then ~24.6k) a pass is 2-6 TFLOP against 0.26 GB of
// bf16 rows, so it is compute-bound, and on the bf16 tensor cores.
//
// Design. The operands arrive rounded to bf16 once by the caller (the rows
// once per k-means run, the centroids once per call), zero-padded to a
// multiple of 16 columns, which leaves every dot unchanged. A 256-thread
// block owns BM = 128 rows; their bf16 tile (d <= 384) is copied into
// shared memory once and stays there while the block sweeps all
// centroids in tiles of BN = 64, which stream through a two-stage
// cp.async ring. Each of the 8 warps computes a 32 x 32 piece of the
// 128 x 64 tile with mma.sync.m16n8k16 (bf16 in, fp32 accumulate; a
// bf16 x bf16 product is exact in fp32, so only the order of the sums
// differs from another GEMM, and it is fixed: a build is the same on every
// run). Fragments come from padded shared-memory rows by ldmatrix, free of
// bank conflicts. The epilogue works on the accumulator fragments:
// `(xn + cn) - 2·acc` rounded as the reference rounds it, tested against
// the thread's current R-th best of that row before any insert into a
// running top-R in registers; the [n, C] matrix is never written. At the
// end the four lanes that share a row merge with shuffles and the two
// warps that share it through shared memory. Ordering is by (distance,
// centroid id): lowest id on ties, as jnp.argmin and lax.top_k; cn = +inf
// never wins unless a row is all +inf, which then returns ids 0..R-1.
// Wider rows (d > 384) stream k-chunks of 128 columns of both operands
// instead of keeping the row tile resident.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 128
#define BN 64
#define NTHREADS 256
#define PAD 8              // bf16 a shared row carries past its data: 16 B
#define K_RESIDENT 384     // widest padded d whose row tile stays resident
#define KC 128             // k-chunk of the streamed path

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [r0, r0 + nrows) x columns [k0, k0 + kw) of a [total, ld] bf16
// matrix into a shared tile of row stride `stride`; rows past `total` are
// zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int nrows, int total, int ld, int k0,
                                          int kw, int stride) {
    const int per_row = kw >> 3;   // 16-byte pieces
    for (int e = threadIdx.x; e < nrows * per_row; e += NTHREADS) {
        const int r = e / per_row, p = e % per_row;
        const int gr = r0 + r;
        const bool ok = gr < total;
        const __nv_bfloat16* s = src + (size_t)(ok ? gr : 0) * ld + k0 + p * 8;
        cp_async16(dst + r * stride + p * 8, s, ok);
    }
}

template <int R>
__global__ void __launch_bounds__(NTHREADS)
kmeans_assign_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ xn, int n,
                     const __nv_bfloat16* __restrict__ cents, const float* __restrict__ cn,
                     int C, int d, int* __restrict__ out_i, float* __restrict__ out_d) {
    extern __shared__ __align__(16) unsigned char smem[];
    const bool resident = d <= K_RESIDENT;
    const int kw_max = resident ? d : KC;            // columns a shared row holds
    const int xrow = kw_max + PAD;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);   // 1 or 2 stages
    __nv_bfloat16* cs = xs + (resident ? 1 : 2) * BM * xrow;      // 2 stages

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 3, wn = warp >> 2;        // 4 x 2 warps over 128 x 64
    const int row0 = blockIdx.x * BM;
    const int nk = resident ? 1 : (d + KC - 1) / KC;
    const int ntiles = (C + BN - 1) / BN;
    const int steps = ntiles * nk;

    float bd[4][R];
    int bi[4][R];
    float rxn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            bd[i][r] = __int_as_float(0x7f800000);
            bi[i][r] = 0x7fffffff;
        }
        // row of fragment slot i: (mi = i / 2, h = i % 2)
        const int gr = row0 + wm * 32 + (i >> 1) * 16 + (lane >> 2) + (i & 1) * 8;
        rxn[i] = gr < n ? xn[gr] : 0.0f;
    }

    auto issue = [&](int s) {
        const int t = s / nk, kc = s % nk;
        const int k0 = kc * KC;
        const int kw = resident ? d : min(KC, d - k0);
        const int buf = s & 1;
        if (!resident) load_tile(xs + buf * BM * xrow, x, row0, BM, n, d, k0, kw, xrow);
        load_tile(cs + buf * BN * xrow, cents, t * BN, BN, C, d, k0, kw, xrow);
    };

    if (resident) load_tile(xs, x, row0, BM, n, d, 0, d, xrow);
    issue(0);
    cp_async_commit();

    float acc[2][4][4];
    for (int s = 0; s < steps; ++s) {
        if (s + 1 < steps) issue(s + 1);
        cp_async_commit();
        cp_async_wait1();
        __syncthreads();
        const int t = s / nk, kc = s % nk;
        const int kw = resident ? d : min(KC, d - kc * KC);
        const __nv_bfloat16* xt = xs + (resident ? 0 : (s & 1) * BM * xrow);
        const __nv_bfloat16* ct = cs + (s & 1) * BN * xrow;
        if (kc == 0) {
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
        }
        // lane addresses of the ldmatrix rows
        const __nv_bfloat16* pa = xt + (wm * 32 + (lane & 15)) * xrow + (lane >> 4) * 8;
        const __nv_bfloat16* pb =
            ct + (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * xrow + ((lane >> 3) & 1) * 8;
        for (int k16 = 0; k16 < kw; k16 += 16) {
            uint32_t a[2][4], b[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) ldmatrix_x4(a[mi], pa + mi * 16 * xrow + k16);
#pragma unroll
            for (int np = 0; np < 2; ++np) ldmatrix_x4(b[np], pb + np * 16 * xrow + k16);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                             b[ni >> 1][(ni & 1) * 2 + 1]);
        }
        if (kc == nk - 1) {
            // epilogue on the fragments: slot (mi, ni, h*2 + e) is row
            // (mi, h), column ni*8 + 2*(lane & 3) + e of the warp's piece
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = t * BN + wn * 32 + ni * 8 + 2 * (lane & 3) + e;
                    if (col >= C) continue;
                    const float cnj = __ldg(cn + col);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float v = __fsub_rn(__fadd_rn(rxn[i], cnj),
                                                  __fmul_rn(2.0f, acc[i >> 1][ni][(i & 1) * 2 + e]));
                        if (lex_less(v, col, bd[i][R - 1], bi[i][R - 1]))
                            insert<R>(bd[i], bi[i], v, col);
                    }
                }
            }
        }
        __syncthreads();   // this stage's buffers are refilled by the next issue
    }

    // merge the lists of the 4 lanes of a quad (the same rows, other columns)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
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
    // then the two warps that share the rows: wn = 1 hands its lists over
    float* xd = reinterpret_cast<float*>(smem);             // [BM][R]
    int* xi = reinterpret_cast<int*>(xd + BM * R);          // [BM][R]
    if (wn == 1 && (lane & 3) == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int lr = wm * 32 + (i >> 1) * 16 + (lane >> 2) + (i & 1) * 8;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                xd[lr * R + r] = bd[i][r];
                xi[lr * R + r] = bi[i][r];
            }
        }
    }
    __syncthreads();
    if (wn == 0 && (lane & 3) == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int lr = wm * 32 + (i >> 1) * 16 + (lane >> 2) + (i & 1) * 8;
            const int gr = row0 + lr;
#pragma unroll
            for (int r = 0; r < R; ++r) insert<R>(bd[i], bi[i], xd[lr * R + r], xi[lr * R + r]);
            if (gr >= n) continue;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                out_i[(size_t)gr * R + r] = bi[i][r];
                out_d[(size_t)gr * R + r] = bd[i][r];
            }
        }
    }
}

template <int R>
static int launch(const __nv_bfloat16* x, const float* xn, int n, const __nv_bfloat16* cents,
                  const float* cn, int C, int d, int* out_i, float* out_d, cudaStream_t s) {
    const bool resident = d <= K_RESIDENT;
    const int xrow = (resident ? d : KC) + PAD;
    const size_t smem = ((resident ? 1 : 2) * BM + 2 * BN) * (size_t)xrow * sizeof(__nv_bfloat16);
    cudaError_t err = cudaFuncSetAttribute(kmeans_assign_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + BM - 1) / BM);
    kmeans_assign_kernel<R><<<grid, NTHREADS, smem, s>>>(x, xn, n, cents, cn, C, d, out_i, out_d);
    return (int)cudaGetLastError();
}

// x [n, d] and cents [C, d] bf16 with d a multiple of 16, 16-byte aligned.
extern "C" int kmeans_assign(const void* x, const float* xn, int n, const void* cents,
                             const float* cn, int C, int d, int r, int* out_i,
                             float* out_d, void* stream) {
    if (d % 16 != 0 || d < 16) return (int)cudaErrorInvalidValue;
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    const __nv_bfloat16* cb = (const __nv_bfloat16*)cents;
    cudaStream_t s = (cudaStream_t)stream;
    switch (r) {
        case 1: return launch<1>(xb, xn, n, cb, cn, C, d, out_i, out_d, s);
        case 2: return launch<2>(xb, xn, n, cb, cn, C, d, out_i, out_d, s);
        case 3: return launch<3>(xb, xn, n, cb, cn, C, d, out_i, out_d, s);
        case 4: return launch<4>(xb, xn, n, cb, cn, C, d, out_i, out_d, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
