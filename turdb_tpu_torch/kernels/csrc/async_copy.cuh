// Asynchronous copies from device memory into shared memory, shared by the
// kernels that stage rows: K5 ivf_rerank (ivf_rerank.cu), K6 / K8-SQ
// (hnsw_beam.cu), K9 (hnsw_greedy.cu, through graph_scorer.cuh), and the
// wide forms of K6 / K8-SQ (graph_wide.cu) and K7 (hnsw_select_wide.cu).
//
// - `stage_copy16` / `stage_copy8` / `stage_copy4`: one thread's `cp.async`
//   of 16, 8 or 4 bytes (global address and shared destination aligned to
//   the size), waited for by `stage_wait` (cp.async.wait_all) in the thread
//   that issued it; a barrier then shows the bytes to the other threads.
// - `bulk_copy`: one thread's `cp.async.bulk` (the 1-D copy of the Tensor
//   Memory Accelerator) of a contiguous run of bytes (source, destination
//   and size multiples of 16), completing on an mbarrier in shared memory:
//   the issuing thread (or any) first arrives on the barrier with the bytes
//   to expect (`mbar_arrive_tx`), every thread that reads the bytes waits
//   for the barrier's phase (`mbar_wait`) with the parity of the phase it
//   expects (0 for the first use after `mbar_init`, then 1, 0, ...).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void stage_copy16(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void stage_copy8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void stage_copy4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// an mbarrier that one arrival (with its expected bytes) completes
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    } while (!done);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}
