// Host-side launch helpers of the kernels with a dynamic shared-memory size
// that depends on the call: K5 (ivf_rerank.cu), K6 / K8 / K8-SQ
// (hnsw_beam.cu), K2's and the beams' wide forms (topk_rows.cu,
// graph_wide.cu).
//
// `raise_smem` sets a kernel's dynamic shared-memory limit on the current
// device only when a launch asks for more than every launch before it there
// (cudaFuncSetAttribute costs host time on every call, too slow for every launch), so the
// attribute is set once a process for each size a kernel grows to.
// `sm_blocks` is the occupancy calculator's blocks an SM at a size, asked
// once for each (kernel, device, threads, bytes). Both keep small tables
// behind one lock (ctypes calls run without Python's lock).
#pragma once
#include <cuda_runtime.h>

#include <mutex>

namespace launch_util {

struct SmemEntry {
    const void* fn;
    int dev;
    size_t bytes;
};
struct OccEntry {
    const void* fn;
    int dev, threads, blocks;
    size_t bytes;
};
constexpr int TABLE = 256;

inline std::mutex& table_lock() {
    static std::mutex mu;
    return mu;
}

inline int smem_limit(const void* fn, size_t bytes) {
    static SmemEntry seen[TABLE];
    static int n = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    std::lock_guard<std::mutex> lock(table_lock());
    int slot = -1;
    for (int i = 0; i < n; ++i)
        if (seen[i].fn == fn && seen[i].dev == dev) {
            if (seen[i].bytes >= bytes) return 0;
            slot = i;
        }
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) {
        cudaGetLastError();  // clear it for the next launch
        return (int)e;
    }
    if (slot < 0 && n < TABLE) slot = n++;
    if (slot >= 0) seen[slot] = SmemEntry{fn, dev, bytes};
    return 0;
}

// blocks of `fn` an SM runs at `threads` and `bytes` of dynamic shared
// memory (0 when it cannot run one)
inline int sm_blocks(const void* fn, int threads, size_t bytes) {
    static OccEntry seen[TABLE];
    static int n = 0;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    {
        std::lock_guard<std::mutex> lock(table_lock());
        for (int i = 0; i < n; ++i)
            if (seen[i].fn == fn && seen[i].dev == dev && seen[i].threads == threads &&
                seen[i].bytes == bytes)
                return seen[i].blocks;
    }
    int blocks = 0;
    if (smem_limit(fn, bytes) ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, bytes) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    std::lock_guard<std::mutex> lock(table_lock());
    if (n < TABLE) seen[n++] = OccEntry{fn, dev, threads, blocks, bytes};
    return blocks;
}

// a block's dynamic shared memory on the current device, opted in
inline size_t smem_optin() {
    int dev = 0, bytes = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return (size_t)bytes;
}

// SMs of the current device
inline int sm_count() {
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
}

}  // namespace launch_util

template <class K>
static int raise_smem(K kernel, size_t bytes) {
    return launch_util::smem_limit(reinterpret_cast<const void*>(kernel), bytes);
}

template <class K>
static int sm_blocks(K kernel, int threads, size_t bytes) {
    return launch_util::sm_blocks(reinterpret_cast<const void*>(kernel), threads, bytes);
}
