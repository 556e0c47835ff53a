// The persistent TMA + wgmma ring of the product kernels: K4b, K4 and K6
// (direct_spectra.cu), K3 (rdft_spectra.cu), P1 and P2 (probes.cu).
//
// A block of kThreads = 384 runs two consumer warpgroups (0, 1) and one
// producer warpgroup (2), of which one thread starts every TMA load.  A
// product tile runs in stages kBk = 64 deep through a ring of kStages
// buffers in shared memory.  Each buffer has a `full` mbarrier (the
// producer's expect_tx; the TMA loads complete it) and an `empty` one (one
// arrive from each consumer warpgroup once its wgmma group on the buffer
// has retired).  A block walks the units blockIdx.x, + gridDim.x, ...,
// each of `sweep` product tiles; the kernel says what a stage loads, which
// wgmmas it runs and what a tile's epilogue does.  Two host helpers size
// the grids of the kernels' pre-passes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ring {

constexpr int kStages = 4;
constexpr int kThreads = 384;                 // 2 consumer WGs + 1 producer
constexpr int kBm = 128;                      // rows of a tile (2 x 64)
constexpr int kBk = 64;                       // depth of a stage
constexpr int kBox = 32;                      // depth of an A box (64 bytes)
constexpr uint32_t kBoxA = kBm * kBox * 2;    // 8 KB: 128 rows x 64 B
constexpr uint32_t kBoxB = kBk * 64 * 2;      // 8 KB: 64 rows x 64 columns

// Dynamic shared memory of a ring of `stage` bytes a buffer (1024 bytes of
// alignment slack and the barriers included), plus `extra` behind it.
constexpr size_t smem_bytes(uint32_t stage, size_t extra = 0) {
    return kStages * (size_t)stage + 1024 + 2 * kStages * sizeof(uint64_t) +
           extra;
}

struct Ring {
    unsigned char* base;      // 1024-aligned: the swizzled tiles need it
    uint32_t stage_bytes;
    uint64_t* full;
    uint64_t* empty;

    __device__ unsigned char* stage(int s) const {
        return base + s * stage_bytes;
    }
    // The first byte behind the barriers (the `extra` of smem_bytes).
    __device__ void* tail() const { return empty + kStages; }
};

// Every thread: carve the ring out of dynamic shared memory; thread 0
// initialises the barriers.  Ends with __syncthreads.
__device__ __forceinline__ Ring make(unsigned char* raw,
                                     uint32_t stage_bytes) {
    Ring r;
    r.base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
    r.stage_bytes = stage_bytes;
    r.full = reinterpret_cast<uint64_t*>(r.base + kStages * stage_bytes);
    r.empty = r.full + kStages;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            hopper::mbar_init(&r.full[s], 1);    // the producer's expect_tx
            hopper::mbar_init(&r.empty[s], 2);   // one arrive a consumer WG
        }
        hopper::mbar_fence_init();
    }
    __syncthreads();
    return r;
}

// The producer thread: every stage of every tile of this block's units,
// sweep_of(u) tiles for unit u.  load(u, t, kb, dst, bar) starts stage kb
// of tile t of unit u into `dst`, stage_bytes of TMA loads completing on
// `bar`.
template <class SweepOf, class Load>
__device__ __forceinline__ void produce_units(const Ring& r, long long units,
                                              SweepOf&& sweep_of, int kblocks,
                                              Load&& load) {
    int it = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const int sweep = sweep_of(u);
        for (int t = 0; t < sweep; ++t)
            for (int kb = 0; kb < kblocks; ++kb, ++it) {
                const int s = it % kStages;
                hopper::mbar_wait(&r.empty[s], ((it / kStages) & 1) ^ 1);
                hopper::mbar_expect_tx(&r.full[s], r.stage_bytes);
                load(u, t, kb, r.stage(s), &r.full[s]);
            }
    }
}

// produce_units with `sweep` tiles a unit.
template <class Load>
__device__ __forceinline__ void produce(const Ring& r, long long units,
                                        int sweep, int kblocks, Load&& load) {
    produce_units(r, units, [sweep](long long) { return sweep; }, kblocks,
                  load);
}

// What runs beside a stage's products unless the caller says otherwise.
struct Idle {
    __device__ void operator()(int) const {}
};

// A consumer warpgroup: the kblocks stages of its next tile (`it` counts
// the stages it has taken).  mma(src, kb) issues stage kb's wgmmas on the
// buffer `src`; a stage is freed once the group after it is issued.
// beside(kb) runs once stage kb's group is committed, while it and the
// group before it are in flight: CUDA-core work that must not touch the
// accumulators.  On return every wgmma of the tile has retired.
template <class Mma, class Beside = Idle>
__device__ __forceinline__ void consume(const Ring& r, int& it, int kblocks,
                                        bool elected, Mma&& mma,
                                        Beside&& beside = Beside()) {
    int prev = 0;
    for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(&r.full[s], (it / kStages) & 1);
        hopper::wgmma_fence();
        mma(r.stage(s), kb);
        hopper::wgmma_commit();
        beside(kb);
        // The group before this one is done: free its stage.
        hopper::wgmma_wait<1>();
        if (kb > 0 && elected) hopper::mbar_arrive(&r.empty[prev]);
        prev = s;
    }
    hopper::wgmma_wait<0>();
    if (elected) hopper::mbar_arrive(&r.empty[prev]);
}

// Host: the device's SM count into `sms`; returns a cudaError_t.
inline int sm_count(int& sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    return (int)err;
}

// Host: blocks of 256 threads for a grid-stride pre-pass over `total`
// elements, at most 8 an SM.
inline int prepass_blocks(long long total, int sms) {
    const long long blocks = (total + 255) / 256;
    return (int)(blocks < 8LL * sms ? blocks : 8LL * sms);
}

}  // namespace ring
