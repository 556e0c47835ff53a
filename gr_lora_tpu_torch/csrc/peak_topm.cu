// Pyramid peak epilogue shared by the rDFT (K1) and overlap (K2) lattices.
//
// Replaces the in-kernel top-M loops of the TPU kernels
// (gr_lora_tpu/ops/pallas_rdft.py `_peaks_kernel`, pallas_peaks.py
// `_kernel`) and the XLA epilogue they mirror (models/pyramid.py:195-206):
// per hop row, the strict cyclic local maxima of the windowed fold faw
// (x > left && x > right, wrapping at bins 0 and K-1) that exceed the
// threshold, reduced to the top M by value with ties going to the lower
// bin (lax.top_k's order).  h / h_single are read from fa / hs at the
// chosen bins; unfilled slots hold bin 0, zero heights and valid = 0.
//
// Bound on the card: one read of three f32 [R, K] arrays (bytes).  One
// block per row: every thread scans a strided slice of the row once,
// keeping its own sorted list of its best min(M, 16) candidates in
// registers, then M block-wide arg-max rounds merge the per-thread lists —
// no second pass over K for M <= 16.  Any M in [1, K] through a second
// instance (kRefill): a thread whose list runs dry after 16 of its
// candidates were taken rescans its slice for the best 16 below the last
// one taken (the order is total: value, then bin), so the rounds see every
// candidate in order.  The M <= 16 instance has no rescan code, and keeps
// its registers and occupancy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kList = 16;          // candidates a thread holds at once

struct Cand {
    float v;
    int b;
};

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
    return a.v > b.v || (a.v == b.v && a.b < b.b);
}

__device__ __forceinline__ Cand warp_best(Cand c) {
    for (int off = 16; off > 0; off >>= 1) {
        Cand o;
        o.v = __shfl_down_sync(0xffffffffu, c.v, off);
        o.b = __shfl_down_sync(0xffffffffu, c.b, off);
        if (better(o, c)) c = o;
    }
    return c;
}

// This thread's best `len` candidates of its slice (bins threadIdx.x +
// kThreads i) that rank below `after` (kRefill; all of them otherwise),
// sorted best first.  Returns whether the slice may hold more (the list
// came back full).
template <bool kRefill>
__device__ __forceinline__ bool scan(const float* w, int k, int len,
                                     float threshold, const Cand& after,
                                     Cand (&list)[kList]) {
    const Cand empty = {-INFINITY, 0x7fffffff};
#pragma unroll
    for (int s = 0; s < kList; ++s) list[s] = empty;
    // Ascending bins per thread: an insertion that only displaces on a
    // strictly better candidate keeps the lower bin first on equal values.
    for (int c = threadIdx.x; c < k; c += kThreads) {
        const float x = w[c];
        const float l = w[c == 0 ? k - 1 : c - 1];
        const float r = w[c == k - 1 ? 0 : c + 1];
        Cand cand = {x, c};
        if (x > threshold && x > l && x > r &&
            (!kRefill || better(after, cand))) {
#pragma unroll
            for (int s = 0; s < kList; ++s) {
                if (s < len && better(cand, list[s])) {
                    const Cand t = list[s];
                    list[s] = cand;
                    cand = t;
                }
            }
        }
    }
    bool full = false;
#pragma unroll
    for (int s = 0; s < kList; ++s)    // constant indices: list stays in
        if (s == len - 1) full = list[s].v != -INFINITY;    // registers
    return full;
}

template <bool kRefill>
__global__ void __launch_bounds__(kThreads)
peak_topm_kernel(const float* __restrict__ faw, const float* __restrict__ fa,
                 const float* __restrict__ hs, int* __restrict__ bins,
                 float* __restrict__ h, float* __restrict__ h_single,
                 uint8_t* __restrict__ valid, int k, int m, float threshold) {
    const long long row = blockIdx.x;
    const float* w = faw + row * k;
    const Cand empty = {-INFINITY, 0x7fffffff};
    const Cand first = {INFINITY, -1};        // ranks above every candidate
    const int len = m < kList ? m : kList;

    Cand list[kList];
    [[maybe_unused]] bool more =
        scan<kRefill>(w, k, len, threshold, first, list);

    __shared__ Cand warp_top[kWarps];
    __shared__ Cand winner;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int slot = 0; slot < m; ++slot) {
        Cand best = warp_best(list[0]);
        if (lane == 0) warp_top[warp] = best;
        __syncthreads();
        if (warp == 0) {
            Cand c = lane < kWarps ? warp_top[lane] : empty;
            c = warp_best(c);
            if (lane == 0) winner = c;
        }
        __syncthreads();
        const Cand win = winner;
        if (list[0].b == win.b && win.v != -INFINITY) {
            // Only the owning thread holds this bin: pop its head, and
            // refill a list it has emptied.
#pragma unroll
            for (int s = 0; s + 1 < kList; ++s) list[s] = list[s + 1];
            list[kList - 1] = empty;
            if constexpr (kRefill)
                if (list[0].v == -INFINITY && more && slot + 1 < m)
                    more = scan<true>(w, k, len, threshold, win, list);
        }
        if (threadIdx.x == 0) {
            const long long o = row * m + slot;
            const bool ok = win.v != -INFINITY;
            bins[o] = ok ? win.b : 0;
            h[o] = ok ? fa[row * k + win.b] : 0.0f;
            h_single[o] = ok ? hs[row * k + win.b] : 0.0f;
            valid[o] = ok ? 1 : 0;
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int grl_peak_topm(const float* faw, const float* fa,
                             const float* hs, int* bins, float* h,
                             float* h_single, uint8_t* valid, long long rows,
                             int k, int m, float threshold, void* stream) {
    if (rows <= 0) return 0;
    if (m < 1 || m > k || k < 3) return cudaErrorInvalidValue;
    auto* kernel =
        m <= kList ? peak_topm_kernel<false> : peak_topm_kernel<true>;
    kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
        faw, fa, hs, bins, h, h_single, valid, k, m, threshold);
    return (int)cudaGetLastError();
}
