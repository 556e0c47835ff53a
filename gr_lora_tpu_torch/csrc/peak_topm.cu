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
// its registers and occupancy.  The main path runs it only for M > 16:
// K1 and K2 search their peaks in their product kernels' epilogues.
//
// The merge of those fused searches (peak_merge.cuh) lives here too, as
// the epilogue's last step: a group of 8 lanes a row (four rows a warp),
// or a warp for a row of more than 64 lists and pairs.  Each lane inserts
// the candidates of its share of the row's lists (their heads read four
// at a time, the rest of a list at once behind a peak, up to its first
// empty slot) and its share of the resolved edge pairs into its own sorted
// list of M in registers (an instance for M <= 8 and one for M <= 16),
// then M rounds of a butterfly arg-max over the group's heads pop the
// row's peaks in order; the owner of a winner writes its slot, and the
// rounds stop at the first empty one.  Bound: the candidates it reads, a
// small fraction of the dense spectra that peak_topm_kernel reads, so its
// time is load latency: hence four rows a warp and independent loads (read
// entry by entry, a warp a row, it was several times slower on the H100,
// most of all for K2's SF12 rows of 128 lists and 128 pairs).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "peak_merge.cuh"

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

template <int kCap>
__device__ __forceinline__ void push(peaks::Cand (&list)[kCap], int m,
                                     peaks::Cand c) {
#pragma unroll
    for (int s = 0; s < kCap; ++s) {
        if (s < m && peaks::better(c, list[s])) {
            const peaks::Cand t = list[s];
            list[s] = c;
            c = t;
        }
    }
}

// One row a group of kLanes lanes; a list of kCap >= m a lane.
template <int kCap, int kLanes>
__global__ void __launch_bounds__(kThreads)
peak_merge_kernel(const peaks::Cand* __restrict__ lists, int nlists,
                  const peaks::Cand* __restrict__ pairs, int npairs,
                  long long rows, int m, int* __restrict__ bins,
                  float* __restrict__ h, float* __restrict__ h_single,
                  uint8_t* __restrict__ valid) {
    const int lane = threadIdx.x % kLanes;
    const long long row =
        (long long)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
    if (row >= rows) return;                // the whole group leaves
    const unsigned group =
        kLanes == 32 ? 0xffffffffu
                     : ((1u << kLanes) - 1) << (threadIdx.x % 32 / kLanes *
                                                kLanes);
    const peaks::Cand none = {-INFINITY, 0x7fffffff, 0.0f, 0.0f};
    peaks::Cand list[kCap];
#pragma unroll
    for (int s = 0; s < kCap; ++s) list[s] = none;
    // The heads of kBatch lists, and kBatch pairs, at a time (independent
    // loads); the rest of a list, all at once, only behind a peak.
    constexpr int kBatch = 4;
    for (int l0 = lane; l0 < nlists; l0 += kLanes * kBatch) {
        peaks::Cand head[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int l = l0 + u * kLanes;
            head[u] = l < nlists ? lists[(row * nlists + l) * m] : none;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (head[u].v == -INFINITY) continue;     // an empty list
            push(list, m, head[u]);
            const peaks::Cand* src =
                lists + (row * nlists + l0 + u * kLanes) * m;
            peaks::Cand rest[kCap];
#pragma unroll
            for (int s = 1; s < kCap; ++s) rest[s] = s < m ? src[s] : none;
#pragma unroll
            for (int s = 1; s < kCap; ++s) {
                if (rest[s].v == -INFINITY) break;    // the list's end
                push(list, m, rest[s]);
            }
        }
    }
    for (int p0 = lane; p0 < npairs; p0 += kLanes * kBatch) {
        peaks::Cand a[kBatch], b[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int p = p0 + u * kLanes;
            a[u] = b[u] = none;
            if (p < npairs) {
                a[u] = pairs[(row * npairs + p) * 2];
                b[u] = pairs[(row * npairs + p) * 2 + 1];
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (a[u].b >= 0 && a[u].v > b[u].v) push(list, m, a[u]);
            if (b[u].b >= 0 && b[u].v > a[u].v) push(list, m, b[u]);
        }
    }
    for (int slot = 0; slot < m; ++slot) {
        // Every lane of the group gets the best head (bins are unique in
        // a row).
        float v = list[0].v;
        int b = list[0].b;
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(group, v, off);
            const int ob = __shfl_xor_sync(group, b, off);
            if (ov > v || (ov == v && ob < b)) {
                v = ov;
                b = ob;
            }
        }
        if (v == -INFINITY) {               // the same in every lane
            for (int s = slot + lane; s < m; s += kLanes) {
                const long long o = row * m + s;
                bins[o] = 0;
                h[o] = 0.0f;
                h_single[o] = 0.0f;
                valid[o] = 0;
            }
            break;
        }
        if (list[0].b == b && list[0].v == v) {
            const long long o = row * m + slot;
            bins[o] = b;
            h[o] = list[0].h;
            h_single[o] = list[0].hs;
            valid[o] = 1;
#pragma unroll
            for (int s = 0; s + 1 < kCap; ++s) list[s] = list[s + 1];
            list[kCap - 1] = none;
        }
    }
}

template <int kCap, int kLanes>
int launch_merge_as(const peaks::Cand* lists, int nlists,
                    const peaks::Cand* pairs, int npairs, long long rows,
                    int m, int* bins, float* h, float* h_single,
                    uint8_t* valid, cudaStream_t stream) {
    const long long per_block = kThreads / kLanes;
    const long long blocks = (rows + per_block - 1) / per_block;
    peak_merge_kernel<kCap, kLanes><<<(unsigned)blocks, kThreads, 0,
                                      stream>>>(
        lists, nlists, pairs, npairs, rows, m, bins, h, h_single, valid);
    return (int)cudaGetLastError();
}

}  // namespace

// A row of up to 64 lists and pairs takes 8 lanes (four rows a warp), a
// longer one a warp; M <= 8 keeps a list of 8 a lane, else of 16.
int peaks::launch_merge(const Cand* lists, int nlists, const Cand* pairs,
                        int npairs, long long rows, int m, int* bins,
                        float* h, float* h_single, uint8_t* valid,
                        cudaStream_t stream) {
    if (rows <= 0) return 0;
    if (m < 1 || m > kMaxM || nlists < 1 || npairs < 0 ||
        (npairs > 0 && pairs == nullptr))
        return cudaErrorInvalidValue;
    const bool wide = nlists + npairs > 64;
    auto* fn = m <= 8 ? (wide ? launch_merge_as<8, 32> : launch_merge_as<8, 8>)
                      : (wide ? launch_merge_as<kMaxM, 32>
                              : launch_merge_as<kMaxM, 8>);
    return fn(lists, nlists, pairs, npairs, rows, m, bins, h, h_single, valid,
              stream);
}

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
