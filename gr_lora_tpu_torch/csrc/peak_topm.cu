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
// peak_topm_kernel.  Bound on the card: bytes — faw read once, fa and hs
// only at the valid peaks (a 32-byte sector each), the M slots written.
// In noise a row holds one or two peaks, so the selection is cheap and
// the kernel has to stream.  Design: a warp owns a row and walks it in
// segments (1024 bins: a float4 a lane per 128 bins, neighbouring lanes on
// neighbouring addresses), persistent over the rows with the next
// segment's loads (the next row's, at a row's end) issued before the
// current one is searched: a register double buffer, 16 warps an SM.
// Neighbours come from the lane's own float4 or from lanes -1 / +1 by
// shuffle; a segment also carries the bins just before and after it (K-1
// and 0 at the row's ends: the cyclic wrap), and a row's last segment
// gives its bins past K bin 0's value (any K >= 3; a K that is no
// multiple of 4 loads one f32 a lane per 32 bins instead).  The tests of
// a segment's bins go into a mask, and only its set bits (a peak above
// the threshold: rare) are inserted into the lane's sorted list of its
// best 8 or 16 (compile-time indices only: registers, no stack frame).
// At a row's end M rounds of a warp arg-max by redux (the largest order
// key, then the least bin holding it) pop the row's peaks with no
// barrier; the rounds stop at the first empty one, lane s keeps slot s,
// and the winners' fa / hs gathers go out together, their stores waiting
// until the next segment is searched.  M > 16 runs an instance whose
// lane, once 16 of its candidates were taken, rescans its bins of the
// row (from device memory: it happens only where one lane holds more than
// 16 of the row's top M) for the best 16 below the last one taken (the
// order is total: value, then bin), so the rounds see every candidate in
// order; the M <= 16 instances have no rescan code.  The lists of 16 take
// segments of 512 bins, and 256 beside the rescan, to stay within 128
// registers.  The main path runs M 8 on the dense backends' folds, and
// M > 16 only where K1, K2 or K4 hand over their dense spectra.
//
// The merge of the fused searches (peak_merge.cuh) lives here too, as the
// epilogue's last step, in blocks of 64 threads: a group of 8 lanes a row
// for up to 32 lists and pairs (K1's), a warp a row for more (K2's: its
// 4096 SF10 rows are some 31 warps an SM).  Each lane loads the heads
// of its share of the row's lists and its share of the edge pairs as
// 16-byte vectors, all before its first insertion, then the rest of a list
// behind a peak (up to its first empty slot, four entries at a time), into
// its own sorted list of M in registers (an instance for M <= 8 and one
// for M <= 16).  Then the rounds pop the row's peaks in order: in a group
// of 8 a butterfly arg-max, the owner of a winner writing its slot; in a
// warp a redux arg-max, lane s keeping slot s (8 lanes a row were twice as
// slow as a warp on K2's rows, their rounds most of it).  Bound: the
// candidates it reads, a small fraction of the dense spectra, so its time
// is load latency and launch.  It is launched as a programmatic dependent
// of K1 / K2 (Hopper's PDL): its blocks may start while the producer's
// last blocks run and wait in griddepcontrol.wait until the producer's
// lists are complete.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "peak_merge.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- peak_topm ------------------------------------------------------------

constexpr int kWarps = 8;                 // warps a block, a row each
constexpr int kThreads = 32 * kWarps;

// Candidates in order: a larger order key first, then the lower bin.  The
// key maps an f32 to a u32 of the same order (-0 taken as +0, which
// compares equal to it); -inf, never a candidate, is the empty key.
__device__ __forceinline__ unsigned order_key(float v) {
    const unsigned u = __float_as_uint(v + 0.0f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
constexpr unsigned kEmptyKey = 0x007fffffu;    // order_key(-inf)
constexpr unsigned kInfKey = 0xff800000u;      // order_key(+inf): no slot
constexpr int kNoBin = 0x7fffffff;

// One segment of a row in a lane's registers: kW consecutive bins per 32
// kW (chunk c, element e: bin seg0 + 32 kW c + kW lane + e), and the bins
// just before and after the segment (cyclic: K-1 before the row's first,
// 0 after its last).
template <int kW, int kSeg>
struct Seg {
    float x[kSeg / 32 / kW][kW];
    float before, after;
};

template <int kW, int kSeg>
__device__ __forceinline__ void load_seg(Seg<kW, kSeg>& s, const float* w,
                                         int k, int seg0, int lane) {
    constexpr int kC = kSeg / 32 / kW;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
        const int b = seg0 + 32 * kW * c + kW * lane;
        if constexpr (kW == 4) {
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (b < k) v = __ldg(reinterpret_cast<const float4*>(w + b));
            s.x[c][0] = v.x;
            s.x[c][1] = v.y;
            s.x[c][2] = v.z;
            s.x[c][3] = v.w;
        } else {
            s.x[c][0] = b < k ? __ldg(w + b) : 0.0f;
        }
    }
    s.before = __ldg(w + (seg0 == 0 ? k - 1 : seg0 - 1));
    s.after = __ldg(w + (seg0 + kSeg < k ? seg0 + kSeg : 0));
}

// The row's last segment where K ends inside it: bins past K take bin 0's
// value (s.after), so bin K-1 meets bin 0 on its right and no bin past K
// is a strict maximum (it has a neighbour of its own value).
template <int kW, int kSeg>
__device__ __forceinline__ void pad_tail(Seg<kW, kSeg>& s, int seg0, int k,
                                         int lane) {
#pragma unroll
    for (int c = 0; c < kSeg / 32 / kW; ++c)
#pragma unroll
        for (int e = 0; e < kW; ++e)
            if (seg0 + 32 * kW * c + kW * lane + e >= k) s.x[c][e] = s.after;
}

// Insert (key, bin) into a lane's sorted list if it ranks above the last.
template <int kList>
__device__ __forceinline__ void insert(unsigned (&lk)[kList],
                                       int (&lb)[kList], unsigned key,
                                       int bin) {
    if (!(key > lk[kList - 1] || (key == lk[kList - 1] &&
                                  bin < lb[kList - 1])))
        return;
#pragma unroll
    for (int s = 0; s < kList; ++s) {
        if (key > lk[s] || (key == lk[s] && bin < lb[s])) {
            const unsigned tk = lk[s];
            const int tb = lb[s];
            lk[s] = key;
            lb[s] = bin;
            key = tk;
            bin = tb;
        }
    }
}

template <int kList>
__device__ __forceinline__ void clear(unsigned (&lk)[kList],
                                      int (&lb)[kList]) {
#pragma unroll
    for (int s = 0; s < kList; ++s) {
        lk[s] = kEmptyKey;
        lb[s] = kNoBin;
    }
}

// The peaks of one segment into the lane's list: the tests of every bin
// into a mask (every lane runs every shuffle: full-mask exchanges), then
// one insertion a set bit (rare: a row of noise holds one or two).
template <int kW, int kSeg, int kList>
__device__ __forceinline__ void scan_seg(const Seg<kW, kSeg>& s, int seg0,
                                         float thr, int lane,
                                         unsigned (&lk)[kList],
                                         int (&lb)[kList]) {
    constexpr int kC = kSeg / 32 / kW;
    const int up_src = (lane + 31) & 31, dn_src = (lane + 1) & 31;
    float up_prev = s.before;             // lane 0's left of chunk 0
    float dn = __shfl_sync(kFull, s.x[0][0], dn_src);
    unsigned found = 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
        // Lane 0 gets lane 31's last bin of this chunk: its left in the
        // next; lane 31 gets lane 0's first bin of the next chunk.
        const float up = __shfl_sync(kFull, s.x[c][kW - 1], up_src);
        const float dn_next =
            c + 1 < kC ? __shfl_sync(kFull, s.x[c + 1][0], dn_src) : s.after;
        const float left0 = lane ? up : up_prev;
        const float right_last = lane < 31 ? dn : dn_next;
        up_prev = up;
        dn = dn_next;
#pragma unroll
        for (int e = 0; e < kW; ++e) {
            const float x = s.x[c][e];
            const float l = e ? s.x[c][e - 1] : left0;
            const float r = e + 1 < kW ? s.x[c][e + 1] : right_last;
            if (x > thr && x > l && x > r) found |= 1u << (c * kW + e);
        }
    }
    while (found) {
        const int j = __ffs(found) - 1;
        found &= found - 1;
        float x = 0.0f;
#pragma unroll
        for (int i = 0; i < kC * kW; ++i)     // constant indices only
            if (i == j) x = s.x[i / kW][i % kW];
        insert(lk, lb, order_key(x), seg0 + 32 * kW * (j / kW) + kW * lane +
                                         j % kW);
    }
}

// kRefill: the lane's best kList candidates of the row that rank below
// (after_key, after_bin), from device memory (one lane alone, rarely: it
// had more than kList of the row's top M).  Returns whether its bins may
// hold more (the list came back full).
template <int kW, int kSeg, int kList>
__device__ __forceinline__ bool rescan(const float* w, int k, float thr,
                                       int lane, unsigned after_key,
                                       int after_bin, unsigned (&lk)[kList],
                                       int (&lb)[kList]) {
    clear(lk, lb);
    for (int seg0 = 0; seg0 < k; seg0 += kSeg) {
        for (int c = 0; c < kSeg / 32 / kW; ++c) {
            for (int e = 0; e < kW; ++e) {
                const int bin = seg0 + 32 * kW * c + kW * lane + e;
                if (bin >= k) continue;
                const float x = w[bin];
                if (!(x > thr && x > w[bin ? bin - 1 : k - 1] &&
                      x > w[bin + 1 < k ? bin + 1 : 0]))
                    continue;
                const unsigned key = order_key(x);
                if (key < after_key || (key == after_key && bin > after_bin))
                    insert(lk, lb, key, bin);
            }
        }
    }
    return lk[kList - 1] != kEmptyKey;
}

// A lane's slot of a finished row, its heights' gathers in flight: written
// after the next segment's search, which hides their latency.
struct Pending {
    long long o = -1;                     // output index; -1: none
    int bin = 0;
    float h = 0.0f, hs = 0.0f;
    bool ok = false;
};

__device__ __forceinline__ void flush(Pending& p, int* bins, float* h,
                                      float* h_single, uint8_t* valid) {
    if (p.o < 0) return;
    bins[p.o] = p.ok ? p.bin : 0;
    h[p.o] = p.h;
    h_single[p.o] = p.hs;
    valid[p.o] = p.ok ? 1 : 0;
    p.o = -1;
}

// The row's top M from the lanes' lists: rounds of a warp arg-max, 32
// slots at a time (lane s keeps slot s), stopping at the first empty one.
// The last 32 slots' gathers go out together into `pend`; earlier ones
// (M > 32) and the empty rest are written here.
template <int kW, int kSeg, int kList, bool kRefill>
__device__ __forceinline__ void emit(long long row, const float* w,
                                     const float* fa, const float* hs,
                                     int* bins, float* h, float* h_single,
                                     uint8_t* valid, int k, int m,
                                     float thr, int lane,
                                     unsigned (&lk)[kList],
                                     int (&lb)[kList], Pending& pend) {
    [[maybe_unused]] bool more = lk[kList - 1] != kEmptyKey;
    int slot = 0;
    for (;;) {
        const int n = m - slot < 32 ? m - slot : 32;
        int mine = 0, filled = 0;
        bool ok = false, done = false;
        for (; filled < n; ++filled) {
            const unsigned kmax = __reduce_max_sync(kFull, lk[0]);
            if (kmax == kEmptyKey) {      // the same in every lane
                done = true;
                break;
            }
            const unsigned bmin = __reduce_min_sync(
                kFull, lk[0] == kmax ? (unsigned)lb[0] : 0xffffffffu);
            if (lane == filled) {
                mine = (int)bmin;
                ok = kmax != kInfKey;     // peaks_plain: valid = finite
            }
            if (lk[0] == kmax && (unsigned)lb[0] == bmin) {
                // Only the owner holds this bin: pop its head.
#pragma unroll
                for (int s = 0; s + 1 < kList; ++s) {
                    lk[s] = lk[s + 1];
                    lb[s] = lb[s + 1];
                }
                lk[kList - 1] = kEmptyKey;
                lb[kList - 1] = kNoBin;
                if constexpr (kRefill)
                    if (lk[0] == kEmptyKey && more && slot + filled + 1 < m)
                        more = rescan<kW, kSeg>(w, k, thr, lane, kmax,
                                                (int)bmin, lk, lb);
            }
        }
        const bool last = done || slot + n >= m;
        if (lane < n) {
            Pending p;
            p.o = row * m + slot + lane;
            p.ok = lane < filled && ok;
            p.bin = mine;
            if (p.ok) {
                p.h = __ldg(fa + row * k + mine);
                p.hs = __ldg(hs + row * k + mine);
            }
            if (last)
                pend = p;
            else
                flush(p, bins, h, h_single, valid);
        }
        slot += n;
        if (last) break;
    }
    for (int s = slot + lane; s < m; s += 32) {
        const long long o = row * m + s;
        bins[o] = 0;
        h[o] = 0.0f;
        h_single[o] = 0.0f;
        valid[o] = 0;
    }
}

template <int kW, int kList, bool kRefill>
__global__ void __launch_bounds__(kThreads, 2)
peak_topm_kernel(const float* __restrict__ faw, const float* __restrict__ fa,
                 const float* __restrict__ hs, int* __restrict__ bins,
                 float* __restrict__ h, float* __restrict__ h_single,
                 uint8_t* __restrict__ valid, long long rows, int k, int m,
                 float thr) {
    // Bins a segment (32 a lane; 16 beside a list of 16, 8 beside the
    // rescan): the register double buffer and the list keep within 128
    // registers, with no stack frame.
    constexpr int kSeg = kList == 8 ? 1024 : kRefill ? 256 : 512;
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * kWarps;
    long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
    if (row >= rows) return;              // the whole warp
    const int nseg = (k + kSeg - 1) / kSeg;
    int seg = 0;
    unsigned lk[kList];
    int lb[kList];
    clear(lk, lb);
    Pending pend;
    Seg<kW, kSeg> a, b;
    load_seg(a, faw + row * k, k, 0, lane);
    // Search `cur` with the warp's next segment loading into `nxt`; the
    // two buffers swap roles, so no register waits on a load it does not
    // read.
    auto step = [&](Seg<kW, kSeg>& cur, Seg<kW, kSeg>& nxt) {
        long long next_row = row;
        int next_seg = seg + 1;
        if (next_seg == nseg) {
            next_row += stride;
            next_seg = 0;
        }
        if (next_row < rows)
            load_seg(nxt, faw + next_row * k, k, next_seg * kSeg, lane);
        if ((seg + 1) * kSeg > k) pad_tail(cur, seg * kSeg, k, lane);
        scan_seg(cur, seg * kSeg, thr, lane, lk, lb);
        flush(pend, bins, h, h_single, valid);
        if (seg == nseg - 1) {
            emit<kW, kSeg, kList, kRefill>(row, faw + row * k, fa, hs, bins,
                                           h, h_single, valid, k, m, thr,
                                           lane, lk, lb, pend);
            clear(lk, lb);
        }
        row = next_row;
        seg = next_seg;
        return row < rows;
    };
    while (step(a, b) && step(b, a)) {
    }
    flush(pend, bins, h, h_single, valid);
}

// Launch `kernel` on `stream`; with `after_producer` as a programmatic
// dependent of the kernel before it on the stream (it must call
// hopper::grid_dependency_wait before reading what that one wrote).
template <class... P, class... A>
int launch(void (*kernel)(P...), unsigned blocks, unsigned threads,
           cudaStream_t stream, bool after_producer, A... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = after_producer ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ---- the merge ------------------------------------------------------------

constexpr int kMergeThreads = 64;

__device__ __forceinline__ peaks::Cand load_cand(const peaks::Cand* p) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(p));
    return {__int_as_float(r.x), r.y, __int_as_float(r.z),
            __int_as_float(r.w)};
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
__global__ void __launch_bounds__(kMergeThreads)
peak_merge_kernel(const peaks::Cand* __restrict__ lists, int nlists,
                  const peaks::Cand* __restrict__ pairs, int npairs,
                  long long rows, int m, int* __restrict__ bins,
                  float* __restrict__ h, float* __restrict__ h_single,
                  uint8_t* __restrict__ valid) {
    const int lane = threadIdx.x % kLanes;
    const long long row = (long long)blockIdx.x * (kMergeThreads / kLanes) +
                          threadIdx.x / kLanes;
    if (row >= rows) return;                // the whole group leaves
    const unsigned group =
        kLanes == 32 ? kFull
                     : ((1u << kLanes) - 1) << (threadIdx.x % 32 / kLanes *
                                                kLanes);
    const peaks::Cand none = {-INFINITY, kNoBin, 0.0f, 0.0f};
    peaks::Cand list[kCap];
#pragma unroll
    for (int s = 0; s < kCap; ++s) list[s] = none;
    // The producer's lists are complete only when its grid has ended.
    hopper::grid_dependency_wait();
    // kBatch list heads and kBatch pairs a lane at a time, every one a
    // 16-byte load issued before the first insertion; the rest of a list
    // only behind a peak, four entries at a time.  A group of 8 takes four
    // of each at a time (two beside a list of 16, within 128 registers); a
    // warp one (72 registers with a list of 8, so more of its rows fit the
    // SMs at once: on K1's SF9 and K2's rows it beat two or four).
    constexpr int kBatch = kLanes == 32 ? 1 : kCap == 8 ? 4 : 2;
    const int per = (nlists > npairs ? nlists : npairs);
    for (int i0 = lane; i0 < per; i0 += kLanes * kBatch) {
        peaks::Cand head[kBatch], a[kBatch], b[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int i = i0 + u * kLanes;
            head[u] = i < nlists ? load_cand(lists + (row * nlists + i) * m)
                                 : none;
            a[u] = b[u] = none;
            if (i < npairs) {
                a[u] = load_cand(pairs + (row * npairs + i) * 2);
                b[u] = load_cand(pairs + (row * npairs + i) * 2 + 1);
            }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            if (a[u].b >= 0 && a[u].v > b[u].v) push(list, m, a[u]);
            if (b[u].b >= 0 && b[u].v > a[u].v) push(list, m, b[u]);
            if (head[u].v == -INFINITY) continue;     // an empty list
            push(list, m, head[u]);
            const peaks::Cand* src =
                lists + (row * nlists + i0 + u * kLanes) * m;
            bool end = false;
#pragma unroll
            for (int s0 = 1; s0 < kCap && !end; s0 += 4) {
                peaks::Cand rest[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    rest[j] = s0 + j < m ? load_cand(src + s0 + j) : none;
#pragma unroll
                for (int j = 0; j < 4 && !end; ++j) {
                    end = rest[j].v == -INFINITY;     // the list's end
                    if (!end) push(list, m, rest[j]);
                }
            }
        }
    }
    if constexpr (kLanes == 32) {
        // A warp a row: rounds of a redux arg-max (the largest order key,
        // then the least bin holding it), lane s keeping slot s and the
        // winner's heights from its owner, one store a slot at the end.
        int mine = 0;
        float mh = 0.0f, mhs = 0.0f;
        bool ok = false;
        for (int slot = 0; slot < m; ++slot) {
            const unsigned key = order_key(list[0].v);
            const unsigned kmax = __reduce_max_sync(kFull, key);
            if (kmax == kEmptyKey) break;   // the same in every lane
            const unsigned bmin = __reduce_min_sync(
                kFull, key == kmax ? (unsigned)list[0].b : 0xffffffffu);
            const bool own = key == kmax && (unsigned)list[0].b == bmin;
            const int src = __ffs(__ballot_sync(kFull, own)) - 1;
            const float wh = __shfl_sync(kFull, list[0].h, src);
            const float whs = __shfl_sync(kFull, list[0].hs, src);
            if (lane == slot) {
                ok = kmax != kInfKey;       // merge_peaks: valid = finite
                mine = ok ? (int)bmin : 0;
                mh = ok ? wh : 0.0f;
                mhs = ok ? whs : 0.0f;
            }
            if (own) {
#pragma unroll
                for (int s = 0; s + 1 < kCap; ++s) list[s] = list[s + 1];
                list[kCap - 1] = none;
            }
        }
        if (lane < m) {
            const long long o = row * m + lane;
            bins[o] = mine;
            h[o] = mh;
            h_single[o] = mhs;
            valid[o] = ok ? 1 : 0;
        }
        return;
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
            const bool ok = v != INFINITY;  // merge_peaks: valid = finite
            bins[o] = ok ? b : 0;
            h[o] = ok ? list[0].h : 0.0f;
            h_single[o] = ok ? list[0].hs : 0.0f;
            valid[o] = ok ? 1 : 0;
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
    const long long per_block = kMergeThreads / kLanes;
    const long long blocks = (rows + per_block - 1) / per_block;
    return launch(peak_merge_kernel<kCap, kLanes>, (unsigned)blocks,
                  kMergeThreads, stream, true, lists, nlists, pairs, npairs,
                  rows, m, bins, h, h_single, valid);
}

}  // namespace

// A row of up to 32 lists and pairs takes 8 lanes (eight rows a block), a
// longer one a warp (two rows a block); M <= 8 keeps a list of 8 a lane,
// else of 16.  The merge runs as a programmatic dependent of the producer
// before it on the stream.
int peaks::launch_merge(const Cand* lists, int nlists, const Cand* pairs,
                        int npairs, long long rows, int m, int* bins,
                        float* h, float* h_single, uint8_t* valid,
                        cudaStream_t stream) {
    if (rows <= 0) return 0;
    if (m < 1 || m > kMaxM || nlists < 1 || npairs < 0 ||
        (npairs > 0 && pairs == nullptr))
        return cudaErrorInvalidValue;
    const bool wide = nlists + npairs > 32;
    auto* fn = m <= 8 ? (wide ? launch_merge_as<8, 32> : launch_merge_as<8, 8>)
                      : (wide ? launch_merge_as<kMaxM, 32>
                              : launch_merge_as<kMaxM, 8>);
    return fn(lists, nlists, pairs, npairs, rows, m, bins, h, h_single, valid,
              stream);
}

// A warp a row, persistent: two blocks of eight warps an SM.  Rows whose
// K is a multiple of 4 (and whose base is 16-byte aligned) load float4s;
// M <= 8 keeps 8 candidates a lane, M <= 16 16, a larger M 16 with the
// rescan.
extern "C" int grl_peak_topm(const float* faw, const float* fa,
                             const float* hs, int* bins, float* h,
                             float* h_single, uint8_t* valid, long long rows,
                             int k, int m, float threshold, void* stream) {
    if (rows <= 0) return 0;
    if (m < 1 || m > k || k < 3) return cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    const long long want = (rows + kWarps - 1) / kWarps;
    const unsigned blocks = (unsigned)(want < 2LL * sms ? want : 2LL * sms);
    const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(faw) % 16 == 0;
    auto* fn = vec ? (m <= 8    ? peak_topm_kernel<4, 8, false>
                      : m <= 16 ? peak_topm_kernel<4, 16, false>
                                : peak_topm_kernel<4, 16, true>)
                   : (m <= 8    ? peak_topm_kernel<1, 8, false>
                      : m <= 16 ? peak_topm_kernel<1, 16, false>
                                : peak_topm_kernel<1, 16, true>);
    return launch(fn, blocks, kThreads, (cudaStream_t)stream, false, faw, fa,
                  hs, bins, h, h_single, valid, rows, k, m, threshold);
}
