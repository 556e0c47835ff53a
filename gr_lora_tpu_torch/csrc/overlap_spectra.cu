// Overlap-decomposed pyramid spectra: the fa / faw / hs folds of every hop
// from the chunk spectra G, for large SF at the collision zoom.
//
// Replaces gr_lora_tpu/ops/pallas_overlap.py `make_overlap_spectra` /
// `_kernel` (K5, whole; the chunk DFT stays outside, as there) and
// gr_lora_tpu/ops/pallas_peaks.py `make_overlap_peaks` / `_kernel` (K2,
// with peak_topm.cu's merge).  With hop h = N/8, F = fft_factor * N, per
// hop b:
//
//   X_b[c]  = sum_{j<8} rho_j[c] * G[b + j, (c - sigma_j) mod F]
//   Xw_b[c] = sum_q tap_q * X_b[(c - shift_q) mod F]      (~15 taps)
//   fa = |X(c)| + |X(c+F-K)|, hs = max of the two, faw = |Xw(c)| + |Xw(c+F-K)|
//
// all in f32 (bf16 G leaves spurious above-threshold peaks,
// pallas_peaks.py:272-275).  The hi fold side is c + F - K for every p
// (the TPU view arithmetic assumes F = 2K).
//
// The sheared walk.  sigma_j = j sigma_1 (mod F), so with e = c + sigma_1 b
// and G'[r, e] = G[r, (e - sigma_1 r) mod F], X_b at bin c is the sum of 8
// consecutive rows of G' down the fixed column e.  rho_j[c] is periodic in
// c with period P = 8 fft_factor and sigma_1 is a multiple of P, so down a
// column rho is constant: the kernel and its plain version
// (ops/overlap_dft.spectra_from_chunks) both take rho from one period,
// `rho_period` [8, P] (the f32 table is periodic only to ~1e-12, so the
// full table would not be constant down a column).  A block owns a band of
// kBand columns e (both fold sides, e and e + F - K) for a run of hops: it
// keeps the G' rows of its band plus the window's halo in a ring of
// shared memory, walks the hops in pairs (rows b .. b + 8 give X_b and
// X_b+1; each window tap is read once for both), brings in the next rows
// with cp.async while a pair is computed, and so reads each G element from
// device memory once (times 1 + 2 halo / kBand) instead of 8 times.  For
// a fixed hop the shift between c and e is constant, so the window is a
// convolution along e inside the tile.  Each column of the band yields an output at p = 2
// (F - K = K: a column whose bin falls in [K, 2K) is the hi side of bin
// c - K, whose lo side is the partner column); at p != 2 only columns whose
// bin falls in [0, K) are written (a waste of loads, not a wrong answer).
//
// Every product and sum is rounded on its own (the _rn intrinsics are never
// contracted into FMAs) and taken in the plain version's order (j
// ascending, taps ascending), so the kernel's folds equal the plain
// version's on the card bit for bit, and so do the peaks.  Bound on the
// card: instruction throughput, not device memory (G is read once) — the
// separately rounded f32 operations of every output (no FMA may fuse them),
// plus the window's shared-memory loads (one X value a tap and side) and
// their addresses.  kSlots, kStride and the 16 zero-padded taps are compile-time
// so that every ring and window load has a constant offset.  A side's
// columns (band + 2 halo) are padded to kStride = 128 kCols: 384 (kCols 3)
// up to fft_factor 8, where the halo is 56 bins (73 728 B of shared memory,
// 3 blocks an SM); 512 (kCols 4) at fft_factor 16, where it is 112 (98 304
// B, 2 blocks an SM).
//
// K2 is the peak instance of the same walk (Mode): it writes no folds.
// After the window it keeps faw of its band's columns in shared memory, and
// each column tests its neighbour columns there: at p = 2 columns e - 1 and
// e + 1 hold bins c - 1 and c + 1 mod K, the fold's wrap included.  A
// band's peaks of a hop (at most 128) are gathered by column, ranked by
// value and bin, and the best M written as that band's list.  At p = 2 a
// band's first and last columns have their outer neighbours in the next
// bands, so they go to the merge as deferred pairs.  Computing those two
// neighbours' windows in the block instead (one or two threads doing a
// whole window while the block waits at the barrier) doubled K2's time on
// the H100, 0.85 to 1.69 ms at SF10.  At p != 2 the cyclic neighbours of bins 0 and
// K - 1 are no adjacent columns: those two are deferred, and the band's
// edge columns see the two beyond it through a halo one column wider (58
// at ff 8, 372 of 384 columns; 114 at ff 16, 484 of 512), computed so.
// The peak instances add 2 328 B of shared memory (3 blocks an SM still
// fit at ff 8) and two barriers a pair of hops; no [lanes, hops, K] array
// is written, and K5's instance is unchanged.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "peak_merge.cuh"

namespace {

constexpr int kBand = 256;        // columns e a block owns (one a thread)
constexpr int kThreads = kBand;
constexpr int kR = 8;             // PYRAMID_OVERLAP_FACTOR
constexpr int kSlots = 10;        // ring rows: the 9 in use, 1 in flight
constexpr int kTaps = 16;         // window taps at most (15 at beta 25)
constexpr int kTargetBlocks = 2048;   // hop runs: about this many blocks
static_assert(kBand % 2 == 0, "the band is copied in pairs of bins");

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                       __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float cmag(float2 a) {
    return sqrtf(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)));
}

__device__ __forceinline__ int mod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

// A side's columns, padded, for kCols X columns a thread (both sides).
template <int kCols>
__host__ __device__ constexpr int stride_of() { return kCols * kThreads / 2; }

// Window tap q at column pointer `col`, both hops of a pair (X rows
// 2 kStride apart) and both sides (kStride apart): xw += tap * X[-sq].
template <int kStride>
__device__ __forceinline__ void window_tap(float2 (&xw)[2][2],
                                           const float2* col, float4 ts,
                                           bool first) {
    const float2 tap = make_float2(ts.x, ts.y);
    const float2* x = col - __float_as_int(ts.z);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int side = 0; side < 2; ++side) {
            const float2 term = cmul(x[(2 * h + side) * kStride], tap);
            xw[h][side] = first ? term : cadd(xw[h][side], term);
        }
}

// The walk's instances: K5 writes the folds; K2 searches each band for
// peaks and defers the bins whose neighbour it cannot see to the merge: at
// p = 2 (kBandPairs) each band's first and last column, whose neighbours are
// the next bands' edge columns; at p != 2 (kHaloEdges) bins 0 and K - 1,
// whose neighbours across the wrap are no adjacent columns, while the
// band's edge columns see the two columns beyond it through a halo one
// column wider.
enum Mode { kSpectra, kBandPairs, kHaloEdges };

// Where a launch writes: K5 the folds [lanes, hops, K] each; K2 the
// candidates of each hop and band [lanes * hops, bands, m] and the
// deferred pairs [lanes * hops, bands, 2] (kBandPairs: pair i is band i's
// last column and band i + 1's first, cyclically) or [lanes * hops, 1, 2]
// (kHaloEdges: bins 0 and K - 1) (peak_merge.cuh).
struct Out {
    float* fa;
    float* faw;
    float* hs;
    peaks::Cand* lists;
    peaks::Cand* pairs;
    int m;
    float threshold;
};

// K2's shared memory behind the ring and the X rows: faw of the band's
// columns (kHaloEdges: and of the one beyond each end) at both hops of a
// pair, and each hop's peak columns.
struct PeakSmem {
    float fw[2][kBand + 2];
    int count[2];
    unsigned char col[2][kBand / 2];    // strict maxima: at most every other
};

// fa and hs of the column at `xh` (its two sides kStride apart).
template <int kStride>
__device__ __forceinline__ void fold_at(const float2* xh, float& fa,
                                        float& hs) {
    const float m0 = cmag(xh[0]), m1 = cmag(xh[kStride]);
    fa = __fadd_rn(m0, m1);
    hs = fmaxf(m0, m1);
}

// K2, after the window of hops b and b + 1: faw of every column of the
// band (kHaloEdges: and of the two beyond it, the wider halo's first), then
// each column's peak test against its neighbour columns; a band's peaks of
// a hop go to its list in rank order (value, then bin), the best M, and an
// end entry behind them.  The deferred bins (see Mode) go to the pairs with
// their bin where they beat the threshold and their neighbour inside the
// band, else -1.  `c` holds this column's bins; the bins of a band's
// columns ascend by one a column, modulo K (p = 2, the fold) or F.  Every
// thread of the block calls this (two barriers).
template <int kStride, int kMode>
__device__ __forceinline__ void peak_step(
    PeakSmem& ps, const Out& out, const float2 (&xw)[2][2],
    const float2* col, const float4* tap_s, int ntaps, const bool (&emit)[2],
    const int (&c)[2], int b, int b1, long long lane, int hops, int f,
    int k) {
    constexpr int o = kMode == kHaloEdges;       // column t at fw[t + o]
    const int t = threadIdx.x;
#pragma unroll
    for (int h = 0; h < 2; ++h)
        ps.fw[h][t + o] = __fadd_rn(cmag(xw[h][0]), cmag(xw[h][1]));
    if (kMode == kHaloEdges && (t == 0 || t == kThreads - 1)) {
        const float2* ce = col + (t == 0 ? -1 : 1);
        float2 xe[2][2];
#pragma unroll
        for (int q = 0; q < kTaps - 1; ++q)
            window_tap<kStride>(xe, ce, tap_s[q], q == 0);
        if (ntaps == kTaps)
            window_tap<kStride>(xe, ce, tap_s[kTaps - 1], false);
#pragma unroll
        for (int h = 0; h < 2; ++h)
            ps.fw[h][t == 0 ? 0 : kBand + 1] =
                __fadd_rn(cmag(xe[h][0]), cmag(xe[h][1]));
    }
    __syncthreads();
    const int span = f == 2 * k ? k : f;         // bins of the columns mod
    const int last = min(kBand, span - (int)blockIdx.x * kBand) - 1;
    bool cand[2];
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        v[h] = ps.fw[h][t + o];
        const float l = ps.fw[h][max(t + o - 1, 0)];
        const float r = ps.fw[h][min(t + o + 1, kBand + 1)];
        int pair, end;
        if (kMode == kBandPairs) {
            end = t == 0 ? 1 : 0;
            pair = t == 0 ? (blockIdx.x + gridDim.x - 1) % gridDim.x
                          : blockIdx.x;
        } else {
            end = c[h] != 0;
            pair = 0;
        }
        const bool edge = kMode == kBandPairs
                              ? t == 0 || t == last
                              : c[h] == 0 || c[h] == k - 1;
        cand[h] = emit[h] && !edge && v[h] > out.threshold && v[h] > l &&
                  v[h] > r;
        if (emit[h] && edge) {
            // The neighbour inside the band: right of a first column (of
            // bin 0), left of a last one (of bin K - 1).
            const float inner =
                (kMode == kBandPairs ? t == 0 : c[h] == 0) ? r : l;
            peaks::Cand e;
            e.v = v[h];
            e.b = v[h] > out.threshold && v[h] > inner ? c[h] : -1;
            fold_at<kStride>(col + h * 2 * kStride, e.h, e.hs);
            const int np = kMode == kBandPairs ? gridDim.x : 1;
            out.pairs[((lane * hops + b + h) * np + pair) * 2 + end] = e;
        }
        if (cand[h]) ps.col[h][atomicAdd(&ps.count[h], 1)] = (unsigned char)t;
    }
    const bool any = __syncthreads_or(cand[0] || cand[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (b + h >= b1) continue;
        const int n = ps.count[h];
        peaks::Cand* list =
            out.lists +
            ((lane * hops + b + h) * gridDim.x + blockIdx.x) * out.m;
        if (any && cand[h]) {
            int rank = 0;
            for (int i = 0; i < n; ++i) {
                const int u = ps.col[h][i];
                const float vu = ps.fw[h][u + o];
                int bu = (c[h] + u - t) % span;
                if (bu < 0) bu += span;
                if (vu > v[h] || (vu == v[h] && bu < c[h])) ++rank;
            }
            if (rank < out.m) {
                peaks::Cand e;
                e.v = v[h];
                e.b = c[h];
                fold_at<kStride>(col + h * 2 * kStride, e.h, e.hs);
                list[rank] = e;
            }
        }
        if (t == 0 && n < out.m) {
            const peaks::Cand end = {-INFINITY, 0x7fffffff, 0.0f, 0.0f};
            list[n] = end;
        }
    }
}

template <int kCols, int kMode>
__global__ void __launch_bounds__(kThreads, kCols == 3 ? 3 : 2)
overlap_spectra_kernel(const float2* __restrict__ g,
                       const float2* __restrict__ rho_period,
                       const int* __restrict__ shifts,
                       const float2* __restrict__ taps, Out out, int rows_g,
                       int hops, int f, int k, int s1, int period, int ntaps,
                       int hp, int run) {
    constexpr bool kPeaks = kMode != kSpectra;
    constexpr int kStride = stride_of<kCols>();
    extern __shared__ __align__(16) unsigned char smem[];
    // A side's columns: band + 2 halo, padded to kStride (a multiple of P,
    // so that a column's rho index is the same on both sides and every 256
    // columns).
    const int width = kBand + 2 * hp;
    float2* ring = reinterpret_cast<float2*>(smem);     // [kSlots][2][kStride]
    float2* xs = ring + kSlots * 2 * kStride;           // [2][2][kStride]
    PeakSmem& ps = *reinterpret_cast<PeakSmem*>(xs + 2 * 2 * kStride);
    // Tap q: (re, im, shift, 0), zero-padded to kTaps.
    __shared__ float4 tap_s[kTaps];

    const int off = f - k;                     // the hi side's column offset
    const int span = f == 2 * k ? k : f;       // columns e the bands cover
    const int e0 = blockIdx.x * kBand;
    const int b0 = blockIdx.y * run;
    const int b1 = min(hops, b0 + run);
    const long long lane = blockIdx.z;
    const float2* gl = g + lane * rows_g * (long long)f;
    const int t = threadIdx.x;

    // Taps past ntaps are 0 with shift 0: they add products of +-0, which
    // leave every sum as it is (up to the sign of a zero, which no
    // magnitude sees).
    if (t < kTaps) {
        const float2 tap = t < ntaps ? taps[t] : make_float2(0.0f, 0.0f);
        const int sq = t < ntaps ? shifts[t] : 0;
        tap_s[t] = make_float4(tap.x, tap.y, __int_as_float(sq), 0.0f);
    }
    // This thread's X columns u = t + 256 m of the flattened [2][kStride]
    // (a padding column's X is computed and never read).  rho down all of
    // them is one period index for every hop.
    float2 rho[kR];
    const int ri = mod(t - hp, period);
#pragma unroll
    for (int j = 0; j < kR; ++j) rho[j] = rho_period[j * period + ri];

    // The row copies: this thread's 16-byte chunks q = t + 256 i of the
    // 2 x width/2 chunks a row, each at a fixed side and column u; a row r
    // starts at bin base_side(r) = e0 - hp + side (F - K) - sigma_1 r
    // (mod F), stepped down by sigma_1 from row to row.
    const int half = width / 2;
    int csrc[2], cdst[2];
    bool cgo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int q = t + i * kThreads;
        const int side = q >= half;
        cgo[i] = q < 2 * half;
        csrc[i] = 2 * (q - side * half) + side * off;   // bin past e0 - hp
        cdst[i] = side * kStride + 2 * (q - side * half);
    }
    const int s1b0 = (int)(((long long)s1 * b0) % f);
    int base = mod(e0 - hp - s1b0, f);         // of row r, side 0 (+ off)
    const int last = b1 + kR - 1;              // rows b0 .. last - 1
    auto load_row = [&](int r) {
        if (r < last) {
            float2* slot = ring + (r % kSlots) * 2 * kStride;
            const float2* row = gl + (long long)r * f;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (!cgo[i]) continue;
                int col = base + csrc[i];
                if (col >= f) col = width + off <= f ? col - f : col % f;
                hopper::cp_async16(slot + cdst[i], row + col);
            }
        }
        hopper::cp_async_commit();
        base -= s1;
        if (base < 0) base += f;
    };
    for (int r = b0; r < b0 + kSlots; ++r) load_row(r);
    // Bin of column e0 at hop b: c0 = e0 - sigma_1 b (mod F).
    int c0 = mod(e0 - s1b0, f);

    // Hops in pairs (b, b + 1): rows b .. b + 8 give both X, each tap of
    // the window is read once for both.
    for (int b = b0; b < b1; b += 2) {
        hopper::cp_async_wait<kSlots - kR - 1>();   // rows up to b + 8
        __syncthreads();
        // The last pair's ranks are taken: its peak counts start anew.
        if (kPeaks && t == 0) ps.count[0] = ps.count[1] = 0;
        // X_b and X_b+1 down this thread's columns: j ascending, as the
        // plain version sums.
        const float2* row[kR + 1];
#pragma unroll
        for (int j = 0; j <= kR; ++j)
            row[j] = ring + (b + j) % kSlots * 2 * kStride + t;
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
            const int u = m * kThreads;
            const float2 g0 = row[0][u], g1 = row[1][u];
            float2 x0 = cmul(g0, rho[0]);
            float2 x1 = cmul(g1, rho[0]);
            x0 = cadd(x0, cmul(g1, rho[1]));
#pragma unroll
            for (int j = 2; j <= kR; ++j) {
                const float2 gj = row[j][u];
                if (j < kR) x0 = cadd(x0, cmul(gj, rho[j]));
                x1 = cadd(x1, cmul(gj, rho[j - 1]));
            }
            xs[t + u] = x0;
            xs[2 * kStride + t + u] = x1;
        }
        __syncthreads();
        // Rows b and b + 1 are spent: their slots take the next two.
        load_row(b + kSlots);
        load_row(b + 1 + kSlots);

        // Bins of column e0 + t at hops b and b + 1.
        int c[2];
        c[0] = c0 + t;
        c0 -= s1;
        if (c0 < 0) c0 += f;
        c[1] = c0 + t;
        c0 -= s1;
        if (c0 < 0) c0 += f;
        const bool inside = e0 + t < span;
        if (!kPeaks && !inside) continue;
        bool emit[2];
        int lo[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (c[h] >= f) c[h] = f >= kBand ? c[h] - f : c[h] % f;
            lo[h] = c[h] >= k;                 // the hi side of bin c - K
            emit[h] = inside && b + h < b1 && (!lo[h] || f == 2 * k);
            if (lo[h]) c[h] -= k;
        }
        // The window along e, taps ascending, both hops and sides at once.
        const float2* col = xs + hp + t;
        float2 xw[2][2];
#pragma unroll
        for (int q = 0; q < kTaps - 1; ++q)
            window_tap<kStride>(xw, col, tap_s[q], q == 0);
        if (ntaps == kTaps)
            window_tap<kStride>(xw, col, tap_s[kTaps - 1], false);
        if constexpr (!kPeaks) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (!emit[h]) continue;
                const float2* xh = col + h * 2 * kStride;
                const float m0 = cmag(xh[0]), m1 = cmag(xh[kStride]);
                const float w0 = cmag(xw[h][0]), w1 = cmag(xw[h][1]);
                const float mlo = lo[h] ? m1 : m0, mhi = lo[h] ? m0 : m1;
                const float wlo = lo[h] ? w1 : w0, whi = lo[h] ? w0 : w1;
                const long long o = (lane * hops + b + h) * (long long)k +
                                    c[h];
                out.fa[o] = __fadd_rn(mlo, mhi);
                out.hs[o] = fmaxf(mlo, mhi);
                out.faw[o] = __fadd_rn(wlo, whi);
            }
        } else {
            peak_step<kStride, kMode>(ps, out, xw, col, tap_s, ntaps, emit,
                                      c, b, b1, lane, hops, f, k);
        }
    }
    // K2: this block's lists and pairs are stored; the merge may launch
    // (it waits for the grid's end before it reads them).
    if constexpr (kPeaks) hopper::launch_dependents();
    hopper::cp_async_wait<0>();
}

template <int kCols, int kMode>
int launch(const float2* g, const float2* rho_period, const int* shifts,
           const float2* taps, const Out& out, int lanes, int rows_g,
           int hops, int f, int k, int s1, int period, int ntaps, int hp,
           cudaStream_t stream) {
    const int span = f == 2 * k ? k : f;
    const int bands = (span + kBand - 1) / kBand;
    const long long per_run = (long long)bands * lanes;
    const long long runs_want = (kTargetBlocks + per_run - 1) / per_run;
    const int run = (int)((hops + runs_want - 1) / runs_want);
    const int runs = (hops + run - 1) / run;
    const size_t smem =
        (size_t)(kSlots + 2) * 2 * stride_of<kCols>() * sizeof(float2) +
        (kMode != kSpectra ? sizeof(PeakSmem) : 0);
    cudaError_t err = cudaFuncSetAttribute(
        overlap_spectra_kernel<kCols, kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(bands, runs, lanes);
    overlap_spectra_kernel<kCols, kMode><<<grid, kThreads, smem, stream>>>(
        g, rho_period, shifts, taps, out, rows_g, hops, f, k, s1, period,
        ntaps, hp, run);
    return (int)cudaGetLastError();
}

// Checks the geometry and launches the instance for band + 2 hp columns:
// up to 384 the 3-column one, up to 512 the 4-column one.
template <int kMode>
int launch_walk(const float* g, const float* rho_period, const int* shifts,
                const float* taps, const Out& out, int lanes, int rows_g,
                int hops, int f, int k, int sigma1, int period, int ntaps,
                int halo, int hp, void* stream) {
    const int width = kBand + 2 * hp;
    const int cols = width <= stride_of<3>() ? 3 : 4;
    const int stride = cols == 3 ? stride_of<3>() : stride_of<4>();
    if (ntaps < 1 || ntaps > kTaps || halo < 0 || rows_g < hops + kR - 1 ||
        k <= 0 || f % k || f % 2 || period <= 0 || kBand % period ||
        sigma1 % period || (f - k) % period || sigma1 < 0 || sigma1 >= f ||
        stride % period || width > stride)
        return cudaErrorInvalidValue;
    auto* fn = cols == 3 ? launch<3, kMode> : launch<4, kMode>;
    return fn(reinterpret_cast<const float2*>(g),
              reinterpret_cast<const float2*>(rho_period), shifts,
              reinterpret_cast<const float2*>(taps), out, lanes, rows_g,
              hops, f, k, sigma1, period, ntaps, hp,
              (cudaStream_t)stream);
}

}  // namespace

// sigma1 = sigma_1 mod F; halo = the largest |window shift|.  The plan's
// sigma_j must be j sigma1 mod F (the wrapper checks it).  K5's halo is
// rounded up to even (16-byte copies).
extern "C" int grl_overlap_spectra(const float* g, const float* rho_period,
                                   const int* shifts, const float* taps,
                                   float* fa, float* faw, float* hs,
                                   int lanes, int rows_g, int hops, int f,
                                   int k, int sigma1, int period, int ntaps,
                                   int halo, void* stream) {
    if (lanes <= 0 || hops <= 0) return 0;
    const Out out = {fa, faw, hs, nullptr, nullptr, 1, 0.0f};
    return launch_walk<kSpectra>(g, rho_period, shifts, taps, out, lanes,
                              rows_g, hops, f, k, sigma1, period, ntaps,
                              halo, halo + (halo & 1), stream);
}

// K2: the walk's peak instance, then the merge.  lists: [lanes * hops,
// bands, m] (bands = ceil(span / 256)); pairs: [lanes * hops, bands, 2] at
// p = 2, [lanes * hops, 1, 2] else.  At p != 2 the halo is one column
// wider than K5's, for the band's outer neighbours, and even.
extern "C" int grl_overlap_peaks(const float* g, const float* rho_period,
                                 const int* shifts, const float* taps,
                                 void* lists, void* pairs, int* bins,
                                 float* h, float* h_single, uint8_t* valid,
                                 int lanes, int rows_g, int hops, int f,
                                 int k, int sigma1, int period, int ntaps,
                                 int halo, int m, float threshold,
                                 void* stream) {
    if (lanes <= 0 || hops <= 0) return 0;
    if (m < 1 || m > peaks::kMaxM || k < 3 || pairs == nullptr)
        return cudaErrorInvalidValue;
    const Out out = {nullptr, nullptr, nullptr,
                     static_cast<peaks::Cand*>(lists),
                     static_cast<peaks::Cand*>(pairs), m, threshold};
    const bool wrap = f != 2 * k;
    const int span = wrap ? f : k;
    const int bands = (span + kBand - 1) / kBand;
    const int wide = halo + 1;
    const int err =
        wrap ? launch_walk<kHaloEdges>(g, rho_period, shifts, taps, out,
                                       lanes, rows_g, hops, f, k, sigma1,
                                       period, ntaps, halo,
                                       wide + (wide & 1), stream)
             : launch_walk<kBandPairs>(g, rho_period, shifts, taps, out,
                                       lanes, rows_g, hops, f, k, sigma1,
                                       period, ntaps, halo,
                                       halo + (halo & 1), stream);
    if (err) return err;
    return peaks::launch_merge(out.lists, bands, out.pairs, wrap ? 1 : bands,
                               (long long)lanes * hops, m, bins, h, h_single,
                               valid, (cudaStream_t)stream);
}
