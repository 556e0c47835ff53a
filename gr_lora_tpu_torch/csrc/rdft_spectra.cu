// rDFT pyramid spectra: the fa / faw / hs folds of every overlapped hop
// frame, from the raw [T, 2] IQ of each lane, on wgmma + TMA.
//
// Replaces gr_lora_tpu/ops/pallas_rdft.py `make_rdft_spectra` / `_kernel`
// (K3) and `make_rdft_peaks` / `_peaks_kernel` (K1, with peak_topm.cu's
// merge).  Per frame f (samples iq[f*hop .. f*hop + n)):
//
//   u      = iq * downchirp          (f32), and u * kaiser     (f32)
//   [R | I] = bf16(u) @ W,  W = bf16 [n, 2*kp] = [cos | -sin] over bins 0..K
//   |X(c)|  from (Re R - Im I, Im R + Re I);  |X(-c)| from the conjugate pair
//   fa[c]  = |X(c)| + |X(c-K)|,  hs = max of the two,  faw likewise windowed
//
// with |X(c-K)| = |X(-(K-c))| read at column K-c of the SAME positive-band
// product.  Numeric class of the TPU kernel: each product operand is
// rounded once to bf16 after the dechirp (and window), the products
// accumulate in f32; the recombination, magnitudes and folds round each
// operation on its own, as the plain version does.  The TPU kernel's
// lane-reversal matmul does not exist here: column K-c is a column of W.
//
// Bound on the card: tensor-core operations (8 n (K+1) MACs a frame; 0.58
// TFLOP at SF8 x ff 8 on 16 x 2048 frames), beside 12 K bytes of output a
// frame.
//
// Design.  The operand A depends on the depth within the frame (the
// dechirp), so it is no box of the samples.  A pre-pass (rdft_frames_
// kernel) writes it once in bf16 in the row order the fold needs:
// [lanes, tiles, 2 (plain, windowed), 128 rows, npad] (npad = n rounded up
// to 64, zero beyond n), tile t holding frames 64 t .. 64 t + 63, row
// 16 w + 8 i + r the component i (0: ur, 1: ui) of frame 64 t + 8 w + r.
// W is re-laid once (ops/rdft_spectra.tile_weights) in tiles of 32-bin
// pairs, 128 columns each: [cos S1 | -sin S1 | cos S2 | -sin S2], S1 =
// bins b0 .. b0 + 31 and S2 their mirrors K - b0 - j in mirrored order, so
// bin b0 + j and its partner column K - b0 - j land in the same thread;
// tiles b0 = 0, 32, .., K/2 (the last one for bin K/2 alone).  The product
// is the ring of tma_ring.cuh: one producer thread keeps TMA loads of
// 64-deep stages (two A boxes of each of the plain and windowed tiles, two
// 64-column B boxes) in flight through 4 buffers; the two consumer
// warpgroups run wgmma m64n128k16 on the plain rows and on the windowed
// rows over the same B stage, two accumulators of 64 registers.  wgmma's
// accumulator layout then gives each thread rows i and i + 8 (ur and ui of
// one frame) at columns 8 j + 2 (lane % 4) + c: all sixteen values a bin
// pair needs, so the recombination and folds are taken in registers and
// write bins b0 + j and K - b0 - j, both as aligned float2 pairs (the
// mirror side's pairs formed by a shuffle within the quad of lanes that
// holds a frame; stored one by one, the mirror side cost the kernel a
// fifth of its time).  A persistent grid walks (lane, frame tile, pair
// tile) units, frame tile outermost, so the blocks in flight share a few A
// tiles and all of W in L2.
//
// K1 is the peak instance (kPeaks): it stores no folds.  A unit is a
// frame tile and a run of kRun pair tiles (the last run also the bin K/2
// tile), so that 8 lanes x 871 frames at SF8 still make 872 units for 132
// SMs.  Along g = b0 + j a thread's S1 and mirror bins are two chains, g
// and K - g, each ascending in g across the quad (lane q holds g = b0 + 8 t
// + 2 q + c), so K4's row sweep serves both: faw from the accumulators,
// the neighbours by quad shuffles, lane 0 carrying the previous tile's
// last g, lane 3 deferring its last g to the next tile's first.  The
// chains join at g = 0 inside the first unit (bin 0 beside bin K - 1, M's
// g = 1) and at g = K/2 inside the last (bin K/2 between the two chains'
// carried K/2 - 1 and K/2 + 1).  Peaks go to each frame's top-M list in
// shared memory (64 frames x M x 16 B), written at the unit's end; a
// unit's first g (unit > 0) and last g (not the last unit) of each chain
// have their neighbour in the next unit, so they are written as deferred
// edge bins for the merge (peak_merge.cuh).  Candidate bytes a frame at
// SF8, M = 8: 8 lists x 128 B + 7 x 64 B of pairs, 1.5 KB where K3 writes
// 24 KB.  ops/rdft_peaks.unit_candidates is this sweep in plain torch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "peak_merge.cuh"
#include "tma_ring.cuh"

namespace {

using ring::kBk;
using ring::kBox;
using ring::kBoxA;
constexpr int kPair = 32;                    // bins of S1 (and S2) a tile
constexpr int kBn = 4 * kPair;               // 128 W columns a tile
constexpr int kFrames = ring::kBm / 2;       // 64 frames a tile (ur, ui)
constexpr int kRun = 4;                      // K1: pair tiles a unit
constexpr uint32_t kStageA = 2 * kBoxA;      // 16 KB: plain or windowed
constexpr uint32_t kStageB = kBn / 64 * ring::kBoxB;     // 16 KB
constexpr uint32_t kStage = 2 * kStageA + kStageB;       // 48 KB

// Register of the value at column 32 g + 8 t + 2 (lane % 4) + c (g: cos
// S1, -sin S1, cos S2, -sin S2), row i (0: ur, 1: ui): d[4 j + 2 i + c],
// j = 4 g + t.
__host__ __device__ constexpr int reg(int g, int t, int i, int c) {
    return 4 * (4 * g + t) + 2 * i + c;
}

__device__ __forceinline__ float cabs_rn(float re, float im) {
    return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

// |X(b)| and |X(-b)| of the column b that this thread holds at (t, c) of
// S1 (g0 = 0) or S2 (g0 = 2).
__device__ __forceinline__ void mags(const float (&d)[64], int g0, int t,
                                     int c, float& pos, float& neg) {
    const float rre = d[reg(g0, t, 0, c)], rim = d[reg(g0 + 1, t, 0, c)];
    const float ire = d[reg(g0, t, 1, c)], iim = d[reg(g0 + 1, t, 1, c)];
    pos = cabs_rn(__fsub_rn(rre, iim), __fadd_rn(rim, ire));
    neg = cabs_rn(__fadd_rn(rre, iim), __fsub_rn(ire, rim));
}

// The bf16 A tiles [lanes, tiles, 2, 128, npad]; a thread writes two
// depths s, s + 1 of one frame's four rows.
__global__ void rdft_frames_kernel(const float2* __restrict__ iq,
                                   const float* __restrict__ consts,
                                   __nv_bfloat162* __restrict__ a, int lanes,
                                   int t_len, int frames, int n, int npad,
                                   int hop, int ftiles) {
    const int half = npad / 2;
    const long long total = (long long)lanes * ftiles * kFrames * half;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < total; e += (long long)gridDim.x * blockDim.x) {
        const int sp = (int)(e % half);
        const long long rest = e / half;
        const int fl = (int)(rest % kFrames);
        const long long lm = rest / kFrames;         // lane * ftiles + tile
        const long long lane = lm / ftiles;
        const int f = (int)(lm % ftiles) * kFrames + fl;
        float v[4][2];                               // ur, ui, ur w, ui w
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int s = 2 * sp + h;
            float xr = 0.0f, xi = 0.0f, dr = 0.0f, di = 0.0f, wn = 0.0f;
            if (s < n) {
                dr = consts[s];
                di = consts[n + s];
                wn = consts[2 * n + s];
                const long long pos = (long long)f * hop + s;
                if (f < frames && pos < t_len) {
                    const float2 x = iq[lane * t_len + pos];
                    xr = x.x;
                    xi = x.y;
                }
            }
            const float ur = __fsub_rn(__fmul_rn(xr, dr), __fmul_rn(xi, di));
            const float ui = __fadd_rn(__fmul_rn(xr, di), __fmul_rn(xi, dr));
            v[0][h] = ur;
            v[1][h] = ui;
            v[2][h] = __fmul_rn(ur, wn);
            v[3][h] = __fmul_rn(ui, wn);
        }
        const int row = 16 * (fl / 8) + fl % 8;
        __nv_bfloat162* tile = a + lm * 2 * ring::kBm * half;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            // c = 2 p + i: product p (plain, windowed), component i.
            const long long o =
                ((long long)(c >> 1) * ring::kBm + row + 8 * (c & 1)) * half +
                sp;
            tile[o] = __floats2bfloat162_rn(v[c][0], v[c][1]);
        }
    }
}

// Where a launch writes: K3 the folds [lanes, frames, K] each; K1 each
// unit's list a frame [lanes * frames, units, m] and the deferred edge
// bins between units [lanes * frames, 2 (units - 1), 2] (peak_merge.cuh).
struct Out {
    float* fa;
    float* faw;
    float* hs;
    peaks::Cand* lists;
    peaks::Cand* pairs;
    int m;
    float threshold;
    int* bins;              // K1's peaks [lanes * frames, m] (the merge's)
    float* h;
    float* h_single;
    uint8_t* valid;
};

// K3: the folds of pair tile b0 of this thread's frame (row offset o)
// into fa / faw / hs; `half`: the last tile, bin K / 2 alone (lane q = 0,
// t = c = 0).
__device__ __forceinline__ void store_tile(const float (&d0)[64],
                                           const float (&d1)[64],
                                           const Out& out, long long o,
                                           int b0, bool half, int k, int q,
                                           int ln, bool live) {
    if (half) {
        if (q == 0 && live) {
            float p1u, n1u, p2u, n2u, p1w, n1w, p2w, n2w;
            mags(d0, 0, 0, 0, p1u, n1u);
            mags(d0, 2, 0, 0, p2u, n2u);
            mags(d1, 0, 0, 0, p1w, n1w);
            mags(d1, 2, 0, 0, p2w, n2w);
            out.fa[o + b0] = __fadd_rn(p1u, n2u);
            out.faw[o + b0] = __fadd_rn(p1w, n2w);
            out.hs[o + b0] = fmaxf(p1u, n2u);
        }
        return;
    }
    // The mirror bins K - b0 - j of this thread: e_t - c, e_t = K - b0
    // - 8 t - 2 q (fa, faw, hs).
    float ma[4][2], mw[4][2], mh[4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        float a1[2], w1[2], h1[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            float p1u, n1u, p2u, n2u, p1w, n1w, p2w, n2w;
            mags(d0, 0, t, c, p1u, n1u);
            mags(d0, 2, t, c, p2u, n2u);
            mags(d1, 0, t, c, p1w, n1w);
            mags(d1, 2, t, c, p2w, n2w);
            // Bin b0 + j: |X(b0 + j)| and |X(b0 + j - K)| (S2's
            // conjugate side); bin K - b0 - j the other way round.
            a1[c] = __fadd_rn(p1u, n2u);
            h1[c] = fmaxf(p1u, n2u);
            w1[c] = __fadd_rn(p1w, n2w);
            ma[t][c] = __fadd_rn(p2u, n1u);
            mh[t][c] = fmaxf(p2u, n1u);
            mw[t][c] = __fadd_rn(p2w, n1w);
        }
        if (!live) continue;
        const long long o1 = o + b0 + 8 * t + 2 * q;
        *reinterpret_cast<float2*>(out.fa + o1) = make_float2(a1[0], a1[1]);
        *reinterpret_cast<float2*>(out.faw + o1) = make_float2(w1[0], w1[1]);
        *reinterpret_cast<float2*>(out.hs + o1) = make_float2(h1[0], h1[1]);
    }
    // Mirror side, as aligned pairs: lane q writes bins (e_t - 2,
    // e_t - 1), its own c = 1 value beside the c = 0 value of bin
    // e_t - 2, which lane q + 1 holds (lane 0 at t + 1 for q = 3).  At
    // the tile's edges bin K - b0 - 31 (q = 3, t = 3; its pair partner
    // is the next tile's) and bin K - b0 (q = 0, t = 0; column K for
    // b0 = 0, else the previous tile's pair) go alone.
    const int src = q < 3 ? ln + 1 : ln - 3;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int tn = t < 3 ? t + 1 : 3;
        const float na = __shfl_sync(0xffffffffu, ma[t][0], src);
        const float nw = __shfl_sync(0xffffffffu, mw[t][0], src);
        const float nh = __shfl_sync(0xffffffffu, mh[t][0], src);
        const float ta = __shfl_sync(0xffffffffu, ma[tn][0], src);
        const float tw = __shfl_sync(0xffffffffu, mw[tn][0], src);
        const float th = __shfl_sync(0xffffffffu, mh[tn][0], src);
        const long long e = o + k - b0 - 8 * t - 2 * q;
        if (!live) continue;
        if (q == 3 && t == 3) {
            out.fa[e - 1] = ma[t][1];
            out.faw[e - 1] = mw[t][1];
            out.hs[e - 1] = mh[t][1];
        } else {
            const bool up = q == 3;
            *reinterpret_cast<float2*>(out.fa + e - 2) =
                make_float2(up ? ta : na, ma[t][1]);
            *reinterpret_cast<float2*>(out.faw + e - 2) =
                make_float2(up ? tw : nw, mw[t][1]);
            *reinterpret_cast<float2*>(out.hs + e - 2) =
                make_float2(up ? th : nh, mh[t][1]);
        }
    }
    if (live && q == 0 && b0 > 0) {
        out.fa[o + k - b0] = ma[0][0];
        out.faw[o + k - b0] = mw[0][0];
        out.hs[o + k - b0] = mh[0][0];
    }
}

// One chain of K1's sweep (0, S: bins g; 1, M: bins K - g) in the lanes
// that use it: lane 0 the previous tile's last faw (carry), lane 3 its
// last g, deferred to this tile (pend, and whether it beat its left
// neighbour and the threshold).
struct Chain {
    float carry;
    peaks::Cand pend;
    bool pend_ok;
};

// fa, faw (v) and hs of chain X's bin at (t, c) of this thread.
__device__ __forceinline__ peaks::Cand fold_cand(const float (&d0)[64],
                                                 const float (&d1)[64],
                                                 int x, int t, int c,
                                                 int bin) {
    float p1, n1, p2, n2, p1w, n1w, p2w, n2w;
    mags(d0, 0, t, c, p1, n1);
    mags(d0, 2, t, c, p2, n2);
    mags(d1, 0, t, c, p1w, n1w);
    mags(d1, 2, t, c, p2w, n2w);
    peaks::Cand e;
    e.b = bin;
    e.v = x ? __fadd_rn(p2w, n1w) : __fadd_rn(p1w, n2w);
    e.h = x ? __fadd_rn(p2, n1) : __fadd_rn(p1, n2);
    e.hs = x ? fmaxf(p2, n1) : fmaxf(p1, n2);
    return e;
}

// K1: the peaks of pair tile nt (tile tu of unit r of `units`; b0 = 32 nt)
// of this thread's frame, into its list.  Lane q of the frame's quad holds
// g = b0 + 8 t + 2 q + c of both chains (bins g and K - g); tile npair
// holds bin K / 2 alone.  The unit's first g (r > 0) goes to `lo_pair`
// (the frame's pairs of unit r - 1 | r; written where `live`).
__device__ __forceinline__ void sweep_tile(
    const float (&d0)[64], const float (&d1)[64], Chain (&ch)[2],
    peaks::Cand* list, peaks::Cand* lo_pair, int q, int ln, int tu, int nt,
    int npair, int r, int k, int m, float thr, bool live) {
    float v[2][4][2];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            float p1w, n1w, p2w, n2w;
            mags(d1, 0, t, c, p1w, n1w);
            mags(d1, 2, t, c, p2w, n2w);
            v[0][t][c] = __fadd_rn(p1w, n2w);
            v[1][t][c] = __fadd_rn(p2w, n1w);
        }
    const bool half = nt == npair;
    const int b0 = nt * kPair;
    // M's g = 0 is column K, no bin, and g = K / 2 is bin K / 2: as the
    // neighbours of g = 1 and g = K / 2 - 1 they take S's value there.
    if ((half || nt == 0) && q == 0) v[1][0][0] = v[0][0][0];
    const bool first = tu == 0;
    const int src_l = q ? ln - 1 : ln + 3;
    const int src_r = q < 3 ? ln + 1 : ln - 3;
    float carry[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
        float xl[4], yr[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            xl[p] = __shfl_sync(0xffffffffu, v[x][p][1], src_l);
            yr[p] = __shfl_sync(0xffffffffu, v[x][p][0], src_r);
        }
        carry[x] = xl[3];
        Chain& st = ch[x];
        // S's g = 0 (bin 0) sits beside bin K - 1, M's g = 1 (lane 0).
        if (first && nt == 0 && x == 0) st.carry = v[1][0][1];
        // The previous tile's last g, right of it this tile's first.
        const bool res = !first && q == 3 && st.pend_ok && st.pend.v > yr[0];
        unsigned mask = 0;
        if (!half) {
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const float left = q ? xl[p] : (p ? xl[(p + 3) & 3] : st.carry);
                // A unit's first g (r > 0) is deferred; M's g = 0 is no bin.
                const bool skip = p == 0 && q == 0 && first && (r > 0 || x);
                if (!skip && v[x][p][0] > thr && v[x][p][0] > left &&
                    v[x][p][0] > v[x][p][1])
                    mask |= 1u << (2 * p);
                const float right = q < 3 ? yr[p] : yr[(p + 1) & 3];
                if (!(p == 3 && q == 3) && v[x][p][1] > thr &&
                    v[x][p][1] > v[x][p][0] && v[x][p][1] > right)
                    mask |= 2u << (2 * p);
            }
        } else if (x == 0 && q == 0 && v[0][0][0] > thr &&
                   v[0][0][0] > ch[0].carry && v[0][0][0] > ch[1].carry) {
            // Bin K / 2, between the chains' carried K / 2 - 1 and
            // K / 2 + 1.
            mask = 1;
        }
        if (__any_sync(0xffffffffu, mask != 0 || res)) {
            for (int qq = 0; qq < 4; ++qq) {
                if (q == qq) {
                    if (res) peaks::insert(list, m, st.pend);
#pragma unroll
                    for (int p = 0; p < 4; ++p)
#pragma unroll
                        for (int c = 0; c < 2; ++c)
                            if (mask >> (2 * p + c) & 1) {
                                const int g = b0 + 8 * p + 2 * q + c;
                                peaks::insert(list, m,
                                              fold_cand(d0, d1, x, p, c,
                                                        x ? k - g : g));
                            }
                }
                __syncwarp();
            }
        }
        if (first && r > 0 && q == 0 && live) {
            peaks::Cand e = fold_cand(d0, d1, x, 0, 0, x ? k - b0 : b0);
            if (!(e.v > thr && e.v > v[x][0][1])) e.b = -1;
            lo_pair[2 * x + 1] = e;
        }
        if (!half) {
            const int g = b0 + kPair - 1;
            st.pend = fold_cand(d0, d1, x, 3, 1, x ? k - g : g);
            st.pend_ok = v[x][3][1] > thr && v[x][3][1] > v[x][3][0];
        }
    }
    // Both chains' new carries only now: bin K / 2 reads the old ones.
    ch[0].carry = carry[0];
    ch[1].carry = carry[1];
}

template <bool kPeaks>
__global__ void __launch_bounds__(ring::kThreads, 1)
rdft_product_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_w, Out out,
                    int lanes, int frames, int k, int kblocks) {
    extern __shared__ unsigned char smem_raw[];
    const ring::Ring rg = ring::make(smem_raw, kStage);
    // K1: the top-M list of each of the unit's 64 frames, [64][m].
    peaks::Cand* lists = reinterpret_cast<peaks::Cand*>(rg.tail());

    const int ftiles = (frames + kFrames - 1) / kFrames;
    const int npair = k / (2 * kPair);
    // K3: a unit is one pair tile (npair + 1 of them, the last for bin
    // K / 2); K1: a run of kRun pair tiles, the last run with bin K / 2's.
    const int per = kPeaks ? (npair + kRun - 1) / kRun : npair + 1;
    const int step = kPeaks ? kRun : 1;
    const long long units = (long long)lanes * ftiles * per;
    auto sweep_of = [=](long long u) {
        const int r = (int)(u % per);
        return kPeaks ? min(kRun, npair - r * kRun) + (r == per - 1) : 1;
    };
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        // Producer warpgroup: one thread starts every TMA load.
        hopper::setmaxnreg_dec<40>();
        if (threadIdx.x == 256) {
            hopper::tma_prefetch_map(&map_a);
            hopper::tma_prefetch_map(&map_w);
            ring::produce_units(rg, units, sweep_of, kblocks,
                                [&](long long u, int t, int kb,
                                    unsigned char* st, uint64_t* bar) {
                const long long lm = u / per;
                const int nt = (int)(u % per) * step + t;
#pragma unroll
                for (int p = 0; p < 2; ++p)
#pragma unroll
                    for (int j = 0; j < 2; ++j)
                        hopper::tma_load_3d(st + p * kStageA + j * kBoxA,
                                            &map_a, bar, kb * kBk + j * kBox,
                                            0, (int)(2 * lm + p));
#pragma unroll
                for (int c = 0; c < kBn / 64; ++c)
                    hopper::tma_load_2d(st + 2 * kStageA + c * ring::kBoxB,
                                        &map_w, bar, nt * kBn + c * 64,
                                        kb * kBk);
            });
        }
        return;
    }

    // Consumer warpgroup wg: rows wg * 64 .. + 64 (frames wg * 32 .. + 32)
    // of every tile.
    hopper::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, ln = threadIdx.x % 32;
    const int q = ln & 3;
    const bool elected = threadIdx.x % 128 == 0;
    const int fr = wg * 32 + warp * 8 + ln / 4;     // this thread's frame
    peaks::Cand* wlist = lists + (wg * 32 + warp * 8) * out.m;
    const peaks::Cand none = {-INFINITY, 0x7fffffff, 0.0f, 0.0f};
    float d0[64], d1[64];                           // plain, windowed
    int it = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const long long lm = u / per;
        const int r = (int)(u % per);
        const int sweep = sweep_of(u);
        // Every lane stays to the end (the shuffles below take the whole
        // warp); only the frames past the end store nothing.
        const int f = (int)(lm % ftiles) * kFrames + fr;
        const bool live = f < frames;
        const long long row = (lm / ftiles) * frames + f;
        const int npairs = 2 * (per - 1);
        Chain ch[2] = {{0.0f, none, false}, {0.0f, none, false}};
        if constexpr (kPeaks) {
            for (int e = ln; e < 8 * out.m; e += 32) wlist[e] = none;
            __syncwarp();
        }
        for (int t = 0; t < sweep; ++t) {
            const int nt = r * step + t;
            ring::consume(rg, it, kblocks, elected,
                          [&](const unsigned char* st, int kb) {
#pragma unroll
                for (int kk = 0; kk < kBk / 16; ++kk) {
                    // A: K-major, 64-byte rows, 8-row groups 512 B apart,
                    // 32 B a k16 slice; two boxes of 32 deep.  B: as P1,
                    // 128 wide.
                    const uint32_t off =
                        (kk >> 1) * kBoxA + wg * 4096 + (kk & 1) * 32;
                    const uint64_t db = hopper::desc_sw128(
                        st + 2 * kStageA + kk * 2048, 8192, 1024);
                    hopper::wgmma_m64n128k16_bf16_bt(
                        d0, hopper::desc_sw64(st + off, 16, 512), db,
                        (kb | kk) != 0);
                    hopper::wgmma_m64n128k16_bf16_bt(
                        d1, hopper::desc_sw64(st + kStageA + off, 16, 512),
                        db, (kb | kk) != 0);
                }
            });
            if constexpr (kPeaks) {
                sweep_tile(d0, d1, ch, lists + fr * out.m,
                           r > 0 ? out.pairs + (row * npairs + 2 * (r - 1)) * 2
                                 : nullptr,
                           q, ln, t, nt, npair, r, k, out.m, out.threshold,
                           live);
            } else {
                store_tile(d0, d1, out, row * k, nt * kPair,
                           nt == npair, k, q, ln, live);
            }
        }
        if constexpr (kPeaks) {
            // The unit's last g of each chain, for the merge with unit
            // r + 1's first.
            if (r < per - 1 && q == 3 && live) {
#pragma unroll
                for (int x = 0; x < 2; ++x) {
                    peaks::Cand e = ch[x].pend;
                    if (!ch[x].pend_ok) e.b = -1;
                    out.pairs[(row * npairs + 2 * r + x) * 2] = e;
                }
            }
            for (int e = ln; e < 8 * out.m; e += 32) {
                const int ff = (int)(lm % ftiles) * kFrames + wg * 32 +
                               warp * 8 + e / out.m;
                if (ff >= frames) continue;
                out.lists[(((lm / ftiles) * frames + ff) * per + r) *
                              out.m + e % out.m] = wlist[e];
            }
            __syncwarp();
        }
    }
}


// The pre-pass and the product (K3, or K1's search with its merge).
template <bool kPeaks>
int launch_rdft(const float* iq, const void* w, const float* consts,
                void* a_scratch, const Out& out, int lanes, int t_len,
                int frames, int n, int hop, int k, cudaStream_t st) {
    if (lanes <= 0 || frames <= 0) return 0;
    if (n <= 0 || n % kBox || hop <= 0 || k <= 0 || k % (2 * kPair) ||
        t_len < 0 || (kPeaks && (out.m < 1 || out.m > peaks::kMaxM)))
        return cudaErrorInvalidValue;
    const int npad = (n + kBk - 1) / kBk * kBk;
    const int ftiles = (frames + kFrames - 1) / kFrames;
    const int npair = k / (2 * kPair);
    const int per = kPeaks ? (npair + kRun - 1) / kRun : npair + 1;
    if (kPeaks && per > 1 && out.pairs == nullptr)
        return cudaErrorInvalidValue;
    int sms = 0;
    int err = ring::sm_count(sms);
    if (err) return err;
    const long long pairs = (long long)lanes * ftiles * kFrames * (npad / 2);
    rdft_frames_kernel<<<ring::prepass_blocks(pairs, sms), 256, 0, st>>>(
        reinterpret_cast<const float2*>(iq), consts,
        reinterpret_cast<__nv_bfloat162*>(a_scratch), lanes, t_len, frames,
        n, npad, hop, ftiles);
    err = (int)cudaGetLastError();
    if (err) return err;

    CUtensorMap map_a, map_w;
    err = hopper::make_map_bf16_planes(
        &map_a, a_scratch, 2ULL * lanes * ftiles, ring::kBm, npad, ring::kBm,
        kBox);
    if (err) return err;
    err = hopper::make_map_bf16(&map_w, w, npad,
                                (uint64_t)(npair + 1) * kBn, kBk, 64);
    if (err) return err;
    const size_t smem = ring::smem_bytes(
        kStage,
        kPeaks ? (size_t)kFrames * out.m * sizeof(peaks::Cand) : 0);
    err = (int)cudaFuncSetAttribute(
        rdft_product_kernel<kPeaks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    const long long units = (long long)lanes * ftiles * per;
    const int grid = (int)(units < sms ? units : sms);
    rdft_product_kernel<kPeaks><<<grid, ring::kThreads, smem, st>>>(
        map_a, map_w, out, lanes, frames, k, npad / kBk);
    err = (int)cudaGetLastError();
    if (err || !kPeaks) return err;
    return peaks::launch_merge(out.lists, per, out.pairs, 2 * (per - 1),
                               (long long)lanes * frames, out.m, out.bins,
                               out.h, out.h_single, out.valid, st);
}

}  // namespace

// w: the re-laid W, bf16 [npad, (K / 64 + 1) 128]; a_scratch: bf16
// [lanes, ceil(frames / 64), 2, 128, npad], npad = n rounded up to 64.
extern "C" int grl_rdft_spectra(const float* iq, const void* w,
                                const float* consts, void* a_scratch,
                                float* fa, float* faw, float* hs, int lanes,
                                int t_len, int frames, int n, int hop, int k,
                                void* stream) {
    const Out out = {fa,      faw,     hs,      nullptr, nullptr, 1,
                     0.0f,    nullptr, nullptr, nullptr, nullptr};
    return launch_rdft<false>(iq, w, consts, a_scratch, out, lanes, t_len,
                              frames, n, hop, k, (cudaStream_t)stream);
}

// K1: lists [lanes * frames, units, m], units = ceil(K / 64 / kRun);
// pairs [lanes * frames, 2 (units - 1), 2] (unused for one unit).
extern "C" int grl_rdft_peaks(const float* iq, const void* w,
                              const float* consts, void* a_scratch,
                              void* lists, void* pairs, int* bins, float* h,
                              float* h_single, uint8_t* valid, int lanes,
                              int t_len, int frames, int n, int hop, int k,
                              int m, float threshold, void* stream) {
    const Out out = {nullptr,   nullptr,
                     nullptr,   static_cast<peaks::Cand*>(lists),
                     static_cast<peaks::Cand*>(pairs), m,
                     threshold, bins,
                     h,         h_single,
                     valid};
    return launch_rdft<true>(iq, w, consts, a_scratch, out, lanes, t_len,
                             frames, n, hop, k, (cudaStream_t)stream);
}
