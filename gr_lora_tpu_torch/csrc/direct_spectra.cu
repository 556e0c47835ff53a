// K4b, K4 and K6: the direct pyramid spectra and peak lattice, and the
// chunk-row spectra, as one bf16 product per hop frame on wgmma + TMA.
//
// Replaces gr_lora_tpu/ops/pallas_direct.py `make_direct_spectra` /
// `_kernel` (K4b) and `make_direct_peaks` / `_peaks_kernel` (K4), and
// gr_lora_tpu/ops/pallas_frontend.py `make_pallas_spectra` / `_kernel`
// (K6).  Per frame f (samples x = iq[f*hop .. f*hop + n)):
//
//   y[8K]  = bf16([Re x | Im x]) @ W,   W = bf16 [2n, 8K]   (f32 accumulate)
//   W's columns, 16 bins at a time: [c0 re | c0 im | ... | c3 re | c3 im],
//   c = {plain, Kaiser} x {bins [0, K), bins [F-K, F)}, each the complex
//   weight down[s] (* kaiser[s]) * exp(-2 pi i s b / F) rounded once to bf16
//   m_c    = |y_c|;  fa = m0 + m1,  hs = max(m0, m1),  faw = m2 + m3
//
// K4b and K6 write fa / faw / hs [lanes, frames, K].  K4 writes only the
// peak_lattice_fn contract [lanes, frames, M]: per frame the strict cyclic
// local maxima of faw above the threshold, the top M by value with ties
// to the lower bin, h and h_single read from fa and hs at those bins;
// unfilled slots hold bin 0, zero heights and valid 0.  Numeric class of
// the TPU kernels: the RAW samples are rounded to bf16 once (the dechirp
// lives in W), each weight once, and the products accumulate in f32; the
// magnitudes and folds round each product and sum on their own, as the
// plain versions do.  K6 is K4b's function from the JAX kernel's chunk-row
// layout: its W is pallas_frontend._component_weights' bf16 values with
// the rows in chunk order (depth r lw + c: column c of chunk row r) and
// the columns in the 16-bin interleave above, the same values as K4b's W,
// so the two differ only in the f32 summation order.
//
// Bound on the card: tensor-core operations (16 n K MACs a frame; 1.1
// TFLOP at SF8 x ff 8 on 16 x 2048 frames), beside the 12 K bytes of
// output a frame of K4b and K6.
//
// Design.  The product is the ring of tma_ring.cuh (P1's core): one
// producer thread keeps TMA loads of 64-deep stages (two A boxes, four
// 64-column B boxes) in flight through 4 buffers, and two consumer
// warpgroups each run wgmma m64n256k16 on 64 frames x 256 columns (32
// bins), f32 accumulators in registers.  A is read in boxes of 128 frames
// x 32 depths (64 bytes, 64-byte swizzle) from a bf16 copy of the samples
// that a pre-pass writes once; the A walk maps a depth to its box:
//
//   K4b (PlaneWalk): two planes (re, im) [rows, hop] a lane, rows = frames
//     + n / hop - 1: frame f at depth d < n of either half is plane row
//     f + d / hop, column d % hop (hop a multiple of 32 samples, so a box
//     never crosses a plane row);
//   K6 (ChunkWalk): the chunk rows [rows, w] a lane, row r = [re(hop r) |
//     im(hop r) | 0] (w = 2 hop rounded up to 128): depth r lw + c is row
//     f + r, column c, lw = 2 hop rounded up to 32, so any hop works and
//     the boxes wholly in the pad columns [lw, w) are never loaded (their
//     weight rows are zero).
//
// Rows past the lane read as zero: no frame matrix is written and no tile
// reads another lane's rows.  B is W through P1's MN-major map (128-byte
// swizzle, trans-b 1).  wgmma's accumulator layout puts all eight
// components of a bin in one thread (column b + 16 m lands at register
// group j + 2 m), so the magnitudes and folds are taken in registers: no
// shared-memory staging.  K4b / K6: a persistent grid walks (column tile,
// lane, frame tile) units, column tile outermost, so the blocks in flight
// share W's column tiles in L2, and stores each thread's bins as float2.
// K4: a unit owns a frame tile of a lane and sweeps its whole row of
// column tiles; each quad of lanes holds one frame's 32 bins of a tile,
// sees its neighbours through shuffles, carries the previous tile's last
// bin, defers bin 0 until bin K-1 is known and each tile's last bin until
// the next tile's first, and inserts each peak into its frame's top-M list
// in shared memory (the quad's lanes in turn).  No [frames, K] array is
// written.  The lists take M <= 16 (230 464 B of shared memory at 16);
// ops/direct.py routes a larger M through K4b and peak_topm.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "peak_merge.cuh"
#include "tma_ring.cuh"

namespace {

using ring::kBk;
using ring::kBm;
using ring::kBox;
using ring::kBoxA;
constexpr int kBn = 256;           // W columns per tile
constexpr int kTileBins = kBn / 8; // 32 bins per tile
constexpr int kMaxM = peaks::kMaxM;
constexpr int kR = 8;              // frames per symbol (n / hop)
constexpr uint32_t kStageA = 2 * kBoxA;        // 16 KB
constexpr uint32_t kStageB = kBn / 64 * ring::kBoxB;   // 32 KB

using peaks::Cand;     // (faw, bin, fa, hs)
using peaks::insert;

struct Out {
    float* fa;          // K4b, K6: [lanes, frames, k] each
    float* faw;
    float* hs;
    int* bins;          // K4: [lanes, frames, m] each
    float* h;
    float* h_single;
    uint8_t* valid;
};

__device__ __forceinline__ float cabs_rn(float re, float im) {
    return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

// Register of component `comp` (0..7: c0 re, c0 im, ..., c3 im) of the bin
// this thread holds at pair p (bins 8 p + 2 (lane % 4) + c of the tile),
// row i: d[4 j + 2 i + c] with column 8 j + 2 (lane % 4) + c, and column
// 128 g + 16 comp + 8 h + ... for bin 16 g + 8 h + ..., p = 2 g + h.
__host__ __device__ constexpr int reg(int p, int comp, int i, int c) {
    return 4 * (16 * (p >> 1) + 2 * comp + (p & 1)) + 2 * i + c;
}

// The three folds of the bin at (p, i, c).
__device__ __forceinline__ void fold(const float (&d)[128], int p, int i,
                                     int c, float& fa, float& faw,
                                     float& hs) {
    const float m0 = cabs_rn(d[reg(p, 0, i, c)], d[reg(p, 1, i, c)]);
    const float m1 = cabs_rn(d[reg(p, 2, i, c)], d[reg(p, 3, i, c)]);
    const float m2 = cabs_rn(d[reg(p, 4, i, c)], d[reg(p, 5, i, c)]);
    const float m3 = cabs_rn(d[reg(p, 6, i, c)], d[reg(p, 7, i, c)]);
    fa = __fadd_rn(m0, m1);
    hs = fmaxf(m0, m1);
    faw = __fadd_rn(m2, m3);
}

__device__ __forceinline__ float faw_of(const float (&d)[128], int p, int i,
                                        int c) {
    return __fadd_rn(cabs_rn(d[reg(p, 4, i, c)], d[reg(p, 5, i, c)]),
                     cabs_rn(d[reg(p, 6, i, c)], d[reg(p, 7, i, c)]));
}

// K4b's A walk: the box of depths d .. d + 31 of the frames f0 .. f0 + 127
// of `lane` in the planes [lanes, 2, rows, hop].
struct PlaneWalk {
    int n, hop;
    __device__ void box(int lane, int f0, int d, int& c0, int& c1,
                        int& c2) const {
        const int part = d >= n;                 // 0 re, 1 im
        const int dd = d - part * n;
        c0 = dd % hop;
        c1 = f0 + dd / hop;
        c2 = 2 * lane + part;
    }
};

// K6's A walk: the same box in the chunk rows [lanes, rows, w].
struct ChunkWalk {
    int lw;
    __device__ void box(int lane, int f0, int d, int& c0, int& c1,
                        int& c2) const {
        c0 = d % lw;
        c1 = f0 + d / lw;
        c2 = lane;
    }
};

// Unit u's (lane * mtiles + frame tile, first column tile).
template <bool kPeaks>
__device__ __forceinline__ void unit_coords(long long u, int row_units,
                                            int& lm, int& nt0) {
    if (kPeaks) {
        lm = (int)u;
        nt0 = 0;
    } else {
        lm = (int)(u % row_units);
        nt0 = (int)(u / row_units);
    }
}

// Per frame row of a K4 sweep, in the lanes that use it: q = 0 keeps the
// previous tile's last faw (carry) and the deferred bin 0 (p0); q = 3
// keeps the deferred last bin of the previous tile (p31) and bin 0's faw
// (first0).
struct Sweep {
    float carry, first0;
    Cand p0, p31;
    bool p0ok, p31ok;
};

// K4: the peaks of tile t (column tile nt) of this thread's rows r0 and
// r0 + 8, into their lists.  Lane q of a row's quad holds tile bins
// 8 p + 2 q + c.
__device__ __forceinline__ void sweep_tile(const float (&d)[128],
                                           Sweep (&sw)[2], Cand* lists,
                                           int r0, int q, int ln, int t,
                                           int nt, int m, float threshold) {
    const int src_l = q ? ln - 1 : ln + 3;
    const int src_r = q < 3 ? ln + 1 : ln - 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float v[4][2];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            v[p][0] = faw_of(d, p, i, 0);
            v[p][1] = faw_of(d, p, i, 1);
        }
        // x[p]: bin 8 p + 2 q - 1 (q > 0) or 8 p + 7 (q = 0);
        // y[p]: bin 8 p + 2 q + 2 (q < 3) or 8 p (q = 3).
        float x[4], y[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            x[p] = __shfl_sync(0xffffffffu, v[p][1], src_l);
            y[p] = __shfl_sync(0xffffffffu, v[p][0], src_r);
        }
        Sweep& st = sw[i];
        // The previous tile's last bin, right of it this tile's bin 0.
        const bool res = t > 0 && q == 3 && st.p31ok && st.p31.v > y[0];
        unsigned mask = 0;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const float left = q ? x[p] : (p ? x[(p + 3) & 3] : st.carry);
            const bool first = p == 0 && q == 0 && t == 0;
            if (!first && v[p][0] > threshold && v[p][0] > left &&
                v[p][0] > v[p][1])
                mask |= 1u << (2 * p);
            const bool last = p == 3 && q == 3;
            const float right = q < 3 ? y[p] : y[(p + 1) & 3];
            if (!last && v[p][1] > threshold && v[p][1] > v[p][0] &&
                v[p][1] > right)
                mask |= 2u << (2 * p);
        }
        if (__any_sync(0xffffffffu, mask != 0 || res)) {
            Cand* list = lists + (r0 + 8 * i) * m;
            for (int qq = 0; qq < 4; ++qq) {
                if (q == qq) {
                    if (res) {
                        Cand c = st.p31;
                        c.b = nt * kTileBins - 1;
                        insert(list, m, c);
                    }
#pragma unroll
                    for (int p = 0; p < 4; ++p)
#pragma unroll
                        for (int c = 0; c < 2; ++c)
                            if (mask >> (2 * p + c) & 1) {
                                Cand cd;
                                fold(d, p, i, c, cd.h, cd.v, cd.hs);
                                cd.b = nt * kTileBins + 8 * p + 2 * q + c;
                                insert(list, m, cd);
                            }
                }
                __syncwarp();
            }
        }
        // Defer this tile's last bin (lane q = 3) and, on the first tile,
        // bin 0 (lane q = 0).
        fold(d, 3, i, 1, st.p31.h, st.p31.v, st.p31.hs);
        st.p31ok = v[3][1] > threshold && v[3][1] > v[3][0];
        if (t == 0) {
            fold(d, 0, i, 0, st.p0.h, st.p0.v, st.p0.hs);
            st.p0.b = 0;
            st.p0ok = v[0][0] > threshold && v[0][0] > v[0][1];
            st.first0 = y[0];
        }
        st.carry = x[3];
    }
}

// K4, after the last tile: the deferred wrap, bin K - 1 (right of it bin
// 0) and bin 0 (left of it bin K - 1).
__device__ __forceinline__ void finish_sweep(const Sweep (&sw)[2],
                                             Cand* lists, int r0, int q,
                                             int k, int m) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const Sweep& st = sw[i];
        const bool last = q == 3 && st.p31ok && st.p31.v > st.first0;
        const bool first = q == 0 && st.p0ok && st.p0.v > st.carry;
        Cand* list = lists + (r0 + 8 * i) * m;
        for (int qq = 0; qq < 4; ++qq) {
            if (q == qq) {
                if (last) {
                    Cand c = st.p31;
                    c.b = k - 1;
                    insert(list, m, c);
                }
                if (first) insert(list, m, st.p0);
            }
            __syncwarp();
        }
    }
}

// depth: the product's depth (2n for K4b, R lw for K6), a multiple of kBk.
template <bool kPeaks, class Walk>
__global__ void __launch_bounds__(ring::kThreads, 1)
direct_product_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w, Out out,
                      Walk walk, int lanes, int frames, int depth, int k,
                      int m, float threshold) {
    extern __shared__ unsigned char smem_raw[];
    const ring::Ring rg = ring::make(smem_raw, kStageA + kStageB);
    Cand* lists = reinterpret_cast<Cand*>(rg.tail());    // K4: [128][m]

    const int mtiles = (frames + kBm - 1) / kBm;
    const int ntiles = k / kTileBins;
    const int row_units = lanes * mtiles;
    const long long units =
        kPeaks ? row_units : (long long)row_units * ntiles;
    const int sweep = kPeaks ? ntiles : 1;
    const int kblocks = depth / kBk;
    const int wg = threadIdx.x / 128;

    if (wg == 2) {
        // Producer warpgroup: one thread starts every TMA load.
        hopper::setmaxnreg_dec<40>();
        if (threadIdx.x == 256) {
            hopper::tma_prefetch_map(&map_a);
            hopper::tma_prefetch_map(&map_w);
            ring::produce(rg, units, sweep, kblocks,
                          [&](long long u, int t, int kb, unsigned char* st,
                              uint64_t* bar) {
                int lm, nt0;
                unit_coords<kPeaks>(u, row_units, lm, nt0);
                const int lane = lm / mtiles, mt = lm % mtiles;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    int c0, c1, c2;
                    walk.box(lane, mt * kBm, kb * kBk + j * kBox, c0, c1, c2);
                    hopper::tma_load_3d(st + j * kBoxA, &map_a, bar, c0, c1,
                                        c2);
                }
#pragma unroll
                for (int c = 0; c < kBn / 64; ++c)
                    hopper::tma_load_2d(st + kStageA + c * ring::kBoxB,
                                        &map_w, bar,
                                        (nt0 + t) * kBn + c * 64, kb * kBk);
            });
        }
        return;
    }

    // Consumer warpgroup wg: frames wg * 64 .. + 64 of every tile.
    hopper::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x % 128) / 32, ln = threadIdx.x % 32;
    const int q = ln & 3;
    const bool elected = threadIdx.x % 128 == 0;
    const int r0 = wg * 64 + warp * 16 + ln / 4;   // rows r0, r0 + 8
    Cand* wlist = lists + (wg * 64 + warp * 16) * m;
    const Cand none = {-INFINITY, INT_MAX, 0.0f, 0.0f};
    float d[128];
    int it = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        int lm, nt0;
        unit_coords<kPeaks>(u, row_units, lm, nt0);
        const int lane = lm / mtiles, mt = lm % mtiles;
        Sweep sw[2] = {{0.0f, 0.0f, none, none, false, false},
                       {0.0f, 0.0f, none, none, false, false}};
        if constexpr (kPeaks) {
            for (int e = ln; e < 16 * m; e += 32) wlist[e] = none;
            __syncwarp();
        }
        for (int t = 0; t < sweep; ++t) {
            const int nt = nt0 + t;
            ring::consume(rg, it, kblocks, elected,
                          [&](const unsigned char* st, int kb) {
#pragma unroll
                for (int kk = 0; kk < kBk / 16; ++kk) {
                    // A: K-major, 64-byte rows, 8-row groups 512 B apart,
                    // 32 B a k16 slice; two boxes of 32 deep.  B: as P1.
                    const uint64_t da = hopper::desc_sw64(
                        st + (kk >> 1) * kBoxA + wg * 4096 + (kk & 1) * 32,
                        16, 512);
                    const uint64_t db = hopper::desc_sw128(
                        st + kStageA + kk * 2048, 8192, 1024);
                    hopper::wgmma_m64n256k16_bf16_bt(d, da, db,
                                                     (kb | kk) != 0);
                }
            });

            if constexpr (!kPeaks) {
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int f = mt * kBm + r0 + 8 * i;
                    if (f >= frames) continue;
                    const long long o = ((long long)lane * frames + f) * k +
                                        nt * kTileBins + 2 * q;
#pragma unroll
                    for (int p = 0; p < 4; ++p) {
                        float2 a, w, h;
                        fold(d, p, i, 0, a.x, w.x, h.x);
                        fold(d, p, i, 1, a.y, w.y, h.y);
                        *reinterpret_cast<float2*>(out.fa + o + 8 * p) = a;
                        *reinterpret_cast<float2*>(out.faw + o + 8 * p) = w;
                        *reinterpret_cast<float2*>(out.hs + o + 8 * p) = h;
                    }
                }
            } else {
                sweep_tile(d, sw, lists, r0, q, ln, t, nt, m, threshold);
            }
        }
        if constexpr (kPeaks) {
            finish_sweep(sw, lists, r0, q, k, m);
            for (int e = ln; e < 16 * m; e += 32) {
                const int f = mt * kBm + wg * 64 + warp * 16 + e / m;
                if (f >= frames) continue;
                const Cand c = wlist[e];
                const bool ok = c.v != -INFINITY;
                const long long o =
                    ((long long)lane * frames + f) * m + e % m;
                out.bins[o] = ok ? c.b : 0;
                out.h[o] = ok ? c.h : 0.0f;
                out.h_single[o] = ok ? c.hs : 0.0f;
                out.valid[o] = ok ? 1 : 0;
            }
            __syncwarp();
        }
    }
}

// K4b's pre-pass: each lane's samples as bf16 planes [lanes, 2 (re, im),
// plane_len], zero past t_len.
__global__ void chunk_planes_kernel(const float2* __restrict__ iq,
                                    __nv_bfloat16* __restrict__ planes,
                                    int lanes, int t_len,
                                    long long plane_len) {
    const long long total = (long long)lanes * plane_len;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < total; e += (long long)gridDim.x * blockDim.x) {
        const long long lane = e / plane_len, s = e % plane_len;
        float2 z = make_float2(0.0f, 0.0f);
        if (s < t_len) z = iq[lane * t_len + s];
        planes[2 * lane * plane_len + s] = __float2bfloat16(z.x);
        planes[(2 * lane + 1) * plane_len + s] = __float2bfloat16(z.y);
    }
}

// K6's pre-pass: each lane's chunk rows as bf16 [lanes, rows, w], row r
// = [re(hop r) | im(hop r) | 0], zero past t_len.
__global__ void chunk_rows_kernel(const float2* __restrict__ iq,
                                  __nv_bfloat16* __restrict__ rows_out,
                                  int lanes, int t_len, int rows, int hop,
                                  int width) {
    const long long total = (long long)lanes * rows * width;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < total; e += (long long)gridDim.x * blockDim.x) {
        const int c = (int)(e % width);
        const long long lr = e / width;
        const long long lane = lr / rows, r = lr % rows;
        const int part = c >= hop;
        const long long s = r * hop + c - part * hop;
        float v = 0.0f;
        if (c < 2 * hop && s < t_len) {
            const float2 z = iq[lane * t_len + s];
            v = part ? z.y : z.x;
        }
        rows_out[e] = __float2bfloat16(v);
    }
}

// The product over the A map, W [depth, 8K].
template <bool kPeaks, class Walk>
int launch_product(const CUtensorMap& map_a, const void* w, const Out& out,
                   Walk walk, int lanes, int frames, int depth, int k, int m,
                   float threshold, int sms, cudaStream_t stream) {
    CUtensorMap map_w;
    int err = hopper::make_map_bf16(&map_w, w, (uint64_t)depth, 8ULL * k,
                                    kBk, 64);
    if (err) return err;
    const size_t smem = ring::smem_bytes(
        kStageA + kStageB, kPeaks ? (size_t)kBm * m * sizeof(Cand) : 0);
    cudaError_t cerr = cudaFuncSetAttribute(
        direct_product_kernel<kPeaks, Walk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (cerr != cudaSuccess) return (int)cerr;
    const long long row_units = (long long)lanes * ((frames + kBm - 1) / kBm);
    const long long units = kPeaks ? row_units : row_units * (k / kTileBins);
    const int grid = (int)(units < sms ? units : sms);
    direct_product_kernel<kPeaks, Walk>
        <<<grid, ring::kThreads, smem, stream>>>(
            map_a, map_w, out, walk, lanes, frames, depth, k, m, threshold);
    return (int)cudaGetLastError();
}

template <bool kPeaks>
int launch_direct(const float* iq, const void* w, void* planes,
                  const Out& out, int lanes, int t_len, int frames, int n,
                  int hop, int k, int m, float threshold,
                  cudaStream_t stream) {
    if (lanes <= 0 || frames <= 0) return 0;
    // Limits: a 32-deep A box within one plane row, the re / im halves on
    // a stage boundary, whole 32-bin column tiles, M in the lists' reach.
    if (hop <= 0 || hop % kBox || n % hop || n % kBk || k % kTileBins ||
        t_len < 0 || (kPeaks && (m < 1 || m > kMaxM)))
        return cudaErrorInvalidValue;
    const long long rows = (long long)frames + n / hop - 1;
    const long long plane_len = rows * hop;
    int sms = 0;
    int err = ring::sm_count(sms);
    if (err) return err;
    const int blocks = ring::prepass_blocks((long long)lanes * plane_len, sms);
    chunk_planes_kernel<<<blocks, 256, 0, stream>>>(
        reinterpret_cast<const float2*>(iq),
        reinterpret_cast<__nv_bfloat16*>(planes), lanes, t_len, plane_len);
    err = (int)cudaGetLastError();
    if (err) return err;
    CUtensorMap map_a;
    err = hopper::make_map_bf16_planes(&map_a, planes, 2ULL * lanes, rows,
                                       hop, kBm, kBox);
    if (err) return err;
    return launch_product<kPeaks>(map_a, w, out, PlaneWalk{n, hop}, lanes,
                                  frames, 2 * n, k, m, threshold, sms,
                                  stream);
}

}  // namespace

// planes: bf16 scratch [lanes, 2, frames + n / hop - 1, hop].
extern "C" int grl_direct_spectra(const float* iq, const void* w,
                                  void* planes, float* fa, float* faw,
                                  float* hs, int lanes, int t_len,
                                  int frames, int n, int hop, int k,
                                  void* stream) {
    Out out = {fa, faw, hs, nullptr, nullptr, nullptr, nullptr};
    return launch_direct<false>(iq, w, planes, out, lanes, t_len, frames, n,
                                hop, k, 1, 0.0f, (cudaStream_t)stream);
}

extern "C" int grl_direct_peaks(const float* iq, const void* w, void* planes,
                                int* bins, float* h, float* h_single,
                                uint8_t* valid, int lanes, int t_len,
                                int frames, int n, int hop, int k, int m,
                                float threshold, void* stream) {
    Out out = {nullptr, nullptr, nullptr, bins, h, h_single, valid};
    return launch_direct<true>(iq, w, planes, out, lanes, t_len, frames, n,
                               hop, k, m, threshold, (cudaStream_t)stream);
}

// K6.  w: bf16 [8 lw, 8K], lw = 2 hop rounded up to 32; rows_scratch:
// bf16 [lanes, frames + 7, width], width = 2 hop rounded up to 128.
extern "C" int grl_chunk_spectra(const float* iq, const void* w,
                                 void* rows_scratch, float* fa, float* faw,
                                 float* hs, int lanes, int t_len, int frames,
                                 int hop, int width, int k, void* stream) {
    if (lanes <= 0 || frames <= 0) return 0;
    const int lw = (2 * hop + kBox - 1) / kBox * kBox;
    if (hop <= 0 || width % 8 || width < lw || k % kTileBins || t_len < 0)
        return cudaErrorInvalidValue;
    const int rows = frames + kR - 1;
    const cudaStream_t st = (cudaStream_t)stream;
    int sms = 0;
    int err = ring::sm_count(sms);
    if (err) return err;
    const int blocks = ring::prepass_blocks((long long)lanes * rows * width,
                                            sms);
    chunk_rows_kernel<<<blocks, 256, 0, st>>>(
        reinterpret_cast<const float2*>(iq),
        reinterpret_cast<__nv_bfloat16*>(rows_scratch), lanes, t_len, rows,
        hop, width);
    err = (int)cudaGetLastError();
    if (err) return err;
    CUtensorMap map_a;
    err = hopper::make_map_bf16_planes(&map_a, rows_scratch, lanes, rows,
                                       width, kBm, kBox);
    if (err) return err;
    Out out = {fa, faw, hs, nullptr, nullptr, nullptr, nullptr};
    return launch_product<false>(map_a, w, out, ChunkWalk{lw}, lanes, frames,
                                 kR * lw, k, 1, 0.0f, sms, st);
}
