// K4b and K4: the direct pyramid spectra and peak lattice, one bf16 product
// per hop frame from the raw [T, 2] IQ of each lane, on wgmma + TMA.
//
// Replaces gr_lora_tpu/ops/pallas_direct.py `make_direct_spectra` /
// `_kernel` (K4b) and `make_direct_peaks` / `_peaks_kernel` (K4).  Per
// frame f (samples x = iq[f*hop .. f*hop + n)):
//
//   y[8K]  = bf16([Re x | Im x]) @ W,   W = bf16 [2n, 8K]   (f32 accumulate)
//   W's columns, 16 bins at a time: [c0 re | c0 im | ... | c3 re | c3 im],
//   c = {plain, Kaiser} x {bins [0, K), bins [F-K, F)}, each the complex
//   weight down[s] (* kaiser[s]) * exp(-2 pi i s b / F) rounded once to bf16
//   m_c    = |y_c|;  fa = m0 + m1,  hs = max(m0, m1),  faw = m2 + m3
//
// K4b writes fa / faw / hs [lanes, frames, K].  K4 writes only the
// peak_lattice_fn contract [lanes, frames, M]: per frame the strict cyclic
// local maxima of faw above the threshold, the top M by value with ties
// to the lower bin, h and h_single read from fa and hs at those bins;
// unfilled slots hold bin 0, zero heights and valid 0.  Numeric class of
// the TPU kernel: the RAW samples are rounded to bf16 once (the dechirp
// lives in W), each weight once, and the products accumulate in f32; the
// magnitudes and folds round each product and sum on their own, as the
// plain version does.
//
// Bound on the card: tensor-core operations (16 n K MACs a frame; 1.1
// TFLOP at SF8 x ff 8 on 16 x 2048 frames), beside K4b's 12 K bytes of
// output a frame.
//
// Design.  A pre-pass (chunk_planes_kernel) writes each lane's samples
// once as two bf16 planes (re, im) [rows, hop], rows = frames + n / hop - 1,
// zero past t_len.  Frame f at depth d < n of either half is plane row
// f + d / hop, column d % hop, so the A tile of 128 consecutive frames and
// 32 depths is one box of a 3-D tensor map (plane, row, column), 64 bytes
// wide (hop is a multiple of 32 samples, so a box never crosses a plane
// row; 64-byte swizzle), and rows past the plane read as zero: the frame
// matrix is never written and no tile reads another lane's rows.  B is W
// through P1's MN-major map (128-byte swizzle, trans-b 1).  The product is
// P1's core (probes.cu): one producer thread keeps TMA loads of 64-deep
// stages (two A boxes, four 64-column B boxes) in flight through a 4-stage
// ring of full / empty mbarriers, and two consumer warpgroups each run
// wgmma m64n256k16 on 64 frames x 256 columns (32 bins), f32 accumulators
// in registers.  wgmma's accumulator layout puts all eight components of a
// bin in one thread (column b + 16 m lands at register group j + 2 m), so
// the magnitudes and folds are taken in registers: no shared-memory
// staging.  K4b: a persistent grid walks (column tile, lane, frame tile)
// units, column tile outermost, so the blocks in flight share W's column
// tiles in L2, and stores each thread's bins as float2.  K4: a unit owns
// a frame tile of a lane and sweeps its whole row of column tiles; each
// quad of lanes holds one frame's 32 bins of a tile, sees its neighbours
// through shuffles, carries the previous tile's last bin, defers bin 0
// until bin K-1 is known and each tile's last bin until the next tile's
// first, and inserts each peak into its frame's top-M list in shared
// memory (the quad's lanes in turn).  No [frames, K] array is written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBm = 128;           // frames per tile (2 warpgroups x 64)
constexpr int kBn = 256;           // W columns per tile
constexpr int kTileBins = kBn / 8; // 32 bins per tile
constexpr int kBk = 64;            // depth per stage
constexpr int kBox = 32;           // depth per A box (64 bytes)
constexpr int kStages = 4;
constexpr int kThreads = 384;      // 2 consumer warpgroups + 1 producer
constexpr int kMaxM = 16;
constexpr uint32_t kBoxA = kBm * kBox * 2;     // 8 KB: 128 rows x 64 B
constexpr uint32_t kStageA = 2 * kBoxA;        // 16 KB
constexpr uint32_t kStageB = kBk * kBn * 2;    // 32 KB: 4 x (64 rows x 128 B)
constexpr size_t kSmem = kStages * (kStageA + kStageB) + 1024 +
                         2 * kStages * sizeof(uint64_t);

struct Cand {
    float v;      // faw
    int b;        // bin
    float h;      // fa
    float hs;     // hs
};

struct Out {
    float* fa;          // K4b: [lanes, frames, k] each
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

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
    return a.v > b.v || (a.v == b.v && a.b < b.b);
}

// Insert into a list of m candidates sorted best first.
__device__ __forceinline__ void insert(Cand* list, int m, const Cand& c) {
    if (!better(c, list[m - 1])) return;
    int pos = m - 1;
    while (pos > 0 && better(c, list[pos - 1])) {
        list[pos] = list[pos - 1];
        --pos;
    }
    list[pos] = c;
}

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

template <bool kPeaks>
__global__ void __launch_bounds__(kThreads, 1)
direct_product_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_w, Out out,
                      int lanes, int frames, int n, int hop, int k, int m,
                      float threshold) {
    extern __shared__ unsigned char smem_raw[];
    // SWIZZLE_128B / 64B tiles must start on a 1024-byte boundary.
    unsigned char* sa = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    unsigned char* sb = sa + kStages * kStageA;
    uint64_t* full = reinterpret_cast<uint64_t*>(sb + kStages * kStageB);
    uint64_t* empty = full + kStages;
    Cand* lists = reinterpret_cast<Cand*>(empty + kStages);  // [128][m]

    const int mtiles = (frames + kBm - 1) / kBm;
    const int ntiles = k / kTileBins;
    const int row_units = lanes * mtiles;
    const long long units =
        kPeaks ? row_units : (long long)row_units * ntiles;
    const int sweep = kPeaks ? ntiles : 1;
    const int kblocks = 2 * n / kBk;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            hopper::mbar_init(&full[s], 1);      // the producer's expect_tx
            hopper::mbar_init(&empty[s], 2);     // one arrive a consumer WG
        }
        hopper::mbar_fence_init();
    }
    __syncthreads();

    if (wg == 2) {
        // Producer warpgroup: one thread starts every TMA load.
        hopper::setmaxnreg_dec<40>();
        if (threadIdx.x == 256) {
            hopper::tma_prefetch_map(&map_a);
            hopper::tma_prefetch_map(&map_w);
            int it = 0;
            for (long long u = blockIdx.x; u < units; u += gridDim.x) {
                int lm, nt0;
                unit_coords<kPeaks>(u, row_units, lm, nt0);
                const int lane = lm / mtiles, mt = lm % mtiles;
                for (int t = 0; t < sweep; ++t) {
                    const int nt = nt0 + t;
                    for (int kb = 0; kb < kblocks; ++kb, ++it) {
                        const int s = it % kStages;
                        const uint32_t ph = (it / kStages) & 1;
                        hopper::mbar_wait(&empty[s], ph ^ 1);
                        hopper::mbar_expect_tx(&full[s], kStageA + kStageB);
                        const int k0 = kb * kBk;
                        const int part = k0 >= n;           // 0 re, 1 im
                        const int d0 = k0 - part * n;
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                            const int dd = d0 + j * kBox;
                            hopper::tma_load_3d(sa + s * kStageA + j * kBoxA,
                                                &map_a, &full[s], dd % hop,
                                                mt * kBm + dd / hop,
                                                2 * lane + part);
                        }
#pragma unroll
                        for (int c = 0; c < kBn / 64; ++c)
                            hopper::tma_load_2d(sb + s * kStageB + c * 8192,
                                                &map_w, &full[s],
                                                nt * kBn + c * 64, k0);
                    }
                }
            }
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
            int prev = 0;
            for (int kb = 0; kb < kblocks; ++kb, ++it) {
                const int s = it % kStages;
                hopper::mbar_wait(&full[s], (it / kStages) & 1);
                hopper::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kBk / 16; ++kk) {
                    // A: K-major, 64-byte rows, 8-row groups 512 B apart,
                    // 32 B a k16 slice; two boxes of 32 deep.  B: as P1.
                    const uint64_t da = hopper::desc_sw64(
                        sa + s * kStageA + (kk >> 1) * kBoxA + wg * 4096 +
                            (kk & 1) * 32,
                        16, 512);
                    const uint64_t db = hopper::desc_sw128(
                        sb + s * kStageB + kk * 2048, 8192, 1024);
                    hopper::wgmma_m64n256k16_bf16_bt(d, da, db,
                                                     (kb | kk) != 0);
                }
                hopper::wgmma_commit();
                // The group before this one is done: free its stage.
                hopper::wgmma_wait<1>();
                if (kb > 0 && elected) hopper::mbar_arrive(&empty[prev]);
                prev = s;
            }
            hopper::wgmma_wait<0>();
            if (elected) hopper::mbar_arrive(&empty[prev]);

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

// Each lane's samples as bf16 planes [lanes, 2 (re, im), plane_len],
// zero past t_len.
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

template <bool kPeaks>
int launch(const float* iq, const void* w, void* planes, const Out& out,
           int lanes, int t_len, int frames, int n, int hop, int k, int m,
           float threshold, cudaStream_t stream) {
    if (lanes <= 0 || frames <= 0) return 0;
    // Limits: a 32-deep A box within one plane row, the re / im halves on
    // a stage boundary, whole 32-bin column tiles, M in registers' reach.
    if (hop <= 0 || hop % kBox || n % hop || n % kBk || k % kTileBins ||
        t_len < 0 || (kPeaks && (m < 1 || m > kMaxM)))
        return cudaErrorInvalidValue;
    const long long rows = (long long)frames + n / hop - 1;
    const long long plane_len = rows * hop;
    int dev = 0, sms = 0;
    cudaError_t cerr = cudaGetDevice(&dev);
    if (cerr == cudaSuccess)
        cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (cerr != cudaSuccess) return (int)cerr;
    const long long total = (long long)lanes * plane_len;
    const long long cblocks = (total + 255) / 256;
    chunk_planes_kernel<<<(int)(cblocks < 8LL * sms ? cblocks : 8LL * sms),
                          256, 0, stream>>>(
        reinterpret_cast<const float2*>(iq),
        reinterpret_cast<__nv_bfloat16*>(planes), lanes, t_len, plane_len);
    cerr = cudaGetLastError();
    if (cerr != cudaSuccess) return (int)cerr;

    CUtensorMap map_a, map_w;
    int err = hopper::make_map_bf16_planes(&map_a, planes, 2ULL * lanes,
                                           rows, hop, kBm, kBox);
    if (err) return err;
    err = hopper::make_map_bf16(&map_w, w, 2ULL * n, 8ULL * k, kBk, 64);
    if (err) return err;
    const size_t smem = kSmem + (kPeaks ? (size_t)kBm * m * sizeof(Cand) : 0);
    cerr = cudaFuncSetAttribute(direct_product_kernel<kPeaks>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
    if (cerr != cudaSuccess) return (int)cerr;
    const long long row_units = (long long)lanes * ((frames + kBm - 1) / kBm);
    const long long units = kPeaks ? row_units : row_units * (k / kTileBins);
    const int grid = (int)(units < sms ? units : sms);
    direct_product_kernel<kPeaks><<<grid, kThreads, smem, stream>>>(
        map_a, map_w, out, lanes, frames, n, hop, k, m, threshold);
    return (int)cudaGetLastError();
}

}  // namespace

// planes: bf16 scratch [lanes, 2, frames + n / hop - 1, hop].
extern "C" int grl_direct_spectra(const float* iq, const void* w,
                                  void* planes, float* fa, float* faw,
                                  float* hs, int lanes, int t_len,
                                  int frames, int n, int hop, int k,
                                  void* stream) {
    Out out = {fa, faw, hs, nullptr, nullptr, nullptr, nullptr};
    return launch<false>(iq, w, planes, out, lanes, t_len, frames, n, hop, k,
                         1, 0.0f, (cudaStream_t)stream);
}

extern "C" int grl_direct_peaks(const float* iq, const void* w, void* planes,
                                int* bins, float* h, float* h_single,
                                uint8_t* valid, int lanes, int t_len,
                                int frames, int n, int hop, int k, int m,
                                float threshold, void* stream) {
    Out out = {nullptr, nullptr, nullptr, bins, h, h_single, valid};
    return launch<true>(iq, w, planes, out, lanes, t_len, frames, n, hop, k,
                        m, threshold, (cudaStream_t)stream);
}
