// Overlap-decomposed pyramid spectra: the fa / faw / hs folds of every hop
// from the chunk spectra G, for large SF at the collision zoom.
//
// Replaces gr_lora_tpu/ops/pallas_overlap.py `make_overlap_spectra` /
// `_kernel` (K5, whole; the chunk DFT stays outside, as there), and is the
// front end of gr_lora_tpu/ops/pallas_peaks.py `make_overlap_peaks` /
// `_kernel` (K2: the j-sum, window convolution and folds; its peak search
// is csrc/peak_topm.cu).  With hop h = N/8, F = fft_factor * N, per hop b:
//
//   X_b[c]  = sum_{j<8} rho_j[c] * G[b + j, (c - sigma_j) mod F]
//   Xw_b[c] = sum_q tap_q * X_b[(c - shift_q) mod F]      (~19-21 taps)
//   fa = |X(c)| + |X(c+F-K)|, hs = max of the two, faw = |Xw(c)| + |Xw(c+F-K)|
//
// all in f32 (bf16 G leaves spurious above-threshold peaks,
// pallas_peaks.py:272-275).  G is indexed directly at (c - sigma_j) mod F:
// the TPU kernel's bin-tile gather, its 46 BlockSpec views and its SMEM
// scalar table do not exist here.  The hi fold side is c + F - K for
// every p (the TPU view arithmetic assumes F = 2K).
//
// Bound on the card: bytes — each output bin reads 8 complex G values per
// fold side (about 130 B of G a bin with the halo).  Design: a block owns
// 8 hops x 256 bins; per fold side it builds X over the tile plus a halo
// of the largest window shift in shared memory (one pass over G, rho read
// once per bin and reused across the 8 hops), then each thread applies the
// window taps to its bin of all 8 hops from shared memory (each tap read
// once), so the dense X / Xw never reach device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTh = 8;            // hops per block
constexpr int kBt = 256;          // output bins per block
constexpr int kThreads = kBt;     // thread i owns bin c0 + i of all kTh hops
constexpr int kR = 8;             // PYRAMID_OVERLAP_FACTOR
constexpr int kMaxTaps = 64;

// Every product and sum is rounded on its own (the _rn intrinsics are never
// contracted into FMAs) and taken in the plain version's order, so the
// kernel's folds equal ops/overlap_dft.spectra_from_chunks on the card bit
// for bit, and so do the peaks.
__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
    acc.x = __fadd_rn(acc.x, __fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)));
    acc.y = __fadd_rn(acc.y, __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
    return acc;
}

__device__ __forceinline__ float cmag(float2 a) {
    return sqrtf(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)));
}

__global__ void __launch_bounds__(kThreads)
overlap_spectra_kernel(const float2* __restrict__ g,
                       const float2* __restrict__ rho,
                       const int* __restrict__ sigma,
                       const int* __restrict__ shifts,
                       const float2* __restrict__ taps,
                       float* __restrict__ fa, float* __restrict__ faw,
                       float* __restrict__ hs, int rows_g, int hops, int f,
                       int k, int ntaps, int halo) {
    extern __shared__ __align__(16) unsigned char smem[];
    float2* xs = reinterpret_cast<float2*>(smem);
    __shared__ float2 tap_s[kMaxTaps];
    __shared__ int shift_s[kMaxTaps];
    __shared__ int sigma_s[kR];

    const int c0 = blockIdx.x * kBt;
    const int b0 = blockIdx.y * kTh;
    const long long lane = blockIdx.z;
    const int width = kBt + 2 * halo;
    const float2* gl = g + lane * rows_g * (long long)f;

    for (int t = threadIdx.x; t < ntaps; t += kThreads) {
        tap_s[t] = taps[t];
        shift_s[t] = shifts[t];
    }
    if (threadIdx.x < kR) sigma_s[threadIdx.x] = sigma[threadIdx.x];
    __syncthreads();

    const int i = threadIdx.x;
    float mag[2][kTh], magw[2][kTh];
#pragma unroll       // static indices keep mag / magw in registers
    for (int side = 0; side < 2; ++side) {
        const int base = c0 + side * (f - k) - halo;     // bin of column 0
        for (int u = threadIdx.x; u < width; u += kThreads) {
            int bin = (base + u) % f;
            if (bin < 0) bin += f;
            float2 acc[kTh];
#pragma unroll
            for (int t = 0; t < kTh; ++t) acc[t] = make_float2(0.0f, 0.0f);
#pragma unroll
            for (int j = 0; j < kR; ++j) {
                const float2 r = rho[(long long)j * f + bin];
                int gb = bin - sigma_s[j];
                if (gb < 0) gb += f;
#pragma unroll
                for (int t = 0; t < kTh; ++t) {
                    const int b = b0 + t;
                    if (b < hops)
                        acc[t] = cfma(gl[(long long)(b + j) * f + gb], r,
                                      acc[t]);
                }
            }
#pragma unroll
            for (int t = 0; t < kTh; ++t) xs[t * width + u] = acc[t];
        }
        __syncthreads();
        // Window taps in ascending q for every hop: one read of each tap.
        float2 xw[kTh];
#pragma unroll
        for (int t = 0; t < kTh; ++t) xw[t] = make_float2(0.0f, 0.0f);
        for (int q = 0; q < ntaps; ++q) {
            const float2 tap = tap_s[q];
            const float2* col = xs + halo + i - shift_s[q];
#pragma unroll
            for (int t = 0; t < kTh; ++t) xw[t] = cfma(col[t * width], tap, xw[t]);
        }
#pragma unroll
        for (int t = 0; t < kTh; ++t) {
            mag[side][t] = cmag(xs[t * width + halo + i]);
            magw[side][t] = cmag(xw[t]);
        }
        __syncthreads();
    }

    const int c = c0 + i;
    if (c >= k) return;
#pragma unroll
    for (int t = 0; t < kTh; ++t) {
        const int b = b0 + t;
        if (b >= hops) break;
        const long long o = (lane * hops + b) * (long long)k + c;
        fa[o] = __fadd_rn(mag[0][t], mag[1][t]);
        hs[o] = fmaxf(mag[0][t], mag[1][t]);
        faw[o] = __fadd_rn(magw[0][t], magw[1][t]);
    }
}

}  // namespace

extern "C" int grl_overlap_spectra(const float* g, const float* rho,
                                   const int* sigma, const int* shifts,
                                   const float* taps, float* fa, float* faw,
                                   float* hs, int lanes, int rows_g, int hops,
                                   int f, int k, int ntaps, int halo,
                                   void* stream) {
    if (lanes <= 0 || hops <= 0) return 0;
    if (ntaps < 1 || ntaps > kMaxTaps || halo < 0 || rows_g < hops + kR - 1 ||
        k > f)
        return cudaErrorInvalidValue;
    const size_t smem = (size_t)kTh * (kBt + 2 * halo) * sizeof(float2);
    cudaError_t err = cudaFuncSetAttribute(
        overlap_spectra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((k + kBt - 1) / kBt, (hops + kTh - 1) / kTh, lanes);
    overlap_spectra_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(g), reinterpret_cast<const float2*>(rho),
        sigma, shifts, reinterpret_cast<const float2*>(taps), fa, faw, hs,
        rows_g, hops, f, k, ntaps, halo);
    return (int)cudaGetLastError();
}
