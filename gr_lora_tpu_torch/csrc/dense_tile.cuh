// The block tile shared by the direct-spectra kernel (K4b / K4,
// direct_spectra.cu) and the chunk-spectra kernel (K6, chunk_spectra.cu):
// the two compute the same function, fa / faw / hs of every hop frame as one
// bf16 product against the weights of four complex components, from
// different inputs (raw iq vs hop-period chunk rows).
//
// A block owns kFt frames x kBins bins, i.e. the kCols = 8 x kBins weight
// columns [c0 re | c0 im | ... | c3 re | c3 im] of one bin tile,
// c = {plain, Kaiser} x {bins [0, K), bins [F-K, F)}.  Eight warps: 4 groups
// of 32 frames x 2 halves of 64 columns, each holding 2 x 4 WMMA m16n16k16
// accumulators (bf16 fragments, f32 accumulate).  After the contraction the
// f32 product tile is staged in shared memory and folded there:
//   m_c = |y_c|;  fa = m0 + m1,  hs = max(m0, m1),  faw = m2 + m3,
// each product and sum rounded on its own, as the plain versions round them.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace dense_tile {

using namespace nvcuda;

constexpr int kFt = 128;           // frames per block (A rows)
constexpr int kBins = 16;          // bins per block
constexpr int kCols = 8 * kBins;   // weight columns per block
constexpr int kKc = 32;            // contraction rows per staged step
constexpr int kThreads = 256;      // 8 warps: 4 (32-frame group) x 2 (64 cols)
constexpr int kLdb = kCols + 8;    // bf16 B tile stride, multiple of 8
constexpr int kLdc = kCols + 4;    // f32 product tile stride, multiple of 4
constexpr size_t kSmemC = (size_t)kFt * kLdc * 4;

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float cabs_rn(float re, float im) {
    return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

__device__ __forceinline__ void zero(Acc (&acc)[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// One kKc-deep step of this warp's 32 frames x 64 columns.  `a` is the
// block's A tile (frame rows, row stride lda; `a` and every 16th row must be
// 32-byte aligned, as WMMA loads need), `b` the kKc x kCols B tile.
__device__ __forceinline__ void mma_step(Acc (&acc)[2][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b) {
    const int warp = threadIdx.x >> 5;
    const int wr = warp >> 1, wc = warp & 1;
#pragma unroll
    for (int kk = 0; kk < kKc; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(af[i], a + (wr * 32 + i * 16) * lda + kk,
                                   lda);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::load_matrix_sync(bf[j], b + kk * kLdb + wc * 64 + j * 16,
                                   kLdb);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
}

// Stage the block's product tile in `cs` (kSmemC bytes of shared memory no
// longer read by any warp) and write the folds of frames f0.. of `lane`.
__device__ __forceinline__ void store_fold(Acc (&acc)[2][4], float* cs,
                                           float* __restrict__ fa,
                                           float* __restrict__ faw,
                                           float* __restrict__ hs,
                                           long long lane, int frames, int f0,
                                           int tile, int k) {
    const int warp = threadIdx.x >> 5;
    const int wr = warp >> 1, wc = warp & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::store_matrix_sync(
                cs + (wr * 32 + i * 16) * kLdc + wc * 64 + j * 16, acc[i][j],
                kLdc, wmma::mem_row_major);
    __syncthreads();

    for (int e = threadIdx.x; e < kFt * kBins; e += kThreads) {
        const int fr = e / kBins, b = e % kBins;
        const int f = f0 + fr;
        if (f >= frames) continue;
        const float* row = cs + fr * kLdc + b;
        float m[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
            m[c] = cabs_rn(row[(2 * c) * kBins], row[(2 * c + 1) * kBins]);
        const long long o =
            (lane * frames + f) * (long long)k + tile * kBins + b;
        fa[o] = __fadd_rn(m[0], m[1]);
        hs[o] = fmaxf(m[0], m[1]);
        faw[o] = __fadd_rn(m[2], m[3]);
    }
}

}  // namespace dense_tile
