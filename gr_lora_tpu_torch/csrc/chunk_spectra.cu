// Chunk-row pyramid spectra: the fa / faw / hs folds of every overlapped hop
// frame, from hop-period chunk rows, as eight bf16 products per frame.
//
// Replaces gr_lora_tpu/ops/pallas_frontend.py `make_pallas_spectra` /
// `_kernel` (K6, backend "pallas").  Input: chunk rows f32 [lanes, C, w],
// row r = [re(hop r) | im(hop r) | zero pad to w] (ops/chunk_spectra.
// row_chunks); frame f is rows f .. f+R-1 laid end to end (R = 8, length
// R*w), rounded to bf16.  Weights: the eight bf16 matrices [R*w, K] of the
// JAX kernel (its `_component_weights`, rows in the chunk layout), matrix
// 2c the real and 2c+1 the imaginary part of component c = {plain, Kaiser}
// x {bins [0, K), bins [F-K, F)}:
//
//   y_j[f] = bf16(frame f) @ W_j   (f32 accumulate),  m_c = |y_2c + i y_2c+1|
//   fa = m0 + m1,  hs = max(m0, m1),  faw = m2 + m3
//
// It computes K4b's function (direct_spectra.cu) from another input, and
// shares its block tile, WMMA step and fold (dense_tile.cuh); it is its own
// entry point with its own launch count.
//
// Bound on the card: tensor-core operations (8 products of 2 R*w K
// operations a frame; at SF8 x ff 8 the weights, 32 MB, stay in L2).
// Design: a block owns kFt = 128 frames x 16 bins.  Because frame f is the
// contiguous rows f .. f+R-1, the A operand of contraction rows
// [r*w + c0, r*w + c0 + 32) is the 128 x 32 sub-tile of the chunk matrix at
// rows f0 + r .., columns c0 ..: the block stages, per column step c0, the
// kFt + R - 1 chunk rows of its frame tile once in shared memory as bf16
// (the overlap-save behind the TPU kernel's R shifted DMAs), and each of the
// R row shifts reads its A fragments from that staging at row offset r with
// no frame matrix built.  The TPU kernel's 128-lane pad of w is kept (the
// weights are the JAX kernel's, bit for bit); its frame-tile padding of the
// frame count is dropped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"

using namespace dense_tile;

namespace {

constexpr int kR = 8;                  // frames per symbol (n / hop)
constexpr int kArows = kFt + kR - 1;   // staged chunk rows per block
// bf16 A stride: a multiple of 16, so that the fragment rows at every shift
// r (any row) start 32-byte aligned.
constexpr int kLda = kKc + 16;
constexpr size_t kSmemAB =
    (size_t)kArows * kLda * 2 + (size_t)kKc * kLdb * 2;
constexpr size_t kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

__global__ void __launch_bounds__(kThreads)
chunk_spectra_kernel(const float* __restrict__ chunks,
                     const __nv_bfloat16* __restrict__ w,
                     float* __restrict__ fa, float* __restrict__ faw,
                     float* __restrict__ hs, int rows_c, int width,
                     int frames, int k) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* bs = as + kArows * kLda;
    float* cs = reinterpret_cast<float*>(smem);        // after the k loop

    const int f0 = blockIdx.x * kFt;
    const int tile = blockIdx.y;                       // bins tile*16 ..
    const long long lane = blockIdx.z;
    const float* x = chunks + lane * rows_c * (long long)width;
    const long long wrows = (long long)kR * width;     // rows of each W_j
    const __nv_bfloat16* wt = w + (long long)tile * kBins;

    Acc acc[2][4];
    zero(acc);
    for (int c0 = 0; c0 < width; c0 += kKc) {
        // A: columns c0.. of chunk rows f0 .. f0 + kArows - 1, one bf16
        // rounding each, staged once for all R shifts.
        for (int e = threadIdx.x; e < kArows * kKc; e += kThreads) {
            const int ar = e / kKc, s = e % kKc;
            const int g = f0 + ar;
            const float v = g < rows_c ? x[(long long)g * width + c0 + s] : 0.0f;
            as[ar * kLda + s] = __float2bfloat16(v);
        }
        for (int r = 0; r < kR; ++r) {
            // B: rows r*w + c0.. of the 8 matrices' 16 columns of this
            // tile, as [W_0 | W_1 | ... | W_7] x 16 bins, 16 B a load.
            for (int e = threadIdx.x; e < kKc * 16; e += kThreads) {
                const int kr = e / 16, q = e % 16;
                const int j = q >> 1, half = q & 1;
                const long long row = (long long)r * width + c0 + kr;
                *reinterpret_cast<uint4*>(bs + kr * kLdb + j * kBins +
                                          half * 8) =
                    *reinterpret_cast<const uint4*>(
                        wt + (j * wrows + row) * k + half * 8);
            }
            __syncthreads();
            mma_step(acc, as + r * kLda, kLda, bs);
            __syncthreads();
        }
    }
    store_fold(acc, cs, fa, faw, hs, lane, frames, f0, tile, k);
}

}  // namespace

extern "C" int grl_chunk_spectra(const float* chunks, const void* w,
                                 float* fa, float* faw, float* hs, int lanes,
                                 int rows_c, int width, int frames, int k,
                                 void* stream) {
    if (lanes <= 0 || frames <= 0) return 0;
    if (width % kKc || k % kBins || k / kBins > 65535 ||
        rows_c < frames + kR - 1)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        chunk_spectra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((frames + kFt - 1) / kFt, k / kBins, lanes);
    chunk_spectra_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        chunks, reinterpret_cast<const __nv_bfloat16*>(w), fa, faw, hs,
        rows_c, width, frames, k);
    return (int)cudaGetLastError();
}
