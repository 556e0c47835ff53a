// Direct pyramid spectra: the fa / faw / hs folds of every overlapped hop
// frame as ONE bf16 product per frame, from the raw [T, 2] IQ of each lane.
//
// Replaces gr_lora_tpu/ops/pallas_direct.py `make_direct_spectra` /
// `_kernel` (K4b, whole), and is the front end of `make_direct_peaks` /
// `_peaks_kernel` (K4: the same product and folds; its peak search is
// csrc/peak_topm.cu).  Per frame f (samples x = iq[f*hop .. f*hop + n)):
//
//   y[8K]  = bf16([Re x | Im x]) @ W,   W = bf16 [2n, 8K]   (f32 accumulate)
//   W's columns, 16 bins at a time: [c0 re | c0 im | ... | c3 re | c3 im],
//   c = {plain, Kaiser} x {bins [0, K), bins [F-K, F)}, each the complex
//   weight down[s] (* kaiser[s]) * exp(-2 pi i s b / F) rounded once to bf16
//   m_c    = |y_c|;  fa = m0 + m1,  hs = max(m0, m1),  faw = m2 + m3
//
// The top band is [F-K, F) for every p (the fold landmine, SURVEY §7).
// Numeric class of the TPU kernel: the RAW samples are rounded to bf16 (not
// the dechirped ones, as in the rDFT kernel) and each weight once, and the
// products accumulate in f32 (tensor-core WMMA m16n16k16, bf16 fragments).
//
// Bound on the card: tensor-core operations (16 n K MACs a frame, twice the
// rDFT kernel's); W (32 MB at SF8 x ff 8) stays in L2.  Design: a block owns
// 128 frames x 16 bins (the 128 columns of one W tile).  The TPU kernel's
// [frames, 2n] bf16 frame matrix is never written: each block builds its A
// tile from the raw iq at f*hop as it goes (real parts for the first n rows
// of W, imaginary parts for the rest), and the 128 x 128 f32 product tile is
// staged in shared memory and folded there, so only fa / faw / hs reach
// device memory.  The magnitudes and folds round each product and sum on
// their own, as the plain version does.  The block tile, the WMMA step and
// the fold are dense_tile.cuh's, shared with K6 (chunk_spectra.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"

using namespace dense_tile;

namespace {

constexpr int kLda = kKc + 8;      // bf16, multiple of 8
constexpr size_t kSmemAB =
    (size_t)kFt * kLda * 2 + (size_t)kKc * kLdb * 2;
constexpr size_t kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

__global__ void __launch_bounds__(kThreads)
direct_spectra_kernel(const float2* __restrict__ iq,
                      const __nv_bfloat16* __restrict__ w,
                      float* __restrict__ fa, float* __restrict__ faw,
                      float* __restrict__ hs, int t_len, int frames, int n,
                      int hop, int k) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* bs = as + kFt * kLda;
    float* cs = reinterpret_cast<float*>(smem);        // after the k loop

    const int f0 = blockIdx.x * kFt;
    const int tile = blockIdx.y;                       // bins tile*16 ..
    const long long lane = blockIdx.z;
    const float2* x = iq + lane * (long long)t_len;
    const long long wcols = 8LL * k;
    const __nv_bfloat16* wt = w + (long long)tile * kCols;

    Acc acc[2][4];
    zero(acc);
    for (int k0 = 0; k0 < 2 * n; k0 += kKc) {
        // A: the raw sample component of W's rows k0.., one bf16 rounding.
        const int part = k0 >= n;                      // 0 re, 1 im
        const int s0 = k0 - part * n;
        for (int e = threadIdx.x; e < kFt * kKc; e += kThreads) {
            const int fr = e / kKc, s = e % kKc;
            const int f = f0 + fr;
            const long long pos = (long long)f * hop + s0 + s;
            float v = 0.0f;
            if (f < frames && pos < t_len) {
                const float2 z = x[pos];
                v = part ? z.y : z.x;
            }
            as[fr * kLda + s] = __float2bfloat16(v);
        }
        // B: rows k0.. of this block's 128 contiguous W columns, 16 B a load.
        for (int e = threadIdx.x; e < kKc * (kCols / 8); e += kThreads) {
            const int kr = e / (kCols / 8), c8 = e % (kCols / 8);
            *reinterpret_cast<uint4*>(bs + kr * kLdb + c8 * 8) =
                *reinterpret_cast<const uint4*>(wt + (k0 + kr) * wcols + c8 * 8);
        }
        __syncthreads();
        mma_step(acc, as, kLda, bs);
        __syncthreads();
    }
    store_fold(acc, cs, fa, faw, hs, lane, frames, f0, tile, k);
}

}  // namespace

extern "C" int grl_direct_spectra(const float* iq, const void* w, float* fa,
                                  float* faw, float* hs, int lanes, int t_len,
                                  int frames, int n, int hop, int k,
                                  void* stream) {
    if (lanes <= 0 || frames <= 0) return 0;
    if (n % kKc || k % kBins || k / kBins > 65535)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        direct_spectra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((frames + kFt - 1) / kFt, k / kBins, lanes);
    direct_spectra_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(iq),
        reinterpret_cast<const __nv_bfloat16*>(w), fa, faw, hs, t_len, frames,
        n, hop, k);
    return (int)cudaGetLastError();
}
