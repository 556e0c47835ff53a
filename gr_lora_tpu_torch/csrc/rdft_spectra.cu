// rDFT pyramid spectra: the fa / faw / hs folds of every overlapped hop
// frame, from the raw [T, 2] IQ of each lane.
//
// Replaces gr_lora_tpu/ops/pallas_rdft.py `make_rdft_spectra` / `_kernel`
// (K3, whole), and is the front end of `make_rdft_peaks` / `_peaks_kernel`
// (K1: these dots and the recombination; its peak search is
// csrc/peak_topm.cu).  Per frame f (samples iq[f*hop .. f*hop + n)):
//
//   u      = iq * downchirp          (f32), and u * kaiser     (f32)
//   [R | I] = bf16(u) @ W,  W = bf16 [n, 2*kp] = [cos | -sin] over bins 0..K
//   |X(c)|  from (Re R - Im I, Im R + Re I);  |X(-c)| from the conjugate pair
//   fa[c]  = |X(c)| + |X(c-K)|,  hs = max of the two,  faw likewise windowed
//
// with |X(c-K)| = |X(-(K-c))| read at column K-c of the SAME positive-band
// product.  Numeric class of the TPU kernel: each dot operand is rounded
// once to bf16 and the products accumulate in f32 (tensor-core WMMA
// m16n16k16 with bf16 fragments).  The TPU kernel's lane-reversal matmul
// and hop-row relayout do not exist here: column K-c is indexed directly,
// and each block reads its frames straight from the iq at offset f*hop.
//
// Bound on the card: tensor-core operations (8*n*(K+1) MACs a frame);
// iq and W stream from L2.  Design: a block owns 32 frames x one PAIR of
// 32-column tiles, S1 = [b0, b0+32) and its mirror S2 = {K-b0-j}; from
// the two it writes bins b0+j (<= K/2) AND bins K-b0-j (> K/2), so every
// column of W is multiplied once per frame tile (one extra pair tile
// covers the middle bin K/2).  The 4 x 128 product tile never leaves the
// SM: it is staged in shared memory and folded there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kFt = 32;            // frames per block
constexpr int kBt = 32;            // columns per tile of the pair
constexpr int kRows = 4 * kFt;     // A rows: [ur | ui | ur*win | ui*win]
constexpr int kCols = 4 * kBt;     // B cols: [cos S1 | sin S1 | cos S2 | sin S2]
constexpr int kKc = 32;            // samples per k step
constexpr int kThreads = 256;      // 8 warps: 4 (component) x 2 (column half)
constexpr int kLda = kKc + 8;      // bf16, multiple of 8
constexpr int kLdb = kCols + 8;    // bf16, multiple of 8
constexpr int kLdc = kCols + 4;    // f32, multiple of 4
constexpr size_t kSmemAB =
    (size_t)kRows * kLda * 2 + (size_t)kKc * kLdb * 2;
constexpr size_t kSmemC = (size_t)kRows * kLdc * 4;
constexpr size_t kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

__device__ __forceinline__ void mags(const float* c, int fr, int col,
                                     int comp0, float& pos, float& neg) {
    // (R, I) of component pair comp0 (re part), comp0 + 1 (im part).
    const float* r = c + (comp0 * kFt + fr) * kLdc;
    const float* i = c + ((comp0 + 1) * kFt + fr) * kLdc;
    const float rre = r[col], rim = r[col + kBt];
    const float ire = i[col], iim = i[col + kBt];
    const float xre = rre - iim, xim = rim + ire;      // X(c)
    const float gre = rre + iim, gim = ire - rim;      // X(-c)
    pos = sqrtf(xre * xre + xim * xim);
    neg = sqrtf(gre * gre + gim * gim);
}

__global__ void __launch_bounds__(kThreads)
rdft_spectra_kernel(const float2* __restrict__ iq,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ consts, float* __restrict__ fa,
                    float* __restrict__ faw, float* __restrict__ hs, int t_len,
                    int frames, int n, int hop, int k, int kp) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* bs = as + kRows * kLda;
    float* cs = reinterpret_cast<float*>(smem);        // after the k loop

    const int f0 = blockIdx.x * kFt;
    const int b0 = blockIdx.y * kBt;
    const long long lane = blockIdx.z;
    const float2* x = iq + lane * (long long)t_len;
    const float* dr = consts;
    const float* di = consts + n;
    const float* win = consts + 2 * n;
    const int warp = threadIdx.x >> 5;
    const int wr = warp >> 1;          // component (A row group of 32)
    const int wc = warp & 1;           // column half (64 of 128)

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < n; k0 += kKc) {
        // A: dechirp (and window) in f32, one bf16 rounding per operand.
        for (int e = threadIdx.x; e < kFt * kKc; e += kThreads) {
            const int fr = e / kKc, s = e % kKc;
            const int f = f0 + fr;
            const long long pos = (long long)f * hop + k0 + s;
            float xr = 0.0f, xi = 0.0f;
            if (f < frames && pos < t_len) {
                const float2 v = x[pos];
                xr = v.x;
                xi = v.y;
            }
            const float c_r = dr[k0 + s], c_i = di[k0 + s], wn = win[k0 + s];
            const float ur = xr * c_r - xi * c_i;
            const float ui = xr * c_i + xi * c_r;
            as[(0 * kFt + fr) * kLda + s] = __float2bfloat16(ur);
            as[(1 * kFt + fr) * kLda + s] = __float2bfloat16(ui);
            as[(2 * kFt + fr) * kLda + s] = __float2bfloat16(ur * wn);
            as[(3 * kFt + fr) * kLda + s] = __float2bfloat16(ui * wn);
        }
        // B: the pair's columns of W, S2 in mirrored order.
        for (int e = threadIdx.x; e < kKc * kCols; e += kThreads) {
            const int kr = e / kCols, c = e % kCols;
            const int grp = c / kBt, j = c % kBt;
            int col = grp < 2 ? b0 + j : k - b0 - j;
            if (grp & 1) col += kp;
            bs[kr * kLdb + c] = w[(long long)(k0 + kr) * (2 * kp) + col];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kKc; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> af[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> bf[4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(af[i], as + (wr * 32 + i * 16) * kLda + kk,
                                       kLda);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                wmma::load_matrix_sync(bf[j], bs + kk * kLdb + wc * 64 + j * 16,
                                       kLdb);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * kLdc + wc * 64 + j * 16,
                                    acc[i][j], kLdc, wmma::mem_row_major);
    __syncthreads();

    const int half = k / 2;
    for (int e = threadIdx.x; e < kFt * kBt; e += kThreads) {
        const int fr = e / kBt, j = e % kBt;
        const int f = f0 + fr;
        if (f >= frames) continue;
        float p1u, q1u, p2u, q2u, p1w, q1w, p2w, q2w;
        mags(cs, fr, j, 0, p1u, q1u);              // S1, plain
        mags(cs, fr, 2 * kBt + j, 0, p2u, q2u);    // S2, plain
        mags(cs, fr, j, 2, p1w, q1w);              // S1, windowed
        mags(cs, fr, 2 * kBt + j, 2, p2w, q2w);    // S2, windowed
        const long long o = (lane * frames + f) * (long long)k;
        const int c1 = b0 + j;                     // primary bin from S1
        if (c1 <= half) {
            fa[o + c1] = p1u + q2u;
            hs[o + c1] = fmaxf(p1u, q2u);
            faw[o + c1] = p1w + q2w;
        }
        const int c2 = k - b0 - j;                 // primary bin from S2
        if (c2 > half && c2 < k) {
            fa[o + c2] = p2u + q1u;
            hs[o + c2] = fmaxf(p2u, q1u);
            faw[o + c2] = p2w + q1w;
        }
    }
}

}  // namespace

extern "C" int grl_rdft_spectra(const float* iq, const void* w,
                                const float* consts, float* fa, float* faw,
                                float* hs, int lanes, int t_len, int frames,
                                int n, int hop, int k, int kp, void* stream) {
    if (lanes <= 0 || frames <= 0) return 0;
    if (n % kKc || k % (2 * kBt) || kp < k + 1)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        rdft_spectra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((frames + kFt - 1) / kFt, k / (2 * kBt) + 1, lanes);
    rdft_spectra_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(iq),
        reinterpret_cast<const __nv_bfloat16*>(w), consts, fa, faw, hs, t_len,
        frames, n, hop, k, kp);
    return (int)cudaGetLastError();
}
