// One step of the demodulator FSM (models/demodulator._machine's body) for
// every lane: three kernels around the two FFTs the step takes through
// cuFFT (torch.fft.fft, launched by ops/fsm_step.py between them).
//
// These kernels replace no Pallas kernel: the JAX package steps its FSM in
// a lax.while_loop of XLA ops.  They were added because eager PyTorch
// spends ~205 launches on one step, and in the triggered receiver the
// CUDA-graph replays of those launches held 86 % of a feed: the step is
// latency-bound, one graph node after another, not bound by its work.
//
// A step, in stream order (L lanes, n samples a window, F = fft_factor * n,
// K = fft_factor * 2^sf bins a band):
//   fsm_win     each lane in S_SFD_SYNC: its window at ptr times the down
//               plan's chirp, into the down buffer [L, F]
//   cuFFT       the down buffer, batch L (the plain body's "down" call)
//   fsm_sfd     each active lane: its window times the up plan's chirp into
//               row 0 of the up buffer [L, 2, F]; a lane in S_SFD_SYNC also
//               folds the down bands (didx, dval), takes nc_sfd and
//               cfo_start, and writes its CFO window times the up chirp
//               into row 1
//   cuFFT       the up buffer, batch 2 L (the plain body's "up" call on the
//               window and the CFO window)
//   fsm_update  each active lane: the up folds (midx, mval; sval, smean for
//               S_DETECT_PREAMBLE; cidx for S_SFD_SYNC) and the whole
//               transition, in place on the loop's state tensors
// The buffers' tails past n are zeroed once, when the loop is built, and
// never written: they are the FFT's zero padding.  Both FFTs take the
// plain body's batches in its layout, so cuFFT sees the same transforms.
//
// The results are the plain body's on the card (tests/
// test_torch_kernels_cuda.py holds them to it after every step):
//   - the dechirp product is c10::complex's (a c - b d, a d + b c), written
//     as ATen's kernel writes it, so nvcc forms it alike;
//   - every other f32 operation rounds on its own, as a chain of eager ATen
//     kernels does (the __f*_rn intrinsics: no FMA contraction): |lo| +
//     |hi| over bins [0, K) and [F - K, F), the PHASE search's rotated
//     sums, and the scalar arithmetic, where a division by a Python number
//     is ATen's multiplication by its f32 reciprocal;
//   - every argmax takes the first index of the largest value, as
//     torch.argmax does; PHASE's over the flattened [k, K] array;
//   - the LDR integrator's sums are exact (multiples of 1 / fft_factor),
//     so its block-wide scan equals torch.cumsum;
//   - the mean of the ABS fold (snr's denominator) is summed in f64 and
//     lies within a few f32 ulps of ATen's f32 reduction.
// A lane that is not active (ptr + reach past the buffer, or it at
// max_iters) is left as it is, as the plain body leaves it.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <utility>

namespace fsm {

// State codes (models/demodulator.py).
constexpr int RESET = 0, PREFILL = 1, DETECT = 2, SFD = 3, HEADER = 4,
              PAYLOAD = 5, OUT = 6;
// cfg.peak_search (config.PeakSearch).
constexpr int ABS = 0, PHASE = 1, B = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_PRE = 16;
constexpr int WIN_THREADS = 256;

// The loop's state tensors (ops/fsm_step.FsmArgs mirrors this layout),
// its buffers, and the configuration's static numbers.
struct Args {
    int* ptr; int* st; int* hist; int* hist_len; int* sync_cnt;
    float* cfo; float* snr; float* syms; int* sym_cnt; int* pkt_sym_len;
    uint8_t* hdr_received; uint8_t* hdr_valid; int* pkt_start;
    const int* base; int* out_syms; int* out_len; int* out_pos;
    float* out_snr; int* out_cnt; int* it;
    const float2* iq;        // [L, buf_len]
    const float2* chirp_dn;  // the down plan's modulation [n]
    const float2* chirp_up;  // the up plan's modulation [n]
    const float2* rot;       // the PHASE search's rotations [phase_k]
    float2* down_in;         // [L, F]
    const float2* down_out;  // its FFT
    float2* up_in;           // [L, 2, F]
    const float2* up_out;    // its FFT
    int* nc_sfd;             // [L], fsm_sfd -> fsm_update
    float* dval;             // [L]
    int lanes, buf_len, reach, max_iters;
    int n, fft, bins, ms, mp;
    int sf, p, fac, nsym, lookback, drift_max, implicit_psl, npre, recovery;
    int peak_search, phase_k, explicit_header, ldr;
};

// A fold's candidate: the value and its (flattened) index.
struct Cand {
    float v;
    int i;
};

__device__ __forceinline__ bool better(Cand a, Cand b) {
    return a.v > b.v || (a.v == b.v && a.i < b.i);
}

__device__ __forceinline__ int code_of(const Args& a, int l) {
    const bool active = a.ptr[l] + a.reach <= a.buf_len &&
                        a.it[l] < a.max_iters;
    return active ? a.st[l] : -1;
}

// A window's start clamped into [0, buf_len - n] (fsm_loop.windows).
__device__ __forceinline__ int clamp_start(int s, int buf_len, int n) {
    return s < 0 ? 0 : (s > buf_len - n ? buf_len - n : s);
}

// z * m of two complex64 values, as c10::complex<float>::operator*= forms
// it (the expression is left to the compiler's contraction, as in ATen).
__device__ __forceinline__ float2 dechirp(float2 z, float2 m) {
    const float a = z.x, b = z.y, c = m.x, d = m.y;
    float2 r;
    r.x = a * c - b * d;
    r.y = a * d + b * c;
    return r;
}

// The window at `start` of lane l times `chirp`, into `dst`, by the
// threads [t, t + stride) of the grid.
__device__ __forceinline__ void dechirp_window(const Args& a, int l,
                                               int start, const float2* chirp,
                                               float2* dst, int t,
                                               int stride) {
    const float2* x = a.iq + (size_t)l * a.buf_len +
                      clamp_start(start, a.buf_len, a.n);
    for (int j = t; j < a.n; j += stride) dst[j] = dechirp(x[j], chirp[j]);
}

__device__ __forceinline__ float cmag(float2 v) {
    return __fsqrt_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
}

// torch.remainder of floats, and the FSM's floor modulo (_fpmod).
__device__ __forceinline__ float frem(float x, float m) {
    float r = fmodf(x, m);
    if (r != 0.f && ((m < 0.f) != (r < 0.f))) r = __fadd_rn(r, m);
    return r;
}

__device__ __forceinline__ float fpmod(float x, float m) {
    return frem(__fadd_rn(frem(x, m), m), m);
}

__device__ __forceinline__ int irem(int x, int m) {
    int r = x % m;
    if (r != 0 && ((m < 0) != (r < 0))) r += m;
    return r;
}

__device__ __forceinline__ int ipmod(int x, int m) {
    return irem(irem(x, m) + m, m);
}

// Floor division of ints by a positive divisor.
__device__ __forceinline__ int ifloordiv(int x, int d) {
    return x / d - (x % d != 0 && x < 0);
}

// ---- block-wide reductions: every thread of the block calls each one
// with the same arguments and gets the block's result.

__device__ __forceinline__ Cand shfl_cand(Cand c, int off) {
    unsigned long long w = ((unsigned long long)(unsigned)c.i << 32) |
                           __float_as_uint(c.v);
    w = __shfl_xor_sync(FULL, w, off);
    return {__uint_as_float((unsigned)w), (int)(w >> 32)};
}

__device__ __forceinline__ Cand warp_best(Cand c) {
    for (int off = 16; off > 0; off >>= 1) {
        const Cand o = shfl_cand(c, off);
        if (better(o, c)) c = o;
    }
    return c;
}

__device__ Cand block_best(Cand c, Cand* part) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    c = warp_best(c);
    if (lane == 0) part[warp] = c;
    __syncthreads();
    c = lane < (int)(blockDim.x >> 5) ? part[lane] : Cand{-1.f, INT_MAX};
    c = warp_best(c);
    __syncthreads();
    return c;
}

// (max, sum) of the block's (float, double) pairs.
__device__ void block_max_sum(float& mx, double& sum, float* fpart,
                              double* dpart) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        sum += __shfl_xor_sync(FULL, sum, off);
    }
    if (lane == 0) {
        fpart[warp] = mx;
        dpart[warp] = sum;
    }
    __syncthreads();
    const bool in = lane < (int)(blockDim.x >> 5);
    mx = in ? fpart[lane] : 0.f;
    sum = in ? dpart[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        sum += __shfl_xor_sync(FULL, sum, off);
    }
    __syncthreads();
}

// Inclusive scan of v over the block's threads in order; `total` is the
// block's sum.
__device__ float block_scan(float v, float* part, float& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v = __fadd_rn(v, u);
    }
    if (lane == 31) part[warp] = v;
    __syncthreads();
    float before = 0.f, all = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
        if (w < warp) before = __fadd_rn(before, part[w]);
        all = __fadd_rn(all, part[w]);
    }
    __syncthreads();
    total = all;
    return __fadd_rn(v, before);
}

// ---- the folds (ops/dechirp.band_peak) of one row of a lane's spectrum:
// bins [0, K) (lo) and [F - K, F) (hi), two bins a float4.

template <int MODE>
__device__ __forceinline__ void fold_bin(const Args& a, float2 lo, float2 hi,
                                         int j, bool stats, Cand& best,
                                         float& mx, double& sum) {
    if (MODE == ABS || stats) {
        const float v = __fadd_rn(cmag(lo), cmag(hi));
        if (MODE == ABS && v > best.v) best = {v, j};
        if (stats) {
            mx = fmaxf(mx, v);
            sum += (double)v;
        }
    }
    if (MODE != ABS) {
        for (int r = 0; r < a.phase_k; ++r) {
            const float2 w = a.rot[r];
            const float sr = __fadd_rn(
                __fsub_rn(__fmul_rn(lo.x, w.x), __fmul_rn(lo.y, w.y)), hi.x);
            const float si = __fadd_rn(
                __fadd_rn(__fmul_rn(lo.x, w.y), __fmul_rn(lo.y, w.x)), hi.y);
            const Cand c = {__fsqrt_rn(__fadd_rn(__fmul_rn(sr, sr),
                                                 __fmul_rn(si, si))),
                            r * a.bins + j};
            if (better(c, best)) best = c;
        }
    }
}

// The block's fold of `row`: its argmax under cfg.peak_search (the bin,
// modulo K, and the value) and, with `stats`, the ABS fold's max and sum.
template <int MODE>
__device__ Cand fold_row(const Args& a, const float2* row, bool stats,
                         float& mx, double& sum, Cand* part) {
    Cand best = {-1.f, INT_MAX};
    mx = 0.f;
    sum = 0.0;
    const float4* lo = reinterpret_cast<const float4*>(row);
    const float4* hi = reinterpret_cast<const float4*>(row + (a.fft - a.bins));
    const int pairs = a.bins / 2, stride = blockDim.x;
    for (int q = threadIdx.x; q < pairs; q += stride) {
        const float4 l4 = lo[q], h4 = hi[q];
        fold_bin<MODE>(a, make_float2(l4.x, l4.y), make_float2(h4.x, h4.y),
                       2 * q, stats, best, mx, sum);
        fold_bin<MODE>(a, make_float2(l4.z, l4.w), make_float2(h4.z, h4.w),
                       2 * q + 1, stats, best, mx, sum);
    }
    best = block_best(best, part);
    best.i %= a.bins;
    return best;
}

// The LDR bin-drift integrator (models/demodulator.compensate) of a lane's
// syms[0, width), `count` of them live, into out[0, width).
__device__ void compensate(const Args& a, const float* syms, int count,
                           int width, int* out, float* part) {
    const float nsym = (float)a.nsym;
    float carry = 0.f;
    for (int base = 0; base < width; base += blockDim.x) {
        const int j = base + threadIdx.x;
        const bool in = j < width, live = j < count;
        const float s = in ? syms[j] : 0.f;
        float drift = 0.f;
        if (a.ldr && live) {
            drift = fpmod(__fsub_rn(s, j == 0 ? 1.f : syms[j - 1]), 4.f);
            drift = drift < 2.f ? drift : __fsub_rn(drift, 4.f);
        }
        float total;
        const float inc = __fadd_rn(block_scan(drift, part, total), carry);
        carry = __fadd_rn(carry, total);
        const float v = a.ldr ? __fsub_rn(s, inc) : s;
        if (in)
            out[j] = live ? (int)fpmod(
                                floorf(__fadd_rn(fpmod(v, nsym), 0.5f)), nsym)
                          : 0;
    }
}

__device__ int header_checksum(int len, int cr_crc) {
    int a[4], b[4], c[4];
    for (int k = 0; k < 4; ++k) {
        a[k] = (len >> (4 + k)) & 1;
        b[k] = (len >> k) & 1;
        c[k] = (cr_crc >> k) & 1;
    }
    return ((a[0] ^ a[1] ^ a[2] ^ a[3]) << 4) |
           ((a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3) |
           ((a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2) |
           ((a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1) |
           (a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]);
}

// The explicit-header parse of 8 compensated symbols (_parse_header):
// valid, and the packet's symbol count.
__device__ void parse_header(const Args& a, const int* comp8, bool& valid,
                             int& psl) {
    const int ppm = a.sf - 2;
    int g[8], nib[5];
    for (int i = 0; i < 8; ++i) {
        const int v = comp8[i] >> 2;    // floor: comp8 lies in [0, 2^sf)
        g[i] = v ^ (v >> 1);
    }
    for (int y = 0; y < 5; ++y) {
        int cw = 0;
        for (int i = 0; i < 8; ++i)
            cw |= ((g[i] >> ipmod(y - i, ppm)) & 1) << i;
        const int p1 = __popc(cw & 0x2E) & 1, p2 = __popc(cw & 0x4B) & 1,
                  p3 = __popc(cw & 0x17) & 1;
        const int fix[8] = {0, 0, 0, 0x08, 0, 0x04, 0x01, 0x02};
        nib[y] = (cw ^ fix[(p3 << 2) | (p2 << 1) | p1]) & 0xF;
    }
    const int plen = (nib[0] << 4) | nib[1], crc = nib[2] & 1,
              cr = nib[2] >> 1, cks = (nib[3] << 4) | nib[4];
    valid = cks == header_checksum(plen, nib[2] & 0xF);
    const int num = 2 * plen - a.sf + 7 + 4 * crc,
              den = a.sf - 2 * a.ldr;
    const int sym = (4 + cr) * -ifloordiv(-num, den);   // ceil(num / den)
    psl = 8 + (sym > 0 ? sym : 0);
}

// ---- the kernels.

__global__ void __launch_bounds__(WIN_THREADS) fsm_win(const Args a) {
    const int l = blockIdx.y;
    if (code_of(a, l) != SFD) return;
    dechirp_window(a, l, a.ptr[l], a.chirp_dn, a.down_in + (size_t)l * a.fft,
                   blockIdx.x * blockDim.x + threadIdx.x,
                   gridDim.x * blockDim.x);
}

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS) fsm_sfd(const Args a) {
    __shared__ Cand part[32];
    const int l = blockIdx.x;
    const int code = code_of(a, l);
    if (code < 0) return;
    float2* up = a.up_in + (size_t)l * 2 * a.fft;
    dechirp_window(a, l, a.ptr[l], a.chirp_up, up, threadIdx.x, blockDim.x);
    if (code != SFD) return;
    float mx;
    double sum;
    const Cand d = fold_row<MODE>(a, a.down_out + (size_t)l * a.fft, false,
                                  mx, sum, part);
    const int idx = d.i > a.bins / 2 ? d.i - a.bins : d.i;
    const float ncf = __fadd_rn(
        __fmul_rn(__fmul_rn(__fmul_rn((float)idx, (float)a.p), 0.5f),
                  __fdiv_rn(1.f, (float)a.fac)),
        (float)(2.25 * a.n));
    const int nc = (int)floorf(__fadd_rn(ncf, 0.5f));
    const int cfo_start = max(a.ptr[l] + nc - a.lookback, 0);
    if (threadIdx.x == 0) {
        a.nc_sfd[l] = nc;
        a.dval[l] = d.v;
    }
    dechirp_window(a, l, cfo_start, a.chirp_up, up + a.fft, threadIdx.x,
                   blockDim.x);
}

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS) fsm_update(const Args a) {
    __shared__ Cand part[32];
    __shared__ float fpart[32];
    __shared__ double dpart[32];
    __shared__ int comp8[8];
    __shared__ int s_task, s_count, s_row;
    enum { NONE = 0, PARSE = 1, EMIT = 2 };
    const int l = blockIdx.x;
    const int code = code_of(a, l);
    if (code < 0) return;
    const float2* y = a.up_out + (size_t)l * 2 * a.fft;
    float* syms = a.syms + (size_t)l * a.ms;

    // Thread 0 runs the transition (its loads issued before the folds, so
    // their latency hides behind them); the block joins for the integrator.
    int ptr = 0, st = code, h[MAX_PRE], hist_len = 0, nc = a.n;
    int sync_cnt = 0, sym_cnt = 0, psl = 0, pkt_start = 0, out_cnt = 0;
    int row = 0, nc_sfd = 0, it = 0;
    bool hdr_received = false, hdr_valid = false, put = false;
    float cfo = 0.f, snr = 0.f, dval = 0.f;
    if (threadIdx.x == 0) {
        ptr = a.ptr[l];
        for (int i = 1; i < a.npre; ++i) h[i] = a.hist[l * a.npre + i - 1];
        hist_len = min(a.hist_len[l] + 1, a.npre);
        sync_cnt = a.sync_cnt[l];
        sym_cnt = a.sym_cnt[l];
        hdr_received = a.hdr_received[l] != 0;
        hdr_valid = a.hdr_valid[l] != 0;
        pkt_start = a.pkt_start[l];
        snr = a.snr[l];
        cfo = a.cfo[l];
        psl = a.pkt_sym_len[l];
        out_cnt = a.out_cnt[l];
        it = a.it[l];
        if (code == SFD) {
            nc_sfd = a.nc_sfd[l];
            dval = a.dval[l];
        }
    }
    float mx;
    double sum;
    const Cand m = fold_row<MODE>(a, y, code == DETECT, mx, sum, part);
    int cidx = 0;
    if (code == SFD) {
        float cmx;
        double csum;
        cidx = fold_row<MODE>(a, y + a.fft, false, cmx, csum, part).i;
    }
    if (code == DETECT) block_max_sum(mx, sum, fpart, dpart);
    if (threadIdx.x == 0) {
        h[0] = m.i;
        int task = NONE;
        if (code == RESET) {
            hist_len = sync_cnt = sym_cnt = 0;
            hdr_received = hdr_valid = false;
            st = PREFILL;
        }
        if (code == PREFILL && hist_len >= a.npre) st = DETECT;
        if (code == DETECT) {
            bool found = m.v > 0.f;
            for (int i = 1; i < a.npre; ++i) {
                const int dis = ipmod(h[0] - h[i], a.bins);
                found &= dis <= a.drift_max || dis >= a.bins - a.drift_max;
            }
            if (found) {
                nc = a.n - (a.p * h[0]) / a.fac;
                st = SFD;
                pkt_start = ptr;
                const float mean = (float)(sum / (double)a.bins);
                snr = __fdiv_rn(mx, fmaxf(mean, 1e-20f));
            }
        }
        if (code == SFD) {
            const bool bail = sync_cnt > a.recovery;
            sync_cnt += 1;
            const bool detect = dval > m.v;
            if (detect) {
                nc = nc_sfd;
                cfo = (float)cidx;
            }
            if (bail && !detect) st = RESET;
            if (detect) st = HEADER;
        }
        const float bin = fpmod(__fmul_rn(__fsub_rn((float)m.i, cfo),
                                          __fdiv_rn(1.f, (float)a.fac)),
                                (float)a.nsym);
        if (code == HEADER) {
            syms[min(sym_cnt, a.ms - 1)] = bin;
            sym_cnt = min(sym_cnt + 1, a.ms);
            if (!a.explicit_header) {
                psl = a.implicit_psl;
                if (sym_cnt > 8) st = PAYLOAD;
            } else if (sym_cnt == 8) {
                task = PARSE;
            }
        }
        if (code == PAYLOAD) {
            if (sym_cnt >= psl) {
                st = OUT;
            } else {
                syms[min(sym_cnt, a.ms - 1)] = bin;
                sym_cnt = min(sym_cnt + 1, a.ms);
            }
        }
        if (code == OUT) {
            row = min(out_cnt, a.mp - 1);
            put = out_cnt < a.mp;
            if (put) task = EMIT;
        }
        s_task = task;
        s_count = sym_cnt;
        s_row = row;
    }
    __syncthreads();
    const int task = s_task;
    if (task == PARSE) compensate(a, syms, 8, 8, comp8, fpart);
    if (task == EMIT)
        compensate(a, syms, s_count, a.ms,
                   a.out_syms + ((size_t)l * a.mp + s_row) * a.ms, fpart);
    __syncthreads();
    if (threadIdx.x != 0) return;
    if (code == HEADER && a.explicit_header) {
        if (task == PARSE) {
            bool valid;
            int hpsl;
            parse_header(a, comp8, valid, hpsl);
            hdr_received = true;
            hdr_valid = valid;
            if (valid) psl = hpsl;
        }
        if (sym_cnt > 8 && hdr_received) st = hdr_valid ? PAYLOAD : RESET;
    }
    if (code == OUT) {
        if (put) {
            const int r = l * a.mp + row;
            a.out_len[r] = sym_cnt;
            a.out_pos[r] = (int)((unsigned)pkt_start + (unsigned)a.base[l]);
            a.out_snr[r] = snr;
        }
        a.out_cnt[l] = out_cnt + 1;
        st = RESET;
    }
    a.ptr[l] = ptr + nc;
    a.st[l] = st;
    for (int i = 0; i < a.npre; ++i) a.hist[l * a.npre + i] = h[i];
    a.hist_len[l] = hist_len;
    a.sync_cnt[l] = sync_cnt;
    a.cfo[l] = cfo;
    a.snr[l] = snr;
    a.sym_cnt[l] = sym_cnt;
    a.pkt_sym_len[l] = psl;
    a.hdr_received[l] = hdr_received;
    a.hdr_valid[l] = hdr_valid;
    a.pkt_start[l] = pkt_start;
    a.it[l] = it + 1;
}

// ---- launchers.

template <class... P, class... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, dim3 block,
                   void* stream, A&&... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = nullptr;
    cfg.numAttrs = 0;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, kernel, std::forward<A>(args)...);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// Threads a lane's block: a quarter of the K / 2 bin pairs, a whole number
// of warps, 32 to 1024.
inline int lane_threads(int bins) {
    int t = (bins / 8 + 31) / 32 * 32;
    return t < 32 ? 32 : (t > MAX_THREADS ? MAX_THREADS : t);
}

inline bool valid(const Args* a) {
    return a->lanes > 0 && a->n > 0 && a->bins % 2 == 0 &&
           a->fft % 2 == 0 && a->bins <= a->fft && a->n <= a->buf_len &&
           a->npre >= 1 && a->npre <= MAX_PRE && a->ms >= 8 && a->mp >= 1 &&
           a->peak_search >= ABS && a->peak_search <= B &&
           (a->peak_search == ABS || a->phase_k >= 1) &&
           a->sf - 2 * a->ldr > 0;
}

}  // namespace fsm

extern "C" int grl_fsm_win(const fsm::Args* a, void* stream) {
    if (!fsm::valid(a)) return cudaErrorInvalidValue;
    const int per = fsm::WIN_THREADS * 4;
    return fsm::launch(fsm::fsm_win, dim3((a->n + per - 1) / per, a->lanes),
                       dim3(fsm::WIN_THREADS), stream, *a);
}

extern "C" int grl_fsm_sfd(const fsm::Args* a, void* stream) {
    if (!fsm::valid(a)) return cudaErrorInvalidValue;
    const dim3 grid(a->lanes), block(fsm::lane_threads(a->bins));
    switch (a->peak_search) {
        case fsm::ABS:
            return fsm::launch(fsm::fsm_sfd<fsm::ABS>, grid, block, stream,
                               *a);
        case fsm::PHASE:
            return fsm::launch(fsm::fsm_sfd<fsm::PHASE>, grid, block, stream,
                               *a);
        default:
            return fsm::launch(fsm::fsm_sfd<fsm::B>, grid, block, stream, *a);
    }
}

extern "C" int grl_fsm_update(const fsm::Args* a, void* stream) {
    if (!fsm::valid(a)) return cudaErrorInvalidValue;
    const dim3 grid(a->lanes), block(fsm::lane_threads(a->bins));
    switch (a->peak_search) {
        case fsm::ABS:
            return fsm::launch(fsm::fsm_update<fsm::ABS>, grid, block, stream,
                               *a);
        case fsm::PHASE:
            return fsm::launch(fsm::fsm_update<fsm::PHASE>, grid, block,
                               stream, *a);
        default:
            return fsm::launch(fsm::fsm_update<fsm::B>, grid, block, stream,
                               *a);
    }
}
