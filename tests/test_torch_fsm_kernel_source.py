"""The demodulator FSM's step kernels (csrc/fsm_step.cu) run on the CPU
under emulated warps, against the plain step (models/demodulator._machine's
``body``).

There is no nvcc here, so the kernels cannot be compiled for the card.
Their device code is plain C++ apart from the CUDA primitives, so this
test compiles the source unchanged with the host compiler, beside a
stand-in ``cuda_runtime.h``: a block's threads are fibers (ucontext) on
one OS thread, run in turns; ``__syncthreads`` ends a thread's turn, and
a warp shuffle is a write to the thread's slot, a turn, a read, a turn (the
kernels call every shuffle and barrier from all threads of a block alike);
``__shared__`` is a static, shared by the block's fibers; the blocks run
one after another; the ``__f*_rn`` intrinsics are the host's f32
operations.  ``ops/fsm_step.FsmStep`` drives the emulated library on CPU
tensors with ``torch.fft`` between the kernels, as it drives the built one
on the card.  After every STEPS steps the whole state must equal the plain
steps': every integer field, ``syms`` and ``cfo`` bit for bit, ``snr`` and
``out_snr`` within 1e-6 (the kernel sums the fold's mean in f64).  What
the card adds (nvcc, cuFFT, the real warp) only the card tests check
(tests/test_torch_kernels_cuda.py).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.config import PeakSearch
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.models.demodulator import demod_fn
from gr_lora_tpu_torch.models.fsm_loop import STEPS
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.ops import fsm_step
from gr_lora_tpu_torch.ops._build import CSRC, SIGNATURES
from gr_lora_tpu_torch.ops.cplx import to_ri

SOURCE = CSRC / "fsm_step.cu"

CUDA_RUNTIME = r"""
#pragma once
#include <ucontext.h>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <math.h>
#include <tuple>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct Idx { unsigned x, y, z; };
inline Idx threadIdx, blockIdx, blockDim, gridDim;
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline unsigned __float_as_uint(float x) {
    unsigned r; std::memcpy(&r, &x, 4); return r; }
inline float __uint_as_float(unsigned x) {
    float r; std::memcpy(&r, &x, 4); return r; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// A block: a fiber a thread, a 64-bit slot a thread for the shuffles.
struct EmuBlock {
    std::vector<ucontext_t> ctx;
    std::vector<char> done;
    std::vector<uint64_t> slot;
    ucontext_t main;
    unsigned cur = 0;
    std::function<void()> body;
};
inline EmuBlock* g_blk;
inline std::vector<std::vector<char>> g_stacks;
constexpr size_t EMU_STACK = 1 << 18;
inline void __syncthreads() {
    swapcontext(&g_blk->ctx[g_blk->cur], &g_blk->main);
}
template <class T> inline T emu_exchange(T v, unsigned src) {
    static_assert(sizeof(T) <= 8);
    uint64_t w = 0;
    std::memcpy(&w, &v, sizeof(T));
    g_blk->slot[threadIdx.x] = w;
    __syncthreads();
    w = g_blk->slot[(threadIdx.x & ~31u) + (src & 31u)];
    __syncthreads();
    T r;
    std::memcpy(&r, &w, sizeof(T));
    return r;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int off) {
    return emu_exchange(v, (threadIdx.x & 31u) ^ (unsigned)off); }
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
    const unsigned lane = threadIdx.x & 31u;
    return emu_exchange(v, lane >= d ? lane - d : lane); }

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
struct cudaLaunchAttribute {};
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline void emu_entry() {
    g_blk->body();
    g_blk->done[g_blk->cur] = 1;
}
// The grid's blocks one after another; a block's fibers in turns until
// every one has returned.
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A&&... args) {
    const unsigned threads = cfg->blockDim.x;
    if (threads % 32 || threads > 1024 || cfg->blockDim.y != 1 ||
        cfg->gridDim.z != 1)
        return cudaErrorInvalidValue;
    std::tuple<P...> params(args...);
    if (g_stacks.size() < threads) g_stacks.resize(threads);
    for (unsigned by = 0; by < cfg->gridDim.y; ++by)
        for (unsigned bx = 0; bx < cfg->gridDim.x; ++bx) {
            EmuBlock blk;
            g_blk = &blk;
            blockIdx = {bx, by, 0};
            blockDim = {threads, 1, 1};
            gridDim = {cfg->gridDim.x, cfg->gridDim.y, 1};
            blk.ctx.resize(threads);
            blk.done.assign(threads, 0);
            blk.slot.assign(threads, 0);
            blk.body = [&] { std::apply(kernel, params); };
            for (unsigned t = 0; t < threads; ++t) {
                g_stacks[t].resize(EMU_STACK);
                getcontext(&blk.ctx[t]);
                blk.ctx[t].uc_stack.ss_sp = g_stacks[t].data();
                blk.ctx[t].uc_stack.ss_size = EMU_STACK;
                blk.ctx[t].uc_link = &blk.main;
                makecontext(&blk.ctx[t], emu_entry, 0);
            }
            for (bool live = true; live;) {
                live = false;
                for (unsigned t = 0; t < threads; ++t) {
                    if (blk.done[t]) continue;
                    live = true;
                    blk.cur = t;
                    threadIdx = {t, 0, 0};
                    swapcontext(&blk.main, &blk.ctx[t]);
                }
            }
        }
    return cudaSuccess;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """fsm_step.cu built for the host beside the stand-in header."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (c++)")
    d = tmp_path_factory.mktemp("fsm_emu")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-I",
                    str(d), "-x", "c++", "-o", str(d / "emu.so"),
                    str(SOURCE)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "emu.so"))
    for name in fsm_step.ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


#: (config, payload) of each case: SF7 ABS with an explicit header, SF8
#: PHASE with an explicit header and LDR on, SF7 B with an implicit one,
#: SF7 PHASE over 80 rotations (no cap on peak_phase_k).
CASES = {
    "sf7_abs_explicit": (dict(sf=7, explicit_header=True), b"\x11\x22\x33"),
    "sf8_phase_ldr": (dict(sf=8, explicit_header=True, ldr=True,
                           peak_search=PeakSearch.PHASE), b"\x44\x55"),
    "sf7_b_implicit": (dict(sf=7, explicit_header=False, payload_len=2,
                            peak_search=PeakSearch.B), b"\x66\x77"),
    "sf7_phase_k80": (dict(sf=7, explicit_header=True,
                           peak_search=PeakSearch.PHASE, peak_phase_k=80),
                      b"\x88\x99"),
}
LANES = 4
MP = 2


def _lanes(cfg, payload: bytes):
    """[LANES, T, 2]: a packet in noise on lanes 0 and 1 at lane-specific
    offsets, its preamble alone in noise on lane 2 (detected, then no
    SFD: the recovery count bails out), silence on lane 3 (every fold a
    tie at 0, no detection)."""
    n = cfg.num_samples
    pkt = 0.2 * modulate(encode(payload, cfg), cfg, pad_front=0, pad_back=0)
    total = len(pkt) + 3 * n
    rng = np.random.default_rng(cfg.sf)
    out = []
    for i, wave in enumerate((pkt, pkt, pkt[:8 * n])):
        iq = (0.01 * (rng.standard_normal(total)
                      + 1j * rng.standard_normal(total))).astype(np.complex64)
        o = n // 2 + 53 * i
        iq[o:o + len(wave)] += wave
        out.append(to_ri(iq))
    out.append(np.zeros((total, 2), np.float32))
    return torch.from_numpy(np.stack(out)), total


def _same(plain, kern):
    for name, a in plain._asdict().items():
        b = getattr(kern, name)
        if name in ("snr", "out_snr"):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=0.0,
                                       msg=name)
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_steps_equal_plain_steps(emulated, case):
    kw, payload = CASES[case]
    cfg = LoraConfig(cr=1, crc=True, p=2, fft_factor=2, **kw)
    x, total = _lanes(cfg, payload)
    demod = demod_fn(cfg, total, MP, "cpu")
    pad = demod.pad_front
    plain, kern = demod.make_loop(LANES), demod.make_loop(LANES)
    assert plain.kernel is None and kern.kernel is None     # CPU loops
    step = fsm_step.FsmStep(cfg, MP, kern, library=emulated)
    for loop in (plain, kern):
        loop.iq[:, pad:pad + total].copy_(x)
        loop._load(demod.init_state(LANES, -pad, pad, torch.device("cpu")))
    before = fsm_step.launches
    replays = 0
    while bool(plain.active(plain.state).any()):
        plain._steps()
        for _ in range(STEPS):
            step()
        replays += 1
        _same(plain.state, kern.state)
    assert fsm_step.launches - before == 3 * STEPS * replays
    # The packets were emitted, silence nothing; the preamble alone
    # nothing where a header must check out.
    cnt = plain.state.out_cnt.tolist()
    assert cnt[:2] == [1, 1] and cnt[3] == 0
    assert cnt[2] == 0 or not cfg.explicit_header


def test_kernel_refuses_cpu_tensors_without_a_library():
    cfg = LoraConfig(sf=7, p=2, fft_factor=2)
    loop = demod_fn(cfg, 64 * cfg.num_samples, MP, "cpu").make_loop(2)
    with pytest.raises(ValueError):
        fsm_step.FsmStep(cfg, MP, loop)
