"""The tracker walk kernel's source (csrc/device_tracker.cu) run on the
CPU under an emulated warp, against its plain version.

There is no nvcc here, so the kernel cannot be compiled for the card.
Its device code is plain C++ apart from the warp primitives, so this test
compiles the source with the host compiler behind a small prelude: 32
``std::thread`` lanes a channel, a ``std::barrier`` for ``__syncwarp``
and the shuffles (each exchange a write, a barrier, a read, a barrier),
``__fadd_rn`` and friends as single rounded f32 operations (no FMA
contraction).  The launcher is replaced by a loop over channels.  The
emulated kernel's whole state must equal the plain walk's bit for bit,
as the card's must (tests/test_torch_kernels_cuda.py).  What the card
adds (the compiler, the real warp, memory ordering) only a card run
checks.
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.config import PYRAMID_MAX_TRACK_PEAKS, TIMESTAMP_MOD
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.models.device_tracker import flush_hops
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import num_hops_for, peak_lattice_fn
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.ops.device_tracker import STATE_FIELDS, TrackerWalk

SOURCE = Path(__file__).resolve().parents[1] / \
    "gr_lora_tpu_torch" / "csrc" / "device_tracker.cu"

PRELUDE = r"""
#include <barrier>
#include <cmath>
#include <cstdint>
#include <math.h>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct Idx { int x; };
thread_local Idx threadIdx, blockIdx;
static std::barrier<>* g_bar;
static int g_si[32];
static float g_sf[32];
static int* g_smem;
inline void __syncwarp() { g_bar->arrive_and_wait(); }
inline int __shfl_xor_sync(unsigned, int v, int o) {
    g_si[threadIdx.x] = v; g_bar->arrive_and_wait();
    int r = g_si[threadIdx.x ^ o]; g_bar->arrive_and_wait(); return r; }
inline float __shfl_xor_sync(unsigned, float v, int o) {
    g_sf[threadIdx.x] = v; g_bar->arrive_and_wait();
    float r = g_sf[threadIdx.x ^ o]; g_bar->arrive_and_wait(); return r; }
inline bool __any_sync(unsigned, bool p) {
    g_si[threadIdx.x] = p; g_bar->arrive_and_wait();
    bool r = false; for (int i = 0; i < 32; ++i) r |= g_si[i] != 0;
    g_bar->arrive_and_wait(); return r; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float __fadd_rn(float a, float b) {
    volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) {
    volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) {
    volatile float r = a * b; return r; }
inline float __fdiv_rn(float a, float b) {
    volatile float r = a / b; return r; }
inline float __int2float_rn(int x) { return (float)x; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
"""

LAUNCHER = r"""
extern "C" int emu_tracker(void* const* fields, const int* params, float thr,
                           const void* bins, const void* h, const void* hs,
                           const void* valid) {
    State s;
    void** dst = reinterpret_cast<void**>(&s);
    for (int i = 0; i < kFields; ++i) dst[i] = fields[i];
    Params p;
    int* pi = &p.C;
    for (int i = 0; i < 22; ++i) pi[i] = params[i];
    p.thr = thr;
    std::vector<int> sm(4 * p.M + 4 * p.S + 1 + kMaxFinalize);
    g_smem = sm.data();
    for (int c = 0; c < p.C; ++c) {
        std::barrier<> bar(32);
        g_bar = &bar;
        std::vector<std::thread> lanes;
        for (int l = 0; l < 32; ++l)
            lanes.emplace_back([&, l] {
                threadIdx.x = l; blockIdx.x = c;
                tracker_kernel(s, p, (const int*)bins, (const float*)h,
                               (const float*)hs, (const uint8_t*)valid);
            });
        for (auto& t : lanes) t.join();
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel source built for the host behind the warp prelude."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (c++)")
    src = SOURCE.read_text()
    src = src.replace("#include <cuda_runtime.h>", PRELUDE)
    src = src.replace("extern __shared__ int smem[];", "int* smem = g_smem;")
    src = src[:src.index('extern "C" int grl_device_tracker')] + LAUNCHER
    d = tmp_path_factory.mktemp("tracker_emu")
    (d / "emu.cc").write_text(src)
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-o", str(d / "emu.so"),
                    str(d / "emu.cc")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "emu.so"))
    lib.emu_tracker.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 4
    return lib


def _run(lib, walk, state, bins, h, hs, valid):
    """The wrapper's launch (ops/device_tracker.TrackerWalk.kernel) with
    the emulated kernel in place of the card's."""
    c, hops = bins.shape[0], bins.shape[1]
    ptrs = (ctypes.c_void_p * len(STATE_FIELDS))(
        *(state[n].data_ptr() for n, _ in STATE_FIELDS))
    params = (ctypes.c_int * 22)(
        c, hops, bins.shape[-1], walk.K, walk.Q, walk.S, walk.O, walk.F,
        walk.E, walk.R, walk.G, walk.n, walk.k, walk.hop, walk.tol, walk.ff,
        walk.qoff, walk.lo0, walk.grace, int(walk.split),
        PYRAMID_MAX_TRACK_PEAKS, TIMESTAMP_MOD)
    lib.emu_tracker(ptrs, params, walk.thr, bins.data_ptr(), h.data_ptr(),
                    hs.data_ptr(), valid.data_ptr())


CFG = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                 payload_len=8, p=2, fft_factor=8, threshold=5.0)


@functools.lru_cache(maxsize=None)
def _lattice(channels=1):
    """[C, H, 8]: the golden SF8 collision on each channel at its own
    offset in noise (the port's ``xla`` lattice), then the flush's empty
    hops."""
    n = CFG.num_samples
    p1 = 0.2 * modulate(encode(bytes([1, 2, 3, 4, 5, 6]), CFG), CFG,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(encode(bytes([7] * 5), CFG), CFG, pad_front=0,
                         pad_back=0)
    total = 1000 + 777 * channels + 22 * n + 2 * (13 * n + 18 * n)
    rng = np.random.default_rng(2)
    iq = (0.01 * (rng.standard_normal((channels, total))
                  + 1j * rng.standard_normal((channels, total)))
          ).astype(np.complex64)
    for c in range(channels):
        off = 1000 + 777 * c
        iq[c, off:off + len(p1)] += p1
        o2 = off + 16 * n + 4 * n // 8 + 204
        iq[c, o2:o2 + len(p2)] += p2
    fn = peak_lattice_fn(CFG, num_hops_for(CFG, total), 8)
    with torch.no_grad():
        lat = fn(torch.from_numpy(to_ri(iq)))
    fh = flush_hops()
    return tuple(torch.cat([x, torch.zeros((channels, fh, 8),
                                           dtype=x.dtype)], 1).contiguous()
                 for x in lat)


@pytest.mark.parametrize("pools", [
    {}, {"split_repeats": True},
    dict(track_pool=4, packet_pool=1, expire_per_hop=1, max_symbols=8,
         out_pool=1, finalize_per_hop=1)], ids=["pools", "split", "tiny"])
def test_emulated_kernel_equals_plain(emulated, pools):
    """Two consecutive blocks (the state carried across): every field of
    the emulated kernel's state equals the plain walk's, f32 bit for
    bit."""
    lat = _lattice()
    walk = TrackerWalk(CFG, 8, **pools)
    hops = lat[0].shape[1]
    kern, plain = walk.init_state(1), walk.init_state(1)
    for lo, hi in ((0, hops // 2), (hops // 2, hops)):
        blk = [x[:, lo:hi].contiguous() for x in lat]
        _run(emulated, walk, kern, *blk)
        walk.plain(plain, *blk)
    for name, _ in STATE_FIELDS:
        a, b = kern[name].numpy(), plain[name].numpy()
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), (name, np.argwhere(a != b)[:4])
    if "track_pool" in pools:
        assert int(kern["tracks_dropped"].sum()) > 0
    else:
        assert int(kern["o_count"].min()) >= 1
