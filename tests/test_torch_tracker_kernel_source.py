"""The tracker walk kernel's source (csrc/device_tracker.cu) run on the
CPU under an emulated block, against its plain version.

There is no nvcc here, so the kernel cannot be compiled for the card.
Its device code is plain C++ apart from the warp primitives, so this test
compiles the source with the host compiler behind a small prelude: 64
``std::thread`` lanes a channel in two warps, a ``std::barrier`` a warp
for ``__syncwarp`` and each warp exchange (``__shfl_sync``,
``__reduce_min_sync``, ``__reduce_add_sync``, ``__ballot_sync``: a
write, a barrier, a read, a barrier), one for ``__syncthreads``,
hopper.cuh's ``cp.async`` a plain copy, the block's dynamic shared memory
a host buffer, and ``__fadd_rn`` and friends as single rounded f32
operations (no FMA contraction).  The launch (``kernel<<<...>>>``) becomes a loop over the
channels, and ``cudaFuncSetAttribute`` refuses more shared memory than a
block may have, as the card does; the rest of the host side (the
instance's slot count, the shared-memory layout) is the source's own.
The emulated kernel's whole state must equal the plain walk's bit for
bit, in both instances, as the card's must
(tests/test_torch_kernels_cuda.py).  What the card adds (the compiler,
the real warp, memory ordering) only a card run checks.
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
from gr_lora_tpu_torch.ops.device_tracker import (ENTRY, MAX_SHARED,
                                                  STATE_FIELDS, TrackerWalk)

SOURCE = Path(__file__).resolve().parents[1] / \
    "gr_lora_tpu_torch" / "csrc" / "device_tracker.cu"

PRELUDE = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct Idx { int x; };
thread_local Idx threadIdx, blockIdx;
struct int4 { int x, y, z, w; };
static std::barrier<>* g_bar[2];    // each warp's lanes
static std::barrier<>* g_blk;       // the block's threads
static int g_si[2][32];
static float g_sf[2][32];
static unsigned char* g_smem;
static size_t g_smem_bytes;
inline int emu_lane() { return threadIdx.x & 31; }
inline int emu_warp() { return threadIdx.x >> 5; }
inline void __syncwarp() { g_bar[emu_warp()]->arrive_and_wait(); }
inline void __syncthreads() { g_blk->arrive_and_wait(); }
template <class T> inline T exchange(T v, T (*slots)[32], int src) {
    T* slot = slots[emu_warp()];
    slot[emu_lane()] = v; g_bar[emu_warp()]->arrive_and_wait();
    T r = slot[src]; g_bar[emu_warp()]->arrive_and_wait(); return r; }
inline int __shfl_sync(unsigned, int v, int src) {
    return exchange(v, g_si, src & 31); }
inline float __shfl_sync(unsigned, float v, int src) {
    return exchange(v, g_sf, src & 31); }
template <class F> inline int warp_fold(int v, F f) {
    int* slot = g_si[emu_warp()];
    slot[emu_lane()] = v; g_bar[emu_warp()]->arrive_and_wait();
    int r = slot[0]; for (int i = 1; i < 32; ++i) r = f(r, slot[i]);
    g_bar[emu_warp()]->arrive_and_wait(); return r; }
inline int __reduce_min_sync(unsigned, int v) {
    return warp_fold(v, [](int a, int b) { return std::min(a, b); }); }
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
    return (unsigned)warp_fold((int)v, [](int a, int b) {
        return (int)((unsigned)a + (unsigned)b); }); }
inline unsigned __ballot_sync(unsigned, bool p) {
    return (unsigned)warp_fold(p ? (int)(1u << emu_lane()) : 0,
                               [](int a, int b) { return a | b; }); }
inline bool __any_sync(unsigned m, bool p) { return __ballot_sync(m, p); }
// hopper.cuh's per-thread cp.async: a plain copy, its waits no-ops.
namespace hopper {
inline void cp_async16(void* d, const void* s) { std::memcpy(d, s, 16); }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __float_as_int(float x) { int r; std::memcpy(&r, &x, 4); return r; }
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
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// The card refuses more than a block's shared memory (error 1, invalid
// value).
template <class K> inline cudaError_t cudaFuncSetAttribute(K, int, int b) {
    return b > 232448 ? 1 : cudaSuccess; }
// kernel<<<C, threads, smem>>>(args...): the channels one after another,
// `threads` lanes each (warps of 32), over one shared buffer.
template <class K, class... A>
void emulate(K kernel, int C, int threads, size_t smem, const A&... args) {
    std::vector<unsigned char> buf(smem + 16);
    g_smem = buf.data() + (16 - (uintptr_t)buf.data() % 16) % 16;
    g_smem_bytes = smem;
    for (int c = 0; c < C; ++c) {
        std::barrier<> w0(32), w1(32), blk(threads);
        g_bar[0] = &w0; g_bar[1] = &w1; g_blk = &blk;
        std::vector<std::thread> lanes;
        for (int l = 0; l < threads; ++l)
            lanes.emplace_back([&, l] {
                threadIdx.x = l; blockIdx.x = c;
                kernel(args...);
            });
        for (auto& t : lanes) t.join();
    }
}
"""

#: The emulated library's own export: the last launch's shared memory.
EXPORT = r"""
extern "C" size_t emu_smem_bytes() { return g_smem_bytes; }
"""

LAUNCH = "kernel<<<p.C, kThreads, smem, stream>>>(s, p, lat);"
HOPPER = '#include "hopper.cuh"'
SHARED = "extern __shared__ __align__(16) unsigned char smem[];"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel source built for the host behind the warp prelude."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (c++)")
    src = SOURCE.read_text()
    for old in ("#include <cuda_runtime.h>", LAUNCH, SHARED, HOPPER):
        assert src.count(old) == 1, old
    src = src.replace("#include <cuda_runtime.h>", PRELUDE)
    src = src.replace(HOPPER, "")
    src = src.replace(SHARED, "unsigned char* smem = g_smem;")
    src = src.replace(LAUNCH,
                      "emulate(kernel, p.C, kThreads, smem, s, p, lat);")
    d = tmp_path_factory.mktemp("tracker_emu")
    (d / "emu.cc").write_text(src + EXPORT)
    subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", "-o", str(d / "emu.so"),
                    str(d / "emu.cc")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "emu.so"))
    for name in ENTRY.values():
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_float] + [ctypes.c_void_p] * 5
        getattr(lib, name).restype = ctypes.c_int
    lib.emu_smem_bytes.restype = ctypes.c_size_t
    return lib


def _run(lib, walk, state, bins, h, hs, valid, instance=None):
    """The wrapper's launch (ops/device_tracker.TrackerWalk.kernel) with
    the emulated kernel in place of the card's: the instance the wrapper
    picks, or the one named.  Returns the entry point's error code."""
    c, hops = bins.shape[0], bins.shape[1]
    ptrs = (ctypes.c_void_p * len(STATE_FIELDS))(
        *(state[n].data_ptr() for n, _ in STATE_FIELDS))
    params = (ctypes.c_int * 22)(
        c, hops, bins.shape[-1], walk.K, walk.Q, walk.S, walk.O, walk.F,
        walk.E, walk.R, walk.G, walk.n, walk.k, walk.hop, walk.tol, walk.ff,
        walk.qoff, walk.lo0, walk.grace, int(walk.split),
        PYRAMID_MAX_TRACK_PEAKS, TIMESTAMP_MOD)
    entry = ENTRY[instance or walk.instance(bins.shape[-1])]
    return getattr(lib, entry)(ptrs, params, walk.thr, bins.data_ptr(),
                               h.data_ptr(), hs.data_ptr(), valid.data_ptr(),
                               None)


def _same_state(kern, plain):
    for name, _ in STATE_FIELDS:
        a, b = kern[name].numpy(), plain[name].numpy()
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), (name, np.argwhere(a != b)[:4])


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


TINY = dict(track_pool=4, packet_pool=1, expire_per_hop=1, max_symbols=8,
            out_pool=1, finalize_per_hop=1)
#: Pools over a block's shared memory (291 840 B of bulk arrays): the
#: global instance.
LARGE = dict(track_pool=256, split_repeats=True)


def _walk_blocks(lib, walk, lat, cuts, instance=None):
    """The lattice fed as consecutive blocks split at ``cuts`` (the state
    carried across) through the emulated kernel and the plain walk; the
    two states after."""
    c = lat[0].shape[0]
    kern, plain = walk.init_state(c, "cpu"), walk.init_state(c, "cpu")
    edges = [0, *cuts, lat[0].shape[1]]
    for lo, hi in zip(edges, edges[1:]):
        blk = [x[:, lo:hi].contiguous() for x in lat]
        assert _run(lib, walk, kern, *blk, instance=instance) == 0
        walk.plain(plain, *blk)
    return kern, plain


@pytest.mark.parametrize("pools", [
    {}, {"split_repeats": True}, TINY], ids=["pools", "split", "tiny"])
def test_emulated_kernel_equals_plain(emulated, pools):
    """Two consecutive blocks (the state carried across) through the
    instance the wrapper picks (the shared one): every field of the
    emulated kernel's state equals the plain walk's, f32 bit for bit."""
    lat = _lattice()
    walk = TrackerWalk(CFG, 8, **pools)
    assert walk.instance() == "shared"
    hops = lat[0].shape[1]
    kern, plain = _walk_blocks(emulated, walk, lat, [hops // 2])
    _same_state(kern, plain)
    if "track_pool" in pools:
        assert int(kern["tracks_dropped"].sum()) > 0
    else:
        assert int(kern["o_count"].min()) >= 1


@pytest.mark.parametrize("pools", [
    {}, {"split_repeats": True}, TINY], ids=["pools", "split", "tiny"])
def test_emulated_global_instance_equals_plain(emulated, pools):
    """The global-memory instance, named, on the pools the shared one
    takes: the same state as the plain walk, bit for bit."""
    lat = _lattice()
    walk = TrackerWalk(CFG, 8, **pools)
    kern, plain = _walk_blocks(emulated, walk, lat, [lat[0].shape[1] // 2],
                               "global")
    _same_state(kern, plain)


def test_emulated_large_pools_take_global(emulated):
    """Track 256 with split_repeats: the wrapper picks the global
    instance, which equals the plain walk on three channels; the shared
    instance refuses the launch (more shared memory than a block has)."""
    lat = _lattice(3)
    walk = TrackerWalk(CFG, 8, **LARGE)
    assert walk.instance() == "global"
    assert walk.shared_bytes() > MAX_SHARED
    kern, plain = _walk_blocks(emulated, walk, lat, [lat[0].shape[1] // 2])
    _same_state(kern, plain)
    assert int(kern["o_count"].min()) >= 1
    st = walk.init_state(3, "cpu")
    assert _run(emulated, walk, st, *lat, instance="shared") != 0


@pytest.mark.parametrize("instance", ["shared", "global"])
@pytest.mark.parametrize("cuts", [[45], [45, 122]],
                         ids=["45+rest", "45+77+rest"])
def test_emulated_ragged_chunks(emulated, instance, cuts):
    """Blocks whose hop counts are no multiple of the 32-hop chunk (45,
    then 77, then the rest), two channels at their own offsets, split
    groups on: each instance equals the plain walk, bit for bit."""
    lat = _lattice(2)
    walk = TrackerWalk(CFG, 8, split_repeats=True)
    kern, plain = _walk_blocks(emulated, walk, lat, cuts, instance)
    _same_state(kern, plain)
    assert int(kern["o_count"].min()) >= 1


def _overcap_lattice(hops=300):
    """[1, hops, 8]: two steady tones from hop 0 (their bins drift with
    the tracker's bin reference), the lower one gone at hop 255, the
    upper one on: at hop 255 the upper track reaches the 256-peak cap as
    the lower (older) one goes idle."""
    k = CFG.bin_size
    bins = np.zeros((1, hops, 8), np.int32)
    h = np.zeros((1, hops, 8), np.float32)
    for t in range(hops):
        ref = t * (k // 8) % k
        bins[0, t, 0] = (10 + ref) % k
        h[0, t, 0] = 20.0 if t < PYRAMID_MAX_TRACK_PEAKS - 1 else 0.0
        bins[0, t, 1] = (k // 2 + ref) % k
        h[0, t, 1] = 30.0
    return tuple(torch.from_numpy(x) for x in (bins, h, 0.8 * h, h > 0))


@pytest.mark.parametrize("finalize", [1, 8])
@pytest.mark.parametrize("instance", ["shared", "global"])
def test_emulated_overcap_before_idle(emulated, instance, finalize):
    """The over-cap track retires before the idle one that is older (lower
    t_seq), as make_device_tracker orders them: one retirement a hop
    (the idle one deferred), or both in one hop, their packets made in
    that order."""
    lat = _overcap_lattice()
    walk = TrackerWalk(CFG, 8, finalize_per_hop=finalize)
    kern, plain = _walk_blocks(emulated, walk, lat, [250], instance)
    _same_state(kern, plain)
    assert int(kern["tracks_overflow_finalized"][0]) >= 1
    assert (int(kern["finalize_deferred"][0]) >= 1) == (finalize == 1)
    assert int(kern["pseq"][0]) >= 2


def _tone_lattice(tones, hops):
    """[1, hops, 8]: steady tones (bin relative to the tracker's bin
    reference, first hop, end hop, height) whose lattice bins drift with
    the reference, as a chirp's do."""
    k = CFG.bin_size
    bins = np.zeros((1, hops, 8), np.int32)
    h = np.zeros((1, hops, 8), np.float32)
    used = np.zeros(hops, np.int64)
    for cur, lo, hi, height in tones:
        for t in range(lo, hi):
            bins[0, t, used[t]] = (cur + t * (k // 8)) % k
            h[0, t, used[t]] = height
            used[t] += 1
    return tuple(torch.from_numpy(x) for x in (bins, h, 0.8 * h, h > 0))


@pytest.mark.parametrize("instance", ["shared", "global"])
def test_emulated_oldest_of_two_matching_tracks(emulated, instance):
    """A peak within tolerance of two live tracks joins the older one
    (least t_seq), here the one in the higher slot: the lower slot was
    freed and taken by a younger track."""
    tol = CFG.bin_tolerance
    lat = _tone_lattice([(100, 0, 1, 20.0), (200, 0, 3, 20.0),
                         (201 + tol, 2, 3, 20.0), (202, 3, 4, 20.0)], 12)
    walk = TrackerWalk(CFG, 8)
    kern, plain = _walk_blocks(emulated, walk, lat, [3], instance)
    _same_state(kern, plain)
    assert kern["t_count"][0, :2].tolist() == [1, 4]


@pytest.mark.parametrize("instance", ["shared", "global"])
def test_emulated_data_peak_of_two_packets(emulated, instance):
    """A data peak eligible for two packets joins the one of least phase
    distance, here the younger one in the higher slot."""
    lat = _tone_lattice([(50, 0, 45, 20.0), (700, 3, 48, 20.0),
                         (1400, DATA_HOP, DATA_HOP + 4, 20.0)], 100)
    walk = TrackerWalk(CFG, 8)
    kern, plain = _walk_blocks(emulated, walk, lat, [60], instance)
    _same_state(kern, plain)
    assert kern["p_count"][0, :2].tolist() == [0, 1]


#: The data tone's first hop in test_emulated_data_peak_of_two_packets.
DATA_HOP = 85


@pytest.mark.parametrize("m", [8, 16])
@pytest.mark.parametrize("pools", [{}, {"split_repeats": True}, TINY, LARGE],
                         ids=["pools", "split", "tiny", "large"])
def test_emulated_shared_memory_is_the_rule(emulated, pools, m):
    """The shared memory the source's launcher asks for, in each instance,
    is TrackerWalk.shared_bytes (the footprint the wrapper's rule
    reads)."""
    walk = TrackerWalk(CFG, m, **pools)
    z = torch.zeros((1, 3, m), dtype=torch.int32)
    flush = (z, z.float(), z.float(), z.bool())
    for inst in ("global", "shared"):
        st = walk.init_state(1, "cpu")
        err = _run(emulated, walk, st, *flush, instance=inst)
        want = walk.shared_bytes(m, inst)
        if want > MAX_SHARED:
            assert err != 0 and inst == "shared"
            continue
        assert err == 0
        assert emulated.emu_smem_bytes() == want, inst
