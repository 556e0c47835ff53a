"""The peak epilogue's kernel source (csrc/peak_topm.cu: ``peak_topm`` and
the merge of the fused searches) run on the CPU under emulated warps,
against the plain versions ``peaks_plain`` and ``merge_peaks``.

There is no nvcc here, so the kernels cannot be compiled for the card.
Their device code is plain C++ apart from the warp primitives, so this
test compiles the source unchanged with the host compiler, beside a
stand-in ``cuda_runtime.h`` and ``hopper.cuh``: a ``std::thread`` a lane,
each block's threads at once and the blocks one after another; a
``std::barrier`` a warp and one an 8-lane group for every exchange
(``__shfl_sync``, ``__shfl_xor_sync`` on a warp or an 8-lane group,
``__reduce_max_sync`` / ``__reduce_min_sync``: a write, a barrier, a
read, a barrier); ``__ldg`` a plain load; ``cudaLaunchKernelEx`` the
launch, which records whether it was asked for a programmatic dependent
launch; the PDL wait and trigger no-ops; an SM count the test sets.  The
launchers are the source's own (the instance picked by K and M, the
persistent grid).  Every output must equal the plain version's bit for
bit, as on the card (tests/test_torch_kernels_cuda.py).  What the card
adds (the compiler, the real warp, memory ordering) only a card run
checks.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch.ops._build import CSRC, SIGNATURES
from gr_lora_tpu_torch.ops.peak_epilogue import merge_peaks, peaks_plain

SOURCE = CSRC / "peak_topm.cu"

CUDA_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <memory>
#include <stdint.h>
#include <thread>
#include <tuple>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct Idx { unsigned x, y, z; };
inline thread_local Idx threadIdx, blockIdx, blockDim, gridDim;
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
    return {a, b, c, d}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __float_as_uint(float x) {
    unsigned r; std::memcpy(&r, &x, 4); return r; }
inline float __int_as_float(int x) { float r; std::memcpy(&r, &x, 4); return r; }
inline int __ffs(int x) { return __builtin_ffs(x); }

// A block: a barrier a warp, one an 8-lane group, a 32-bit slot a thread.
struct EmuBlock {
    std::vector<std::unique_ptr<std::barrier<>>> warp, group;
    std::vector<uint32_t> slot;
};
inline thread_local EmuBlock* g_blk;
inline int emu_lane() { return threadIdx.x & 31; }
inline std::barrier<>& emu_bar(unsigned mask) {
    if (mask == 0xffffffffu) return *g_blk->warp[threadIdx.x / 32];
    const unsigned own = 0xffu << (threadIdx.x % 32 / 8 * 8);
    if (mask != own) std::abort();      // only whole warps and 8-lane groups
    return *g_blk->group[threadIdx.x / 8];
}
template <class T> inline T emu_exchange(unsigned mask, T v, int src) {
    static_assert(sizeof(T) == 4);
    uint32_t* s = g_blk->slot.data() + (threadIdx.x & ~31u);
    std::barrier<>& b = emu_bar(mask);
    std::memcpy(&s[emu_lane()], &v, 4);
    b.arrive_and_wait();
    T r;
    std::memcpy(&r, &s[src & 31], 4);
    b.arrive_and_wait();
    return r;
}
template <class T> inline T __shfl_sync(unsigned m, T v, int src) {
    return emu_exchange(m, v, src); }
template <class T> inline T __shfl_xor_sync(unsigned m, T v, int off) {
    return emu_exchange(m, v, emu_lane() ^ off); }
template <class F> inline unsigned emu_fold(unsigned mask, unsigned v, F f) {
    if (mask != 0xffffffffu) std::abort();
    uint32_t* s = g_blk->slot.data() + (threadIdx.x & ~31u);
    std::barrier<>& b = emu_bar(mask);
    s[emu_lane()] = v;
    b.arrive_and_wait();
    unsigned r = s[0];
    for (int i = 1; i < 32; ++i) r = f(r, s[i]);
    b.arrive_and_wait();
    return r;
}
inline unsigned __ballot_sync(unsigned m, bool p) {
    return emu_fold(m, p ? 1u << emu_lane() : 0u,
                    [](unsigned a, unsigned b) { return a | b; }); }
inline unsigned __reduce_max_sync(unsigned m, unsigned v) {
    return emu_fold(m, v, [](unsigned a, unsigned b) { return a > b ? a : b; }); }
inline unsigned __reduce_min_sync(unsigned m, unsigned v) {
    return emu_fold(m, v, [](unsigned a, unsigned b) { return a < b ? a : b; }); }

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaLaunchAttributeID {
    cudaLaunchAttributeProgrammaticStreamSerialization = 3 };
struct cudaLaunchAttributeValue { int programmaticStreamSerializationAllowed; };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; cudaLaunchAttributeValue val; };
struct cudaLaunchConfig_t {
    dim3 gridDim, blockDim;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
inline int g_emu_sms = 2;          // the SM count the launchers see
inline int g_emu_pdl = -1;         // the last launch asked for PDL
inline unsigned g_emu_grid = 0;    // the last launch's blocks
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
    *v = g_emu_sms; return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// The grid's blocks one after another, each block's threads at once; the
// arguments converted to the kernel's parameter types, as the card does.
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A&&... args) {
    g_emu_pdl = 0;
    for (unsigned i = 0; i < cfg->numAttrs; ++i)
        if (cfg->attrs[i].id ==
                cudaLaunchAttributeProgrammaticStreamSerialization &&
            cfg->attrs[i].val.programmaticStreamSerializationAllowed)
            g_emu_pdl = 1;
    const unsigned threads = cfg->blockDim.x, blocks = cfg->gridDim.x;
    g_emu_grid = blocks;
    if (threads % 32 || cfg->gridDim.y != 1 || cfg->blockDim.y != 1)
        return cudaErrorInvalidValue;
    std::tuple<P...> params(args...);
    for (unsigned blk = 0; blk < blocks; ++blk) {
        EmuBlock eb;
        for (unsigned w = 0; w < threads / 32; ++w)
            eb.warp.emplace_back(new std::barrier<>(32));
        for (unsigned g = 0; g < threads / 8; ++g)
            eb.group.emplace_back(new std::barrier<>(8));
        eb.slot.assign(threads, 0);
        std::vector<std::thread> lanes;
        for (unsigned t = 0; t < threads; ++t)
            lanes.emplace_back([&, t] {
                threadIdx = {t, 0, 0};
                blockIdx = {blk, 0, 0};
                blockDim = {threads, 1, 1};
                gridDim = {blocks, 1, 1};
                g_blk = &eb;
                std::apply(kernel, params);
            });
        for (auto& t : lanes) t.join();
    }
    return cudaSuccess;
}
"""

HOPPER = r"""
#pragma once
namespace hopper {
inline void grid_dependency_wait() {}
inline void launch_dependents() {}
}
"""

#: The emulated library's own exports: the merge's launcher (a C++
#: function of peak_merge.cuh), the SM count, and what the last launch
#: asked for.
EXPORT = r"""
extern "C" int emu_merge(const void* lists, int nlists, const void* pairs,
                         int npairs, long long rows, int m, int* bins,
                         float* h, float* h_single, uint8_t* valid) {
    return peaks::launch_merge(static_cast<const peaks::Cand*>(lists), nlists,
                               static_cast<const peaks::Cand*>(pairs), npairs,
                               rows, m, bins, h, h_single, valid, nullptr);
}
extern "C" void emu_set_sms(int n) { g_emu_sms = n; }
extern "C" int emu_pdl() { return g_emu_pdl; }
extern "C" unsigned emu_grid() { return g_emu_grid; }
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """peak_topm.cu built for the host beside the stand-in headers."""
    cxx = shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++20 compiler (c++)")
    d = tmp_path_factory.mktemp("peak_emu")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    (d / "hopper.cuh").write_text(HOPPER)        # found before csrc's
    (d / "emu.cc").write_text(SOURCE.read_text() + EXPORT)
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                    "-I", str(d), "-I", str(CSRC), "-o", str(d / "emu.so"),
                    str(d / "emu.cc")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "emu.so"))
    lib.grl_peak_topm.argtypes = SIGNATURES["grl_peak_topm"]
    lib.grl_peak_topm.restype = ctypes.c_int
    lib.emu_merge.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 4
    lib.emu_merge.restype = ctypes.c_int
    lib.emu_grid.restype = ctypes.c_uint
    lib.emu_set_sms(1)
    return lib


def _outputs(rows, m):
    return (torch.empty((rows, m), dtype=torch.int32),
            torch.empty((rows, m), dtype=torch.float32),
            torch.empty((rows, m), dtype=torch.float32),
            torch.empty((rows, m), dtype=torch.bool))


def _topm(lib, fa, faw, hs, thr, m):
    """grl_peak_topm through the emulated launch."""
    rows, k = faw.shape
    out = _outputs(rows, m)
    err = lib.grl_peak_topm(faw.data_ptr(), fa.data_ptr(), hs.data_ptr(),
                            *(t.data_ptr() for t in out), rows, k, m, thr,
                            None)
    assert err == 0
    return out


def _same(got, ref):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), torch.nonzero(a != b)[:4].tolist()


def _rows(k, rng):
    """[R, K] folds, one edge case a row (threshold 5)."""
    rows = []
    r = (rng.random(k) * 10).astype(np.float32)      # many peaks
    r[k // 3] = np.nan                                # never a peak
    rows.append(r)
    r = (rng.random(k) * 4).astype(np.float32)        # exact ties
    r[3::17] = 9.5
    rows.append(r)
    for hi, lo in ((12.0, 11.0), (11.0, 12.0)):      # the wrap
        r = (rng.random(k) * 4).astype(np.float32)
        r[0], r[-1] = hi, lo
        rows.append(r)
    r = (rng.random(k) * 4).astype(np.float32)        # peaks at both ends
    r[0], r[1], r[-2], r[-1] = 9.0, 6.0, 6.0, 8.0
    rows.append(r)
    r = (rng.random(k) * 4).astype(np.float32)        # plateaus
    for b, n, v in ((1, 2, 9.0), (k // 2, 3, 8.0), (k - 2, 2, 7.0)):
        r[b:b + n] = v
    r[k // 4] = 6.5
    rows.append(r)
    rows.append((rng.random(k) * 4.9).astype(np.float32))   # no peak
    rows.append(np.full(k, 7.0, np.float32))          # flat: no peak
    r = (rng.random(k) * 4).astype(np.float32)        # +inf: no slot
    r[k // 2] = np.inf
    r[k // 5] = 9.0
    rows.append(r)
    for period, offs in ((128, (0, 2)), (32, (0,))):  # one lane's bins
        r = np.ones(k, np.float32)
        for o in offs:
            at = np.arange(o, k - 1, period)
            r[at] = 6.0 + np.round(rng.random(at.size) * 4, 1)
        rows.append(r)
    return np.stack(rows)


def _folds(k, seed, copies=3):
    rng = np.random.default_rng(seed)
    faw = np.concatenate([_rows(k, rng) for _ in range(copies)])
    fa = rng.random(faw.shape).astype(np.float32)
    hs = rng.random(faw.shape).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (fa, faw, hs)]


@pytest.mark.parametrize("m", [1, 8, 16, 17, 32])
@pytest.mark.parametrize("k", [2048, 1100, 300, 2051, 203],
                         ids=["2048", "1100-tail", "300-one-seg",
                              "2051-scalar", "203-scalar"])
def test_emulated_topm_equals_plain(emulated, k, m):
    """Each instance (float4 rows: K 2048, a ragged tail at 1100 and 300;
    one f32 a lane where K is no multiple of 4; lists of 8, 16, and 16
    with the rescan) on rows of every edge case, several rows a warp:
    equal to peaks_plain bit for bit."""
    fa, faw, hs = _folds(k, k * 100 + m)
    got = _topm(emulated, fa, faw, hs, 5.0, m)
    assert faw.shape[0] > 8 * emulated.emu_grid()    # rows a warp > 1
    assert emulated.emu_pdl() == 0
    _same(got, peaks_plain(fa, faw, hs, 5.0, m))
    assert got[3].any()


def test_emulated_topm_rescans_one_lane(emulated):
    """M 32 on rows whose peaks all lie in one lane's bins (32 a lane at K
    2048): the lane's list of 16 runs dry and it rescans, twice where M
    asks for more; the rounds then stop at the first empty slot."""
    k = 2048
    rng = np.random.default_rng(7)
    faw = np.ones((9, k), np.float32)
    for r in range(9):
        at = np.concatenate([np.arange(0, k, 128), np.arange(2, k, 128)])
        faw[r, at] = 6.0 + np.round(rng.random(at.size) * (1 + r), 1)
    fa, hs = (torch.from_numpy(rng.random((9, k)).astype(np.float32))
              for _ in range(2))
    faw = torch.from_numpy(faw)
    for m in (17, 32, 40):
        got = _topm(emulated, fa, faw, hs, 5.0, m)
        _same(got, peaks_plain(fa, faw, hs, 5.0, m))
        assert int(got[3].sum(-1).min()) == min(m, 32)


def test_emulated_topm_small_k_and_signed_zeros(emulated):
    """K 3 and 4 (one lane, the wrap on both sides of a three-bin row),
    and peaks of value -0 and +0 (threshold -1): equal values, so ties to
    the lower bin whatever the sign."""
    rng = np.random.default_rng(3)
    for k in (3, 4):
        faw = torch.from_numpy((rng.random((20, k)) * 10).astype(np.float32))
        fa, hs = torch.rand(20, k), torch.rand(20, k)
        for m in range(1, k + 1):
            _same(_topm(emulated, fa, faw, hs, 5.0, m),
                  peaks_plain(fa, faw, hs, 5.0, m))
    faw = np.full((2, 256), -5.0, np.float32)
    faw[:, [5, 9, 13, 40]] = [-0.0, 0.0, -0.0, -0.5]
    faw[1, [9, 100]] = [0.0, -0.0]
    faw = torch.from_numpy(faw)
    fa, hs = torch.rand(2, 256), torch.rand(2, 256)
    got = _topm(emulated, fa, faw, hs, -1.0, 5)
    _same(got, peaks_plain(fa, faw, hs, -1.0, 5))
    assert got[0][0].tolist() == [5, 9, 13, 40, 0]


def _cands(rng, shape, bins):
    """Cand [..., 4] f32 (faw, bin bits, fa, hs) with faw from a few
    values (ties across lists and pairs)."""
    c = np.zeros((*shape, 4), np.float32)
    c[..., 0] = 5.0 + rng.integers(0, 12, shape) * 0.5
    c[..., 1] = bins.astype(np.int32).view(np.float32)
    c[..., 2:] = rng.random((*shape, 2))
    return c


def _merge_inputs(rows, nl, npairs, m, seed):
    """The producer's lists [rows, L, M] (sorted, ended by -inf, garbage
    behind the end as K1 / K2 leave it) and pairs [rows, P, 2]; the plain
    copies hold -inf behind the end.  Row 0 holds no candidate, row 1 a
    candidate of value +inf (merge_peaks: its slot not valid)."""
    rng = np.random.default_rng(seed)
    lists = np.zeros((rows, nl, m, 4), np.float32)
    plain = np.zeros_like(lists)
    pairs = np.zeros((rows, max(npairs, 1), 2, 4), np.float32)
    for r in range(rows):
        bins = rng.permutation(8192)[:nl * m + 2 * npairs]
        c = _cands(rng, (nl, m), bins[:nl * m].reshape(nl, m))
        for i in range(nl):
            n = [0, 0, 1, m, int(rng.integers(0, m + 1))][
                int(rng.integers(0, 5))] if r else 0
            if r == 1 and i == 0:              # +inf: a slot, not valid
                n = max(n, 1)
                c[i, 0, 0] = np.inf
            key = sorted(range(m), key=lambda s: (-c[i, s, 0],
                                                  c[i, s, 1].view(np.int32)))
            c[i] = c[i, key]
            plain[r, i] = c[i]
            plain[r, i, n:, 0] = -np.inf
            lists[r, i] = c[i]
            if n < m:
                lists[r, i, n, 0] = -np.inf
        if npairs:
            p = _cands(rng, (npairs, 2), bins[nl * m:].reshape(npairs, 2))
            failed = (rng.random((npairs, 2)) < 0.25) | (r == 0)
            p[..., 1] = np.where(failed, np.int32(-1).view(np.float32),
                                 p[..., 1])
            pairs[r, :npairs] = p
    return lists, plain, pairs


def _split(a):
    """[..., 4] Cand f32 -> (faw, bin int32, fa, hs) tensors."""
    b = np.ascontiguousarray(a[..., 1]).view(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (a[..., 0], b, a[..., 2], a[..., 3]))


@pytest.mark.parametrize("m", [1, 8, 9, 16])
@pytest.mark.parametrize("nl,npairs", [(8, 14), (20, 12), (6, 0), (32, 32),
                                        (40, 40)],
                         ids=["K1-SF8", "32-items", "no-pairs", "K2-SF10",
                              "wide"])
def test_emulated_merge_equals_plain(emulated, nl, npairs, m):
    """Both list instances (M <= 8, M <= 16) in 8-lane groups and, past
    32 lists and pairs, a warp a row: empty, single and full lists with
    garbage behind their end, pairs resolved either way and failed
    entries, ties, a candidate of +inf: equal to merge_peaks bit for bit,
    launched as a programmatic dependent."""
    rows = 19
    lists, plain, pairs = _merge_inputs(rows, nl, npairs, m, 31 * m + nl)
    out = _outputs(rows, m)
    err = emulated.emu_merge(lists.ctypes.data, nl,
                             pairs.ctypes.data if npairs else None, npairs,
                             rows, m, *(t.data_ptr() for t in out))
    assert err == 0 and emulated.emu_pdl() == 1
    ref = merge_peaks(_split(plain), _split(pairs[:, :npairs])
                      if npairs else None, m)
    _same(out, ref)
    assert out[3][1:].any() and not out[3][0].any()
