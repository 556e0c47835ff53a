"""The dense-spectra kernels' plain versions against the JAX Pallas kernels
(run with ``interpret=True``), and the lattice dispatch against the JAX
package's.

K3 (ops/rdft_spectra.py), K4b and K4 (ops/direct.py) and K5
(ops/overlap_spectra.py) each get the same numpy-seeded IQ as the JAX
kernel.  Tolerances, as a bound on max |delta| over max |ref| of each of
fa / faw / hs:

- K3 against ``rev="flip"``: 2e-4.  Both round the f32 dechirp product to
  bf16 once, but XLA may contract it into an FMA, so an operand can land
  one bf16 step away (measured up to 7.5e-5 at SF7 x ff 2).
- K3 against the default ``rev="matmul"``: 5e-3, the bf16 rounding of the
  TPU kernel's mirror magnitudes (2^-8; measured 2.4e-3).
- K4b: 1e-5.  Same bf16 frames and bit-equal weights; only the f32
  accumulation order differs (measured 6e-7).
- K5: 1e-5.  The port's chunk DFT is an f32 FFT, JAX's an f32 matmul at
  ``precision="highest"`` (measured 4e-7).

Peak sets must be equal up to f32 ties (ops/peak_epilogue.compare_peaks),
peak heights within rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu.models.pyramid import peak_lattice_fn as jax_lattice_fn
from gr_lora_tpu.ops.pallas_direct import (_weights, make_direct_peaks,
                                           make_direct_spectra)
from gr_lora_tpu.ops.pallas_overlap import make_overlap_spectra
from gr_lora_tpu.ops.pallas_rdft import make_rdft_spectra
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import (BlockedLattice, DenseLattice,
                                              num_hops_for, peak_lattice_fn)
from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.ops.direct import (DirectPeaks, DirectSpectra,
                                          direct_weights)
from gr_lora_tpu_torch.ops.overlap_peaks import OverlapPeaks
from gr_lora_tpu_torch.ops.overlap_spectra import OverlapSpectra
from gr_lora_tpu_torch.ops.peak_epilogue import compare_peaks, peaks_plain
from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks
from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra
from test_torch_core import config_pair

GRID = [(7, 8), (8, 8), (7, 2)]
MAX_HOPS = 256


def _cfg(sf, ff, p=2):
    """(JAX config, port config)."""
    return config_pair(sf=sf, cr=1, crc=True, ldr=False,
                       explicit_header=True, payload_len=4, p=p,
                       fft_factor=ff, threshold=5.0)


def _signal(cfg, seed):
    """One packet in noise: (iq float32 [T, 2], hops <= MAX_HOPS)."""
    n = cfg.num_samples
    pkt = 0.2 * modulate(encode(bytes([1, 2, 3, cfg.sf]), cfg), cfg,
                         pad_front=0, pad_back=0)
    rng = np.random.default_rng(seed)
    total = len(pkt) + 6 * n
    iq = (0.01 * (rng.standard_normal(total)
                  + 1j * rng.standard_normal(total))).astype(np.complex64)
    iq[2 * n:2 * n + len(pkt)] += pkt
    return to_ri(iq), min(num_hops_for(cfg, total), MAX_HOPS)


def _assert_close(ours, ref, tol):
    for a, b in zip(ours, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        err = np.max(np.abs(a - b)) / np.abs(b).max()
        assert err <= tol, err


def _jax(fn, iq):
    return jax.device_get(fn(jnp.asarray(iq)))


def _peaks(spectra, cfg, m=8):
    return peaks_plain(*(torch.from_numpy(np.array(s)) for s in spectra),
                       float(cfg.threshold), m)


@pytest.mark.parametrize("sf,ff", GRID)
def test_rdft_spectra_plain_matches_jax(sf, ff):
    jcfg, cfg = _cfg(sf, ff)
    iq, nh = _signal(cfg, seed=sf * ff)
    ours = RdftSpectra(cfg, nh)(torch.from_numpy(iq))
    flip = _jax(make_rdft_spectra(jcfg, nh, rev="flip", interpret=True), iq)
    _assert_close(ours, flip, 2e-4)
    ref = _peaks(flip, cfg)
    assert ref[3].any()
    compare_peaks(ref, _peaks(ours, cfg), 1e-4, faw=flip[1],
                  threshold=cfg.threshold)
    matmul = _jax(make_rdft_spectra(jcfg, nh, interpret=True), iq)
    _assert_close(ours, matmul, 5e-3)


@pytest.mark.parametrize("sf,ff", GRID)
def test_direct_spectra_plain_matches_jax(sf, ff):
    jcfg, cfg = _cfg(sf, ff)
    iq, nh = _signal(cfg, seed=sf * ff + 1)
    ours = DirectSpectra(cfg, nh)(torch.from_numpy(iq))
    ref = _jax(make_direct_spectra(jcfg, nh, interpret=True), iq)
    _assert_close(ours, ref, 1e-5)
    compare_peaks(_peaks(ref, cfg), _peaks(ours, cfg), 1e-4, faw=ref[1],
                  threshold=cfg.threshold)


@pytest.mark.parametrize("sf,ff", [(7, 8), (7, 2), (8, 2)])
def test_direct_weights_equal_jax_bits(sf, ff):
    """W is built as the JAX kernel builds it (float64 product, f32,
    bf16), in its ``kt = 16`` column layout: equal bit for bit."""
    jcfg, cfg = _cfg(sf, ff)
    ref = np.asarray(_weights(jcfg, 16)).view(np.uint16)
    ours = direct_weights(sf, cfg.p, ff, float(cfg.beta))
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
    assert np.array_equal(ours.view(torch.int16).numpy().view(np.uint16), ref)


@pytest.mark.parametrize("sf,ff", [(7, 8), (8, 8)])
def test_direct_peaks_plain_matches_jax(sf, ff):
    """K4's per-tile top-M with the one-bin tile extension, merged by a
    cross-tile top_k, picks the peaks of the dense epilogue."""
    jcfg, cfg = _cfg(sf, ff)
    iq, nh = _signal(cfg, seed=sf + 3)
    ref = _jax(make_direct_peaks(jcfg, nh, 8, interpret=True), iq)
    x = torch.from_numpy(iq)
    mod = DirectPeaks(cfg, nh, 8)
    ours = mod(x)
    assert ref[3].any()
    _, faw, _ = mod.front.plain(x)
    compare_peaks(ref, ours, 1e-4, faw=faw, threshold=cfg.threshold)


@pytest.mark.parametrize("sf,ff", GRID)
def test_overlap_spectra_plain_matches_jax(sf, ff):
    jcfg, cfg = _cfg(sf, ff)
    iq, nh = _signal(cfg, seed=sf * ff + 2)
    ours = OverlapSpectra(cfg, nh)(torch.from_numpy(iq))
    ref = _jax(make_overlap_spectra(jcfg, nh, interpret=True), iq)
    _assert_close(ours, ref, 1e-5)
    compare_peaks(_peaks(ref, cfg), _peaks(ours, cfg), 1e-4, faw=ref[1],
                  threshold=cfg.threshold)


def test_plain_versions_leave_tf32_setting_alone():
    """The plain bf16 products read the process's TF32 setting and never
    write it (TF32 leaves bf16 operands exact)."""
    _, cfg = _cfg(7, 2)
    x = torch.from_numpy(_signal(cfg, seed=5)[0])
    prev = torch.backends.cuda.matmul.allow_tf32
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = flag
        try:
            a = RdftSpectra(cfg, 16)(x)
            b = DirectSpectra(cfg, 16)(x)
            c = ChunkSpectra(cfg, 16)(x)
            RdftPeaks(cfg, 16)(x)
            DirectPeaks(cfg, 16)(x)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        if flag:
            first = (*a, *b, *c)
        else:
            for u, v in zip(first, (*a, *b, *c)):
                assert torch.equal(u, v)


def _jax_kind(fn):
    """What the JAX dispatch chose, read off the returned function."""
    q = fn.__qualname__
    for make, kind in (("make_rdft_peaks", "K1"),
                       ("make_direct_peaks", "K4"),
                       ("make_overlap_peaks", "K2")):
        if q.startswith(make):
            return kind
    cells = dict(zip(fn.__code__.co_freevars,
                     (c.cell_contents for c in fn.__closure__ or ())))
    if q.endswith("run_blocked"):
        return ("blocked", cells["block_hops"], _jax_kind(cells["inner"]))
    return cells["spectra"].__name__.removeprefix("spectra_")


def _kind(mod):
    if isinstance(mod, BlockedLattice):
        return ("blocked", mod.block_hops, _kind(mod.inner))
    if isinstance(mod, DenseLattice):
        return mod.backend
    return {RdftPeaks: "K1", DirectPeaks: "K4", OverlapPeaks: "K2"}[type(mod)]


_ALL = ("xla", "fast", "rdft", "direct", "fastp", "pallas", "fused",
        "fused_direct")
#: Large plans build no dense weight block here (the direct one is 134 MB
#: at SF9 x ff 8): their cases take the backends without one.
_NO_DENSE_W = ("xla", "fast", "fastp", "fused", "fused_direct")
DISPATCH = [(cfg, b) for cfg, backends in [
    ((7, 8, 2, 40, None), _ALL), ((8, 8, 2, 300, 128), _ALL),
    ((7, 2, 2, 40, None), _ALL), ((9, 8, 2, 96, 32), _NO_DENSE_W),
    ((10, 8, 2, 96, 32), _NO_DENSE_W), ((9, 1, 16, 64, 32), _NO_DENSE_W)]
    for b in backends]


@pytest.mark.parametrize("case,backend", DISPATCH)
def test_lattice_dispatch_matches_jax(case, backend):
    """Each backend picks the lattice the JAX package picks, including
    'fused_direct' -> K4 where n*4*K <= 2^23 else K2, 'fused' falling
    back to dense 'xla' (then 'fast') where the overlap kernel's tiling
    does not apply, and block_hops honoured by every dense backend."""
    sf, ff, p, hops, block = case
    jcfg, cfg = _cfg(sf, ff, p)
    ref = _jax_kind(jax_lattice_fn(jcfg, hops, 8, backend, block))
    assert _kind(peak_lattice_fn(cfg, hops, 8, backend, block)) == ref


def test_pallas_backend_not_ported():
    """Backend "pallas" builds the dense lattice on K6's front end and is
    blocked like "fastp" (the dispatch cases above hold it against the
    JAX dispatch)."""
    _, cfg = _cfg(7, 8)
    mod = peak_lattice_fn(cfg, 16, 8, "pallas")
    assert isinstance(mod, DenseLattice) and type(mod.front) is ChunkSpectra
    blocked = peak_lattice_fn(cfg, 300, 8, "pallas", block_hops=128)
    fastp = peak_lattice_fn(cfg, 300, 8, "fastp", block_hops=128)
    assert isinstance(blocked, BlockedLattice)
    assert type(blocked.inner.front) is ChunkSpectra
    assert (blocked.block_hops, blocked.seg, blocked.inner.num_hops) == \
        (fastp.block_hops, fastp.seg, fastp.inner.num_hops)
