"""The port's folded tone probes (ops/dechirp: ``band_peak`` in its three
peak-search modes, ``up_peak``, ``down_peak``, ``up_peak_stats``,
``down_bands``) against the JAX package's, at precision 'highest'.

Windows are numpy-seeded noise, and up and down chirps at chosen symbol
values over a little noise, at SF7-8 x fft_factor 1 / 8 x p 1 / 2.  The
port's transform is a complex64 ``torch.fft`` where the JAX package uses
f32 matmuls: peak indices must be equal, peak values within rtol 1e-4,
the bands within 1e-4 of their largest magnitude.  ``band_peak`` is also
fed the same bands in both packages, where the arithmetic is the same.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gr_lora_tpu.ops import dechirp as jdechirp
from gr_lora_tpu_torch.config import PeakSearch
from gr_lora_tpu_torch.ops import dechirp as tdechirp
from gr_lora_tpu_torch.ops.chirp import symbol_chirp
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_torch_core import config_pair

RTOL = 1e-4
GRID = [(sf, ff, p) for sf in (7, 8) for ff in (1, 8) for p in (1, 2)]
MODES = [PeakSearch.ABS, PeakSearch.PHASE, PeakSearch.B]


def _cfg(sf, ff, p, mode=PeakSearch.ABS):
    return config_pair(sf=sf, p=p, fft_factor=ff, precision="highest",
                       peak_search=mode, peak_phase_k=4)


def _windows(cfg, seed):
    """[12, N, 2]: four noise windows, four up-chirps and four down-chirps
    at seeded symbol values, each chirp over noise at 0.01."""
    rng = np.random.default_rng(seed)
    n, m = cfg.num_samples, 1 << cfg.sf
    noise = (rng.standard_normal((12, n))
             + 1j * rng.standard_normal((12, n))).astype(np.complex64)
    syms = rng.integers(0, m, 8)
    chirps = [symbol_chirp(int(v), cfg.sf, cfg.p) for v in syms]
    w = noise.copy()
    w[4:8] = 0.01 * noise[4:8] + np.stack(chirps[:4])
    w[8:] = 0.01 * noise[8:] + np.conj(np.stack(chirps[4:]))
    return to_ri(w)


def _peaks_equal(ours, ref):
    idx, val = (t.numpy() for t in ours)
    ridx, rval = (np.asarray(x) for x in ref)
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(val, rval, rtol=RTOL)


def _bands_close(ours, ref):
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= RTOL * np.max(np.abs(b))


@pytest.mark.parametrize("sf,ff,p", GRID)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_band_peak_same_bands(sf, ff, p, mode):
    """band_peak on the same (lo, hi) bands in both packages."""
    jcfg, cfg = _cfg(sf, ff, p, mode)
    lo, hi = tdechirp.up_bands(torch.from_numpy(_windows(cfg, sf + ff + p)),
                               cfg)
    _peaks_equal(tdechirp.band_peak(lo, hi, cfg),
                 jdechirp.band_peak(jnp.asarray(lo.numpy()),
                                    jnp.asarray(hi.numpy()), jcfg))


@pytest.mark.parametrize("sf,ff,p", GRID)
@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_up_and_down_peaks_match_jax(sf, ff, p, mode):
    jcfg, cfg = _cfg(sf, ff, p, mode)
    w = _windows(cfg, 10 * sf + ff + p)
    x, jx = torch.from_numpy(w), jnp.asarray(w)
    _peaks_equal(tdechirp.up_peak(x, cfg), jdechirp.up_peak(jx, jcfg))
    _peaks_equal(tdechirp.down_peak(x, cfg), jdechirp.down_peak(jx, jcfg))


@pytest.mark.parametrize("sf,ff,p", GRID)
def test_stats_and_down_bands_match_jax(sf, ff, p):
    """up_peak_stats folds ABS whatever cfg.peak_search says."""
    jcfg, cfg = _cfg(sf, ff, p, PeakSearch.PHASE)
    w = _windows(cfg, 100 + sf + ff + p)
    x, jx = torch.from_numpy(w), jnp.asarray(w)
    for a, b in zip(tdechirp.up_peak_stats(x, cfg),
                    jdechirp.up_peak_stats(jx, jcfg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    _bands_close(tdechirp.down_bands(x, cfg), jdechirp.down_bands(jx, jcfg))


def test_chirp_windows_peak_at_their_symbols():
    """An up-chirp of value v dechirps to bin v * ff; the port's down
    plan takes an SFD window to bin 0."""
    _, cfg = _cfg(8, 8, 2)
    w = _windows(cfg, 3)
    rng = np.random.default_rng(3)
    rng.standard_normal((2, 12, cfg.num_samples))
    syms = rng.integers(0, 1 << cfg.sf, 8)
    up, _ = tdechirp.up_peak(torch.from_numpy(w[4:8]), cfg)
    np.testing.assert_array_equal(up.numpy(), syms[:4] * cfg.fft_factor)
    sfd = to_ri(np.conj(symbol_chirp(0, cfg.sf, cfg.p)))
    down, _ = tdechirp.down_peak(torch.from_numpy(sfd), cfg)
    assert int(down) == 0


def test_device_plans_cached_per_device():
    """One plan a (direction, shape, device); a CPU builder call returns a
    fresh module, so moving it moves no cached plan."""
    a = tdechirp.device_plan("up", 7, 2, 8, torch.device("cpu"))
    assert a is tdechirp.device_plan("up", 7, 2, 8, torch.device("cpu"))
    assert a is not tdechirp.device_plan("down", 7, 2, 8,
                                         torch.device("cpu"))
    assert tdechirp.up_plan(7, 2, 8) is not tdechirp.up_plan(7, 2, 8)
