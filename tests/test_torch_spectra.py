"""The port's dense spectra against the JAX package at precision 'highest'.

The port computes the dechirp + zoom DFT as a complex64 ``torch.fft``
where the JAX package uses f32 matmuls; both are f32 transforms summed in
another order, so they agree to max |delta| <= 1e-4 * max |ref|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gr_lora_tpu.ops import dechirp as jdechirp
from gr_lora_tpu.ops.overlap_dft import fast_pyramid_spectra as jfast
from gr_lora_tpu_torch.ops import dechirp as tdechirp
from gr_lora_tpu_torch.ops.overlap_dft import fast_pyramid_spectra
from test_torch_core import config_pair

RTOL = 1e-4


def _cfg(sf, ff, p=2):
    """(JAX config, port config)."""
    return config_pair(sf=sf, cr=1, crc=True, ldr=False,
                       explicit_header=True, payload_len=8, p=p,
                       fft_factor=ff, threshold=5.0, precision="highest")


def _close(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.max(np.abs(ours - ref)) <= RTOL * np.max(np.abs(ref))


def _frames(cfg, num, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((num, cfg.num_samples, 2)).astype(np.float32)


@pytest.mark.parametrize("sf,ff", [(7, 2), (8, 2), (8, 8)])
def test_up_bands_match_jax(sf, ff):
    jcfg, cfg = _cfg(sf, ff)
    fr = _frames(cfg, 6, sf + ff)
    lo, hi = tdechirp.up_bands(torch.from_numpy(fr), cfg)
    rlo, rhi = jdechirp.up_bands(jnp.asarray(fr), jcfg)
    _close(lo, rlo)
    _close(hi, rhi)


@pytest.mark.parametrize("sf,ff,p", [(7, 8, 2), (8, 8, 2), (7, 2, 8)])
def test_pyramid_spectra_match_jax(sf, ff, p):
    jcfg, cfg = _cfg(sf, ff, p)
    fr = _frames(cfg, 5, sf * ff)
    ours = tdechirp.pyramid_spectra(torch.from_numpy(fr), cfg)
    ref = jdechirp.pyramid_spectra(jnp.asarray(fr), jcfg)
    for a, b in zip(ours, ref):
        _close(a, b)


@pytest.mark.parametrize("sf,ff", [(7, 8), (8, 8), (9, 8)])
def test_fast_pyramid_spectra_match_jax(sf, ff):
    jcfg, cfg = _cfg(sf, ff)
    nh = 40
    rng = np.random.default_rng(sf)
    total = (nh + 7) * cfg.num_samples // 8
    iq = rng.standard_normal((total, 2)).astype(np.float32)
    ours = fast_pyramid_spectra(torch.from_numpy(iq), cfg, nh)
    ref = jfast(jnp.asarray(iq), jcfg, nh)
    for a, b in zip(ours, ref):
        _close(a, b)


def test_fast_matches_framed_spectra():
    """The overlap decomposition equals explicit framing in the port too."""
    _, cfg = _cfg(8, 8)
    n, hop, nh = cfg.num_samples, cfg.num_samples // 8, 24
    rng = np.random.default_rng(11)
    iq = torch.from_numpy(rng.standard_normal(
        ((nh + 7) * hop, 2)).astype(np.float32))
    framed = tdechirp.pyramid_spectra(
        tdechirp.frame_signal(iq, n, hop, nh), cfg)
    for a, b in zip(fast_pyramid_spectra(iq, cfg, nh), framed):
        assert torch.max(torch.abs(a - b)) <= RTOL * torch.max(torch.abs(b))
