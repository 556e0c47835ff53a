"""K1 (ops/rdft_peaks.py) plain version against the JAX rDFT kernel.

The JAX kernel runs in interpret mode with ``rev="flip"``: its default
``"matmul"`` lane reversal rounds the mirror magnitudes to bf16, which the
port drops on purpose.  Both sides round the same f32 dechirp products to
bf16 once and accumulate exact bf16 products in f32, so peak sets must be
identical per hop and heights agree to rtol 1e-4 (the f32 accumulation
order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu.ops.pallas_rdft import make_rdft_peaks
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import num_hops_for, peak_lattice_fn
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.ops.peak_epilogue import compare_peaks
from gr_lora_tpu_torch.ops.rdft_peaks import RdftPeaks, rdft_peaks_supported
from test_torch_core import config_pair

RTOL = 1e-4


def _signal(cfg, seed):
    n = cfg.num_samples
    pkt = 0.2 * modulate(encode(bytes([1, 2, 3, cfg.sf]), cfg), cfg,
                         pad_front=0, pad_back=0)
    rng = np.random.default_rng(seed)
    total = len(pkt) + 6 * n
    iq = (0.01 * (rng.standard_normal(total)
                  + 1j * rng.standard_normal(total))).astype(np.complex64)
    iq[2 * n:2 * n + len(pkt)] += pkt
    return to_ri(iq), total


@pytest.mark.parametrize("sf,ff", [(7, 8), (7, 2), (8, 8), (8, 2)])
def test_rdft_plain_matches_jax_kernel(sf, ff):
    jcfg, cfg = config_pair(sf=sf, cr=1, crc=True, ldr=False,
                            explicit_header=True, payload_len=4, p=2,
                            fft_factor=ff, threshold=5.0)
    assert rdft_peaks_supported(cfg)
    iq, total = _signal(cfg, seed=sf * ff)
    nh = num_hops_for(cfg, total)
    ref = jax.device_get(jax.jit(make_rdft_peaks(
        jcfg, nh, 8, rev="flip", interpret=True))(jnp.asarray(iq)))
    ours = RdftPeaks(cfg, nh, 8)(torch.from_numpy(iq))
    assert ref[3].any()
    compare_peaks(ref, ours, RTOL)


def test_rdft_batched_lanes_match_single():
    """Leading batch dims (the gateway's event lanes) give each lane's own
    single-stream result."""
    _, cfg = config_pair(sf=7, cr=1, crc=True, ldr=False,
                         explicit_header=True, payload_len=4, p=2,
                         fft_factor=8, threshold=5.0)
    a, total = _signal(cfg, seed=1)
    b, _ = _signal(cfg, seed=2)
    nh = num_hops_for(cfg, total)
    mod = RdftPeaks(cfg, nh, 8)
    both = mod(torch.from_numpy(np.stack([a, b])))
    for lane, x in enumerate((a, b)):
        one = mod(torch.from_numpy(x))
        for u, v in zip(one, both):
            assert torch.equal(u, v[lane])


def test_fused_dispatch_and_short_input():
    """'fused' picks K1 at SF7-9 x ff 8; frames past the capture end are
    zero-padded, so a short input yields no peaks there."""
    _, cfg = config_pair(sf=9, cr=1, crc=True, ldr=False,
                         explicit_header=True, payload_len=4, p=2,
                         fft_factor=8, threshold=5.0)
    lat = peak_lattice_fn(cfg, 40, 8, "fused")
    assert isinstance(lat, RdftPeaks)
    iq = torch.zeros((cfg.num_samples, 2))
    bins, h, hs, valid = lat(iq)
    assert bins.shape == (40, 8) and bins.dtype == torch.int32
    assert not valid.any() and not h.any() and not bins.any()
