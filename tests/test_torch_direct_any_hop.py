"""K4b and K4 at the hops where hop = n / 8 is no multiple of 32 samples
(SF6 x p 2 and SF7 x p 1: hop 16; SF6 x p 1: hop 8; SF7 x p 3: hop 48),
where the kernel walks chunk rows instead of sample planes.

- The plain versions against the JAX Pallas kernels (``interpret=True``,
  as tests/test_pallas_direct.py runs them) on the same numpy-seeded IQ:
  the spectra within 1e-5 of the largest value (same bf16 frames and
  bit-equal weights, only the f32 accumulation order differs, as at the
  other hops: tests/test_torch_dense_kernels.py), the peaks equal up to
  f32 ties with heights within rtol 1e-4.
- Which walk a module takes, and the chunk walk's depth order
  (``chunk_depths``): a permutation of the frame columns plus zero pad
  (its weights: tests/test_torch_product_tiles.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gr_lora_tpu.ops.pallas_direct import (make_direct_peaks,
                                           make_direct_spectra)
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import num_hops_for
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.ops.direct import (DirectPeaks, DirectSpectra,
                                          chunk_depths, plane_walk)
from gr_lora_tpu_torch.ops.peak_epilogue import compare_peaks, peaks_plain
from test_torch_core import config_pair

MAX_HOPS = 160


def _cfg(sf, ff, p):
    """(JAX config, port config); SF6 takes the implicit header."""
    return config_pair(sf=sf, cr=1, crc=True, ldr=False,
                       explicit_header=sf > 6, payload_len=4, p=p,
                       fft_factor=ff, threshold=5.0)


def _signal(cfg, seed):
    n = cfg.num_samples
    pkt = 0.2 * modulate(encode(bytes([1, 2, 3, cfg.sf]), cfg), cfg,
                         pad_front=0, pad_back=0)
    rng = np.random.default_rng(seed)
    total = len(pkt) + 6 * n
    iq = (0.01 * (rng.standard_normal(total)
                  + 1j * rng.standard_normal(total))).astype(np.complex64)
    iq[2 * n:2 * n + len(pkt)] += pkt
    return to_ri(iq), min(num_hops_for(cfg, total), MAX_HOPS)


def _jax(fn, iq):
    return jax.device_get(fn(jnp.asarray(iq)))


@pytest.mark.parametrize("sf,ff,p", [(6, 8, 2), (7, 8, 1)])
def test_direct_spectra_plain_matches_jax_any_hop(sf, ff, p):
    jcfg, cfg = _cfg(sf, ff, p)
    assert not plane_walk(cfg.num_samples // 8)
    iq, nh = _signal(cfg, seed=sf * ff + p)
    ours = DirectSpectra(cfg, nh)(torch.from_numpy(iq))
    ref = _jax(make_direct_spectra(jcfg, nh, interpret=True), iq)
    for a, b in zip(ours, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= 1e-5 * np.abs(b).max()
    thr = float(cfg.threshold)
    ref_peaks = peaks_plain(*(torch.from_numpy(np.array(s)) for s in ref),
                            thr, 8)
    assert ref_peaks[3].any()
    compare_peaks(ref_peaks, peaks_plain(*ours, thr, 8), 1e-4,
                  faw=torch.from_numpy(np.array(ref[1])), threshold=thr)


@pytest.mark.parametrize("sf,ff,p", [(6, 8, 2), (7, 8, 1)])
def test_direct_peaks_plain_matches_jax_any_hop(sf, ff, p):
    jcfg, cfg = _cfg(sf, ff, p)
    iq, nh = _signal(cfg, seed=sf + ff + p)
    ref = _jax(make_direct_peaks(jcfg, nh, 8, interpret=True), iq)
    x = torch.from_numpy(iq)
    mod = DirectPeaks(cfg, nh, 8)
    assert ref[3].any()
    _, faw, _ = mod.front.plain(x)
    compare_peaks(ref, mod(x), 1e-4, faw=faw, threshold=cfg.threshold)


@pytest.mark.parametrize("sf,p,walk", [(8, 2, True), (9, 1, True),
                                       (6, 2, False), (7, 1, False),
                                       (6, 4, True), (7, 3, False)])
def test_walk_choice(sf, p, walk):
    """The plane walk where hop is a multiple of 32 samples, else the
    chunk walk with its own W buffer, whose depths read every frame
    column once."""
    _, cfg = _cfg(sf, 1, p)
    mod = DirectSpectra(cfg, 8)
    assert mod.plane_walk is walk
    assert hasattr(mod, "w_kernel") is not walk
    n = cfg.num_samples
    src = chunk_depths(n)
    assert sorted(src[src >= 0].tolist()) == list(range(2 * n))
    if not walk:
        assert mod.w_kernel.shape[0] == src.numel()
        assert not mod.w_kernel[src < 0].view(torch.int16).any()
