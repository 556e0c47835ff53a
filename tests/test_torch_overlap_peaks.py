"""K2 (ops/overlap_peaks.py) plain version against the JAX overlap kernel.

Both evaluate the f32 overlap decomposition (chunk DFT, 8-term j-sum,
window taps, folds) and the same epilogue, in another summation order:
peak sets must be identical per hop, heights within rtol 1e-4.
"""

import numpy as np
import torch

import jax

from gr_lora_tpu.ops.overlap_dft import fast_pyramid_spectra as jax_fast
from gr_lora_tpu.ops.pallas_peaks import make_overlap_peaks
from gr_lora_tpu_torch.models.pyramid import (BlockedLattice, num_hops_for,
                                              peak_lattice_fn)
from gr_lora_tpu_torch.ops.overlap_peaks import (OverlapPeaks,
                                                 overlap_peaks_supported)
from gr_lora_tpu_torch.ops.peak_epilogue import compare_peaks
from test_pallas_peaks import _fixture
from test_torch_core import config_pair

RTOL = 1e-4
JAX_CFG9, CFG9 = config_pair(sf=9, cr=1, crc=True, ldr=False,
                             explicit_header=True, payload_len=4,
                             fft_factor=8, threshold=5.0)


def test_overlap_plain_matches_jax_kernel():
    """The fixture's hop-aligned packet leaves symmetric two-bin plateaus
    in faw; where the reference's two bins tie in f32, the strict local
    max may sit on either (compare_peaks), and only there."""
    assert overlap_peaks_supported(CFG9)          # K/8 = 512
    iq, total = _fixture(JAX_CFG9, seed=9, tail=12)
    nh = num_hops_for(CFG9, total)
    ref = jax.device_get(jax.jit(make_overlap_peaks(JAX_CFG9, nh, 8,
                                                    interpret=True))(iq))
    ref_faw = np.asarray(jax_fast(iq, JAX_CFG9, nh)[1])
    ours = OverlapPeaks(CFG9, nh, 8)(torch.from_numpy(np.array(iq)))
    npeaks = int(ref[3].sum())
    assert npeaks > 0
    _, moved = compare_peaks(ref, ours, RTOL, faw=ref_faw,
                             threshold=CFG9.threshold)
    assert moved <= max(2, npeaks // 100), (moved, npeaks)


def test_overlap_blocked_matches_unblocked():
    """block_hops=64 slicing around K2 (each hop window is
    self-contained) gives the unblocked peaks."""
    iq, total = _fixture(JAX_CFG9, seed=3, tail=10)
    x = torch.from_numpy(np.array(iq))
    nh = num_hops_for(CFG9, total)
    assert nh > 64
    whole = OverlapPeaks(CFG9, nh, 8)(x)
    blocked = BlockedLattice(OverlapPeaks(CFG9, 64, 8), CFG9, nh, 64)(x)
    compare_peaks(whole, blocked, 1e-5)


def test_fused_dispatches_k2_with_blocks_at_sf10():
    """'fused' at SF10 x ff 8 is K2 (no rDFT fit), wrapped in block_hops;
    it equals the port's dense 'fast' backend + plain epilogue."""
    cfg = CFG9.replace(sf=10)
    iq, total = _fixture(JAX_CFG9.replace(sf=10), seed=10, tail=4)
    x = torch.from_numpy(np.array(iq))
    nh = num_hops_for(cfg, total)
    lat = peak_lattice_fn(cfg, nh, 8, "fused", block_hops=96)
    assert isinstance(lat, BlockedLattice)
    assert isinstance(lat.inner, OverlapPeaks)
    ref = peak_lattice_fn(cfg, nh, 8, "fast")(x)
    compare_peaks(ref, lat(x), 1e-5)
