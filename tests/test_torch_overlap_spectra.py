"""K5's sheared walk (ops/overlap_spectra.sheared_spectra, the plain-torch
model of csrc/overlap_spectra.cu) against the roll-based plain version,
and the plan facts the walk rests on.

The walk substitutes e = c + sigma_1 b and takes rho_j[c] from one period
(``rho_period``), so it needs sigma_j = j sigma_1 (mod F) with sigma_1 a
multiple of P = 8 fft_factor, and ``rho_period`` close to the full table
(within 7e-16 N: 6e-12 up to N = 8192).  fft_factor 16 is included: its
window halo is 112 bins, so a band's row with both halos is 480 columns
(the kernel's wider ring instance).  The model rounds every
operation as ``spectra_from_chunks`` does, in its order: the two must be
equal bit for bit, for small bands (including the ones whose rows wrap
at F), several hop runs, p = 2 (every column yields an output through
the fold pairing) and p = 4 (only columns whose bin falls in [0, K)
do).
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch.ops.overlap_dft import OverlapPlan, spectra_from_chunks
from gr_lora_tpu_torch.ops.overlap_spectra import sheared_spectra

GRID = [(sf, ff, p) for sf in range(7, 13) for ff in (1, 2, 8)
        for p in (1, 2, 4)]


@pytest.mark.parametrize("sf,ff,p", [(sf, ff, p) for sf in (7, 8)
                                     for ff in (1, 2, 8) for p in (2, 4)]
                         + [(7, 16, 2), (8, 16, 2)])
def test_sheared_walk_equals_plain(sf, ff, p):
    plan = OverlapPlan(sf, p, ff, 25.0)
    f, nh = plan.fft_size, 28
    band = max(32, plan.period)
    rng = np.random.default_rng(100 * sf + 10 * ff + p)
    g = torch.from_numpy(rng.standard_normal(
        (2, nh + 7, f, 2)).astype(np.float32))
    # Band 0's rows start at bin -halo - sigma_1 r (mod F) and so wrap.
    halo = max(abs(s) for s in plan.win_shifts.tolist())
    assert any((-halo - plan.sigma_list[1] * r) % f + band + 2 * halo > f
               for r in range(nh + 7))
    ref = spectra_from_chunks(g, plan, nh)
    got = sheared_spectra(g, plan, nh, band=band, run=12)
    for a, b in zip(got, ref):
        assert torch.equal(a, b), float((a - b).abs().max())


def test_sheared_walk_refuses_a_band_off_the_period():
    plan = OverlapPlan(7, 2, 8, 25.0)
    g = torch.zeros((1, 15, plan.fft_size, 2))
    with pytest.raises(ValueError):
        sheared_spectra(g, plan, 8, band=32)


@pytest.mark.parametrize("sf,ff,p", GRID)
def test_sigma_is_a_multiple_of_the_period(sf, ff, p):
    plan = OverlapPlan(sf, p, ff, 25.0)
    f, s1 = plan.fft_size, plan.sigma_list[1]
    assert plan.period == 8 * ff
    assert s1 % plan.period == 0 and (f - s1) == plan.bin_size // 8
    assert plan.sigma_list == tuple(j * s1 % f for j in range(8))


@pytest.mark.parametrize("sf,ff,p", GRID)
def test_rho_period_is_close_to_rho(sf, ff, p):
    plan = OverlapPlan(sf, p, ff, 25.0)
    f, per = plan.fft_size, plan.period
    assert plan.rho_period.shape == (8, per, 2)
    assert torch.equal(plan.rho_period, plan.rho[:, :per])
    # The float64 phase 2 pi j c / P rounds to ~1e-16 of its size, up to
    # 2 pi 7 N / 8 at c < F: 1.3e-12 at N = 2048, 5.3e-12 at N = 8192,
    # 1.1e-11 at N = 16384 (SF12, p = 4).
    tiled = plan.rho_period.double().repeat(1, f // per, 1)
    n = p << sf
    assert float((tiled - plan.rho.double()).abs().max()) <= 7e-16 * n
