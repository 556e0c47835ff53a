"""The shared peak epilogue (ops/peak_epilogue.py) on the CPU.

``peaks_plain`` must pick exactly what the JAX lattice's epilogue picks
(gr_lora_tpu/models/pyramid.py:195-206: strict cyclic local maxima of faw
above the threshold, ``lax.top_k`` order, ties to the lower bin), and
``compare_peaks`` must accept a differing peak only where an f32 tie
decides it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gr_lora_tpu_torch.ops.peak_epilogue import compare_peaks, peaks_plain


def _jax_epilogue(fa, faw, hs, threshold, m):
    """The epilogue of gr_lora_tpu.models.pyramid.peak_lattice_fn."""
    left = jnp.roll(faw, 1, axis=-1)
    right = jnp.roll(faw, -1, axis=-1)
    is_peak = (faw > threshold) & (faw > left) & (faw > right)
    vals = jnp.where(is_peak, faw, -jnp.inf)
    top_vals, top_bins = jax.lax.top_k(vals, m)
    valid = jnp.isfinite(top_vals)
    h = jnp.take_along_axis(fa, top_bins, axis=-1)
    h_single = jnp.take_along_axis(hs, top_bins, axis=-1)
    return top_bins.astype(jnp.int32), h, h_single, valid


@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 64])
def test_peaks_plain_matches_jax_epilogue(m):
    rng = np.random.default_rng(m)
    faw = (rng.random((2, 9, 512)) * 10).astype(np.float32)
    faw[..., ::37] = 9.5                      # equal values, distinct bins
    faw[0, :, 0], faw[0, :, -1] = 12.0, 11.0  # peaks across the wrap
    faw[1] *= 0.4                             # below the threshold but
    faw[1][:, [50, 200, 511]] = 6.0, 7.0, 8.0  # three peaks a row
    fa = rng.random(faw.shape).astype(np.float32)
    hs = rng.random(faw.shape).astype(np.float32)
    ours = peaks_plain(*(torch.from_numpy(a) for a in (fa, faw, hs)), 5.0, m)
    ref = jax.device_get(_jax_epilogue(fa, faw, hs, 5.0, m))
    v = ref[3]
    assert v.any() and (m == 1 or not v.all())
    assert np.array_equal(ours[3].numpy(), v)
    # Unfilled slots: the JAX epilogue leaves whatever top_k returned;
    # the port writes bin 0 and zero heights there.
    for a, b in zip(ours[:3], ref[:3]):
        assert np.array_equal(a.numpy()[v], b[v])
        assert not a.numpy()[~v].any()


def _peaks(bins, heights):
    """One row of M = 3 slots, filled from the front."""
    m = 3
    b = np.zeros((1, m), np.int32)
    h = np.zeros((1, m), np.float32)
    v = np.zeros((1, m), bool)
    b[0, :len(bins)], h[0, :len(bins)], v[0, :len(bins)] = bins, heights, True
    return b, h, h.copy(), v


def test_compare_peaks_accepts_only_ties():
    faw = np.zeros((1, 16), np.float32)
    faw[0, 4], faw[0, 5] = 9.0, 9.0          # a plateau: either bin may win
    faw[0, 10] = 8.0                          # a clear peak
    ref = _peaks([4, 10], [9.0, 8.0])
    assert compare_peaks(ref, _peaks([4, 10], [9.0, 8.0]), 0.0) == (0.0, 0)
    err, ties = compare_peaks(ref, _peaks([5, 10], [9.0, 8.0]), 0.0,
                              faw=faw, threshold=5.0)
    assert (err, ties) == (0.0, 2)
    with pytest.raises(AssertionError):      # no tie check without faw
        compare_peaks(ref, _peaks([5, 10], [9.0, 8.0]), 0.0)
    with pytest.raises(AssertionError):      # bin 10 is no tie
        compare_peaks(ref, _peaks([4], [9.0]), 0.0, faw=faw, threshold=5.0)
    with pytest.raises(AssertionError):      # height beyond rtol
        compare_peaks(ref, _peaks([4, 10], [9.0, 8.01]), 1e-4)
    with pytest.raises(ValueError):
        compare_peaks(ref, ref, 0.0, faw=faw)
