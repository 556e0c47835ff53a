"""The fused peak searches of K2 and K1 (the plain-torch models
ops/overlap_peaks.band_candidates and ops/rdft_peaks.unit_candidates of
csrc/overlap_spectra.cu's and csrc/rdft_spectra.cu's peak instances,
merged by ops/peak_epilogue.merge_peaks, the model of csrc/peak_topm.cu's
merge) against ``peaks_plain`` on the same folds.

Both compare and select the same f32 values, so the merged peaks must
equal ``peaks_plain``'s bit for bit, on rows built for each edge case: a
peak on a band or tile edge (K2's band edges at p = 2 and K1's unit edges
are deferred to the merge as pairs), a plateau across one, the wrap at
bins 0 and K - 1 (deferred by K2 at p != 2, joined inside the first unit
by K1), bin K / 2 (K1's chains turn there), more than M candidates in
one band or unit, fewer than M in the row, M = 1, 8 and 16.
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch.ops.overlap_dft import OverlapPlan
from gr_lora_tpu_torch.ops.overlap_peaks import band_candidates
from gr_lora_tpu_torch.ops.peak_epilogue import merge_peaks, peaks_plain
from gr_lora_tpu_torch.ops.rdft_peaks import num_units, unit_candidates

THR = 5.0
MS = [1, 8, 16]


def _base(rows, k, seed):
    rng = np.random.default_rng(seed)
    faw = rng.random((rows, k)).astype(np.float32) * 4     # below threshold
    fa = rng.random((rows, k)).astype(np.float32)
    hs = rng.random((rows, k)).astype(np.float32)
    return rng, fa, faw, hs


def _put(row, k, at, vals):
    for b, v in zip(at, vals):
        row[b % k] = v


def _edge_cases(faw, k, edges, rng):
    """Row r of ``faw`` gets case r % 12 around the edge bins ``edges(r)``
    (ascending bins e whose right neighbour e + 1 lies across an edge)."""
    for r in range(faw.shape[0]):
        row, e = faw[r], edges(r)
        case = r % 12
        if case == 0:                  # a peak at bin 0 (left: K - 1)
            _put(row, k, [-1, 0, 1], [6.0, 9.0, 6.0])
        elif case == 1:                # a peak at bin K - 1 (right: 0)
            _put(row, k, [-2, -1, 0], [6.0, 9.0, 6.0])
        elif case == 2:                # bin 0 beats bin 1, loses to K - 1
            _put(row, k, [-2, -1, 0, 1], [6.0, 10.0, 9.0, 6.0])
        elif case == 3:                # peaks on both sides of edges
            _put(row, k, [e[0] - 1, e[0], e[0] + 1], [6.0, 9.0, 7.0])
            _put(row, k, [e[1], e[1] + 1, e[1] + 2], [7.0, 9.5, 6.0])
            # Edge bins that lose to the neighbour across the edge.
            _put(row, k, [e[2], e[2] + 1], [8.0, 9.0])
            _put(row, k, [e[3], e[3] + 1], [9.0, 8.5])
        elif case == 4:                # plateaus across edges, ties
            _put(row, k, [e[0], e[0] + 1], [8.0, 8.0])
            _put(row, k, [e[1] - 1, e[1], e[1] + 1, e[1] + 2],
                 [6.0, 7.5, 7.5, 6.0])
            _put(row, k, [e[2] - 3, e[3] - 3], [7.0, 7.0])
            _put(row, k, [e[4] - 5], [THR])            # at the threshold
        elif case == 5:                # more than M peaks in one band
            lo = e[0] + 2
            for i in range(20):
                _put(row, k, [lo + 2 * i], [6.0 + 0.1 * i])
        elif case == 6:                # twenty equal peaks
            for i in range(20):
                _put(row, k, [3 + 2 * i], [7.0])
        elif case == 7:                # nothing above the threshold
            pass
        elif case == 8:                # fewer than M: two peaks
            _put(row, k, [e[0], e[-1] + 1], [9.0, 12.0])
        else:                          # many random peaks
            row[:] = rng.random(k).astype(np.float32) * 10


def _check(got, ref, m):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    bins, valid = ref[0].reshape(-1, m), ref[3].reshape(-1, m)
    assert valid.any()
    return bins, valid


# ---- K2: the sheared walk's bands ----------------------------------------

def _band_edges(plan, band, hop):
    """Bins e of hop ``hop`` whose neighbour e + 1 lies in another band
    of the walk (or in no band)."""
    f, k, s1 = plan.fft_size, plan.bin_size, plan.sigma_list[1]
    span = k if f == 2 * k else f
    c = torch.arange(k)
    which = ((c + s1 * hop) % span) // band
    return [int(x) for x in c[which != which.roll(-1)]]


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("sf,ff,p,band", [(7, 8, 2, 256), (8, 2, 2, 64),
                                          (7, 2, 4, 256), (7, 1, 1, 32)])
def test_band_search_equals_plain(sf, ff, p, band, m):
    plan = OverlapPlan(sf, p, ff, 25.0)
    k = plan.bin_size
    hops = 24
    rng, fa, faw, hs = _base(2 * hops, k, 7 * sf + ff + p)
    # Rows are [lane, hop]: the edges move with the hop's shear.
    _edge_cases(faw, k, lambda r: _band_edges(plan, band, r % hops)
                + [k - 40] * 5, rng)
    fa, faw, hs = (torch.from_numpy(x).reshape(2, hops, k)
                   for x in (fa, faw, hs))
    lists, pairs = band_candidates(fa, faw, hs, plan, THR, m, band)
    bands = -(-(k if p == 2 else p * k) // band)
    assert lists[0].shape[:3] == (2, hops, bands)
    assert pairs[0].shape == (2, hops, bands if p == 2 else 1, 2)
    got = merge_peaks(lists, pairs, m)
    bins, valid = _check(got, peaks_plain(fa, faw, hs, THR, m), m)
    assert bins[0, 0] == 0 and bins[1, 0] == k - 1 and bins[2, 0] == k - 1
    assert not valid[7].any()


def test_band_search_defers_the_wrap_at_p4():
    """At p != 2 bins 0 and K - 1 are deferred, never in a band's list:
    a bin 0 that only beats bin 1 must not push a true peak out."""
    plan = OverlapPlan(7, 4, 2, 25.0)
    k = plan.bin_size
    faw = torch.full((1, 1, k), 1.0)
    faw[..., [k - 1, 0, 1, 50]] = torch.tensor([12.0, 11.0, 6.0, 7.0])
    fa, hs = faw * 0.5, faw * 0.25
    lists, pairs = band_candidates(fa, faw, hs, plan, THR, 1)
    assert not (lists[1][torch.isfinite(lists[0])] == 0).any()
    assert pairs[1].tolist() == [[[[0, k - 1]]]]
    got = merge_peaks(lists, pairs, 1)
    assert got[0].item() == k - 1
    for g, r in zip(got, peaks_plain(fa, faw, hs, THR, 1)):
        assert torch.equal(g, r)


# ---- K1: the rDFT epilogue's units ---------------------------------------

def _unit_edges(k, run):
    """Bins e whose neighbour e + 1 lies in another pair tile: the S
    chain's tile ends 32 t - 1, the M chain's K - 32 t, and bin K / 2's
    neighbours; unit edges (every ``run`` tiles) first."""
    tiles = range(1, k // 64)
    unit = [t for t in tiles if t % run == 0]
    rest = [t for t in tiles if t % run]
    out = []
    for t in unit + rest:
        out += [32 * t - 1, k - 32 * t]
    return out + [k // 2 - 1, k // 2]


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,run", [(256, 4), (1024, 4), (2048, 4),
                                   (1024, 1), (512, 3)])
def test_unit_sweep_equals_plain(k, run, m):
    rng, fa, faw, hs = _base(36, k, k + run)
    _edge_cases(faw, k, lambda r: _unit_edges(k, run)[r % 3 * 2:]
                + [k // 4] * 5, rng)
    fa, faw, hs = (torch.from_numpy(x) for x in (fa, faw, hs))
    lists, pairs = unit_candidates(fa, faw, hs, THR, m, run)
    units = -(-(k // 64) // run)
    assert lists[0].shape == (36, units, m)
    assert (pairs is None) == (units == 1)
    got = merge_peaks(lists, pairs, m)
    bins, valid = _check(got, peaks_plain(fa, faw, hs, THR, m), m)
    assert bins[0, 0] == 0 and bins[1, 0] == k - 1 and bins[2, 0] == k - 1
    assert not valid[7].any()


@pytest.mark.parametrize("at", ["half", "half_left", "half_right"])
def test_unit_sweep_turns_at_half(at):
    """Bin K / 2 and its neighbours K / 2 +- 1: the last unit's K / 2 tile
    sees the two chains' carried values."""
    k, m = 1024, 4
    faw = torch.full((3, k), 1.0)
    c = {"half": k // 2, "half_left": k // 2 - 1, "half_right": k // 2 + 1}
    faw[0, c[at]] = 9.0                          # a peak there
    faw[1, [k // 2 - 1, k // 2, k // 2 + 1]] = torch.tensor([8.0, 9.0, 8.0])
    faw[1, c[at]] += 2.0                         # the peak moves
    faw[2, [k // 2 - 1, k // 2 + 1]] = 9.0       # two peaks beside K / 2
    fa, hs = faw * 0.5, faw * 0.25
    got = merge_peaks(*unit_candidates(fa, faw, hs, THR, m), m)
    ref = peaks_plain(fa, faw, hs, THR, m)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert got[0][0, 0] == c[at]


def test_unit_counts():
    assert [num_units(k) for k in (64, 256, 512, 1024, 2048, 4096)] == \
        [1, 1, 2, 4, 8, 16]


def test_merge_resolves_pairs_and_fills():
    """merge_peaks: a pair entry is a peak only where its flag holds and
    it beats the other entry; fewer candidates than M leave empty slots
    (bin 0, zero heights, invalid)."""
    inf = float("inf")
    lists = (torch.tensor([[[9.0, -inf]]]), torch.tensor([[[7, 0]]]),
             torch.tensor([[[1.0, 0.0]]]), torch.tensor([[[2.0, 0.0]]]))
    pairs = (torch.tensor([[[8.0, 6.0], [5.5, 8.5]]]),
             torch.tensor([[[3, 4], [20, -1]]]),
             torch.tensor([[[3.0, 4.0], [5.0, 6.0]]]),
             torch.tensor([[[0.3, 0.4], [0.5, 0.6]]]))
    bins, h, hs, valid = merge_peaks(lists, pairs, 4)
    assert bins.tolist() == [[7, 3, 0, 0]]
    assert h.tolist() == [[1.0, 3.0, 0.0, 0.0]]
    assert hs.tolist() == [[2.0, pytest.approx(0.3), 0.0, 0.0]]
    assert valid.tolist() == [[True, True, False, False]]
