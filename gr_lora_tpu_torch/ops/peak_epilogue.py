"""The Pyramid peak epilogue shared by the K1 and K2 lattices.

Per hop row of the folded spectra: the strict cyclic local maxima of the
windowed fold ``faw`` above the threshold (pyramid_demod_impl.cc:229-235),
reduced to the top M by value, ties going to the lower bin as
``lax.top_k`` orders them (gr_lora_tpu/models/pyramid.py:195-206).
Returns ``(bins int32, h f32, h_single f32, valid bool)``, each
``[..., M]``; unfilled slots hold bin 0 and zero heights.

:func:`peaks_plain` is the plain PyTorch version; :func:`launch_topm`
launches the hand-written kernel (``csrc/peak_topm.cu``) and is called by
the kernel wrappers on CUDA tensors only.  :func:`compare_peaks` holds one
peak lattice's output against another's (a kernel against its plain
version, or the port against the JAX package).

The fused lattices (K1, K2, K4) search their peaks inside the product's
epilogue and take M <= :data:`FUSED_MAX_PEAKS`.  K1 and K2 leave per-tile
candidate lists and the deferred edge bins of each tile; one merge kernel
(``csrc/peak_topm.cu`` ``peak_merge_kernel``) reduces them to the row's
top M.  :func:`merge_peaks` is that merge in plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

#: The largest M of the fused peak searches (K1, K2 and K4); a larger M
#: runs the lattice's dense front end and ``peak_topm``.
FUSED_MAX_PEAKS = 16

#: Launches of the dense ``peak_topm`` kernel (:func:`launch_topm`).
topm_launches = 0


def peaks_plain(fa: torch.Tensor, faw: torch.Tensor, hs: torch.Tensor,
                threshold: float, max_peaks: int):
    left = torch.roll(faw, 1, dims=-1)
    right = torch.roll(faw, -1, dims=-1)
    is_peak = (faw > threshold) & (faw > left) & (faw > right)
    vals = torch.where(is_peak, faw, torch.full_like(faw, -torch.inf))
    # A stable descending sort keeps equal values in ascending bin order.
    top_vals, top_bins = torch.sort(vals, dim=-1, descending=True,
                                    stable=True)
    top_vals = top_vals[..., :max_peaks]
    top_bins = top_bins[..., :max_peaks]
    valid = torch.isfinite(top_vals)
    zero = torch.zeros((), dtype=fa.dtype, device=fa.device)
    h = torch.where(valid, torch.gather(fa, -1, top_bins), zero)
    h_single = torch.where(valid, torch.gather(hs, -1, top_bins), zero)
    bins = torch.where(valid, top_bins, torch.zeros_like(top_bins))
    return bins.to(torch.int32), h, h_single, valid


def launch_topm(fa: torch.Tensor, faw: torch.Tensor, hs: torch.Tensor,
                threshold: float, max_peaks: int):
    """Kernel version of :func:`peaks_plain` for contiguous CUDA f32
    ``[..., K]`` spectra, any M in [1, K]."""
    if not 1 <= max_peaks <= faw.shape[-1]:
        raise ValueError(f"max_peaks must be in [1, K = {faw.shape[-1]}]")
    for t in (fa, faw, hs):
        if (not t.is_cuda or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != faw.shape):
            raise ValueError("spectra must be contiguous CUDA float32 "
                             "tensors of one shape")
    lead = faw.shape[:-1]
    k = faw.shape[-1]
    rows = faw.numel() // k
    dev = faw.device
    bins = torch.empty(*lead, max_peaks, dtype=torch.int32, device=dev)
    h = torch.empty(*lead, max_peaks, dtype=torch.float32, device=dev)
    h_single = torch.empty_like(h)
    valid = torch.empty(*lead, max_peaks, dtype=torch.bool, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.grl_peak_topm(
            faw.data_ptr(), fa.data_ptr(), hs.data_ptr(), bins.data_ptr(),
            h.data_ptr(), h_single.data_ptr(), valid.data_ptr(), rows, k,
            max_peaks, float(threshold), _build.stream_of(faw))
    _build.check("grl_peak_topm", err)
    global topm_launches
    topm_launches += 1
    return bins, h, h_single, valid


def top_candidates(v, b, h, s, max_peaks: int):
    """The best ``max_peaks`` of candidates (faw, bin, fa, hs) along the
    last dim, in the kernels' list order (value descending, ties to the
    lower bin; a non-candidate holds faw -inf), padded with empty slots."""
    if v.shape[-1] < max_peaks:
        pad = max_peaks - v.shape[-1]
        v = torch.nn.functional.pad(v, (0, pad), value=-torch.inf)
        b, h, s = (torch.nn.functional.pad(x, (0, pad)) for x in (b, h, s))
    order = torch.argsort(b, dim=-1, stable=True)
    order = order.gather(-1, torch.argsort(v.gather(-1, order), dim=-1,
                                           descending=True, stable=True))
    keep = order[..., :max_peaks]
    return tuple(x.gather(-1, keep) for x in (v, b, h, s))


def merge_peaks(lists, pairs, max_peaks: int):
    """The fused lattices' merge in plain torch: each row's top M of its
    candidate lists and its resolved edge bins.

    ``lists`` is (faw, bin, fa, hs), each [..., L, S]: per row L lists of
    confirmed peaks, an empty slot holding faw -inf.  ``pairs`` is None or
    (faw, bin, fa, hs), each [..., P, 2]: two neighbouring edge bins that
    two tiles deferred, each with its bin where its test against the
    threshold and its neighbour inside its own tile passed, else -1.  An
    edge bin is a peak where that test passed and its value exceeds the
    other entry's (its neighbour across the tile edge).  Returns (bins
    int32, h, h_single, valid), each [..., M], in ``peaks_plain``'s order
    (value descending, ties to the lower bin)."""
    lead = lists[0].shape[:-2]
    v, b, h, s = (x.reshape(*lead, -1) for x in lists)
    b = b.to(torch.int64)
    if pairs is not None:
        pv, pb, ph, ps = pairs
        ok = (pb >= 0) & (pv > pv.flip(-1))
        ninf = torch.full_like(pv, -torch.inf)
        v = torch.cat([v, torch.where(ok, pv, ninf).reshape(*lead, -1)], -1)
        b = torch.cat([b, pb.to(torch.int64).reshape(*lead, -1)], -1)
        h = torch.cat([h, ph.reshape(*lead, -1)], -1)
        s = torch.cat([s, ps.reshape(*lead, -1)], -1)
    v, b, h, s = top_candidates(v, b, h, s, max_peaks)
    valid = torch.isfinite(v)
    zero = torch.zeros((), dtype=h.dtype)
    return (torch.where(valid, b, 0).to(torch.int32),
            torch.where(valid, h, zero), torch.where(valid, s, zero), valid)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _untied(row_faw, only, other, m, threshold, tie_rtol):
    """The bins of ``only`` (peaks of one set, not of ``other``) that no
    f32 tie explains.  Two summation orders may pick different peaks only
    where the reference fold ``row_faw`` puts the decision within
    ``tie_rtol`` of the row's largest value (the scale of an f32 sum's
    rounding): the value against a neighbour (a plateau, where the strict
    local maximum is a rounding decision) or against the threshold, or the
    top-M cut (``other`` is full and holds no lower value)."""
    k = row_faw.shape[0]
    tol = tie_rtol * max(float(np.abs(row_faw).max()), threshold)
    floor = min((row_faw[c] for c in other), default=np.inf)
    out = set()
    for b in only:
        x = row_faw[b]
        near = min(abs(x - row_faw[(b - 1) % k]),
                   abs(x - row_faw[(b + 1) % k]), abs(x - threshold))
        if near > tol and not (len(other) == m and x <= floor + tol):
            out.add(b)
    return out


def compare_peaks(ref, got, rtol: float, faw=None,
                  threshold: float | None = None, tie_rtol: float = 1e-5):
    """Hold peaks ``got`` against ``ref``, each ``(bins, h, h_single,
    valid)`` of shape [..., M] (tensors or arrays): the same peak bins in
    every row and both heights of each within ``rtol``.

    Given the reference's windowed fold ``faw`` [..., K] and the peak
    threshold, a peak that only one side has is accepted where an f32 tie
    decides it (see _untied).  Returns (max |delta| of the matched
    heights, number of such peaks); raises AssertionError on any other
    difference."""
    if faw is not None and threshold is None:
        raise ValueError("a tie check needs the peak threshold")
    rb, rh, rhs, rv = (_host(x) for x in ref)
    gb, gh, ghs, gv = (_host(x) for x in got)
    if rb.shape != gb.shape:
        raise AssertionError(f"peak shapes {rb.shape} and {gb.shape}")
    if not (np.isfinite(gh).all() and np.isfinite(ghs).all()):
        raise AssertionError("non-finite peak heights")
    m = rb.shape[-1]
    rb, rh, rhs, rv, gb, gh, ghs, gv = (
        a.reshape(-1, m) for a in (rb, rh, rhs, rv, gb, gh, ghs, gv))
    if faw is not None:
        faw = _host(faw).reshape(rb.shape[0], -1)
    err, ties = 0.0, 0
    for r in range(rb.shape[0]):
        rs = {int(b): (h, s) for b, h, s in
              zip(rb[r][rv[r]], rh[r][rv[r]], rhs[r][rv[r]])}
        gs = {int(b): (h, s) for b, h, s in
              zip(gb[r][gv[r]], gh[r][gv[r]], ghs[r][gv[r]])}
        only_r, only_g = set(rs) - set(gs), set(gs) - set(rs)
        bad_r, bad_g = only_r, only_g
        if faw is not None:
            bad_r = _untied(faw[r], only_r, gs, m, threshold, tie_rtol)
            bad_g = _untied(faw[r], only_g, rs, m, threshold, tie_rtol)
        if bad_r or bad_g:
            raise AssertionError(
                f"peak bins differ in row {r}: only in ref {sorted(only_r)}, "
                f"only in got {sorted(only_g)}, ref peaks {sorted(rs)}")
        ties += len(only_r) + len(only_g)
        for b in set(rs) & set(gs):
            for a, c in zip(gs[b], rs[b]):
                d = abs(float(a) - float(c))
                err = max(err, d)
                if d > rtol * abs(float(c)):
                    raise AssertionError(
                        f"height at row {r} bin {b}: got {a}, ref {c}")
    return err, ties
