"""K2: the overlap-decomposed pyramid peak lattice (SF10-12 at the
collision zoom).

Replaces gr_lora_tpu/ops/pallas_peaks.py ``make_overlap_peaks``: the K5
front end (ops/overlap_spectra.py: chunk DFT, j-sum, window convolution,
folds, all in f32) with the peak search of the shared epilogue
(ops/peak_epilogue.py).

On a CUDA tensor :class:`OverlapPeaks` launches the peak instance of
``csrc/overlap_spectra.cu``: K5's sheared walk, whose blocks (a band of
256 columns over a run of hops) search their own columns for peaks after
the window and write each band's top M per hop, never the dense folds;
then ``csrc/peak_topm.cu``'s merge takes each hop's top M over its bands.
The TPU kernel keeps per-tile candidates in VMEM the same way
(pallas_peaks.py:71-163, merged by one ``lax.top_k`` at :279-287).  At p
= 2 a band's first and last columns have their outer neighbours in the
next bands: they go to the merge as deferred pairs.  At p != 2 the cyclic
neighbours of bins 0 and K - 1 are no adjacent columns, so those two go
to the merge, and a band's edge columns see the two columns beyond it
(the halo one column wider).  Every operation rounds as the plain
version's, so the kernel's peaks equal
:meth:`OverlapPeaks.plain_from_chunks` bit for bit.
The fused search takes M <= FUSED_MAX_PEAKS; a larger M runs K5's kernel
(counted as a K5 launch) and ``peak_topm``.  On a CPU tensor it runs
:meth:`OverlapPeaks.plain_from_chunks`, ``fast_pyramid_spectra``'s
roll-based sums and the plain epilogue.

:func:`band_candidates` is the kernel's per-band search in plain torch,
for the tests (with ``peak_epilogue.merge_peaks``, the merge).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from . import _build
from .overlap_dft import OverlapPlan
from .overlap_spectra import OverlapSpectra
from .peak_epilogue import (FUSED_MAX_PEAKS, launch_topm, peaks_plain,
                            top_candidates)

_R = PYRAMID_OVERLAP_FACTOR
#: Columns e a block of the walk owns (csrc/overlap_spectra.cu kBand).
BAND = 256


def overlap_peaks_supported(cfg: LoraConfig) -> bool:
    """The JAX dispatch predicate (pallas_peaks.py:62-64), kept so both
    packages split the SFs alike; the CUDA kernel itself takes any K."""
    return (cfg.bin_size // _R) % 128 == 0


def _bands(f: int, k: int, band: int = BAND) -> int:
    """Bands of the walk: over columns [0, K) at p = 2, [0, F) else."""
    span = k if f == 2 * k else f
    return -(-span // band)


class OverlapPeaks(nn.Module):
    """iq float32 [..., T, 2] -> per-hop top-M peaks (bins int32, h, hs,
    valid), each [..., num_hops, M].

    The front end is the ``front`` submodule (K5; its ``plan`` holds the
    phase plan).  ``launches`` counts K2 launches (one per call on a CUDA
    tensor at M <= FUSED_MAX_PEAKS); they do not count as K5's.  A larger
    M runs the ``front`` (K5, counted there) and the ``peak_topm``
    kernel."""

    def __init__(self, cfg: LoraConfig, num_hops: int, max_peaks: int = 8):
        super().__init__()
        self.front = OverlapSpectra(cfg, num_hops)
        self.num_hops = num_hops
        self.max_peaks = max_peaks
        self.threshold = float(cfg.threshold)
        self.launches = 0

    @property
    def plan(self):
        return self.front.plan

    def forward(self, iq: torch.Tensor):
        return self.from_chunks(self.plan.chunk_dft(iq, self.num_hops))

    def from_chunks(self, g: torch.Tensor):
        """G [..., num_hops + 7, F, 2] -> peaks."""
        if g.device.type == "cpu":
            return self.plain_from_chunks(g)
        if self.max_peaks > FUSED_MAX_PEAKS:
            return launch_topm(*self.front.from_chunks(g), self.threshold,
                               self.max_peaks)
        out = self.kernel(g)
        self.launches += 1
        return out

    def plain_from_chunks(self, g: torch.Tensor):
        fa, faw, hs = self.front.plain_from_chunks(g)
        return peaks_plain(fa, faw, hs, self.threshold, self.max_peaks)

    def kernel(self, g: torch.Tensor):
        """Kernel peaks for a CUDA G (not counted): the walk with the
        per-band search, then the merge; no [H, K] array.  M <=
        FUSED_MAX_PEAKS."""
        m = self.max_peaks
        if not 1 <= m <= FUSED_MAX_PEAKS:
            raise ValueError(f"max_peaks of the fused search must be in "
                             f"[1, {FUSED_MAX_PEAKS}]")
        fr = self.front
        x, lead, args, geometry = fr.launch_args(g)
        rows = x.shape[0] * self.num_hops
        dev = g.device
        # Candidates (faw, bin bits, fa, hs) per hop and band; the deferred
        # pairs: each band's edge columns at p = 2, bins 0 and K - 1 else.
        bands = _bands(fr.f, fr.k)
        lists = torch.empty((rows, bands, m, 4), dtype=torch.float32,
                            device=dev)
        pairs = torch.empty((rows, bands if fr.f == 2 * fr.k else 1, 2, 4),
                            dtype=torch.float32, device=dev)
        shape = (rows, m)
        bins = torch.empty(shape, dtype=torch.int32, device=dev)
        h = torch.empty(shape, dtype=torch.float32, device=dev)
        h_single = torch.empty_like(h)
        valid = torch.empty(shape, dtype=torch.bool, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.grl_overlap_peaks(
                *args, lists.data_ptr(), pairs.data_ptr(),
                bins.data_ptr(), h.data_ptr(), h_single.data_ptr(),
                valid.data_ptr(), *geometry, m, self.threshold,
                _build.stream_of(x))
        _build.check("grl_overlap_peaks", err)
        out = (*lead, self.num_hops, m)
        return (bins.reshape(out), h.reshape(out), h_single.reshape(out),
                valid.reshape(out))


# ---- the kernel's search in plain torch (tests) --------------------------

def band_candidates(fa: torch.Tensor, faw: torch.Tensor, hs: torch.Tensor,
                    plan: OverlapPlan, threshold: float, max_peaks: int,
                    band: int = BAND):
    """The peak instances of ``csrc/overlap_spectra.cu`` in plain torch, on
    the folds [..., H, K] of hops 0 .. H - 1: (lists, pairs) for
    ``peak_epilogue.merge_peaks``.

    At hop b, column e of band i (e = band i + t) holds bin c = (e -
    sigma_1 b) mod F, folded to c mod K at p = 2 and a bin only where c <
    K at p != 2 (the other columns' folds are no bin's: NaN here).  A
    column is a peak where its bin is, its value exceeds the threshold and
    both neighbour columns' values; each band's peaks of a hop go to its
    list in rank order (value, then bin), the best M.  Deferred to the
    merge, each with its bin where it beats the threshold and its
    neighbour inside the band, else -1: at p = 2 each band's first and
    last columns (pair i: band i's last, band i + 1's first, cyclically;
    pairs [..., H, bands, 2]); at p != 2 bins 0 and K - 1, whose neighbour
    columns across the wrap hold no neighbour bin (pairs [..., H, 1, 2]),
    while a band's edge columns see the columns beyond it (the wider
    halo).  Returns lists (faw, bin, fa, hs), each [..., H, bands, M], and
    pairs, each [..., H, P, 2]."""
    f, k = plan.fft_size, plan.bin_size
    s1 = plan.sigma_list[1]
    paired = f == 2 * k
    span = k if paired else f
    bands = _bands(f, k, band)
    lead, nh = faw.shape[:-2], faw.shape[-2]
    fa, faw, hs = (x.reshape(-1, nh, k) for x in (fa, faw, hs))
    e = torch.arange(bands)[:, None] * band + torch.arange(-1, band + 1)
    c = (e - s1 * torch.arange(nh)[:, None, None]) % f      # [H, B, W]
    is_bin = (c < k) | paired
    cb = c % k
    hop = torch.arange(nh)[:, None, None].expand_as(cb)
    col = torch.where(is_bin, faw[:, hop, cb], torch.nan)   # [L, H, B, W]
    t = torch.arange(band)
    last = (span - torch.arange(bands) * band).clamp(max=band) - 1  # [B]
    if paired:
        # The p = 2 instance sees no column beyond its band's last.
        beyond = torch.arange(-1, band + 1) > last[:, None]
        col = torch.where(beyond | (e == e[:, :1]), torch.nan, col)
    v, left, right = col[..., 1:-1], col[..., :-2], col[..., 2:]
    bins = cb[..., 1:-1]
    if paired:
        deferred = (t == 0) | (t == last[:, None])
    else:
        deferred = (bins == 0) | (bins == k - 1)
    emit = is_bin[..., 1:-1] & (t <= last[:, None]) & ~deferred
    peak = emit & (v > threshold) & (v > left) & (v > right)
    ninf = torch.full_like(v, -torch.inf)
    at = (slice(None), hop[..., 1:-1], bins)
    lists = top_candidates(torch.where(peak, v, ninf),
                           bins.expand_as(v), fa[at], hs[at], max_peaks)
    lists = tuple(x.reshape(*lead, nh, bands, max_peaks) for x in lists)
    if paired:
        # [L, H, B, 2 (first, last)] -> pair i: (last of i, first of i + 1).
        ends = torch.stack([torch.zeros_like(last), last], dim=-1)
        ix = ends.expand(*v.shape[:-1], 2)
        ev, eb = v.gather(-1, ix), bins.expand_as(v).gather(-1, ix)
        inner = torch.stack([right[..., 0], left.gather(-1, ix[..., 1:])[
            ..., 0]], dim=-1)
        ok = (ev > threshold) & (ev > inner)
        eh, es = fa[at].gather(-1, ix), hs[at].gather(-1, ix)
        ent = (ev, torch.where(ok, eb, -1), eh, es)
        pairs = tuple(torch.stack([x[..., 1], x[..., 0].roll(-1, -1)], -1)
                      for x in ent)
        return lists, tuple(x.reshape(*lead, nh, bands, 2) for x in pairs)
    ends = torch.tensor([0, k - 1])
    inner = torch.tensor([1, k - 2])
    pv = faw[..., ends]
    ok = (pv > threshold) & (pv > faw[..., inner])
    pairs = (pv, torch.where(ok, ends, -1), fa[..., ends], hs[..., ends])
    return lists, tuple(x.reshape(*lead, nh, 1, 2) for x in pairs)
