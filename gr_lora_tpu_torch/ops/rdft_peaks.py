"""K1: the rDFT pyramid peak lattice (SF7-9 at the collision zoom).

Replaces gr_lora_tpu/ops/pallas_rdft.py ``make_rdft_peaks``: the K3 front
end (ops/rdft_spectra.py: the products, the recombination and the folds)
with the peak search of the shared epilogue (ops/peak_epilogue.py).

On a CUDA tensor :class:`RdftPeaks` launches the peak instance of
``csrc/rdft_spectra.cu``: K3's product, whose epilogue searches each
frame's bins in the accumulator registers instead of storing the folds,
then ``csrc/peak_topm.cu``'s merge.  As the TPU kernel keeps per-tile
candidates in VMEM (pallas_rdft.py:298-348, merged at :420-434), a unit
of the product (a frame tile and a run of RUN pair tiles) keeps each
frame's top M in shared memory and writes it, and the merge takes each
frame's top M over its units.  A pair tile holds bins b0 + j and their
mirrors K - b0 - j (j < 32): along g = b0 + j the two are one chain each,
bin g and bin K - g, joined at g = 0 (bin 0 beside bin K - 1) and at g =
K / 2, which the last unit sweeps as its last tile.  A unit sweeps its
tiles in order as K4 does (quad shuffles, the previous tile's last g
carried, each tile's last g deferred to the next); the first and last g
of a unit have their neighbours in the units beside it, so they go to
the merge as deferred edge bins.  The fused search takes M <=
FUSED_MAX_PEAKS; a larger M runs K3's kernel (counted as a K3 launch)
and ``peak_topm``.  On a CPU tensor it runs :meth:`RdftPeaks.plain`,
K3's plain version and the plain epilogue.

:func:`unit_candidates` is the kernel's sweep in plain torch, for the
tests (with ``peak_epilogue.merge_peaks``, the merge).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import LoraConfig
from . import _build
from .peak_epilogue import (FUSED_MAX_PEAKS, launch_topm, peaks_plain,
                            top_candidates)
from .rdft_spectra import _PAD, PAIR, RdftSpectra

#: Pair tiles a unit of the fused search sweeps (csrc/rdft_spectra.cu
#: kRun); the last unit also sweeps the bin-K/2 tile.
RUN = 4


def rdft_peaks_supported(cfg: LoraConfig) -> bool:
    """The JAX dispatch predicate (pallas_rdft.py:285-295), kept as is so
    both packages split the SFs alike."""
    return cfg.num_samples * (cfg.bin_size + _PAD) <= 4_350_000


def num_units(k: int, run: int = RUN) -> int:
    """Units of the fused search a frame: runs of ``run`` pair tiles."""
    return -(-(k // (2 * PAIR)) // run)


class RdftPeaks(nn.Module):
    """iq float32 [..., T, 2] -> per-hop top-M peaks (bins int32, h, hs,
    valid), each [..., num_frames, M] — the peak_lattice_fn contract.

    The front end is the ``front`` submodule (K3, buffers ``w``,
    ``w_tiles`` and ``consts``).  ``launches`` counts K1 launches (one per
    call on a CUDA tensor at M <= FUSED_MAX_PEAKS); they do not count as
    K3's.  A larger M runs the ``front`` (K3, counted there) and the
    ``peak_topm`` kernel."""

    def __init__(self, cfg: LoraConfig, num_frames: int, max_peaks: int = 8):
        super().__init__()
        self.front = RdftSpectra(cfg, num_frames)
        self.num_frames = num_frames
        self.max_peaks = max_peaks
        self.threshold = float(cfg.threshold)
        self.launches = 0

    def forward(self, iq):
        if iq.device.type == "cpu":
            return self.plain(iq)
        if self.max_peaks > FUSED_MAX_PEAKS:
            return launch_topm(*self.front(iq), self.threshold,
                               self.max_peaks)
        out = self.kernel(iq)
        self.launches += 1
        return out

    def plain(self, iq):
        fa, faw, hs = self.front.plain(iq)
        return peaks_plain(fa, faw, hs, self.threshold, self.max_peaks)

    def kernel(self, iq):
        """Kernel peaks for a CUDA iq (not counted): K3's product with the
        search in its epilogue, then the merge; no [H, K] array.  M <=
        FUSED_MAX_PEAKS."""
        m = self.max_peaks
        if not 1 <= m <= FUSED_MAX_PEAKS:
            raise ValueError(f"max_peaks of the fused search must be in "
                             f"[1, {FUSED_MAX_PEAKS}]")
        fr = self.front
        x, lead, a = fr.launch_args(iq)
        lanes, t_len = x.shape[0], x.shape[1]
        rows = lanes * self.num_frames
        units = num_units(fr.k)
        dev = iq.device
        # Each unit's list (faw, bin bits, fa, hs) a frame, and the two
        # deferred edge bins of each chain between neighbouring units.
        lists = torch.empty((rows, units, m, 4), dtype=torch.float32,
                            device=dev)
        pairs = None if units == 1 else torch.empty(
            (rows, 2 * (units - 1), 2, 4), dtype=torch.float32, device=dev)
        shape = (rows, m)
        bins = torch.empty(shape, dtype=torch.int32, device=dev)
        h = torch.empty(shape, dtype=torch.float32, device=dev)
        h_single = torch.empty_like(h)
        valid = torch.empty(shape, dtype=torch.bool, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.grl_rdft_peaks(
                x.data_ptr(), fr.w_tiles.data_ptr(), fr.consts.data_ptr(),
                a.data_ptr(), lists.data_ptr(),
                None if pairs is None else pairs.data_ptr(),
                bins.data_ptr(), h.data_ptr(), h_single.data_ptr(),
                valid.data_ptr(), lanes, t_len, self.num_frames, fr.n,
                fr.hop, fr.k, m, self.threshold, _build.stream_of(x))
        _build.check("grl_rdft_peaks", err)
        out = (*lead, self.num_frames, m)
        return (bins.reshape(out), h.reshape(out), h_single.reshape(out),
                valid.reshape(out))


# ---- the kernel's sweep in plain torch (tests) ---------------------------

def unit_candidates(fa: torch.Tensor, faw: torch.Tensor, hs: torch.Tensor,
                    threshold: float, max_peaks: int, run: int = RUN):
    """The peak instance of ``csrc/rdft_spectra.cu`` in plain torch, on
    the folds [..., K]: (lists, pairs) for ``peak_epilogue.merge_peaks``.

    Pair tile nt (b0 = 32 nt < K / 2) holds, in lane q of a frame's quad,
    g = b0 + 8 t + 2 q + c (t < 4, c < 2) of two chains: S, bin g, and M,
    bin K - g; tile K / 64 holds bin K / 2 alone (lane 0, t = c = 0).  A
    unit sweeps ``run`` pair tiles (the last unit also the K / 2 tile) as
    the kernel does: x[t] the value of lane q - 1's (t, 1) (lane 3's for q
    = 0), y[t] of lane q + 1's (t, 0) (lane 0's for q = 3); lane 0 carries
    the previous tile's last g, lane 3 defers its last g to the next tile.
    The chains join at g = 0 (S's left neighbour there is M's g = 1, bin
    K - 1; M's g = 0, column K, is no bin and takes bin 0's value) and at
    K / 2 (M's g = K / 2 takes bin K / 2's value; bin K / 2's neighbours
    are the two carried values).  A unit's first g (unit > 0) and last g
    (unit < last) go to ``pairs`` with their bin where they beat their
    inner neighbour and the threshold, else -1: pair 2 u + X (X 0: S, 1:
    M) holds unit u's last g and unit u + 1's first.  Returns lists (faw,
    bin, fa, hs), each [..., units, M], and pairs, each [..., 2 (units -
    1), 2], or None for one unit.  Values the kernel never reads are NaN
    here, so a use would show."""
    k = faw.shape[-1]
    lead = faw.shape[:-1]
    fa, faw, hs = (x.reshape(-1, k) for x in (fa, faw, hs))
    rows = faw.shape[0]
    npair = k // (2 * PAIR)
    units = num_units(k, run)
    q = torch.arange(4)
    j = 8 * torch.arange(4)[:, None, None] + 2 * q[:, None] + torch.arange(2)
    ninf = torch.tensor(-torch.inf)
    lists, lo, hi = [], {}, {}
    for u in range(units):
        nt0 = u * run
        tiles = min(run, npair - nt0) + (u == units - 1)
        cands = []
        carry = pend = None
        for ti in range(tiles):
            nt = nt0 + ti
            g = PAIR * nt + j                             # [t, q, c]
            bins = torch.stack([g % k, (k - g) % k])      # [X, t, q, c]
            v = faw[:, bins].clone()                      # [R, X, t, q, c]
            if nt == npair:
                keep = v[:, 0, 0, 0, 0].clone()
                v[:] = torch.nan
                v[:, :, 0, 0, 0] = keep[:, None]
            elif nt == 0:
                v[:, 1, 0, 0, 0] = v[:, 0, 0, 0, 0]
            x = v[..., (q - 1) % 4, 1]                    # [R, X, t, q]
            y = v[..., (q + 1) % 4, 0]
            if ti == 0:
                carry = torch.full((rows, 2, 4), torch.nan)
                if nt == 0:
                    carry[:, 0, 0] = v[:, 1, 0, 0, 1]     # bin K - 1
            left = torch.where(q > 0, x, torch.cat([carry[:, :, None],
                                                    x[:, :, :3]], dim=2))
            right = torch.where(q < 3, y, torch.cat([y[:, :, 1:],
                                                     y[:, :, :1]], dim=2))
            v0, v1 = v[..., 0], v[..., 1]
            pk0 = (v0 > threshold) & (v0 > left) & (v0 > v1)
            pk1 = (v1 > threshold) & (v1 > v0) & (v1 > right)
            pk1[:, :, 3, 3] = False                       # deferred
            if nt == npair:
                pk0[:] = pk1[:] = False
                pk0[:, 0, 0, 0] = (v0[:, 0, 0, 0] > threshold) \
                    & (v0[:, 0, 0, 0] > carry[:, 0, 0]) \
                    & (v0[:, 0, 0, 0] > carry[:, 1, 0])
            if nt == 0:
                pk0[:, 1, 0, 0] = False                   # column K
            elif ti == 0:
                pk0[:, :, 0, 0] = False                   # deferred
                ok = (v0[:, :, 0, 0] > threshold) \
                    & (v0[:, :, 0, 0] > v1[:, :, 0, 0])
                lo[u] = (v0[:, :, 0, 0],
                         torch.where(ok, bins[:, 0, 0, 0], -1),
                         fa[:, bins[:, 0, 0, 0]], hs[:, bins[:, 0, 0, 0]])
            pk = torch.stack([pk0, pk1], dim=-1)
            flat = [torch.where(pk, v, ninf), bins.expand_as(v),
                    fa[:, bins], hs[:, bins]]
            cands += [[z.reshape(rows, -1) for z in flat]]
            if pend is not None:
                res = pend[3] & (pend[0] > y[:, :, 0, 3])
                cands += [[torch.where(res, pend[0], ninf), pend[1],
                           pend[2], pend[4]]]
            pend = None
            if nt < npair:
                pv = v[:, :, 3, 3, 1]
                pb = bins[:, 3, 3, 1].expand(rows, 2)
                pend = (pv, pb, fa[:, pb[0]],
                        (pv > threshold) & (pv > v[:, :, 3, 3, 0]),
                        hs[:, pb[0]])
            carry = x[:, :, 3, :]
        if u < units - 1:
            hi[u] = (pend[0], torch.where(pend[3], pend[1], -1), pend[2],
                     pend[4])
        lists.append(top_candidates(
            *(torch.cat([c[i] for c in cands], dim=1) for i in range(4)),
            max_peaks))
    lists = tuple(torch.stack([li[i] for li in lists], dim=1)
                  .reshape(*lead, units, max_peaks) for i in range(4))
    if units == 1:
        return lists, None
    # Pair 2 u + X: (unit u's last g, unit u + 1's first g) of chain X.
    pairs = tuple(torch.stack([torch.stack([hi[u][i], lo[u + 1][i]], dim=-1)
                               for u in range(units - 1)], dim=1)
                  .reshape(*lead, 2 * (units - 1), 2) for i in range(4))
    return lists, pairs
