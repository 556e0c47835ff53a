"""K2: the overlap-decomposed pyramid peak lattice (SF10-12 at the
collision zoom).

Replaces gr_lora_tpu/ops/pallas_peaks.py ``make_overlap_peaks``: the K5
front end (ops/overlap_spectra.py: chunk DFT, j-sum, window convolution,
folds, all in f32) followed by the shared peak epilogue
(ops/peak_epilogue.py).

On a CUDA tensor :class:`OverlapPeaks` launches ``csrc/overlap_spectra.cu``
and then ``csrc/peak_topm.cu``; on a CPU tensor it runs
:meth:`OverlapPeaks.plain_from_chunks`, ``fast_pyramid_spectra``'s
roll-based sums and the plain epilogue.  Both stages round as their plain
versions do, so on the card kernel and plain version give the same bits.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from .overlap_spectra import OverlapSpectra
from .peak_epilogue import launch_topm, peaks_plain

_R = PYRAMID_OVERLAP_FACTOR


def overlap_peaks_supported(cfg: LoraConfig) -> bool:
    """The JAX dispatch predicate (pallas_peaks.py:62-64), kept so both
    packages split the SFs alike; the CUDA kernel itself takes any K."""
    return (cfg.bin_size // _R) % 128 == 0


class OverlapPeaks(nn.Module):
    """iq float32 [..., T, 2] -> per-hop top-M peaks (bins int32, h, hs,
    valid), each [..., num_hops, M].

    The front end is the ``front`` submodule (K5; its ``plan`` holds the
    phase plan).  ``launches`` counts K2 launches (one per call on a CUDA
    tensor); they do not count as K5's."""

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
        fa, faw, hs = self.front.kernel(g)
        out = launch_topm(fa, faw, hs, self.threshold, self.max_peaks)
        self.launches += 1
        return out

    def plain_from_chunks(self, g: torch.Tensor):
        fa, faw, hs = self.front.plain_from_chunks(g)
        return peaks_plain(fa, faw, hs, self.threshold, self.max_peaks)
