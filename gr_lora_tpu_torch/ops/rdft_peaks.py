"""K1: the rDFT pyramid peak lattice (SF7-9 at the collision zoom).

Replaces gr_lora_tpu/ops/pallas_rdft.py ``make_rdft_peaks``: the K3 front
end (ops/rdft_spectra.py, the dense fa / faw / hs folds) followed by the
shared peak epilogue (ops/peak_epilogue.py).

On a CUDA tensor :class:`RdftPeaks` launches ``csrc/rdft_spectra.cu`` and
then ``csrc/peak_topm.cu``; on a CPU tensor it runs :meth:`RdftPeaks.plain`,
K3's plain version and the plain epilogue.
"""

from __future__ import annotations

from torch import nn

from ..config import LoraConfig
from .peak_epilogue import launch_topm, peaks_plain
from .rdft_spectra import _PAD, RdftSpectra


def rdft_peaks_supported(cfg: LoraConfig) -> bool:
    """The JAX dispatch predicate (pallas_rdft.py:285-295), kept as is so
    both packages split the SFs alike."""
    return cfg.num_samples * (cfg.bin_size + _PAD) <= 4_350_000


class RdftPeaks(nn.Module):
    """iq float32 [..., T, 2] -> per-hop top-M peaks (bins int32, h, hs,
    valid), each [..., num_frames, M] — the peak_lattice_fn contract.

    The front end is the ``front`` submodule (K3, buffers ``w`` and
    ``consts``).  ``launches`` counts K1 launches (one per call on a CUDA
    tensor); they do not count as K3's."""

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
        fa, faw, hs = self.front.kernel(iq)
        out = launch_topm(fa, faw, hs, self.threshold, self.max_peaks)
        self.launches += 1
        return out

    def plain(self, iq):
        fa, faw, hs = self.front.plain(iq)
        return peaks_plain(fa, faw, hs, self.threshold, self.max_peaks)
