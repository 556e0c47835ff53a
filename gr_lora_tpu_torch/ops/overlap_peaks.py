"""K2: the overlap-decomposed pyramid peak lattice (SF10-12 at the
collision zoom).

Replaces gr_lora_tpu/ops/pallas_peaks.py ``make_overlap_peaks``.  The
chunk spectra G (ops/overlap_dft.py, a ``torch.fft`` outside the kernel,
as the JAX package computes it outside its Pallas kernel) feed the j-sum
with the ``rho``/``sigma`` phase plan, the window applied as a bin
convolution, the fa / faw / hs folds and the shared peak epilogue
(ops/peak_epilogue.py), all in f32.

On a CUDA tensor :class:`OverlapPeaks` launches ``csrc/overlap_peaks.cu``
(the dense X / Xw stay in shared memory) and then ``csrc/peak_topm.cu``;
on a CPU tensor it runs :meth:`OverlapPeaks.plain_from_chunks`, i.e.
``fast_pyramid_spectra``'s roll-based sums and the plain epilogue.  The
kernel rounds every operation as the plain version does, in its order, so
on the card both give the same bits.
"""

from __future__ import annotations

import torch
from torch import nn

from gr_lora_tpu.config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from . import _build
from .overlap_dft import OverlapPlan, spectra_from_chunks
from .peak_epilogue import launch_topm, peaks_plain

_R = PYRAMID_OVERLAP_FACTOR


def overlap_peaks_supported(cfg: LoraConfig) -> bool:
    """The JAX dispatch predicate (pallas_peaks.py:62-64), kept so both
    packages split the SFs alike; the CUDA kernel itself takes any K."""
    return (cfg.bin_size // _R) % 128 == 0


class OverlapPeaks(nn.Module):
    """iq float32 [..., T, 2] -> per-hop top-M peaks (bins int32, h, hs,
    valid), each [..., num_hops, M].

    The phase plan is the ``plan`` submodule (buffers rho, sigma,
    win_shifts, win_taps, chunk_mod).  ``launches`` counts kernel launches
    (one per call on a CUDA tensor)."""

    def __init__(self, cfg: LoraConfig, num_hops: int, max_peaks: int = 8):
        super().__init__()
        self.plan = OverlapPlan(cfg.sf, cfg.p, cfg.fft_factor,
                                float(cfg.beta))
        self.num_hops = num_hops
        self.max_peaks = max_peaks
        self.threshold = float(cfg.threshold)
        self.k = cfg.bin_size
        self.f = cfg.fft_size
        #: Halo of the window convolution: the largest |tap shift|.
        self.halo = max(abs(s) for s in self.plan.win_shifts.tolist())
        self.launches = 0

    def forward(self, iq: torch.Tensor):
        return self.from_chunks(self.plan.chunk_dft(iq, self.num_hops))

    def from_chunks(self, g: torch.Tensor):
        """G [..., num_hops + 7, F, 2] -> peaks."""
        if g.device.type == "cpu":
            return self.plain_from_chunks(g)
        fa, faw, hs = self.spectra_from_chunks(g)
        out = launch_topm(fa, faw, hs, self.threshold, self.max_peaks)
        self.launches += 1
        return out

    def plain_from_chunks(self, g: torch.Tensor):
        fa, faw, hs = spectra_from_chunks(g, self.plan, self.num_hops)
        return peaks_plain(fa, faw, hs, self.threshold, self.max_peaks)

    def spectra_from_chunks(self, g: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA G."""
        if (not g.is_cuda or g.dtype != torch.float32 or g.shape[-1] != 2
                or g.shape[-2] != self.f
                or g.shape[-3] < self.num_hops + _R - 1):
            raise ValueError("OverlapPeaks kernel takes CUDA float32 "
                             f"[..., >= {self.num_hops + _R - 1}, {self.f}, 2]")
        if self.plan.rho.device != g.device:
            raise ValueError(f"module on {self.plan.rho.device}, "
                             f"G on {g.device}")
        lead = g.shape[:-3]
        x = g.reshape(-1, *g.shape[-3:]).contiguous()
        lanes, rows = x.shape[0], x.shape[1]
        out = torch.empty((3, lanes, self.num_hops, self.k),
                          dtype=torch.float32, device=g.device)
        fa, faw, hs = out[0], out[1], out[2]
        p = self.plan
        lib = _build.library()
        with torch.cuda.device(g.device):
            err = lib.grl_overlap_spectra(
                x.data_ptr(), p.rho.data_ptr(), p.sigma.data_ptr(),
                p.win_shifts.data_ptr(), p.win_taps.data_ptr(),
                fa.data_ptr(), faw.data_ptr(), hs.data_ptr(), lanes, rows,
                self.num_hops, self.f, self.k, p.win_taps.shape[0],
                self.halo, _build.stream_of(x))
        _build.check("grl_overlap_spectra", err)
        shape = (*lead, self.num_hops, self.k)
        return fa.reshape(shape), faw.reshape(shape), hs.reshape(shape)
