"""K5: the overlap-decomposed pyramid spectra (backend "fastp"; the front
end of K2).

Replaces gr_lora_tpu/ops/pallas_overlap.py ``make_overlap_spectra``.  The
chunk spectra G (ops/overlap_dft.py, a cuFFT through ``torch.fft`` outside
the kernel, as the JAX package keeps its chunk matmul outside its Pallas
kernel) feed the j-sum with the ``rho``/``sigma`` phase plan, the window
applied as a bin convolution and the fa / faw / hs folds, all in f32.

On a CUDA tensor :class:`OverlapSpectra` launches
``csrc/overlap_spectra.cu`` (the dense X / Xw stay in shared memory); on a
CPU tensor it runs ``overlap_dft.spectra_from_chunks``, the roll-based
sums.  The kernel rounds every operation as the plain version does, in its
order, so on the card both give the same bits.

The JAX kernel sizes its hop tile for the TPU's vector memory and raises
where one 8-hop tile of [8, F] rows does not fit (F above about 13.6 k,
SF10-12 at fft_factor 8, pallas_overlap.py:96-105).  That cap is not
carried over: the CUDA kernel tiles bins as well as hops and takes any F.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from . import _build
from .overlap_dft import OverlapPlan, spectra_from_chunks

_R = PYRAMID_OVERLAP_FACTOR


class OverlapSpectra(nn.Module):
    """iq float32 [..., T, 2] -> (fa, faw, hs) float32 [..., num_hops, K].

    The phase plan is the ``plan`` submodule (buffers rho, sigma,
    win_shifts, win_taps, chunk_mod).  ``launches`` counts kernel launches
    made through :meth:`forward` / :meth:`from_chunks` (one per call on a
    CUDA tensor); :meth:`kernel` launches without counting, for K2."""

    def __init__(self, cfg: LoraConfig, num_hops: int):
        super().__init__()
        self.plan = OverlapPlan(cfg.sf, cfg.p, cfg.fft_factor,
                                float(cfg.beta))
        self.num_hops = num_hops
        self.k = cfg.bin_size
        self.f = cfg.fft_size
        #: Halo of the window convolution: the largest |tap shift|.
        self.halo = max(abs(s) for s in self.plan.win_shifts.tolist())
        self.launches = 0

    def forward(self, iq: torch.Tensor):
        return self.from_chunks(self.plan.chunk_dft(iq, self.num_hops))

    def from_chunks(self, g: torch.Tensor):
        """G [..., >= num_hops + 7, F, 2] -> (fa, faw, hs)."""
        if g.device.type == "cpu":
            return self.plain_from_chunks(g)
        out = self.kernel(g)
        self.launches += 1
        return out

    def plain_from_chunks(self, g: torch.Tensor):
        return spectra_from_chunks(g, self.plan, self.num_hops)

    def kernel(self, g: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA G (not counted)."""
        if (not g.is_cuda or g.dtype != torch.float32 or g.shape[-1] != 2
                or g.shape[-2] != self.f
                or g.shape[-3] < self.num_hops + _R - 1):
            raise ValueError("the overlap kernel takes CUDA float32 "
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
