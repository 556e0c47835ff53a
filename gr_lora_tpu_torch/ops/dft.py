"""Zoom DFT of dechirped frames.

The receivers need only two narrow bands of the zero-padded FFT of each
dechirped symbol window: bins [0, nlo) and [F-nhi, F) of the F-point
spectrum (F = fft_factor * p * 2^sf), because a dechirped LoRa symbol is a
tone inside +-bw (reference folding: demod_impl.cc:176,
pyramid_demod_impl.cc:596).

The JAX package evaluates those bands as MXU matmuls because its TPU has no
FFT and no complex dtype (gr_lora_tpu/ops/dft.py, ``ZoomDftPlan``).  The card
has both, so the port multiplies by the dechirp vector in complex64 and
takes a zero-padded ``torch.fft.fft`` — the same transform, computed in f32
whatever ``cfg.precision`` says, with no matmul (so no TF32 question).
This transform sits outside every Pallas kernel in the JAX package too, so
on the card it is plain PyTorch, not a kernel port.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .cplx import as_complex, as_ri


class ZoomDft(nn.Module):
    """Dechirp-and-zoom plan for one (N, F, bands, modulation) combination.

    ``modulation`` is complex [N] or [V, N] (V variants, e.g. unwindowed
    and Kaiser-windowed dechirp); it is held as the float32 [V, N, 2]
    buffer ``mod``.  ``forward(frames [..., N, 2])`` returns
    ``(lo [..., nlo, 2], hi [..., nhi, 2])`` for one variant, else a list
    of such pairs.
    """

    def __init__(self, n: int, fft_size: int, nlo: int, nhi: int,
                 modulation: np.ndarray):
        super().__init__()
        if fft_size % n:
            raise ValueError("fft_size must be a multiple of the frame length")
        v = np.asarray(modulation, np.complex64)
        if v.ndim == 1:
            v = v[None, :]
        if v.shape[1] != n:
            raise ValueError(f"modulation length {v.shape[1]} != {n}")
        self.n = n
        self.fft_size = fft_size
        self.nlo = nlo
        self.nhi = nhi
        self.register_buffer(
            "mod", torch.from_numpy(np.stack([v.real, v.imag], -1)
                                    .astype(np.float32)))

    def forward(self, frames: torch.Tensor):
        z = as_complex(frames)
        f = self.fft_size
        outs = []
        for m in as_complex(self.mod):
            y = torch.fft.fft(z * m, n=f, dim=-1)
            outs.append((as_ri(y[..., :self.nlo]),
                         as_ri(y[..., f - self.nhi:])))
        return outs[0] if len(outs) == 1 else outs
