"""K3: the rDFT pyramid spectra (backend "rdft"; the front end of K1).

Replaces gr_lora_tpu/ops/pallas_rdft.py ``make_rdft_spectra``.  Per hop
frame the dechirped frame u (and u x Kaiser) is transformed by one shared
bf16 ``[n, 2(K+128)]`` block of ``[cos | -sin]`` columns over bins 0..K;
the conjugate recombination gives ``|X(b)|`` and ``|X(b-K)|`` from the
positive band alone, and the folds give fa / faw / hs ``[..., H, K]``.

On a CUDA tensor :class:`RdftSpectra` launches ``csrc/rdft_spectra.cu``
(bf16 tensor-core dots with f32 accumulation, the folds kept on chip); on
a CPU tensor it runs :meth:`RdftSpectra.plain`, the same numeric class in
plain PyTorch (bf16-rounded operands, an f32 ``torch.matmul``, the
recombination).  The TPU kernel's anti-identity lane reversal
(``rev="matmul"``) is not carried over: bin K-j is indexed directly, so
the mirror magnitudes are never rounded to bf16 (the JAX ``rev="flip"``
variant is the matching one).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from . import _build
from .chirp import chirp_tables
from .dechirp import frame_signal, kaiser_window

_R = PYRAMID_OVERLAP_FACTOR
_PAD = 128          # kp = K + 128 columns per half, as in the JAX plan


def bf16_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of two bf16 tensors with the products summed in f32 —
    the tensor-core class, in plain PyTorch.  Both operands are upcast to
    f32 exactly.  TF32, where the caller allows it, rounds an operand to
    10 mantissa bits and so leaves these 7-bit values unchanged, and every
    product of two of them is exact in f32: the result is an f32 sum of
    exact products whatever the process's TF32 setting, which is read and
    never written here."""
    return torch.matmul(a.float(), w.float())


@lru_cache(maxsize=None)
def rdft_weights(sf: int, p: int, fft_factor: int) -> np.ndarray:
    """float32 [n, 2*kp] (bf16-representable after rounding): zoom-DFT
    exponentials [cos | -sin] for bins 0..K inclusive, columns K+1..kp-1
    of each half zero (pallas_rdft._rdft_weights)."""
    n = p << sf
    f = fft_factor * n
    k = fft_factor << sf
    kp = k + _PAD
    th = 2.0 * np.pi * np.outer(np.arange(n), np.arange(kp)) / f
    w = np.zeros((n, 2 * kp), np.float32)
    w[:, :kp] = np.cos(th)
    w[:, kp:] = -np.sin(th)
    w[:, k + 1:kp] = 0.0
    w[:, kp + k + 1:] = 0.0
    return w


@lru_cache(maxsize=None)
def rdft_consts(sf: int, p: int, beta: float) -> np.ndarray:
    """float32 [8, n]: rows 0/1 the dechirp multiplier (re/im), row 2 the
    Kaiser window (pallas_rdft._consts)."""
    n = p << sf
    _, down = chirp_tables(sf, p)
    c = np.zeros((8, n), np.float32)
    c[0] = down.real.astype(np.float32)
    c[1] = down.imag.astype(np.float32)
    c[2] = kaiser_window(n, beta).astype(np.float32)
    return c


class RdftSpectra(nn.Module):
    """iq float32 [..., T, 2] -> (fa, faw, hs) float32 [..., num_frames, K].

    Buffers: ``w`` bf16 [n, 2*kp] and ``consts`` f32 [8, n].  ``launches``
    counts kernel launches made through :meth:`forward` (one per call on
    a CUDA tensor); :meth:`kernel` launches without counting, for the
    lattices that compose this front end (K1)."""

    def __init__(self, cfg: LoraConfig, num_frames: int):
        super().__init__()
        self.n = cfg.num_samples
        self.hop = self.n // _R
        self.k = cfg.bin_size
        self.kp = self.k + _PAD
        self.num_frames = num_frames
        w = torch.from_numpy(rdft_weights(cfg.sf, cfg.p, cfg.fft_factor))
        self.register_buffer("w", w.to(torch.bfloat16))
        self.register_buffer("consts", torch.tensor(
            rdft_consts(cfg.sf, cfg.p, float(cfg.beta))))
        self.launches = 0

    def forward(self, iq: torch.Tensor):
        if iq.device.type == "cpu":
            return self.plain(iq)
        out = self.kernel(iq)
        self.launches += 1
        return out

    def plain(self, iq: torch.Tensor):
        """(fa, faw, hs) [..., H, K] in the kernel's numeric class."""
        frames = frame_signal(iq, self.n, self.hop, self.num_frames)
        xr, xi = frames[..., 0], frames[..., 1]
        dr, di, win = self.consts[0], self.consts[1], self.consts[2]
        ur = xr * dr - xi * di
        ui = xr * di + xi * dr

        def dot(u):
            return bf16_matmul(u.to(torch.bfloat16), self.w)

        k, kp = self.k, self.kp

        def recombine(y1, y2):
            rre, rim = y1[..., :kp], y1[..., kp:]
            ire, iim = y2[..., :kp], y2[..., kp:]
            xre = rre[..., :k] - iim[..., :k]
            xim = rim[..., :k] + ire[..., :k]
            mpos = torch.sqrt(xre * xre + xim * xim)
            gre = rre[..., 1:k + 1] + iim[..., 1:k + 1]
            gim = ire[..., 1:k + 1] - rim[..., 1:k + 1]
            g = torch.sqrt(gre * gre + gim * gim)        # |X(-b)|, b in 1..K
            return mpos, torch.flip(g, dims=[-1])        # |X(j-K)|

        m0, m1 = recombine(dot(ur), dot(ui))
        m2, m3 = recombine(dot(ur * win), dot(ui * win))
        return m0 + m1, m2 + m3, torch.maximum(m0, m1)

    def kernel(self, iq: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA iq (not counted)."""
        if not iq.is_cuda or iq.dtype != torch.float32 or iq.shape[-1] != 2:
            raise ValueError("the rDFT kernel takes CUDA float32 [..., T, 2]")
        if self.w.device != iq.device:
            raise ValueError(f"module on {self.w.device}, iq on {iq.device}")
        lead = iq.shape[:-2]
        x = iq.reshape(-1, iq.shape[-2], 2).contiguous()
        lanes, t_len = x.shape[0], x.shape[1]
        out = torch.empty((3, lanes, self.num_frames, self.k),
                          dtype=torch.float32, device=iq.device)
        fa, faw, hs = out[0], out[1], out[2]
        lib = _build.library()
        with torch.cuda.device(iq.device):
            err = lib.grl_rdft_spectra(
                x.data_ptr(), self.w.data_ptr(), self.consts.data_ptr(),
                fa.data_ptr(), faw.data_ptr(), hs.data_ptr(), lanes, t_len,
                self.num_frames, self.n, self.hop, self.k, self.kp,
                _build.stream_of(x))
        _build.check("grl_rdft_spectra", err)
        shape = (*lead, self.num_frames, self.k)
        return fa.reshape(shape), faw.reshape(shape), hs.reshape(shape)
