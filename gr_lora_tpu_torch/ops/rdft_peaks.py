"""K1: the rDFT pyramid peak lattice (SF7-9 at the collision zoom).

Replaces gr_lora_tpu/ops/pallas_rdft.py ``make_rdft_peaks``.  Per hop
frame the dechirped frame u (and u x Kaiser) is transformed by one shared
bf16 ``[n, 2(K+128)]`` block of ``[cos | -sin]`` columns over bins 0..K;
the conjugate recombination gives ``|X(b)|`` and ``|X(b-K)|`` from the
positive band alone, then the fa / faw / hs folds feed the shared peak
epilogue (ops/peak_epilogue.py).

On a CUDA tensor :class:`RdftPeaks` launches ``csrc/rdft_peaks.cu`` (bf16
tensor-core dots with f32 accumulation, the folds kept on chip) and then
``csrc/peak_topm.cu``; on a CPU tensor it runs :meth:`RdftPeaks.plain`,
the same numeric class in plain PyTorch (bf16-rounded operands, an f32
``torch.matmul``, the recombination and the plain epilogue).  The TPU
kernel's anti-identity lane reversal (``rev="matmul"``) is not carried
over: bin K-j is indexed directly, so the mirror magnitudes are never
rounded to bf16 (the JAX ``rev="flip"`` variant is the matching one).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from gr_lora_tpu.config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from . import _build
from .chirp import chirp_tables
from .dechirp import frame_signal, kaiser_window
from .peak_epilogue import launch_topm, peaks_plain

_R = PYRAMID_OVERLAP_FACTOR
_PAD = 128          # kp = K + 128 columns per half, as in the JAX plan


def rdft_peaks_supported(cfg: LoraConfig) -> bool:
    """The JAX dispatch predicate (pallas_rdft.py:285-295), kept as is so
    both packages split the SFs alike."""
    return cfg.num_samples * (cfg.bin_size + _PAD) <= 4_350_000


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


class RdftPeaks(nn.Module):
    """iq float32 [..., T, 2] -> per-hop top-M peaks (bins int32, h, hs,
    valid), each [..., num_frames, M] — the peak_lattice_fn contract.

    Buffers: ``w`` bf16 [n, 2*kp] and ``consts`` f32 [8, n].  ``launches``
    counts kernel launches (one per call on a CUDA tensor)."""

    def __init__(self, cfg: LoraConfig, num_frames: int, max_peaks: int = 8):
        super().__init__()
        self.n = cfg.num_samples
        self.hop = self.n // _R
        self.k = cfg.bin_size
        self.kp = self.k + _PAD
        self.num_frames = num_frames
        self.max_peaks = max_peaks
        self.threshold = float(cfg.threshold)
        w = torch.from_numpy(rdft_weights(cfg.sf, cfg.p, cfg.fft_factor))
        self.register_buffer("w", w.to(torch.bfloat16))
        self.register_buffer("consts", torch.tensor(
            rdft_consts(cfg.sf, cfg.p, float(cfg.beta))))
        self.launches = 0

    def forward(self, iq: torch.Tensor):
        if iq.device.type == "cpu":
            return self.plain(iq)
        return self._launch(iq)

    def spectra_plain(self, iq: torch.Tensor):
        """(fa, faw, hs) [..., H, K] in K1's numeric class."""
        frames = frame_signal(iq, self.n, self.hop, self.num_frames)
        xr, xi = frames[..., 0], frames[..., 1]
        dr, di, win = self.consts[0], self.consts[1], self.consts[2]
        ur = xr * dr - xi * di
        ui = xr * di + xi * dr
        # Full f32 products of the bf16-rounded operands (exact) — TF32
        # would round them again, so it is switched off for this matmul.
        torch.backends.cuda.matmul.allow_tf32 = False
        w = self.w.float()

        def dot(u):
            return torch.matmul(u.to(torch.bfloat16).float(), w)

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

    def plain(self, iq: torch.Tensor):
        fa, faw, hs = self.spectra_plain(iq)
        return peaks_plain(fa, faw, hs, self.threshold, self.max_peaks)

    def spectra(self, iq: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA iq."""
        if not iq.is_cuda or iq.dtype != torch.float32 or iq.shape[-1] != 2:
            raise ValueError("RdftPeaks kernel takes CUDA float32 [..., T, 2]")
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

    def _launch(self, iq: torch.Tensor):
        fa, faw, hs = self.spectra(iq)
        out = launch_topm(fa, faw, hs, self.threshold, self.max_peaks)
        self.launches += 1
        return out
