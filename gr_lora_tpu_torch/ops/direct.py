"""K4b and K4: the direct pyramid spectra and peak lattice (backends
"direct" and "fused_direct").

Replaces gr_lora_tpu/ops/pallas_direct.py ``make_direct_spectra`` (K4b)
and ``make_direct_peaks`` (K4).  Per hop frame, one bf16 product
``[Re x | Im x] @ W`` with f32 accumulation gives four complex components,
{unwindowed, Kaiser} x {bins [0, K), bins [F-K, F)}; the epilogue takes
their magnitudes m0..m3 and folds fa = m0 + m1, hs = max(m0, m1),
faw = m2 + m3.  The dechirp and the window live in the weights, so the
raw samples, not the dechirped ones, are rounded to bf16 (the rDFT
kernels round after the dechirp).

On a CUDA tensor :class:`DirectSpectra` launches
``csrc/direct_spectra.cu``, which builds each bf16 frame tile on chip from
the raw iq at f*hop (the TPU kernel's ``[frames, 2N]`` frame matrix is
never written).  On a CPU tensor it runs :meth:`DirectSpectra.plain`, the
same numeric class in plain PyTorch.  :class:`DirectPeaks` is the same
front end followed by the shared peak epilogue (ops/peak_epilogue.py):
the TPU kernel's per-tile top-M and the cross-tile ``lax.top_k`` that
merges it choose the same peaks, the larger value first and the lower
bin on a tie.
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
from .peak_epilogue import launch_topm, peaks_plain
from .rdft_spectra import bf16_matmul

_R = PYRAMID_OVERLAP_FACTOR
#: Bins per column tile of W (the kernel's block width).
TILE_BINS = 16


@lru_cache(maxsize=4)
def direct_weights(sf: int, p: int, fft_factor: int,
                   beta: float) -> torch.Tensor:
    """bf16 [2n, 8K]: per tile of 16 bins the columns [c0 re | c0 im | ...
    | c3 re | c3 im] of pallas_direct._weights (equal to its
    ``kt = 16`` layout bit for bit).  Each weight is a float64 product,
    rounded to f32 and then once to bf16."""
    n = p << sf
    f = fft_factor * n
    k = fft_factor << sf
    _, down = chirp_tables(sf, p)
    v0 = down
    v1 = down * kaiser_window(n, beta)
    ns = np.arange(n)
    cols = np.zeros((2 * n, k // TILE_BINS, 4, 2, TILE_BINS), np.float32)
    for c, (v, base) in enumerate([(v0, 0), (v0, f - k), (v1, 0),
                                   (v1, f - k)]):
        bins = np.arange(base, base + k)
        wc = np.exp(-2j * np.pi * np.outer(ns, bins) / f) * v[:, None]
        re = wc.real.astype(np.float32).reshape(n, -1, TILE_BINS)
        im = wc.imag.astype(np.float32).reshape(n, -1, TILE_BINS)
        # y_re rows: [Wre; -Wim], y_im rows: [Wim; Wre].
        cols[:n, :, c, 0] = re
        cols[n:, :, c, 0] = -im
        cols[:n, :, c, 1] = im
        cols[n:, :, c, 1] = re
    return torch.from_numpy(cols.reshape(2 * n, 8 * k)).to(torch.bfloat16)


class DirectSpectra(nn.Module):
    """iq float32 [..., T, 2] -> (fa, faw, hs) float32 [..., num_frames, K].

    Buffer: ``w`` bf16 [2n, 8K] (built once per config).  ``launches``
    counts kernel launches made through :meth:`forward` (one per call on
    a CUDA tensor); :meth:`kernel` launches without counting, for K4."""

    def __init__(self, cfg: LoraConfig, num_frames: int):
        super().__init__()
        self.n = cfg.num_samples
        self.hop = self.n // _R
        self.k = cfg.bin_size
        self.num_frames = num_frames
        self.register_buffer("w", direct_weights(
            cfg.sf, cfg.p, cfg.fft_factor, float(cfg.beta)))
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
        x = torch.cat([frames[..., 0], frames[..., 1]], dim=-1)
        y = bf16_matmul(x.to(torch.bfloat16), self.w)
        y = y.reshape(*y.shape[:-1], -1, 4, 2, TILE_BINS)
        re, im = y[..., 0, :], y[..., 1, :]
        m = torch.sqrt(re * re + im * im)               # [..., H, tiles, 4, 16]

        def comp(c):
            return m[..., c, :].flatten(-2)             # [..., H, K]

        m0, m1, m2, m3 = (comp(c) for c in range(4))
        return m0 + m1, m2 + m3, torch.maximum(m0, m1)

    def kernel(self, iq: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA iq (not counted)."""
        if not iq.is_cuda or iq.dtype != torch.float32 or iq.shape[-1] != 2:
            raise ValueError("the direct kernel takes CUDA float32 [..., T, 2]")
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
            err = lib.grl_direct_spectra(
                x.data_ptr(), self.w.data_ptr(), fa.data_ptr(),
                faw.data_ptr(), hs.data_ptr(), lanes, t_len,
                self.num_frames, self.n, self.hop, self.k,
                _build.stream_of(x))
        _build.check("grl_direct_spectra", err)
        shape = (*lead, self.num_frames, self.k)
        return fa.reshape(shape), faw.reshape(shape), hs.reshape(shape)


class DirectPeaks(nn.Module):
    """iq float32 [..., T, 2] -> per-hop top-M peaks (bins int32, h, hs,
    valid), each [..., num_frames, M] — the peak_lattice_fn contract.

    The front end is the ``front`` submodule (K4b).  ``launches`` counts
    K4 launches (one per call on a CUDA tensor); they do not count as
    K4b's."""

    def __init__(self, cfg: LoraConfig, num_frames: int, max_peaks: int = 8):
        super().__init__()
        self.front = DirectSpectra(cfg, num_frames)
        self.num_frames = num_frames
        self.max_peaks = max_peaks
        self.threshold = float(cfg.threshold)
        self.launches = 0

    def forward(self, iq: torch.Tensor):
        if iq.device.type == "cpu":
            return self.plain(iq)
        fa, faw, hs = self.front.kernel(iq)
        out = launch_topm(fa, faw, hs, self.threshold, self.max_peaks)
        self.launches += 1
        return out

    def plain(self, iq: torch.Tensor):
        fa, faw, hs = self.front.plain(iq)
        return peaks_plain(fa, faw, hs, self.threshold, self.max_peaks)
