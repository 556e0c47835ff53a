"""K6: the chunk-row pyramid spectra (backend "pallas").

Replaces gr_lora_tpu/ops/pallas_frontend.py ``make_pallas_spectra`` (the
JAX package's round-1 fused front end).  The IQ is laid out as hop-period
chunk rows ``[re(hop) | im(hop) | zero pad]`` of width ``w`` (the JAX
kernel's 128-lane multiple, kept so that the weights are its own bit for
bit); frame f is rows f .. f+R-1 end to end, rounded to bf16.  Eight bf16
products against the row-permuted component weights, summed in f32, give
four complex components, {unwindowed, Kaiser} x {bins [0, K), bins
[F-K, F)}; their magnitudes m0..m3 fold to fa = m0 + m1, hs = max(m0, m1),
faw = m2 + m3.  This is K4b's function (ops/direct.py) from another input
layout; the two agree up to the f32 summation order.

On a CUDA tensor :class:`ChunkSpectra` launches ``grl_chunk_spectra`` in
``csrc/direct_spectra.cu``, K4b's ``wgmma`` + TMA product with another A
walk: a pre-pass writes the chunk rows once in bf16 [rows, w], and frame
f at depth r lw + c (lw = 2 hop rounded up to 32) is chunk row f + r,
column c, so each A tile of 128 frames x 32 depths is one TMA box and the
boxes of the pad columns [lw, w) are never loaded (their weight rows are
zero).  Its weights are :func:`kernel_weights`, the component weights'
bf16 values re-laid once (rows r lw + c, columns in K4b's 16-bin
interleave): a permutation, so they equal ``direct_weights`` row for row.
Any hop works.  On a CPU tensor it runs :meth:`ChunkSpectra.plain`, the
same numeric class in plain PyTorch.  The JAX kernel's frame-tile padding
of the frame count is dropped: the chunk rows cover exactly
``num_frames + R - 1`` hops.

:func:`tile_frames` is the kernel's A walk in plain torch, for the tests
(its pre-pass writes :func:`row_chunks` in bf16; ``ops/direct.
tile_spectra`` models its product and folds).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from . import _build
from .chirp import chirp_tables
from .dechirp import kaiser_window
from .direct import BOX, FRAME_TILE, TILE_BINS
from .rdft_spectra import bf16_matmul

_R = PYRAMID_OVERLAP_FACTOR


def row_width(hop: int) -> int:
    """Chunk row width: 2 hop rounded up to a multiple of 128."""
    return -(-2 * hop // 128) * 128


def live_width(hop: int) -> int:
    """Columns of a chunk row the kernel reads: 2 hop rounded up to a
    multiple of its 32-deep box."""
    return -(-2 * hop // BOX) * BOX


@lru_cache(maxsize=4)
def component_weights(sf: int, p: int, fft_factor: int,
                      beta: float) -> torch.Tensor:
    """bf16 [8, R*w, K]: pallas_frontend._component_weights.  Matrix 2c
    (2c + 1) maps a frame's chunk-row layout to the real (imaginary) part
    of component c; rows of the lane pad are zero.  Each weight is a
    float64 product, rounded to f32 and then once to bf16."""
    n = p << sf
    f = fft_factor * n
    k = fft_factor << sf
    hop = n // _R
    w = row_width(hop)
    _, down = chirp_tables(sf, p)
    v0 = down
    v1 = down * kaiser_window(n, beta)
    # Source row of each chunk-layout row: per hop r, [re r | im r | pad].
    perm = np.full((_R, w), -1)
    for r in range(_R):
        perm[r, :hop] = np.arange(r * hop, (r + 1) * hop)
        perm[r, hop:2 * hop] = np.arange(n + r * hop, n + (r + 1) * hop)
    perm = perm.reshape(-1)
    ok = perm >= 0
    ns = np.arange(n)
    out = np.zeros((8, _R * w, k), np.float32)
    for c, (v, base) in enumerate([(v0, 0), (v0, f - k), (v1, 0),
                                   (v1, f - k)]):
        wc = np.exp(-2j * np.pi * np.outer(ns, np.arange(base, base + k)) /
                    f) * v[:, None]
        re = wc.real.astype(np.float32)
        im = wc.imag.astype(np.float32)
        # y_re rows: [Wre; -Wim], y_im rows: [Wim; Wre].
        for j, packed in enumerate((np.concatenate([re, -im]),
                                    np.concatenate([im, re]))):
            out[2 * c + j, ok] = packed[perm[ok]]
    return torch.from_numpy(out).to(torch.bfloat16)


@lru_cache(maxsize=4)
def kernel_weights(sf: int, p: int, fft_factor: int,
                   beta: float) -> torch.Tensor:
    """bf16 [R lw, 8K]: :func:`component_weights` re-laid for the kernel.
    Row r lw + c is chunk-layout row r w + c (rows c >= lw, all zero,
    dropped); column 128 g + 32 c + 16 j + b of 16-bin tile g is bin
    16 g + b of matrix 2c + j, K4b's interleave (ops/direct.py)."""
    n = p << sf
    hop = n // _R
    w, lw = row_width(hop), live_width(hop)
    k = fft_factor << sf
    cw = component_weights(sf, p, fft_factor, beta)        # [8, R w, K]
    x = cw.reshape(4, 2, _R, w, k // TILE_BINS, TILE_BINS)[:, :, :, :lw]
    return x.permute(2, 3, 4, 0, 1, 5).reshape(_R * lw, 8 * k).contiguous()


def row_chunks(iq: torch.Tensor, hop: int, width: int,
               num_frames: int) -> torch.Tensor:
    """iq float32 [..., T, 2] -> chunk rows float32 [..., num_frames + R - 1,
    width]: row r is samples [r hop, (r + 1) hop) as [re | im | zeros].  The
    stream is zero-padded or cut to whole rows."""
    rows = num_frames + _R - 1
    need = rows * hop
    x = iq[..., :need, :].to(torch.float32)
    if x.shape[-2] < need:
        x = torch.nn.functional.pad(x, (0, 0, 0, need - x.shape[-2]))
    x = x.reshape(*x.shape[:-2], rows, hop, 2)
    pad = x.new_zeros((*x.shape[:-2], width - 2 * hop))
    return torch.cat([x[..., 0], x[..., 1], pad], dim=-1)


class ChunkSpectra(nn.Module):
    """iq float32 [..., T, 2] -> (fa, faw, hs) float32 [..., num_frames, K].

    Buffers: ``w`` bf16 [8, R*w, K] (the plain version's) and ``w_kernel``
    bf16 [R lw, 8K] (the kernel's), built once per config.  ``launches``
    counts kernel launches made through :meth:`forward` (one per call on
    a CUDA tensor)."""

    def __init__(self, cfg: LoraConfig, num_frames: int):
        super().__init__()
        self.hop = cfg.num_samples // _R
        self.width = row_width(self.hop)
        self.k = cfg.bin_size
        self.num_frames = num_frames
        self.register_buffer("w", component_weights(
            cfg.sf, cfg.p, cfg.fft_factor, float(cfg.beta)))
        self.register_buffer("w_kernel", kernel_weights(
            cfg.sf, cfg.p, cfg.fft_factor, float(cfg.beta)))
        self.launches = 0

    def forward(self, iq: torch.Tensor):
        if iq.device.type == "cpu":
            return self.plain(iq)
        out = self.kernel(iq)
        self.launches += 1
        return out

    def chunks(self, iq: torch.Tensor) -> torch.Tensor:
        return row_chunks(iq, self.hop, self.width, self.num_frames)

    def plain(self, iq: torch.Tensor):
        """(fa, faw, hs) [..., H, K] in the kernel's numeric class."""
        c = self.chunks(iq)
        frames = c.unfold(-2, _R, 1).transpose(-1, -2)   # [..., H, R, w]
        x = frames.reshape(*frames.shape[:-2], -1).to(torch.bfloat16)

        def cmag(j):
            yr = bf16_matmul(x, self.w[2 * j])
            yi = bf16_matmul(x, self.w[2 * j + 1])
            return torch.sqrt(yr * yr + yi * yi)

        m0, m1, m2, m3 = (cmag(j) for j in range(4))
        return m0 + m1, m2 + m3, torch.maximum(m0, m1)

    def kernel(self, iq: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA iq (not counted)."""
        if not iq.is_cuda or iq.dtype != torch.float32 or iq.shape[-1] != 2:
            raise ValueError("the chunk kernel takes CUDA float32 [..., T, 2]")
        if self.w_kernel.device != iq.device:
            raise ValueError(f"module on {self.w_kernel.device}, "
                             f"iq on {iq.device}")
        lead = iq.shape[:-2]
        x = iq.reshape(-1, iq.shape[-2], 2).contiguous()
        lanes, t_len = x.shape[0], x.shape[1]
        rows = torch.empty((lanes, self.num_frames + _R - 1, self.width),
                           dtype=torch.bfloat16, device=iq.device)
        out = torch.empty((3, lanes, self.num_frames, self.k),
                          dtype=torch.float32, device=iq.device)
        fa, faw, hs = out[0], out[1], out[2]
        lib = _build.library()
        with torch.cuda.device(iq.device):
            err = lib.grl_chunk_spectra(
                x.data_ptr(), self.w_kernel.data_ptr(), rows.data_ptr(),
                fa.data_ptr(), faw.data_ptr(), hs.data_ptr(), lanes, t_len,
                self.num_frames, self.hop, self.width, self.k,
                _build.stream_of(x))
        _build.check("grl_chunk_spectra", err)
        shape = (*lead, self.num_frames, self.k)
        return fa.reshape(shape), faw.reshape(shape), hs.reshape(shape)


# ---- the kernel's walk in plain torch (tests) ---------------------------

def tile_frames(rows: torch.Tensor, hop: int, num_frames: int):
    """A [..., frame tiles x 128, R lw] bf16 as the kernel's TMA boxes
    load it from the bf16 chunk rows [..., C, w]: depths d0 .. d0 + 31 (d0 a
    multiple of 32) of the frames f0 .. f0 + 127 are the box at row f0 +
    d0 // lw, column d0 % lw; rows past C read as zero, and no box reaches
    the columns [lw, w)."""
    c_rows = rows.shape[-2]
    lw = live_width(hop)
    fpad = -(-num_frames // FRAME_TILE) * FRAME_TILE
    f = torch.arange(fpad)[:, None]
    d = torch.arange(_R * lw)[None, :]
    d0 = d // BOX * BOX
    row = f + d0 // lw
    col = d0 % lw + d % BOX
    return torch.where(row < c_rows, rows[..., row.clamp(max=c_rows - 1),
                                          col],
                       torch.zeros((), dtype=rows.dtype))
