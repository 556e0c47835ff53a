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

On a CUDA tensor both launch ``csrc/direct_spectra.cu``: a pre-pass
writes each lane's samples once as bf16 planes (re, im) of hop-sample
rows, and the product (``wgmma`` + TMA) loads its frame tiles from them as
boxes (frame f at depth d is plane row f + d // hop), so no frame matrix
is written; the folds are taken from the accumulator registers.
:class:`DirectSpectra` writes fa / faw / hs; :class:`DirectPeaks` runs the
peak search in the same kernel's epilogue, a sweep along each frame's
row of bin tiles, and writes only the [..., H, M] peaks.  Its per-frame
top-M lists live in shared memory and take M <= 16 (:data:`FUSED_MAX_PEAKS`);
for a larger M, :class:`DirectPeaks` runs K4b's kernel and then the
``peak_topm`` kernel (ops/peak_epilogue.launch_topm), counted as a K4b
launch, not a K4 one.  The kernel serves hop = n / 8 a multiple of 32
samples (n = p 2^sf >= 256) and raises otherwise.  On a CPU tensor both
run their plain versions, the same numeric class in plain PyTorch.

:func:`chunk_planes`, :func:`tile_frames`, :func:`tile_spectra` and
:func:`sweep_peaks` are the kernel's walk in plain torch, for the tests:
the planes, the box arithmetic, wgmma's accumulator-to-bin mapping and
the row sweep with its deferred wrap.
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
from .peak_epilogue import (FUSED_MAX_PEAKS, launch_topm, peaks_plain,
                            top_candidates)
from .rdft_spectra import bf16_matmul

_R = PYRAMID_OVERLAP_FACTOR
#: Bins per column group of W: [c0 re | c0 im | ... | c3 re | c3 im].
TILE_BINS = 16
#: The kernel's tile: 128 frames x 256 W columns (32 bins), fed in A boxes
#: of 32 depths.
FRAME_TILE = 128
BIN_TILE = 32
BOX = 32


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
    a CUDA tensor)."""

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

    def launch_args(self, iq: torch.Tensor):
        """(iq [lanes, T, 2] contiguous, its leading shape, the planes
        scratch) for a kernel launch; raises on what the kernel does not
        take."""
        if not iq.is_cuda or iq.dtype != torch.float32 or iq.shape[-1] != 2:
            raise ValueError("the direct kernel takes CUDA float32 [..., T, 2]")
        if self.w.device != iq.device:
            raise ValueError(f"module on {self.w.device}, iq on {iq.device}")
        if self.hop % BOX or self.n % 64 or self.k % BIN_TILE:
            raise RuntimeError(
                f"the direct kernel needs hop = n / 8 a multiple of {BOX} "
                f"samples (n = p 2^sf >= 256) and K a multiple of "
                f"{BIN_TILE}: n {self.n}, hop {self.hop}, K {self.k}")
        x = iq.reshape(-1, iq.shape[-2], 2).contiguous()
        # The kernel's planes: rows of hop samples, as many as the last
        # frame reaches (frames + n / hop - 1).
        rows = self.num_frames + self.n // self.hop - 1
        planes = torch.empty((x.shape[0], 2, rows, self.hop),
                             dtype=torch.bfloat16, device=iq.device)
        return x, iq.shape[:-2], planes

    def kernel(self, iq: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA iq (not counted)."""
        x, lead, planes = self.launch_args(iq)
        lanes, t_len = x.shape[0], x.shape[1]
        out = torch.empty((3, lanes, self.num_frames, self.k),
                          dtype=torch.float32, device=iq.device)
        fa, faw, hs = out[0], out[1], out[2]
        lib = _build.library()
        with torch.cuda.device(iq.device):
            err = lib.grl_direct_spectra(
                x.data_ptr(), self.w.data_ptr(), planes.data_ptr(),
                fa.data_ptr(), faw.data_ptr(), hs.data_ptr(), lanes, t_len,
                self.num_frames, self.n, self.hop, self.k,
                _build.stream_of(x))
        _build.check("grl_direct_spectra", err)
        shape = (*lead, self.num_frames, self.k)
        return fa.reshape(shape), faw.reshape(shape), hs.reshape(shape)


class DirectPeaks(nn.Module):
    """iq float32 [..., T, 2] -> per-hop top-M peaks (bins int32, h, hs,
    valid), each [..., num_frames, M] — the peak_lattice_fn contract.

    The weights and the plain spectra are the ``front`` submodule's (K4b).
    ``launches`` counts K4 launches (one per call on a CUDA tensor at M <=
    FUSED_MAX_PEAKS); they do not count as K4b's.  A larger M runs the
    ``front`` (K4b, counted there) and the ``peak_topm`` kernel."""

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
        if self.max_peaks > FUSED_MAX_PEAKS:
            return launch_topm(*self.front(iq), self.threshold,
                               self.max_peaks)
        out = self.kernel(iq)
        self.launches += 1
        return out

    def plain(self, iq: torch.Tensor):
        fa, faw, hs = self.front.plain(iq)
        return peaks_plain(fa, faw, hs, self.threshold, self.max_peaks)

    def kernel(self, iq: torch.Tensor):
        """Kernel peaks for a CUDA iq (not counted): the product and the
        peak search in one launch, no [H, K] array; M <= FUSED_MAX_PEAKS."""
        m = self.max_peaks
        if not 1 <= m <= FUSED_MAX_PEAKS:
            raise ValueError(f"max_peaks of the fused search must be in "
                             f"[1, {FUSED_MAX_PEAKS}]")
        fr = self.front
        x, lead, planes = fr.launch_args(iq)
        lanes, t_len = x.shape[0], x.shape[1]
        dev = iq.device
        shape = (lanes, self.num_frames, m)
        bins = torch.empty(shape, dtype=torch.int32, device=dev)
        h = torch.empty(shape, dtype=torch.float32, device=dev)
        h_single = torch.empty_like(h)
        valid = torch.empty(shape, dtype=torch.bool, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.grl_direct_peaks(
                x.data_ptr(), fr.w.data_ptr(), planes.data_ptr(),
                bins.data_ptr(), h.data_ptr(), h_single.data_ptr(),
                valid.data_ptr(), lanes, t_len, self.num_frames, fr.n,
                fr.hop, fr.k, m, self.threshold, _build.stream_of(x))
        _build.check("grl_direct_peaks", err)
        out = (*lead, self.num_frames, m)
        return (bins.reshape(out), h.reshape(out), h_single.reshape(out),
                valid.reshape(out))


# ---- the kernel's walk in plain torch (tests) ---------------------------

def chunk_planes(iq: torch.Tensor, hop: int, rows: int) -> torch.Tensor:
    """The pre-pass: iq [..., T, 2] -> bf16 planes [..., 2, rows, hop],
    plane c row r column j the sample r hop + j of component c, zero past
    T."""
    t = iq.shape[-2]
    s = torch.arange(rows * hop)
    z = iq[..., s.clamp(max=t - 1), :]
    z = torch.where((s < t)[:, None], z, torch.zeros((), dtype=iq.dtype))
    return z.movedim(-1, -2).reshape(*iq.shape[:-2], 2, rows, hop) \
        .to(torch.bfloat16)


def tile_frames(planes: torch.Tensor, n: int, num_frames: int):
    """A [..., frame tiles x 128, 2n] bf16 as the kernel's TMA boxes load
    it from ``planes`` [..., 2, rows, hop]: depths d0 .. d0 + 31 (d0 a
    multiple of 32) of half c of the frames f0 .. f0 + 127 are the box at
    plane c, row f0 + d0 // hop, column d0 % hop; rows past the planes
    read as zero."""
    rows, hop = planes.shape[-2], planes.shape[-1]
    if hop % BOX or n % hop:
        raise ValueError(f"a {BOX}-deep box must lie within a plane row: "
                         f"hop {hop}, n {n}")
    fpad = -(-num_frames // FRAME_TILE) * FRAME_TILE
    f = torch.arange(fpad)[:, None]
    d = torch.arange(n)[None, :]
    d0 = d // BOX * BOX
    row = f + d0 // hop
    col = d0 % hop + d % BOX
    inside = row < rows
    halves = [torch.where(inside, planes[..., c, row.clamp(max=rows - 1),
                                         col],
                          torch.zeros((), dtype=planes.dtype))
              for c in (0, 1)]
    return torch.cat(halves, dim=-1)


def _accumulator_layout():
    """(row, col) [256 threads, 128 registers] of the two consumer
    warpgroups' wgmma m64n256k16 accumulators on a 128 x 256 tile: d[4 j +
    2 i + c] of thread t holds row 64 wg + 16 warp + lane // 4 + 8 i,
    column 8 j + 2 (lane % 4) + c."""
    t = torch.arange(256)[:, None]
    r = torch.arange(128)[None, :]
    wg, warp, lane = t // 128, t % 128 // 32, t % 32
    j, i, c = r // 4, r % 4 // 2, r % 2
    return (64 * wg + 16 * warp + lane // 4 + 8 * i,
            8 * j + 2 * (lane % 4) + c)


def _reg(p: int, comp: int, i: int, c: int) -> int:
    """Register of component ``comp`` (c0 re, c0 im, ..., c3 im) of the bin
    a thread holds at pair p (tile bins 8 p + 2 (lane % 4) + c), row i."""
    return 4 * (16 * (p >> 1) + 2 * comp + (p & 1)) + 2 * i + c


def tile_spectra(a: torch.Tensor, w: torch.Tensor):
    """(fa, faw, hs) [..., frames, K] of A [..., frames, 2n] (frames a
    multiple of 128) through the kernel's tiles: each 128 x 256 tile of
    the f32 product is read as the threads' accumulator registers, and
    each thread folds its own bins from them (column b + 16 m of a tile
    is register group j + 2 m of the thread that holds column b)."""
    y = bf16_matmul(a, w)
    lead, frames, cols = y.shape[:-2], y.shape[-2], y.shape[-1]
    mt, nt = frames // FRAME_TILE, cols // (8 * BIN_TILE)
    tiles = y.reshape(*lead, mt, FRAME_TILE, nt, 8 * BIN_TILE) \
        .movedim(-3, -2).flatten(-2)                 # [..., mt, nt, 32768]
    row, col = _accumulator_layout()
    d = tiles[..., row * (8 * BIN_TILE) + col]       # [..., mt, nt, 256, 128]
    r0, q = row[:, 0], col[:, 0] // 2                # register 0: i = c = 0
    out = torch.zeros((3, *lead, mt, nt, FRAME_TILE * BIN_TILE))
    for p in range(4):
        for i in range(2):
            for c in range(2):
                re = [d[..., _reg(p, 2 * u, i, c)] for u in range(4)]
                im = [d[..., _reg(p, 2 * u + 1, i, c)] for u in range(4)]
                m = [torch.sqrt(x * x + z * z) for x, z in zip(re, im)]
                at = (r0 + 8 * i) * BIN_TILE + 8 * p + 2 * q + c
                out[0, ..., at] = m[0] + m[1]
                out[1, ..., at] = m[2] + m[3]
                out[2, ..., at] = torch.maximum(m[0], m[1])
    out = out.reshape(3, *lead, mt, nt, FRAME_TILE, BIN_TILE) \
        .movedim(-2, -3).reshape(3, *lead, frames, nt * BIN_TILE)
    return out[0], out[1], out[2]


def _merge(lists, cands, max_peaks):
    """Each row's top-M of its list and its new candidates, (faw, bin, fa,
    hs) [R, *], by the kernel's order."""
    return top_candidates(*(torch.cat([x, y], dim=1)
                            for x, y in zip(lists, cands)), max_peaks)


def sweep_peaks(fa: torch.Tensor, faw: torch.Tensor, hs: torch.Tensor,
                threshold: float, max_peaks: int):
    """K4's epilogue in plain torch: the peaks of [..., K] folds as
    ``csrc/direct_spectra.cu`` sweeps each row's 32-bin tiles.

    In a tile, lane q of a row's quad holds bins 8 p + 2 q + c (p < 4,
    c < 2) and reads its neighbours from the quad: x[p] the faw of lane
    q - 1's (p, 1) (lane 3's for q = 0), y[p] of lane q + 1's (p, 0) (lane
    0's for q = 3).  Lane 0 carries the previous tile's last bin; lane 3
    defers its last bin until the next tile's bin 0, and at the end until
    bin 0 of the first tile; lane 0 defers bin 0 until the last tile's
    last bin.  Each peak goes into its row's top-M list.  Returns
    (bins int32, h, h_single, valid), each [..., M], as peaks_plain."""
    k = faw.shape[-1]
    lead = faw.shape[:-1]
    fa, faw, hs = (x.reshape(-1, k) for x in (fa, faw, hs))
    rows = faw.shape[0]
    q = torch.arange(4)
    ninf = torch.tensor(-torch.inf)
    none = (torch.full((rows, max_peaks), -torch.inf),
            torch.full((rows, max_peaks), k, dtype=torch.int64),
            torch.zeros((rows, max_peaks)), torch.zeros((rows, max_peaks)))
    lists = none
    carry = first0 = None
    p31 = p0 = None
    for nt in range(k // BIN_TILE):
        lo = nt * BIN_TILE
        v, a, s = (x[:, lo:lo + BIN_TILE].reshape(rows, 4, 4, 2)
                   for x in (faw, fa, hs))                # [R, p, q, c]
        b = lo + 8 * torch.arange(4)[:, None, None] + 2 * q[:, None] \
            + torch.arange(2)
        x = v[:, :, (q - 1) % 4, 1]                        # [R, p, q]
        y = v[:, :, (q + 1) % 4, 0]
        c0 = torch.zeros_like(x[:, :1]) if carry is None \
            else carry[:, None, :]
        left = torch.where(q > 0, x, torch.cat([c0, x[:, :3]], dim=1))
        right = torch.where(q < 3, y, torch.cat([y[:, 1:], y[:, :1]], dim=1))
        pk0 = (v[..., 0] > threshold) & (v[..., 0] > left) \
            & (v[..., 0] > v[..., 1])
        pk1 = (v[..., 1] > threshold) & (v[..., 1] > v[..., 0]) \
            & (v[..., 1] > right)
        pk1[:, 3, 3] = False                               # deferred
        if nt == 0:
            pk0[:, 0, 0] = False                           # deferred
        pk = torch.stack([pk0, pk1], dim=-1)
        cands = [torch.where(pk, v, ninf).reshape(rows, -1),
                 b.expand(rows, 4, 4, 2).reshape(rows, -1),
                 a.reshape(rows, -1), s.reshape(rows, -1)]
        if p31 is not None:
            # Lane 3: the previous tile's last bin, right of it bin 0.
            ok = p31[4] & (p31[0] > y[:, 0, 3])
            cands = [torch.cat([c, e[:, None]], dim=1) for c, e in zip(
                cands, (torch.where(ok, p31[0], ninf), p31[1], p31[2],
                        p31[3]))]
        lists = _merge(lists, cands, max_peaks)
        p31 = (v[:, 3, 3, 1], torch.full((rows,), lo + BIN_TILE - 1),
               a[:, 3, 3, 1], s[:, 3, 3, 1],
               (v[:, 3, 3, 1] > threshold) & (v[:, 3, 3, 1] > v[:, 3, 3, 0]))
        if nt == 0:
            p0 = (v[:, 0, 0, 0], torch.zeros(rows, dtype=torch.int64),
                  a[:, 0, 0, 0], s[:, 0, 0, 0],
                  (v[:, 0, 0, 0] > threshold)
                  & (v[:, 0, 0, 0] > v[:, 0, 0, 1]))
            first0 = y[:, 0, 3]
        carry = x[:, 3, :]
    # The wrap: bin K - 1 (lane 3) right of it bin 0; bin 0 (lane 0) left
    # of it bin K - 1.
    last = p31[4] & (p31[0] > first0)
    first = p0[4] & (p0[0] > carry[:, 0])
    cands = [torch.stack([torch.where(last, p31[0], ninf),
                          torch.where(first, p0[0], ninf)], dim=1)] + \
        [torch.stack([p31[j], p0[j]], dim=1) for j in (1, 2, 3)]
    v, b, h, s = _merge(lists, cands, max_peaks)
    valid = torch.isfinite(v)
    zero = torch.zeros(())
    out = (*lead, max_peaks)
    return (torch.where(valid, b, 0).to(torch.int32).reshape(out),
            torch.where(valid, h, zero).reshape(out),
            torch.where(valid, s, zero).reshape(out), valid.reshape(out))
