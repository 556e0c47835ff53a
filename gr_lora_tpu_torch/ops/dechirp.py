"""Dechirp + zoom spectra for the Pyramid lattice and the preamble scan,
and the folded tone probes SIC aligns and re-reads packets with.

Twin of gr_lora_tpu/ops/dechirp.py (reference hot loops:
demod_impl.cc:162-213, :329-359, pyramid_demod_impl.cc:569-603).  The
tone probes (``up_peak``, ``down_peak``, ``up_peak_stats``) run on the
window's device through a plan cached per device (``device_plan``).

Fold landmine (SURVEY.md §7, gr_lora_tpu/ops/dechirp.py:10-26): the
reference pyramid folds mags[:K] + mags[K:2K], which is the top band only
at fs/bw = 2.  The port folds mags[:K] + mags[F-K:] for ALL p, exactly as
the JAX package does: bit-identical to the reference at p = 2 and
functional at p > 2.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import LoraConfig, PeakSearch
from .chirp import chirp_tables
from .cplx import cmag
from .dft import ZoomDft


@lru_cache(maxsize=None)
def kaiser_window(num_samples: int, beta: float) -> np.ndarray:
    """Kaiser window as built by gr::fft::window::build(WIN_KAISER, n, beta)
    (reference: demod_impl.cc:121, pyramid_demod_impl.cc:98)."""
    return np.kaiser(num_samples, beta).astype(np.float32)


def up_plan(sf: int, p: int, fft_factor: int) -> ZoomDft:
    """Dechirp data/preamble upchirps: multiply by the +phi chirp (the
    reference's 'downchirp' table, demod_impl.cc:329); bins [0, K) and
    the top K.  Built on the CPU."""
    _, down = chirp_tables(sf, p)
    n = p << sf
    k = fft_factor << sf
    return ZoomDft(n, fft_factor * n, k, k, down)


def down_plan(sf: int, p: int, fft_factor: int) -> ZoomDft:
    """Dechirp the SFD downchirps: multiply by the -phi chirp; bins
    [0, K) and the top K.  Built on the CPU."""
    up, _ = chirp_tables(sf, p)
    n = p << sf
    k = fft_factor << sf
    return ZoomDft(n, fft_factor * n, k, k, up)


@lru_cache(maxsize=None)
def device_plan(direction: str, sf: int, p: int, fft_factor: int,
                device: torch.device) -> ZoomDft:
    """``up_plan`` or ``down_plan`` (``direction`` "up" / "down") on
    ``device``, built and uploaded once per device and shape."""
    build = up_plan if direction == "up" else down_plan
    return build(sf, p, fft_factor).to(device)


def pyramid_plan(sf: int, p: int, fft_factor: int, beta: float) -> ZoomDft:
    """Pyramid needs bins [0, K) + top K, both unwindowed and
    Kaiser-windowed (two variants of one plan).  Built on the CPU."""
    _, down = chirp_tables(sf, p)
    n = p << sf
    k = fft_factor << sf
    if 2 * k > fft_factor * n:
        raise ValueError("pyramid fold requires p >= 2 (reference uses 8)")
    mods = np.stack([down, down * kaiser_window(n, beta)])
    return ZoomDft(n, fft_factor * n, k, k, mods)


def up_bands(window: torch.Tensor, cfg: LoraConfig):
    """Window(s) [..., N, 2] -> up-chirp dechirped bands (lo, hi), each
    [..., K, 2] (the preamble scan's transform)."""
    return device_plan("up", cfg.sf, cfg.p, cfg.fft_factor,
                       window.device)(window)


def down_bands(window: torch.Tensor, cfg: LoraConfig):
    """Window(s) [..., N, 2] -> down-chirp (SFD) dechirped bands."""
    return device_plan("down", cfg.sf, cfg.p, cfg.fft_factor,
                       window.device)(window)


@lru_cache(maxsize=None)
def _rotations(k: int, device: torch.device) -> torch.Tensor:
    """The ``k`` phase rotations of the PHASE search, [k, 2] float32 on
    ``device``, uploaded once (a step captured in a CUDA graph may not
    copy from the host)."""
    th = 2.0 * np.pi / k * np.arange(k)
    return torch.from_numpy(np.stack([np.cos(th), np.sin(th)], -1)
                            .astype(np.float32)).to(device)


def band_peak(lo: torch.Tensor, hi: torch.Tensor, cfg: LoraConfig):
    """(lo, hi) complex bands [..., K, 2] -> (argmax int32, max value)
    under cfg.peak_search (reference: demod_impl.cc:162-213).  ABS folds
    the magnitudes; PHASE takes the best of ``peak_phase_k`` phase
    rotations of lo summed with hi (B: one, unrotated), argmax over the
    flattened [k, K] array, then the bin modulo K.  Ties go to the first
    index, as ``jnp.argmax``."""
    if cfg.peak_search == PeakSearch.ABS:
        folded = cmag(lo) + cmag(hi)
        idx = torch.argmax(folded, dim=-1)
        val = torch.gather(folded, -1, idx[..., None])[..., 0]
        return idx.to(torch.int32), val
    k = cfg.peak_phase_k if cfg.peak_search == PeakSearch.PHASE else 1
    rot = _rotations(k, lo.device)                          # [k, 2]
    lr, li = lo[..., None, :, 0], lo[..., None, :, 1]
    rr, ri = rot[:, None, 0], rot[:, None, 1]
    sr = lr * rr - li * ri + hi[..., None, :, 0]
    si = lr * ri + li * rr + hi[..., None, :, 1]
    flat = torch.sqrt(sr * sr + si * si).flatten(-2)        # [..., k K]
    best = torch.argmax(flat, dim=-1)
    val = torch.gather(flat, -1, best[..., None])[..., 0]
    return (best % lo.shape[-2]).to(torch.int32), val


def up_peak(window: torch.Tensor, cfg: LoraConfig):
    """Window(s) [..., N, 2] -> folded up-chirp peak (idx, val)."""
    return band_peak(*up_bands(window, cfg), cfg)


def up_peak_stats(window: torch.Tensor, cfg: LoraConfig):
    """(peak, mean) of the ABS-folded up-chirp spectrum, the noise-floor
    proxy of per-packet SNR estimates: the ABS fold whatever
    cfg.peak_search says, as the estimate is calibrated for it."""
    lo, hi = up_bands(window, cfg)
    folded = cmag(lo) + cmag(hi)
    return folded.amax(dim=-1), folded.mean(dim=-1)


def down_peak(window: torch.Tensor, cfg: LoraConfig):
    """Window(s) [..., N, 2] -> folded down-chirp (SFD) peak (idx, val)."""
    return band_peak(*down_bands(window, cfg), cfg)


def pyramid_spectra(frames: torch.Tensor, cfg: LoraConfig):
    """Per-hop dense spectra for the pyramid demod, batched over frames.

    frames [..., N, 2] -> (fft_add, fft_add_w, h_single), each [..., K]:
    - fft_add:   unwindowed, mags[:K] + mags[F-K:]
    - fft_add_w: Kaiser-windowed, same fold          (pyramid_demod_impl.cc:603)
    - h_single:  max(mags[:K], mags[F-K:])           (pyramid_demod_impl.cc:269)
    """
    plan = pyramid_plan(cfg.sf, cfg.p, cfg.fft_factor, float(cfg.beta))
    return fold_spectra(plan.to(frames.device)(frames))


def fold_spectra(bands):
    """((lo, hi), (lo_w, hi_w)) -> (fft_add, fft_add_w, h_single)."""
    (lo, hi), (lo_w, hi_w) = bands
    mlo, mhi = cmag(lo), cmag(hi)
    return mlo + mhi, cmag(lo_w) + cmag(hi_w), torch.maximum(mlo, mhi)


def frame_signal(iq: torch.Tensor, frame_len: int, hop: int,
                 num_frames: int) -> torch.Tensor:
    """Strided frames [..., num_frames, frame_len, 2] of IQ [..., T, 2],
    zero-padded past T."""
    need = (num_frames - 1) * hop + frame_len
    pad = need - iq.shape[-2]
    if pad > 0:
        iq = torch.nn.functional.pad(iq, (0, 0, 0, pad))
    fr = iq[..., :need, :].unfold(-2, frame_len, hop)   # [..., H, 2, L]
    return fr.transpose(-1, -2)
