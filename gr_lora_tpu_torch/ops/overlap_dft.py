"""Overlap-decomposed pyramid spectra: the chunk DFT that feeds K2 and
its plain reference.

Twin of gr_lora_tpu/ops/overlap_dft.py (see its module docstring for the
two exact identities).  In short, with hop h = N/8 and F = fft_factor * N:

    G[a, c]   = sum_u iq[a*h + u] * down[u] * exp(-2*pi*i*u*c / F)
    X_b[c]    = sum_{j<8} rho_j[c] * G[b + j, c - sigma_j]
    Xw_b[c]   = sum_q what_q * X_b[c - q*fft_factor]

``OverlapPlan`` holds the NumPy constants of ``overlap_plan`` (rho, sigma,
the window taps and their bin shifts, and the chunk dechirp) as buffers.
The chunk DFT G is outside every Pallas kernel in the JAX package
(pallas_peaks.py:269), so here it is a zero-padded ``torch.fft`` in
complex64.  ``fast_pyramid_spectra`` is K2's plain version: the j-sum and
the window convolution as whole-array rolls, then the top-band fold.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from .cplx import as_complex, as_ri, cmag, cmul
from .dechirp import kaiser_window

_R = PYRAMID_OVERLAP_FACTOR


@lru_cache(maxsize=None)
def overlap_constants(sf: int, p: int, fft_factor: int, beta: float,
                      tap_tol: float = 1e-7):
    """NumPy constants of gr_lora_tpu.ops.overlap_dft.overlap_plan:
    (rho float32[8, F, 2], sigma tuple, win_shifts tuple,
    win_taps float32[T, 2], chunk dechirp complex128[h])."""
    n = p << sf
    h = n // _R
    f = fft_factor * n
    k = fft_factor << sf
    if k % _R:
        raise ValueError(f"bin shift K/{_R} not integral (K={k})")
    # Exact float64 dechirp chirp (the identity is exact only for the
    # exact quadratic phase).
    i = np.arange(n, dtype=np.float64)
    down = np.exp(1j * (np.pi / p) * (i - i * i / n))

    u = np.arange(h)
    rho = np.zeros((_R, f), np.complex128)
    sigma = []
    for j in range(_R):
        tau = down[j * h + u] * np.conj(down[u])
        beta_j = tau[0]
        nu = -j * h / (p * n)
        fit = beta_j * np.exp(2j * np.pi * nu * u)
        err = np.max(np.abs(tau - fit))
        if err >= 1e-9:
            raise ValueError(f"chunk correction j={j} not a pure tone ({err})")
        shift = nu * f
        s_int = int(round(shift))
        if abs(shift - s_int) >= 1e-6:
            raise ValueError(f"non-integer bin shift {shift}")
        sigma.append(s_int % f)
        c = np.arange(f)
        rho[j] = beta_j * np.exp(-2j * np.pi * j * h * c / f)
    rho_ri = np.stack([rho.real, rho.imag], axis=-1).astype(np.float32)

    w = np.asarray(kaiser_window(n, beta), np.float64)
    what = np.fft.fft(w) / n
    mag = np.abs(what)
    keep = np.nonzero(mag > tap_tol * mag.max())[0]
    win_shifts = tuple(int(q * fft_factor) % f for q in keep)
    win_taps = np.stack([what[keep].real, what[keep].imag],
                        axis=-1).astype(np.float32)
    return rho_ri, tuple(sigma), win_shifts, win_taps, down[:h]


class OverlapPlan(nn.Module):
    """Buffers: ``rho`` f32[8, F, 2], ``rho_period`` f32[8, P, 2],
    ``sigma`` i32[8], ``win_shifts`` i32[T] (signed, in (-F/2, F/2]),
    ``win_taps`` f32[T, 2] and the chunk dechirp ``chunk_mod`` f32[h, 2].
    ``sigma_list``/``shift_list`` keep the unsigned Python ints of the JAX
    plan (roll amounts).

    rho_j[c] = beta_j exp(-2 pi i j c / (8 fft_factor)) has the period
    P = 8 fft_factor in c, but its f32 table is periodic only to ~1e-12
    (rounding of the float64 phase).  ``rho_period`` is the table's first
    period, and the spectra take rho_j[c] as ``rho_period[j, c mod P]``,
    so that down a column of the sheared walk (ops/overlap_spectra.py)
    rho is one constant; ``rho`` stays the JAX plan's exact copy."""

    def __init__(self, sf: int, p: int, fft_factor: int, beta: float):
        super().__init__()
        rho, sigma, shifts, taps, down = overlap_constants(
            sf, p, fft_factor, beta)
        self.n = p << sf
        self.hop = self.n // _R
        self.fft_size = fft_factor * self.n
        self.bin_size = fft_factor << sf
        self.sigma_list = sigma
        self.shift_list = shifts
        f = self.fft_size
        signed = [s if s <= f // 2 else s - f for s in shifts]
        self.register_buffer("rho", torch.tensor(rho))
        self.period = _R * fft_factor
        self.register_buffer("rho_period",
                             torch.tensor(rho[:, :self.period]).contiguous())
        self.register_buffer("sigma", torch.tensor(sigma, dtype=torch.int32))
        self.register_buffer("win_shifts",
                             torch.tensor(signed, dtype=torch.int32))
        self.register_buffer("win_taps", torch.tensor(taps))
        self.register_buffer("chunk_mod", torch.from_numpy(
            np.stack([down.real, down.imag], -1).astype(np.float32)))

    def chunk_dft(self, iq: torch.Tensor, num_hops: int) -> torch.Tensor:
        """iq [..., T, 2] -> G [..., num_hops + 7, F, 2] (zero-padded past
        T, as the JAX ``run`` pads)."""
        nchunks = num_hops + _R - 1
        need = nchunks * self.hop
        pad = need - iq.shape[-2]
        if pad > 0:
            iq = torch.nn.functional.pad(iq, (0, 0, 0, pad))
        chunks = iq[..., :need, :].reshape(*iq.shape[:-2], nchunks,
                                           self.hop, 2)
        z = as_complex(chunks) * as_complex(self.chunk_mod)
        return as_ri(torch.fft.fft(z, n=self.fft_size, dim=-1))


def spectra_from_chunks(g: torch.Tensor, plan: OverlapPlan, num_hops: int):
    """G [..., num_hops + 7, F, 2] -> (fft_add, fft_add_w, h_single), each
    [..., num_hops, K] — K2's and K5's plain version (roll-based j-sum
    with rho from one period, and window convolution,
    gr_lora_tpu/ops/overlap_dft.py:136-157)."""
    k = plan.bin_size
    f = plan.fft_size
    rho = plan.rho_period.repeat(1, f // plan.period, 1)   # [8, F, 2]
    x = None
    for j in range(_R):
        gj = torch.roll(g[..., j:j + num_hops, :, :], plan.sigma_list[j],
                        dims=-2)
        term = cmul(gj, rho[j])
        x = term if x is None else x + term           # [..., H, F, 2]

    # Top-band fold for all p (ops/dechirp.py docstring).
    mags = cmag(x)
    fft_add = mags[..., :k] + mags[..., f - k:]
    h_single = torch.maximum(mags[..., :k], mags[..., f - k:])

    xw = None
    for t, shift in enumerate(plan.shift_list):
        term = cmul(torch.roll(x, shift, dims=-2), plan.win_taps[t])
        xw = term if xw is None else xw + term
    magw = cmag(xw)
    fft_add_w = magw[..., :k] + magw[..., f - k:]
    return fft_add, fft_add_w, h_single


def fast_pyramid_spectra(iq: torch.Tensor, cfg: LoraConfig, num_hops: int):
    """iq [..., T, 2] -> (fft_add, fft_add_w, h_single), each
    [..., num_hops, K]: the overlap-decomposed dense spectra."""
    plan = OverlapPlan(cfg.sf, cfg.p, cfg.fft_factor,
                       float(cfg.beta)).to(iq.device)
    return spectra_from_chunks(plan.chunk_dft(iq, num_hops), plan, num_hops)
