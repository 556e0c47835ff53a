"""K5: the overlap-decomposed pyramid spectra (backend "fastp"; the front
end of K2).

Replaces gr_lora_tpu/ops/pallas_overlap.py ``make_overlap_spectra``.  The
chunk spectra G (ops/overlap_dft.py, a cuFFT through ``torch.fft`` outside
the kernel, as the JAX package keeps its chunk matmul outside its Pallas
kernel) feed the j-sum with the ``rho_period``/``sigma`` phase plan, the
window applied as a bin convolution and the fa / faw / hs folds, all in
f32.

On a CUDA tensor :class:`OverlapSpectra` launches
``csrc/overlap_spectra.cu``, the sheared walk: a block owns a band of
columns e = c + sigma_1 b and walks down the hops with the last 8 rows of
G'[r, e] = G[r, e - sigma_1 r] in a ring, so G is read once.  On a CPU
tensor it runs ``overlap_dft.spectra_from_chunks``, the roll-based sums.
The kernel rounds every operation as the plain version does, in its
order, so on the card both give the same bits.  :func:`sheared_spectra`
is the kernel's walk in plain torch, for the tests: the same index
arithmetic (bands, runs, ring, fold pairing) on the CPU.

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
from .cplx import cmag, cmul
from .overlap_dft import OverlapPlan, spectra_from_chunks

_R = PYRAMID_OVERLAP_FACTOR


class OverlapSpectra(nn.Module):
    """iq float32 [..., T, 2] -> (fa, faw, hs) float32 [..., num_hops, K].

    The phase plan is the ``plan`` submodule (buffers rho, rho_period,
    sigma, win_shifts, win_taps, chunk_mod).  ``launches`` counts kernel
    launches made through :meth:`forward` / :meth:`from_chunks` (one per
    call on a CUDA tensor); :meth:`kernel` launches without counting, for
    K2."""

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

    def launch_args(self, g: torch.Tensor):
        """(G [lanes, rows, F, 2] contiguous, its leading shape, the C
        arguments from the plan through ``halo``) for a launch of the
        walk; raises on what the kernel does not take."""
        if (not g.is_cuda or g.dtype != torch.float32 or g.shape[-1] != 2
                or g.shape[-2] != self.f
                or g.shape[-3] < self.num_hops + _R - 1):
            raise ValueError("the overlap kernel takes CUDA float32 "
                             f"[..., >= {self.num_hops + _R - 1}, {self.f}, 2]")
        p = self.plan
        if p.rho_period.device != g.device:
            raise ValueError(f"module on {p.rho_period.device}, "
                             f"G on {g.device}")
        s1 = p.sigma_list[1]
        if any(s != j * s1 % self.f for j, s in enumerate(p.sigma_list)):
            raise ValueError(f"sigma is not j sigma_1 mod F: {p.sigma_list}")
        x = g.reshape(-1, *g.shape[-3:]).contiguous()
        args = (x.data_ptr(), p.rho_period.data_ptr(),
                p.win_shifts.data_ptr(), p.win_taps.data_ptr())
        geometry = (x.shape[0], x.shape[1], self.num_hops, self.f, self.k,
                    s1, p.period, p.win_taps.shape[0], self.halo)
        return x, g.shape[:-3], args, geometry

    def kernel(self, g: torch.Tensor):
        """Kernel (fa, faw, hs) [..., H, K] for a CUDA G (not counted)."""
        x, lead, args, geometry = self.launch_args(g)
        out = torch.empty((3, x.shape[0], self.num_hops, self.k),
                          dtype=torch.float32, device=g.device)
        fa, faw, hs = out[0], out[1], out[2]
        lib = _build.library()
        with torch.cuda.device(g.device):
            err = lib.grl_overlap_spectra(
                *args, fa.data_ptr(), faw.data_ptr(), hs.data_ptr(),
                *geometry, _build.stream_of(x))
        _build.check("grl_overlap_spectra", err)
        shape = (*lead, self.num_hops, self.k)
        return fa.reshape(shape), faw.reshape(shape), hs.reshape(shape)


def sheared_spectra(g: torch.Tensor, plan: OverlapPlan, num_hops: int,
                    band: int = 256, run: int | None = None):
    """G [..., >= num_hops + 7, F, 2] -> (fa, faw, hs) [..., num_hops, K]
    by ``csrc/overlap_spectra.cu``'s walk, in plain torch (tests only).

    Bands of ``band`` columns e (both sides, e and e + F - K; over [0, K)
    at p = 2, [0, F) otherwise) walk runs of ``run`` hops with a ring of
    the last 8 G' rows, each row loaded as the kernel loads it (its band
    plus an even halo, from bin e0 - halo - sigma_1 r mod F on); X from
    the ring with rho_period at the column's index, the window along e,
    then each column's output by the kernel's fold pairing.  Every
    operation is rounded as the kernel and ``spectra_from_chunks`` round
    it, so the three agree bit for bit.  (The kernel also pads the window
    to 16 taps with zero taps, which change no magnitude, and walks the
    hops in pairs; neither changes an operation.)"""
    f, k = plan.fft_size, plan.bin_size
    s1, per = plan.sigma_list[1], plan.period
    if band % per or band % 2 or s1 % per:
        raise ValueError(f"the walk needs band and sigma_1 multiples of "
                         f"P = {per}: band {band}, sigma_1 {s1}")
    shifts = plan.win_shifts.tolist()
    halo = max(abs(s) for s in shifts)
    hp = halo + (halo & 1)
    width = band + 2 * hp
    off, span = f - k, (k if f == 2 * k else f)
    bands = -(-span // band)
    run = run or num_hops
    lead = g.shape[:-3]
    x = g.reshape(-1, *g.shape[-3:])
    lanes = x.shape[0]
    out = torch.zeros((3, lanes, num_hops, k), dtype=torch.float32)
    e0 = torch.arange(bands) * band                          # [B]
    u = torch.arange(width)
    side_off = torch.tensor([0, off])
    # Columns of a loaded row before the shear: [B, 2, W].
    cols = e0[:, None, None] - hp + side_off[None, :, None] + u
    rho = plan.rho_period[:, (u - hp) % per]                 # [8, W, 2]
    taps = plan.win_taps
    t = torch.arange(band)
    for b0 in range(0, num_hops, run):
        b1 = min(num_hops, b0 + run)
        ring = {}

        def load(r):
            ring[r % _R] = x[:, r][:, (cols - s1 * r) % f]   # [L, B, 2, W, 2]
        for r in range(b0, b0 + _R - 1):
            load(r)
        for b in range(b0, b1):
            load(b + _R - 1)
            xs = cmul(ring[b % _R], rho[0])
            for j in range(1, _R):
                xs = xs + cmul(ring[(b + j) % _R], rho[j])
            win = xs[..., hp:hp + band, :]
            xw = cmul(xs[..., hp - shifts[0]:hp - shifts[0] + band, :],
                      taps[0])
            for q in range(1, len(shifts)):
                lo_q = hp - shifts[q]
                xw = xw + cmul(xs[..., lo_q:lo_q + band, :], taps[q])
            mag, magw = cmag(win), cmag(xw)                  # [L, B, 2, E]
            c = (e0[:, None] + t - s1 * b) % f               # [B, E]
            keep = (e0[:, None] + t < span) & ((c < k) | (f == 2 * k))
            swap = c >= k
            cc = torch.where(swap, c - k, c)
            lo = torch.where(swap, mag[:, :, 1], mag[:, :, 0])
            hi = torch.where(swap, mag[:, :, 0], mag[:, :, 1])
            low = torch.where(swap, magw[:, :, 1], magw[:, :, 0])
            hiw = torch.where(swap, magw[:, :, 0], magw[:, :, 1])
            for i, v in enumerate((lo + hi, low + hiw,
                                   torch.maximum(lo, hi))):
                out[i, :, b, cc[keep]] = v[:, keep]
    shape = (*lead, num_hops, k)
    return tuple(o.reshape(shape) for o in out)
