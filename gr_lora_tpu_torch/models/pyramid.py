"""Pyramid real-time collision decoder (INFOCOM 2021): the peak lattice,
the one-shot decoder and its block-streaming form.

Twin of gr_lora_tpu/models/pyramid.py.  The dense lattice runs in
PyTorch on the input's device: every overlapped hop (hop = symbol / 8) is
dechirped and zoom-transformed twice (unwindowed and Kaiser-windowed,
pyramid_demod_impl.cc:569-603), folded, local-max masked, thresholded and
reduced to the top-M peaks per hop.  The sparse tracking runs on the host
in the port's C++ tracker (gr_lora_tpu_torch.native), fed the peak lists.

Backends of :func:`peak_lattice_fn`, dispatched as the JAX package
dispatches them (models/pyramid.py:83-193):

- ``"xla"``: dense f32 spectra of explicit frames (ops/dechirp.py) plus
  the plain epilogue; beyond the JAX direct-plan size it becomes "fast";
- ``"fast"``: the overlap-decomposed dense f32 spectra plus the plain
  epilogue;
- ``"rdft"``, ``"direct"``, ``"fastp"``, ``"pallas"``: the dense spectra
  of the hand-written kernels K3 (ops/rdft_spectra.py), K4b
  (ops/direct.py), K5 (ops/overlap_spectra.py) and K6
  (ops/chunk_spectra.py), followed by the peak epilogue (the
  ``peak_topm`` kernel on the card, the plain one on the CPU);
- ``"fused"``: the peak-lattice kernels, split over SF as the JAX
  dispatch splits them — K1 (ops/rdft_peaks.py) where
  ``rdft_peaks_supported``, else K4 (ops/direct.py) where the direct
  plan fits, else K2 (ops/overlap_peaks.py) where
  ``overlap_peaks_supported``, else "xla";
- ``"fused_direct"``: as "fused" without K1.

On a CPU tensor every kernel module runs its plain version.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import native
from ..config import PYRAMID_OVERLAP_FACTOR, LoraConfig
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..ops.chunk_spectra import ChunkSpectra
from ..ops.cplx import to_ri
from ..ops.dechirp import fold_spectra, frame_signal, pyramid_plan
from ..ops.direct import DirectPeaks, DirectSpectra
from ..ops.overlap_dft import OverlapPlan, spectra_from_chunks
from ..ops.overlap_peaks import OverlapPeaks, overlap_peaks_supported
from ..ops.overlap_spectra import OverlapSpectra
from ..ops.peak_epilogue import launch_topm, peaks_plain
from ..ops.rdft_peaks import RdftPeaks, rdft_peaks_supported
from ..ops.rdft_spectra import RdftSpectra

#: Matrices larger than this (complex elements) leave the JAX direct plan
#: (gr_lora_tpu/ops/dft.py _DIRECT_MAX_ELEMS); the dense "xla" backend and
#: the fused dispatch test the same size.
_DIRECT_MAX_ELEMS = 1 << 23

BACKENDS = ("xla", "fast", "rdft", "direct", "fastp", "pallas", "fused",
            "fused_direct")
#: The dense-spectra kernel module of each kernel backend.
_FRONTS = {"rdft": RdftSpectra, "direct": DirectSpectra,
           "fastp": OverlapSpectra, "pallas": ChunkSpectra}


def num_hops_for(cfg: LoraConfig, num_samples_total: int) -> int:
    n = cfg.num_samples
    hop = n // PYRAMID_OVERLAP_FACTOR
    return max((num_samples_total - n) // hop + 1, 0)


class DenseLattice(nn.Module):
    """Dense spectra followed by the peak epilogue: "xla" (explicit
    frames) and "fast" (overlap decomposition) in plain f32 PyTorch, or
    the kernel backends' ``front`` module (K3, K4b, K5 or K6), whose spectra
    on the card go to the ``peak_topm`` kernel."""

    def __init__(self, cfg: LoraConfig, num_hops: int, max_peaks: int,
                 backend: str):
        super().__init__()
        self.cfg = cfg
        self.num_hops = num_hops
        self.max_peaks = max_peaks
        self.backend = backend
        self.front = None
        if backend == "xla":
            self.plan = pyramid_plan(cfg.sf, cfg.p, cfg.fft_factor,
                                     float(cfg.beta))
        elif backend == "fast":
            self.plan = OverlapPlan(cfg.sf, cfg.p, cfg.fft_factor,
                                    float(cfg.beta))
        else:
            self.front = _FRONTS[backend](cfg, num_hops)

    def spectra(self, iq: torch.Tensor):
        cfg = self.cfg
        if self.front is not None:
            return self.front(iq)
        if self.backend == "fast":
            g = self.plan.chunk_dft(iq, self.num_hops)
            return spectra_from_chunks(g, self.plan, self.num_hops)
        n = cfg.num_samples
        frames = frame_signal(iq, n, n // PYRAMID_OVERLAP_FACTOR,
                              self.num_hops)
        return fold_spectra(self.plan(frames))

    def forward(self, iq: torch.Tensor):
        fa, faw, hs = self.spectra(iq)
        epilogue = launch_topm if self.front is not None and fa.is_cuda \
            else peaks_plain
        return epilogue(fa, faw, hs, float(self.cfg.threshold),
                        self.max_peaks)


class BlockedLattice(nn.Module):
    """Runs ``inner`` (a ``block_hops`` lattice) over consecutive hop
    blocks.  Blocks overlap by the symbol-minus-hop halo, so every hop
    window is self-contained and the peak decisions match the unblocked
    plan; only one block's spectra are ever resident."""

    def __init__(self, inner: nn.Module, cfg: LoraConfig, num_hops: int,
                 block_hops: int):
        super().__init__()
        self.inner = inner
        self.num_hops = num_hops
        self.block_hops = block_hops
        n = cfg.num_samples
        self.hop = n // PYRAMID_OVERLAP_FACTOR
        self.seg = block_hops * self.hop + n - self.hop

    def forward(self, iq: torch.Tensor):
        nb = -(-self.num_hops // self.block_hops)
        need = (nb - 1) * self.block_hops * self.hop + self.seg
        pad = need - iq.shape[-2]
        if pad > 0:
            iq = torch.nn.functional.pad(iq, (0, 0, 0, pad))
        outs = [self.inner(iq[..., b * self.block_hops * self.hop:
                              b * self.block_hops * self.hop + self.seg, :])
                for b in range(nb)]
        return tuple(torch.cat(parts, dim=-2)[..., :self.num_hops, :]
                     for parts in zip(*outs))


def peak_lattice_fn(cfg: LoraConfig, num_hops: int, max_peaks: int = 16,
                    backend: str = "xla",
                    block_hops: int | None = None) -> nn.Module:
    """A module mapping iq float32 [..., T, 2] -> per-hop top-M peaks
    (bins int32, h f32, h_single f32, valid bool), each [..., H, M].

    Peaks are the strict cyclic local maxima of the Kaiser-windowed folded
    spectrum above cfg.threshold (pyramid_demod_impl.cc:229-235); h is
    the unwindowed folded height and h_single the max of the two unfolded
    edge bands (:269).  The module is built on the CPU: move it with
    ``.to(device)``.  ``block_hops`` bounds the resident spectra as in
    the JAX package; the K1 and K4 lattices ignore it, as there."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    n = cfg.num_samples
    if backend in ("fused", "fused_direct"):
        if backend == "fused" and rdft_peaks_supported(cfg):
            return RdftPeaks(cfg, num_hops, max_peaks)
        if n * 4 * cfg.bin_size <= _DIRECT_MAX_ELEMS:
            return DirectPeaks(cfg, num_hops, max_peaks)
        backend = "fused" if overlap_peaks_supported(cfg) else "xla"

    if block_hops is not None and num_hops > block_hops:
        inner = peak_lattice_fn(cfg, block_hops, max_peaks, backend)
        return BlockedLattice(inner, cfg, num_hops, block_hops)
    if backend == "fused":
        return OverlapPeaks(cfg, num_hops, max_peaks)
    if backend == "xla" and n * 4 * cfg.bin_size > _DIRECT_MAX_ELEMS:
        backend = "fast"
    return DenseLattice(cfg, num_hops, max_peaks, backend)


def pyramid_demodulate(iq, cfg: LoraConfig, max_peaks: int = 16,
                       flush: bool = True, use_native: bool | None = None,
                       backend: str = "xla", grace: int = 0,
                       split_repeats: bool = False, quantize: str = "round",
                       device: str | torch.device = DEFAULT_DEVICE
                       ) -> list[np.ndarray]:
    """IQ stream -> one uint16 symbol vector per (colliding) packet.

    ``iq`` is complex [T], float32 [T, 2] (numpy) or a float32 [T, 2]
    tensor; the lattice runs on ``device`` (the card unless the caller
    passes ``device="cpu"``).  Tracking uses the port's native C++
    tracker, which is behavior-identical to the JAX package's Python
    tracker; the Python tracker is not ported (``use_native=False``
    raises).
    """
    if use_native is False:
        raise NotImplementedError("the Python PyramidTracker is not ported; "
                                  "the port tracks with its native tracker")
    dev = resolve_device(device)
    if isinstance(iq, torch.Tensor):
        x = iq.to(dev, torch.float32)
    else:
        a = np.asarray(iq)
        if np.iscomplexobj(a):
            a = to_ri(a)
        x = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    nh = num_hops_for(cfg, x.shape[0])
    if nh == 0:
        return []
    lattice = peak_lattice_fn(cfg, nh, max_peaks, backend).to(x.device)
    with torch.no_grad():
        bins, h, hs, valid = (t.cpu().numpy() for t in lattice(x))

    tracker = native.PyramidTracker(cfg, grace=grace,
                                    split_repeats=split_repeats,
                                    quantize=quantize)
    for t in range(nh):
        v = valid[t]
        if v.any():
            # The reference scans bins in ascending order (:227);
            # replicate so first-match track assignment is identical.
            order = np.argsort(bins[t][v], kind="stable")
            tracker.step(bins[t][v][order], h[t][v][order], hs[t][v][order])
        else:
            tracker.step()
    if flush:
        for _ in range(tracker.flush_hops() + grace):
            tracker.step()
    return tracker.drain()


class StreamingPyramidDemodulator:
    """Block-streaming collision decoder: the dense lattice runs per block
    (fixed shapes, one module on ``device``), while the native tracker —
    whose ts_ref/bin_ref carry the hop phase — persists across blocks, so
    packets spanning block boundaries assemble exactly as in one-shot
    mode.  Twin of the JAX ``StreamingPyramidDemodulator``; the Python
    tracker is not ported (``use_native=False`` raises)."""

    def __init__(self, cfg: LoraConfig, block_hops: int = 2048,
                 max_peaks: int = 16, grace: int = 0,
                 use_native: bool | None = None, backend: str = "xla",
                 split_repeats: bool = False, quantize: str = "round",
                 device: str | torch.device = DEFAULT_DEVICE):
        if use_native is False:
            raise NotImplementedError("the Python PyramidTracker is not "
                                      "ported; the port tracks with its "
                                      "native tracker")
        self.cfg = cfg
        self.block_hops = block_hops
        self.device = resolve_device(device)
        n = cfg.num_samples
        self._hop = n // PYRAMID_OVERLAP_FACTOR
        self._overlap = n - self._hop     # samples shared between blocks
        self.tracker = native.PyramidTracker(
            cfg, grace=grace, split_repeats=split_repeats, quantize=quantize)
        self._grace = grace
        self._pending = np.zeros((0, 2), np.float32)
        self._lattice = peak_lattice_fn(cfg, block_hops, max_peaks,
                                        backend).to(self.device)

    @torch.no_grad()
    def feed(self, iq) -> list[np.ndarray]:
        iq = np.asarray(iq)
        if np.iscomplexobj(iq):
            iq = to_ri(iq)
        buf = np.concatenate(
            [self._pending, np.asarray(iq, np.float32).reshape(-1, 2)])
        need = self.block_hops * self._hop + self._overlap
        out: list[np.ndarray] = []
        while buf.shape[0] >= need:
            block = torch.from_numpy(np.ascontiguousarray(buf[:need]))
            bins, h, hs, valid = (
                t.cpu().numpy() for t in self._lattice(block.to(self.device)))
            for t in range(self.block_hops):
                v = valid[t]
                if v.any():
                    order = np.argsort(bins[t][v], kind="stable")
                    self.tracker.step(bins[t][v][order], h[t][v][order],
                                      hs[t][v][order])
                else:
                    self.tracker.step()
            out += self.tracker.drain()
            buf = buf[self.block_hops * self._hop:]
        self._pending = buf
        return out

    def flush(self) -> list[np.ndarray]:
        """Zero-pad the residue to a whole block and expire all state."""
        drain_hops = (self.tracker.flush_hops() + self._grace
                      + self.block_hops)
        pad = drain_hops * self._hop + self._overlap
        return self.feed(np.zeros((pad, 2), np.float32))
