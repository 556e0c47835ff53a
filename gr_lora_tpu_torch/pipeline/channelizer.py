"""Wideband channelizer: one SDR stream -> a bank of LoRa channels.

Port of gr_lora_tpu/pipeline/channelizer.py.  The reference processes a
single 125 kHz channel and lists multi-channel decoding as future work
(reference README.md:45).  A gateway ingests one wideband capture (e.g.
8 Msps = 64 x 125 kHz) and must split it into per-channel baseband
streams at the demod rate p*bw.  Output sample m of channel c is

    y[m, c] = phase(m, c) * dot(x[m*D : m*D + W], h .* carrier_c)

i.e. strided input frames and ONE packed complex matmul against a
[W, C] filter-times-carrier matrix, with the residual per-(m, c) phase
an elementwise factor.  Decimation D = fs_in / (p * spacing) gives output
directly at the demod rate (oversampled-by-p channelizer), so the result
feeds the gateways and receivers unchanged.

On the device: the frames are ``x.unfold(0, W, D)`` — [M, 2, W], which
reshaped to [M, 2W] is already the [re | im] operand order of
``pack_cmatmul_weights`` (the JAX package builds them from a chunked view
because the TPU has no cheap gather).  The product runs in full f32
whatever the TF32 flags (TF32's 10-bit mantissa would eat into the
> 50 dB adjacent-channel rejection).  The residual phase is computed on
the device in float64 from the absolute input index, reduced modulo one
turn, and cast to f32 only after the cos / sin: in f32 it drifts within
seconds of stream.  Nothing of size [M, C] crosses the host link.  No
kernel: ``channelize`` holds no ``pl.pallas_call``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..device import upload
from ..ops.cplx import cmatmul_packed, pack_cmatmul_weights


@lru_cache(maxsize=None)
def _channelizer_plan(num_channels: int, decim: int, taps_per_phase: int,
                      spacing_ratio: float):
    """Precompute the packed [2W, 2C] filter-carrier matrix (the JAX
    package's NumPy design).

    spacing_ratio = channel spacing / fs_in (= 1 / num_channels for a
    critically-stacked bank).
    """
    # Windowed sinc designed AT the bank length: LoRa needs >50 dB
    # adjacent-stream rejection (it decodes below -12 dB SNR), so never
    # truncate a longer design — that wrecks the stopband.
    w = taps_per_phase * num_channels | 1
    m = (w - 1) // 2
    ns0 = np.arange(-m, m + 1)
    cutoff = 0.5 * spacing_ratio
    proto = np.sinc(2 * cutoff * ns0) * (2 * cutoff) * np.kaiser(w, 10.0)
    proto = (proto / proto.sum()).astype(np.float32)
    # Channel c sits at frequency offset (c - C/2) * spacing (centered grid).
    offs = (np.arange(num_channels) - num_channels // 2) * spacing_ratio
    ns = np.arange(w)
    carrier = np.exp(-2j * np.pi * np.outer(ns, offs))       # [W, C]
    wc = proto[:, None] * carrier
    packed = pack_cmatmul_weights(wc.real.astype(np.float32),
                                  wc.imag.astype(np.float32))
    return packed, w, offs


@lru_cache(maxsize=None)
def _device_plan(num_channels: int, decim: int, taps_per_phase: int,
                 spacing_ratio: float, device: torch.device):
    """The plan's packed weights (f32) and channel offsets (f64) on
    ``device``, uploaded once."""
    packed, w, offs = _channelizer_plan(num_channels, decim, taps_per_phase,
                                        spacing_ratio)
    return (torch.from_numpy(packed).to(device), w,
            torch.from_numpy(offs).to(device))


def _decimation(fs_in: float, out_rate: float) -> int:
    decim_f = fs_in / out_rate
    decim = int(round(decim_f))
    if abs(decim - decim_f) > 1e-9:
        raise ValueError(f"fs_in {fs_in} not an integer multiple of {out_rate}")
    return decim


def channelize(iq, num_channels: int, fs_in: float,
               spacing: float = 125e3, p: int = 2,
               taps_per_phase: int = 16, sample_offset: int = 0,
               device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """[T, 2] (or complex [T]) wideband IQ at fs_in -> [C, T_out, 2]
    float32 per-channel baseband at p * spacing on ``device`` (ready for
    the demodulators).

    fs_in must be an integer multiple of p * spacing.  ``sample_offset`` is
    the absolute input-sample index of ``iq[0]`` — it keeps the residual
    carrier phase continuous when a long stream is channelized in blocks
    (StreamingChannelizer passes it).
    """
    decim = _decimation(fs_in, p * spacing)
    x = upload(iq, resolve_device(device)).reshape(-1, 2)
    packed, w, offs = _device_plan(num_channels, decim, taps_per_phase,
                                   spacing / fs_in, x.device)
    m = max((x.shape[0] - w) // decim + 1, 0)
    if m == 0:
        return torch.zeros((num_channels, 0, 2), dtype=torch.float32,
                           device=x.device)
    frames = x[:(m - 1) * decim + w].unfold(0, w, decim)      # [M, 2, W]
    y = cmatmul_packed(frames.transpose(1, 2), packed)         # [M, C, 2]

    # Residual carrier phase at the frame starts, e^{-2pi i f_c m D}, in
    # float64 turns reduced to [0, 1) before the cos / sin.
    md = (torch.arange(m, dtype=torch.float64, device=x.device) * decim
          + sample_offset)
    turns = md[:, None] * offs[None, :]
    ang = (-2 * np.pi) * (turns - torch.floor(turns))
    c, s = torch.cos(ang).float(), torch.sin(ang).float()
    yr, yi = y[..., 0], y[..., 1]
    return torch.stack([yr * c - yi * s, yr * s + yi * c],
                       dim=-1).transpose(0, 1).contiguous()   # [C, M, 2]


def channel_frequencies(num_channels: int, spacing: float = 125e3
                        ) -> np.ndarray:
    """Baseband center frequency of each output channel."""
    return (np.arange(num_channels) - num_channels // 2) * spacing


class StreamingChannelizer:
    """``channelize`` over an unbounded stream, fed in arbitrary blocks.

    Carries the polyphase filter history (w - decim samples) on the
    channelizer's device across block seams, and the absolute input-sample
    index (an exact Python int: the phase math reads it in float64 on the
    device) for residual-carrier phase continuity, so the concatenated
    per-channel outputs equal one whole-capture ``channelize`` call
    (tests/test_torch_channelizer.py).
    """

    def __init__(self, num_channels: int, fs_in: float,
                 spacing: float = 125e3, p: int = 2,
                 taps_per_phase: int = 16,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.decim = _decimation(fs_in, p * spacing)
        self.num_channels = num_channels
        self.fs_in = fs_in
        self.spacing = spacing
        self.p = p
        self.taps_per_phase = taps_per_phase
        self.w = taps_per_phase * num_channels | 1
        self._hist = torch.zeros((0, 2), dtype=torch.float32,
                                 device=self.device)
        self._abs = 0            # absolute input-sample index of _hist[0]
        #: absolute OUTPUT-sample index of the next emitted sample
        self.out_pos = 0

    def feed(self, iq_ri) -> torch.Tensor:
        """[T, 2] float32 (or [T] complex) — a host array, uploaded once
        from pinned memory, or a tensor — -> [C, M, 2] on the
        channelizer's device; M may be 0 while the filter history fills."""
        x = torch.cat([self._hist,
                       upload(iq_ri, self.device).reshape(-1, 2)], dim=0)
        m = (x.shape[0] - self.w) // self.decim + 1
        if m <= 0:
            self._hist = x
            return torch.zeros((self.num_channels, 0, 2),
                               dtype=torch.float32, device=self.device)
        y = channelize(x, self.num_channels, self.fs_in, self.spacing,
                       p=self.p, taps_per_phase=self.taps_per_phase,
                       sample_offset=self._abs, device=self.device)
        consumed = m * self.decim
        self._hist = x[consumed:]
        self._abs += consumed
        self.out_pos += m
        return y

    def flush(self) -> torch.Tensor:
        """Zero-pad the history through the filter; final partial output."""
        return self.feed(torch.zeros((self.w, 2), dtype=torch.float32,
                                     device=self.device))
