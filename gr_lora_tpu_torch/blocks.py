"""Drop-in block-style API: the reference's Python factory surface.

Mirrors the SWIG-exported ``lora.mod(...)``, ``lora.encode(...)``, etc.
(reference: swig/lora_swig.i:10-30, python/__init__.py:28-33) with the SAME
factory names and positional parameter orders as the C++ ``make()``
signatures, so a gr-lora user can move flowgraph code over mechanically.
Instead of GNU Radio stream/message ports, each block is a callable:
arrays in, arrays out.  Twin of gr_lora_tpu/blocks.py: the receivers run
on ``device`` (the card unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np

from .config import LoraConfig, PeakSearch
from .device import DEFAULT as DEFAULT_DEVICE


class mod:
    """IQ chirp modulator (reference: mod.h:49 — make(sf, sync_word))."""

    def __init__(self, spreading_factor: int, sync_word: int = 0x12):
        self.cfg = LoraConfig(sf=spreading_factor, sync_word=sync_word, p=1)

    def __call__(self, symbols, p: int | None = None) -> np.ndarray:
        from .models.modulator import modulate
        return modulate(np.asarray(symbols, np.uint16), self.cfg,
                        p=p or self.cfg.p)


class encode:
    """Byte -> symbol encoder (reference: encode.h:50-54 —
    make(sf, code_rate, crc, low_data_rate, header))."""

    def __init__(self, spreading_factor: int, code_rate: int, crc: bool,
                 low_data_rate: bool, header: bool):
        self.cfg = LoraConfig(sf=spreading_factor, cr=code_rate, crc=crc,
                              ldr=low_data_rate, explicit_header=header)

    def __call__(self, payload: bytes) -> np.ndarray:
        from .core.codec import encode as _encode
        return _encode(payload, self.cfg)


class decode:
    """Symbol -> byte decoder (reference: decode.h:52-57 —
    make(sf, header, payload_len, code_rate, crc, low_data_rate))."""

    def __init__(self, spreading_factor: int, header: bool, payload_len: int,
                 code_rate: int, crc: bool, low_data_rate: bool):
        self.cfg = LoraConfig(sf=spreading_factor, explicit_header=header,
                              payload_len=payload_len, cr=code_rate, crc=crc,
                              ldr=low_data_rate)

    def __call__(self, symbols):
        from .core.codec import decode as _decode
        return _decode(np.asarray(symbols, np.uint16), self.cfg)


class demod:
    """Single-packet demodulator (reference: demod.h:69-79 — make(sf,
    header, payload_len, cr, crc, low_data_rate, beta, fft_factor,
    peak_search_algorithm, peak_search_phase_k, fs_bw_ratio))."""

    def __init__(self, spreading_factor: int, header: bool, payload_len: int,
                 cr: int, crc: bool, low_data_rate: bool, beta: float = 25.0,
                 fft_factor: int = 10, peak_search_algorithm: int = 0,
                 peak_search_phase_k: int = 4, fs_bw_ratio: float = 2,
                 device=DEFAULT_DEVICE):
        self.cfg = LoraConfig(
            sf=spreading_factor, explicit_header=header,
            payload_len=payload_len, cr=cr, crc=crc, ldr=low_data_rate,
            beta=beta, fft_factor=fft_factor,
            peak_search=PeakSearch(peak_search_algorithm),
            peak_phase_k=peak_search_phase_k, p=int(fs_bw_ratio))
        self.device = device

    def __call__(self, iq, max_packets: int = 8):
        from .models.demodulator import demodulate
        return demodulate(iq, self.cfg, max_packets=max_packets,
                          device=self.device)


class pyramid_demod:
    """Collision demodulator (reference: pyramid_demod.h:58-63 —
    make(sf, low_data_rate, beta, fft_factor, threshold, fs_bw_ratio))."""

    def __init__(self, spreading_factor: int, low_data_rate: bool,
                 beta: float = 25.0, fft_factor: int = 8,
                 threshold: float = 0.005, fs_bw_ratio: float = 8,
                 device=DEFAULT_DEVICE):
        self.cfg = LoraConfig(sf=spreading_factor, ldr=low_data_rate,
                              beta=beta, fft_factor=fft_factor,
                              threshold=threshold, p=int(fs_bw_ratio))
        self.device = device

    def __call__(self, iq):
        from .models.pyramid import pyramid_demodulate
        return pyramid_demodulate(iq, self.cfg, device=self.device)


class weak_demod:
    """Weak-signal demodulator (reference: weak_demod.h:63-74 — make(sf,
    header, payload_len, cr, crc, low_data_rate, sym_num, beta, fft_factor,
    peak_search_algorithm, peak_search_phase_k, fs_bw_ratio))."""

    def __init__(self, spreading_factor: int, header: bool, payload_len: int,
                 cr: int, crc: bool, low_data_rate: bool, sym_num: int,
                 beta: float = 25.0, fft_factor: int = 8,
                 peak_search_algorithm: int = 0, peak_search_phase_k: int = 4,
                 fs_bw_ratio: float = 2, device=DEFAULT_DEVICE):
        self.cfg = LoraConfig(
            sf=spreading_factor, explicit_header=header,
            payload_len=payload_len, cr=cr, crc=crc, ldr=low_data_rate,
            weak_sym_num=sym_num, beta=beta, fft_factor=fft_factor,
            peak_search=PeakSearch(peak_search_algorithm),
            peak_phase_k=peak_search_phase_k, p=int(fs_bw_ratio))
        self.device = device

    def __call__(self, iq):
        from .models.weak import weak_demodulate
        return weak_demodulate(iq, self.cfg, device=self.device)
