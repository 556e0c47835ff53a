"""Gray mapping between interleaved symbols and chirp bins.

Vectorized over symbol arrays (reference loops: encode_impl.cc:114-135,
decode_impl.cc:113-133).  The LoRa convention is inverted relative to the
usual naming: the *encoder* applies the inverse Gray map plus the +1 bin
offset, and the *decoder* applies the forward Gray map after removing it.
"""

from __future__ import annotations

import numpy as np


def to_gray(symbols: np.ndarray) -> np.ndarray:
    """v -> v ^ (v >> 1)."""
    s = np.asarray(symbols, dtype=np.uint16)
    return s ^ (s >> 1)


def from_gray(symbols: np.ndarray) -> np.ndarray:
    """Inverse Gray map via prefix XOR."""
    s = np.asarray(symbols, dtype=np.uint16).copy()
    for shift in (8, 4, 2, 1):
        s ^= s >> shift
    return s


def gray_to_tx_bins(symbols: np.ndarray, sf: int, ldr: bool) -> np.ndarray:
    """Encoder-side map from interleaved Gray symbols to transmitted chirp
    bins: header symbols (first 8) and all LDR symbols use (g*4 + 1) mod 2^sf,
    the rest (g + 1) mod 2^sf (reference: encode_impl.cc:124-135)."""
    g = from_gray(symbols).astype(np.uint32)
    n = np.uint32(1 << sf)
    idx = np.arange(len(g))
    hdr = (idx < 8) | ldr
    return np.where(hdr, (g * 4 + 1) % n, (g + 1) % n).astype(np.uint16)


def rx_bins_to_gray(bins: np.ndarray, sf: int, ldr: bool) -> np.ndarray:
    """Decoder-side normalization + Gray map: header symbols (first 8) and
    all LDR symbols divide by 4 (truncating), the rest subtract 1 modulo 2^sf
    (reference: decode_impl.cc:299-314)."""
    v = np.asarray(bins, dtype=np.int64)
    n = 1 << sf
    idx = np.arange(len(v))
    hdr = (idx < 8) | ldr
    norm = np.where(hdr, v // 4, (v - 1) % n).astype(np.uint16)
    return to_gray(norm)
