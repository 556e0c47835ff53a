"""A plain LoRa receiver for packets whose start is known: the check of the
traffic generator.

Each payload symbol's window is dechirped and transformed at its known
place; the folded magnitude's argmax is the chirp bin.  The bins are
decoded by the plain rules (Gray map, the diagonal de-interleaver,
Hamming(4 + cr, 4) with the first block at 4/8, dewhitening, the payload
CRC).  It corrects no bit and resolves no collision: it only reads clean
air, which is what the generator's tests hand it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spectra

NUM_PREAMBLE_CHIRPS = 8


def _whitening() -> np.ndarray:
    s = np.ones(255 + 7, np.uint8)
    for i in range(8, len(s)):
        s[i] = s[i - 4] ^ s[i - 5] ^ s[i - 6] ^ s[i - 8]
    win = np.lib.stride_tricks.sliding_window_view(s, 8)[:255]
    return (win * (1 << np.arange(7, -1, -1))).sum(axis=1).astype(np.uint8)


def _crc16(data) -> int:
    crc = 0
    for b in data[:max(len(data) - 2, 0)]:
        crc ^= int(b) << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) if crc & 0x8000 else crc << 1
            crc &= 0xFFFF
    return crc ^ int(data[-1]) ^ (int(data[-2]) << 8)


def demod_bins(iq: torch.Tensor, start: int, count: int, sf: int,
               p: int) -> list[int]:
    """Chirp bins of ``count`` payload symbols of the packet whose first
    preamble sample is ``start`` in ``iq`` (float [T, 2])."""
    n = p << sf
    first = start + (NUM_PREAMBLE_CHIRPS + 2) * n + 2 * n + n // 4
    fr = spectra.frames(spectra.as_complex(iq), n, n, count, start=first)
    lo, hi = spectra.bands(fr, spectra.dechirp(sf, p, iq.device), sf, 1)
    return (lo + hi).argmax(-1).tolist()


def _deinterleave(syms: list[int], ppm: int, bpw: int) -> list[int]:
    return [sum(((syms[i] >> ((y - i) % ppm)) & 1) << i for i in range(bpw))
            for y in range(ppm)]


def _hamming(cw: int, fix: bool) -> int:
    def par(mask):
        return bin(cw & mask).count("1") & 1

    syndrome = par(0x17) << 2 | par(0x4B) << 1 | par(0x2E)
    if fix:
        cw ^= {3: 0x08, 5: 0x04, 6: 0x01, 7: 0x02}.get(syndrome, 0)
    return cw & 0x0F


def _header_checksum(length: int, cr_crc: int) -> int:
    a = [(length >> (4 + k)) & 1 for k in range(4)]
    b = [(length >> k) & 1 for k in range(4)]
    c = [(cr_crc >> k) & 1 for k in range(4)]
    return ((a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
            | (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
            | (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
            | (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
            | (a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]))


def decode(bins: list[int], sf: int, cr: int, ldr: bool):
    """(payload bytes, crc_ok) of an explicit-header packet's bins, or
    None when its header does not check."""
    gray = []
    for i, b in enumerate(bins):
        v = b // 4 if i < 8 or ldr else (b - 1) % (1 << sf)
        gray.append(v ^ (v >> 1))
    cws = _deinterleave(gray[:8], sf - 2, 8)
    ppm = sf - 2 if ldr else sf
    for k in range(8, len(gray) - (cr + 4) + 1, cr + 4):
        cws += _deinterleave(gray[k:k + cr + 4], ppm, cr + 4)
    cws.insert(5, 0)               # the header's half byte
    nibs = [_hamming(c, i < sf - 2 or cr > 2) for i, c in enumerate(cws)]
    size = nibs[0] << 4 | nibs[1]
    if (nibs[3] << 4 | nibs[4]) != _header_checksum(size, nibs[2]):
        return None
    data = [nibs[2 * i + 1] << 4 | nibs[2 * i]
            for i in range(3, 3 + size + 2)]
    white = _whitening()
    payload = bytes(b ^ int(white[i]) for i, b in enumerate(data[:size]))
    crc_ok = _crc16(payload) == (data[size] | data[size + 1] << 8)
    return payload, crc_ok
