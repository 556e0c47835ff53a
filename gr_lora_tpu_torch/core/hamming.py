"""LoRa's non-standard Hamming(4+cr, 4) code.

Table-driven, vectorized versions of the reference's per-nibble loops
(reference: encode_impl.cc:203-264, decode_impl.cc:180-241).  The codeword
bit layout is p4 p2 p1 p3 d1 d2 d4 d3 (MSB..LSB) with different generator
masks on encode and syndrome masks on decode — both landmines are carried
over exactly.
"""

from __future__ import annotations

import numpy as np

from . import constants as C


def _parity_table(mask: int) -> np.ndarray:
    vals = np.arange(256, dtype=np.uint16) & mask
    # popcount via bit tricks
    v = vals
    v = (v & 0x5555) + ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v & 0x0F0F) + ((v >> 4) & 0x0F0F)
    v = (v & 0x00FF) + (v >> 8)
    return (v & 1).astype(np.uint8)


_ENC_P1 = _parity_table(C.HAMMING_ENC_P1)
_ENC_P2 = _parity_table(C.HAMMING_ENC_P2)
_ENC_P3 = _parity_table(C.HAMMING_ENC_P3)
_ENC_P4 = _parity_table(C.HAMMING_ENC_P4)
_ENC_P5 = _parity_table(C.HAMMING_ENC_P5)
_DEC_P1 = _parity_table(C.HAMMING_DEC_P1)
_DEC_P2 = _parity_table(C.HAMMING_DEC_P2)
_DEC_P3 = _parity_table(C.HAMMING_DEC_P3)

# Syndrome (p3<<2 | p2<<1 | p1) -> XOR mask fixing the indicated data bit
# (reference: decode_impl.cc:197-222).
_SYNDROME_FIX = np.zeros(8, dtype=np.uint8)
_SYNDROME_FIX[3] = C.HAMMING_DEC_D1
_SYNDROME_FIX[5] = C.HAMMING_DEC_D2
_SYNDROME_FIX[6] = C.HAMMING_DEC_D3
_SYNDROME_FIX[7] = C.HAMMING_DEC_D4


def hamming_encode(nibbles: np.ndarray, sf: int, cr: int) -> np.ndarray:
    """Nibbles -> codewords.  The first sf-2 nibbles always use CR 4/8
    regardless of the configured code rate (reference: encode_impl.cc:217)."""
    nib = np.asarray(nibbles, dtype=np.uint8) & 0xF
    p1, p2, p3 = _ENC_P1[nib], _ENC_P2[nib], _ENC_P3[nib]
    p4, p5 = _ENC_P4[nib], _ENC_P5[nib]

    by_cr = {
        1: (p4 << 4) | nib,
        2: (p5 << 5) | (p3 << 4) | nib,
        3: (p2 << 6) | (p5 << 5) | (p3 << 4) | nib,
        4: (p1 << 7) | (p2 << 6) | (p5 << 5) | (p3 << 4) | nib,
    }
    out = by_cr[cr].astype(np.uint8)
    if sf - 2 > 0:
        head = by_cr[4][: sf - 2].astype(np.uint8)
        out[: sf - 2] = head
    return out


def hamming_decode(codewords: np.ndarray, sf: int, rdd: int) -> np.ndarray:
    """Codewords -> corrected data nibbles.  Single-bit correction is applied
    only when the codeword carries enough parity — rdd > 2 — or for the first
    sf-2 codewords, which are always CR 4/8 (reference: decode_impl.cc:186-225).
    """
    cw = np.asarray(codewords, dtype=np.uint8).copy()
    syndrome = (_DEC_P3[cw].astype(np.uint8) << 2) | (_DEC_P2[cw] << 1) | _DEC_P1[cw]
    fix = _SYNDROME_FIX[syndrome]
    idx = np.arange(len(cw))
    correctable = (rdd > 2) | (idx < sf - 2)
    cw = np.where(correctable, cw ^ fix, cw)
    return (cw & 0x0F).astype(np.uint8)
