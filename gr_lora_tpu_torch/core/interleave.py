"""LoRa diagonal interleaver.

The reference does this with per-bit shift/mask loops and a `rotl`
(reference: encode_impl.cc:166-200, decode_impl.cc:146-178).  Here each block
is a single vectorized bit-gather:

  forward (encode):  out_sym[x] bit j = bit x of codeword[(j + x) mod ppm]
  reverse (decode):  out_cw[y]  bit i = bit ((y - i) mod ppm) of symbol[i]

which is exactly the reference's "transpose, then rotate row i right by i".

Block structure: the first block always covers sf-2 codewords at 8 bits per
word (CR 4/8); subsequent blocks cover sf-2*ldr codewords at cr+4 bits per
word (reference: encode_impl.cc:178-180).
"""

from __future__ import annotations

import numpy as np


def _interleave_block(cw: np.ndarray, ppm: int, bpw: int) -> np.ndarray:
    cw = cw.astype(np.uint16)
    j = np.arange(ppm, dtype=np.int64)[None, :]
    x = np.arange(bpw, dtype=np.int64)[:, None]
    bits = (cw[(j + x) % ppm] >> x) & 1           # [bpw, ppm]
    return (bits << j).sum(axis=1).astype(np.uint16)


def _deinterleave_block(syms: np.ndarray, ppm: int, bpw: int) -> np.ndarray:
    syms = syms.astype(np.uint16)
    y = np.arange(ppm, dtype=np.int64)[:, None]
    i = np.arange(bpw, dtype=np.int64)[None, :]
    bits = (syms[None, :] >> ((y - i) % ppm)) & 1  # [ppm, bpw]
    return (bits << i).sum(axis=1).astype(np.uint8)


def interleave(codewords: np.ndarray, sf: int, cr: int, ldr: bool) -> np.ndarray:
    """Codewords -> interleaved symbols (Gray domain).

    Reference: encode_impl.cc:172-200.
    """
    cw = np.asarray(codewords, dtype=np.uint8)
    out = []
    start = 0
    first = True
    while True:
        ppm = (sf - 2) if first else (sf - 2 * int(ldr))
        bpw = 8 if first else (cr + 4)
        if start + ppm > len(cw):
            break
        out.append(_interleave_block(cw[start:start + ppm], ppm, bpw))
        start += ppm
        first = False
    if not out:
        return np.zeros(0, dtype=np.uint16)
    return np.concatenate(out)


def deinterleave(symbols: np.ndarray, ppm: int, rdd: int) -> np.ndarray:
    """Interleaved symbols -> codewords; processes ``len(symbols) // (rdd+4)``
    full blocks (reference: decode_impl.cc:159-178)."""
    syms = np.asarray(symbols, dtype=np.uint16)
    bpw = rdd + 4
    nblocks = len(syms) // bpw
    out = [
        _deinterleave_block(syms[k * bpw:(k + 1) * bpw], ppm, bpw)
        for k in range(nblocks)
    ]
    if not out:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(out)
