"""Protocol constants for the LoRa PHY.

The 255-byte whitening sequence (reference: include/lora/lora.h:29-30) is not
embedded as a table: it is the output of the LFSR x^8 + x^6 + x^5 + x^4 + 1
seeded with all ones, read as a sliding 8-bit window (MSB-first).  We generate
it at import time and it is bit-identical to the reference table (verified in
tests/test_codec_primitives.py).
"""

from __future__ import annotations

import numpy as np

WHITENING_SEQUENCE_LENGTH = 255

# LFSR taps for x^8 + x^6 + x^5 + x^4 + 1 (Fibonacci form, s[n] = s[n-4]^s[n-5]^s[n-6]^s[n-8]).
_LFSR_TAPS = (4, 5, 6, 8)


def _gen_whitening_sequence() -> np.ndarray:
    nbits = WHITENING_SEQUENCE_LENGTH + 7
    s = np.ones(nbits, dtype=np.uint8)
    for n in range(8, nbits):
        b = 0
        for t in _LFSR_TAPS:
            b ^= s[n - t]
        s[n] = b
    # Byte i is the window s[i .. i+7], MSB-first.
    windows = np.lib.stride_tricks.sliding_window_view(s, 8)[:WHITENING_SEQUENCE_LENGTH]
    weights = (1 << np.arange(7, -1, -1)).astype(np.uint16)
    return (windows.astype(np.uint16) @ weights).astype(np.uint8)


WHITENING_SEQUENCE: np.ndarray = _gen_whitening_sequence()
WHITENING_SEQUENCE.setflags(write=False)

# Non-standard LoRa Hamming code bit layout: p4 p2 p1 p3 d1 d2 d4 d3
# (bit 7 .. bit 0).  Parity-generator masks over the data nibble used by the
# encoder (reference: encode_impl.cc:28-32) ...
HAMMING_ENC_P1 = 0x0D
HAMMING_ENC_P2 = 0x0B
HAMMING_ENC_P3 = 0x07
HAMMING_ENC_P4 = 0x0F
HAMMING_ENC_P5 = 0x0E

# ... and syndrome-check masks over the full codeword used by the decoder
# (reference: decode_impl.cc:36-43).
HAMMING_DEC_P1 = 0x2E
HAMMING_DEC_P2 = 0x4B
HAMMING_DEC_P3 = 0x17
HAMMING_DEC_D1 = 0x08
HAMMING_DEC_D2 = 0x04
HAMMING_DEC_D3 = 0x01
HAMMING_DEC_D4 = 0x02
