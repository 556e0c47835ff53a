"""Payload whitening (reference: encode_impl.cc:138-144, decode_impl.cc:135-144)."""

from __future__ import annotations

import numpy as np

from .constants import WHITENING_SEQUENCE, WHITENING_SEQUENCE_LENGTH


def whiten_tx(data: np.ndarray, payload_len: int) -> np.ndarray:
    """XOR the first ``payload_len`` bytes with the whitening sequence.
    CRC bytes and padding beyond payload_len are NOT whitened
    (reference: encode_impl.cc:306 passes pkt_len, not the padded size)."""
    out = np.asarray(data, dtype=np.uint8).copy()
    n = min(payload_len, WHITENING_SEQUENCE_LENGTH, len(out))
    out[:n] ^= WHITENING_SEQUENCE[:n]
    return out


def whiten_rx(data: np.ndarray, explicit_header: bool, crc: bool) -> np.ndarray:
    """Dewhiten decoded bytes in place-semantics: skip the 3 header bytes when
    in explicit-header mode and the trailing 2 CRC bytes
    (reference: decode_impl.cc:135-144)."""
    out = np.asarray(data, dtype=np.uint8).copy()
    offset = 3 if explicit_header else 0
    crc_offset = 2 if crc else 0
    n = min(len(out) - crc_offset - offset, WHITENING_SEQUENCE_LENGTH)
    if n > 0:
        out[offset:offset + n] ^= WHITENING_SEQUENCE[:n]
    return out
