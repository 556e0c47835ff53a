"""Checksums used by the LoRa bit-level codec.

Vectorized (table-driven / bit-parallel) re-implementations of the reference's
per-bit loops (reference: lib/utilities.h:74-120).  Both operate on NumPy
arrays so the gateway path can checksum many packets at once.
"""

from __future__ import annotations

import numpy as np

_CRC16_POLY = 0x1021


def _build_crc_table() -> np.ndarray:
    tbl = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ _CRC16_POLY) if (crc & 0x8000) else (crc << 1)
            crc &= 0xFFFF
        tbl[byte] = crc
    return tbl


_CRC16_TABLE = _build_crc_table()
_CRC16_TABLE.setflags(write=False)


def data_checksum(data, length: int | None = None) -> int:
    """LoRa payload CRC16 (CCITT polynomial, zero init) with the quirk that
    the final two data bytes are XORed into the CRC instead of being fed
    through it (reference: utilities.h:74-94).
    """
    data = np.asarray(data, dtype=np.uint8)
    if length is None:
        length = len(data)
    crc = 0
    for j in range(max(length - 2, 0)):
        crc = ((crc << 8) & 0xFFFF) ^ int(_CRC16_TABLE[(crc >> 8) ^ int(data[j])])
    x1 = int(data[length - 1]) if length >= 1 else 0
    x2 = (int(data[length - 2]) << 8) if length >= 2 else 0
    return (crc ^ x1 ^ x2) & 0xFFFF


def header_checksum(payload_len: int, cr_crc: int) -> int:
    """5-bit checksum over the explicit header fields
    (reference: utilities.h:96-120)."""
    a = [(payload_len >> (4 + k)) & 1 for k in range(4)]   # a0..a3
    b = [(payload_len >> k) & 1 for k in range(4)]         # b0..b3
    c = [(cr_crc >> k) & 1 for k in range(4)]              # c0..c3

    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res |= (a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3
    res |= (a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2
    res |= (a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1
    res |= a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3]
    return res
