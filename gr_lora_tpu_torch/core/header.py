"""Explicit-header generation/parsing and the packet symbol-count formula."""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .crc import header_checksum


def calc_sym_num(payload_len: int, *, sf: int, cr: int, crc: bool, ldr: bool,
                 explicit_header: bool) -> int:
    """Total symbols per packet, the 8 reduced-rate header symbols included
    (reference: encode_impl.cc:107-112, demod_impl.cc:100)."""
    tmp = 2.0 * payload_len - sf + 7 + 4 * int(crc) - 5 * (1 - int(explicit_header))
    return 8 + max((4 + cr) * int(math.ceil(tmp / (sf - 2 * int(ldr)))), 0)


def gen_header_nibbles(payload_len: int, cr: int, crc: bool) -> np.ndarray:
    """The 5 explicit-header nibbles (reference: encode_impl.cc:95-105)."""
    cr_crc = ((cr << 1) | int(crc)) & 0xFF
    cks = header_checksum(payload_len, cr_crc)
    return np.array(
        [payload_len >> 4, payload_len & 0xF, cr_crc, cks >> 4, cks & 0xF],
        dtype=np.uint8,
    )


@dataclasses.dataclass(frozen=True)
class HeaderInfo:
    """Result of parsing an explicit header (reference: decode_impl.cc:332-355)."""

    is_valid: bool
    payload_len: int
    cr: int
    crc: bool


def parse_header_nibbles(nibbles: np.ndarray) -> HeaderInfo:
    nib = np.asarray(nibbles, dtype=np.uint8)
    payload_len = (int(nib[0]) << 4) | int(nib[1])
    crc = bool(nib[2] & 1)
    cr = int(nib[2]) >> 1
    checksum = (int(nib[3]) << 4) | int(nib[4])
    is_valid = checksum == header_checksum(payload_len, int(nib[2]) & 0xF)
    return HeaderInfo(is_valid=is_valid, payload_len=payload_len, cr=cr, crc=crc)
