"""Full bit-level packet codec: payload bytes <-> chirp-bin symbols.

Pure functions composing whitening, Hamming FEC, diagonal interleaving and
Gray mapping.  The TX side mirrors encode_impl::encode
(reference: encode_impl.cc:277-359); the RX side mirrors decode_impl::decode
(reference: decode_impl.cc:274-430) with the header round-trip folded into a
plain function call instead of a message-port loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import LoraConfig
from .crc import data_checksum
from .gray import gray_to_tx_bins, rx_bins_to_gray
from .hamming import hamming_decode, hamming_encode
from .header import HeaderInfo, calc_sym_num, gen_header_nibbles, parse_header_nibbles
from .interleave import deinterleave, interleave
from .whitening import whiten_rx, whiten_tx


def encode(payload: bytes | np.ndarray, cfg: LoraConfig) -> np.ndarray:
    """Payload bytes -> uint16 chirp-bin symbols (reference: encode_impl.cc:277-359)."""
    data = np.frombuffer(bytes(payload), dtype=np.uint8).copy() \
        if isinstance(payload, (bytes, bytearray)) else np.asarray(payload, dtype=np.uint8).copy()
    pkt_len = len(data)

    if cfg.crc:
        checksum = data_checksum(data, pkt_len)
        data = np.concatenate([data, np.array([checksum & 0xFF, checksum >> 8], dtype=np.uint8)])

    sym_num = calc_sym_num(pkt_len, sf=cfg.sf, cr=cfg.cr, crc=cfg.crc, ldr=cfg.ldr,
                           explicit_header=cfg.explicit_header)
    nibble_num = cfg.sf - 2 + (sym_num - 8) // (cfg.cr + 4) * (cfg.sf - 2 * int(cfg.ldr))

    # Zero-pad so every payload nibble indexes a real byte.  The reference pads
    # (nibble_num - 2*size)/2 bytes (encode_impl.cc:298-304), which can leave
    # the final odd nibble reading one byte past the vector; we pad that byte
    # with zero instead — it only ever lands in interleaver blocks the symbol
    # count discards.
    need_bytes = (nibble_num + 1) // 2
    if need_bytes > len(data):
        data = np.concatenate([data, np.zeros(need_bytes - len(data), dtype=np.uint8)])

    data = whiten_tx(data, pkt_len)

    # Byte -> nibble split, low nibble first (reference: encode_impl.cc:309-319).
    idx = np.arange(nibble_num)
    payload_nibbles = np.where(idx % 2 == 0, data[idx // 2] & 0xF, data[idx // 2] >> 4).astype(np.uint8)

    if cfg.explicit_header:
        nibbles = np.concatenate([gen_header_nibbles(pkt_len, cfg.cr, cfg.crc), payload_nibbles])
    else:
        nibbles = payload_nibbles

    codewords = hamming_encode(nibbles, cfg.sf, cfg.cr)
    symbols = interleave(codewords, cfg.sf, cfg.cr, cfg.ldr)
    return gray_to_tx_bins(symbols, cfg.sf, cfg.ldr)


@dataclasses.dataclass(frozen=True)
class DecodeResult:
    """Decoded packet.  ``payload`` carries header bytes (explicit mode), the
    payload, the received CRC bytes and the appended CRC pass/fail byte —
    exactly the PDU the reference prints (decode_impl.cc:406-413)."""

    payload: np.ndarray
    header: HeaderInfo | None
    crc_ok: bool | None
    ok: bool
    reason: str = ""


def decode_header(symbols: np.ndarray, cfg: LoraConfig) -> HeaderInfo:
    """Parse the explicit header from the first 8 symbols
    (reference: decode_impl.cc:329-355)."""
    gray = rx_bins_to_gray(np.asarray(symbols[:8], dtype=np.uint16), cfg.sf, cfg.ldr)
    cw = deinterleave(gray, cfg.sf - 2, 4)
    nibbles = hamming_decode(cw, cfg.sf, 4)
    return parse_header_nibbles(nibbles[:5])


def decode(symbols: np.ndarray, cfg: LoraConfig) -> DecodeResult:
    """uint16 chirp-bin symbols -> DecodeResult (reference: decode_impl.cc:274-430)."""
    syms = np.asarray(symbols, dtype=np.uint16)
    if len(syms) < 8:
        # Not even a full header block (reference silently drops these,
        # decode_impl.cc:358).
        return DecodeResult(np.zeros(0, np.uint8), None, None, False,
                            "short packet")
    gray = rx_bins_to_gray(syms, cfg.sf, cfg.ldr)

    header_cw = deinterleave(gray[:8], cfg.sf - 2, 4)

    payload_len, cr, crc = cfg.payload_len, cfg.cr, cfg.crc
    header: HeaderInfo | None = None
    if cfg.explicit_header:
        header_nibbles = hamming_decode(header_cw.copy(), cfg.sf, 4)
        header = parse_header_nibbles(header_nibbles[:5])
        if not header.is_valid:
            return DecodeResult(np.zeros(0, np.uint8), header, None, False, "invalid header")
        payload_len, cr, crc = header.payload_len, header.cr, header.crc

    ppm = (cfg.sf - 2) if cfg.ldr else cfg.sf
    payload_cw = deinterleave(gray[8:], ppm, cr)
    codewords = np.concatenate([header_cw, payload_cw])

    # Explicit header occupies 2.5 bytes: pad a zero nibble at index 5
    # (reference: decode_impl.cc:371).
    if cfg.explicit_header:
        codewords = np.insert(codewords, 5, 0)

    nibbles = hamming_decode(codewords, cfg.sf, cr)
    min_len = payload_len * 2 + int(cfg.explicit_header) * 6 + int(crc) * 4
    if len(nibbles) < min_len:
        return DecodeResult(np.zeros(0, np.uint8), header, None, False, "short packet")

    nib = nibbles[:min_len].astype(np.uint16)
    lo, hi = nib[0::2], nib[1::2]
    # Header bytes pack big-endian-nibble-first, payload little
    # (reference: decode_impl.cc:380-390).
    byte_idx = np.arange(len(lo))
    hdr_mask = cfg.explicit_header & (byte_idx < 3)
    combined = np.where(hdr_mask, (lo << 4) | hi, (hi << 4) | lo).astype(np.uint8)

    combined = whiten_rx(combined, cfg.explicit_header, crc)

    crc_ok: bool | None = None
    if crc:
        offset = 3 if cfg.explicit_header else 0
        rx_crc = int(combined[payload_len + offset]) | (int(combined[payload_len + offset + 1]) << 8)
        crc_ok = rx_crc == data_checksum(combined[offset:], payload_len)
        combined = np.concatenate([combined, np.array([int(crc_ok)], dtype=np.uint8)])

    return DecodeResult(combined, header, crc_ok, True)
