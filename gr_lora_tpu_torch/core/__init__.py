"""The bit-level LoRa codec (NumPy): the port's own copy of
gr_lora_tpu/core, module for module, with the same names.
tests/test_torch_core.py holds it equal to the original."""

from .codec import DecodeResult, decode, decode_header, encode
from .constants import WHITENING_SEQUENCE
from .crc import data_checksum, header_checksum
from .gray import from_gray, gray_to_tx_bins, rx_bins_to_gray, to_gray
from .hamming import hamming_decode, hamming_encode
from .header import HeaderInfo, calc_sym_num, gen_header_nibbles, parse_header_nibbles
from .interleave import deinterleave, interleave
from .whitening import whiten_rx, whiten_tx

__all__ = [
    "DecodeResult", "decode", "decode_header", "encode",
    "WHITENING_SEQUENCE", "data_checksum", "header_checksum",
    "from_gray", "gray_to_tx_bins", "rx_bins_to_gray", "to_gray",
    "hamming_decode", "hamming_encode",
    "HeaderInfo", "calc_sym_num", "gen_header_nibbles", "parse_header_nibbles",
    "deinterleave", "interleave", "whiten_rx", "whiten_tx",
]
