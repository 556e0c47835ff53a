"""Decoder model: thin wrapper over the pure codec (core/codec.py).

Port of gr_lora_tpu/models/decoder.py, kept as a class for API parity
with the reference's decode block (decode.h:52-57); all logic lives in the
port's NumPy codec, ``core``.
"""

from __future__ import annotations

import numpy as np

from ..config import LoraConfig
from ..core.codec import DecodeResult, decode, decode_header


class Decoder:
    def __init__(self, cfg: LoraConfig):
        self.cfg = cfg

    def __call__(self, symbols: np.ndarray) -> DecodeResult:
        return decode(symbols, self.cfg)

    def parse_header(self, symbols: np.ndarray):
        return decode_header(symbols, self.cfg)
