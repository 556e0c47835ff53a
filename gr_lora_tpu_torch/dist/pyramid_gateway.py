"""Gateway packet record and the 8-byte peak packing.

Twin of the parts of gr_lora_tpu/dist/pyramid_gateway.py that the
detection-gated gateway uses: ``GatewayPacket``, ``_pack_peaks`` and
``_unpack_peaks``.  The packed words are bit-identical to the JAX
package's uint32 pair (held as int32 here: torch has no full uint32).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gr_lora_tpu.core.codec import DecodeResult


class GatewayPacket(NamedTuple):
    channel: int
    symbols: np.ndarray
    result: DecodeResult
    #: The tracker's preamble reference timestamp: sample index (mod 2^28)
    #: of the walked-back apex of the last trackable preamble chirp, i.e.
    #: ~7 symbols after the packet's first sample.
    position: int = -1
    #: Spreading factor the packet decoded at.
    sf: int = -1


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its bf16 bit pattern in [0, 2^16) as int64."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _pack_peaks(outs):
    """(bins, h, hs, valid) -> int32[..., M, 2]: 8 B/peak instead of 13
    for the device->host fetch (bins+valid packed in word 0; bf16 heights
    in word 1 — bf16 keeps float32's range, and its ~0.4 % resolution is
    far inside the tracker's ratio gates, so the tracker sees the same
    rounded heights as with the JAX package).  Bins must be < 2^16."""
    bins, h, hs, valid = outs
    w0 = bins.to(torch.int64) | (valid.to(torch.int64) << 16)
    w1 = _bf16_bits(h) | (_bf16_bits(hs) << 16)
    w1 = torch.where(w1 >= 1 << 31, w1 - (1 << 32), w1)
    return torch.stack([w0, w1], dim=-1).to(torch.int32)


def _bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _unpack_peaks(w: np.ndarray):
    w = np.asarray(w).view(np.uint32)
    bins = (w[..., 0] & 0xFFFF).astype(np.int32)
    valid = (w[..., 0] >> 16).astype(bool)
    h = _bf16_to_f32((w[..., 1] & 0xFFFF).astype(np.uint16))
    hs = _bf16_to_f32((w[..., 1] >> 16).astype(np.uint16))
    return bins, h, hs, valid
