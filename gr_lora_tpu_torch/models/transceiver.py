"""End-to-end pipelines: the txrx_sim loopback.

Port of gr_lora_tpu/models/transceiver.py: the reference's GRC flowgraph
wiring (examples/txrx_sim.grc: socket_pdu -> encode -> mod -> throttle ->
demod -> decode) as plain function composition, the demodulator on
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import LoraConfig
from ..core.codec import DecodeResult, decode, encode
from ..device import DEFAULT as DEFAULT_DEVICE
from .demodulator import demodulate
from .modulator import modulate


@dataclasses.dataclass
class LoopbackResult:
    symbols_tx: np.ndarray
    iq: np.ndarray
    packets: list[np.ndarray]
    decoded: list[DecodeResult]

    @property
    def payloads(self) -> list[bytes]:
        return [bytes(d.payload) for d in self.decoded if d.ok]


def loopback(payload: bytes, cfg: LoraConfig, *, snr_db: float | None = None,
             seed: int = 0, max_packets: int = 8,
             device: str | torch.device = DEFAULT_DEVICE) -> LoopbackResult:
    """encode -> modulate -> (optional AWGN) -> demodulate -> decode."""
    syms = encode(payload, cfg)
    iq = modulate(syms, cfg)
    if snr_db is not None:
        rng = np.random.default_rng(seed)
        # Signal power is 1.0 over the chirps; noise power relative to that.
        npow = 10.0 ** (-snr_db / 10.0)
        noise = (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq)))
        iq = (iq + np.sqrt(npow / 2) * noise).astype(np.complex64)
    packets = demodulate(iq, cfg, max_packets=max_packets, device=device)
    decoded = [decode(p, cfg) for p in packets]
    return LoopbackResult(syms, iq, packets, decoded)
