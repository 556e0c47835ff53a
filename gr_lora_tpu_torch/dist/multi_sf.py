"""Multi-SF reception: demodulate every spreading factor on every channel.

Port of gr_lora_tpu/dist/multi_sf.py.  LoRa SFs are quasi-orthogonal, so
one IQ stream is fed to one demodulator per SF and each finds only its own
packets.  The SF axis is a Python loop (shapes differ per SF); the channel
axis is the lane axis of one batched demod per SF, on ``device`` (the card
unless the caller asks for the CPU), over one device copy of the feed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import LoraConfig
from ..core.codec import DecodeResult, decode
from ..device import DEFAULT as DEFAULT_DEVICE
from ..device import resolve as resolve_device
from ..models.demodulator import demod_fn
from .triggered import device_feed


@dataclass
class SfPacket:
    channel: int
    sf: int
    position: int
    symbols: np.ndarray
    result: DecodeResult
    #: Peak/mean detection ratio (models.demodulator.snr_db_estimate).
    snr_ratio: float = 0.0


class MultiSFReceiver:
    """Demodulate [channels, T] IQ at several spreading factors at once."""

    def __init__(self, base: LoraConfig, sfs=(7, 8, 9, 10, 11, 12),
                 num_samples: int | None = None, max_packets: int = 4,
                 bw: float = 125e3,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.cfgs = {}
        for sf in sfs:
            ldr = (1 << sf) / bw > 16e-3   # SX127x LDR rule (rx_file.grc)
            self.cfgs[sf] = base.replace(sf=sf, ldr=ldr)
        self.max_packets = max_packets
        self._num_samples = num_samples
        #: Packets lost to slot overflow (raise max_packets if nonzero).
        self.dropped = 0

    def __call__(self, iq) -> list[SfPacket]:
        """Packets of iq: complex or [C, T, 2] / [T, 2] float IQ, on the
        host or already on the device."""
        diq = device_feed(iq, self.device)
        total = diq.shape[1]
        out: list[SfPacket] = []
        for sf, cfg in self.cfgs.items():
            fn = demod_fn(cfg, total, self.max_packets, self.device)
            syms, lens, pos, cnt, dropped, snr = (x.cpu().numpy()
                                                  for x in fn(diq))
            self.dropped += int(np.sum(dropped))
            for c in range(diq.shape[0]):
                for r in range(int(cnt[c])):
                    s = syms[c, r, :lens[c, r]].astype(np.uint16)
                    res = decode(s, cfg)
                    if res.ok:
                        out.append(SfPacket(c, sf, int(pos[c, r]), s, res,
                                            float(snr[c, r])))
        out.sort(key=lambda p: (p.channel, p.position))
        return out
