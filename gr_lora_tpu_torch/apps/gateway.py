"""The product gateway: one wideband stream -> decoded LoRa PDUs.

Port of gr_lora_tpu/apps/gateway.py.

    # whole-capture replay, FSM path (triggered multi-SF):
    python -m gr_lora_tpu_torch.apps.gateway wideband.cf64 --samp-rate 1e6 \
        --channels 8 --sfs 7,8,9

    # same capture with Pyramid COLLISION decoding on every channel x SF
    # (detection-gated; overlapping packets both decode):
    python -m gr_lora_tpu_torch.apps.gateway wideband.cf64 --collision ...

    # live: UDP datagrams of wideband complex64 IQ (SDR-agnostic ingress),
    # PDUs forwarded over UDP, stats on exit:
    python -m gr_lora_tpu_torch.apps.gateway --live udp:5005 --collision \
        --udp 127.0.0.1:40868 ...

The full advertised chain in one command: ring/UDP or file ingest ->
polyphase channelizer (streaming, phase-continuous) -> triggered multi-SF
FSM receiver or detection-gated Pyramid collision gateway -> RSSI skirt
dedupe -> PduSink (console / UDP / callback).  This is the composed
product graph the reference ships as rx_usrp_collision.grc /
rx_file_collision.grc (reference examples/rx_usrp_collision.grc:1), at
the BASELINE north-star scale (N x 125 kHz channels x SF7-12) the
reference's README.md:45 lists as future work.

On the card each wideband block crosses the host link once (pinned), and
the channelized [C, M, 2] block stays there: the engines take it as a
device tensor, the power track reduces it to per-bucket means on the
device (only those [C, buckets] means reach the host, once a block) and
the FSM engine's carried buffer is concatenated on the device.
:func:`decode_stream` is the chain after ingest, shared by :func:`main`
and any caller that builds its own engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from ..device import resolve as resolve_device
from ..ops.cplx import cmag2
from .common import add_config_args, config_from_args, read_capture


class _PowerTrack:
    """Rolling per-channel power track at bucket granularity — RSSI for
    skirt dedupe without retaining the sample stream (a strong packet
    also decodes, attenuated, on adjacent channels; production gateways
    keep the strongest copy).  Bucket means are taken on the block's
    device; the host keeps only the [C, buckets] means."""

    def __init__(self, channels: int, bucket: int = 64,
                 keep_buckets: int = 1 << 16):
        self.bucket = bucket
        self.keep = keep_buckets
        self._pw = np.zeros((channels, 0), np.float32)
        self._base = 0                     # bucket index of _pw[:, 0]
        self._residue: torch.Tensor | None = None

    def push(self, block: torch.Tensor) -> None:
        """block: [C, M, 2] float32 on any device."""
        p = cmag2(block)
        if self._residue is not None:
            p = torch.cat([self._residue, p], dim=1)
        nb = p.shape[1] // self.bucket
        self._residue = p[:, nb * self.bucket:]
        if nb:
            means = p[:, :nb * self.bucket].reshape(
                p.shape[0], nb, self.bucket).mean(dim=2)
            self._pw = np.concatenate([self._pw, means.cpu().numpy()],
                                      axis=1)
        if self._pw.shape[1] > self.keep:
            cut = self._pw.shape[1] - self.keep
            self._pw = self._pw[:, cut:]
            self._base += cut

    def mean(self, ch: int, lo: int, hi: int) -> float:
        b0 = max(lo // self.bucket - self._base, 0)
        b1 = max(-(-hi // self.bucket) - self._base, b0 + 1)
        seg = self._pw[ch, b0:b1]
        return float(seg.mean()) if seg.size else 0.0


class _FsmEngine:
    """Streaming wrapper over TriggeredReceiver: carries a scan-window
    overlap across block seams (on the receiver's device) and absolute
    positions."""

    def __init__(self, base, sfs, spacing, channels, device):
        from ..dist.triggered import TriggeredReceiver, scan_window

        self.rx = TriggeredReceiver(base, sfs=sfs, bw=spacing, device=device)
        self.overlap = max(scan_window(c) for c in self.rx.cfgs.values())
        self.channels = channels
        self._buf = torch.zeros((channels, 0, 2), dtype=torch.float32,
                                device=self.rx.device)
        self._abs = 0

    def _run(self, final: bool):
        t = self._buf.shape[1]
        # Packets triggering inside the trailing overlap may be truncated;
        # leave them for the next block (they re-trigger with full data).
        cut = t if final else t - self.overlap
        if cut <= 0:
            return []
        out = []
        for p in self.rx(self._buf):
            if p.position < cut or final:
                out.append(dataclasses.replace(
                    p, position=p.position + self._abs))
        if not final:
            self._buf = self._buf[:, cut:]
            self._abs += cut
        return out

    def feed(self, block):
        self._buf = torch.cat([self._buf, block.to(self._buf.device)],
                              dim=1)
        if self._buf.shape[1] < 2 * self.overlap:
            return []
        return self._run(final=False)

    def flush(self):
        return self._run(final=True)

    def stats(self):
        return {"dropped_events": self.rx.dropped_events,
                "dropped_packets": self.rx.dropped_packets}


def _parse_hostport(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def decode_stream(blocks, chan, engine, sink, sfs, p: int) -> None:
    """The chain after ingest: every wideband block of ``blocks`` through
    ``chan`` (a StreamingChannelizer), ``engine`` (feed / flush returning
    packets with channel, sf, position and a DecodeResult) and the RSSI
    skirt dedupe into ``sink``; then the flush.  On KeyboardInterrupt the
    engine is flushed and what it holds is emitted."""
    from ..dist.pdu_sink import PduEvent

    power = _PowerTrack(chan.num_channels)
    sf_n = {sf: (1 << sf) * p for sf in sfs}
    hold = 3 * max(sf_n.values()) * 16          # dedupe window (samples)
    pending: list = []                          # normalized packets

    def norm(q):
        """TriggeredPacket / GatewayPacket -> (ch, sf, pos, payload,
        crc_ok)."""
        r = q.result
        crc = None if r is None else (r.crc_ok if r.ok else False)
        payload = b"" if r is None else bytes(r.payload)
        return (q.channel, q.sf, int(q.position), payload, crc)

    def emit_ready(head: int, final: bool = False) -> None:
        nonlocal pending
        ready = [q for q in pending if final or q[2] + hold < head]
        if not ready:
            return
        pending = [q for q in pending if not (final or q[2] + hold < head)]
        # Same (sf, payload) closer than 4 symbols = skirt / re-detection
        # copies: keep the strongest channel (reference gateways behave
        # the same; see tests/test_wideband_e2e.py).
        ready.sort(key=lambda q: (q[1], q[3], q[2]))
        groups: list[list] = []
        for q in ready:
            g = groups[-1] if groups else None
            if (g and g[0][1] == q[1] and g[0][3] == q[3]
                    and q[2] - g[-1][2] < 4 * sf_n.get(q[1], 1 << 10)):
                g.append(q)
            else:
                groups.append([q])
        for g in groups:
            best = max(g, key=lambda q: power.mean(
                q[0], q[2], q[2] + 8 * sf_n.get(q[1], 1 << 10)))
            sink.emit(PduEvent(*best))

    try:
        for wb in blocks:
            blk = chan.feed(wb)
            if blk.shape[1] == 0:
                continue
            power.push(blk)
            pending += [norm(q) for q in engine.feed(blk)]
            emit_ready(chan.out_pos)
        blk = chan.flush()
        if blk.shape[1]:
            power.push(blk)
            pending += [norm(q) for q in engine.feed(blk)]
        pending += [norm(q) for q in engine.flush()]
        emit_ready(chan.out_pos, final=True)
    except KeyboardInterrupt:
        pending += [norm(q) for q in engine.flush()]
        emit_ready(chan.out_pos, final=True)


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("capture", nargs="?",
                    help="raw complex64 wideband IQ file ('-' = stdin)")
    ap.add_argument("--live", metavar="udp:PORT",
                    help="live wideband IQ over UDP datagrams instead of "
                         "a capture file (ring-buffered ingest)")
    ap.add_argument("--samp-rate", type=float, default=1e6)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--spacing", type=float, default=125e3)
    ap.add_argument("--sfs", type=str, default="7,8,9,10,11,12")
    ap.add_argument("--collision", action="store_true",
                    help="Pyramid collision decoding on every channel x SF "
                         "(detection-gated) instead of the demod FSM")
    ap.add_argument("--udp", metavar="HOST:PORT",
                    help="forward PDUs as UDP datagrams (wire: 1B ch, "
                         "1B sf, 4B LE position, payload)")
    ap.add_argument("--all", action="store_true",
                    help="emit CRC-failed PDUs too")
    ap.add_argument("--quiet", action="store_true",
                    help="no per-PDU console lines (UDP/stats only)")
    ap.add_argument("--block", type=int, default=1 << 21,
                    help="wideband samples per processing block")
    ap.add_argument("--max-payload-len", type=int, default=32,
                    help="collision mode: payload bound sizing the "
                         "dispatch window")
    ap.add_argument("--sic", action="store_true",
                    help="collision mode: successive interference "
                         "cancellation on dispatched windows (recovers "
                         "masked-preamble packets; host-side cost per "
                         "decoded window)")
    ap.add_argument("--split-repeats", action="store_true",
                    help="collision mode: split merged peak tracks "
                         "(adjacent-equal / adjacent-value symbol runs "
                         "truncate packets under reference-exact rules; "
                         "see docs/PARITY.md)")
    ap.add_argument("--tracker", choices=["host", "device"],
                    default="host",
                    help="collision mode: host C++ tracker bank vs the "
                         "on-device tracker (only finished packets come "
                         "to the host)")
    add_config_args(ap)
    args = ap.parse_args(argv)
    base = config_from_args(args)
    sfs = tuple(int(s) for s in args.sfs.split(","))
    if (args.capture is None) == (args.live is None):
        ap.error("exactly one of CAPTURE or --live required")
    dev = resolve_device(device)

    from ..dist.pdu_sink import PduSink
    from ..pipeline.channelizer import StreamingChannelizer

    # --- engine -----------------------------------------------------------
    if args.collision:
        from ..dist.collision_gateway import TriggeredPyramidGateway

        pyr_base = base if base.fft_factor >= 8 else \
            base.replace(fft_factor=8)
        engine = TriggeredPyramidGateway(
            pyr_base, args.channels, sfs=sfs,
            max_payload_len=args.max_payload_len, bw=args.spacing,
            sic=args.sic, split_repeats=args.split_repeats,
            tracker=args.tracker, device=dev)
    else:
        engine = _FsmEngine(base, sfs, args.spacing, args.channels, dev)

    sink = PduSink(udp=_parse_hostport(args.udp) if args.udp else None,
                   console=not args.quiet, crc_filter=not args.all)
    chan = StreamingChannelizer(args.channels, args.samp_rate,
                                args.spacing, p=base.p, device=dev)

    # --- ingest -----------------------------------------------------------
    def wideband_blocks():
        if args.live:
            from ..pipeline.ingest import RingIngest
            from .rx_stream import UdpIqSource

            src = UdpIqSource(int(args.live.split(":", 1)[1]))
            try:
                yield from RingIngest(src, args.block).blocks()
            finally:
                src.close()
        elif args.capture == "-":
            while True:
                raw = sys.stdin.buffer.read(args.block * 8)
                if not raw:
                    break
                n = len(raw) - len(raw) % 8
                yield np.frombuffer(raw[:n], np.float32).reshape(-1, 2)
        else:
            ri = read_capture(args.capture).view(np.float32).reshape(-1, 2)
            for lo in range(0, len(ri), args.block):
                yield ri[lo:lo + args.block]

    try:
        decode_stream(wideband_blocks(), chan, engine, sink, sfs, base.p)
    finally:
        stats = {**engine.stats(), **sink.stats()}
        print("stats: " + " ".join(f"{k}={v}" for k, v in stats.items()),
              file=sys.stderr)
        sink.close()
    return 0 if sink.emitted else 1


if __name__ == "__main__":
    raise SystemExit(main())
