"""End-to-end wideband gateway chain on the port, twins of
tests/test_wideband_e2e.py: one fixture through the full product path —
as a hand-assembled chain (channelizer -> triggered receiver + pyramid
gateway -> PduSink -> UDP) and as one ``apps.gateway --collision`` CLI
command — with every injected payload exactly once on its channel, SF
and position; and the port's CLI held to the JAX package's CLI on the
same capture: equal (channel, sf, payload) datagram sets, positions
within one hop (tests/test_torch_collision_gateway.py's convention),
on that fixture and on one of random payloads drawn under the wideband
north star's fixture rules, where neither package decodes every packet."""

import socket

import numpy as np
import pytest

from gr_lora_tpu_torch import LoraConfig
from gr_lora_tpu_torch.apps.common import UdpPduPort
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.dist.pdu_sink import PduEvent, PduSink
from gr_lora_tpu_torch.dist.pyramid_gateway import PyramidGateway
from gr_lora_tpu_torch.dist.triggered import TriggeredReceiver
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.pipeline.channelizer import (channel_frequencies,
                                                    channelize)

FS = 500e3
SPACING = 125e3
CHANNELS = 4
P = 2

PYR_CFG = LoraConfig(sf=8, cr=1, crc=True, ldr=False, explicit_header=True,
                     payload_len=8, p=P, fft_factor=8, threshold=5.0)
TRIG_BASE = LoraConfig(sf=7, cr=1, crc=True, ldr=False, explicit_header=True,
                       payload_len=8, p=P, fft_factor=4)

# channel: (sf, payload bytes, baseband offset in samples) — the JAX
# test's singles (no adjacent-equal symbols; the SF7 single after the
# adjacent-channel collision pair, see tests/test_wideband_e2e.py).
PAYLOADS = {
    0: (7, bytes([0x10, 0x20, 0x30, 0x40]), 26000),
    2: (9, bytes([0xDE, 0xAD, 0xBE, 0xEF]), 5000),
}
COLL_CH = 1
COLL_P1 = bytes([1, 2, 3, 4, 5, 6])
COLL_P2 = bytes([7] * 5)
PDU_1 = "0630f0010203040506050801"
PDU_2 = "053000" + "07" * 5 + "e76b01"
N8 = PYR_CFG.num_samples
OFF2 = 1000 + 16 * N8 + 4 * N8 // 8 + 204
CLI_ARGS = ["--collision", "--quiet", "--samp-rate", str(FS),
            "--channels", str(CHANNELS), "--spacing", str(SPACING),
            "--sfs", "7,8,9", "--payload-len", "8", "--fft-factor", "8",
            "--max-payload-len", "16"]


def _wideband_fixture(seed=0):
    """Per-channel packets synthesized directly AT the wideband rate
    (modulate supports any p — no upsampling images), mixed to their
    channel slots and summed."""
    total_bb = 1000 + 76 * N8
    up = int(FS / (P * SPACING))          # wideband p = P * up
    total = total_bb * up
    pw = P * up
    rng = np.random.default_rng(seed)
    freqs = channel_frequencies(CHANNELS, SPACING)
    t = np.arange(total) / FS
    wide = np.zeros(total, np.complex64)

    def place(ch, iq_w, off_bb):
        off = off_bb * up
        wide[off:off + len(iq_w)] += (
            iq_w * np.exp(2j * np.pi * freqs[ch] * t[off:off + len(iq_w)])
        ).astype(np.complex64)

    for ch, (sf, payload, off) in PAYLOADS.items():
        cfg = TRIG_BASE.replace(sf=sf, ldr=(1 << sf) / SPACING > 16e-3)
        place(ch, 0.4 * modulate(encode(payload, cfg), cfg, p=pw,
                                 pad_front=0, pad_back=0), off)
    place(COLL_CH, 0.4 * modulate(encode(COLL_P1, PYR_CFG), PYR_CFG, p=pw,
                                  pad_front=0, pad_back=0), 1000)
    place(COLL_CH, 0.18 * modulate(encode(COLL_P2, PYR_CFG), PYR_CFG, p=pw,
                                   pad_front=0, pad_back=0), OFF2)
    wide += 0.01 * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total)
                    ).astype(np.complex64)
    return wide


def _drawn_fixture(seed=0):
    """chip_smoke.py phase 10's capture at this file's size: on every
    channel an SF8 pair at the pair's amplitudes and offset, and a single
    at SF 7 or 9, payloads of 4-8 bytes drawn from default_rng(seed),
    each distinct and encoding with no two equal adjacent symbols.  A
    channel's pair and single take alternate slots, as do adjacent
    channels' pairs, so no two packets of one SF on adjacent channels
    (0 and the last too) overlap, nor a single its own pair.  Returns
    (capture, {(channel, sf, pdu hex)})."""
    from gr_lora_tpu_torch.core.codec import decode

    rng = np.random.default_rng(seed)
    up = int(FS / (P * SPACING))
    freqs = channel_frequencies(CHANNELS, SPACING)
    cfgs = {sf: TRIG_BASE.replace(sf=sf, ldr=False) for sf in (7, 9)}
    cfgs[8] = PYR_CFG
    used = set()

    def draw(cfg):
        while True:
            pl = bytes(rng.integers(0, 256, int(rng.integers(4, 9)),
                                    dtype=np.uint8))
            syms = encode(pl, cfg)
            if pl not in used and not np.any(syms[1:] == syms[:-1]):
                used.add(pl)
                return pl, syms

    def longest(cfg):                    # an 8-byte packet
        return len(modulate(encode(bytes(8), cfg), cfg, p=P, pad_front=0,
                            pad_back=0))

    slot = max(OFF2 - 1000 + longest(PYR_CFG), longest(cfgs[9])) + 4 * N8
    total = (1000 + 2 * slot) * up
    t = np.arange(total) / FS
    wide = np.zeros(total, np.complex64)
    injected = set()
    for ch in range(CHANNELS):
        sf = (7, 9)[ch % 2]
        pair0 = 1000 + (ch % 2) * slot
        single0 = 1000 + (1 - ch % 2) * slot
        for cfg, amp, off in ((PYR_CFG, 0.4, pair0),
                              (PYR_CFG, 0.18, pair0 + OFF2 - 1000),
                              (cfgs[sf], 0.4, single0)):
            _, syms = draw(cfg)
            iq_w = amp * modulate(syms, cfg, p=P * up, pad_front=0,
                                  pad_back=0)
            lo = off * up
            wide[lo:lo + len(iq_w)] += (iq_w * np.exp(
                2j * np.pi * freqs[ch] * t[lo:lo + len(iq_w)])
            ).astype(np.complex64)
            injected.add((ch, cfg.sf, bytes(decode(syms, cfg).payload).hex()))
    wide += 0.01 * (rng.standard_normal(total)
                    + 1j * rng.standard_normal(total)
                    ).astype(np.complex64)
    return wide, injected


def _datagrams(rx_port: UdpPduPort) -> list:
    """Every datagram waiting on rx_port as (ch, sf, position, hex)."""
    got = []
    rx_port.sock.settimeout(0.5)
    try:
        while True:
            data, _ = rx_port.sock.recvfrom(65536)
            got.append((data[0], data[1],
                        int.from_bytes(data[2:6], "little", signed=False),
                        data[6:].hex()))
    except socket.timeout:
        pass
    finally:
        rx_port.close()
    return got


def _assert_every_packet_once(got):
    """tests/test_wideband_e2e.py's assertions on a datagram list."""
    def hits(pred):
        return [g for g in got if pred(g)]

    # Singles: exactly once, right channel/SF, position near injection
    # (PDU = 3 header bytes + payload + CRC + pass flag).
    for ch, (sf, payload, off) in PAYLOADS.items():
        n = (1 << sf) * P
        matches = hits(lambda g, ch=ch, sf=sf, payload=payload:
                       g[0] == ch and g[1] == sf
                       and g[3][6:].startswith(payload.hex()))
        assert len(matches) == 1, (ch, sf, matches, got)
        assert 0 <= matches[0][2] - off <= 10 * n, (matches[0][2], off)
    # Collision pair: both golden PDUs exactly once on the collision
    # channel; positions are the pyramid preamble reference timestamps.
    m1 = hits(lambda g: g[0] == COLL_CH and g[3] == PDU_1)
    m2 = hits(lambda g: g[0] == COLL_CH and g[3] == PDU_2)
    assert len(m1) == 1, (m1, got)
    assert len(m2) == 1, (m2, got)
    assert 0 <= m1[0][2] - 1000 <= 10 * N8, m1
    assert 0 <= m2[0][2] - OFF2 <= 10 * N8, m2
    # Nothing survives on the idle channel.
    assert not hits(lambda g: g[0] == 3), got


def test_wideband_chain_to_udp():
    wide = _wideband_fixture()
    chans = channelize(wide, CHANNELS, FS, SPACING, p=P, device="cpu")
    assert chans.shape[0] == CHANNELS

    rx_port = UdpPduPort(listen_port=0)
    sink = PduSink(udp=("127.0.0.1", rx_port.sock.getsockname()[1]),
                   crc_filter=True)
    # Triggered multi-SF receiver for the single packets (skip SF8: the
    # collision channel belongs to the pyramid path).
    trig = TriggeredReceiver(TRIG_BASE, sfs=(7, 9), bw=SPACING, device="cpu")
    for p in trig(chans):
        if p.result.crc_ok:
            sink.emit(PduEvent(p.channel, p.sf, p.position,
                               bytes(p.result.payload), p.result.crc_ok))
    # Pyramid collision gateway over all channels at SF8.
    gw = PyramidGateway(PYR_CFG, CHANNELS, block_hops=512, device="cpu")
    for pkt in gw.feed(chans.numpy()) + gw.flush():
        if pkt.result is not None and pkt.result.ok and pkt.result.crc_ok:
            sink.emit(PduEvent(pkt.channel, 8, pkt.position,
                               bytes(pkt.result.payload), pkt.result.crc_ok))
    sink.close()
    got = _datagrams(rx_port)

    # A strong packet's spectral skirt can decode on neighboring channels
    # too; dedupe by RSSI exactly like apps/gateway.py.
    ch_np = chans.numpy()

    def rssi(ch, sf, pos):
        seg = ch_np[ch, pos:pos + 8 * (1 << sf) * P]
        return float(np.mean(seg ** 2)) if seg.size else 0.0

    best = {}
    for ch, sf, pos, pdu in got:
        key = (sf, pdu)
        if key not in best or rssi(ch, sf, pos) > rssi(*best[key][:3]):
            best[key] = (ch, sf, pos, pdu)
    _assert_every_packet_once(list(best.values()))


def _cli_datagrams(main, cap, **kw) -> list:
    rx_port = UdpPduPort(listen_port=0)
    rc = main([str(cap), *CLI_ARGS,
               "--udp", f"127.0.0.1:{rx_port.sock.getsockname()[1]}"], **kw)
    got = _datagrams(rx_port)
    assert rc == 0
    return got


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    cap = tmp_path_factory.mktemp("wideband") / "wideband.cf64"
    _wideband_fixture().astype(np.complex64).tofile(cap)
    return cap


@pytest.fixture(scope="module")
def port_cli(capture):
    """The port's ``apps.gateway --collision`` datagrams on the capture."""
    from gr_lora_tpu_torch.apps import gateway

    return _cli_datagrams(gateway.main, capture, device="cpu")


def test_wideband_cli_collision_to_udp(port_cli):
    """The same fixture through the one product command: every packet
    exactly once over UDP."""
    _assert_every_packet_once(port_cli)


def _same_sets(got, ref):
    """Equal (channel, sf, payload) sets, each once, positions within one
    hop."""
    def keyed(dgrams):
        out = {}
        for ch, sf, pos, hx in dgrams:
            out.setdefault((ch, sf, hx), []).append(pos)
        return out

    ours, theirs = keyed(got), keyed(ref)
    assert set(ours) == set(theirs), (sorted(ours), sorted(theirs))
    for key, pos in ours.items():
        hop = (1 << key[1]) * P // 8
        assert len(pos) == len(theirs[key]) == 1, (key, pos, theirs[key])
        assert abs(pos[0] - theirs[key][0]) <= hop, (key, pos, theirs[key])


@pytest.fixture(scope="module")
def jax_cli(capture):
    """The JAX package's ``apps.gateway --collision`` datagrams."""
    from gr_lora_tpu.apps import gateway as jax_gateway

    return _cli_datagrams(jax_gateway.main, capture)


def test_wideband_cli_matches_jax_cli(port_cli, jax_cli):
    """The port's CLI against the JAX package's CLI on the same capture:
    equal (channel, sf, payload) sets, positions within one hop."""
    _same_sets(port_cli, jax_cli)


def test_gateway_cli_device_tracker_matches_jax_cli(capture, jax_cli,
                                                    monkeypatch):
    """``--tracker device``: every packet once, each SF's windows tracked
    by the device walk, and the JAX CLI's (channel, sf, payload) set (its
    host tracker bank; tests/test_torch_device_gateways.py holds the
    port's device mode to the JAX package's on the gated gateway)."""
    from gr_lora_tpu_torch.apps import gateway
    from gr_lora_tpu_torch.ops.device_tracker import TrackerWalk

    walked = set()
    process = TrackerWalk.process

    def counted(self, *args):
        walked.add(self.cfg.sf)
        return process(self, *args)

    monkeypatch.setattr(TrackerWalk, "process", counted)
    got = _cli_datagrams(lambda argv, **kw: gateway.main(
        argv + ["--tracker", "device"], **kw), capture, device="cpu")
    _assert_every_packet_once(got)
    assert {sf for _, sf, _, _ in got} <= walked, walked
    _same_sets(got, jax_cli)


def test_wideband_cli_matches_jax_cli_on_drawn_payloads(tmp_path):
    """Random payloads under the wideband north star's fixture rules: the
    port's CLI decodes exactly the packets the JAX package's CLI decodes,
    its misses included, and nothing that was not injected."""
    from gr_lora_tpu.apps import gateway as jax_gateway
    from gr_lora_tpu_torch.apps import gateway

    wide, injected = _drawn_fixture()
    cap = tmp_path / "drawn.cf64"
    wide.tofile(cap)
    got = _cli_datagrams(gateway.main, cap, device="cpu")
    _same_sets(got, _cli_datagrams(jax_gateway.main, cap))
    assert {(ch, sf, hx) for ch, sf, _, hx in got} <= injected, got
