"""The port's CLI apps and PduSink on the CPU, twins of tests/test_apps.py
and tests/test_pdu_sink.py: tx_file -> rx_file / rx_file_collision round
trips, txrx_sim on the command line and as a UDP service, rx_stream over
the ring and without it, the sink's CRC filter and its drains; the SVG
plots and the whitening consensus tool equal to the JAX package's.

Every app runs with ``device="cpu"``; UDP uses ephemeral ports only (the
JAX twins bind fixed ports and may run at the same time in another
worker).
"""

import socket
import threading

import numpy as np
import pytest

from gr_lora_tpu.core.codec import encode as jax_encode
from gr_lora_tpu_torch.apps import (rx_file, rx_file_collision, rx_stream,
                                    tx_file, txrx_sim)
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.dist.pdu_sink import PduEvent, PduSink
from gr_lora_tpu_torch.models.modulator import modulate
from test_torch_core import config_pair

PDU_1 = "06 30 f0 01 02 03 04 05 06 05 08 01"


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_tx_rx_file_roundtrip(tmp_path, capsys):
    cap = tmp_path / "single.cf64"
    assert tx_file.main([str(cap), "--payload", "010203040506",
                         "--amplitude", "0.3"], device="cpu") == 0
    capsys.readouterr()
    assert rx_file.main([str(cap)], device="cpu") == 0
    assert PDU_1 in capsys.readouterr().out


def test_tx_rx_collision_roundtrip(tmp_path, capsys):
    cap = tmp_path / "collision.cf64"
    assert tx_file.main([
        str(cap),
        "--payload", "010203040506", "--payload", "0707070707",
        "--offset", "0", "--offset", "19.72265625",   # 5049/256 samples
        "--amplitude", "0.25", "--amplitude", "0.12",
    ], device="cpu") == 0
    capsys.readouterr()
    assert rx_file_collision.main([str(cap)], device="cpu") == 0
    assert "07 07 07 07 07" in capsys.readouterr().out   # the weak packet


def test_tx_file_capture_equals_jax(tmp_path):
    """The same tx_file command writes the same capture in both packages
    (modulator twin + polyphase upsampler), within 1e-5 of its peak."""
    from gr_lora_tpu.apps import tx_file as jax_tx_file

    argv = ["--payload", "010203", "--payload", "0a0b", "--offset", "0",
            "--offset", "11.5", "--amplitude", "0.3", "--amplitude", "0.2"]
    jax_tx_file.main([str(tmp_path / "jax.cf64"), *argv])
    tx_file.main([str(tmp_path / "port.cf64"), *argv], device="cpu")
    ref = np.fromfile(tmp_path / "jax.cf64", np.complex64)
    got = np.fromfile(tmp_path / "port.cf64", np.complex64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_txrx_sim_cli(capsys):
    assert txrx_sim.main(["--payload", "0102030405"], device="cpu") == 0
    assert "01 02 03 04 05" in capsys.readouterr().out


def test_txrx_sim_udp(capsys):
    port_in, port_out = _free_port(), _free_port()
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", port_out))
    rx.settimeout(120)
    result = []
    t = threading.Thread(target=lambda: result.append(txrx_sim.main(
        ["--udp", "--udp-in", str(port_in), "--udp-out", str(port_out),
         "--count", "1"], device="cpu")))
    t.start()
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        data = None
        for _ in range(100):          # until the service has bound its port
            tx.sendto(bytes([9, 8, 7]), ("127.0.0.1", port_in))
            try:
                rx.settimeout(0.5)
                data, _ = rx.recvfrom(65536)
                break
            except socket.timeout:
                continue
        tx.close()
        assert data is not None and data[:3] == bytes([9, 8, 7])
    finally:
        t.join(timeout=120)
        rx.close()
    assert not t.is_alive() and result == [0]


@pytest.mark.parametrize("ring", [True, False])
def test_rx_stream_cli(tmp_path, capsys, ring):
    """Streaming CLI over a demod-rate capture, through the native ring
    and with --no-ring."""
    _, cfg = config_pair(sf=8, cr=1, crc=True, ldr=False,
                         explicit_header=True, payload_len=8, p=2,
                         fft_factor=8)
    iq = modulate(encode(bytes([1, 2, 3, 4, 5, 6]), cfg), cfg)
    path = tmp_path / "stream.cf64"
    np.asarray(0.5 * iq, np.complex64).tofile(path)
    argv = [str(path), "--chunk", "4096"] + ([] if ring else ["--no-ring"])
    assert rx_stream.main(argv, device="cpu") == 0
    assert PDU_1 in capsys.readouterr().out


def test_sink_crc_filter():
    sink = PduSink(crc_filter=True)
    sink.emit(PduEvent(0, 7, 0, b"bad", False))
    sink.emit(PduEvent(0, 7, 0, b"good", True))
    sink.emit(PduEvent(0, 7, 0, b"nocrc", None))
    assert [e.payload for e in sink.events] == [b"good", b"nocrc"]
    assert sink.stats() == {"emitted": 2, "crc_filtered": 1}


def test_sink_drain_gateway_to_udp():
    """drain_gateway on a hand-built per-channel (position, symbols) list
    (the sharded gateway that produces one is not ported): each good
    packet decodes with the port's codec and goes out as one datagram;
    a packet that does not decode is skipped."""
    jcfg, cfg = config_pair(sf=7, cr=2, crc=True, ldr=False,
                            explicit_header=False, payload_len=4, p=2,
                            fft_factor=2)
    payload = bytes([0xDE, 0xAD, 0xBE, 0xEF])
    syms = encode(payload, cfg)
    assert np.array_equal(syms, jax_encode(payload, jcfg))
    packets = [[], [(500, syms), (900, np.zeros(3, np.uint16))]]

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(10)
    got = []
    sink = PduSink(udp=("127.0.0.1", rx.getsockname()[1]),
                   callback=got.append)
    n = sink.drain_gateway(packets, cfg)
    sink.close()
    assert n == 1 and len(got) == 1
    ev = got[0]
    assert ev.channel == 1 and ev.position == 500 and ev.crc_ok
    assert ev.payload[:4] == payload
    data, _ = rx.recvfrom(65536)
    rx.close()
    assert data == ev.to_wire()
    assert data[0] == 1 and data[1] == cfg.sf
    assert int.from_bytes(data[2:6], "little") == 500
    assert data[6:10] == payload


def test_sink_drain_multi_sf():
    """drain_multi_sf emits every MultiSFReceiver packet as it stands."""
    from gr_lora_tpu_torch.core.codec import decode
    from gr_lora_tpu_torch.dist.multi_sf import SfPacket

    _, cfg = config_pair(sf=8, cr=1, crc=True, ldr=False,
                         explicit_header=True, payload_len=8, p=2,
                         fft_factor=8)
    syms = encode(bytes([1, 2, 3, 4, 5, 6]), cfg)
    pkts = [SfPacket(channel=2, sf=8, position=1234, symbols=syms,
                     result=decode(syms, cfg))]
    got = []
    sink = PduSink(callback=got.append)
    assert sink.drain_multi_sf(pkts) == 1
    assert got == [PduEvent(2, 8, 1234, bytes(pkts[0].result.payload),
                            True)]


@pytest.mark.parametrize("name,artifact", [
    ("plot_per", "docs/per_curves.json"),
    ("plot_collision", "docs/collision_recovery.json")])
def test_plot_equals_jax(tmp_path, capsys, name, artifact):
    """The port's SVG renderers write the JAX package's SVG, byte for
    byte, from the repo's artifacts."""
    import importlib
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    svgs = []
    for pkg in ("gr_lora_tpu", "gr_lora_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.apps.{name}")
        dst = tmp_path / f"{pkg}.svg"
        assert mod.main([str(root / artifact), str(dst)]) == 0
        svgs.append(dst.read_text())
    assert svgs[0] == svgs[1] and svgs[0].startswith("<svg")
    assert capsys.readouterr().out.count("wrote") == 2


def test_whitening_consensus_equals_jax(tmp_path, capsys):
    """consensus() and the CLI's printout equal the JAX tool's on noisy
    observations of the whitening sequence; an empty dump fails."""
    from gr_lora_tpu.apps import whitening_consensus as jwc
    from gr_lora_tpu_torch.apps import whitening_consensus as wc
    from gr_lora_tpu_torch.core.whitening import WHITENING_SEQUENCE

    rng = np.random.default_rng(4)
    true = bytes(WHITENING_SEQUENCE[:40])
    obs = []
    for i in range(7):
        o = bytearray(true[:40 - (i % 3)])
        o[int(rng.integers(0, len(o)))] ^= 1 << int(rng.integers(0, 8))
        obs.append(bytes(o))
    assert wc.consensus(obs) == jwc.consensus(obs) == true
    dump = tmp_path / "dump.txt"
    dump.write_text("\n".join(" ".join(f"{b:02x}" for b in o)
                              for o in obs) + "\n\n")
    outs = []
    for mod in (jwc, wc):
        assert mod.main([str(dump)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "0x" in outs[0]
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    assert wc.main([str(empty)]) == 1
