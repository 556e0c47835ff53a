"""The port's FSM receivers against the JAX package's: TriggeredReceiver,
MultiSFReceiver, the loopback, Decoder and the flagship entry.

Fixtures are tests/test_triggered.py's, tests/test_multi_sf.py's,
tests/test_snr.py's and tests/test_overflow.py's, built with the port's
modulator and codec at ``precision="highest"``.  Channel, SF, position,
symbols, payload and the drop counters must be equal; ``snr_ratio``
passes through the dechirp transform (an f32 FFT here, f32 matmuls there)
and is held within rtol 1e-4.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from gr_lora_tpu.dist.multi_sf import MultiSFReceiver as JaxMultiSF
from gr_lora_tpu.dist.triggered import TriggeredReceiver as JaxTriggered
from gr_lora_tpu.dist.triggered import scan_window as jax_scan_window
from gr_lora_tpu.models.transceiver import loopback as jax_loopback
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.dist import (MultiSFReceiver, TriggeredReceiver)
from gr_lora_tpu_torch.dist.triggered import scan_window
from gr_lora_tpu_torch.entry import entry
from gr_lora_tpu_torch.models import Decoder, loopback
from gr_lora_tpu_torch.models.demodulator import (StreamingDemodulator,
                                                  demodulate)
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.weak import (StreamingWeakDemodulator,
                                           weak_demodulate)
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_torch_core import config_pair

BASE_KW = dict(sf=7, cr=1, crc=True, ldr=False, explicit_header=True,
               payload_len=4, p=2, fft_factor=4, precision="highest")
JBASE, BASE = config_pair(**BASE_KW)
CPU = dict(device="cpu")


def _pkt(sf, payload, ldr=False):
    cfg = BASE.replace(sf=sf, ldr=ldr)
    return to_ri(modulate(encode(payload, cfg), cfg, pad_front=0, pad_back=0))


def _same_packets(ref, out):
    """Field for field: channel, sf, position, symbols, payload, checks;
    snr_ratio within rtol 1e-4."""
    assert len(out) == len(ref)
    for a, b in zip(ref, out):
        assert (b.channel, b.sf, b.position) == (a.channel, a.sf, a.position)
        assert b.symbols.dtype == a.symbols.dtype == np.uint16
        assert np.array_equal(b.symbols, a.symbols)
        assert bytes(b.result.payload) == bytes(a.result.payload)
        assert (b.result.ok, b.result.crc_ok) == (a.result.ok, a.result.crc_ok)
        np.testing.assert_allclose(b.snr_ratio, a.snr_ratio, rtol=1e-4)


def _triggered_both(iq, **kw):
    ref_rx = JaxTriggered(JBASE, **kw)
    rx = TriggeredReceiver(BASE, **kw, **CPU)
    ref, out = ref_rx(iq), rx(iq)
    _same_packets(ref, out)
    assert (rx.dropped_events, rx.dropped_packets) == \
        (ref_rx.dropped_events, ref_rx.dropped_packets)
    return out, rx


def test_scan_window_matches_jax():
    for sf in range(7, 13):
        for explicit in (False, True):
            jc, c = config_pair(**dict(BASE_KW, sf=sf, ldr=sf >= 11,
                                       explicit_header=explicit))
            assert scan_window(c) == jax_scan_window(jc)


def test_triggered_sparse_stream_multi_sf():
    """test_triggered.py: three packets at two SFs on two channels."""
    rng = np.random.default_rng(1)
    n7 = BASE.num_samples
    t = 500 * n7
    iq = rng.normal(0, 0.01, (2, t, 2)).astype(np.float32)
    spots = [(0, 31 * n7 + 77, _pkt(7, bytes([1, 2, 3, 4]))),
             (0, 300 * n7 + 13, _pkt(9, bytes([5, 6, 7, 8]))),
             (1, 144 * n7 + 200, _pkt(7, bytes([1, 2, 3, 4])))]
    for ch, off, pkt in spots:
        iq[ch, off:off + len(pkt)] += pkt
    out, _ = _triggered_both(iq, sfs=(7, 9))
    assert {(p.channel, p.sf) for p in out} == {(0, 7), (0, 9), (1, 7)}
    assert len(out) == 3


def test_triggered_idle_stream_silent():
    rng = np.random.default_rng(2)
    iq = rng.normal(0, 0.01, (2, 200 * BASE.num_samples, 2)) \
        .astype(np.float32)
    out, _ = _triggered_both(iq, sfs=(7, 8))
    assert out == []


def test_triggered_counts_event_overflow():
    """test_overflow.py: six packets on one channel, two event slots."""
    kw = dict(sf=7, cr=1, crc=False, ldr=False, explicit_header=False,
              payload_len=2, p=2, fft_factor=2, precision="highest")
    jcfg, cfg = config_pair(**kw)
    n = cfg.num_samples
    pkt = to_ri(modulate(encode(bytes([1, 2]), cfg), cfg, pad_front=0,
                         pad_back=0))
    rng = np.random.default_rng(0)
    t = 400 * n
    iq = rng.normal(0, 0.01, (1, t, 2)).astype(np.float32)
    span = t - len(pkt) - n
    for i in range(6):
        off = n + i * span // 6
        iq[0, off:off + len(pkt)] += pkt
    ref_rx = JaxTriggered(jcfg, sfs=(7,), max_events=2)
    rx = TriggeredReceiver(cfg, sfs=(7,), max_events=2, **CPU)
    _same_packets(ref_rx(iq), rx(iq))
    assert rx.dropped_events == ref_rx.dropped_events > 0
    assert rx.dropped_packets == ref_rx.dropped_packets


def _multi_both(iq, **kw):
    jbase, base = kw.pop("jbase", JBASE), kw.pop("base", BASE)
    ref_rx = JaxMultiSF(jbase, **kw)
    rx = MultiSFReceiver(base, **kw, **CPU)
    ref, out = ref_rx(iq), rx(iq)
    _same_packets(ref, out)
    assert rx.dropped == ref_rx.dropped
    return out


def test_multi_sf_two_sfs_same_channel():
    """test_multi_sf.py: SF7 inside an SF9 packet on one channel."""
    p7 = _pkt(7, bytes([0x11, 0x22]))
    p9 = _pkt(9, bytes([0x33, 0x44, 0x55]))
    total = 3000 + max(len(p7) + 2000, len(p9)) + 4096
    iq = np.zeros((total, 2), np.float32)
    iq[5000:5000 + len(p7)] += 0.5 * p7
    iq[3000:3000 + len(p9)] += 0.5 * p9
    out = _multi_both(iq, sfs=(7, 9))
    assert {p.sf for p in out} == {7, 9}


def test_multi_sf_multi_channel():
    p7 = _pkt(7, bytes([0xAA, 0xBB]))
    p8 = _pkt(8, bytes([0xCC, 0xDD]))
    total = 4000 + max(len(p7), len(p8)) + 4096
    iq = np.zeros((2, total, 2), np.float32)
    iq[0, 1000:1000 + len(p7)] += 0.5 * p7
    iq[1, 2000:2000 + len(p8)] += 0.5 * p8
    out = _multi_both(iq, sfs=(7, 8))
    assert {(p.channel, p.sf) for p in out} == {(0, 7), (1, 8)}


def test_multi_sf_snr_and_slot_overflow():
    """test_snr.py's receiver case (an SF8 packet at 5 dB, implicit
    header) and test_overflow.py's slot overflow (4 packets, 2 slots)."""
    kw = dict(sf=8, cr=1, crc=True, ldr=False, explicit_header=False,
              payload_len=4, p=2, fft_factor=4, precision="highest")
    jcfg, cfg = config_pair(**kw)
    iq = modulate(encode(bytes([1, 2, 3, 4]), cfg), cfg)
    rng = np.random.default_rng(0)
    sigma = np.sqrt(cfg.p * 10 ** (-5.0 / 10) / 2)
    iq = (iq + sigma * (rng.standard_normal(len(iq))
                        + 1j * rng.standard_normal(len(iq)))
          ).astype(np.complex64)
    out = _multi_both(to_ri(iq)[None], jbase=jcfg, base=cfg, sfs=(8,),
                      num_samples=len(iq))
    assert out and out[0].snr_ratio > 0.0

    kw = dict(sf=7, cr=1, crc=False, ldr=False, explicit_header=False,
              payload_len=2, p=2, fft_factor=2, precision="highest")
    jcfg, cfg = config_pair(**kw)
    pkt = to_ri(modulate(encode(bytes([1, 2]), cfg), cfg, pad_front=0,
                         pad_back=0))
    gap = np.zeros((4 * cfg.num_samples, 2), np.float32)
    iq = np.concatenate([x for _ in range(4) for x in (pkt, gap)])
    ref_rx = JaxMultiSF(jcfg, sfs=(7,), max_packets=2)
    rx = MultiSFReceiver(cfg, sfs=(7,), max_packets=2, **CPU)
    _same_packets(ref_rx(iq), rx(iq))
    assert rx.dropped == ref_rx.dropped == 2


@pytest.mark.parametrize("kw,payload", [
    (dict(sf=8, cr=1, crc=True, ldr=False, explicit_header=True, p=2,
          fft_factor=2), bytes([1, 2, 3, 4, 5, 6])),
    (dict(sf=8, cr=4, crc=True, ldr=True, explicit_header=False,
          payload_len=8, p=2, fft_factor=2), bytes(range(8))),
])
def test_loopback_and_decoder(kw, payload):
    jcfg, cfg = config_pair(precision="highest", **kw)
    for snr in (None, 10.0):
        ref = jax_loopback(payload, jcfg, snr_db=snr, seed=3)
        out = loopback(payload, cfg, snr_db=snr, seed=3, **CPU)
        assert np.array_equal(out.symbols_tx, ref.symbols_tx)
        assert np.array_equal(out.iq, ref.iq)
        assert [p.tolist() for p in out.packets] == \
            [p.tolist() for p in ref.packets]
        assert out.payloads == ref.payloads and len(out.payloads) == 1
    dec = Decoder(cfg)
    res = dec(out.packets[0])
    assert res.ok and bytes(res.payload) == out.payloads[0]
    if cfg.explicit_header:
        assert dec.parse_header(out.packets[0]).payload_len == len(payload)


def test_entry_matches_graft_entry():
    """The port's entry() runs the same FSM step on the same packet as
    __graft_entry__.entry()."""
    jfn, (jiq,) = __graft_entry__.entry()
    fn, (iq,) = entry(device="cpu")
    assert iq.device.type == "cpu" and np.array_equal(iq.numpy(), jiq)
    ref = [np.asarray(x) for x in jax.device_get(jax.jit(jfn)(jiq))]
    out = [x.numpy() for x in fn(iq)]
    for a, b in zip(ref[:5], out[:5]):
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))
    np.testing.assert_allclose(out[5], ref[5], rtol=1e-4)
    assert int(out[3]) == 1


def _entry_points():
    _, cfg = config_pair(**BASE_KW)
    iq = np.zeros((4 * cfg.num_samples, 2), np.float32)
    wcfg = cfg.replace(weak_sym_num=2)
    return {
        "demodulate": (demodulate, lambda **kw: demodulate(iq, cfg, **kw)),
        "StreamingDemodulator": (StreamingDemodulator,
                                 lambda **kw: StreamingDemodulator(cfg, **kw)),
        "weak_demodulate": (weak_demodulate,
                            lambda **kw: weak_demodulate(iq, wcfg, **kw)),
        "StreamingWeakDemodulator": (
            StreamingWeakDemodulator,
            lambda **kw: StreamingWeakDemodulator(wcfg, **kw)),
        "TriggeredReceiver": (
            TriggeredReceiver,
            lambda **kw: TriggeredReceiver(cfg, sfs=(7,), **kw)(iq)),
        "MultiSFReceiver": (
            MultiSFReceiver,
            lambda **kw: MultiSFReceiver(cfg, sfs=(7,), **kw)(iq)),
        "loopback": (loopback, lambda **kw: loopback(bytes([1]), cfg, **kw)),
        "entry": (entry, lambda **kw: entry(**kw)),
    }


@pytest.mark.parametrize("name", ["demodulate", "StreamingDemodulator",
                                  "weak_demodulate",
                                  "StreamingWeakDemodulator",
                                  "TriggeredReceiver", "MultiSFReceiver",
                                  "loopback", "entry"])
def test_new_entry_points_default_to_the_card(name, monkeypatch):
    """Each entry point's device defaults to "cuda"; with no CUDA device
    it raises unless the caller passes device="cpu", where it runs."""
    fn, call = _entry_points()[name]
    target = fn.__init__ if inspect.isclass(fn) else fn
    assert inspect.signature(target).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device="cpu")
