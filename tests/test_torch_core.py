"""The port's own copies of what it shares no code with any more — the
config, the NumPy codec and the C++ host tracker — against the JAX
package's originals.

``config_pair`` is the one helper by which every port test builds the two
packages' configs from the same keyword arguments (``port_config`` turns a
JAX test module's fixture config into the port's).
"""

import dataclasses

import numpy as np
import pytest
import torch

import gr_lora_tpu.config as jconfig
from gr_lora_tpu import native as jnative
from gr_lora_tpu.core import codec as jcodec
from gr_lora_tpu.core import constants as jconstants
import gr_lora_tpu_torch.config as tconfig
from gr_lora_tpu_torch import native as tnative
from gr_lora_tpu_torch.core import codec as tcodec
from gr_lora_tpu_torch.core import constants as tconstants
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import num_hops_for, peak_lattice_fn
from gr_lora_tpu_torch.ops.cplx import to_ri


def config_pair(**kw):
    """(the JAX package's LoraConfig, the port's) from the same keyword
    arguments; ``peak_search`` may be either package's enum."""
    ps = int(kw.pop("peak_search", 0))
    return (jconfig.LoraConfig(peak_search=jconfig.PeakSearch(ps), **kw),
            tconfig.LoraConfig(peak_search=tconfig.PeakSearch(ps), **kw))


def port_config(cfg):
    """The port's LoraConfig with the fields of a JAX one."""
    return config_pair(**dataclasses.asdict(cfg))[1]


def same_fields(a, b) -> bool:
    """Field-wise equality of two configs of either package."""
    return dataclasses.astuple(a) == dataclasses.astuple(b)


CONFIG_GRID = [(sf, p, ff) for sf in range(7, 13) for p in (1, 2, 4)
               for ff in (1, 2, 8)]
DERIVED = ("num_symbols", "num_samples", "bin_size", "fft_size",
           "preamble_drift_max", "bin_tolerance", "ppm_payload")


@pytest.mark.parametrize("sf,p,ff", CONFIG_GRID)
def test_config_fields_and_derived_properties(sf, p, ff):
    ldr = (1 << sf) / 125e3 > 16e-3
    jc, tc = config_pair(sf=sf, cr=1 + sf % 4, crc=sf % 2 == 0, ldr=ldr,
                         explicit_header=sf != 12, payload_len=9, p=p,
                         fft_factor=ff, threshold=5.0)
    assert [f.name for f in dataclasses.fields(tc)] == \
        [f.name for f in dataclasses.fields(jc)]
    assert same_fields(tc, jc)
    for name in DERIVED:
        assert getattr(tc, name) == getattr(jc, name), name
    for n in (0, 5, 64):
        assert tc.packet_symbol_len(n) == jc.packet_symbol_len(n)
    twin = tc.replace(fft_factor=2 * ff)
    assert same_fields(twin, jc.replace(fft_factor=2 * ff))
    assert twin != tc and tc == tc.replace() and hash(tc) == hash(
        tc.replace())


def test_config_constants_and_validation():
    names = [n for n in dir(jconfig) if n.isupper()]
    assert names and all(getattr(tconfig, n) == getattr(jconfig, n)
                         for n in names)
    assert [int(v) for v in tconfig.PeakSearch] == \
        [int(v) for v in jconfig.PeakSearch]
    for bad in (dict(sf=13), dict(cr=0), dict(sf=6, explicit_header=True),
                dict(p=0), dict(precision="tf32"),
                dict(weak_compensation="x")):
        for cls in (jconfig.LoraConfig, tconfig.LoraConfig):
            with pytest.raises(ValueError):
                cls(**bad)


PAYLOADS = [bytes([1, 2, 3, 4, 5, 6]), bytes([7] * 5), b"", bytes([0xFF]),
            bytes(range(37))]
CODEC_GRID = [(sf, cr, crc, explicit) for sf in (7, 8, 10, 12)
              for cr, crc, explicit in ((1, True, True), (4, False, True),
                                        (2, True, False))]


@pytest.mark.parametrize("sf,cr,crc,explicit", CODEC_GRID)
def test_codec_encode_decode_equal_jax(sf, cr, crc, explicit):
    """Symbols and decode results (PDU bytes, header, CRC verdict) equal
    over a payload grid that holds the two golden PDUs' payloads, and for
    a corrupted packet."""
    rng = np.random.default_rng(sf * 10 + cr)
    for payload in PAYLOADS + [rng.bytes(int(rng.integers(1, 60)))]:
        if not payload and not explicit:
            continue
        jc, tc = config_pair(sf=sf, cr=cr, crc=crc,
                             ldr=(1 << sf) / 125e3 > 16e-3,
                             explicit_header=explicit,
                             payload_len=len(payload))
        syms = tcodec.encode(payload, tc)
        assert syms.dtype == np.uint16
        assert np.array_equal(syms, jcodec.encode(payload, jc))
        bad = syms.copy()
        bad[len(bad) // 2] ^= 5
        for s in (syms, bad, syms[:6]):
            a, b = tcodec.decode(s, tc), jcodec.decode(s, jc)
            assert np.array_equal(a.payload, b.payload)
            assert (a.crc_ok, a.ok, a.reason) == (b.crc_ok, b.ok, b.reason)
            assert (a.header is None) == (b.header is None)
            if a.header is not None:
                assert dataclasses.astuple(a.header) == \
                    dataclasses.astuple(b.header)
    golden = {"0630f0010203040506050801": bytes([1, 2, 3, 4, 5, 6]),
              "0530000707070707e76b01": bytes([7] * 5)}
    if (cr, crc, explicit) == (1, True, True):
        for pdu, payload in golden.items():
            _, tc = config_pair(sf=sf, cr=1, crc=True,
                                ldr=(1 << sf) / 125e3 > 16e-3,
                                explicit_header=True)
            res = tcodec.decode(tcodec.encode(payload, tc), tc)
            assert bytes(res.payload).hex() == pdu


def test_whitening_table_equal_jax():
    assert tconstants.WHITENING_SEQUENCE.dtype == np.uint8
    assert np.array_equal(tconstants.WHITENING_SEQUENCE,
                          jconstants.WHITENING_SEQUENCE)
    assert np.array_equal(tconstants.WHITENING_SEQUENCE,
                          jnative.whitening_sequence())


def _recorded_peaks(channels: int = 2):
    """The peak stream of the README collision (SF8, ff 8) on
    ``channels`` channels, from the port's dense lattice: (cfg pair, bins,
    h, hs, valid), each [C, H, M]."""
    jc, tc = config_pair(sf=8, cr=1, crc=True, ldr=False,
                         explicit_header=True, payload_len=8, p=2,
                         fft_factor=8, threshold=5.0)
    n = tc.num_samples
    p1 = 0.2 * modulate(tcodec.encode(bytes([1, 2, 3, 4, 5, 6]), tc), tc,
                        pad_front=0, pad_back=0)
    p2 = 0.09 * modulate(tcodec.encode(bytes([7] * 5), tc), tc,
                         pad_front=0, pad_back=0)
    total = 1000 + 60 * n + channels * 3 * n
    iq = np.zeros((channels, total), np.complex64)
    for c in range(channels):
        base = 1000 + c * 3 * n
        off2 = base + 16 * n + 4 * n // 8 + 204
        iq[c, base:base + len(p1)] += p1
        iq[c, off2:off2 + len(p2)] += p2
    x = torch.from_numpy(to_ri(iq))
    nh = num_hops_for(tc, total)
    with torch.no_grad():
        out = peak_lattice_fn(tc, nh, 8, "rdft")(x)
    return (jc, tc), *(t.numpy() for t in out)


def test_host_tracker_drains_equal_jax_native():
    """The port's C++ tracker (built from csrc/host/) and the JAX
    package's native one give the same drains on one recorded peak stream:
    per-channel banks (packets with positions) and the one-stream tracker
    (symbols), with the same stats and flush length."""
    (jc, tc), bins, h, hs, valid = _recorded_peaks()
    ours = tnative.MultiPyramidTracker(tc, bins.shape[0])
    ref = jnative.MultiPyramidTracker(jc, bins.shape[0])
    assert ours.flush_hops() == ref.flush_hops()
    got, want = [], []
    for lo in range(0, bins.shape[1], 100):
        blk = (a[:, lo:lo + 100] for a in (bins, h, hs, valid))
        b, hh, ss, v = blk
        ours.feed(b, hh, ss, v)
        ref.feed(b, hh, ss, v)
        got += ours.drain()
        want += ref.drain()
    z = np.zeros((bins.shape[0], ours.flush_hops(), bins.shape[2]))
    ours.feed(z, z, z, z.astype(bool))
    ref.feed(z, z, z, z.astype(bool))
    got += ours.drain()
    want += ref.drain()
    assert len(got) == len(want) >= 2 * bins.shape[0]
    for (c, pos, s), (rc, rpos, rs) in zip(got, want):
        assert (c, pos) == (rc, rpos) and np.array_equal(s, rs)
    pdus = {bytes(tcodec.decode(s, tc).payload).hex() for _, _, s in got}
    assert {"0630f0010203040506050801", "0530000707070707e76b01"} <= pdus
    assert ours.stats() == ref.stats()

    one, one_ref = tnative.PyramidTracker(tc), jnative.PyramidTracker(jc)
    for t in range(bins.shape[1]):
        v = valid[0, t]
        order = np.argsort(bins[0, t][v], kind="stable")
        args = (bins[0, t][v][order], h[0, t][v][order], hs[0, t][v][order])
        one.step(*args)
        one_ref.step(*args)
    for _ in range(one.flush_hops()):
        one.step()
        one_ref.step()
    a, b = one.drain(), one_ref.drain()
    assert len(a) == len(b) >= 2
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert one.stats() == one_ref.stats()


def test_host_tracker_rejects_bad_input():
    _, tc = config_pair(sf=8, fft_factor=8, p=2)
    with pytest.raises(ValueError):
        tnative.PyramidTracker(tc, quantize="ceil")
    bank = tnative.MultiPyramidTracker(tc, 2)
    z = np.zeros((3, 4, 8))
    with pytest.raises(ValueError):
        bank.feed(z, z, z, z.astype(bool))


def test_host_tracker_library_is_built_from_the_port():
    """The host library (tracker, codec, ring) is the port's own build
    under _build/, never the JAX package's native/liblora_host.so."""
    lib = tnative.library()
    assert tnative.LIB_PATH.exists() and not tnative._stale()
    assert tnative.LIB_PATH.parent.name == "_build"
    assert lib._name == str(tnative.LIB_PATH)
    assert [p.name for p in tnative.sources()] == [
        "lora_codec.cc", "pyramid_tracker.cc", "ring_buffer.cc"]
