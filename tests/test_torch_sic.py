"""The port's SIC (models/sic) against the JAX package's on the CPU.

Fixtures are tests/test_sic.py's and tests/test_collision_gateway.py's,
rebuilt here with the port's modulator and codec (equal to the JAX
package's bit for bit, tests/test_torch_twins.py) at the same offsets and
ratios.  Where both packages do the same NumPy work the results are equal
bit for bit: symbols, start indices, flags.  Where a value passes through
the dechirp transform (a torch.fft here, f32 matmuls there) or a float
sum, it is held within a tolerance: ``captured`` within rtol 1e-5 (1e-4
through ``sic_demodulate``), the subtracted waveform within 1e-6.
"""

import numpy as np
import pytest

from gr_lora_tpu.dist.collision_gateway import \
    TriggeredPyramidGateway as JaxGateway
from gr_lora_tpu.models import sic as jsic
from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.models import sic as tsic
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import pyramid_demodulate
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_torch_core import config_pair

JCFG, CFG = config_pair(sf=8, cr=1, crc=True, ldr=False,
                        explicit_header=True, payload_len=8, p=2,
                        fft_factor=8, threshold=5.0)
N = CFG.num_samples
PAY1, PAY2 = bytes([1, 2, 3, 4, 5, 6]), bytes([7] * 5)
PDU1 = "0630f0010203040506050801"
PDU2 = "053000" + "07" * 5 + "e76b01"
P1 = modulate(encode(PAY1, CFG), CFG, pad_front=0, pad_back=0)
P2 = modulate(encode(PAY2, CFG), CFG, pad_front=0, pad_back=0)
CPU = dict(device="cpu")

#: sic_demodulate cases: (name, weak-packet offset or None, ratio, kw).
MASKED = 1000 + 16 * N + 13          # test_recovers_masked_weak_packet
TRUNCATED = 1000 + 8 * N + 204       # test_refinement_fixes_truncated_track
CASES = [("masked", MASKED, 0.2, dict(grace=8)),
         ("truncated", TRUNCATED, 0.45, dict(grace=8)),
         ("single", None, 0.0, {}),
         ("masked_fast", MASKED, 0.2, dict(grace=8, fast_align=True))]


def _collision(off2, ratio):
    """tests/test_sic.py _mk_collision: the strong packet at 1000, the
    weak one at ``off2`` (None: the strong one alone, test_single_packet's
    buffer)."""
    if off2 is None:
        iq = np.zeros(len(P1) + 14 * N, np.complex64)
        iq[1000:1000 + len(P1)] = (0.2 * P1).astype(np.complex64)
        return iq
    iq = np.zeros(off2 + len(P2) + 12 * N, np.complex64)
    iq[1000:1000 + len(P1)] += (0.2 * P1).astype(np.complex64)
    iq[off2:off2 + len(P2)] += (0.2 * ratio * P2).astype(np.complex64)
    return iq


def _pdus(streams):
    return {bytes(r.payload).hex() for r in (decode(s, CFG) for s in streams)
            if r.ok}


def _same_packets(ours, ref, rtol=1e-4):
    assert len(ours) == len(ref) >= 1
    for q, r in zip(ours, ref):
        assert isinstance(q, tsic.SicPacket)
        assert (q.position, q.sic_pass, q.subtracted, q.refined) == \
            (r.position, r.sic_pass, r.subtracted, r.refined)
        assert np.asarray(q.symbols).dtype == np.uint16
        np.testing.assert_array_equal(q.symbols, r.symbols)
        np.testing.assert_allclose(q.captured, r.captured, rtol=rtol)


# -- helpers ---------------------------------------------------------------

def test_reencode_and_trim_equal_jax():
    """_reencode of a clean decode; _trim_to_packet of a tracked stream
    with trailing symbols (re-encoded), of a corrupted one (cut to the
    on-air count) and of a header-less one."""
    syms = np.asarray(encode(PAY1, CFG), np.uint16)
    np.testing.assert_array_equal(
        tsic._reencode(decode(syms, CFG), CFG),
        jsic._reencode(jsic.decode(syms, JCFG), JCFG))
    rng = np.random.default_rng(0)
    tail = np.concatenate([syms, rng.integers(0, 256, 5).astype(np.uint16)])
    bad = tail.copy()
    bad[12] ^= 0x11
    for s in (tail, bad, np.zeros(4, np.uint16)):
        (_, a), (_, b) = tsic._trim_to_packet(s, CFG), \
            jsic._trim_to_packet(s, JCFG)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("off2", [MASKED, TRUNCATED])
def test_align_and_align_fast_equal_jax(off2):
    """Both aligners, for each packet at the tracker's timestamp
    convention (start + 7 symbols), give the JAX start index."""
    iq = _collision(off2, 0.45)
    for start, pay in ((1000, PAY1), (off2, PAY2)):
        tmpl = modulate(encode(pay, CFG), CFG, pad_front=0, pad_back=0)
        ts = start + 7 * N + 37
        got = tsic._align(iq, tmpl, CFG, ts)
        assert got == jsic._align(iq, tmpl, JCFG, ts) == start
        fast = tsic._align_fast(iq, tmpl, CFG, ts)
        assert fast == jsic._align_fast(iq, tmpl, JCFG, ts)


@pytest.mark.parametrize("fast_align", [False, True])
def test_subtract_equal_jax(fast_align):
    iq = _collision(TRUNCATED, 0.45)
    syms = np.asarray(encode(PAY1, CFG), np.uint16)
    ours, ref = iq.copy(), iq.copy()
    a = tsic._subtract(ours, syms, CFG, 1000 + 7 * N, fast_align=fast_align)
    b = jsic._subtract(ref, syms, JCFG, 1000 + 7 * N, fast_align=fast_align)
    assert a[0] is b[0] is True and a[2] == b[2] == 1000
    np.testing.assert_allclose(a[1], b[1], rtol=1e-5)
    np.testing.assert_allclose(a[3], b[3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_reextract_equal_jax():
    """Re-read the weak packet at its known start once the strong one is
    cancelled, and the strong one from the raw buffer."""
    iq = _collision(TRUNCATED, 0.45)
    nsym = len(encode(PAY2, CFG))
    clean = iq.copy()
    tsic._subtract(clean, np.asarray(encode(PAY1, CFG), np.uint16), CFG,
                   1000 + 7 * N, start=1000)
    for buf, start, n in ((clean, TRUNCATED, nsym),
                          (iq, 1000, len(encode(PAY1, CFG)))):
        a = tsic._reextract(buf, CFG, start, n)
        np.testing.assert_array_equal(a, jsic._reextract(buf, JCFG, start,
                                                         n))
        assert _pdus([a]) <= {PDU1, PDU2} and _pdus([a])
    assert tsic._reextract(iq, CFG, len(iq) - N, 8) is None


# -- sic_demodulate ----------------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("name,off2,ratio,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_sic_demodulate_equals_jax(name, off2, ratio, kw, use_native):
    iq = _collision(off2, ratio)
    ours = tsic.sic_demodulate(iq, CFG, use_native=use_native, **kw, **CPU)
    ref = jsic.sic_demodulate(iq, JCFG, use_native=use_native, **kw)
    _same_packets(ours, ref)
    want = {PDU1} if off2 is None else {PDU1, PDU2}
    assert _pdus([q.symbols for q in ours]) >= want
    if name == "truncated":
        plain = _pdus(pyramid_demodulate(iq, CFG, grace=8, **CPU))
        assert PDU2 not in plain and any(q.refined for q in ours)
    assert [s.tobytes() for s in tsic.sic_symbol_streams(
        iq, CFG, use_native=use_native, **kw, **CPU)] == \
        [q.symbols.tobytes() for q in ours]


@pytest.mark.parametrize("use_native", [True, False])
def test_known_fast_path_dense_passes_equal_jax(monkeypatch, use_native):
    """tests/test_sic.py's known= fast path: an explained window runs no
    dense pass; the masked hop-aligned collision runs the JAX package's
    count of them and recovers both packets."""
    calls = {"ours": 0, "ref": 0}

    def counting(mod, key):
        real = mod._demod_pass

        def run(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, "_demod_pass", run)

    counting(tsic, "ours")
    counting(jsic, "ref")
    known = [(1000 + 7 * N, np.asarray(encode(PAY1, CFG), np.uint16))]
    kw = dict(known=known, residual_gate=0.02, fast_align=True,
              use_native=use_native)
    single = np.zeros(1000 + len(P1) + 12 * N, np.complex64)
    single[1000:1000 + len(P1)] += (0.2 * P1).astype(np.complex64)
    for iq, want, dense in ((single, {PDU1}, 0),
                            (_collision(1000 + 16 * N, 0.2), {PDU1, PDU2},
                             None)):
        before = dict(calls)
        ours = tsic.sic_demodulate(iq, CFG, **kw, **CPU)
        _same_packets(ours, jsic.sic_demodulate(iq, JCFG, **kw))
        assert _pdus([q.symbols for q in ours]) >= want
        n_ours = calls["ours"] - before["ours"]
        assert n_ours == calls["ref"] - before["ref"]
        assert n_ours == dense if dense is not None else n_ours >= 1


# -- the gateway -------------------------------------------------------------

def _gateway_stream(off2):
    """tests/test_collision_gateway.py's SIC fixture: the strong packet at
    5000, the weak one (ratio 0.2) ``off2`` later."""
    p1, p2 = 0.2 * P1, 0.2 * 0.2 * P2
    total = 5000 + off2 + len(p2) + 60 * N
    iq = np.zeros((1, total), np.complex64)
    iq[0, 5000:5000 + len(p1)] += p1
    iq[0, 5000 + off2:5000 + off2 + len(p2)] += p2
    return to_ri(iq)


@pytest.mark.parametrize("off2", [16 * N, 16 * 512 + 13])
def test_gateway_sic_equals_jax(off2):
    """TriggeredPyramidGateway(sic=True): the masked hop-aligned point
    (test_sic_recovers_masked_preamble_in_gateway) and one envelope point
    of test_sic_envelope_through_gateway; the same PDUs and SIC windows as
    the JAX gateway's."""
    ri = _gateway_stream(off2)
    kw = dict(sfs=(8,), max_payload_len=16, scan_chunk_samples=1 << 16)

    def pdus(pkts):
        return {bytes(p.result.payload).hex() for p in pkts
                if p.result is not None and p.result.ok}

    gw = TriggeredPyramidGateway(CFG, 1, sic=True, backend="fused", **kw,
                                 **CPU)
    ours = pdus(gw.feed(ri) + gw.flush())
    ref_gw = JaxGateway(JCFG, 1, sic=True, **kw)
    ref = pdus(ref_gw.feed(ri) + ref_gw.flush())
    assert ours == ref and {PDU1, PDU2} <= ours
    assert gw.sic_windows == ref_gw.sic_windows >= 1
    assert gw.stats()["sic_windows"] == gw.sic_windows
    assert gw.wall["sic"] > 0
    assert gw.wall_reset()["sic"] > 0 and gw.wall["sic"] == 0.0


def test_gateway_without_sic_loses_the_masked_packet():
    """The masked point needs SIC: the plain gateway decodes the strong
    packet only, and runs no SIC window."""
    gw = TriggeredPyramidGateway(CFG, 1, sfs=(8,), max_payload_len=16,
                                 scan_chunk_samples=1 << 16,
                                 backend="fused", **CPU)
    ri = _gateway_stream(16 * N)
    got = {bytes(p.result.payload).hex() for p in gw.feed(ri) + gw.flush()
           if p.result is not None and p.result.ok}
    assert PDU1 in got and PDU2 not in got
    assert gw.sic_windows == 0 and gw.wall["sic"] == 0.0
