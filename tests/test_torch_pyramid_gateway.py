"""The port's always-on gateway (dist/pyramid_gateway.py) and streaming
demodulator on the CPU, against the JAX package.

The collision matrix is tests/test_pyramid_gateway.py's (the README
two-packet collision on every channel, SF8 x ff 8), at 2 channels and
256-hop blocks.  Per kernel backend the port's ``PyramidGateway`` (plain
versions of K3, K4b, K4 and K5 here) and the JAX one (its Pallas kernels
in interpret mode) must emit the same packets: channel, preamble
position, symbols, and both golden PDUs with CRC on every channel.  The
port takes its own config (``port_config`` of the JAX fixture's) and runs
on the CPU here (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu.dist.pyramid_gateway import \
    MultiSFPyramidGateway as JaxMultiSF
from gr_lora_tpu.dist.pyramid_gateway import PyramidGateway as JaxGateway
from gr_lora_tpu_torch.dist.pyramid_gateway import (MultiSFPyramidGateway,
                                                    PyramidGateway)
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.models.pyramid import (StreamingPyramidDemodulator,
                                              pyramid_demodulate)
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_multi_sf_pyramid import _clean_payload
from test_pyramid import CFG as JAX_PYR_CFG, _N as PYR_N, _collision
from test_pyramid_gateway import CFG as JAX_CFG
from test_pyramid_gateway import PDU_1, PDU_2, _N, _collision_matrix
from test_torch_core import port_config

CFG = port_config(JAX_CFG)
PYR_CFG = port_config(JAX_PYR_CFG)
CPU = dict(device="cpu")

CHANNELS = 2
TOTAL = 1000 + CHANNELS * 4 * _N + 76 * _N
KERNEL_BACKENDS = ["rdft", "direct", "fused_direct", "fastp", "pallas"]


def _packets(pkts):
    return sorted((p.channel, p.position, p.symbols.tobytes(),
                   bytes(p.result.payload).hex()
                   if p.result is not None and p.result.ok
                   and p.result.crc_ok else None) for p in pkts)


def _run(gw, ri, step=None):
    if step is None:
        return gw.feed(ri) + gw.flush()
    out = []
    for lo in range(0, ri.shape[1], step):
        out += gw.feed(ri[:, lo:lo + step])
    return out + gw.flush()


@pytest.fixture(scope="module")
def matrix():
    return to_ri(_collision_matrix(CHANNELS, TOTAL))


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_gateway_matches_jax_gateway(matrix, backend):
    kw = dict(block_hops=256, max_peaks=8, backend=backend)
    ours = _packets(_run(PyramidGateway(CFG, CHANNELS, **CPU, **kw),
                         matrix))
    ref = _packets(_run(JaxGateway(JAX_CFG, CHANNELS, **kw), matrix))
    assert ours == ref
    for c in range(CHANNELS):
        assert {PDU_1, PDU_2} <= {p[3] for p in ours if p[0] == c}, ours


@pytest.mark.parametrize("as_tensor", [False, True])
def test_chunked_feed_matches_one_shot(matrix, as_tensor):
    """Small chunks (packets straddle block boundaries), fed as numpy or
    as tensors, give the one-shot packets."""
    one = PyramidGateway(CFG, CHANNELS, block_hops=512, backend="rdft",
                         decode_payloads=False, **CPU)
    ref = _packets(_run(one, matrix))
    small = PyramidGateway(CFG, CHANNELS, block_hops=128, backend="rdft",
                           decode_payloads=False, **CPU)
    ri = torch.from_numpy(matrix) if as_tensor else matrix
    got = _packets(_run(small, ri, step=3000))
    assert [(c, s) for c, _, s, _ in got] == [(c, s) for c, _, s, _ in ref]
    assert len(ref) == 2 * CHANNELS


def test_gateway_complex_input_stats_and_bytes(matrix):
    gw = PyramidGateway(CFG, CHANNELS, block_hops=256, max_peaks=8,
                        backend="fastp", **CPU)
    cplx = matrix[..., 0] + 1j * matrix[..., 1]
    got = _packets(gw.feed(cplx) + gw.flush())
    assert {PDU_1, PDU_2} <= {p[3] for p in got}
    assert gw.stats() == {"tracks_dropped": 0, "packets_dropped": 0,
                          "tracks_overflow_finalized": 0}
    blocks = gw.fetched_bytes // (CHANNELS * 256 * 8 * 8)
    assert gw.fetched_bytes == blocks * CHANNELS * 256 * 8 * 8 > 0
    assert set(gw.wall) == {"dispatch", "fetch", "tracker", "decode"}
    assert sum(gw.wall_reset().values()) > 0 and not any(gw.wall.values())


@pytest.mark.parametrize("kw", [dict(mesh=object()),
                                dict(tracker="device"),
                                dict(use_native=False)])
def test_gateway_options_not_ported(kw):
    """mesh= and tracker="device" raise, citing their ROADMAP items;
    use_native=False builds the Python tracker bank."""
    if "use_native" in kw:
        gw = PyramidGateway(CFG, 2, **CPU, **kw)
        assert gw.stats() == {"tracks_dropped": 0, "packets_dropped": 0,
                              "tracks_overflow_finalized": 0}
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        PyramidGateway(CFG, 2, **CPU, **kw)


def test_gateway_rejects_wrong_channel_count(matrix):
    with pytest.raises(ValueError):
        PyramidGateway(CFG, 3, block_hops=256, **CPU).feed(matrix)


@pytest.mark.parametrize("backend", ["rdft", "fastp"])
def test_streaming_demodulator_matches_one_shot(backend):
    """Chunked feeding through StreamingPyramidDemodulator reproduces
    pyramid_demodulate's symbols (test_pyramid.py's collision)."""
    iq = _collision(1000 + 16 * PYR_N + 4 * PYR_N // 8 + 204)
    one = pyramid_demodulate(iq, PYR_CFG, backend=backend, **CPU)
    sp = StreamingPyramidDemodulator(PYR_CFG, block_hops=512,
                                     backend=backend, **CPU)
    ri = to_ri(iq)
    got = []
    for i in range(0, len(ri), 9001):
        got += sp.feed(ri[i:i + 9001])
    got += sp.flush()
    assert len(got) == len(one) >= 2
    for a, b in zip(got, one):
        assert np.array_equal(a, b)
    pdus = {bytes(r.payload).hex() for r in (decode(s, PYR_CFG)
                                             for s in got) if r.ok}
    assert {PDU_1, PDU_2} <= pdus


def test_streaming_python_tracker_not_ported():
    """use_native=False streams through the Python PyramidTracker twin and
    returns what the native tracker returns, block by block."""
    iq = _collision(1000 + 16 * PYR_N + 4 * PYR_N // 8 + 204)
    ri = to_ri(iq)
    got = {}
    for use_native in (False, True):
        sp = StreamingPyramidDemodulator(PYR_CFG, block_hops=512,
                                         backend="xla",
                                         use_native=use_native, **CPU)
        got[use_native] = [sp.feed(ri[i:i + 9001])
                           for i in range(0, len(ri), 9001)] + [sp.flush()]
    assert [len(x) for x in got[False]] == [len(x) for x in got[True]]
    flat = [(a, b) for x, y in zip(got[False], got[True])
            for a, b in zip(x, y)]
    assert len(flat) >= 2 and all(np.array_equal(a, b) for a, b in flat)


def test_multi_sf_gateway_matches_jax():
    """Two SFs on one stream: the SF8 golden collision on each channel and
    a clean SF7 single before it; backend 'fastp' (K5) on both SFs."""
    sfs = (7, 8)
    kw = dict(sfs=sfs, block_hops={7: 256, 8: 128}, backend="fastp")
    gw = MultiSFPyramidGateway(CFG, CHANNELS, **CPU, **kw)
    cfg7 = gw.cfgs[7]
    pay7 = _clean_payload(JAX_CFG.replace(sf=7, ldr=cfg7.ldr), 6, seed0=70)
    single = 0.15 * modulate(encode(pay7, cfg7), cfg7, pad_front=0,
                             pad_back=0)
    lead = len(single) + 2000
    coll = _collision_matrix(CHANNELS, TOTAL)
    iq = np.zeros((CHANNELS, lead + TOTAL), np.complex64)
    iq[:, 500:500 + len(single)] += single
    iq[:, lead:] += coll
    ri = to_ri(iq)

    def packets(pkts):
        return sorted((p.channel, p.sf, p.position, p.symbols.tobytes(),
                       bytes(p.result.payload).hex() if p.result.ok
                       else None) for p in pkts)

    ours = packets(_run(gw, ri, step=20_000))
    ref = packets(_run(JaxMultiSF(JAX_CFG, CHANNELS, **kw), ri,
                       step=20_000))
    assert ours == ref
    for c in range(CHANNELS):
        got = {(sf, pdu) for ch, sf, _, _, pdu in ours if ch == c}
        assert {(8, PDU_1), (8, PDU_2)} <= got
        assert any(sf == 7 and pdu is not None
                   and bytes.fromhex(pdu)[3:3 + len(pay7)] == pay7
                   for sf, pdu in got), got
    assert gw.fetched_bytes > 0 and set(gw.stats()) == {
        "tracks_dropped", "packets_dropped", "tracks_overflow_finalized"}
