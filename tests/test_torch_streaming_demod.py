"""The port's StreamingDemodulator against the JAX one, and checkpoints
that cross between the two packages.

Fixture: tests/test_streaming.py's (three SF7 packets at random gaps),
built with the port's modulator and codec, fed at its chunk sizes with
``pipelined`` off and on.  Each feed() and flush() must return the same
packets (position and symbols) as the JAX streamer's, with the same drop
counter; the SNR ratios within rtol 1e-4 (the dechirp transform differs
in kind: an f32 FFT here, f32 matmuls there).

A checkpoint taken mid-packet carries the JAX package's keys, shapes and
dtypes both ways, and loading it into a fresh streamer of the other
package continues to the same packets.  The values of ``hist`` (carry_2)
and ``snr`` (carry_6) may differ where a window's spectrum is flat (an
up-dechirped SFD window's argmax is a near tie): neither decides a packet
once the FSM has left preamble detection.
"""

import numpy as np
import pytest

from gr_lora_tpu.models.demodulator import \
    StreamingDemodulator as JaxStreamer
from gr_lora_tpu_torch.core.codec import decode, encode
from gr_lora_tpu_torch.models.demodulator import StreamingDemodulator
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_torch_core import config_pair

JCFG, CFG = config_pair(sf=7, cr=2, crc=True, ldr=False,
                        explicit_header=False, payload_len=4, p=2,
                        fft_factor=2, precision="highest")
PAYLOAD = bytes([0xCA, 0xFE, 0x12, 0x34])
N = CFG.num_samples


def _stream(num_packets=3, gap_syms=40, seed=0):
    """tests/test_streaming.py's _stream."""
    pkt = to_ri(modulate(encode(PAYLOAD, CFG), CFG, pad_front=0, pad_back=0))
    rng = np.random.default_rng(seed)
    chunks, positions = [], []
    t = 0
    for _ in range(num_packets):
        gap = (gap_syms + int(rng.integers(0, 8))) * N \
            + int(rng.integers(0, N))
        chunks.append(np.zeros((gap, 2), np.float32))
        t += gap
        positions.append(t)
        chunks.append(pkt)
        t += len(pkt)
    chunks.append(np.zeros((8 * N, 2), np.float32))
    return np.concatenate(chunks), positions


def _as_list(pkts):
    return [(int(p), s.dtype.str, s.tolist()) for p, s in pkts]


def _feed_both(jsd, tsd, iq, chunk):
    """Feed both streamers the same chunks, then flush; every call's
    packets, drop counter and SNR ratios must agree.  Returns the port's
    packets."""
    got = []
    calls = [(iq[i:i + chunk],) for i in range(0, len(iq), chunk)] + [None]
    for args in calls:
        ref = jsd.feed(*args) if args else jsd.flush()
        out = tsd.feed(*args) if args else tsd.flush()
        assert _as_list(out) == _as_list(ref)
        np.testing.assert_allclose(tsd.snr_ratios, jsd.snr_ratios,
                                   rtol=1e-4)
        assert tsd.dropped == jsd.dropped
        got += out
    return got


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("chunk", [1536, 4096, 100_000])
def test_streaming_matches_jax(chunk, pipelined):
    iq, positions = _stream()
    kw = dict(block_len=8 * N, pipelined=pipelined)
    got = _feed_both(JaxStreamer(JCFG, **kw),
                     StreamingDemodulator(CFG, device="cpu", **kw), iq, chunk)
    assert len(got) == len(positions)
    for (pos, syms), true_pos in zip(got, positions):
        r = decode(syms, CFG)
        assert r.ok and bytes(r.payload[:4]) == PAYLOAD
        assert true_pos <= pos <= true_pos + 10 * N


def test_streaming_slot_overflow_matches_jax():
    """tests/test_overflow.py's streaming case: 5 packets, 2 slots."""
    jcfg, cfg = config_pair(sf=7, cr=1, crc=False, ldr=False,
                            explicit_header=False, payload_len=2, p=2,
                            fft_factor=2, precision="highest")
    pkt = to_ri(modulate(encode(bytes([1, 2]), cfg), cfg, pad_front=0,
                         pad_back=0))
    gap = np.zeros((4 * cfg.num_samples, 2), np.float32)
    iq = np.concatenate([x for _ in range(5) for x in (pkt, gap)])
    kw = dict(block_len=iq.shape[0], max_packets=2)
    tsd = StreamingDemodulator(cfg, device="cpu", **kw)
    got = _feed_both(JaxStreamer(jcfg, **kw), tsd, iq, iq.shape[0])
    assert len(got) == 2 and tsd.dropped == 3


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(direction):
    """Both streamers fed to mid-packet: their checkpoints have the same
    keys, shapes and dtypes, and equal values but for carry_2 / carry_6
    (see the module docstring).  Loaded into a fresh streamer of the other
    package, a checkpoint continues to the same packets."""
    iq, positions = _stream(num_packets=2, seed=5)
    cut = positions[1] + 9 * N + 77          # inside the second packet
    jsd = JaxStreamer(JCFG, block_len=8 * N)
    tsd = StreamingDemodulator(CFG, block_len=8 * N, device="cpu")
    assert len(jsd.feed(iq[:cut])) == len(tsd.feed(iq[:cut])) == 1
    jstate, tstate = jsd.state_dict(), tsd.state_dict()
    assert set(tstate) == set(jstate) == \
        {f"carry_{i}" for i in range(21)} | {"pending"}
    for k, a in jstate.items():
        a, b = np.asarray(a), np.asarray(tstate[k])
        assert (a.dtype, a.shape) == (b.dtype, b.shape), k
        if k not in ("carry_2", "carry_6"):
            assert np.array_equal(a, b), k
    assert tstate["carry_14"].dtype == np.uint16
    np.testing.assert_allclose(tstate["carry_6"], jstate["carry_6"],
                               rtol=1e-4)

    src, state = (jsd, jstate) if direction == "jax_to_port" \
        else (tsd, tstate)
    dst = StreamingDemodulator(CFG, block_len=8 * N, device="cpu") \
        if direction == "jax_to_port" else JaxStreamer(JCFG, block_len=8 * N)
    dst.load_state_dict(state)
    tail_src = src.feed(iq[cut:]) + src.flush()
    tail_dst = dst.feed(iq[cut:]) + dst.flush()
    assert len(tail_src) == 1
    assert _as_list(tail_dst) == _as_list(tail_src)
    assert bytes(decode(tail_dst[0][1], CFG).payload[:4]) == PAYLOAD
