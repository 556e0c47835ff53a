"""The port's soak driver (dist/soak.py) and the gated gateway's streaming
hygiene over minutes of simulated air, on the CPU.

Twins of tests/test_soak.py.  The traffic generator is held to the JAX
package's: the same seed injects the same packets at the same samples.
The soaks themselves stream the port's gated gateway (Python tracker
bank, or the device tracker's plain walk) through ``check_soak``'s
assertions, unchanged: every injected packet decodes byte-exact exactly
once, the streaming state stays bounded, no deviation, the ring settles,
and the stream wraps the ring more than 4 times.
"""

import numpy as np
import pytest

from gr_lora_tpu.dist import soak as jax_soak
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.dist.soak import _pkt, check_soak, run_gateway_soak
from gr_lora_tpu_torch.models.pyramid import pyramid_demodulate
from gr_lora_tpu_torch.models.transceiver import loopback
from test_soak import BASE as JAX_BASE
from test_torch_core import port_config

BASE = port_config(JAX_BASE)
CPU = dict(device="cpu")


def test_repeated_symbol_is_a_pyramid_landmine():
    """The reference landmine of tests/test_soak.py: a payload with two
    adjacent equal symbols truncates in the Pyramid engine; the FSM
    demodulator decodes it byte-exact."""
    cfg = BASE
    pay = bytes([7, 0xA0, 8, 1, 2, 3, 4, 5])
    tx = np.asarray(encode(pay, cfg))
    assert np.any(tx[1:] == tx[:-1])
    n = cfg.num_samples
    wave = 0.2 * _pkt(cfg, pay, 1.0)
    iq = np.zeros(8 * n + len(wave) + 30 * n, np.complex64)
    iq[8 * n:8 * n + len(wave)] += wave
    out = pyramid_demodulate(iq, cfg, max_peaks=8, **CPU)
    assert len(out) == 1 and len(out[0]) < len(tx), [len(s) for s in out]
    r = loopback(pay, cfg.replace(explicit_header=False, payload_len=8),
                 **CPU)
    d = r.decoded[0]
    assert d.ok and d.crc_ok and bytes(d.payload[:8]) == pay


class _Idle:
    """A gateway that decodes nothing: drives the soak generator alone."""

    class _Ring:
        cap = length = 0

    def __init__(self, cfgs, split, suppress):
        self.sf_states = {sf: type("St", (), dict(cfg=c, recent={},
                                                  suppress=suppress[sf]))
                          for sf, c in cfgs.items()}
        self._split_repeats = split
        self._ring = self._Ring()

    def feed(self, iq):
        self.fed = getattr(self, "fed", 0) + iq.shape[1]
        return []

    def flush(self):
        return []

    def stats(self):
        return {}


@pytest.mark.parametrize("split", [False, True])
def test_generator_matches_jax(split):
    """run_gateway_soak injects what the JAX driver injects (payloads,
    channels, SFs, start samples, counts) from the same seed, curated and
    uncurated."""
    gw = TriggeredPyramidGateway(BASE, 2, sfs=(7, 8), max_payload_len=8,
                                 use_native=False, **CPU)
    sup = {sf: st.suppress for sf, st in gw.sf_states.items()}
    n8 = gw.sf_states[8].cfg.num_samples
    logs = []
    for pkg, cfgs in ((run_gateway_soak, {sf: st.cfg for sf, st in
                                           gw.sf_states.items()}),
                      (jax_soak.run_gateway_soak,
                       {sf: JAX_BASE.replace(sf=sf) for sf in (7, 8)})):
        log = []
        idle = _Idle(cfgs, split, sup)
        expected, got, _ = pkg(idle, 2, (7, 8), 6, 96 * n8, seed=7,
                               duty_target=0.18, collision_every=4,
                               inject_log=log)
        logs.append((log, expected, got, idle.fed))
    assert logs[0] == logs[1]
    assert len(logs[0][0]) >= 6


@pytest.mark.parametrize("tracker", ["host", "device"])
def test_gateway_soak(tracker):
    """Minutes of simulated air through the gated gateway with
    split_repeats (uncurated traffic, every landmine class seeded), in
    chunks small enough to force many DeviceRing trims and compactions."""
    channels, sfs = 2, (7, 8)
    gw = TriggeredPyramidGateway(BASE, channels, sfs=sfs, max_payload_len=8,
                                 tracker=tracker, use_native=False,
                                 scan_chunk_samples=1 << 15,
                                 split_repeats=True, **CPU)
    n8 = gw.sf_states[8].cfg.num_samples
    chunk = 96 * n8
    chunks = 12 if tracker == "device" else 16
    expected, got, log = run_gateway_soak(
        gw, channels, sfs, chunks, chunk, seed=7, duty_target=0.18,
        collision_every=4)
    check_soak(expected, got, log, gw,
               min_packets=8 if tracker == "device" else 12)
    assert chunks * chunk > 4 * gw._ring.cap, (chunks * chunk, gw._ring.cap)
    reps = 0
    for ch, pay in expected:
        sf = pay[2] if len(pay) == 8 else None
        if sf in sfs:
            tx = np.asarray(encode(pay, gw.sf_states[sf].cfg))
            reps += bool(np.any(tx[1:] == tx[:-1]))
    assert reps >= 2, (reps, sorted(expected))


def test_gateway_soak_reference_parity():
    """split_repeats=False is exact reference behaviour: its soak streams
    the curated repeat-free traffic class."""
    gw = TriggeredPyramidGateway(BASE, 2, sfs=(7, 8), max_payload_len=8,
                                 use_native=False,
                                 scan_chunk_samples=1 << 15, **CPU)
    n8 = gw.sf_states[8].cfg.num_samples
    expected, got, log = run_gateway_soak(
        gw, 2, (7, 8), 8, 96 * n8, seed=9, duty_target=0.18,
        collision_every=4)
    check_soak(expected, got, log, gw, min_packets=6)
