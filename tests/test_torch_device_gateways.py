"""The port's gateways with ``tracker="device"`` against the JAX package's,
on the CPU (the lattice and the tracker walk through their plain
versions).

Fixtures: tests/test_device_tracker.py's gateway collision matrix (the
golden collision on three channels) for the always-on gateway, with its
fetch cut; tests/test_split_repeats.py's repeat payload through the gated
gateway with ``split_repeats``; tests/test_torch_sic.py's masked point
through the gated gateway with ``sic=True``.  The packets must equal the
JAX device mode's (``apps.gateway --tracker device``: in
tests/test_torch_wideband_e2e.py).
"""

import numpy as np
import pytest

import test_device_tracker as JT
from gr_lora_tpu.dist.collision_gateway import \
    TriggeredPyramidGateway as JaxTriggered
from gr_lora_tpu.dist.pyramid_gateway import PyramidGateway as JaxGateway
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.dist.pyramid_gateway import (MultiSFPyramidGateway,
                                                    PyramidGateway)
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_split_repeats import _air
from test_split_repeats import _cfg as split_cfg
from test_torch_core import port_config
from test_torch_sic import CFG as SIC_CFG
from test_torch_sic import JCFG as SIC_JCFG
from test_torch_sic import PDU1, PDU2, _gateway_stream

CPU = dict(device="cpu")


def _packets(pkts):
    return sorted((p.channel, p.position, tuple(p.symbols.tolist()))
                  for p in pkts)


def test_gateway_device_mode_matches_jax_and_cuts_fetch_100x():
    """PyramidGateway(tracker="device"): the JAX device gateway's packets
    on the golden collision matrix, no deviation, and the host copy cut
    at least 100x against the port's host-tracker gateway."""
    iq = JT._gateway_fixture()
    kw = dict(block_hops=512, max_peaks=8)
    ours = PyramidGateway(port_config(JT._GCFG), 3, tracker="device",
                          **kw, **CPU)
    got = _packets(ours.feed(iq) + ours.flush())
    ref = JaxGateway(JT._GCFG, 3, tracker="device", **kw)
    assert got == _packets(ref.feed(iq) + ref.flush())
    assert len(got) == 6
    stats = ours.stats()
    assert stats["deviations"] == 0 and stats == ref.stats()
    host = PyramidGateway(port_config(JT._GCFG), 3, use_native=False,
                          **kw, **CPU)
    assert _packets(host.feed(iq) + host.flush()) == got
    assert host.fetched_bytes >= 100 * ours.fetched_bytes, \
        (host.fetched_bytes, ours.fetched_bytes)
    assert ours.wall["tracker"] == 0.0


def test_multi_sf_device_mode_matches_host():
    """MultiSFPyramidGateway(tracker="device") at SF7-8: the host-tracker
    gateway's packets (the always-on matrix at SF8), pools passed
    through."""
    iq = JT._gateway_fixture(channels=2)
    kw = dict(sfs=(7, 8), block_hops=512, max_peaks=8)
    base = port_config(JT._GCFG)
    dev = MultiSFPyramidGateway(base, 2, tracker="device",
                                device_pools=dict(track_pool=32), **kw,
                                **CPU)
    host = MultiSFPyramidGateway(base, 2, use_native=False, **kw, **CPU)
    got = dev.feed(iq) + dev.flush()
    assert _packets(got) == _packets(host.feed(iq) + host.flush())
    assert {p.sf for p in got} == {8} and len(got) == 4
    assert dev.stats()["deviations"] == 0
    assert dev.gws[8]._dev_states["t_active"].shape == (2, 32)


@pytest.mark.parametrize("split", [False, True])
def test_gated_gateway_device_mode_matches_jax(split):
    """TriggeredPyramidGateway(tracker="device") on the repeat payload:
    the JAX device gateway's packets; with split_repeats the payload
    decodes, without it the reference-exact tracker truncates it."""
    cfg = split_cfg(8)
    pay = bytes([7, 0xA0, 8, 1, 2, 3, 4, 5])
    iq, _ = _air(cfg, pay)
    ri = to_ri(iq[None])
    kw = dict(sfs=(8,), max_payload_len=8, scan_chunk_samples=1 << 15,
              split_repeats=split, tracker="device")
    ours = TriggeredPyramidGateway(port_config(cfg), 1, **kw, **CPU)
    got = ours.feed(ri) + ours.flush()
    ref = JaxTriggered(cfg, 1, **kw)
    want = ref.feed(ri) + ref.flush()
    assert _packets(got) == _packets(want)
    decoded = {bytes(p.result.payload[3:11]) for p in got
               if p.result.ok and p.result.crc_ok}
    assert (pay in decoded) == split
    assert ours.stats()["device_deviations"] == ref.device_deviations == 0


def test_gated_gateway_device_mode_with_sic_matches_jax():
    """sic=True with tracker="device": the masked point's PDUs and SIC
    windows equal the JAX gateway's."""
    ri = _gateway_stream(16 * SIC_CFG.num_samples)
    kw = dict(sfs=(8,), max_payload_len=16, scan_chunk_samples=1 << 16,
              sic=True, tracker="device")

    def pdus(pkts):
        return {bytes(p.result.payload).hex() for p in pkts
                if p.result is not None and p.result.ok}

    gw = TriggeredPyramidGateway(SIC_CFG, 1, **kw, **CPU)
    ours = pdus(gw.feed(ri) + gw.flush())
    ref_gw = JaxTriggered(SIC_JCFG, 1, **kw)
    assert ours == pdus(ref_gw.feed(ri) + ref_gw.flush())
    assert {PDU1, PDU2} <= ours
    assert gw.sic_windows == ref_gw.sic_windows >= 1


def test_device_mode_mesh_raises():
    """mesh= (ported since) takes a dist/mesh.ShardGrid and raises for
    anything else; an unknown tracker raises."""
    with pytest.raises(TypeError, match="ShardGrid"):
        PyramidGateway(port_config(JT._GCFG), 2, tracker="device",
                       mesh=object(), **CPU)
    with pytest.raises(ValueError):
        PyramidGateway(port_config(JT._GCFG), 2, tracker="both", **CPU)
