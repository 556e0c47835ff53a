"""The port's slice end to end: TriggeredPyramidGateway on the CPU.

The fixtures are those of tests/test_collision_gateway.py.  The port's
gateway runs backend "fused" (K1 / K2, here through their plain
versions); the JAX gateway runs "xla" to keep CPU time down.  Both must
decode the same (channel, sf, payload) set with crc_ok, at positions one
hop apart at most, and nothing on the idle channel.  The port takes its own
config and runs on the CPU here (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from gr_lora_tpu_torch.config import PYRAMID_OVERLAP_FACTOR
from gr_lora_tpu_torch.core.codec import encode
from gr_lora_tpu.dist.collision_gateway import \
    TriggeredPyramidGateway as JaxGateway
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.models.modulator import modulate
from gr_lora_tpu_torch.ops.cplx import to_ri
from gr_lora_tpu_torch.pipeline.device_ring import DeviceRing
from test_collision_gateway import BASE as JAX_BASE
from test_collision_gateway import PDU1, PDU2, _golden_collision
from test_torch_core import port_config

BASE = port_config(JAX_BASE)


def _decoded(pkts):
    got = {}
    for p in pkts:
        if p.result is not None and p.result.ok and p.result.crc_ok:
            key = (p.channel, p.sf, bytes(p.result.payload).hex())
            got.setdefault(key, []).append(p.position)
    return got


def _run(gw, ri, step):
    pkts = []
    for lo in range(0, ri.shape[1], step):
        pkts += gw.feed(ri[:, lo:lo + step])
    return pkts + gw.flush()


def _three_channel_fixture(cfg9):
    coll = _golden_collision(JAX_BASE)
    pkt9 = 0.15 * modulate(encode(bytes([0xDE, 0xAD, 0xBE, 0xEF]), cfg9),
                           cfg9, pad_front=0, pad_back=0)
    channels, total = 3, 200_000
    iq = np.zeros((channels, total), np.complex64)
    iq[0, 3000:3000 + len(coll)] += coll          # collision on ch0/sf8
    iq[2, 9000:9000 + len(pkt9)] += pkt9          # single on ch2/sf9
    iq += 0.003 * (np.random.default_rng(0).standard_normal((channels, total))
                   + 1j * np.random.default_rng(1).standard_normal(
                       (channels, total))).astype(np.complex64)
    return to_ri(iq)


def test_gateway_matches_jax_gateway():
    kw = dict(sfs=(7, 8, 9), max_payload_len=16, scan_chunk_samples=1 << 16)
    gw = TriggeredPyramidGateway(BASE, 3, backend="fused", device="cpu", **kw)
    ri = _three_channel_fixture(gw.sf_states[9].cfg)
    ours = _decoded(_run(gw, ri, 37_000))
    ref = _decoded(_run(JaxGateway(JAX_BASE, 3, backend="xla", **kw), ri,
                        37_000))

    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    assert (0, 8, PDU1) in ours and (0, 8, PDU2) in ours
    assert any(ch == 2 and sf == 9 and "deadbeef" in h
               for ch, sf, h in ours)
    assert not any(ch == 1 for ch, _, _ in ours)
    for key, pos in ours.items():
        assert len(pos) == len(ref[key]) == 1, (key, pos, ref[key])
        hop = gw.sf_states[key[1]].cfg.num_samples // PYRAMID_OVERLAP_FACTOR
        assert abs(pos[0] - ref[key][0]) <= hop, (key, pos, ref[key])
    s = gw.stats()
    assert s["scanned_samples"] > 0 and s["dispatched_samples"] > 0
    assert s["pending_events"] == 0
    assert gw.wall["scan"] > 0 and gw.wall["lattice"] > 0


def test_cotimed_channels_not_suppressed():
    """An event on one channel must not suppress a co-timed event on
    another channel: the same golden collision at the SAME position on
    every channel decodes on every channel."""
    channels = 2
    gw = TriggeredPyramidGateway(BASE, channels, sfs=(8,), backend="fused",
                                 max_payload_len=16,
                                 scan_chunk_samples=1 << 16, device="cpu")
    coll = _golden_collision(JAX_BASE)
    total = 150_000
    iq = np.zeros((channels, total), np.complex64)
    for c in range(channels):
        iq[c, 5000:5000 + len(coll)] += coll
    iq += 0.003 * (np.random.default_rng(2).standard_normal(
        (channels, total))
        + 1j * np.random.default_rng(3).standard_normal(
            (channels, total))).astype(np.complex64)
    got = _decoded(gw.feed(torch.from_numpy(to_ri(iq))) + gw.flush())
    for c in range(channels):
        assert (c, 8, PDU1) in got and (c, 8, PDU2) in got, (c, got)


@pytest.mark.parametrize("kw", [dict(sic=True), dict(tracker="device"),
                                dict(mesh=object()),
                                dict(use_native=False)])
def test_unported_options_raise(kw):
    """sic=True, use_native=False and tracker="device" (ported since)
    build a gateway; mesh= (ported since) takes a dist/mesh.ShardGrid and
    raises for anything else."""
    if "sic" in kw or "use_native" in kw or "tracker" in kw:
        gw = TriggeredPyramidGateway(BASE, 1, sfs=(8,), device="cpu", **kw)
        assert gw.stats()["sic_windows"] == 0 and gw.wall["sic"] == 0.0
        assert gw.stats()["device_deviations"] == 0
        return
    with pytest.raises(TypeError, match="ShardGrid"):
        TriggeredPyramidGateway(BASE, 1, sfs=(8,), device="cpu", **kw)


def test_device_ring_matches_jax_ring():
    """Append / trim / compaction / growth keep the same live span as the
    JAX ring, and slices and gathers read the same samples."""
    from gr_lora_tpu.pipeline.device_ring import DeviceRing as JaxRing

    rng = np.random.default_rng(5)
    ours = DeviceRing(3, 1024, history=100, device="cpu")
    ref = JaxRing(3, 1024, history=100)
    for lg, cut in [(700, 300), (900, 600), (2500, 100), (40, 2000)]:
        chunk = rng.standard_normal((3, lg, 2)).astype(np.float32)
        ours.append(chunk)
        ref.append(chunk)
        ours.trim(cut)
        ref.trim(cut)
        assert ours.length == ref.length and ours.cap == ref.cap
        lo = ours.length // 3
        assert np.array_equal(ours.slice(lo, 50).numpy(),
                              np.asarray(ref.slice(lo, 50)))
        chs, los = [2, 0, 1], [0, lo, ours.length - 64]
        assert np.array_equal(ours.gather(chs, los, 64).numpy(),
                              np.asarray(ref.gather(chs, los, 64)))
    assert ours.ingest_bytes == ref.ingest_bytes
