"""The port's FSM gateway on a shard grid (dist/gateway.py, dist/mesh.py)
on the CPU, against the JAX package's on its 8 virtual devices and
against the port's ``mesh=None``.

Port grids hold their slots in this one process on ``"cpu"``, as the
conftest's 8 virtual CPU devices hold the JAX mesh.  Fixtures:
tests/test_dist.py's three (packets straddling every time-shard
boundary, {ch: 2, t: 4} with several channels a slot, AWGN) and
tests/test_pdu_sink.py's sharded gateway through ``PduSink`` to UDP on an
ephemeral port; and four channels of chip_smoke.py phase 12a's noisy
capture on its {ch: 2, t: 4} grid, a false detection included.  ``syms``, ``lens``, ``pos``, ``cnt`` and ``dropped``
must equal the JAX mesh's exactly, ``snr`` within rtol 1e-4 (the FSM's
transform is an f32 FFT here, a matmul there); the packets equal those
``demod_fn`` finds in the whole stream (mesh=None), each once, at the
same global positions where a shard's block is a whole number of
symbols.  Then the grid's own primitives: ``shift_t``'s
zero fill, ``all_gather``'s layout, ``axis_index`` and the halo lengths.
"""

import dataclasses
import socket

import jax
import numpy as np
import pytest
import torch

import test_dist as TD
from gr_lora_tpu.dist import gateway as JG
from gr_lora_tpu_torch.dist import PduSink
from gr_lora_tpu_torch.dist import gateway as PG
from gr_lora_tpu_torch.dist.mesh import ShardGrid
from gr_lora_tpu_torch.models.demodulator import demod_fn
from test_torch_core import config_pair, port_config

CFG = port_config(TD.CFG)
NAMES = ("syms", "lens", "pos", "cnt", "dropped", "snr")


def _grid(nch, nt):
    return PG.make_mesh(nch, nt, devices=["cpu"] * (nch * nt))


def _both(iq, nch, nt, channels, block_len, mp=4, cfg=CFG):
    """(JAX mesh outputs, port grid outputs) as numpy arrays, held equal;
    returns the port's gateway_receive lists."""
    jcfg = config_pair(**dataclasses.asdict(cfg))[0]
    jplan = JG.make_gateway(jcfg, JG.make_mesh(
        nch, nt, devices=jax.devices()[:nch * nt]), channels, block_len,
        max_packets=mp)
    plan = PG.make_gateway(cfg, _grid(nch, nt), channels, block_len,
                           max_packets=mp)
    ref = [np.asarray(a) for a in jax.device_get(jplan.fn(iq))]
    # One FSM plan and one step loop for the rank's slots, not one a slot.
    demod = demod_fn(cfg, PG.left_halo_len(cfg) + block_len
                     + PG.right_halo_len(cfg), mp, device="cpu")
    before = set(demod.loops)
    got = [a.numpy() for a in plan.fn(iq)]
    assert set(demod.loops) - before <= {channels * nt}
    for name, a, b in zip(NAMES, ref, got):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name == "snr":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=0)
        else:
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), \
                name
    out = PG.gateway_receive(plan, iq, cfg)
    assert all(s.dtype == np.uint16 for ch in out for _, s in ch)
    return out


def _whole_stream(iq, cfg=CFG):
    """mesh=None: demod_fn over each channel's whole stream, as
    (position, symbols) lists."""
    syms, lens, pos, cnt, _, _ = (a.numpy() for a in demod_fn(
        cfg, iq.shape[1], 8, device="cpu")(iq))
    return [[(int(pos[c, r]), syms[c, r, :lens[c, r]].astype(np.uint16))
             for r in range(int(cnt[c]))] for c in range(iq.shape[0])]


def _same_packets(a, b, block_len):
    """The same symbols, each once; the same positions where block_len is
    a whole number of symbols, else within one: the FSM reads whole
    symbols from its window's start, and a shard's window starts at
    t * block_len - left_halo_len."""
    n = CFG.num_samples
    assert [[s.tolist() for _, s in ch] for ch in a] == \
        [[s.tolist() for _, s in ch] for ch in b]
    for ca, cb in zip(a, b):
        for (pa, _), (pb, _) in zip(ca, cb):
            assert pa == pb if block_len % n == 0 else abs(pa - pb) < n, \
                (pa, pb)


def test_time_sharded_boundary_packets():
    """A packet centred on every interior boundary of t = 4 and one inside
    a shard: each decoded exactly once, at the whole stream's position."""
    nt = 4
    pkt = TD._packet()
    block_len = max(PG.right_halo_len(CFG), 3 * len(pkt))
    iq = np.zeros((1, nt * block_len, 2), np.float32)
    offs = [b * block_len - len(pkt) // 2 for b in range(1, nt)]
    offs.append(block_len // 4)
    for off in offs:
        iq[0, off:off + len(pkt)] = pkt
    packets = _both(iq, 1, nt, 1, block_len)
    assert TD._decode_all(packets)[0] == [TD.PAYLOAD] * len(offs)
    _same_packets(packets, _whole_stream(iq), block_len)


def test_channel_and_time_sharding():
    """{ch: 2, t: 4}, two channels a slot, one packet a channel."""
    pkt = TD._packet()
    block_len = max(PG.right_halo_len(CFG), len(pkt) + 4 * CFG.num_samples)
    channels, total = 4, 4 * block_len
    rng = np.random.default_rng(0)
    iq = np.zeros((channels, total, 2), np.float32)
    for c in range(channels):
        off = int(rng.integers(0, total - len(pkt)))
        iq[c, off:off + len(pkt)] = pkt
    packets = _both(iq, 2, 4, channels, block_len)
    assert TD._decode_all(packets) == [[TD.PAYLOAD]] * channels
    _same_packets(packets, _whole_stream(iq), block_len)


def test_awgn_multichannel():
    """Noisy channels still decode through the sharded path."""
    nt = 2
    pkt = TD._packet()
    block_len = max(PG.right_halo_len(CFG), len(pkt) + 4 * CFG.num_samples)
    rng = np.random.default_rng(7)
    iq = rng.normal(0, 0.02, (2, nt * block_len, 2)).astype(np.float32)
    for c in range(2):
        off = c * block_len + (block_len - len(pkt)) // 2
        iq[c, off:off + len(pkt)] += pkt
    packets = _both(iq, 1, nt, 2, block_len)
    assert TD._decode_all(packets) == [[TD.PAYLOAD], [TD.PAYLOAD]]
    _same_packets(packets, _whole_stream(iq), block_len)


def test_chip_smoke_mesh_fixture_equals_jax_mesh():
    """chip_smoke.py phase 12a's capture (phase 9a's noise, each packet's
    preamble across a t seam), channels 20-23 on its {ch: 2, t: 4} grid:
    the port's outputs equal the JAX mesh's exactly, the detections that
    decode no payload included: channel 21's at position 0
    (``MESH_FSM_UNDECODABLE``, which 12a asserts on the card), where
    shard 0's zero left halo meets the noise and which mesh=None does not
    report; every other packet decodes its payload once, as mesh=None's
    at the same position."""
    import chip_smoke as CS

    cfg = CS.fsm_config()
    chans = range(20, 24)
    block = CS.FSM_SYMBOLS * cfg.num_samples // 4
    iq, _ = CS.mesh_fsm_fixture(cfg, block, keep=chans)
    got = CS._fsm_packets(cfg, _both(iq, 2, 4, len(chans), block, cfg=cfg))
    ref = CS._fsm_packets(cfg, _whole_stream(iq, cfg))
    assert [(chans[g[0]], g[1]) for g in got if not g[3]] == [
        u for u in CS.MESH_FSM_UNDECODABLE if u[0] in chans] == [(21, 0)]
    assert [r for r in ref if not r[3]] == []
    assert [g for g in got if g[3]] == ref
    assert [g[3][:2 * len(CS.FSM_PAYLOAD)] for g in ref] == \
        [CS.FSM_PAYLOAD.hex()] * len(chans)


def test_sink_from_sharded_gateway_to_udp():
    """test_pdu_sink.py's case: t = 2, one packet, through PduSink to a
    UDP socket on an ephemeral port; the datagram is the event's wire
    form, as the JAX gateway's through the JAX sink."""
    from gr_lora_tpu.dist.pdu_sink import PduSink as JaxSink

    nt = 2
    pkt = TD._packet()
    block_len = max(PG.right_halo_len(CFG), 3 * len(pkt))
    iq = np.zeros((1, nt * block_len, 2), np.float32)
    iq[0, 500:500 + len(pkt)] = pkt
    packets = _both(iq, 1, nt, 1, block_len)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(10)
    got = []
    sink = PduSink(udp=("127.0.0.1", rx.getsockname()[1]),
                   callback=got.append)
    try:
        assert sink.drain_gateway(packets, CFG) == 1
    finally:
        sink.close()
    data, _ = rx.recvfrom(65536)
    rx.close()
    ev = got[0]
    assert ev.payload[:4] == TD.PAYLOAD and ev.crc_ok
    assert data == ev.to_wire()
    ref = []
    JaxSink(callback=ref.append).drain_gateway(packets, TD.CFG)
    assert data == ref[0].to_wire()


def test_gather_results_and_dropped():
    """gather_results=True gives the same outputs on one rank; a slot's
    overflow shows in ``dropped`` (max_packets 1, two packets in one
    shard), as the JAX gateway's."""
    pkt = TD._packet()
    block_len = max(PG.right_halo_len(CFG), 3 * len(pkt))
    iq = np.zeros((1, 2 * block_len, 2), np.float32)
    for off in (100, 100 + len(pkt) + 4 * CFG.num_samples):
        iq[0, off:off + len(pkt)] = pkt
    _both(iq, 1, 2, 1, block_len, mp=1)
    plan = PG.make_gateway(CFG, _grid(1, 2), 1, block_len, max_packets=1,
                           gather_results=True)
    _, stats = PG.gateway_receive(plan, iq, CFG, return_stats=True)
    assert stats["dropped"] == 1


@pytest.mark.parametrize("sf,p,ff", [(7, 2, 2), (8, 1, 8), (10, 4, 1)])
def test_halo_lengths_equal_jax(sf, p, ff):
    jcfg, pcfg = config_pair(sf=sf, p=p, fft_factor=ff)
    assert PG.left_halo_len(pcfg) == JG.left_halo_len(jcfg)
    assert PG.right_halo_len(pcfg) == JG.right_halo_len(jcfg)


def test_grid_primitives():
    """shift_t fills a slot with no source with zeros (ppermute); a
    {2, 4} grid's all_gather lays the slots out on the grid; axis_index;
    scatter splits C over ch and T over t."""
    grid = _grid(2, 4)
    assert grid.shape == {"ch": 2, "t": 4}
    assert [s for s in grid.local] == [(c, t) for c in range(2)
                                       for t in range(4)]
    x = torch.arange(8, dtype=torch.float32)[:, None] + 1
    left = grid.shift_t(x, 1)[:, 0].tolist()
    right = grid.shift_t(x, -1)[:, 0].tolist()
    assert left == [0, 1, 2, 3, 0, 5, 6, 7]
    assert right == [2, 3, 4, 0, 6, 7, 8, 0]
    assert grid.all_gather(x)[..., 0].tolist() == [[1, 2, 3, 4],
                                                   [5, 6, 7, 8]]
    assert grid.axis_index("t").tolist() == [0, 1, 2, 3] * 2
    assert grid.axis_index("ch").tolist() == [0] * 4 + [1] * 4
    full = torch.arange(4 * 8).reshape(4, 8)
    parts = grid.scatter(full)
    assert parts.shape == (8, 2, 2)
    assert parts[5].tolist() == full[2:4, 2:4].tolist()
    assert grid.row_layout() == ([0, 1], False, 0, 2)


def test_grid_rejects_bad_layouts():
    with pytest.raises(ValueError, match="grid"):
        PG.make_mesh(3, 2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="outside"):
        ShardGrid([[(1, "cpu")]])
    with pytest.raises(ValueError, match="halo"):
        PG.make_gateway(CFG, _grid(1, 2), 1, 100)
    with pytest.raises(ValueError, match="ch-shards"):
        PG.make_gateway(CFG, _grid(2, 1), 3, PG.right_halo_len(CFG))
