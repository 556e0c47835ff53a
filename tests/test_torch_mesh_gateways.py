"""The port's Pyramid gateways and device tracker on a shard grid, on the
CPU, against the JAX package's on its 8 virtual devices and against the
port's ``mesh=None``.

Port grids hold their slots in this one process on ``"cpu"``
(``make_mesh(..., devices=["cpu"] * 8)``), as the conftest's 8 virtual
CPU devices hold the JAX mesh.  Fixtures: tests/test_pyramid_gateway.py's
collision matrix on a ``{ch: 2, t: 4}`` grid (the host tracker);
tests/test_device_tracker.py's gateway matrix with ``tracker="device"`` on
``{1, 8}`` and on ``{2, 4}`` (six channels, the three twice); the JAX mesh
plan's state carried into the port's grid plan (``state_from_jax``); the
gated gateway on a ``{ch: 4}`` grid with the golden collision on every
channel (tests/multihost_triggered_worker.py's fixture at 4 channels).
Packets are (channel, position, symbols) and must be equal; the device
tracker's deviation counters equal and zero, its states bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import test_device_tracker as JT
from gr_lora_tpu.dist.collision_gateway import \
    TriggeredPyramidGateway as JaxTriggered
from gr_lora_tpu.dist.pyramid_gateway import PyramidGateway as JaxGateway
from gr_lora_tpu.models.device_tracker import \
    make_channel_tracker_plan as jax_tracker_plan
from gr_lora_tpu_torch.dist.collision_gateway import TriggeredPyramidGateway
from gr_lora_tpu_torch.dist.gateway import make_mesh
from gr_lora_tpu_torch.dist.pyramid_gateway import (MultiSFPyramidGateway,
                                                    PyramidGateway)
from gr_lora_tpu_torch.models import device_tracker as dt
from gr_lora_tpu_torch.ops.cplx import to_ri
from test_pyramid_gateway import CFG as PG_CFG
from test_pyramid_gateway import _N, _collision_matrix
from test_torch_core import port_config
from test_torch_device_tracker import _assert_same_state

CPU = dict(device="cpu")


def _packets(pkts):
    return sorted((p.channel, p.position, tuple(p.symbols.tolist()))
                  for p in pkts)


def _grid(nch, nt):
    return make_mesh(nch, nt, devices=["cpu"] * (nch * nt))


def _jax_mesh(nch, nt):
    return Mesh(np.asarray(jax.devices()[:nch * nt]).reshape(nch, nt),
                ("ch", "t"))


def _run(gw, iq):
    return _packets(gw.feed(iq) + gw.flush())


def test_pyramid_gateway_grid_matches_jax_mesh():
    """test_pyramid_gateway.py's mesh case: the collision matrix (4
    channels) on {ch: 2, t: 4}; the port's grid, the JAX mesh and the
    port's mesh=None give the same packets, both golden PDUs on every
    channel."""
    channels = 4
    total = 1000 + channels * 4 * _N + 76 * _N
    iq = to_ri(_collision_matrix(channels, total))
    kw = dict(block_hops=512)
    ours = PyramidGateway(port_config(PG_CFG), channels, mesh=_grid(2, 4),
                          **kw)
    got = _run(ours, iq)
    assert got == _run(JaxGateway(PG_CFG, channels, mesh=_jax_mesh(2, 4),
                                  **kw), iq)
    assert got == _run(PyramidGateway(port_config(PG_CFG), channels, **kw,
                                      **CPU), iq)
    assert ours.local_channels == ours.ingest_channels == channels
    assert len(got) == 2 * channels


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_device_tracker_grid_matches_jax_mesh(shape):
    """test_device_tracker.py's time-only ({1, 8}) and {2, 4} cases with
    tracker="device": the JAX mesh gateway's packets and deviation
    counters (zero), and every state field bit for bit against the
    port's mesh=None on the same channels.  On {2, 4} the three channels
    go twice."""
    iq = JT._gateway_fixture()
    if shape[0] == 2:
        iq = np.concatenate([iq, iq], axis=0)
    channels = iq.shape[0]
    kw = dict(block_hops=512, max_peaks=8, tracker="device")
    cfg = port_config(JT._GCFG)
    ours = PyramidGateway(cfg, channels, mesh=_grid(*shape), **kw)
    got = _run(ours, iq)
    ref = JaxGateway(JT._GCFG, channels, mesh=_jax_mesh(*shape), **kw)
    assert got == _run(ref, iq)
    assert len(got) == 2 * channels
    stats = ours.stats()
    assert stats == ref.stats() and stats["deviations"] == 0
    one = PyramidGateway(cfg, channels, **kw, **CPU)
    assert _run(one, iq) == got
    _assert_same_state(dt.state_to_numpy(one._dev_states),
                       dt.state_to_numpy(ours._dev_states))


def test_state_from_jax_mesh_plan_carries_into_grid_plan():
    """A state fetched from the JAX mesh plan ({2, 4}, six channels) after
    its first block, packets in flight, is placed row by row on the
    port's grid plan (state_from_jax with the grid); the next block (the
    flush's silence, tail included) leaves both states equal bit for
    bit, and the packets that block finishes are the same."""
    cfg, jcfg = port_config(JT._GCFG), JT._GCFG
    iq = JT._gateway_fixture()
    iq = np.concatenate([iq, iq], axis=0)
    channels, hops = iq.shape[0], 256
    n = cfg.num_samples
    hop, halo = n // 8, n - n // 8
    block = hops * hop
    ri = to_ri(iq)[:, :block + halo]
    mesh = _jax_mesh(2, 4)
    init, step, _ = jax_tracker_plan(jcfg, hops, 8, mesh=mesh)
    own = NamedSharding(mesh, P("ch", "t", None))
    tail = NamedSharding(mesh, P("ch", None, None))

    def jax_step(states, x):
        return step(states, jax.device_put(x[:, :block], own),
                    jax.device_put(x[:, block:], tail))

    states, _ = jax_step(init(channels), ri)
    fetched = {k: np.asarray(v) for k, v in states.items()}
    assert fetched["p_active"].any() and fetched["t_active"].any()
    grid = _grid(2, 4)
    _, pstep, _ = dt.make_channel_tracker_plan(cfg, hops, 8, mesh=grid)
    ours = dt.state_from_jax(fetched, mesh=grid)
    assert ours["t_active"].shape[0] == channels
    silence = np.zeros_like(ri)
    after, _ = jax_step(states, silence)
    ours, counts = pstep(ours, torch.from_numpy(silence))
    _assert_same_state({k: np.asarray(v) for k, v in after.items()},
                       dt.state_to_numpy(ours))
    assert counts.tolist() == np.asarray(after["o_count"]).tolist()


def test_multi_sf_passes_the_grid():
    """MultiSFPyramidGateway(mesh=...) builds every SF's gateway on the
    grid and decodes the collision matrix as mesh=None does."""
    channels = 2
    total = 1000 + channels * 4 * _N + 76 * _N
    iq = to_ri(_collision_matrix(channels, total))
    kw = dict(sfs=(7, 8), block_hops=512)
    ours = MultiSFPyramidGateway(port_config(PG_CFG), channels,
                                 mesh=_grid(2, 4), **kw)
    assert all(gw._mesh is not None for gw in ours.gws.values())
    ref = MultiSFPyramidGateway(port_config(PG_CFG), channels, **kw, **CPU)
    got = _run(ours, iq)
    assert got == _run(ref, iq) and len(got) == 2 * channels


def _gated_fixture(channels):
    """tests/multihost_triggered_worker.py's capture: the golden collision
    on every channel at a channel-dependent base."""
    from test_pyramid_gateway import _tx
    p1 = _tx(bytes([1, 2, 3, 4, 5, 6]), 0.2)
    p2 = _tx(bytes([7] * 5), 0.09)
    total = 1000 + channels * 2 * _N + 90 * _N
    iq = np.zeros((channels, total), np.complex64)
    for c in range(channels):
        base = 1000 + c * 2 * _N
        off2 = base + 16 * _N + 4 * _N // 8 + 204
        iq[c, base:base + len(p1)] += p1
        iq[c, off2:off2 + len(p2)] += p2
    return to_ri(iq)


def test_gated_gateway_ch_grid_matches_jax_mesh():
    """The gated gateway on a {ch: 4} grid (one channel a slot) equals the
    JAX gateway on a 4-device ch mesh and the port's mesh=None: both
    golden PDUs on every channel, once each; every channel owned."""
    channels = 4
    ri = _gated_fixture(channels)
    kw = dict(sfs=(8,), max_payload_len=16)
    ours = TriggeredPyramidGateway(port_config(PG_CFG), channels,
                                   mesh=_grid(4, 1), **kw)
    got = _run(ours, ri)
    jmesh = Mesh(np.asarray(jax.devices()[:channels]), ("ch",))
    theirs = JaxTriggered(PG_CFG, channels, mesh=jmesh, **kw)
    assert got == _run(theirs, ri)
    assert got == _run(TriggeredPyramidGateway(port_config(PG_CFG),
                                               channels, **kw, **CPU), ri)
    assert ours._own_channels == sorted(theirs._own_channels) \
        == list(range(channels))
    assert len(got) == 2 * channels


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_grid_arguments_are_checked(shape):
    """A gated gateway takes a ch-only grid; channels must split over
    ch; block_hops over t."""
    grid = _grid(*shape)
    if shape[1] > 1:
        with pytest.raises(ValueError, match="ch-only"):
            TriggeredPyramidGateway(port_config(PG_CFG), 2, sfs=(8,),
                                    mesh=grid)
        with pytest.raises(ValueError, match="t-shards"):
            PyramidGateway(port_config(PG_CFG), 2, block_hops=511, mesh=grid)
    else:
        with pytest.raises(ValueError, match="ch-shards"):
            PyramidGateway(port_config(PG_CFG), 3, mesh=grid)
        with pytest.raises(ValueError, match="ch-shards"):
            dt.make_channel_tracker_plan(port_config(PG_CFG), 64,
                                         mesh=grid)[0](3)
